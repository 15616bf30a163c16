"""Ground rules of the PyTorch port.

- The port stands alone: no file in ``unionml_tpu_torch/``, and not
  ``chip_smoke.py`` or ``chip_ab.py``, imports ``jax``, ``flax`` or anything of ``unionml_tpu``
  (checked on the source with ``ast``, and by importing the whole package in
  a fresh interpreter).
- Entry points default to ``device="cuda"`` and raise where there is no CUDA
  device unless the caller asks for the CPU explicitly; they never fall back
  quietly.
- Nothing builds or launches at import time, and the kernel sources the
  wrappers load are in the package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from unionml_tpu_torch import kernels
from unionml_tpu_torch.kernels import _build
from unionml_tpu_torch.models import GPTConfig, GPTLMHeadModel, init_gpt
from unionml_tpu_torch.models import gpt as tgpt
from unionml_tpu_torch.serving.continuous import ContinuousBatcher, DecodeEngine

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "unionml_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_ab.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "unionml_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_whole_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib, unionml_tpu_torch\n"
        "for m in pkgutil.walk_packages(unionml_tpu_torch.__path__, 'unionml_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in {'jax', 'flax', 'unionml_tpu'}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device is valid here")


def test_model_defaults_to_cuda_and_raises_without_it(no_cuda):
    cfg = GPTConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTLMHeadModel(cfg)
    with pytest.raises(RuntimeError):
        init_gpt(cfg, seed=0)
    with pytest.raises(RuntimeError):
        tgpt.init_block_pool(cfg, 4, 4)
    assert GPTLMHeadModel(cfg, device="cpu").device.type == "cpu"


def test_engine_and_batcher_default_to_cuda_and_raise_without_it(no_cuda):
    model = GPTLMHeadModel(GPTConfig.tiny(dtype=torch.float32), device="cpu")
    with pytest.raises(RuntimeError):
        DecodeEngine(model, max_len=64)
    engine = DecodeEngine(model, max_len=64, device="cpu")
    with pytest.raises(RuntimeError):
        ContinuousBatcher(engine)
    ContinuousBatcher(engine, device="cpu").close()


def test_engine_rejects_unported_modes():
    model = GPTLMHeadModel(GPTConfig.tiny(dtype=torch.float32), device="cpu")
    with pytest.raises(NotImplementedError):
        DecodeEngine(model, paged=False, device="cpu")
    with pytest.raises(ValueError):
        DecodeEngine(model, kv_quantize="int4", device="cpu")


def test_kernel_sources_ship_with_the_package_and_nothing_launched_on_cpu():
    for name in ("flash_fwd", "flash_bwd", "paged_attention"):
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()
        assert name in _build._ENTRY_POINTS
    assert set(kernels.launches) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_attention"}
    assert set(kernels.launches) == {s for symbols in _build._ENTRY_POINTS.values() for s in symbols}
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    model = GPTLMHeadModel(GPTConfig.tiny(dtype=torch.float32), device="cpu")
    before = dict(kernels.launches)
    DecodeEngine(model, max_len=64, device="cpu").generate([1, 2, 3], 4)
    assert kernels.launches == before  # CPU tensors take the plain versions
