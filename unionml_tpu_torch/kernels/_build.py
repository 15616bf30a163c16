"""Build the CUDA sources in ``csrc/`` and load them through ``ctypes``.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` entry points with a plain C
interface (pointers, ints, floats and a stream), so ``nvcc`` compiles it in
seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The shared library lands in ``build/torch_kernels/`` at the repository root
under a name that carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads from the build directory. Nothing
builds at import time: the first launch of a kernel builds it, and
:func:`build_all` builds every source at once, one ``nvcc`` process each, all
started together.

Every entry point returns ``cudaGetLastError()`` after its launch; wrappers
call :func:`check` on it and raise if it is not 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

__all__ = ["BUILD_DIR", "CSRC_DIR", "DTYPE_CODES", "NVCC_FLAGS", "build_all", "check", "library"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

#: the ``dtype`` argument of the entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: argument types of each library's entry points (pointers and the stream as
#: c_void_p: a bare Python int would be passed as a 32-bit int and cut)
_BWD_ARGS = [_P] * 9  # q, k, v, d_out, lse, delta, kv_lens, seg_ids, seg_ranges
# B, H, Sq, Sk, D, seg_stride, dtype, causal, sm_scale, stream
_BWD_SHAPE = [_I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
_ENTRY_POINTS = {
    "flash_fwd": {
        # q, k, v, kv_lens, seg_ids, seg_ranges, o, lse,
        # B, H, Sq, Sk, D, seg_stride, dtype, causal, sm_scale, stream
        "flash_fwd": [_P] * 8 + [_I] * 8 + [_F, _P],
    },
    "flash_bwd": {
        "flash_bwd_dq": _BWD_ARGS + [_P] + _BWD_SHAPE,  # ..., dq, ...
        "flash_bwd_dkv": _BWD_ARGS + [_P, _P] + _BWD_SHAPE,  # ..., dk, dv, ...
    },
    "paged_attention": {
        # q, k, v, k_scale, v_scale, table, base, o,
        # B, H, S, D, bs, W, dtype, kv_int8, sm_scale, stream
        "paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build in this process
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, target: Path) -> subprocess.Popen:
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, target: Path, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    build_log[name] = out
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named source that is not built yet, all ``nvcc`` processes
    started together. Returns seconds per source (from the common start until
    its ``nvcc`` finished; 0.0 for a source already built) and the wall
    seconds of the whole build under ``"total"``."""
    names = list(names or _ENTRY_POINTS)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        pending: List = []
        times: Dict[str, float] = {}
        for name in names:
            target = _target(name)
            if target.exists():
                times[name] = 0.0
                continue
            pending.append((name, target, _start(name, target)))
        errors = []
        for name, target, proc in pending:
            try:
                _finish(name, target, proc)
            except RuntimeError as exc:
                errors.append(str(exc))
            times[name] = time.perf_counter() - t0
        times["total"] = time.perf_counter() - t0
        if errors:
            raise RuntimeError("\n".join(errors))
        return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for symbol, argtypes in _ENTRY_POINTS[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(status: int, name: str) -> None:
    """Raise if a kernel's entry point reported a CUDA error (its launch was
    refused, e.g. for an invalid configuration)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
