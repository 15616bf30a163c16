"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; they carry the ``cuda`` marker
and skip elsewhere. Run them on the GPU machine with

    python -m pytest tests/test_torch_kernels.py -m cuda -q

The file imports nothing of JAX, so it runs where JAX is not installed.
Tolerances: float32 atol 2e-5 (summation order only); bfloat16 atol 2e-2 +
rtol 2e-2 (the plain versions round the softmax weights to bf16 before the
value product, the kernels keep them in f32). Each test also checks that the
kernel's launch count moved.
"""

import numpy as np
import pytest
import torch

from unionml_tpu_torch import kernels
from unionml_tpu_torch.ops.attention import _kv_lens_to_mask, flash_attention, reference_attention
from unionml_tpu_torch.ops.paged_attention import paged_attention, reference_paged_attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    atol, rtol = TOL[got.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("Sq,S,D,causal,lens", [
    (16, 16, 64, True, None), (100, 100, 64, True, None), (257, 257, 64, False, [257, 3]),
    (77, 77, 128, True, [77, 0]), (5, 77, 64, False, [70, 77]), (40, 9, 64, True, None),
])
def test_flash_kernel_matches_plain(cuda, dtype, Sq, S, D, causal, lens):
    g = torch.Generator().manual_seed(S)
    q = torch.randn((2, 3, Sq, D), generator=g).to(cuda, dtype)
    k, v = (torch.randn((2, 3, S, D), generator=g).to(cuda, dtype) for _ in range(2))
    kv_lens = torch.tensor(lens, device=cuda) if lens else None
    before = kernels.launches["flash_fwd"]
    got = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches["flash_fwd"] == before + 1
    mask = _kv_lens_to_mask(kv_lens, S) if kv_lens is not None else None
    _close(got, reference_attention(q, k, v, mask=mask, causal=causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "full"])
@pytest.mark.parametrize("B,S,bs", [(8, 1, 16), (1, 32, 16), (3, 2, 8), (2, 5, 32)])
def test_paged_kernel_matches_plain(cuda, dtype, quantized, B, S, bs):
    rng = np.random.default_rng(B + S)
    H, D, width = 4, 64, 9
    blocks = B * (width - 1) + 1
    base = rng.integers(0, (width - 1) * bs - S + 1, B)
    table = np.full((B, width), blocks - 1, dtype=np.int32)
    for b in range(B):
        table[b, : (base[b] + S - 1) // bs + 1] = rng.permutation(blocks - 1)[: (base[b] + S - 1) // bs + 1]
    if quantized:
        kp = torch.from_numpy(rng.integers(-127, 128, (blocks, H, bs, D)).astype(np.int8)).to(cuda)
        vp = torch.from_numpy(rng.integers(-127, 128, (blocks, H, bs, D)).astype(np.int8)).to(cuda)
        ks = torch.rand((blocks, H, 1, 1), device=cuda) * 0.05
        vs = torch.rand((blocks, H, 1, 1), device=cuda) * 0.05
    else:
        kp = torch.randn((blocks, H, bs, D), device=cuda).to(dtype)
        vp = torch.randn((blocks, H, bs, D), device=cuda).to(dtype)
        ks = vs = None
    q = torch.randn((B, H, S, D), device=cuda).to(dtype)
    table_t, base_t = torch.from_numpy(table).to(cuda), torch.from_numpy(base).to(cuda)
    before = kernels.launches["paged_attention"]
    got = paged_attention(q, kp, vp, table_t, base_t, ks, vs)
    torch.cuda.synchronize()
    assert kernels.launches["paged_attention"] == before + 1
    _close(got, reference_paged_attention(q, kp, vp, table_t, base_t, ks, vs))


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.randn((1, 2, 8, 32), device=cuda)  # head_dim 32: no kernel instantiation
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    q = torch.randn((1, 2, 16, 64), device=cuda)[:, :, ::2]  # non-contiguous
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
