"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; they carry the ``cuda`` marker
and skip elsewhere. Run them on the GPU machine with

    python -m pytest tests/test_torch_kernels.py -m cuda -q

The file imports nothing of JAX, so it runs where JAX is not installed.
Tolerances: float32 atol 2e-5 (summation order only); bfloat16 atol 2e-2 +
rtol 2e-2 (the plain versions round the softmax weights to bf16 before the
value product, the kernels keep them in f32 or, in K1's bf16 body, as two bf16
parts). The backward kernels K2/K3
against ``reference_attention_backward`` (same lse, f32 arithmetic in both,
summation order only): float32 atol 1e-4 (gradients sum up to 256 terms of
size ~1), bfloat16 atol 2e-2 + rtol 2e-2 (both round to bf16 once, at the
end); whole-autograd agreement with ``reference_attention`` uses the same
two tolerances. Each test also checks that the kernel's launch count moved.
The packed (segment-id) cases hold K1, K2 and K3 to the same tolerances, with
three segments and a padding tail, ids that recur non-contiguously with
interior zeros, and cross-length calls from one id array; padding queries get
zero outputs and padding keys exact-zero dK/dV. K1's bf16 body (128-row
query tiles of two 64-row warpgroups, 64-key tiles) is held at those tile
edges, with segment boundaries on and inside tiles, and its lse against
``torch.logsumexp`` of the plain masked scores (1e-4; -1e30 on rows that see
no key).
"""

import numpy as np
import pytest
import torch

from unionml_tpu_torch import kernels
from unionml_tpu_torch.ops.attention import (
    _combined_mask,
    _kv_lens_to_mask,
    _masked_logits,
    flash_attention,
    flash_attention_backward,
    reference_attention,
    reference_attention_backward,
)
from unionml_tpu_torch.ops.paged_attention import paged_attention, reference_paged_attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}
BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    atol, rtol = tol[got.dtype]
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
    # bf16 contiguous but not 16-byte aligned: the tensor-core body refuses it
    q = torch.randn(2 * 16 * 64 + 1, device=cuda).to(torch.bfloat16)[1:].view(1, 2, 16, 64)
    before = kernels.launches["flash_fwd"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, q, q)
    assert kernels.launches["flash_fwd"] == before


# the bf16 body's 128-row query tiles (two warpgroups of 64) and 64-key tiles: Sq, Sk, D, causal, kv_lens
BF16_EDGE_CASES = [
    (63, 63, 64, True, None), (64, 64, 64, True, None), (65, 65, 64, True, None),
    (127, 127, 64, False, [127, 64]), (128, 128, 64, True, None), (129, 129, 64, False, [1, 0]),
    (1, 1, 64, True, None), (1, 129, 64, False, [129, 65]), (65, 129, 64, True, None),
    (129, 65, 64, True, None), (129, 129, 128, True, None), (127, 65, 128, False, [0, 1]),
    (200, 300, 128, True, [300, 129]),
]


@pytest.mark.parametrize("Sq,S,D,causal,lens", BF16_EDGE_CASES)
def test_flash_bf16_tile_edges_match_plain(cuda, Sq, S, D, causal, lens):
    g = torch.Generator().manual_seed(Sq * 3 + S)
    q = torch.randn((2, 3, Sq, D), generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn((2, 3, S, D), generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    kv_lens = torch.tensor(lens, device=cuda) if lens else None
    before = kernels.launches["flash_fwd"]
    got = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches["flash_fwd"] == before + 1
    mask = _kv_lens_to_mask(kv_lens, S) if kv_lens is not None else None
    _close(got, reference_attention(q, k, v, mask=mask, causal=causal))
    for b, n in enumerate(lens or []):
        if n == 0:  # a row that sees no key writes zeros
            assert torch.all(got[b] == 0)


# packed ids whose segment boundaries fall on 64-row tile edges (64, 128) and inside tiles
EDGE_IDS = {
    "on-tile-edges": (256, [[(1, 64), (2, 64), (3, 70), (0, 58)], [(4, 128), (5, 128)]]),
    "inside-tiles": (256, [[(1, 30), (2, 100), (3, 126)], [(1, 1), (2, 190), (0, 3), (3, 62)]]),
    "ragged-200": (200, [[(1, 65), (2, 63), (3, 72)], [(6, 129), (0, 71)]]),
}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", list(EDGE_IDS))
def test_flash_bf16_packed_tile_edges_match_plain(cuda, case, causal, D):
    S, rows = EDGE_IDS[case]
    ids = _ids(rows).to(cuda)
    g = torch.Generator().manual_seed(S + D + causal)
    q, k, v = (torch.randn((2, 3, S, D), generator=g).to(cuda, torch.bfloat16) for _ in range(3))
    before = kernels.launches["flash_fwd"]
    out = flash_attention(q, k, v, causal=causal, segment_ids=ids)
    torch.cuda.synchronize()
    assert kernels.launches["flash_fwd"] == before + 1
    _close(out, reference_attention(q, k, v, causal=causal, segment_ids=ids))
    assert torch.all(out.transpose(1, 2)[ids == 0] == 0)


LSE_CASES = {  # Sq, Sk, D, causal, kv_lens, (seg, length) runs or None
    "kv_lens": (129, 129, 64, False, [129, 0], None),
    "causal-Sq-ne-Sk": (65, 200, 128, True, [200, 0], None),
    "packed": (256, 256, 64, True, None, [[(1, 64), (2, 100), (0, 92)], [(0, 10), (3, 246)]]),
}


@pytest.mark.parametrize("case", list(LSE_CASES))
def test_flash_bf16_lse_matches_logsumexp(cuda, case):
    """K1's bf16 lse against torch.logsumexp of the plain masked f32 scores
    (the same bf16 inputs): within 1e-4 on rows that see a key, exactly -1e30
    on rows that see none (K2/K3 read it)."""
    Sq, S, D, causal, lens, rows = LSE_CASES[case]
    g = torch.Generator().manual_seed(Sq + S)
    q = torch.randn((2, 3, Sq, D), generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn((2, 3, S, D), generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    kv_lens = torch.tensor(lens, device=cuda) if lens else None
    ids = _ids(rows).to(cuda) if rows else None
    _, lse = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, return_lse=True, segment_ids=ids)
    mask = _combined_mask(None, kv_lens, ids, Sq, S)
    logits, valid = _masked_logits(q, k, mask, causal, D ** -0.5)
    live = valid.expand(logits.shape).any(dim=-1)
    assert lse.dtype == torch.float32 and bool((~live).any())  # every case has a row that sees no key
    torch.testing.assert_close(lse[live], torch.logsumexp(logits, dim=-1)[live], atol=1e-4, rtol=0)
    assert torch.all(lse[~live] == -1e30)


BWD_CASES = [  # B, H, Sq, Sk, D, causal, kv_lens
    (2, 3, 128, 128, 64, False, [128, 1]), (3, 2, 100, 100, 64, False, [100, 37, 64]),
    (2, 3, 77, 77, 64, True, None), (1, 2, 256, 256, 64, True, None), (2, 3, 77, 77, 128, False, [77, 5]),
    (2, 2, 77, 77, 128, True, [77, 40]), (2, 2, 40, 9, 64, True, None), (2, 2, 5, 77, 64, False, [70, 77]),
    (2, 2, 130, 130, 64, False, [0, 130]),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,Sq,S,D,causal,lens", BWD_CASES)
def test_flash_backward_kernels_match_plain(cuda, dtype, B, H, Sq, S, D, causal, lens):
    g = torch.Generator().manual_seed(Sq * 7 + S)
    q = torch.randn((B, H, Sq, D), generator=g).to(cuda, dtype)
    k, v = (torch.randn((B, H, S, D), generator=g).to(cuda, dtype) for _ in range(2))
    # d_out as the head transpose leaves it: non-contiguous
    d_out = torch.randn((B, Sq, H, D), generator=g).to(cuda, dtype).transpose(1, 2)
    kv_lens = torch.tensor(lens, device=cuda) if lens else None
    out, lse = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, return_lse=True)
    before = dict(kernels.launches)
    got = flash_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert kernels.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = reference_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a, b, BWD_TOL)
    for b, n in enumerate(lens or []):  # keys past kv_len: exact zeros, though outputs start empty
        assert torch.all(got[1][b, :, n:] == 0) and torch.all(got[2][b, :, n:] == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,Sq,S,D,causal,lens", [BWD_CASES[0], BWD_CASES[2], BWD_CASES[4]])
def test_flash_autograd_matches_plain_autograd(cuda, dtype, B, H, Sq, S, D, causal, lens):
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn((B, H, n, D), generator=g).to(cuda, dtype).requires_grad_()
               for n in (Sq, S, S))
    d_out = torch.randn((B, H, Sq, D), generator=g).to(cuda, dtype)
    kv_lens = torch.tensor(lens, device=cuda) if lens else None
    before = kernels.launches["flash_bwd_dkv"]
    got = torch.autograd.grad(flash_attention(q, k, v, kv_lens=kv_lens, causal=causal), (q, k, v), d_out)
    assert kernels.launches["flash_bwd_dkv"] == before + 1
    mask = _kv_lens_to_mask(kv_lens, S) if kv_lens is not None else None
    want = torch.autograd.grad(reference_attention(q, k, v, mask=mask, causal=causal), (q, k, v), d_out)
    for a, b in zip(got, want):
        _close(a, b, BWD_TOL)


def _ids(rows):
    return torch.tensor([sum(([seg] * n for seg, n in row), []) for row in rows], dtype=torch.int32)


PACKED_CASES = {  # Sq, Sk, D, causal, (seg, length) runs per row of the id array
    "three-segments-tail": (77, 77, 64, True, [[(1, 20), (2, 33), (3, 14), (0, 10)], [(1, 77)]]),
    "non-contiguous-zeros": (128, 128, 64, True, [[(1, 30), (0, 6), (2, 40), (1, 20), (3, 32)],
                                                  [(0, 5), (4, 60), (0, 3), (4, 50), (5, 10)]]),
    "Sq96-Sk160": (96, 160, 64, True, [[(1, 50), (2, 70), (0, 40)], [(1, 100), (2, 60)]]),
    "Sq160-Sk96": (160, 96, 64, True, [[(1, 50), (2, 70), (0, 40)], [(1, 100), (2, 60)]]),
    "non-causal": (128, 128, 64, False, [[(1, 40), (2, 60), (0, 28)], [(3, 128)]]),
    "D128": (77, 77, 128, True, [[(1, 20), (2, 33), (3, 14), (0, 10)], [(2, 77)]]),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_packed_kernels_match_plain(cuda, dtype, case):
    Sq, S, D, causal, rows = PACKED_CASES[case]
    ids = _ids(rows).to(cuda)
    g = torch.Generator().manual_seed(Sq + S + D)
    q = torch.randn((2, 3, Sq, D), generator=g).to(cuda, dtype)
    k, v = (torch.randn((2, 3, S, D), generator=g).to(cuda, dtype) for _ in range(2))
    d_out = torch.randn((2, Sq, 3, D), generator=g).to(cuda, dtype).transpose(1, 2)
    before = dict(kernels.launches)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True, segment_ids=ids)
    got = flash_attention_backward(q, k, v, out, lse, d_out, causal=causal, segment_ids=ids)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.launches[name] == before[name] + 1, name
    _close(out, reference_attention(q, k, v, causal=causal, segment_ids=ids))
    assert torch.all(out.transpose(1, 2)[ids[:, :Sq] == 0] == 0)
    want = reference_attention_backward(q, k, v, out, lse, d_out, causal=causal, segment_ids=ids)
    for a, b in zip(got, want):
        _close(a, b, BWD_TOL)
    pad_keys = ids[:, :S] == 0
    assert torch.all(got[1].transpose(1, 2)[pad_keys] == 0) and torch.all(got[2].transpose(1, 2)[pad_keys] == 0)


def test_packed_autograd_matches_plain_autograd(cuda):
    dtype = torch.float32
    Sq, S, D, causal, rows = PACKED_CASES["non-contiguous-zeros"]
    ids = _ids(rows).to(cuda)
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, 3, S, D), generator=g).to(cuda, dtype).requires_grad_() for _ in range(3))
    d_out = torch.randn((2, 3, S, D), generator=g).to(cuda, dtype)
    got = torch.autograd.grad(flash_attention(q, k, v, causal=True, segment_ids=ids), (q, k, v), d_out)
    want = torch.autograd.grad(reference_attention(q, k, v, causal=True, segment_ids=ids), (q, k, v), d_out)
    for a, b in zip(got, want):
        _close(a, b, BWD_TOL)


def test_backward_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.randn((1, 2, 8, 64), device=cuda)
    out, lse = flash_attention(q, q, q, return_lse=True)
    with pytest.raises(ValueError):  # lse of the wrong dtype
        flash_attention_backward(q, q, q, out, lse.double(), out)
    with pytest.raises(ValueError):  # d_out on the CPU
        flash_attention_backward(q, q, q, out, lse, out.cpu())
