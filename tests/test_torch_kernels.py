"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc``; they carry the ``cuda`` marker
and skip elsewhere. Run them on the GPU machine with

    python -m pytest tests/test_torch_kernels.py -m cuda -q

The file imports nothing of JAX, so it runs where JAX is not installed.
Tolerances: float32 atol 2e-5 (summation order only); bfloat16 atol 2e-2 +
rtol 2e-2 (the plain versions round the softmax weights to bf16 before the
value product, the kernels keep them in f32 or, in K1's bf16 body, as two bf16
parts). The backward kernels K2/K3
against ``reference_attention_backward`` (same lse, f32 arithmetic in the
plain version): float32 atol 1e-4 (gradients sum up to 256 terms of size ~1),
bfloat16 atol 2e-2 + rtol 2e-2 (the plain version rounds once, at the end;
the bf16 bodies also round dS once and P into two bf16 parts);
whole-autograd agreement with ``reference_attention`` uses the same two
tolerances. Each test also checks that the kernel's launch count moved.
The packed (segment-id) cases hold K1, K2 and K3 to the same tolerances, with
three segments and a padding tail, ids that recur non-contiguously with
interior zeros, and cross-length calls from one id array; padding queries get
zero outputs and padding keys exact-zero dK/dV. K1's bf16 body (128-row
query tiles of two 64-row warpgroups, 64-key tiles) is held at those tile
edges, with segment boundaries on and inside tiles, and its lse against
``torch.logsumexp`` of the plain masked scores (1e-4; -1e30 on rows that see
no key). K2's and K3's bf16 bodies (128-row tiles of queries or keys, 64 keys
at head_dim 128 in K3) are held at the same tile edges, packed tile edges and
rows that see no key, routed by dtype (by the profiler's kernel names), and
refuse a misaligned bf16 d_out; a packed forward + backward computes the skip
map once for self-attention.
"""

import importlib

import numpy as np
import pytest
import torch

from unionml_tpu_torch import _graphs, kernels
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


@pytest.mark.parametrize("S", [16, 32, 64])
def test_paged_kernel_at_a_hit_prefill(cuda, S):
    """A prefix-cache hit's suffix prefill: K4's query tile (bf16 over int8)
    at the block-aligned base 384, through a table row whose first 24 columns
    are spliced blocks scattered over the pool, then the slot's own blocks and
    scratch; against the plain version."""
    rng = np.random.default_rng(S)
    H, D, bs, base = 12, 64, 16, 384
    width, blocks = 1024 // bs + 1, 80
    ids = rng.permutation(blocks - 1)
    table = np.full((1, width), blocks - 1, dtype=np.int32)  # scratch tail
    table[0, : base // bs + S // bs] = ids[: base // bs + S // bs]
    kp, vp = (torch.from_numpy(rng.integers(-127, 128, (blocks, H, bs, D)).astype(np.int8)).to(cuda)
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.05, (blocks, H, 1, 1)).astype(np.float32)).to(cuda)
              for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((1, H, S, D), dtype=np.float32)).to(cuda, torch.bfloat16)
    t, pos = torch.from_numpy(table).to(cuda), torch.tensor([base], dtype=torch.int32, device=cuda)
    got = paged_attention(q, kp, vp, t, pos, ks, vs)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), reference_paged_attention(q, kp, vp, t, pos, ks, vs).float(),
                               atol=atol, rtol=rtol)


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


# ---------------------------------------------- K2/K3's bf16 tensor-core bodies

def _backward_case(cuda, dtype, Sq, S, D, causal, lens=None, ids=None, seed=0, heads=3):
    """K1's out and lse, then K2/K3 against the plain backward on the same
    out, lse and a non-contiguous d_out; returns the kernels' (dq, dk, dv)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((2, heads, Sq, D), generator=g).to(cuda, dtype)
    k, v = (torch.randn((2, heads, S, D), generator=g).to(cuda, dtype) for _ in range(2))
    d_out = torch.randn((2, Sq, heads, D), generator=g).to(cuda, dtype).transpose(1, 2)
    kv_lens = torch.tensor(lens, device=cuda) if lens else None
    out, lse = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, return_lse=True, segment_ids=ids)
    before = dict(kernels.launches)
    got = flash_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens, causal=causal, segment_ids=ids)
    torch.cuda.synchronize()
    assert kernels.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert kernels.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = reference_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens, causal=causal, segment_ids=ids)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a, b, BWD_TOL)
    for b, n in enumerate(lens or []):  # keys past kv_len: exact zeros, though outputs start empty
        assert torch.all(got[1][b, :, n:] == 0) and torch.all(got[2][b, :, n:] == 0)
        if n == 0:  # queries that see no key: exact zeros
            assert torch.all(got[0][b] == 0)
    if ids is not None:  # padding queries and keys: exact zeros
        assert torch.all(got[0].transpose(1, 2)[ids[:, :Sq] == 0] == 0)
        pad_keys = ids[:, :S] == 0
        assert torch.all(got[1].transpose(1, 2)[pad_keys] == 0) and torch.all(got[2].transpose(1, 2)[pad_keys] == 0)
    return got


@pytest.mark.parametrize("Sq,S,D,causal,lens", BF16_EDGE_CASES + [(128, 128, 64, False, [128, 64])])
def test_flash_backward_bf16_tile_edges_match_plain(cuda, Sq, S, D, causal, lens):
    """K2 (128 query rows per CTA) and K3 (128 keys, 64 at D 128) at their
    tile edges: Sq and Sk off multiples of 64 and 128, kv_len 0, 1, at tile
    edges and S, Sq != Sk both ways, D 128."""
    _backward_case(cuda, torch.bfloat16, Sq, S, D, causal, lens, seed=Sq * 5 + S)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", list(EDGE_IDS))
def test_flash_backward_bf16_packed_tile_edges_match_plain(cuda, case, causal, D):
    S, rows = EDGE_IDS[case]
    _backward_case(cuda, torch.bfloat16, S, S, D, causal, ids=_ids(rows).to(cuda), seed=S + D + causal)


@pytest.mark.parametrize("case", list(LSE_CASES))
def test_flash_backward_bf16_takes_nothing_from_dead_rows(cuda, case):
    """Rows that see no key carry lse -1e30: K2/K3 select them away (zero dQ
    there, nothing leaks into dK/dV)."""
    Sq, S, D, causal, lens, rows = LSE_CASES[case]
    ids = _ids(rows).to(cuda) if rows else None
    _backward_case(cuda, torch.bfloat16, Sq, S, D, causal, lens, ids=ids, seed=Sq + S)


def _kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if "flash_bwd" in e.key}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_bodies_are_chosen_by_dtype(cuda, dtype):
    """bf16 runs the tensor-core bodies, f32 the CUDA-core ones, by the
    profiler's kernel names."""
    q, k, v = (torch.randn((2, 3, 100, 64), device=cuda).to(dtype) for _ in range(3))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    names = " ".join(_kernel_names(lambda: flash_attention_backward(q, k, v, out, lse, out, causal=True)))
    tensor_core = dtype == torch.bfloat16
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert (f"{kernel}_wgmma_kernel" in names) == tensor_core, names
        assert (f"{kernel}_kernel" in names) == (not tensor_core), names


def test_backward_bf16_misaligned_d_out_raises(cuda):
    q = torch.randn((1, 2, 16, 64), device=cuda).to(torch.bfloat16)
    out, lse = flash_attention(q, q, q, return_lse=True)
    # contiguous but not 16-byte aligned: TMA cannot read it, and no fallback takes it
    d_out = torch.randn(2 * 16 * 64 + 1, device=cuda).to(torch.bfloat16)[1:].view(1, 2, 16, 64)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_backward(q, q, q, out, lse, d_out)
    assert kernels.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("Sq,S", [(128, 128), (96, 160)], ids=["self", "cross"])
def test_packed_forward_backward_builds_the_skip_map_once(cuda, monkeypatch, Sq, S, dtype):
    """One packed forward + backward through autograd computes the ranges
    once for self-attention (K1's map serves K2 and K3) and once more for a
    cross-length call (K3's transposed map)."""
    attention_ops = importlib.import_module("unionml_tpu_torch.ops.attention")
    calls = []
    real = attention_ops._segment_ranges
    monkeypatch.setattr(attention_ops, "_segment_ranges", lambda *a: calls.append(1) or real(*a))
    ids = _ids(PACKED_CASES["Sq96-Sk160"][4]).to(cuda)
    g = torch.Generator().manual_seed(Sq)
    q = torch.randn((2, 3, Sq, 64), generator=g).to(cuda, dtype).requires_grad_()
    k, v = (torch.randn((2, 3, S, 64), generator=g).to(cuda, dtype).requires_grad_() for _ in range(2))
    out = flash_attention(q, k, v, causal=True, segment_ids=ids)
    got = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert len(calls) == (1 if Sq == S else 2)
    want = torch.autograd.grad(reference_attention(q, k, v, causal=True, segment_ids=ids), (q, k, v),
                               torch.ones_like(out))
    for a, b in zip(got, want):
        _close(a, b, BWD_TOL)


# ------------------------------------------------------------------ K4 bodies

PAGED_POOLS = [(torch.bfloat16, "int8"), (torch.bfloat16, "full"), (torch.float32, "int8"), (torch.float32, "full")]
PAGED_S = [1, 2, 5, 15, 16, 17, 63, 64, 65, 127, 128, 129, 144, 256]


def _paged_inputs(device, dtype, pool, bases, S, D=64, bs=16, width=None, heads=4, seed=0):
    """Pools holding every block the rows' last queries need plus one scratch
    block, tables mapping exactly those (the tail on the scratch block), and
    one mapped block of scale 0 (an empty block dequantizes to zeros)."""
    rng = np.random.default_rng(seed)
    bases = np.asarray(bases, dtype=np.int64)
    need = (bases + S - 1) // bs + 1
    width = width or int(need.max()) + 1
    blocks = int(need.sum()) + 1
    table = np.full((len(bases), width), blocks - 1, dtype=np.int32)
    perm, start = rng.permutation(blocks - 1), 0
    for b, n in enumerate(need):
        table[b, :n] = perm[start:start + n]
        start += n
    shape = (blocks, heads, bs, D)
    if pool == "int8":
        kp, vp = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(device) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.05, (blocks, heads, 1, 1)).astype(np.float32)).to(device)
                  for _ in range(2))
        ks[int(perm[0])] = 0.0
        vs[int(perm[0])] = 0.0
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype) for _ in range(2))
        ks = vs = None
    q = torch.from_numpy(rng.standard_normal((len(bases), heads, S, D), dtype=np.float32)).to(device, dtype)
    return q, kp, vp, torch.from_numpy(table).to(device), torch.from_numpy(bases).to(device), ks, vs


def _paged_bases(S, bs):
    """Decode rows at block edges (pos % bs of 0 and bs - 1) and across a
    16-column split; chunks at base 0 and at a base whose queries cross a
    split and a 64-key tile boundary."""
    split = 16 * bs
    if S <= 8:
        return [0, bs - 1, bs, 3 * bs - 1, split - 1, split, 2 * split - S // 2]
    return [0, max(bs - 1, split - S // 2 - 3)]


@pytest.mark.parametrize("dtype,pool", PAGED_POOLS, ids=["bf16-int8", "bf16-bf16", "f32-int8", "f32-f32"])
@pytest.mark.parametrize("S,D,bs", [(S, 64, bs) for S in PAGED_S for bs in (8, 16, 32)] +
                         [(S, 128, 16) for S in PAGED_S])
def test_paged_bodies_match_plain(cuda, dtype, pool, S, D, bs):
    q, kp, vp, table, base, ks, vs = _paged_inputs(cuda, dtype, pool, _paged_bases(S, bs), S, D=D, bs=bs, seed=S + bs)
    before = kernels.launches["paged_attention"]
    got = paged_attention(q, kp, vp, table, base, ks, vs)
    torch.cuda.synchronize()
    assert kernels.launches["paged_attention"] == before + 1
    _close(got, reference_paged_attention(q, kp, vp, table, base, ks, vs))


@pytest.mark.parametrize("dtype,pool", PAGED_POOLS, ids=["bf16-int8", "bf16-bf16", "f32-int8", "f32-f32"])
@pytest.mark.parametrize("width", [65, 129])
def test_paged_long_context_decode_matches_plain(cuda, dtype, pool, width):
    bases = [1000, 1003, 1007, 1008, 1011, 1015, 1016, 1022]
    q, kp, vp, table, base, ks, vs = _paged_inputs(cuda, dtype, pool, bases, 1, width=width, heads=12, seed=width)
    _close(paged_attention(q, kp, vp, table, base, ks, vs), reference_paged_attention(q, kp, vp, table, base, ks, vs))


@pytest.mark.parametrize("dtype,pool", PAGED_POOLS, ids=["bf16-int8", "bf16-bf16", "f32-int8", "f32-f32"])
def test_paged_decode_is_bitwise_invariant_to_batch_and_width(cuda, dtype, pool):
    """One row's decode output is bitwise the same alone, in a batch of 8 and
    under a 129-column table that maps the same blocks."""
    bases = [5, 1000, 250, 16, 1022, 511, 64, 777]
    q, kp, vp, table, base, ks, vs = _paged_inputs(cuda, dtype, pool, bases, 1, width=65, heads=12, seed=3)
    batch = paged_attention(q, kp, vp, table, base, ks, vs)
    wide = torch.cat([table, table[:, -1:].expand(-1, 64)], dim=1).contiguous()
    batch_wide = paged_attention(q, kp, vp, wide, base, ks, vs)
    for r in range(len(bases)):
        alone = paged_attention(q[r:r + 1].contiguous(), kp, vp, table[r:r + 1].contiguous(), base[r:r + 1], ks, vs)
        assert torch.equal(alone[0], batch[r]) and torch.equal(batch_wide[r], batch[r]), r


@pytest.mark.parametrize("dtype,pool", PAGED_POOLS, ids=["bf16-int8", "bf16-bf16", "f32-int8", "f32-f32"])
def test_paged_retired_row_at_the_sentinel_leaves_other_rows_alone(cuda, dtype, pool):
    bases = [40, 300, 1000]
    q, kp, vp, table, base, ks, vs = _paged_inputs(cuda, dtype, pool, bases, 1, width=65, heads=12, seed=9)
    want = paged_attention(q, kp, vp, table, base, ks, vs)
    table[1] = table[1, -1]  # row 1 retired: every column on the scratch block, at the sentinel position
    base[1] = (table.shape[1] - 1) * kp.shape[2]
    got = paged_attention(q, kp, vp, table, base, ks, vs)
    assert torch.isfinite(got[1].float()).all()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    live = [0, 2]
    _close(got[live], reference_paged_attention(q, kp, vp, table, base, ks, vs)[live])


@pytest.mark.parametrize("dtype,pool", PAGED_POOLS, ids=["bf16-int8", "bf16-bf16", "f32-int8", "f32-f32"])
@pytest.mark.parametrize("S", [1, 64])
def test_paged_query_that_sees_one_key_returns_its_value_exactly(cuda, dtype, pool, S):
    """Base 0: query 0 sees key 0 alone, so its output is key 0's value as
    the plain version dequantizes it, bit for bit (both bodies' value
    rounding, without the softmax's)."""
    q, kp, vp, table, base, ks, vs = _paged_inputs(cuda, dtype, pool, [0], S, heads=12)
    blk = int(table[0, 0])
    if ks is not None:  # key 0's block is the one of scale 0: give it a scale
        ks[blk] = 0.0371
        vs[blk] = 0.0293
    got = paged_attention(q, kp, vp, table, base, ks, vs)[0, :, 0]
    want = vp[blk, :, 0].float() * vs[blk, :, 0] if ks is not None else vp[blk, :, 0]
    assert torch.equal(got, want.to(dtype))


def _paged_kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages() if "paged_" in e.key)


@pytest.mark.parametrize("dtype,pool", PAGED_POOLS, ids=["bf16-int8", "bf16-bf16", "f32-int8", "f32-f32"])
@pytest.mark.parametrize("S", [1, 256])
def test_paged_bodies_are_chosen_by_the_launch_plan(cuda, dtype, pool, S):
    from unionml_tpu_torch.ops.paged_attention import launch_plan

    q, kp, vp, table, base, ks, vs = _paged_inputs(cuda, dtype, pool, [300], S, heads=12)
    names = _paged_kernel_names(lambda: paged_attention(q, kp, vp, table, base, ks, vs))
    plan = launch_plan(1, 12, S, 64, dtype, kp.dtype, table.shape[1], kp.shape[2])
    assert all(k in names for k in plan.kernels), names
    others = {"paged_decode_kernel", "paged_merge_kernel", "paged_tile_wgmma_kernel", "paged_tile_f32_kernel",
              "paged_attention_kernel"} - set(plan.kernels)
    assert not any(k in names for k in others), names


def test_paged_wrapper_raises_instead_of_falling_back(cuda):
    q, kp, vp, table, base, ks, vs = _paged_inputs(cuda, torch.bfloat16, "int8", [0], 64, bs=48)
    before = kernels.launches["paged_attention"]
    with pytest.raises(ValueError):  # the bf16 query tile takes block sizes that divide 64
        paged_attention(q, kp, vp, table, base, ks, vs)
    q, kp, vp, table, base, ks, vs = _paged_inputs(cuda, torch.bfloat16, "int8", [0], 64)
    q = torch.randn(q.numel() + 1, device=cuda).to(torch.bfloat16)[1:].view(q.shape)  # not 16-byte aligned
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_attention(q, kp, vp, table, base, ks, vs)
    assert kernels.launches["paged_attention"] == before


@pytest.mark.parametrize("dtype,pool", PAGED_POOLS, ids=["bf16-int8", "bf16-bf16", "f32-int8", "f32-f32"])
def test_verify_chunk_on_the_kernel_matches_plain(cuda, dtype, pool):
    """The speculative verify (``models/gpt.py::_paged_verify_chunk``) at the
    engine's shape: 8 rows, 5 chunk positions each, ragged bases and a row at
    the sentinel, K4 over the local copy against the plain version; the pool
    untouched and K4 launched once per chunk position."""
    from unionml_tpu_torch.models.gpt import _paged_verify_chunk

    bases = [5, 1000 - 5, 250, 16, 511, 64, 777, 1024]
    q, kp, vp, table, base, ks, vs = _paged_inputs(cuda, dtype, pool, [min(b, 1018) for b in bases], 5, heads=12,
                                                   width=65)
    base = torch.tensor(bases, dtype=torch.int32, device=cuda)
    k, v = (torch.randn(q.shape, device=cuda).to(dtype) for _ in range(2))
    cache = {"k": kp, "v": vp, **({"k_scale": ks, "v_scale": vs} if ks is not None else {})}
    before = {n: x.clone() for n, x in cache.items()}
    launches = kernels.launches["paged_attention"]
    got = _paged_verify_chunk(cache, table, base, q, k, v, dtype)
    assert kernels.launches["paged_attention"] == launches + 5
    want = _paged_verify_chunk(cache, table, base, q, k, v, dtype, impl="reference")
    _close(got[:7], want[:7])
    assert all(torch.equal(cache[n], before[n]) for n in cache)


@pytest.mark.parametrize("spec", [False, True], ids=["decode-burst", "speculative-round"])
def test_graph_replay_matches_the_eager_program(cuda, spec):
    """A decode burst's and a speculative round's CUDA graphs (f32, a small GPT
    at head_dim 64) against the same programs run eagerly: identical streams,
    every dispatch a replay, and K4's launch count that of the eager run plus
    the captures' warm-ups (a replay counts its graph's launches, the
    recording none)."""
    from unionml_tpu_torch.models import GPTConfig, init_gpt
    from unionml_tpu_torch.serving import DecodeEngine, SpeculativeEngine

    model = init_gpt(GPTConfig.tiny(hidden_size=128, num_heads=2, max_position_embeddings=256, dtype=torch.float32),
                     std=0.3, device=cuda)
    kw = dict(num_slots=4, max_len=256, prefill_buckets=(16, 32), kv_quantize="int8", device=cuda)
    requests = [([3, 1, 4, 1, 5], 20, {"speculative": True} if spec else {}),
                ([2, 7, 1, 8, 2, 8], 14, {"speculative": True, "temperature": 0.8, "seed": 3} if spec else {}),
                ([9] * 20, 9, {})]

    def run(eager):
        engine = SpeculativeEngine(model, model, **kw) if spec else DecodeEngine(model, **kw)
        if eager:
            engine._run_program = lambda key, fn, generators=(): fn()
        slots = engine.admit_many(requests)
        streams = {s: [] for s in slots}
        while engine.num_active:
            for ev in engine.step():
                if ev.emit:
                    streams[ev.slot].append(ev.token)
        return [streams[s] for s in slots], engine

    kernels.reset_launches()
    graphs, engine = run(eager=False)
    on_graphs = kernels.launches["paged_attention"]
    kernels.reset_launches()
    assert graphs == run(eager=True)[0]
    assert engine._step_fns and engine.pipeline_stats()["step_dispatches"] == sum(
        g.replays for g in engine._step_fns.values())
    warmups = _graphs._WARMUP_RUNS * sum(g.launches.get("paged_attention", 0) for g in engine._step_fns.values())
    assert warmups > 0 and on_graphs == kernels.launches["paged_attention"] + warmups
