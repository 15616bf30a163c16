"""Port parity: sequence packing and the segment-id (packed) mode of attention.

- ``pack_sequences`` is byte-identical to the JAX ``pack_sequences(impl=
  "python")`` over seeded corpora (truncation, ``max_segments_per_row`` and
  empty sequences included); ``packing_efficiency`` equals the JAX one.
- ``reference_attention(segment_ids=...)`` against ``xla_attention`` and the
  Pallas ``_flash_forward(..., interpret=True, segment_ids=...)`` at
  tile-aligned shapes with explicit 16x16 blocks, and
  ``reference_attention_backward(segment_ids=...)`` against the Pallas
  ``_flash_backward`` in interpret mode fed the JAX forward's own ``out`` and
  ``lse``: float32 inputs from a numpy seed, atol 1e-5 (the same f32
  arithmetic in another summation order). Id layouts: packed rows with a
  padding tail, ids that recur non-contiguously, interior zeros, a fully
  padded row, and cross-length calls (``Sq != Sk``, both ways, from one id
  array).
- The skip ranges (``_segment_ranges``), reduced over tiles, equal the JAX
  ``_segment_block_bounds`` exactly, and the kernels' ``kv_len`` equals the
  JAX ``_segment_arrays`` one. The bf16 bodies' work orders (K1, and K2/K3
  over query or key tiles) are stable descending permutations of the tiles
  by scan length, with the scan lengths of the plain mask and of
  ``_segment_block_bounds``; the backward's skip maps built from K1's equal
  fresh ones, with no ranges recomputed for self-attention.
- The port's autograd through ``flash_attention(segment_ids=...)`` equals
  autograd of the plain version (atol 1e-5) and passes ``gradcheck`` in
  float64 (its default tolerances).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.ops import packing as jpacking
from unionml_tpu_torch import kernels
from unionml_tpu_torch.ops import packing as tpacking

jattn = importlib.import_module("unionml_tpu.ops.attention")
tattn = importlib.import_module("unionml_tpu_torch.ops.attention")

ATOL = 1e-5
H, D = 2, 64


def _corpus(seed, n, seq_len):
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(seq_len / 4), 0.8, n).astype(np.int64), 0, 2 * seq_len)
    return [rng.integers(1, 50_000, int(m)).astype(np.int32) for m in lengths]


@pytest.mark.parametrize("seed,n,seq_len,max_segments", [
    (0, 200, 64, 0), (1, 150, 32, 3), (2, 100, 128, 0), (3, 80, 16, 2), (4, 40, 512, 1),
])
def test_pack_sequences_is_byte_identical_to_jax(seed, n, seq_len, max_segments):
    corpus = _corpus(seed, n, seq_len)
    corpus[3] = np.zeros((0,), np.int32)  # an empty sequence is dropped by both
    want = jpacking.pack_sequences(corpus, seq_len, max_segments_per_row=max_segments, impl="python")
    got = tpacking.pack_sequences(corpus, seq_len, max_segments_per_row=max_segments)
    assert set(got) == set(want)
    assert got["truncated"] == want["truncated"]
    for key in ("input_ids", "segment_ids", "positions"):
        assert got[key].dtype == want[key].dtype and got[key].tobytes() == want[key].tobytes(), key


def test_pack_sequences_options_and_unported_native():
    empty = tpacking.pack_sequences([], 8, pad_id=7)
    assert empty["input_ids"].tolist() == [[7] * 8] and empty["truncated"] == 0
    assert tpacking.pack_sequences([np.arange(20)], 8, impl="python")["truncated"] == 1
    # the native packer is ported (tests/test_torch_native.py): the same arrays as the Python loop
    corpus = _corpus(4, 30, 8)
    native, python = (tpacking.pack_sequences(corpus, 8, impl=impl) for impl in ("native", "python"))
    assert native["truncated"] == python["truncated"] > 0
    assert all(native[k].tobytes() == python[k].tobytes() for k in ("input_ids", "segment_ids", "positions"))
    with pytest.raises(ValueError):
        tpacking.pack_sequences([np.arange(3)], 0)
    with pytest.raises(ValueError):
        tpacking.pack_sequences([np.arange(3)], 8, impl="cpp")


@pytest.mark.parametrize("segs", [np.zeros((0, 4), np.int32), np.asarray([[1, 1, 2, 0], [0, 0, 0, 0]]),
                                  np.asarray([[3, 3, 3, 3]])], ids=["empty", "half", "full"])
def test_packing_efficiency_matches_jax(segs):
    assert tpacking.packing_efficiency(segs) == jpacking.packing_efficiency(segs)


# ------------------------------------------------------- segment-id attention

def _row(*runs):
    return sum(([seg] * n for seg, n in runs), [])


LAYOUTS = {
    # row 0: three segments and a padding tail; row 1: one segment fills it
    "packed": [_row((1, 10), (2, 13), (3, 5), (0, 4)), _row((1, 32))],
    # id 1 recurs after id 2; id 5 around id 7
    "non-contiguous": [_row((1, 8), (2, 8), (1, 8), (3, 8)), _row((5, 4), (7, 20), (5, 8))],
    # zeros inside a row, and a row that starts with padding
    "interior-zeros": [_row((1, 6), (0, 4), (1, 6), (2, 10), (0, 6)), _row((0, 3), (4, 29))],
    "fully-padded-row": [_row((0, 32)), _row((1, 16), (2, 16))],
}
# one id array, sliced per axis: row 0 ends in padding; every live query of
# either slicing sees at least one key
CROSS_IDS = [_row((1, 20), (2, 20), (0, 8)), _row((1, 30), (3, 18))]


def _qkv(sq, sk, seed, batch=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(batch, H, sq, D)).astype(np.float32)
    k, v = (rng.normal(size=(batch, H, sk, D)).astype(np.float32) for _ in range(2))
    return q, k, v, rng.normal(size=(batch, H, sq, D)).astype(np.float32)


def _jax_forward(q, k, v, ids, causal):
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    return jattn._flash_forward(jq, jk, jv, None, causal, D ** -0.5, 16, 16, True, return_residuals=True,
                                segment_ids=jnp.asarray(ids))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_forward_matches_xla_and_pallas(layout, causal):
    ids = np.asarray(LAYOUTS[layout], np.int32)
    q, k, v, _ = _qkv(32, 32, seed=len(layout) + causal)
    got = tattn.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                    segment_ids=torch.from_numpy(ids)).numpy()
    xla = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              segment_ids=jnp.asarray(ids))
    pallas, _ = _jax_forward(q, k, v, ids, causal)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)
    assert np.all(got.transpose(0, 2, 1, 3)[ids == 0] == 0)  # padding rows write zeros


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,sk", [(32, 48), (48, 32)], ids=["Sq<Sk", "Sq>Sk"])
def test_cross_length_forward_matches_xla_and_pallas(sq, sk, causal):
    ids = np.asarray(CROSS_IDS, np.int32)
    q, k, v, _ = _qkv(sq, sk, seed=sq + causal)
    got = tattn.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                    segment_ids=torch.from_numpy(ids)).numpy()
    xla = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              segment_ids=jnp.asarray(ids))
    pallas, _ = _jax_forward(q, k, v, ids, causal)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=0)


def _backward_case(ids, sq, sk, causal, seed):
    q, k, v, g = _qkv(sq, sk, seed)
    out, lse = _jax_forward(q, k, v, ids, causal)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    want = jattn._flash_backward(jq, jk, jv, None, out, lse, jg, causal, D ** -0.5, 16, 16, True,
                                 segment_ids=jnp.asarray(ids))
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, g)]
    got = tattn.reference_attention_backward(*t, causal=causal, segment_ids=torch.from_numpy(ids))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=f"d{name}")
    return got


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_backward_matches_pallas_kernels(layout, causal):
    ids = np.asarray(LAYOUTS[layout], np.int32)
    dq, dk, dv = _backward_case(ids, 32, 32, causal, seed=3 * len(layout) + causal)
    pad = torch.from_numpy(ids == 0)
    # padding queries and keys get exact zeros
    for grad in (dq, dk, dv):
        assert torch.all(grad.transpose(1, 2)[pad] == 0)


@pytest.mark.parametrize("sq,sk", [(32, 48), (48, 32)], ids=["Sq<Sk", "Sq>Sk"])
def test_cross_length_backward_matches_pallas_kernels(sq, sk):
    _backward_case(np.asarray(CROSS_IDS, np.int32), sq, sk, True, seed=sq * 3 + sk)


@pytest.mark.parametrize("block,other", [(16, 16), (32, 16), (16, 64), (64, 64), (128, 64)])
def test_skip_ranges_reduce_to_jax_block_bounds(block, other):
    """The skip map reduced over tiles of ``block`` rows (``_tile_ranges``, as
    the kernels reduce it: 32-row tiles in K2/K3 and K1's f32 body, 64- and
    128-row tiles in K1's bf16 body) equals ``_segment_block_bounds``."""
    rng = np.random.default_rng(block + other)
    ids = np.concatenate([np.asarray(LAYOUTS[name], np.int32) for name in LAYOUTS])
    ids = np.concatenate([ids, ids[:, ::-1]], axis=1)  # 64 positions; ids recur in reverse
    ids[0, 5:9] = [100, 200, -3, 100]  # out-of-range and negative ids share the clip buckets
    ids[1] = rng.integers(0, 4, 64)
    width = max(64, 2 * block)
    ids = np.tile(ids, (1, width // 64))
    half = width // 2
    for own, other_ids in ((ids, ids), (ids[:, :half], ids), (ids, ids[:, :half])):
        ranges = tattn._segment_ranges(torch.from_numpy(own), torch.from_numpy(other_ids))
        lo, hi = (x.numpy() for x in tattn._tile_ranges(ranges, block))
        want_start, want_stop = jattn._segment_block_bounds((jnp.asarray(own), jnp.asarray(other_ids)), block,
                                                            other)
        np.testing.assert_array_equal((lo // other).reshape(-1), np.asarray(want_start))
        np.testing.assert_array_equal((-(-hi // other)).reshape(-1), np.asarray(want_stop))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq", [77, 256, 1024])
def test_k1_work_order_is_a_stable_descending_permutation(seq, causal):
    """K1's bf16 launch order in packed mode: every 128-row query tile once,
    by descending count of 64-key tiles its scan visits (counted here from
    the plain per-row mask), ties in index order, the same on every call."""
    rng = np.random.default_rng(seq)
    rows = []
    for _ in range(3):
        lengths = np.clip(rng.lognormal(np.log(seq / 4), 0.8, 64).astype(np.int64), 1, seq)
        row = np.concatenate([np.full(n, i + 1) for i, n in enumerate(lengths)])[:seq]
        row[len(row) - int(rng.integers(0, seq // 8)):] = 0  # a padding tail
        rows.append(row)
    ids = torch.from_numpy(np.stack(rows).astype(np.int32))
    ranges = tattn._segment_ranges(ids, ids)
    lens = tattn._segment_kv_lens(ids, seq)
    order = tattn._work_order(ranges, lens, causal, tattn._K1_BLOCK_Q)
    n_tiles = -(-seq // tattn._K1_BLOCK_Q)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(3 * n_tiles))
    assert torch.equal(order, tattn._work_order(ranges, lens, causal, tattn._K1_BLOCK_Q))
    # the scan of each tile from the ids alone: key tiles from the first to the
    # last key any of its rows may see
    visible = tattn._combined_mask(None, None, ids, seq, seq)[:, 0]
    if causal:
        visible = visible & torch.ones((seq, seq), dtype=torch.bool).tril()
    work = []
    for b in range(3):
        for m in range(n_tiles):
            keys = torch.nonzero(visible[b, m * 128:(m + 1) * 128].any(dim=0))[:, 0]
            work.append(0 if keys.numel() == 0 else int(keys[-1]) // 64 + 1 - int(keys[0]) // 64)
    got = [work[i] for i in order.tolist()]
    assert got == sorted(work, reverse=True)
    for a, b in zip(order.tolist(), order.tolist()[1:]):
        assert work[a] > work[b] or a < b  # ties keep index order


def test_kernel_kv_lens_are_the_last_nonzero_index_plus_one():
    ids = np.asarray([_row((1, 6), (0, 4), (2, 6)), _row((0, 16)), _row((3, 16))], np.int32)
    for seq_k in (16, 12):
        _, _, want = jattn._segment_arrays(jnp.asarray(ids), 16, seq_k)
        got = tattn._segment_kv_lens(torch.from_numpy(ids), seq_k)
        assert got.dtype == torch.int32 and got.tolist() == np.asarray(want).tolist()


def test_segment_ids_with_kv_lens_raise():
    q = torch.zeros((1, 1, 4, 64))
    ids, lens = torch.ones((1, 4), dtype=torch.int32), torch.tensor([4])
    for call in (
        lambda: tattn.flash_attention(q, q, q, kv_lens=lens, segment_ids=ids),
        lambda: tattn.attention(q, q, q, kv_lens=lens, segment_ids=ids),
        lambda: tattn.attention(q, q, q, kv_lens=lens, segment_ids=ids, impl="kernel"),
        lambda: tattn.flash_attention_backward(q, q, q, q, q[..., 0], q, kv_lens=lens, segment_ids=ids),
    ):
        with pytest.raises(ValueError, match="segment_ids already encodes padding"):
            call()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_packed_autograd_matches_plain_autograd_on_cpu(causal):
    ids = torch.tensor(LAYOUTS["interior-zeros"], dtype=torch.int32)
    q, k, v, g = (torch.from_numpy(x) for x in _qkv(32, 32, seed=9 + causal))
    before = dict(kernels.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(*leaves, causal=causal, segment_ids=ids)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(tattn.reference_attention(*ref_leaves, causal=causal, segment_ids=ids), ref_leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert kernels.launches == before


def test_packed_gradcheck_double():
    gen = torch.Generator().manual_seed(0)
    ids = torch.tensor([[1, 1, 2, 2, 0], [3, 0, 3, 3, 3]])
    q, k, v = (torch.randn((2, 2, 5, 4), generator=gen, dtype=torch.float64).requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tattn.flash_attention(a, b, c, causal=True, segment_ids=ids), (q, k, v)
    )


def _random_packed_rows(seed, batch, seq):
    """Packed rows with interior zeros and ids that recur non-contiguously."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(batch):
        row = np.zeros(seq, np.int64)
        pos = 0
        while pos < seq:
            n = int(rng.integers(1, seq // 3 + 2))
            row[pos:pos + n] = rng.integers(0, 6)  # 0: an interior run of padding; ids 1..5 recur
            pos += n
        rows.append(row)
    return torch.from_numpy(np.stack(rows).astype(np.int32))


@pytest.mark.parametrize("seq", [48, 200])
def test_self_attention_skip_map_is_its_own_transpose(seq):
    """For self-attention both axes read one id slice, so K3's map (query
    ranges per key) is K2's (key ranges per query): one tensor serves both.
    Each position's range is its id's extent on the other axis (the dense
    mask's first and last hit), empty for padding."""
    ids = _random_packed_rows(seq, 4, seq)
    q_map = tattn._segment_ranges(ids[:, :seq], ids[:, :seq])
    k_map = tattn._segment_ranges(ids[:, :seq].clone(), ids[:, :seq].clone())
    assert torch.equal(q_map, k_map)
    same = tattn._segment_mask(ids, seq, seq)[:, 0]
    pos = torch.arange(seq)
    first = torch.where(same, pos, seq).amin(-1)
    end = torch.where(same, pos + 1, 0).amax(-1)
    assert torch.equal(q_map, torch.stack([first, end], -1).to(torch.int32))


@pytest.mark.parametrize("bf16,head_dim", [(True, 64), (True, 128), (False, 64)], ids=["bf16-D64", "bf16-D128", "f32"])
@pytest.mark.parametrize("seq_q,seq_k", [(200, 200), (96, 160), (160, 96)], ids=["self", "Sq<Sk", "Sq>Sk"])
def test_backward_maps_equal_a_fresh_computation(monkeypatch, seq_q, seq_k, bf16, head_dim):
    """K2 and K3 built from K1's map equal maps built from the ids alone;
    given K1's map, self-attention computes no ranges, cross-length one set."""
    ids = _random_packed_rows(seq_q + seq_k, 3, max(seq_q, seq_k))
    lens = tattn._segment_kv_lens(ids, seq_k)
    fresh_q = tattn._skip_map(ids, lens, seq_q, seq_k, True, bf16, tattn._K1_BLOCK_Q)  # K2's tiles are K1's
    fresh_k = tattn._skip_map(ids, lens, seq_k, seq_q, True, bf16, tattn._DKV_BLOCKS[head_dim], keys=True)
    fwd_map = fresh_q.clone()
    calls = []
    real = tattn._segment_ranges
    monkeypatch.setattr(tattn, "_segment_ranges", lambda *a: calls.append(1) or real(*a))
    q_map, k_map = tattn._backward_maps(ids, lens, seq_q, seq_k, True, head_dim, bf16, fwd_map)
    assert len(calls) == (0 if seq_q == seq_k else 1)
    assert torch.equal(q_map, fresh_q) and torch.equal(k_map, fresh_k)
    assert [t.dtype for t in (q_map, k_map)] == [torch.int32] * 2
    alone = tattn._backward_maps(ids, lens, seq_q, seq_k, True, head_dim, bf16)
    assert torch.equal(alone[0], fresh_q) and torch.equal(alone[1], fresh_k)


def _contiguous_segment_rows(seed, batch, seq):
    """Rows of contiguous segments (lognormal lengths) and a padding tail."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(batch):
        lengths = np.clip(rng.lognormal(np.log(seq / 4), 0.8, 64).astype(np.int64), 1, seq)
        row = np.concatenate([np.full(n, i + 1) for i, n in enumerate(lengths)])[:seq]
        row[len(row) - int(rng.integers(0, seq // 8)):] = 0
        rows.append(row)
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq", [256, 1024])
@pytest.mark.parametrize("kernel", ["k2", "k3"])
def test_backward_work_orders_follow_the_scan_lengths(kernel, seq, causal):
    """K2's and K3's bf16 work orders (128-row tiles of queries or keys, 64-row
    tiles scanned): a permutation of the tiles, scan lengths not increasing
    along it, ties in index order; the scan lengths equal those from the plain
    mask (K3: from the tile's first key on under causal) and those from JAX's
    ``_segment_block_bounds`` at 128-row tiles."""
    ids_np = _contiguous_segment_rows(seq + causal, 3, seq)
    ids = torch.from_numpy(ids_np)
    keys = kernel == "k3"
    ranges = tattn._segment_ranges(ids, ids)
    lens = tattn._segment_kv_lens(ids, seq)
    work = tattn._tile_work(ranges, lens, causal, 128, keys=keys)
    order = tattn._work_order(ranges, lens, causal, 128, keys=keys)
    flat = work.flatten().tolist()
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(len(flat)))
    along = [flat[i] for i in order.tolist()]
    assert along == sorted(flat, reverse=True)
    for a, b in zip(order.tolist(), order.tolist()[1:]):
        assert flat[a] > flat[b] or a < b
    # from the plain mask: the other axis's 64-row tiles from the first to the last visible row
    visible = tattn._combined_mask(None, None, ids, seq, seq)[:, 0]
    if causal:
        visible = visible & torch.ones((seq, seq), dtype=torch.bool).tril()
    if keys:
        visible = visible.transpose(1, 2)  # (batch, key, query)
    plain = []
    for b in range(3):
        for m in range(seq // 128):
            hit = torch.nonzero(visible[b, m * 128:(m + 1) * 128].any(dim=0))[:, 0]
            plain.append(0 if hit.numel() == 0 else int(hit[-1]) // 64 + 1 - int(hit[0]) // 64)
    assert flat == plain
    # from JAX's block bounds (units of 64 rows), with the kernels' kv_len and causal rules
    start, stop = (np.asarray(x).reshape(3, -1) for x in jattn._segment_block_bounds(
        (jnp.asarray(ids_np), jnp.asarray(ids_np)), 128, 64))
    tiles = np.arange(seq // 128)[None, :]
    kv = lens.numpy()[:, None]
    if keys:
        begin = np.maximum(start, 2 * tiles) if causal else start
        want = np.where((stop > begin) & (tiles * 128 < kv), stop - begin, 0)
    else:
        cap = -(-np.minimum(kv, (tiles + 1) * 128 if causal else seq) // 64)
        want = np.where(stop > start, np.maximum(np.minimum(stop, cap) - start, 0), 0)
    np.testing.assert_array_equal(work.numpy(), want)
