"""Port parity: paged attention (K4's plain version) against the JAX package.

The port's ``paged_attention`` on CPU tensors runs its plain version
(``reference_paged_attention``: gather, dequantize, attend); here it is held
against the JAX Pallas paged kernel run in interpret mode
(``paged_attention(impl="pallas", interpret=True)``) and against the JAX
``xla_paged_attention`` on the same pools, tables and base positions, made
with numpy from a seed: int8 pools with per-(block, head) scales and float32
pools, S in {1, 4}, ragged bases, unmapped tail columns on a scratch block.
Only live rows are compared (a retired row at the sentinel position attends
garbage the engine never samples). Tolerance: float32 atol 1e-5. The same
comparison runs at the engine's block size 16, with queries that cross a
block edge and chunks at a base past 0.

K4's launch plan (``launch_plan``: which body an (S, dtype, width, block
size) takes, its grid and the decode body's key splits) is checked on the
host: every table column falls in exactly one split, split boundaries sit at
fixed multiples of ``SPLIT_COLUMNS`` whatever the width, batch or S, the plan
needs no base, and combinations no body takes are refused. A float64 model
of the split-key decode (partials per split, merged over splits 0 .. the
query's last in order) is held to the plain version.
"""

import inspect

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jpaged = importlib.import_module("unionml_tpu.ops.paged_attention")
tpaged = importlib.import_module("unionml_tpu_torch.ops.paged_attention")

ATOL = 1e-5
HEADS, HD, BS, WIDTH = 2, 64, 4, 6  # width: 5 data columns + the scratch column


def _case(seed, batch, S, quantized, bs=BS, width=WIDTH, base=None):
    rng = np.random.default_rng(seed)
    blocks = batch * (width - 1) + 1
    scratch = blocks - 1
    if quantized:
        k = rng.integers(-127, 128, (blocks, HEADS, bs, HD)).astype(np.int8)
        v = rng.integers(-127, 128, (blocks, HEADS, bs, HD)).astype(np.int8)
        ks = rng.uniform(0.005, 0.05, (blocks, HEADS, 1, 1)).astype(np.float32)
        vs = rng.uniform(0.005, 0.05, (blocks, HEADS, 1, 1)).astype(np.float32)
        ks[0] = 0.0  # an empty block: scale 0 dequantizes to exact zeros
    else:
        k = rng.normal(size=(blocks, HEADS, bs, HD)).astype(np.float32)
        v = rng.normal(size=(blocks, HEADS, bs, HD)).astype(np.float32)
        ks = vs = None
    if base is None:
        base = rng.integers(0, (width - 1) * bs - S + 1, batch)
    base = np.asarray(base, dtype=np.int32)
    table = np.full((batch, width), scratch, dtype=np.int32)
    ids = rng.permutation(blocks - 1)
    for b in range(batch):
        live = (int(base[b]) + S - 1) // bs + 1
        table[b, :live] = ids[b * (width - 1): b * (width - 1) + live]
    q = rng.normal(size=(batch, HEADS, S, HD)).astype(np.float32)
    return q, k, v, table, base, ks, vs


def _jax(q, k, v, table, base, ks, vs, impl):
    j = lambda x: None if x is None else jnp.asarray(x)
    return np.asarray(jpaged.paged_attention(
        j(q), j(k), j(v), j(table), j(base), k_scale=j(ks), v_scale=j(vs),
        out_dtype=jnp.float32, impl=impl, interpret=True,
    ))


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("S,batch", [(1, 3), (4, 2), (4, 1)])
def test_plain_paged_attention_matches_jax_kernel_and_xla(quantized, S, batch):
    args = _case(seed=S * 10 + batch + quantized, batch=batch, S=S, quantized=quantized)
    t = lambda x: None if x is None else torch.from_numpy(x)
    port = tpaged.paged_attention(*(t(x) for x in args)).numpy()
    np.testing.assert_allclose(port, _jax(*args, impl="pallas"), atol=ATOL, rtol=0)
    np.testing.assert_allclose(port, _jax(*args, impl="xla"), atol=ATOL, rtol=0)


def test_retired_row_at_the_sentinel_is_not_compared_but_live_rows_are():
    q, k, v, table, base, ks, vs = _case(seed=7, batch=3, S=1, quantized=True)
    base[1] = (WIDTH - 1) * BS  # a retired row decodes at the sentinel position
    table[1, :] = table[1, -1]
    t = lambda x: None if x is None else torch.from_numpy(x)
    port = tpaged.paged_attention(*(t(x) for x in (q, k, v, table, base, ks, vs))).numpy()
    want = _jax(q, k, v, table, base, ks, vs, impl="pallas")
    live = [0, 2]
    np.testing.assert_allclose(port[live], want[live], atol=ATOL, rtol=0)


def test_reference_impl_and_scale_pairing():
    args = _case(seed=3, batch=2, S=1, quantized=True)
    t = [torch.from_numpy(x) for x in args]
    assert torch.equal(tpaged.paged_attention(*t, impl="reference"), tpaged.paged_attention(*t))
    with pytest.raises(ValueError):
        tpaged.paged_attention(*t[:5], k_scale=t[5])
    with pytest.raises(ValueError):
        tpaged.paged_attention(*t, impl="pallas")


@pytest.mark.parametrize("quantized", [True, False])
def test_fused_hbm_bytes_matches_jax_model(quantized):
    for width, bs, heads, hd in ((65, 16, 12, 64), (9, 4, 2, 128)):
        assert tpaged.fused_hbm_bytes(width, bs, heads, hd, quantized) == jpaged.fused_hbm_bytes(
            width, bs, heads, hd, quantized
        )


def _torch(args):
    return [None if x is None else torch.from_numpy(x) for x in args]


# the engine's block size: bases on and next to block edges, a query run that
# crosses one, and chunks at a base past 0 (one crossing into a fresh block)
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("S,base", [
    (1, [15, 16, 31]), (4, [14, 29, 0]), (20, [16]), (33, [37]),
], ids=["decode-edges", "S4-crossing", "chunk-base16", "chunk-base37"])
def test_plain_paged_attention_matches_jax_at_block_size_16(quantized, S, base):
    args = _case(seed=S + len(base), batch=len(base), S=S, quantized=quantized, bs=16, width=6, base=base)
    port = tpaged.paged_attention(*_torch(args)).numpy()
    np.testing.assert_allclose(port, _jax(*args, impl="pallas"), atol=ATOL, rtol=0)
    np.testing.assert_allclose(port, _jax(*args, impl="xla"), atol=ATOL, rtol=0)


# ------------------------------------------------------------ launch plan

WIDTHS = [1, 15, 16, 17, 33, 65, 129]


@pytest.mark.parametrize("width", WIDTHS)
def test_decode_splits_cover_every_column_exactly_once(width):
    plan = tpaged.launch_plan(8, 12, 1, 64, torch.bfloat16, torch.int8, width, 16)
    assert plan.body == "decode" and plan.splits == -(-width // tpaged.SPLIT_COLUMNS)
    covered = [c for i in range(plan.splits) for c in plan.split_columns(i)]
    assert sorted(covered) == list(range(width)) and len(covered) == width
    assert plan.grid == (plan.splits, 12, 8)
    assert plan.workspace_floats == 8 * 12 * 1 * plan.splits * (64 + 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_split_boundaries_do_not_depend_on_width_batch_or_s(dtype):
    kv = torch.int8
    plans = [tpaged.launch_plan(batch, 4, S, 64, dtype, kv, width, bs)
             for batch in (1, 8) for S in (1, 2, 5, 8) for width in WIDTHS for bs in (8, 16, 32)]
    for plan in plans:
        for i in range(plan.splits):
            cols = plan.split_columns(i)
            assert cols.start == i * tpaged.SPLIT_COLUMNS
            assert cols.stop == min((i + 1) * tpaged.SPLIT_COLUMNS, plan.width)
    # a row's columns fall in the same splits under a wider table
    narrow, wide = (tpaged.launch_plan(1, 4, 1, 64, dtype, kv, w, 16) for w in (65, 129))
    for i in range(narrow.splits - 1):
        assert narrow.split_columns(i) == wide.split_columns(i)


def test_launch_plan_needs_no_base_and_routes_by_host_facts():
    params = set(inspect.signature(tpaged.launch_plan).parameters)
    assert params == {"batch", "heads", "S", "head_dim", "dtype", "kv_dtype", "width", "block_size"}
    route = {}
    for S in (1, 2, 5, 8, 9, 15, 16, 17, 64, 129, 256):
        for dtype in (torch.bfloat16, torch.float32):
            plan = tpaged.launch_plan(1, 12, S, 64, dtype, torch.int8, 65, 16)
            route[S, dtype] = plan.kernels
    for (S, dtype), kernels in route.items():
        if S <= tpaged.DECODE_MAX_S:
            assert kernels == ("paged_decode_kernel", "paged_merge_kernel")
        elif dtype == torch.bfloat16:
            assert kernels == ("paged_tile_wgmma_kernel",)
        else:
            assert kernels == ("paged_tile_f32_kernel",)
    chunk = tpaged.launch_plan(1, 12, 256, 64, torch.bfloat16, torch.int8, 65, 16)
    assert chunk.grid == (4, 12, 1) and chunk.workspace_floats == 0 and chunk.split_columns(0) == range(65)
    assert tpaged.launch_plan(1, 12, 256, 128, torch.float32, torch.float32, 65, 16).grid == (8, 12, 1)


@pytest.mark.parametrize("args", [
    (1, 12, 256, 64, torch.bfloat16, torch.int8, 65, 48),      # the bf16 query tile: bs must divide 64
    (1, 12, 1, 32, torch.bfloat16, torch.int8, 65, 16),        # head_dim 32
    (1, 12, 1, 128, torch.float32, torch.float32, 65, 128),    # the decode ring does not fit
    (1, 12, 256, 64, torch.float16, torch.float16, 65, 16),    # no f16 body
    (1, 12, 256, 64, torch.bfloat16, torch.bfloat16, 60000, 16),  # the table does not fit
], ids=["bs48", "head_dim32", "decode-ring", "f16", "wide-table"])
def test_launch_plan_refuses_what_no_body_takes(args):
    with pytest.raises(ValueError):
        tpaged.launch_plan(*args)


def _split_key_decode(q, k, v, table, base, ks, vs):
    """float64 model of the decode body: per split (the plan's column runs)
    a partial (max, sum, unnormalised output) over the split's visible keys,
    merged over splits 0 .. the query's last, in order."""
    batch, heads, S, hd = q.shape
    bs, width = k.shape[2], table.shape[1]
    plan = tpaged.launch_plan(batch, heads, S, hd, torch.float32, torch.from_numpy(k).dtype, width, bs)
    out = np.zeros(q.shape)
    for b in range(batch):
        for h in range(heads):
            for s in range(S):
                pos = int(base[b]) + s
                last = min(pos // bs, width - 1) if pos >= 0 else -1
                parts = []
                for i in range(plan.splits):
                    cols = [c for c in plan.split_columns(i) if c <= last]
                    if not cols:
                        break
                    keys = np.concatenate([k[table[b, c], h].astype(np.float64) * (ks[table[b, c], h, 0, 0] if ks is not None else 1) for c in cols])
                    vals = np.concatenate([v[table[b, c], h].astype(np.float64) * (vs[table[b, c], h, 0, 0] if vs is not None else 1) for c in cols])
                    visible = np.arange(cols[0] * bs, (cols[-1] + 1) * bs) <= pos
                    scores = np.where(visible, keys @ q[b, h, s] * hd ** -0.5, -np.inf)
                    m = scores.max()
                    p = np.exp(scores - m)
                    parts.append((m, p.sum(), p @ vals))
                if parts:
                    m_all = max(m for m, _, _ in parts)
                    num = sum(acc * np.exp(m - m_all) for m, _, acc in parts)
                    den = sum(l * np.exp(m - m_all) for m, l, _ in parts)
                    out[b, h, s] = num / den
    return out


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("S,base,width,bs", [
    (1, [15, 16, 255, 256, 40], 33, 8), (2, [0, 33, 130], 40, 4), (5, [60, 3], 20, 16),
], ids=["decode-split-edges", "S2-three-splits", "S5"])
def test_split_key_decode_model_matches_plain(quantized, S, base, width, bs):
    args = _case(seed=len(base) + S, batch=len(base), S=S, quantized=quantized, bs=bs, width=width, base=base)
    want = tpaged.reference_paged_attention(*_torch(args)).numpy()
    np.testing.assert_allclose(_split_key_decode(*args), want, atol=ATOL, rtol=0)
