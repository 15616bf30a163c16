"""Port parity: paged attention (K4's plain version) against the JAX package.

The port's ``paged_attention`` on CPU tensors runs its plain version
(``reference_paged_attention``: gather, dequantize, attend); here it is held
against the JAX Pallas paged kernel run in interpret mode
(``paged_attention(impl="pallas", interpret=True)``) and against the JAX
``xla_paged_attention`` on the same pools, tables and base positions, made
with numpy from a seed: int8 pools with per-(block, head) scales and float32
pools, S in {1, 4}, ragged bases, unmapped tail columns on a scratch block.
Only live rows are compared (a retired row at the sentinel position attends
garbage the engine never samples). Tolerance: float32 atol 1e-5.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jpaged = importlib.import_module("unionml_tpu.ops.paged_attention")
tpaged = importlib.import_module("unionml_tpu_torch.ops.paged_attention")

ATOL = 1e-5
HEADS, HD, BS, WIDTH = 2, 64, 4, 6  # width: 5 data columns + the scratch column


def _case(seed, batch, S, quantized):
    rng = np.random.default_rng(seed)
    blocks = batch * (WIDTH - 1) + 1
    scratch = blocks - 1
    if quantized:
        k = rng.integers(-127, 128, (blocks, HEADS, BS, HD)).astype(np.int8)
        v = rng.integers(-127, 128, (blocks, HEADS, BS, HD)).astype(np.int8)
        ks = rng.uniform(0.005, 0.05, (blocks, HEADS, 1, 1)).astype(np.float32)
        vs = rng.uniform(0.005, 0.05, (blocks, HEADS, 1, 1)).astype(np.float32)
        ks[0] = 0.0  # an empty block: scale 0 dequantizes to exact zeros
    else:
        k = rng.normal(size=(blocks, HEADS, BS, HD)).astype(np.float32)
        v = rng.normal(size=(blocks, HEADS, BS, HD)).astype(np.float32)
        ks = vs = None
    base = rng.integers(0, (WIDTH - 1) * BS - S + 1, batch).astype(np.int32)
    table = np.full((batch, WIDTH), scratch, dtype=np.int32)
    ids = rng.permutation(blocks - 1)
    for b in range(batch):
        live = (int(base[b]) + S - 1) // BS + 1
        table[b, :live] = ids[b * (WIDTH - 1): b * (WIDTH - 1) + live]
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
