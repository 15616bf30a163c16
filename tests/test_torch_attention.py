"""Port parity: dense attention (K1's plain version) against the JAX package.

The port's ``flash_attention`` on CPU tensors runs its plain version
(``reference_attention``); here it is held against the JAX Pallas flash
kernel run in interpret mode (``flash_attention(..., interpret=True)``, which
falls back to ``xla_attention`` for lengths that are not tile-aligned, as in
the JAX package) and against ``xla_attention`` directly. Inputs are float32,
made with numpy from a seed. Tolerance: atol 1e-5 (the three compute the
same softmax in a different summation order). Rows with ``kv_len == 0`` are
compared separately: the flash kernels and the port write zeros there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages' ops/__init__ re-export the function `attention` over the module name
jattn = importlib.import_module("unionml_tpu.ops.attention")
tattn = importlib.import_module("unionml_tpu_torch.ops.attention")

ATOL = 1e-5
B, H, D = 2, 2, 64


def _inputs(seq_q, seq_k, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, seq_q, D)).astype(np.float32)
    k = rng.normal(size=(B, H, seq_k, D)).astype(np.float32)
    v = rng.normal(size=(B, H, seq_k, D)).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, kv_lens, causal):
    lens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    # positional: (q, k, v, kv_lens, segment_ids, causal, sm_scale, block_q, block_k, interpret)
    return np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lens, None, causal, None, 16, 16, True
    ))


@pytest.mark.parametrize("seq", [32, 20], ids=["aligned", "ragged"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_jax_flash_and_xla(seq, causal):
    q, k, v = _inputs(seq, seq, seed=seq + causal)
    port = tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(port, _jax_flash(q, k, v, None, causal), atol=ATOL, rtol=0)
    xla = np.asarray(jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(port, xla, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seq,lens", [(32, [32, 9]), (32, [17, 1]), (20, [20, 13])],
                         ids=["aligned-full", "aligned-short", "ragged"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_kv_lens_matches_jax(seq, lens, causal):
    q, k, v = _inputs(seq, seq, seed=sum(lens))
    port = tattn.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), kv_lens=torch.tensor(lens), causal=causal
    ).numpy()
    np.testing.assert_allclose(port, _jax_flash(q, k, v, lens, causal), atol=ATOL, rtol=0)
    xla = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lens=jnp.asarray(lens), causal=causal, impl="xla"
    ))
    np.testing.assert_allclose(port, xla, atol=ATOL, rtol=0)


def test_cross_length_causal_matches_xla():
    q, k, v = _inputs(12, 28, seed=3)
    port = tattn.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True).numpy()
    xla = np.asarray(jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    np.testing.assert_allclose(port, xla, atol=ATOL, rtol=0)


def test_fully_masked_row_writes_zeros_like_the_jax_kernel():
    q, k, v = _inputs(32, 32, seed=5)
    port = tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), kv_lens=torch.tensor([32, 0])).numpy()
    jax_out = _jax_flash(q, k, v, [32, 0], False)
    assert np.all(port[1] == 0.0) and np.all(jax_out[1] == 0.0)
    np.testing.assert_allclose(port[0], jax_out[0], atol=ATOL, rtol=0)


def test_lse_matches_jax_residual():
    q, k, v = _inputs(32, 32, seed=8)
    _, port_lse = tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, return_lse=True)
    sm = 1.0 / np.sqrt(D)
    _, jax_lse = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True, sm, 16, 16, True, return_residuals=True
    )
    np.testing.assert_allclose(port_lse.numpy(), np.asarray(jax_lse), atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "kernel", "reference"])
def test_dispatcher_on_cpu_runs_the_plain_version(impl):
    q, k, v = (torch.from_numpy(x) for x in _inputs(20, 20, seed=1))
    want = tattn.reference_attention(q, k, v, causal=True)
    assert torch.equal(tattn.attention(q, k, v, causal=True, impl=impl), want)


def test_dispatcher_rejects_dense_mask_for_the_kernel_and_unknown_impls():
    q, k, v = (torch.from_numpy(x) for x in _inputs(8, 8, seed=2))
    with pytest.raises(ValueError):
        tattn.attention(q, k, v, mask=torch.ones(1, 1, 8, 8, dtype=torch.bool), impl="kernel")
    with pytest.raises(ValueError):
        tattn.attention(q, k, v, impl="pallas")
