"""Port parity: attention's backward (K2/K3's plain version) against the JAX package.

``reference_attention_backward`` is held against the JAX Pallas backward
kernels run in interpret mode (``_flash_backward(..., interpret=True)`` at
tile-aligned shapes with explicit 16x16 blocks, fed the JAX forward's own
``out`` and ``lse``), and the port's autograd through ``flash_attention``
(``_FlashAttention`` on CPU tensors) against ``jax.vjp`` of the JAX
``flash_attention(..., interpret=True)`` and of ``xla_attention`` (ragged
lengths: against ``xla_attention``, which the JAX package itself falls back
to there). Inputs are float32 from a numpy seed. Tolerance: atol 1e-5 (the
same f32 arithmetic in another summation order). ``torch.autograd.gradcheck``
runs the autograd Function in float64 at a tiny shape (its default
tolerances, atol 1e-5 and rtol 1e-3).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu_torch import kernels

jattn = importlib.import_module("unionml_tpu.ops.attention")
tattn = importlib.import_module("unionml_tpu_torch.ops.attention")

ATOL = 1e-5
B, H, D = 2, 2, 64
LENS = {"none": None, "short": [1, 32], "full-and-short": [32, 9]}


def _inputs(seq, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, seq, D)).astype(np.float32) for _ in range(4))
    return q, k, v, g


def _lens(name, seq):
    lens = LENS[name]
    return None if lens is None else [min(n, seq) for n in lens]


@pytest.mark.parametrize("lens", list(LENS), ids=list(LENS))
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_backward_matches_jax_pallas_kernels(lens, causal):
    seq = 32
    q, k, v, g = _inputs(seq, seed=7 + causal)
    kv = _lens(lens, seq)
    jlens = None if kv is None else jnp.asarray(kv, jnp.int32)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, jlens, causal, scale, 16, 16, True, return_residuals=True)
    want = jattn._flash_backward(jq, jk, jv, jlens, out, lse, jg, causal, scale, 16, 16, True)
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, g)]
    got = tattn.reference_attention_backward(
        *t,
        kv_lens=None if kv is None else torch.tensor(kv), causal=causal, sm_scale=scale,
    )
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("seq", [32, 20], ids=["aligned", "ragged"])
@pytest.mark.parametrize("lens", list(LENS), ids=list(LENS))
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_autograd_matches_jax_vjp(seq, lens, causal):
    q, k, v, g = _inputs(seq, seed=seq + causal)
    kv = _lens(lens, seq)
    jlens = None if kv is None else jnp.asarray(kv, jnp.int32)
    mask = None if kv is None else jattn._kv_lens_to_mask(jlens, seq)
    jx = [jnp.asarray(x) for x in (q, k, v)]
    _, xla_vjp = jax.vjp(lambda a, b, c: jattn.xla_attention(a, b, c, mask=mask, causal=causal), *jx)
    references = [xla_vjp(jnp.asarray(g))]
    if seq % 16 == 0:
        # positional: (q, k, v, kv_lens, segment_ids, causal, sm_scale, block_q, block_k, interpret)
        _, flash_vjp = jax.vjp(
            lambda a, b, c: jattn.flash_attention(a, b, c, jlens, None, causal, None, 16, 16, True), *jx
        )
        references.append(flash_vjp(jnp.asarray(g)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, kv_lens=None if kv is None else torch.tensor(kv), causal=causal)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for want in references:
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("causal,lens", [(False, [3, 5]), (True, None), (True, [1, 4])])
def test_gradcheck_double(causal, lens):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 2, 5, 4), generator=gen, dtype=torch.float64).requires_grad_() for _ in range(3))
    kv_lens = None if lens is None else torch.tensor(lens)
    assert torch.autograd.gradcheck(
        lambda a, b, c: tattn.flash_attention(a, b, c, kv_lens=kv_lens, causal=causal), (q, k, v)
    )


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_plain_autograd_and_launches_nothing_on_cpu(causal):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(24, seed=3))
    kv_lens = torch.tensor([24, 11])
    before = dict(kernels.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tattn.flash_attention(*leaves, kv_lens=kv_lens, causal=causal), leaves, g)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    mask = tattn._kv_lens_to_mask(kv_lens, 24)
    want = torch.autograd.grad(
        tattn.reference_attention(*ref_leaves, mask=mask, causal=causal), ref_leaves, g
    )
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    assert kernels.launches == before


def test_backward_takes_non_contiguous_d_out_and_ignores_lse_grad():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(16, seed=4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tattn.flash_attention(*leaves, return_lse=True)
    assert not lse.requires_grad
    # the model's head transpose hands the backward a non-contiguous gradient
    g = torch.randn(B, 16, H, D, generator=torch.Generator().manual_seed(1)).transpose(1, 2)
    got = torch.autograd.grad(out, leaves, g)
    want = tattn.reference_attention_backward(q, k, v, out.detach(), lse, g.contiguous())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_no_autograd_function_without_grad():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(16, seed=5))
    assert tattn.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        leaf = q.clone().requires_grad_()
        assert tattn.flash_attention(leaf, k, v).grad_fn is None


def test_masked_entries_ignore_whatever_lse_holds():
    """A row that sees no key (kv_len 0) has an lse of about -1e30 from K1;
    its P must be exactly 0, and with it every gradient term of the row."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(16, seed=6))
    kv_lens = torch.tensor([16, 0])
    out, lse = tattn.flash_attention(q, k, v, kv_lens=kv_lens, return_lse=True)
    for poison in (float("-inf"), float("nan")):
        bad = lse.clone()
        bad[1] = poison
        dq, dk, dv = tattn.reference_attention_backward(q, k, v, out, bad, g, kv_lens=kv_lens)
        assert torch.all(dq[1] == 0) and torch.all(dk[1] == 0) and torch.all(dv[1] == 0)
        assert torch.isfinite(dq[0]).all()


def test_kernel_input_check_messages_name_each_case():
    q = torch.zeros((1, 1, 4, 64))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn._check_flash_inputs(q, q, q, None)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn._check_flash_inputs(q, q, q, None, name="flash_attention_backward")
