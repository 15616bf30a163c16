"""Port parity: weight-only int8 (``quantize="int8"``) against the JAX package.

Ports ``tests/unit/test_quant.py:46-140`` on the tiny GPT, its JAX weights
carried across (``tests/test_torch_prefix_cache.py``'s pair):

- ``quantize_array``: int8 codes and f32 scales bitwise equal to JAX's on the
  same inputs (f32 and bf16 leaves, an outlier and an all-zero channel), the
  port's ``(out, in)`` layout being JAX's ``(in, out)`` transposed;
- ``quantize_tree`` over a dense and a sparse GPT selects the same leaves as
  JAX's (the four kernels of a dense block, ``qkv``/``attn_out`` of a sparse
  one; no embedding, norm, bias, router or expert stack), with the same codes
  and scales, and ``quantized_bytes`` equals JAX's;
- the int8-weight engine's f32 greedy streams equal JAX's ``quantize="int8"``
  engine, paged (int8 and f32 pools) and dense; the caller's model is left
  untouched;
- ``SpeculativeEngine(quantize="int8")``: the target serves int8, the draft
  full precision; speculation on equals off, greedy and fixed-seed sampled.

Tolerance: none; every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_prefix_cache import Pair, run_schedule
from unionml_tpu.models import gpt as jgpt
from unionml_tpu.ops import quant as jquant
from unionml_tpu.serving.continuous import DecodeEngine as JaxEngine
from unionml_tpu_torch.models import GPTConfig, init_gpt
from unionml_tpu_torch.models._layers import QuantizedLinear
from unionml_tpu_torch.ops import QuantizedArray, dequantize_tree, quantize_array, quantize_tree, quantized_bytes
from unionml_tpu_torch.serving import DecodeEngine, SpeculativeEngine

KW = dict(num_slots=4, max_len=64, prefill_buckets=(4, 8, 16, 32))
REQUESTS = [([3, 1, 4, 1, 5], 10), (list(range(1, 14)), 8), ([2, 7], 12), ([9] * 20, 6)]


@pytest.fixture(scope="module")
def gpt():
    return Pair()


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codes_and_scales_match_jax_bitwise(dtype):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(96, 160)).astype(np.float32)  # JAX's (in, out)
    w[:, 7] *= 1000.0  # an outlier output channel
    w[:, 11] = 0.0  # an all-zero channel: scale 1.0
    want = jquant.quantize_array(jnp.asarray(w, dtype=dtype))
    got = quantize_array(torch.from_numpy(w.T.copy()).to(getattr(torch, dtype)))
    assert got.q.dtype == torch.int8 and got.scale.shape == (160, 1) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q).T)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale).T)
    np.testing.assert_array_equal(_np(got.dequantize()), _np(want.dequantize()).T)
    assert float(got.scale[11, 0]) == 1.0


def _jax_leaves(tree):
    """``{(layer, module): QuantizedArray}`` of a quantized JAX params tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jquant.QuantizedArray))[0]:
        if isinstance(leaf, jquant.QuantizedArray):
            keys = [getattr(k, "key", k) for k in path]
            out[(keys[-3], keys[-2])] = leaf
    return out


@pytest.mark.parametrize("overrides", [{}, dict(moe_every=2, num_experts=4)], ids=["dense", "sparse"])
def test_tree_selects_the_same_leaves_and_bytes_as_jax(overrides):
    jcfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, **overrides)
    variables = jgpt.init_params(jcfg, seq_len=16)
    model = init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0, **overrides),
                     params=jax.tree_util.tree_map(np.asarray, jax.device_get(variables)), device="cpu")
    jtree = jquant.quantize_tree(variables)
    tree = quantize_tree(dict(model.named_parameters()))
    want = _jax_leaves(jtree)
    got = {}
    for name, leaf in tree.items():
        if isinstance(leaf, QuantizedArray):
            parts = name.split(".")  # layers.<i>.<module>.weight
            got[(f"layer_{parts[1]}", parts[2])] = leaf
    assert set(got) == set(want)
    sparse = {f"layer_{i}" for i in range(jcfg.num_layers) if overrides and (i + 1) % 2 == 0}
    assert {m for (layer, m) in got if layer in sparse} <= {"qkv", "attn_out"}
    for key, leaf in got.items():
        np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(want[key].q).T)
        np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(want[key].scale).T)
    assert quantized_bytes(tree) == jquant.quantized_bytes(jtree)
    restored = dequantize_tree(tree)
    assert all(torch.is_tensor(v) for v in restored.values())


@pytest.mark.parametrize("mode", ["paged_int8_pool", "paged_f32_pool", "dense"])
def test_quantized_engine_greedy_matches_jax(gpt, mode):
    kv = "int8" if mode == "paged_int8_pool" else None
    paged = mode != "dense"
    jeng = JaxEngine(gpt.jmodel, gpt.variables, quantize="int8", kv_quantize=kv, paged=paged, **KW)
    eng = DecodeEngine(gpt.tmodel, quantize="int8", kv_quantize=kv, paged=paged, device="cpu", **KW)
    requests = [(p, b) for p, b in REQUESTS]
    got = run_schedule(eng, requests)
    assert got == run_schedule(jeng, requests)
    full = run_schedule(DecodeEngine(gpt.tmodel, kv_quantize=kv, paged=paged, device="cpu", **KW), requests)
    assert sum(a == b for a, b in zip(got, full)) >= 1  # int8 weights move logits, not every choice
    assert quantized_bytes(eng._variables) == jquant.quantized_bytes(jeng._variables)


def test_callers_model_is_untouched(gpt):
    model = gpt.tmodel
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kinds = [type(m) for m in model.modules()]
    eng = DecodeEngine(model, quantize="int8", device="cpu", **KW)
    eng.generate([3, 1, 4], 6)
    assert [type(m) for m in model.modules()] == kinds
    assert all(torch.equal(v, before[k]) and v.dtype == before[k].dtype for k, v in model.state_dict().items())
    # the engine's copy: int8 decoder kernels, every other parameter shared
    qkv = eng._model.layers[0].qkv
    assert isinstance(qkv, QuantizedLinear) and qkv.q.dtype == torch.int8 and "weight" not in dict(
        qkv.named_parameters())
    assert eng._model.wte.weight is model.wte.weight and qkv.bias is model.layers[0].qkv.bias
    stored, full = quantized_bytes(eng._variables)
    assert stored < full and full == sum(p.numel() * 4 for p in model.parameters())
    with pytest.raises(ValueError, match="quantize mode"):
        DecodeEngine(model, quantize="fp4", device="cpu")


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "seed": 5}], ids=["greedy", "sampled"])
def test_speculation_on_equals_off_under_int8(gpt, sampling):
    kw = dict(KW, block_size=4, kv_quantize="int8", seed=7, quantize="int8")
    spec = SpeculativeEngine(gpt.tmodel, gpt.tmodel, device="cpu", **kw)
    assert isinstance(spec._model.layers[0].qkv, QuantizedLinear) and spec._draft_model is gpt.tmodel
    reqs = [(p, b, dict(sampling)) for p, b in REQUESTS[:3]]
    on = run_schedule(spec, [(p, b, dict(s, speculative=True)) for p, b, s in reqs])
    off = run_schedule(SpeculativeEngine(gpt.tmodel, gpt.tmodel, device="cpu", **kw),
                       [(p, b, dict(s, speculative=False)) for p, b, s in reqs])
    assert on == off
    if not sampling:
        kw.pop("seed")
        assert on == run_schedule(DecodeEngine(gpt.tmodel, device="cpu", **kw), [(p, b) for p, b, _ in reqs])
    assert spec.speculation_stats()["accepted"] > 0
