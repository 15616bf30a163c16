"""Port parity: the sparse (mixture-of-experts) GPT against the JAX package.

``GPTConfig.tiny(moe_every=2, num_experts=4, moe_k=2, dropout=0.0)`` in f32
(layer 1 sparse, layer 0 dense), seeded weights from the port's
``random_params`` (std 0.2, so greedy streams vary token to token) fed to
both packages; inputs from numpy seeds. Tolerances:

- logits, dropless (deterministic) and capacity-bounded (a training
  forward, with drops at capacity factor 0.5): within 1e-4 of JAX's, as the
  dense logits in ``test_torch_gpt.py``;
- ``generate`` continues as the full forward's argmax does, exactly
  (``tests/unit/test_gpt.py:160-178``);
- the first ``make_lm_train_step(packed=True, moe_aux=True)`` step
  (``tests/unit/test_packing.py:466-497``): the loss (about 7.3) within 1e-6
  relative, the router losses within 1e-6, every gradient leaf within 1e-5 of its largest magnitude, and
  ``grad_norm`` within 1e-6 relative of optax's;
- router jitter: the same generator state gives the same step bitwise, and
  a deterministic forward ignores the noise bitwise;
- ``DecodeEngine`` greedy streams (int8 and f32 pools, a prefix-cache hit)
  identical to JAX's engine, with equal prefill-token counters;
- speculation on equals speculation off, bit for bit (self-draft, int8 and
  f32 pools).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models import moe as jmoe
from unionml_tpu.models import training as jtraining
from unionml_tpu.serving.continuous import DecodeEngine as JaxEngine
from unionml_tpu_torch.models import (
    GPTConfig,
    collect_aux_losses,
    create_train_state,
    fit_lm,
    generate,
    gpt_grads_to_jax,
    init_gpt,
    make_lm_train_step,
    random_params,
)
from unionml_tpu_torch.models.training import lm_grads
from unionml_tpu_torch.ops.packing import pack_sequences
from unionml_tpu_torch.serving import DecodeEngine, SpeculativeEngine

MOE = dict(moe_every=2, num_experts=4, moe_k=2, dropout=0.0)
SEQ = 32


def _configs(**overrides):
    kw = dict(MOE, **overrides)
    return (jgpt.GPTConfig.tiny(dtype=jnp.float32, attention_impl="xla", **kw),
            GPTConfig.tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def params():
    """A JAX-layout tree of the sparse tiny GPT (numpy f32)."""
    return random_params(GPTConfig.tiny(**MOE), seed=0, std=0.2)


def _models(params, **overrides):
    jcfg, tcfg = _configs(**overrides)
    return jgpt.GPTLMHeadModel(jcfg), init_gpt(tcfg, params=params, device="cpu")


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _packed(seed):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(1, 512, int(n)).astype(np.int32) for n in rng.integers(4, 20, 10)]
    packed = pack_sequences(seqs, SEQ)
    return {k: packed[k][:3] for k in ("input_ids", "segment_ids")}


def test_sparse_blocks_carry_expert_parameters(params):
    _, model = _models(params)
    names = dict(model.named_parameters())
    assert "layers.1.moe_mlp.w_in" in names and "layers.0.mlp_up.weight" in names
    assert "layers.1.mlp_up.weight" not in names
    assert names["layers.1.moe_mlp.w_in"].shape == (4, 64, 256)
    assert names["layers.1.moe_mlp.router.weight"].shape == (4, 64)
    bf16 = init_gpt(GPTConfig.tiny(**MOE), params=params, device="cpu")
    assert bf16.layers[1].moe_mlp.w_out.dtype == torch.bfloat16  # experts in config.dtype, as flax
    assert bf16.layers[1].moe_mlp.router.weight.dtype == torch.float32


@pytest.mark.parametrize("mode", ["dropless", "capacity-1.25", "capacity-0.5"])
def test_logits_match_jax(params, mode):
    cf = 1.25 if mode == "dropless" else float(mode.split("-")[1])
    jmodel, model = _models(params, moe_capacity_factor=cf)
    ids = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(np.int32)
    if mode == "dropless":
        want = jmodel.apply({"params": params["params"]}, jnp.asarray(ids))
        with torch.no_grad():
            got = model(torch.from_numpy(ids))
    else:
        want = jmodel.apply({"params": params["params"]}, jnp.asarray(ids), deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        with torch.no_grad():
            got = model(torch.from_numpy(ids), deterministic=False, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    if mode == "capacity-0.5":
        with torch.no_grad():
            dropless = model(torch.from_numpy(ids))
        assert not torch.allclose(got, dropless, atol=1e-3), "capacity 0.5 must drop choices"


def test_generate_continues_the_full_forward_argmax(params):
    _, model = _models(params)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 5)))
    out = generate(model, prompt, max_new_tokens=6)
    assert out.shape == (2, 11)
    with torch.no_grad():
        full = model(out)
    assert torch.equal(torch.argmax(full[:, 4:-1], dim=-1), out[:, 5:])


def test_first_packed_moe_aux_step_matches_jax(params):
    jmodel, model = _models(params)
    batch = _packed(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits, sown = jmodel.apply({"params": p}, jbatch["input_ids"], segment_ids=jbatch["segment_ids"],
                                    deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
                                    mutable=["intermediates"])
        aux = jmoe.collect_aux_losses(sown["intermediates"])
        return aux + jgpt.lm_loss(logits, jbatch["input_ids"], segment_ids=jbatch["segment_ids"]), aux

    (j_loss, j_aux), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params["params"])
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = create_train_state(model)
    with torch.no_grad():
        _, aux = model(tbatch["input_ids"], segment_ids=tbatch["segment_ids"], deterministic=False,
                       generator=torch.Generator(), return_aux=True)
    np.testing.assert_allclose(float(collect_aux_losses(aux)), float(j_aux), atol=1e-6, rtol=0)
    grads, loss = lm_grads(state, tbatch, packed=True, moe_aux=True)
    np.testing.assert_allclose(float(loss), float(j_loss), atol=0, rtol=1e-6)
    got = dict(_leaves(gpt_grads_to_jax(dict(zip(state.names, grads)))))
    want = dict(_leaves(j_grads))
    assert set(got) == set(want) and ("layer_1", "moe_mlp", "w_in") in want
    for path, value in want.items():
        assert float(np.abs(got[path] - value).max()) <= 1e-5 * float(np.abs(value).max()), path

    # the whole step's metrics, against JAX's make_lm_train_step
    jstate = jtraining.create_train_state(jmodel, {"params": params["params"]}, learning_rate=1e-3)
    _, j_metrics = jtraining.make_lm_train_step(packed=True, moe_aux=True)(jstate, jbatch)
    _, metrics = make_lm_train_step(packed=True, moe_aux=True)(create_train_state(_models(params)[1],
                                                                                  learning_rate=1e-3), tbatch)
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), atol=0, rtol=1e-6)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(j_metrics["grad_norm"]), rtol=1e-6)
    # without the router losses the objective is the LM loss alone
    _, plain = make_lm_train_step(packed=True)(create_train_state(_models(params)[1]), tbatch)
    assert float(metrics["loss"]) > float(plain["loss"])


def test_router_jitter_follows_the_generator_and_not_a_deterministic_forward(params):
    _, noisy = _models(params, moe_router_noise=0.3)
    _, quiet = _models(params)
    batch = {k: torch.from_numpy(v) for k, v in _packed(4).items()}
    first = lm_grads(create_train_state(noisy, seed=5), batch, packed=True, moe_aux=True)
    again = lm_grads(create_train_state(noisy, seed=5), batch, packed=True, moe_aux=True)
    other = lm_grads(create_train_state(noisy, seed=6), batch, packed=True, moe_aux=True)
    calm = lm_grads(create_train_state(quiet, seed=5), batch, packed=True, moe_aux=True)
    assert all(torch.equal(a, b) for a, b in zip(first[0], again[0])) and torch.equal(first[1], again[1])
    assert not torch.equal(first[1], other[1]) and not torch.equal(first[1], calm[1])
    with torch.no_grad():
        assert torch.equal(noisy(batch["input_ids"]), quiet(batch["input_ids"]))


def test_fit_lm_trains_a_bf16_sparse_model(params):
    """``fit_lm(moe_aux=True)`` end to end in a bf16 config: finite losses,
    the experts move, and their parameters and moments stay bf16."""
    model = init_gpt(GPTConfig.tiny(**MOE), params=params, device="cpu")
    state = create_train_state(model, learning_rate=1e-3)
    before = model.layers[1].moe_mlp.w_in.detach().clone()
    rng = np.random.default_rng(2)
    corpus = [rng.integers(1, 512, int(n)).astype(np.int32) for n in rng.integers(4, 30, 24)]
    result = fit_lm(state, corpus, seq_len=SEQ, batch_size=2, num_steps=3, log_every=1, moe_aux=True)
    assert result.steps == 3 and all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                                     for h in result.metrics_history)
    w_in = model.layers[1].moe_mlp.w_in
    assert w_in.dtype == torch.bfloat16 and not torch.equal(w_in.detach(), before)
    index = state.names.index("layers.1.moe_mlp.w_in")
    assert state.mu[index].dtype == state.nu[index].dtype == torch.bfloat16


SHARED = [5, 9, 14, 3, 7, 21, 8, 2, 30, 11, 6, 4]  # three blocks of 4


def _drive(engine, requests):
    """Admit ``requests`` one at a time (two steps apart), then drain; each
    request's tokens, in order."""
    out, req_of_slot = {}, {}

    def pump(events):
        for ev in events:
            if ev.emit:
                out[req_of_slot[ev.slot]].append(ev.token)

    for i, (prompt, budget) in enumerate(requests):
        (slot,) = engine.admit_many([(prompt, budget)])
        req_of_slot[slot], out[i] = i, []
        pump(engine.take_pending_events())
        for _ in range(2):
            pump(engine.step())
    while engine.num_active or engine.has_pending_prefill or engine.has_pending_events:
        pump(engine.step())
    return out


REQUESTS = [(SHARED + [20, 21], 8), ([40, 41, 42], 6), (SHARED + [30], 7), (list(range(60, 79)), 5)]
ENGINE_KW = dict(num_slots=4, max_len=64, prefill_buckets=(4, 8, 16, 32))


@pytest.mark.parametrize("pool", ["int8", "f32"])
def test_decode_engine_streams_match_jax(params, pool):
    jmodel, model = _models(params)
    quant = "int8" if pool == "int8" else None
    variables = jax.tree_util.tree_map(jnp.asarray, {"params": params["params"]})
    jengine = JaxEngine(jmodel, variables, prefix_cache_blocks=32, prefix_block_size=4, kv_quantize=quant,
                        prefill_chunk=8, **ENGINE_KW)
    tengine = DecodeEngine(model, prefix_cache_blocks=32, block_size=4, kv_quantize=quant, prefill_chunk=8,
                           device="cpu", **ENGINE_KW)
    got, want = _drive(tengine, REQUESTS), _drive(jengine, REQUESTS)
    assert got == want
    assert tengine.prefix_cache.stats()["hits"] == 1
    assert tengine.prefill_tokens_computed == jengine.prefill_tokens_computed


@pytest.mark.parametrize("pool", ["int8", "f32"])
def test_speculation_on_equals_off(params, pool):
    _, model = _models(params)
    kw = dict(ENGINE_KW, kv_quantize="int8" if pool == "int8" else None, block_size=4, seed=7)
    reqs = [([1, 2, 3, 4], 12), ([9, 8, 7], 10), (SHARED, 9)]

    def run(**extra):
        engine = SpeculativeEngine(model, model, device="cpu", **kw)
        streams, slot_req = {}, {}

        def pump(events):
            for ev in events:
                if ev.emit:
                    streams[slot_req[ev.slot]].append(ev.token)

        for rid, (prompt, budget) in enumerate(reqs):
            (slot,) = engine.admit_many([(prompt, budget, {"speculative": True, **extra})])
            slot_req[slot], streams[rid] = rid, []
            pump(engine.take_pending_events())
        while engine.num_active or engine.has_pending_prefill or engine.has_pending_events:
            pump(engine.step(1))
        return streams, engine.speculation_stats()

    on, stats = run()
    off, _ = run(gamma=0)
    assert on == off
    assert stats["accepted"] > 0
    vanilla = DecodeEngine(model, device="cpu", **kw)
    assert on == {i: vanilla.generate(p, n) for i, (p, n) in enumerate(reqs)}
