"""Port parity: ``SpeculativeEngine`` on the paged pool.

Ports ``tests/unit/test_spec_engine.py:141-409`` on the tiny f32 GPT (the
JAX weights carried across) and a smaller draft, without the mesh and
scheduler-class tests (ROADMAP: slice 6 and M12; the prefix-cache and chaos
cases are in ``test_torch_prefix_cache.py`` and ``test_torch_recovery.py``):

- greedy speculative streams equal the port's vanilla engine and JAX's
  ``SpeculativeEngine`` on the same weights, with a chunked-prefill admission
  that decodes vanilla in the same batch;
- spec-on equals spec-off (the γ = 0 arm of the same engine) bitwise,
  greedy and fixed-seed sampled, on int8 and f32 pools;
- sampled speculative streams equal JAX's token for token (keyed selection
  draws JAX's bits; the f32 logits agree to ~1e-6);
- a pinned seed reproduces, default seeds differ between admissions;
- a self-draft ramps γ (accepted tokens per target step > 2.5); a hostile
  draft decays γ to 0;
- speculation adds no block demand and the pool stats charge the draft bytes;
- NaN logits quarantine one speculative slot, its sibling stays exact;
- a cancel between rounds leaks no block; top-k/top-p and bad constructor
  arguments are rejected; the stats block's shape;
- requests reach the engine through ``ContinuousBatcher`` with
  ``speculative`` in their sampling dict, and through ``SpeculativeBatcher``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu.serving.speculative import SpeculativeEngine as JaxSpeculativeEngine
from unionml_tpu_torch.models import GPTConfig, init_gpt, speculative_generate
from unionml_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeEngine,
    SpeculativeBatcher,
    SpeculativeEngine,
    Telemetry,
)

ENGINE_KW = dict(num_slots=4, max_len=64, prefill_buckets=(4, 8, 16), prefill_chunk=4, seed=7, temperature=0.0)
PROMPTS = [
    ([1, 2, 3, 4], 10, {}),  # bucket prefill, armed
    ([7, 8, 9], 8, {}),  # bucket prefill, armed
    ([1, 2, 3, 4, 5, 6, 7], 12, {}),  # chunked prefill: decodes vanilla
]
MIXED = [([1, 2, 3, 4], 10, {"temperature": 0.8, "seed": 11}), ([7, 8, 9], 8, {}),
         ([5, 6, 7, 8, 9], 9, {"temperature": 1.2})]


def _pair(**overrides):
    jcfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, attention_impl="xla", **overrides)
    variables = jgpt.init_params(jcfg, seq_len=16)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tmodel = init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0, **overrides), params=params, device="cpu")
    return jgpt.GPTLMHeadModel(jcfg), variables, tmodel


@pytest.fixture(scope="module")
def gpt():
    return _pair()


@pytest.fixture(scope="module")
def draft():
    """A smaller draft over the same vocab."""
    return _pair(num_layers=1, hidden_size=32, num_heads=2)


def make_spec(gpt, draft, **kw):
    return SpeculativeEngine(gpt[2], draft[2], device="cpu", **dict(ENGINE_KW, block_size=4, **kw))


def drive(engine, reqs):
    """Admit ``reqs`` one by one, then run the engine dry; per-request streams."""
    streams, slot_req = {}, {}
    for rid, (prompt, budget, sampling) in enumerate(reqs):
        (slot,) = engine.admit_many([(prompt, budget, sampling)])
        for ev in engine.take_pending_events():
            if ev.emit:
                streams[slot_req[ev.slot]].append(ev.token)
        slot_req[slot], streams[rid] = rid, []
    while engine.num_active or engine.has_pending_prefill or engine.has_pending_events:
        for ev in engine.step(1):
            if ev.emit:
                streams[slot_req[ev.slot]].append(ev.token)
    return streams


def _spec(reqs, **extra):
    return [(p, b, dict(s, speculative=True, **extra)) for p, b, s in reqs]


def _no_leaks(engine):
    assert engine.available_blocks() == engine._allocator.num_blocks and not engine._slot_block_map


@pytest.fixture(scope="module")
def jax_streams(gpt, draft):
    """JAX's SpeculativeEngine (paged, no prefix cache) over the same schedules."""
    def run(reqs):
        engine = JaxSpeculativeEngine(gpt[0], gpt[1], draft[0], draft[1], prefix_block_size=4, **ENGINE_KW)
        return drive(engine, reqs)

    return {"greedy": run(_spec(PROMPTS)), "mixed": run(_spec(MIXED))}


def test_greedy_equals_vanilla_and_jax(gpt, draft, jax_streams):
    ref = drive(DecodeEngine(gpt[2], device="cpu", block_size=4, **ENGINE_KW), PROMPTS)
    eng = make_spec(gpt, draft)
    got = drive(eng, _spec(PROMPTS))
    assert got == ref == jax_streams["greedy"]
    assert eng.spec_round_dispatches > 0 and eng.draft_prefill_dispatches == 2
    _no_leaks(eng)


def test_sampled_streams_equal_jax_token_for_token(gpt, draft, jax_streams):
    assert drive(make_spec(gpt, draft), _spec(MIXED)) == jax_streams["mixed"]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_spec_on_equals_spec_off(gpt, draft, kv, sampled):
    kw = {"temperature": 0.7, "seed": 5} if sampled else {}
    base = [([1, 2, 3, 4], 10, dict(kw)), ([9, 8, 7], 12, dict(kw))]
    on = drive(make_spec(gpt, draft, kv_quantize=kv), _spec(base))
    off = drive(make_spec(gpt, draft, kv_quantize=kv), _spec(base, gamma=0))
    assert on == off


def test_explicit_seed_reproduces_and_default_seeds_diverge(gpt, draft):
    req = [([1, 2, 3, 4], 10, {"temperature": 0.9, "seed": 42, "speculative": True})]
    assert drive(make_spec(gpt, draft), req) == drive(make_spec(gpt, draft), req)
    unseeded = [([1, 2, 3, 4], 10, {"temperature": 0.9, "speculative": True})]
    eng = make_spec(gpt, draft)
    assert drive(eng, unseeded)[0] != drive(eng, unseeded)[0], "two admissions must not replay each other"


def test_self_draft_ramps_gamma(gpt):
    eng = SpeculativeEngine(gpt[2], gpt[2], device="cpu", block_size=4,
                            **dict(ENGINE_KW, max_len=128, prefill_chunk=None))
    streams = drive(eng, [([1, 2, 3, 4, 5], 60, {"speculative": True})])
    assert len(streams[0]) == 60
    s = eng.speculation_stats()
    assert s["accepted_per_target_step"] > 2.5, s
    assert s["proposed"] - s["accepted"] <= eng._gamma_max, s
    assert s["round_dispatches"] < 20, s


def test_hostile_draft_decays_gamma_to_vanilla(gpt, draft):
    eng = make_spec(gpt, draft, ema_beta=0.5)
    drive(eng, [([1, 2, 3, 4], 20, {"speculative": True})])
    s = eng.speculation_stats()
    assert s["fallback_rounds"] > 0, s
    assert s["proposed"] < s["rounds"] * eng._gamma_max, s


def test_admission_arithmetic_unchanged_and_draft_bytes_reported(gpt, draft):
    plain, spec = DecodeEngine(gpt[2], device="cpu", block_size=4, **ENGINE_KW), make_spec(gpt, draft)
    assert spec.block_demand(5, 10) == plain.block_demand(5, 10)
    stats = spec.kv_pool_stats()
    assert stats["draft_kv_pool_bytes"] > 0
    assert stats["kv_pool_bytes"] == plain.kv_pool_stats()["kv_pool_bytes"] + stats["draft_kv_pool_bytes"]


def test_nan_quarantine_isolates_one_spec_slot(gpt, draft):
    reqs = _spec([([3, 1, 4, 1, 5], 10, {}), ([2, 7, 1], 8, {})])
    clean = drive(make_spec(gpt, draft, num_slots=2, prefill_chunk=None), reqs)
    eng = make_spec(gpt, draft, num_slots=2, prefill_chunk=None)
    streams, slot_req = {0: [], 1: []}, {}
    for rid, req in enumerate(reqs):
        (slot,) = eng.admit_many([req])
        slot_req[slot] = rid
    for _ in range(2):
        for ev in eng.step(1):
            if ev.emit:
                streams[slot_req[ev.slot]].append(ev.token)
    victim = next(s for s, r in slot_req.items() if r == 0)
    eng._last_logits[victim] = float("nan")  # poison the next round's bonus selection
    errors = []
    while eng.num_active or eng.has_pending_events:
        for ev in eng.step(1):
            if ev.error is not None:
                errors.append((slot_req[ev.slot], ev.error))
            elif ev.emit:
                streams[slot_req[ev.slot]].append(ev.token)
    assert errors == [(0, "nan_logits")] and eng.quarantined_requests == 1
    assert streams[1] == clean[1], "the sibling diverged"
    assert streams[0] == clean[0][: len(streams[0])] and len(streams[0]) < len(clean[0])
    _no_leaks(eng)


def test_cancel_between_rounds_leaks_nothing(gpt, draft):
    eng = make_spec(gpt, draft)
    slots = eng.admit_many(_spec(PROMPTS))
    eng.step(1)
    eng.step(1)
    eng.cancel(slots[1])
    eng.take_pending_events()
    while eng.num_active or eng.has_pending_prefill or eng.has_pending_events:
        eng.step(1)
    _no_leaks(eng)


def test_rejections_and_constructor_validation(gpt, draft):
    eng = make_spec(gpt, draft)
    with pytest.raises(ValueError, match="temperature sampling only"):
        eng.admit_many([([1, 2, 3], 4, {"speculative": True, "top_k": 5})])
    with pytest.raises(ValueError, match="temperature sampling only"):
        eng.validate_request([1, 2, 3], 4, top_p=0.9)
    eng.validate_request([1, 2, 3], 4, speculative=True, seed=9, gamma=2)
    for kw, match in ((dict(paged=False), "paged"), (dict(gamma_max=0), "gamma_max"),
                      (dict(ema_lo=0.9, ema_hi=0.5), "ema_lo"), (dict(gamma_init=5), "gamma_init")):
        with pytest.raises(ValueError, match=match):
            make_spec(gpt, draft, **kw)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(gpt[2], init_gpt(GPTConfig.tiny(vocab_size=64, dtype=torch.float32), device="cpu"),
                          device="cpu", max_len=64)
    # telemetry is wired: the round's counters feed the registry
    tel = Telemetry()
    eng = make_spec(gpt, draft, telemetry=tel)
    drive(eng, _spec([([1, 2, 3, 4], 6, {})]))
    assert tel.spec_proposed_total.value() == eng.spec_proposed > 0
    assert tel.spec_accepted_total.value() == eng.spec_accepted


def test_stats_block_shape(gpt, draft):
    eng = make_spec(gpt, draft)
    drive(eng, _spec([([1, 2, 3, 4], 6, {})]))
    assert set(eng.speculation_stats()) == {
        "enabled_slots", "gamma_max", "rounds", "round_dispatches", "proposed", "accepted", "fallback_rounds",
        "acceptance_ema", "gamma", "accepted_per_target_step"}


def test_batchers_pass_speculation_through(gpt, draft):
    """``ContinuousBatcher`` passes ``speculative`` in a request's sampling dict
    to the engine (greedy streams equal vanilla); ``SpeculativeBatcher``
    answers with ``speculative_generate``'s tokens, a pinned seed reproducing."""
    ref = drive(DecodeEngine(gpt[2], device="cpu", block_size=4, **ENGINE_KW), PROMPTS)
    engine = make_spec(gpt, draft)
    batcher = ContinuousBatcher(engine, device="cpu")
    single = SpeculativeBatcher(gpt[2], draft[2], gamma=3, max_len=64, device="cpu")

    async def main():
        spec = await asyncio.gather(*(batcher.generate(p, n, speculative=True) for p, n, _ in PROMPTS))
        one = await single.generate([1, 2, 3, 4], 10)
        sampled = [await single.generate([1, 2, 3], 6, temperature=0.9, seed=3) for _ in range(2)]
        return spec, one, sampled

    try:
        spec, one, sampled = asyncio.run(main())
    finally:
        batcher.close()
        single.close()
    assert spec == [ref[i] for i in range(len(PROMPTS))] and engine.spec_rounds > 0
    want = speculative_generate(gpt[2], draft[2], torch.tensor([[1, 2, 3, 4]]), 10, gamma=3)
    assert one == want[0, 4:].tolist() and sampled[0] == sampled[1]
    assert len(one) == 10 and [len(s) for s in sampled] == [6, 6] and single.round_failures == 0
