"""Port parity: the dense per-slot engine (``DecodeEngine(paged=False)``).

On the tiny GPT with JAX's weights (``tests/test_torch_prefix_cache.py``'s
pair), f32 caches, block size 4:

- ``test_paged_kv.py:107-147``'s mixed schedule (miss, hit, unrelated miss,
  chunked prefill, a cancel racing the burst in flight, a replay into the
  freed slot): the port's dense greedy streams equal JAX's dense engine and
  the port's paged engine, fixed-seed sampled streams equal the port's paged
  engine (both draw from the engine's generator in one order), and the
  dispatch counters (``prefill_dispatches``, ``prefill_tokens_computed``,
  ``prefix_restore_dispatches``, ``prefix_save_dispatches``) equal JAX's;
- ``test_torch_prefix_cache.py``'s schedules (hits, evictions, chunked
  resumes, generated capture, same-call dedupe, cancel and reset, preempt and
  resume) on both dense engines: streams, counters and index stats equal;
- a ``FaultPlan`` dispatch fault under a supervisor: the prefix pool and
  index survive the rebuild, the resumes hit them, and streams and counters
  equal JAX's; a failed block save rebuilds the prefix pool alone;
- the accounting (``block_demand`` 0, ``available_blocks`` and
  ``pool_signal`` None, ``kv_pool_stats`` ``{}``) through the batcher and
  its telemetry, and the constructor's errors.

Tolerance: none; every comparison is exact. The card's replay of a dense
burst is ``test_torch_graphs.py::test_burst_replay_equals_the_eager_burst``.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_prefix_cache import SCHEDULES, Pair, counters, leaks, run_schedule
from tests.test_torch_recovery import PAIR, Sink, run_batcher, supervisor
from tests.test_torch_slo_batcher import _Worker, run
from tests.torch_xp_axes_ranks import expert_tensor_layout
from unionml_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from unionml_tpu.serving.supervisor import EngineSupervisor as JaxSupervisor
from unionml_tpu.serving.telemetry import Telemetry as JaxTelemetry
from unionml_tpu_torch.models import GPTConfig, GPTLMHeadModel
from unionml_tpu_torch.serving import ContinuousBatcher, DecodeEngine, SpeculativeEngine, Telemetry

MIXED_KW = dict(num_slots=4, max_len=64, prefill_buckets=(4, 8, 16), prefill_chunk=4, blocks=24)


@pytest.fixture(scope="module")
def gpt():
    return Pair()


def dense(gpt, kind, **kw):
    return gpt.engine(kind, pool="f32", paged=False, **kw)


def dispatches(engine):
    return (engine.prefill_dispatches, engine.prefill_tokens_computed, engine.prefix_restore_dispatches,
            engine.prefix_save_dispatches, engine.prefix_cache.stats())


def mixed_schedule(engine, sampled=False):
    """``test_paged_kv.py:107-127`` on a fixed tick script: each request's
    emitted tokens, events drained under the old slot mapping."""
    streams, req_of_slot = {}, {}
    kw = dict(temperature=0.9, top_k=3) if sampled else {}

    def pump(events):
        for ev in events:
            if ev.emit:
                streams[req_of_slot[ev.slot]].append(ev.token)

    def admit(rid, prompt, budget):
        (slot,) = engine.admit_many([(prompt, budget, kw)])
        pump(engine.take_pending_events())
        req_of_slot[slot], streams[rid] = rid, []
        return slot

    shared = list(range(1, 11))
    script = [(0, shared + [20, 21], 6, 2), (1, shared + [30], 5, 1), (2, [40, 41, 42], 12, 1),
              (3, list(range(50, 64)), 4, 2)]
    slots = {}
    for rid, prompt, budget, steps in script:
        slots[rid] = admit(rid, prompt, budget)
        for _ in range(steps):
            pump(engine.step())
    engine.cancel(slots[2])
    pump(engine.take_pending_events())
    admit(4, shared + [20, 21], 6)
    while engine.num_active or engine.has_pending_prefill or engine.has_pending_events:
        pump(engine.step())
    return streams


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_mixed_schedule_matches_jax_and_the_paged_engine(gpt, sampled):
    port = dense(gpt, "torch", seed=7, **MIXED_KW)
    got = mixed_schedule(port, sampled)
    assert got == mixed_schedule(gpt.engine("torch", pool="f32", seed=7, **MIXED_KW), sampled)
    assert leaks(port) == (0, 0, 0)
    if not sampled:  # JAX samples with threefry, the port with Philox
        jeng = dense(gpt, "jax", seed=7, **MIXED_KW)
        assert got == mixed_schedule(jeng)
        assert dispatches(port) == dispatches(jeng)


@pytest.mark.parametrize("name", [n for n in SCHEDULES if n != "teardowns_leak_no_blocks"])
def test_prefix_schedule_matches_jax_dense_engine(gpt, name):
    got = SCHEDULES[name](lambda **kw: dense(gpt, "torch", **kw))
    assert got == SCHEDULES[name](lambda **kw: dense(gpt, "jax", **kw))
    assert got["leaks"] == (0, 0, 0)


def test_rebuild_keeps_the_prefix_pool_and_resumes_hit_it(gpt):
    """``test_chaos.py:128-148`` on dense engines: the pinned salvage paths
    survive the rebuild with the pool, so each resume prefills a suffix."""
    kw = dict(num_slots=2, prefill_buckets=(8, 16, 32), blocks=64, prefix_cache_generated=True)
    fault = dict(step_dispatch_failures=(6,))
    clean_eng = dense(gpt, "torch", **kw)
    clean = run_batcher(clean_eng, PAIR)
    eng, sup = dense(gpt, "torch", faults=fault, **kw), supervisor()
    got = run_batcher(eng, PAIR, sup)
    jeng = dense(gpt, "jax", faults=fault, **kw)
    assert got == clean == run_batcher(jeng, PAIR, supervisor(JaxSupervisor))
    assert eng.failure_count == 1 and sup.stats()["recovered_requests"] == 2
    assert dispatches(eng) == dispatches(jeng)
    # the clean run hits nothing; the resume of the transcript that had
    # indexed a block hits it in the pool that outlived the rebuild
    assert clean_eng.prefix_cache.stats()["hits"] == 0 and eng.prefix_cache.stats()["hits"] == 1
    assert leaks(eng) == (0, 0, 0)


def test_failed_save_rebuilds_the_prefix_pool_alone(gpt):
    """``continuous.py:1694-1732``: a block save that fails forgets every
    cached prefix; the request in flight is untouched."""
    prompt = list(range(1, 15))

    def run(kind):
        eng = dense(gpt, kind)
        first = eng.generate(prompt, 6)
        save = "_save" if kind == "torch" else "_save_fn"
        original = getattr(eng, save)

        def fail(*args, **kwargs):
            raise RuntimeError("injected save failure")

        setattr(eng, save, fail)
        second = eng.generate(list(range(100, 114)), 6)  # a miss whose save fails
        cached = eng.prefix_cache.cached_blocks
        setattr(eng, save, original)
        third = eng.generate(prompt, 6)  # the pool was rebuilt: a miss again
        return [first, second, third], cached, dispatches(eng), leaks(eng)

    got = run("torch")
    assert got == run("jax")
    assert got[1] == 0 and got[2][4]["hits"] == 0 and got[0][0] == got[0][2]


def test_accounting_and_the_batcher_read_as_jax(gpt):
    want = [dense(gpt, "torch").generate(p, b) for p, b in PAIR]
    for kind, telemetry in (("torch", Telemetry()), ("jax", JaxTelemetry())):
        eng = dense(gpt, kind, blocks=8, telemetry=telemetry)
        assert eng.block_demand(10, 5) == 0 and eng.available_blocks() is None
        assert eng.pool_signal() is None and eng.kv_pool_stats() == {} and eng.paged_attn_impl is None
        batcher = ContinuousBatcher(eng, device="cpu") if kind == "torch" else JaxBatcher(eng)
        batcher._worker = _Worker()  # _submit starts no thread: the loop runs below
        sinks = [Sink() for _ in PAIR]
        for (prompt, budget), sink in zip(PAIR, sinks):
            batcher._submit(prompt, budget, sink, {})
        run(batcher)
        assert [s.result() for s in sinks] == want
        admissions = [s.get("attrs", {}) for t in telemetry.recent(10) for s in t["spans"]
                      if s["kind"] == "admission"]
        assert len(admissions) == 2 and all(a["block_demand"] == 0 and a.get("available_blocks") is None
                                            for a in admissions)
    batcher = ContinuousBatcher(dense(gpt, "torch", blocks=8), device="cpu")
    assert batcher.scheduler.stats()["pool"] is None and not batcher._block_starved()
    batcher.close()


def test_constructor_errors(gpt):
    for kind in ("torch", "jax"):
        with pytest.raises(ValueError, match="kv_quantize requires paged=True"):
            gpt.engine(kind, pool="int8", paged=False)
    # tensor, fsdp, sequence and expert axes serve (tests/test_torch_tensor_parallel.py,
    # tests/test_torch_mesh_serving_axes.py), and so do experts over an expert and a tensor axis at once
    # (tests/test_torch_expert_axes.py): each rank holds 2 of the 4 experts at half their hidden width,
    # its partial outputs summed over the 4 ranks of expert×tensor
    sparse = GPTLMHeadModel(GPTConfig.tiny(dtype=torch.float32, moe_every=2, num_experts=4), device="cpu")
    assert expert_tensor_layout(sparse) == [((2, 64, 128), (2, 128, 64), 4)]
    with pytest.raises(ValueError, match="paged"):
        SpeculativeEngine(gpt.tmodel, gpt.tmodel, paged=False, device="cpu")
    eng = dense(gpt, "torch", blocks=0)
    assert eng.prefix_cache is None and eng._pool is None and eng._cache["layer_0"]["k"].shape == (4, 4, 64, 16)
    eng.enable_prefix_cache(8, block_size=8)
    assert eng.block_size == 8 and eng._pool["layer_0"]["k"].shape == (8, 4, 8, 16)
    assert np.asarray(run_schedule(eng, [(list(range(1, 20)), 4)] * 2)).shape == (2, 4)
    assert eng.prefix_cache.stats()["hits"] == 1
