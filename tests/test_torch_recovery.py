"""Port parity: fault injection, salvage, rebuild and supervised recovery.

Ports ``tests/unit/test_chaos.py`` without its mesh, HTTP, deadline and
telemetry cases (ROADMAP M12, slices 6 and 7), and
``tests/unit/test_paged_kv.py:196-223``, on the tiny GPT with JAX's weights
(``tests/test_torch_prefix_cache.py``'s pair). Each batcher run drives the
worker's loop on the test's thread, so the schedule is fixed:

- a dispatch or deferred-fetch fault mid-decode under an ``EngineSupervisor``:
  every request completes; greedy streams equal the fault-free run's and the
  JAX batcher's under the same plan (int8 and f32 pools); fixed-seed sampled
  streams equal the fault-free run's (port against port: the generator is put
  back where the first undelivered burst found it); health ends ``ok``;
- attributable faults fail one request, structured: a prefill fault, a
  chunked-prefill fault, NaN logits (siblings exact, greedy and sampled), a
  quarantined slot's reuse; pool exhaustion only skips indexing;
- the watchdog trips on a fetch stall and recovers; rebuild backoff
  succeeds within its budget, exhaustion fails everything fast; without a
  supervisor every request fails structured and the engine serves on;
- teardowns and pins: abort_all and close mid chunked prefill, preempt then
  failure, ``take_salvage``'s pin ownership, ``drain``; no block, reference
  or pin leaks anywhere;
- the speculative engine: a failure mid-speculation rebuilds both pools and
  the streams equal a fault-free run; ``SpeculativeBatcher``'s round fault.

Sampled streams resumed mid-way are compared on f32 pools: a resume
re-prefills the delivered tokens, and an int8 block quantized at once rounds
differently from one appended token by token. On the card a rebuild drops the
burst graphs and recaptures them: ``test_torch_graphs.py::
test_engine_rebuild_recaptures_its_graphs``.
"""

import asyncio

import numpy as np
import pytest
import torch

from tests.test_torch_prefix_cache import Pair, leaks
from tests.torch_xp_axes_ranks import expert_tensor_layout
from unionml_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from unionml_tpu.serving.supervisor import EngineSupervisor as JaxSupervisor
from unionml_tpu.serving.telemetry import Telemetry as JaxTelemetry
from unionml_tpu_torch.models import GPTConfig, GPTLMHeadModel
from unionml_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeEngine,
    EngineFailure,
    EngineSupervisor,
    FaultError,
    FaultPlan,
    PreemptedSlot,
    SpeculativeBatcher,
    SpeculativeEngine,
    Telemetry,
)

PROMPT_A, BUDGET_A = [3, 1, 4, 1, 5], 12
PROMPT_B, BUDGET_B = [2, 7, 1], 10
PAIR = [(PROMPT_A, BUDGET_A), (PROMPT_B, BUDGET_B)]
CHAOS_KW = dict(num_slots=2, prefill_buckets=(8, 16, 32), blocks=64, pool="f32")


@pytest.fixture(scope="module")
def gpt():
    return Pair()


def engine(gpt, kind="torch", **kw):
    return gpt.engine(kind, **dict(CHAOS_KW, **kw))


def supervisor(cls=EngineSupervisor, **kw):
    kw.setdefault("watchdog_interval_s", 0)  # tests call check() themselves
    kw.setdefault("backoff_s", 0.005)
    kw.setdefault("backoff_max_s", 0.02)
    return cls(**kw)


class Sink:
    cancelled = False

    def __init__(self):
        self.tokens, self.done, self.error = [], False, None

    def emit(self, token):
        self.tokens.append(token)

    def finish(self):
        self.done = True

    def fail(self, exc):
        self.error = exc

    def result(self):
        return self.error if self.error is not None else self.tokens


def run_batcher(eng, requests, sup=None, **sampling):
    """Queue every request, then run the batcher's worker loop on this thread
    until it drains (one fixed schedule); JAX's batcher for a JAX engine."""
    sinks = [Sink() for _ in requests]
    if isinstance(eng, DecodeEngine):
        batcher = ContinuousBatcher(eng, supervisor=sup, device="cpu")
        for (prompt, budget), sink in zip(requests, sinks):
            batcher.scheduler.submit(batcher.scheduler.make_ticket(
                np.asarray(prompt, dtype=np.int32), budget, dict(sampling), sink))
    else:
        batcher = JaxBatcher(eng, supervisor=sup)
        for (prompt, budget), sink in zip(requests, sinks):
            batcher.scheduler.submit(batcher.scheduler.make_ticket(
                np.asarray(prompt, dtype=np.int32), budget, dict(sampling), sink))
    batcher._closed = True
    batcher._run()
    if sup is not None:
        sup.close()
    return [s.result() for s in sinks]


def no_leaks(eng):
    assert leaks(eng) == (0, 0, 0)


# ------------------------------------------------------- recoverable: token parity


@pytest.mark.parametrize("pool", ["int8", "f32"])
@pytest.mark.parametrize("fault", [dict(step_dispatch_failures=(4,)), dict(step_fetch_failures=(3,))],
                         ids=["dispatch_fault", "deferred_fetch_fault"])
def test_engine_failure_recovers_token_identical_greedy(gpt, fault, pool):
    """``test_chaos.py:128-148``: a device fault mid-decode costs nothing
    observable; the port equals the fault-free run and the JAX batcher."""
    clean = run_batcher(engine(gpt, pool=pool), PAIR)
    sup = supervisor()
    eng = engine(gpt, pool=pool, faults=fault)
    got = run_batcher(eng, PAIR, sup)
    want = run_batcher(engine(gpt, "jax", pool=pool, faults=fault), PAIR, supervisor(JaxSupervisor))
    assert got == clean == want
    assert eng.failure_count == 1 and eng.rebuilds >= 1
    stats = sup.stats()
    assert stats["health"] == "ok" and stats["recovered_requests"] == 2 and stats["failed_requests"] == 0
    no_leaks(eng)


@pytest.mark.parametrize("fault", [dict(step_dispatch_failures=(4,)), dict(step_fetch_failures=(3,)),
                                   dict(step_fetch_failures=(2,), step_dispatch_failures=(6,))],
                         ids=["dispatch_fault", "deferred_fetch_fault", "two_faults"])
def test_engine_failure_recovers_token_identical_fixed_seed_sampled(gpt, fault):
    """``test_chaos.py:151-178``, port against port: the rebuilt engine's
    generator starts where the first undelivered burst found it, so resumed
    sampled streams equal the fault-free run's."""
    def run(faults, sup=None):
        eng = engine(gpt, faults=faults, temperature=0.8, seed=7)
        out = run_batcher(eng, PAIR, sup, temperature=0.8)
        no_leaks(eng)
        return out

    clean = run(None)
    assert all(isinstance(r, list) and r for r in clean)
    assert run(fault, supervisor()) == clean


def test_recovery_works_without_prefix_cache(gpt):
    """``test_chaos.py:181-191``: salvage re-prefills the whole transcript."""
    clean = run_batcher(engine(gpt, blocks=0), PAIR)
    sup = supervisor()
    assert run_batcher(engine(gpt, blocks=0, faults=dict(step_dispatch_failures=(5,))), PAIR, sup) == clean
    assert sup.stats()["recovered_requests"] == 2


def test_unsupervised_failure_fails_structured_then_serves(gpt):
    """``test_chaos.py:194-205``."""
    eng = engine(gpt, faults=dict(step_dispatch_failures=(4,)))
    results = run_batcher(eng, PAIR)
    assert all(isinstance(r, EngineFailure) and r.reason == "injected_step_dispatch" for r in results)
    no_leaks(eng)
    assert eng.generate(PROMPT_A, 6) == engine(gpt).generate(PROMPT_A, 6)


# --------------------------------------------------- attributable: one request


def test_prefill_failure_fails_only_that_request(gpt):
    """``test_chaos.py:230-257``: the batched prefill (#1) and the raiser's
    retry (#2) fail; its siblings admit one at a time and decode exactly."""
    eng = engine(gpt, num_slots=4, faults=dict(prefill_failures=(1, 2)))
    prompts = [[3, 1, 4], [2, 7, 5], [9, 9, 1]]
    results = run_batcher(eng, [(p, 5) for p in prompts])
    assert isinstance(results[0], EngineFailure) and results[0].reason == "injected_prefill"
    fresh = engine(gpt, num_slots=4)
    assert results[1:] == [fresh.generate(p, 5) for p in prompts[1:]]
    assert eng.failure_count == 0
    no_leaks(eng)


def test_chunked_prefill_failure_kills_only_that_slot(gpt):
    """``test_chaos.py:260-280``."""
    eng = engine(gpt, prefill_buckets=(8, 32), prefill_chunk=4, faults=dict(prefill_failures=(3,)))
    sibling = eng.add_request([2, 7], 8)
    (chunked,) = eng.admit_many([(list(range(1, 15)), 5)])
    out, events = [], []
    while eng.num_active or eng.has_pending_prefill or eng.has_pending_events:
        for ev in eng.step():
            events.append(ev)
            if ev.slot == sibling and ev.emit:
                out.append(ev.token)
    errors = [ev for ev in events if ev.error is not None]
    assert len(errors) == 1 and errors[0].slot == chunked and errors[0].error == "prefill_failed"
    assert out == engine(gpt).generate([2, 7], 8)
    no_leaks(eng)


@pytest.mark.parametrize("pool", ["int8", "f32"])
def test_nan_logits_quarantines_one_slot_siblings_exact(gpt, pool):
    """``test_chaos.py:283-300``, against the JAX batcher too."""
    clean = run_batcher(engine(gpt, pool=pool), PAIR)
    sup = supervisor()
    eng = engine(gpt, pool=pool, faults=dict(nan_logits=((5, 0),)))
    got = run_batcher(eng, PAIR, sup)
    want = run_batcher(engine(gpt, "jax", pool=pool, faults=dict(nan_logits=((5, 0),))), PAIR,
                       supervisor(JaxSupervisor))
    assert isinstance(got[0], EngineFailure) and got[0].reason == "nan_logits"
    assert got[1] == clean[1] == want[1] and want[0].reason == "nan_logits"
    assert eng.quarantined_requests == 1 and eng.failure_count == 0 and sup.stats()["health"] == "ok"
    no_leaks(eng)


def test_nan_quarantine_sampled_sibling_parity(gpt):
    """``test_chaos.py:303-324``: a quarantine never moves a sampled
    sibling's draws (every row draws at every sampling step)."""
    def run(faults):
        eng = engine(gpt, faults=faults, temperature=0.8, seed=11)
        a = eng.add_request(PROMPT_A, 8, temperature=0.8)
        b = eng.add_request(PROMPT_B, 8, temperature=0.8)
        out = {a: [], b: []}
        while eng.num_active or eng.has_pending_events:
            for ev in eng.step():
                if ev.emit:
                    out[ev.slot].append(ev.token)
        no_leaks(eng)
        return out[a], out[b]

    clean_a, clean_b = run(None)
    _, faulty_b = run(dict(nan_logits=((3, 0),)))
    assert faulty_b == clean_b and len(clean_a) == 8


def test_quarantined_slot_reuse_never_inherits_stale_burst_token(gpt):
    """``test_chaos.py:327-349``."""
    eng = engine(gpt, num_slots=1, faults=dict(nan_logits=((3, 0),)))
    eng.add_request(PROMPT_A, 10)
    assert any(any(ev.error == "nan_logits" for ev in eng.step()) for _ in range(20))
    eng.add_request(PROMPT_B, 6)
    out = []
    while eng.num_active or eng.has_pending_events:
        out.extend(ev.token for ev in eng.step() if ev.emit)
    assert out == engine(gpt).generate(PROMPT_B, 6)
    no_leaks(eng)


def test_pool_exhaustion_at_admit_degrades_gracefully(gpt):
    """``test_chaos.py:352-369``: nothing is indexed, the request is exact."""
    eng = engine(gpt, faults=dict(pool_exhausted_admits=(1,)))
    prompt = list(range(1, 13))
    want = engine(gpt, blocks=0).generate(prompt, 5)
    assert eng.generate(prompt, 5) == want
    assert eng._faults.observed.get("pool_exhausted", 0) >= 1
    assert eng.prefix_cache.stats()["inserted_blocks"] == 0
    assert eng.generate(prompt, 5) == want
    assert eng.prefix_cache.stats()["inserted_blocks"] > 0
    no_leaks(eng)


# ----------------------------------------------------------- watchdog & rebuilds


def test_fetch_stall_trips_watchdog_then_recovers(gpt):
    """``test_chaos.py:372-397``, with the batcher's and the watchdog's threads."""
    eng = engine(gpt, faults=dict(fetch_stalls=((2, 300.0),)))
    sup = EngineSupervisor(stall_timeout_s=0.05, watchdog_interval_s=0.02, backoff_s=0.005)
    batcher = ContinuousBatcher(eng, supervisor=sup, device="cpu")
    try:
        out = asyncio.run(batcher.generate(PROMPT_A, 8))
    finally:
        batcher.close()
    assert out == engine(gpt).generate(PROMPT_A, 8)
    sup.check()
    stats = sup.stats()
    assert stats["watchdog_trips"] >= 1 and stats["health"] == "ok"
    assert sup.last_fault["reason"] == "watchdog_stall" and eng._faults.injected.get("fetch_stall") == 1


def test_watchdog_check_is_deterministic_synchronously(gpt):
    """``test_chaos.py:400-418``."""
    eng = engine(gpt)
    sup = supervisor(stall_timeout_s=1.0)
    sup.attach(eng)
    eng.add_request(PROMPT_A, 4)
    now = eng.last_heartbeat
    assert not sup.check(now=now + 0.5)
    assert sup.check(now=now + 2.0) and sup.check(now=now + 3.0)
    assert sup.stats()["watchdog_trips"] == 1 and sup.state == "degraded"
    eng.last_heartbeat = now + 10.0
    assert not sup.check(now=now + 10.5) and sup.state == "ok"


def test_rebuild_backoff_succeeds_within_budget(gpt):
    """``test_chaos.py:421-438``: the in-place rebuild and one retry fail, the
    next lands; requests still recover exactly."""
    clean = run_batcher(engine(gpt), PAIR)
    sup = supervisor(max_rebuild_attempts=3)
    eng = engine(gpt, faults=dict(step_dispatch_failures=(4,), rebuild_failures=2))
    assert run_batcher(eng, PAIR, sup) == clean
    stats = sup.stats()
    assert stats["health"] == "ok" and stats["rebuild_attempts"] == 2 and stats["recovered_requests"] == 2
    no_leaks(eng)


def test_rebuild_exhaustion_fails_everything_structured_and_fast(gpt):
    """``test_chaos.py:441-476``: a dead engine fails every request and
    refuses new work at once; its worker idles instead of spinning."""
    sup = supervisor(max_rebuild_attempts=2)
    eng = engine(gpt, faults=dict(step_dispatch_failures=(4,), rebuild_failures=99))
    batcher = ContinuousBatcher(eng, supervisor=sup, device="cpu")

    async def main():
        results = await asyncio.gather(batcher.generate(PROMPT_A, BUDGET_A), batcher.generate(PROMPT_B, BUDGET_B),
                                       return_exceptions=True)
        with pytest.raises(EngineFailure) as fast:
            await batcher.generate([5, 5], 4)
        return results, fast.value

    try:
        results, fast = asyncio.run(main())
        attempts = sup.stats()["rebuild_attempts"]
        asyncio.run(asyncio.sleep(0.1))
        assert sup.stats()["rebuild_attempts"] == attempts  # no retry loop behind a dead engine
    finally:
        batcher.close()
    assert sup.state == "failed"
    assert all(isinstance(r, EngineFailure) and r.reason in ("engine_failed", "engine_rebuilding") for r in results)
    assert fast.reason == "engine_failed" and not fast.retryable
    assert sup.stats()["failed_requests"] >= 2
    no_leaks(eng)


def test_classify_names_torch_device_errors():
    assert EngineSupervisor.classify(FaultError("x", site="step_fetch")) == "injected_step_fetch"
    assert EngineSupervisor.classify(EngineFailure("x", reason="pool_exhausted")) == "pool_exhausted"
    assert EngineSupervisor.classify(torch.cuda.OutOfMemoryError("CUDA out of memory")) == "device_oom"
    assert EngineSupervisor.classify(RuntimeError("CUDA error: an illegal memory access")) == "cuda_error"
    assert EngineSupervisor.classify(ValueError("other")) == "device_failure"
    # the supervisor's telemetry, op for op against JAX's
    renders = []
    for sup_cls, tel_cls in ((EngineSupervisor, Telemetry), (JaxSupervisor, JaxTelemetry)):
        tel = tel_cls()
        sup = sup_cls(watchdog_interval_s=0, max_rebuild_attempts=1, sleep_fn=lambda s: None, telemetry=tel)
        sup.note_failure(FaultError("x", site="step_fetch"))
        sup.note_rebuilt()
        sup.note_failure(FaultError("y", site="step_dispatch"))
        assert sup.run_rebuild(lambda: None)
        sup.note_failure(FaultError("z", site="rebuild"))
        assert not sup.run_rebuild(lambda: (_ for _ in ()).throw(FaultError("w", site="rebuild")))
        renders.append(tel.metrics.render())
        assert tel.rebuilds_total.value() == 2 and tel.health_transitions_total.value("failed") == 1
    assert renders[0] == renders[1]


# ----------------------------------------------------------- teardowns and pins


def test_abort_all_mid_chunked_prefill_releases_everything(gpt):
    """``test_chaos.py:516-527``."""
    eng = engine(gpt, prefill_buckets=(8, 16, 32), prefill_chunk=4)
    seed = list(range(1, 15))
    want = eng.generate(seed, 4)
    eng.admit_many([(seed[:12] + [40] * 8, 5)])
    assert eng.has_pending_prefill
    eng.abort_all()
    no_leaks(eng)
    assert eng.generate(seed, 4) == want


def test_batcher_close_mid_chunked_prefill_no_pin_leak(gpt):
    """``test_chaos.py:530-548``."""
    eng = engine(gpt, prefill_buckets=(8, 32), prefill_chunk=4)
    batcher = ContinuousBatcher(eng, device="cpu")

    async def main():
        fut = asyncio.ensure_future(batcher.generate(list(range(1, 20)), 5))
        while not eng.has_pending_prefill and not eng.num_active:
            await asyncio.sleep(0.002)
        batcher.close()
        try:
            await asyncio.wait_for(fut, timeout=5.0)
        except (EngineFailure, RuntimeError):
            pass  # completed or closed; hanging is the failure

    asyncio.run(main())
    no_leaks(eng)


def test_preempt_then_engine_failure_keeps_checkpoint_resumable(gpt):
    """``test_chaos.py:551-594``: the rebuild drops the checkpoint's pins
    (the pool restarts empty); the transcript alone resumes it exactly."""
    expected = engine(gpt).generate(PROMPT_A, BUDGET_A)
    eng = engine(gpt, faults={})
    slot = eng.add_request(PROMPT_A, BUDGET_A)
    out = []
    for _ in range(5):
        out.extend(ev.token for ev in eng.step() if ev.emit)
    state = eng.preempt(slot)
    assert state is not None and eng.prefix_cache.pinned_blocks == len(state.path) > 0
    out.extend(ev.token for ev in eng.take_pending_events() if ev.emit and ev.slot == slot)
    eng.add_request(PROMPT_B, BUDGET_B)
    eng._faults.step_dispatch_failures = (eng._faults._dispatches + 1,)
    with pytest.raises(FaultError):
        eng.step()
    salvage = eng.take_salvage()
    assert salvage
    for rec in salvage:
        eng.release_preempted(PreemptedSlot(tokens=rec.tokens, path=rec.path))
    assert eng.prefix_cache.pinned_blocks == 0 and eng.prefix_cache.slot_blocks == 0
    eng.add_request(state.tokens, BUDGET_A - (len(state.tokens) - len(PROMPT_A)))
    eng.release_preempted(state)  # stale pins: the count never goes negative
    while eng.num_active or eng.has_pending_events:
        out.extend(ev.token for ev in eng.step() if ev.emit)
    assert out == expected
    no_leaks(eng)


def test_rebuild_schedule_parity_and_zero_leaks(gpt):
    """``test_paged_kv.py:196-223``: transcript-only salvage re-admitted by
    hand finishes exactly; the grants were returned at capture."""
    prompt, budget = [3, 1, 4, 1, 5], 10
    expected = engine(gpt).generate(prompt, budget)
    eng = engine(gpt, faults=dict(step_dispatch_failures=(3,)))
    eng.add_request(prompt, budget)
    out = []
    with pytest.raises(FaultError):
        while True:
            out.extend(ev.token for ev in eng.step() if ev.emit)
    (rec,) = eng.take_salvage()
    assert rec.path == [] and eng._allocator.slot_blocks == 0
    assert eng.take_salvage() == []  # collected once
    eng.add_request(rec.tokens, rec.remaining)
    eng.release_preempted(PreemptedSlot(tokens=rec.tokens, path=rec.path))
    while eng.num_active or eng.has_pending_prefill or eng.has_pending_events:
        out.extend(ev.token for ev in eng.step() if ev.emit)
    assert out == expected and eng.robustness_stats()["engine_failures"] == 1
    no_leaks(eng)


def test_drain_finishes_inflight_then_refuses_new_work(gpt):
    """``test_chaos.py:702-726``."""
    expected = engine(gpt).generate(PROMPT_A, BUDGET_A)
    eng = engine(gpt)
    batcher = ContinuousBatcher(eng, supervisor=supervisor(), device="cpu")

    async def main():
        fut = asyncio.ensure_future(batcher.generate(PROMPT_A, BUDGET_A))
        while not eng.num_active:
            await asyncio.sleep(0.005)
        await asyncio.get_running_loop().run_in_executor(None, batcher.drain, 10.0)
        with pytest.raises(EngineFailure) as err:
            await batcher.generate(PROMPT_B, 4)
        assert err.value.reason == "batcher_closed"
        return await fut

    assert asyncio.run(main()) == expected
    no_leaks(eng)


# ------------------------------------------------------------------ speculation


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_speculative_engine_recovers_token_identical(gpt, sampled):
    """A dispatch fault mid-speculation: the rebuild reallocates the draft
    pool with the target's; streams equal a fault-free run (sampled rounds
    select by key, re-armed from each request's seed)."""
    def run(faults, sup=None):
        plan = FaultPlan(**faults) if faults is not None else None
        eng = SpeculativeEngine(gpt.tmodel, gpt.tmodel, num_slots=2, max_len=64, prefill_buckets=(8, 16, 32),
                                block_size=4, prefix_cache_blocks=32, kv_quantize="int8", faults=plan, device="cpu")
        sampling = dict(speculative=True, temperature=0.8, seed=5) if sampled else dict(speculative=True)
        out = run_batcher(eng, PAIR, sup, **sampling)
        no_leaks(eng)
        return out, eng

    clean, _ = run(None)
    got, eng = run(dict(step_dispatch_failures=(3,)), supervisor())
    assert got == clean and eng.failure_count == 1 and eng.spec_round_dispatches > 0


def test_speculative_round_failure_is_structured_and_isolated(gpt):
    """``test_chaos.py:597-614`` on the port's ``SpeculativeBatcher``."""
    spec = SpeculativeBatcher(gpt.tmodel, gpt.tmodel, gamma=2, max_len=64,
                              faults=FaultPlan(speculative_round_failures=(1,)), device="cpu")
    with pytest.raises(EngineFailure) as err:
        asyncio.run(spec.generate([3, 1, 4], 5))
    assert err.value.reason == "speculative_round_failed" and spec.round_failures == 1
    assert len(asyncio.run(spec.generate([3, 1, 4], 5))) == 5
    spec.close()


def test_unported_modes_raise_naming_their_items(gpt):
    # tensor, fsdp, sequence and expert axes serve (tests/test_torch_tensor_parallel.py,
    # tests/test_torch_mesh_serving_axes.py), and so do experts over an expert and a tensor axis at once
    # (tests/test_torch_expert_axes.py): each rank holds 2 of the 4 experts at half their hidden width,
    # its partial outputs summed over the 4 ranks of expert×tensor
    sparse = GPTLMHeadModel(GPTConfig.tiny(dtype=torch.float32, moe_every=2, num_experts=4), device="cpu")
    assert expert_tensor_layout(sparse) == [((2, 64, 128), (2, 128, 64), 4)]
    # telemetry is wired: the engine names its paged attention path and feeds the pool gauges
    tel = Telemetry()
    eng = DecodeEngine(gpt.tmodel, max_len=64, device="cpu", telemetry=tel, kv_quantize="int8")
    assert tel.paged_attn_impl.value("reference") == 1.0 and eng.kv_pool_stats()["impl"] == "reference"
    eng.generate([3, 1, 4], 4)
    assert tel.pool_kv_bytes.value("int8") == eng.kv_pool_stats()["kv_pool_bytes"] > 0
    assert tel.tokens_out_total.value() == 4
