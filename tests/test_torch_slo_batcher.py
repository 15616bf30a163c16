"""Port parity: the batchers' SLO policy against the JAX package's batchers.

The cases of ``tests/unit/test_scheduler.py:224-813`` (mesh and telemetry
aside): priority order under contention, preempt-to-prefix-cache end to end
(pipelined and not, int8 and f32 pools), refcounts released, deadlines
while queued and while running, displacement, close, a preempt racing a
disconnect, the preempt bookkeeping and requeue failures that must drop
their pin, and the speculative batcher's routing and turn-taking.

Every schedule is fixed: the batcher's worker loop runs on the test thread
(``batcher._run()`` with a stand-in worker, so ``_submit`` starts no thread),
and a request that arrives mid-decode is submitted from a sink's ``emit``
when a stream reaches a given token. Deadlines are expired by setting a
ticket's ``deadline`` in the past, never by sleeping. The port's batcher and
JAX's run the same schedule over the same tiny GPT (weights carried across)
and must give the same greedy streams, the same failures and the same
scheduler counters, with no pinned or slot-owned block left.
"""

import asyncio
import threading

import pytest

from tests.test_torch_prefix_cache import Pair, leaks
from unionml_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from unionml_tpu.serving.scheduler import SchedulerConfig as JaxConfig
from unionml_tpu.serving.speculative import SpeculativeBatcher as JaxSpeculativeBatcher
from unionml_tpu_torch.serving import (
    ContinuousBatcher,
    DeadlineExceededError,
    QueueFullError,
    SchedulerConfig,
    SpeculativeBatcher,
    SpeculativeEngine,
)

HOG, HOG_BUDGET = [9, 9, 1, 2], 40
INTER, INTER_BUDGET = [3, 1, 4], 4


@pytest.fixture(scope="module")
def gpt():
    return Pair()


class Sink:
    """Records tokens, the finish order and failures; ``hook(n)`` runs after
    the n-th token."""

    order: list = []
    cancelled = False

    def __init__(self, name, hook=None):
        self.name, self.hook = name, hook
        self.tokens, self.error, self.done = [], None, False

    def emit(self, token):
        self.tokens.append(token)
        if self.hook is not None:
            self.hook(len(self.tokens))

    def finish(self):
        self.done = True
        self.order.append(self.name)

    def fail(self, exc):
        self.error = exc
        self.order.append(self.name)

    def result(self):
        return self.tokens if self.error is None else (type(self.error).__name__, self.error.reason)


class _Worker:
    """Stands in for the worker thread, so ``_submit`` starts none."""

    @staticmethod
    def is_alive():
        return True

    @staticmethod
    def join(timeout=None):
        return None


def batcher_for(gpt, kind, scheduler=None, *, pipeline=True, pool="f32", blocks=64, num_slots=1, **engine_kw):
    """A batcher of ``kind`` with aging off (``aging_s=0``): aging reads the
    wall clock, and the order under test must not depend on how fast this
    host decodes (aging itself is tested on a virtual clock in
    ``test_torch_scheduler.py``)."""
    engine = gpt.engine(kind, num_slots=num_slots, prefill_buckets=(8, 16, 32), blocks=blocks, pool=pool,
                        pipeline=pipeline, **engine_kw)
    scheduler = dict(scheduler or {}, aging_s=0)
    if kind == "jax":
        batcher = JaxBatcher(engine, scheduler=JaxConfig(**scheduler))
    else:
        batcher = ContinuousBatcher(engine, scheduler=SchedulerConfig(**scheduler), device="cpu")
    batcher._worker = _Worker()
    return batcher


def submit(batcher, prompt, budget, sink, **slo):
    """``_submit`` from the test thread, also while ``_run`` drives the loop."""
    closed, batcher._closed = batcher._closed, False
    try:
        batcher._submit(prompt, budget, sink, {}, **slo)
    finally:
        batcher._closed = closed


def run(batcher):
    """The worker loop on this thread until queue and slots drain."""
    batcher._closed = True
    batcher._run()
    batcher._worker = None


def solo(gpt, prompt, budget, pool="f32"):
    return gpt.engine("torch", num_slots=1, prefill_buckets=(8, 16, 32), blocks=0, pool=pool).generate(prompt, budget)


def both(fn):
    """``fn(kind)`` for the port and for JAX; returns the port's, asserting
    that the two agree."""
    Sink.order = []
    port = fn("torch")
    port_order, Sink.order = Sink.order, []
    jax = fn("jax")
    assert port == jax
    assert port_order == Sink.order
    return port


def test_priority_ordering_under_contention(gpt):
    """``test_scheduler.py::test_priority_ordering_under_contention``: with the
    only slot held and no preemption, a later interactive request overtakes
    an earlier batch request."""
    def go(kind):
        batcher = batcher_for(gpt, kind, dict(preempt=False))
        hog, batch, inter = Sink("hog"), Sink("batch"), Sink("inter")
        submit(batcher, HOG, 25, hog)
        batcher._admit()  # the hog holds the slot before the others queue
        submit(batcher, [2, 7], 4, batch, priority="batch")
        submit(batcher, INTER, INTER_BUDGET, inter, priority="interactive")
        run(batcher)
        return [s.result() for s in (hog, batch, inter)], batcher.scheduler.stats()["admitted"]

    streams, admitted = both(go)
    assert Sink.order == ["hog", "inter", "batch"] and admitted == 3
    assert streams == [solo(gpt, HOG, 25), solo(gpt, [2, 7], 4), solo(gpt, INTER, INTER_BUDGET)]


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "unpipelined"])
def test_preempt_to_prefix_cache_end_to_end(gpt, pipeline, pool):
    """``test_scheduler.py::test_preempt_to_prefix_cache_end_to_end`` and
    ``::test_preempt_resume_token_parity_greedy`` through the batcher: a batch
    hog on the only slot is preempted for an interactive arrival after 5
    tokens and resumes through the prefix cache. Port == JAX; both outputs
    equal the requests alone (f32 pool); every pin and refcount released
    (``::test_preempt_refcounts_fully_released_after_completion``)."""
    def go(kind):
        batcher = batcher_for(gpt, kind, pipeline=pipeline, pool=pool)
        inter = Sink("inter")

        def arrive(n):
            if n == 5:
                submit(batcher, INTER, INTER_BUDGET, inter, priority="interactive")

        hog = Sink("hog", arrive)
        submit(batcher, HOG, HOG_BUDGET, hog, priority="batch")
        run(batcher)
        stats = batcher.scheduler.stats()
        engine = batcher.engine
        return ([hog.result(), inter.result()], stats["preemptions"], stats["resumes"], engine.preempted_requests,
                leaks(engine))

    (hog, inter), preemptions, resumes, preempted, leaked = both(go)
    assert Sink.order == ["inter", "hog"] and preemptions == resumes == preempted == 1
    assert leaked == (0, 0, 0)
    if pool == "f32":
        assert hog == solo(gpt, HOG, HOG_BUDGET) and inter == solo(gpt, INTER, INTER_BUDGET)


def test_preempt_resume_fixed_seed_sampled_equals_uninterrupted(gpt):
    """Port against port (``::test_preempt_resume_token_parity_fixed_seed_sampled``):
    on an f32 pool a sampled stream (temperature 0.8, seed 7) preempted after
    4 bursts and re-admitted from its checkpoint equals the uninterrupted one,
    pipelined and not."""
    prompt, budget = [3, 1, 4, 1, 5], 12

    def sampled(preempt_after, pipeline):
        engine = gpt.engine("torch", num_slots=2, prefill_buckets=(8, 16, 32), blocks=64, pool="f32",
                            temperature=0.8, seed=7, pipeline=pipeline)
        slot = engine.add_request(prompt, budget, temperature=0.8)
        out = []
        for _ in range(preempt_after or 0):
            out.extend(ev.token for ev in engine.step() if ev.emit)
        if preempt_after:
            state = engine.preempt(slot)
            out.extend(ev.token for ev in engine.take_pending_events() if ev.emit)
            engine.add_request(state.tokens, budget - (len(state.tokens) - len(prompt)), temperature=0.8)
            engine.release_preempted(state)
        while engine.num_active or engine.has_pending_events:
            out.extend(ev.token for ev in engine.step() if ev.emit)
        assert leaks(engine) == (0, 0, 0)
        return out

    for pipeline in (True, False):
        assert sampled(4, pipeline) == sampled(None, pipeline)


@pytest.mark.parametrize("where", ["queued", "running"])
def test_deadline_cancels_request(gpt, where):
    """``test_scheduler.py::test_deadline_cancels_queued_request`` and
    ``::test_deadline_cancels_running_request``: the request fails with
    ``DeadlineExceededError``, the miss is counted on its side, and the slot
    and its blocks return (the follow-up decodes as it would alone)."""
    def go(kind):
        batcher = batcher_for(gpt, kind, dict(preempt=False))
        hog, late, follow = Sink("hog"), Sink("late"), Sink("follow")
        if where == "queued":
            submit(batcher, HOG, 30, hog)
            batcher._admit()
            submit(batcher, INTER, INTER_BUDGET, late, deadline_ms=60_000)
            batcher.scheduler.peek().deadline = 0.0  # expired while queued behind the hog
        else:
            def expire(n):
                if n == 3:
                    next(t for t in batcher._slot_meta.values() if t.sink is late).deadline = 0.0
                    submit(batcher, INTER, INTER_BUDGET, follow)

            late.hook = expire
            submit(batcher, HOG, 30, late, deadline_ms=60_000)
        run(batcher)
        stats = batcher.scheduler.stats()
        return ([late.error.reason, late.tokens, hog.result(), follow.result()], stats["deadline_misses_queued"],
                stats["deadline_misses_running"], batcher.engine.num_active)

    (reason, tokens, hog, follow), queued, running, active = both(go)
    assert reason == "deadline_exceeded" and active == 0
    if where == "queued":
        assert (queued, running, tokens) == (1, 0, []) and hog == solo(gpt, HOG, 30)
    else:
        assert (queued, running) == (0, 1) and 3 <= len(tokens) < 30
        assert tokens == solo(gpt, HOG, 30)[: len(tokens)] and follow == solo(gpt, INTER, INTER_BUDGET)


def test_displaced_request_fails_with_queue_full(gpt):
    """``test_scheduler.py::test_displaced_request_fails_with_queue_full``: under
    a full queue (bound 1) an interactive arrival displaces the queued batch
    request, which fails fast with ``QueueFullError``."""
    def go(kind):
        batcher = batcher_for(gpt, kind, dict(max_queue=1, preempt=False))
        hog, batch, inter = Sink("hog"), Sink("batch"), Sink("inter")
        submit(batcher, HOG, 25, hog)
        batcher._admit()
        submit(batcher, [2, 7], 4, batch, priority="batch")
        submit(batcher, INTER, INTER_BUDGET, inter, priority="interactive")
        displaced_at_submit = batch.error is not None
        with pytest.raises(Exception) as shed:
            submit(batcher, [5, 5], 4, Sink("shed"), priority="batch")
        run(batcher)
        return ([s.result() for s in (hog, batch, inter)], displaced_at_submit, type(shed.value).__name__,
                batcher.scheduler.stats()["shed_queue_full"])

    (hog, batch, inter), displaced_at_submit, shed, count = both(go)
    assert batch == ("QueueFullError", "queue_full") and displaced_at_submit and shed == "QueueFullError"
    assert count == 2 and hog == solo(gpt, HOG, 25) and inter == solo(gpt, INTER, INTER_BUDGET)


def test_close_fails_queued_sinks_and_drops_resume_pins(gpt):
    """``test_scheduler.py::test_close_fails_queued_sinks_promptly``: ``close``
    fails every queued request with ``batcher_closed`` at once, a preempted
    request's resume among them, whose pin is dropped."""
    def go(kind):
        batcher = batcher_for(gpt, kind)
        hog, queued = Sink("hog"), Sink("queued")
        dispatch = batcher._dispatch_events if kind == "jax" else batcher._dispatch
        submit(batcher, HOG, HOG_BUDGET, hog, priority="batch")
        batcher._admit()
        while len(hog.tokens) < 5:
            dispatch(batcher.engine.step())
        submit(batcher, INTER, 20, Sink("inter"), priority="interactive")
        batcher._admit()  # preempts the hog: its resume waits queued, pinned
        submit(batcher, [2, 7], 4, queued)
        pinned = batcher.engine.prefix_cache.pinned_blocks
        batcher._worker = None
        batcher.close()
        return ([hog.error.reason, queued.error.reason], pinned > 0, batcher.engine.prefix_cache.pinned_blocks,
                batcher.scheduler.depth)

    reasons, was_pinned, pinned, depth = both(go)
    assert reasons == ["batcher_closed", "batcher_closed"] and was_pinned and pinned == 0 and depth == 0


def test_preempt_racing_disconnect_never_leaks_pinned_entry(gpt):
    """``test_scheduler.py::test_preempt_racing_disconnect_never_leaks_pinned_entry``:
    a preempted request whose consumer goes away while it waits re-queued
    drops its pin when the worker pops it."""
    def go(kind):
        batcher = batcher_for(gpt, kind)
        state = {}

        def inter_hook(n):
            if n == 1:  # the hog sits re-queued, pinned; its consumer leaves
                state["pinned"] = batcher.engine.prefix_cache.pinned_blocks
                hog.cancelled = True

        inter = Sink("inter", inter_hook)

        def arrive(n):
            if n == 1:
                submit(batcher, INTER, 30, inter, priority="interactive")

        hog = Sink("hog", arrive)
        submit(batcher, HOG, HOG_BUDGET, hog, priority="batch")
        run(batcher)
        engine = batcher.engine
        return (hog.tokens, inter.result(), state["pinned"] > 0, engine.prefix_cache.pinned_blocks,
                batcher.scheduler.stats()["preemptions"], leaks(engine))

    hog, inter, was_pinned, pinned, preemptions, leaked = both(go)
    assert was_pinned and pinned == 0 and preemptions == 1 and leaked == (0, 0, 0)
    assert hog == solo(gpt, HOG, HOG_BUDGET)[: len(hog)] and inter == solo(gpt, INTER, 30)


def test_preempt_bookkeeping_failure_drops_its_pin(gpt):
    """``test_scheduler.py::test_preempt_bookkeeping_failure_drops_its_pin``:
    a slot teardown that dies inside ``preempt`` after the pin was taken
    drops the pin before the error propagates."""
    for kind in ("torch", "jax"):
        engine = gpt.engine(kind, num_slots=2, prefill_buckets=(8, 16, 32), blocks=64, pool="f32")
        slot = engine.add_request([3, 1, 4, 1, 5], 14)
        for _ in range(5):
            engine.step()

        def boom(*args, **kwargs):
            raise RuntimeError("slot device update failed")

        engine._slot_device_update = boom
        with pytest.raises(RuntimeError, match="slot device update failed"):
            engine.preempt(slot)
        assert engine.prefix_cache.pinned_blocks == 0


def test_preempt_requeue_failure_releases_the_checkpoint(gpt):
    """``test_scheduler.py::test_preempt_requeue_failure_releases_the_checkpoint``:
    a re-queue that dies after ``preempt`` returned releases the checkpoint
    and fails the victim; the interactive request is served all the same."""
    def go(kind):
        batcher = batcher_for(gpt, kind)
        requeues = []

        def failing_requeue(meta, **kwargs):
            requeues.append(kwargs.get("preemption", True))
            raise RuntimeError("scheduler requeue failed")

        batcher.scheduler.requeue = failing_requeue
        inter = Sink("inter")

        def arrive(n):
            if n == 5:
                submit(batcher, INTER, INTER_BUDGET, inter, priority="interactive")

        hog = Sink("hog", arrive)
        submit(batcher, HOG, HOG_BUDGET, hog, priority="batch")
        run(batcher)
        return (requeues, type(hog.error).__name__, inter.result(), batcher.engine.prefix_cache.pinned_blocks,
                leaks(batcher.engine))

    requeues, hog_error, inter, pinned, leaked = both(go)
    assert requeues == [True] and hog_error == "RuntimeError" and pinned == 0 and leaked == (0, 0, 0)
    assert inter == solo(gpt, INTER, INTER_BUDGET)


# ------------------------------------------------------------ speculation


def _spec_pair(gpt, **scheduler):
    port = SpeculativeBatcher(gpt.tmodel, gpt.tmodel, gamma=2, max_len=64, device="cpu",
                              scheduler=SchedulerConfig(**scheduler) if scheduler else None)
    jax = JaxSpeculativeBatcher(gpt.jmodel, gpt.variables, gpt.jmodel, gpt.variables, gamma=2, max_len=64,
                                scheduler=JaxConfig(**scheduler) if scheduler else None)
    return port, jax


def test_speculative_routes_through_scheduler(gpt):
    """``test_scheduler.py::test_speculative_routes_through_scheduler``: the same
    structured shed at a zero bound, the same tokens, and the same scheduler
    and engine counters as JAX's facade."""
    for spec in _spec_pair(gpt, max_queue=0):
        with pytest.raises(Exception) as err:
            asyncio.run(spec.generate(INTER, 4))
        assert type(err.value).__name__ == "QueueFullError"
        assert spec.scheduler.stats()["shed_queue_full"] == 1 and spec.scheduler.stats()["policy"] == "priority"
        spec.close()
    port, jax = _spec_pair(gpt)
    got = [asyncio.run(s.generate(INTER, 5, priority="interactive", deadline_ms=60_000)) for s in (port, jax)]
    assert got[0] == got[1] == solo(gpt, INTER, 5)
    assert port.scheduler.stats()["admitted"] == jax.scheduler.stats()["admitted"] == 1
    assert vars(port.engine).keys() == vars(jax.engine).keys()
    assert port.engine.tokens_decoded == jax.engine.tokens_decoded == 5
    for s in (port, jax):
        s.close()


def test_speculative_priority_turn_taking(gpt):
    """``test_scheduler.py::test_speculative_priority_turn_taking``: with the
    stream held, a batch then an interactive request queue; once it frees,
    the interactive one runs first. The stream is held by the test (no sleep
    races a decode): both facades must give this order."""
    for spec in _spec_pair(gpt, aging_s=0):
        order = []

        async def main():
            async def one(name, priority):
                await spec.generate(INTER, 4, priority=priority)
                order.append(name)

            with spec._turn:
                spec._current = "held"
            tasks = [asyncio.ensure_future(one("batch", "batch"))]
            while spec.scheduler.depth < 1:
                await asyncio.sleep(0.005)
            tasks.append(asyncio.ensure_future(one("inter", "interactive")))
            while spec.scheduler.depth < 2:
                await asyncio.sleep(0.005)
            with spec._turn:
                spec._current = None
                spec._turn.notify_all()
            await asyncio.gather(*tasks)

        try:
            asyncio.run(main())
        finally:
            spec.close()
        assert order == ["inter", "batch"]


@pytest.mark.parametrize("cls, rounds", [("interactive", True), ("batch", False)])
def test_speculation_follows_the_class(gpt, cls, rounds):
    """``_spec_sampling``: on a ``SpeculativeEngine`` behind the batcher, the
    interactive class decodes speculatively by default and the batch class
    does not; both streams equal the vanilla engine's."""
    engine = SpeculativeEngine(gpt.tmodel, gpt.tmodel, gamma_max=2, num_slots=2, max_len=64,
                               prefill_buckets=(8, 16, 32), device="cpu")
    batcher = ContinuousBatcher(engine, scheduler=SchedulerConfig(aging_s=0), device="cpu")
    batcher._worker = _Worker()
    sinks = [Sink(i) for i in range(2)]
    for sink, prompt in zip(sinks, (INTER, HOG)):
        submit(batcher, prompt, 10, sink, priority=cls)
    run(batcher)
    assert [s.tokens for s in sinks] == [solo(gpt, INTER, 10), solo(gpt, HOG, 10)]
    assert (engine.speculation_stats()["rounds"] > 0) == rounds


def test_batcher_wires_engine_pool_signal_into_scheduler(gpt):
    """``test_scheduler.py::test_batcher_wires_engine_pool_signal_into_scheduler``:
    the scheduler's load signal and stats carry the engine's pool occupancy,
    with JAX's keys and values on an idle engine."""
    port = batcher_for(gpt, "torch", num_slots=2)
    jax = batcher_for(gpt, "jax", num_slots=2)
    pool = port.scheduler.load_signal()["pool"]
    assert pool.keys() == jax.scheduler.load_signal()["pool"].keys()
    assert pool["free_frac"] == 1.0 and pool["pressure"] == 0.0 and pool["pinned_frac"] == 0.0
    assert pool["available_blocks"] == pool["num_blocks"] > 0 and port.scheduler.stats()["pool"] == pool


def test_queue_wait_rides_first_step_event_only(gpt):
    """``test_scheduler.py::test_queue_wait_rides_first_step_event_only``."""
    engine = gpt.engine("torch", num_slots=1, prefill_buckets=(8,), blocks=0)
    slot = engine.add_request(INTER, 4)
    engine.note_queue_wait(slot, 12.5)
    events = []
    while engine.num_active or engine.has_pending_events:
        events.extend(engine.step())
    waits = [ev.queue_wait_ms for ev in events]
    assert waits[0] == 12.5 and all(w is None for w in waits[1:])
    assert engine.pipeline_stats()["ema_queue_wait_ms"] == 12.5


def test_threaded_batcher_serves_classes_and_deadlines(gpt):
    """The batcher with its own worker thread through ``generate``/``stream``:
    the hog's slot is held by a test-local gate on the engine's ``step`` (no
    sleep races a decode), so an interactive request preempts it, a queued
    request with an expired deadline fails 504-style while the engine is
    held, and a stream's shed raises at its first ``anext``."""
    engine = gpt.engine("torch", num_slots=1, prefill_buckets=(8, 16, 32), blocks=64, pool="f32")
    batcher = ContinuousBatcher(engine, scheduler=SchedulerConfig(max_queue=2, aging_s=0), device="cpu")
    gate, real_step = threading.Event(), engine.step

    def gated_step(lookahead=1):
        if not gate.is_set():
            gate.wait(0.01)
            return []
        return real_step(lookahead)

    engine.step = gated_step

    async def main():
        hog = asyncio.ensure_future(batcher.generate(HOG, HOG_BUDGET, priority="batch"))
        while not engine.num_active:
            await asyncio.sleep(0.005)
        with pytest.raises(DeadlineExceededError):  # batch: it queues behind the hog, no preemption
            await batcher.generate(INTER, 4, priority="batch", deadline_ms=20)
        late = batcher.stream(INTER, 4, priority="batch")
        filler = [asyncio.ensure_future(batcher.generate([2, 7], 4, priority="batch")) for _ in range(2)]
        while batcher.scheduler.depth < 2:
            await asyncio.sleep(0.005)
        with pytest.raises(QueueFullError):
            await late.__anext__()
        inter = asyncio.ensure_future(batcher.generate(INTER, INTER_BUDGET, priority="interactive"))
        gate.set()
        return await inter, await hog, await asyncio.gather(*filler, return_exceptions=True)

    try:
        inter, hog, filler = asyncio.run(main())
    finally:
        batcher.close()
    assert inter == solo(gpt, INTER, INTER_BUDGET) and hog == solo(gpt, HOG, HOG_BUDGET)
    assert [type(f).__name__ for f in filler] == ["list", "QueueFullError"]  # the interactive arrival displaced one
    stats = batcher.scheduler.stats()
    assert stats["deadline_misses_queued"] == 1 and stats["preemptions"] == stats["resumes"] >= 1
    assert leaks(engine) == (0, 0, 0)
