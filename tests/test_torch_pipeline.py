"""Depth-1 dispatch-ahead in the port's ``DecodeEngine`` (``pipeline=True``).

Ports ``tests/unit/test_pipeline_parity.py:118-250, :381`` (without the
prefix cache, which the port does not have yet) on the tiny f32 GPT:

1. parity: a pipelined engine emits exactly the streams of an unpipelined one
   under one fixed call script (admissions, a chunked prefill, a cancel
   racing the burst in flight, a replay into the freed slot), greedy and
   fixed-seed sampled, and with lookahead bursts; greedy survivors equal each
   request decoded alone;
2. fencing: ``cancel`` and ``abort_all`` with a burst in flight, and a
   chunked prefill cancelled beside a neighbour's burst in flight, leave the
   survivors exact and credit no stale token to a slot's next occupant; eos
   retirement stops where decoding alone stops;
3. no host data in a steady-state step: a dispatch mode in the spirit of
   ``_graphs._HostSyncCheck`` fails on any tensor made from host data
   (``lift_fresh``) and any op that syncs the host, around ``step()`` at
   lookahead 1 and 4 and on the sampling path (the engine's one designed
   sync, the fetch, reads the burst's host copies through numpy);
4. ``pipeline_stats``' shape and counters;
5. a stream abandoned while ``ContinuousBatcher`` delivers a burst's events
   leaves every other stream in order.
"""

import numpy as np
import pytest
import torch

from unionml_tpu_torch import _graphs
from unionml_tpu_torch.models import GPTConfig, init_gpt
from unionml_tpu_torch.serving.continuous import ContinuousBatcher, DecodeEngine
from unionml_tpu_torch.serving.scheduler import Ticket


@pytest.fixture(scope="module")
def model():
    return init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0), std=0.3, device="cpu")


def make_engine(model, *, pipeline, **kw):
    kw = dict(dict(num_slots=4, max_len=64, prefill_buckets=(4, 8, 16), prefill_chunk=4, block_size=4, seed=7),
              **kw)
    return DecodeEngine(model, pipeline=pipeline, device="cpu", **kw)


def solo(model, prompt, n, **kw):
    return make_engine(model, pipeline=False, num_slots=1, prefill_chunk=None, **kw).generate(prompt, n)


class Script:
    """A scripted caller logging every applied token per request; it drains
    ``take_pending_events`` under the OLD slot mapping before re-keying."""

    def __init__(self, engine):
        self.engine, self.streams, self.req_of_slot = engine, {}, {}

    def _pump(self, events):
        for ev in events:
            if ev.emit:
                self.streams[self.req_of_slot[ev.slot]].append(ev.token)

    def admit(self, req_id, prompt, budget, **sampling):
        (slot,) = self.engine.admit_many([(prompt, budget, sampling)])
        self._pump(self.engine.take_pending_events())
        self.req_of_slot[slot] = req_id
        self.streams.setdefault(req_id, [])
        return slot

    def step(self, lookahead=1):
        self._pump(self.engine.step(lookahead))

    def cancel(self, slot):
        self.engine.cancel(slot)
        self._pump(self.engine.take_pending_events())

    def drain(self, lookahead=1):
        eng = self.engine
        while eng.num_active or eng.has_pending_prefill or eng.has_pending_events:
            self.step(lookahead)
        return self.streams


SHARED = list(range(1, 11))


def mixed_schedule(engine, sampled):
    """A fixed tick script (no feedback from engine state): full prefills, a
    chunked prefill, a cancel racing the burst in flight, an exact replay
    into the freed slot. Returns (streams, cancelled request)."""
    drv = Script(engine)
    kw = dict(temperature=0.9, top_k=3) if sampled else {}
    drv.admit(0, SHARED + [20, 21], 6, **kw)
    drv.step()
    drv.step()
    drv.admit(1, SHARED + [30], 5, **kw)
    drv.step()
    victim = drv.admit(2, [40, 41, 42], 12, **kw)
    drv.step()
    drv.admit(3, list(range(50, 64)), 4, **kw)  # 14 tokens: chunked prefill
    drv.step()
    drv.step()
    drv.cancel(victim)
    drv.admit(4, SHARED + [20, 21], 6, **kw)
    drv.drain()
    return drv.streams, 2


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_mixed_schedule_parity(model, sampled):
    on, cancelled = mixed_schedule(make_engine(model, pipeline=True), sampled)
    off, _ = mixed_schedule(make_engine(model, pipeline=False), sampled)
    survivors = [r for r in on if r != cancelled]
    assert {r: on[r] for r in survivors} == {r: off[r] for r in survivors}
    n = min(len(on[cancelled]), len(off[cancelled]))  # what was delivered must agree
    assert on[cancelled][:n] == off[cancelled][:n]
    if not sampled:
        expected = {0: solo(model, SHARED + [20, 21], 6), 1: solo(model, SHARED + [30], 5),
                    3: solo(model, list(range(50, 64)), 4), 4: solo(model, SHARED + [20, 21], 6)}
        assert {r: on[r] for r in expected} == expected


def test_lookahead_burst_pipeline_parity(model):
    requests = [([3, 1, 4, 1, 5], 9), ([2, 7], 6), ([1, 8, 2, 8], 4)]

    def run(pipeline):
        drv = Script(make_engine(model, pipeline=pipeline, num_slots=3, prefill_buckets=(8,), prefill_chunk=None))
        for i, (p, n) in enumerate(requests):
            drv.admit(i, p, n)
        return drv.drain(lookahead=4)

    assert run(True) == run(False)


def test_eos_retirement_pipelined(model):
    prompt = [3, 1, 4, 1, 5]
    expected = solo(model, prompt, 6)
    eos = expected[2]
    engine = make_engine(model, pipeline=True, num_slots=1, prefill_buckets=(8,), prefill_chunk=None,
                         eos_token_id=eos)
    assert engine.generate(prompt, 6) == expected[: expected.index(eos)]
    assert engine.num_active == 0
    assert engine.generate([9, 9, 1, 2], 5) == solo(model, [9, 9, 1, 2], 5, eos_token_id=eos)


@pytest.mark.parametrize("race", ["cancel", "abort_all", "cancel_chunked"])
def test_fencing_a_burst_in_flight(model, race):
    engine = make_engine(model, pipeline=True, num_slots=2, prefill_buckets=(8, 16))
    drv = Script(engine)
    drv.admit(0, [3, 1, 4, 1, 5], 8)
    if race == "cancel_chunked":
        drv.step()
        (slot,) = engine.admit_many([(SHARED, 5)])  # reserved: a chunked prefill
        drv.step()  # one chunk while a decode burst is in flight
        assert engine.has_pending_prefill and engine._inflight is not None
        engine.cancel(slot)
        drv._pump(engine.take_pending_events())
        assert not engine.has_pending_prefill and slot in engine.free_slots
        assert drv.drain()[0] == solo(model, [3, 1, 4, 1, 5], 8)
        return
    victim = drv.admit(1, [2, 7], 40)
    drv.step()
    drv.step()
    assert engine._inflight is not None  # a burst really is in flight
    if race == "abort_all":
        engine.abort_all()
        assert engine.num_active == 0 and engine._inflight is None and not engine.has_pending_events
        assert engine.available_blocks() == engine._allocator.num_blocks
        assert engine.generate([3, 1, 4], 5) == solo(model, [3, 1, 4], 5)
        return
    drv.cancel(victim)
    assert engine.free_slots == [victim]
    assert drv.admit(2, [9, 9, 1, 2], 5) == victim
    streams = drv.drain()
    assert streams[0] == solo(model, [3, 1, 4, 1, 5], 8)
    assert streams[2] == solo(model, [9, 9, 1, 2], 5)
    assert streams[1] == solo(model, [2, 7], 40)[: len(streams[1])]  # nothing foreign


class _Sink:
    """A batcher sink whose consumer abandons the stream after ``keep``
    tokens, as ``ContinuousBatcher.stream`` does on exit."""

    def __init__(self, keep=None):
        self.tokens, self.keep, self.cancelled, self.ended = [], keep, False, None

    def emit(self, token):
        self.tokens.append(token)
        self.cancelled = self.keep is not None and len(self.tokens) >= self.keep

    def finish(self):
        self.ended = "finish"

    def fail(self, exc):
        self.ended = exc


@pytest.mark.parametrize("lookahead", [1, 2])
def test_stream_abandoned_during_delivery_keeps_other_streams_in_order(model, lookahead):
    """The lowest slot's stream is abandoned while a burst is in flight: its
    cancel fetches that burst, whose tokens must reach the higher slots only
    after the events being delivered (pipelined == unpipelined == alone)."""
    requests = [([3, 1, 4, 1, 5], 12), ([2, 7], 9), ([1, 8, 2, 8], 10), ([9, 9, 1], 8)]

    def run(pipeline):
        engine = make_engine(model, pipeline=pipeline, prefill_buckets=(8,), prefill_chunk=None)
        batcher = ContinuousBatcher(engine, lookahead=lookahead, device="cpu")
        sinks = [_Sink(keep=3)] + [_Sink() for _ in requests[1:]]
        for (prompt, n), sink in zip(requests, sinks):
            batcher._queue.submit(Ticket(prompt=np.asarray(prompt), budget=n, sampling={}, sink=sink))
        batcher._closed = True
        batcher._run()  # the worker's loop on this thread: one fixed schedule
        assert engine.num_active == 0 and engine.available_blocks() == engine._allocator.num_blocks
        return [(s.tokens, s.ended) for s in sinks]

    on, off = run(True), run(False)
    assert on == off and on[0] == (off[0][0], None) and len(on[0][0]) == 3
    assert [tokens for tokens, _ in on[1:]] == [solo(model, p, n) for p, n in requests[1:]]


class _NoHostData(_graphs._HostSyncCheck):
    """``_HostSyncCheck``, and no tensor made from host data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in ("lift_fresh", "lift_fresh_copy"):
            raise _graphs.CaptureError(f"{func} makes a tensor from host data")
        return super().__torch_dispatch__(func, types, args, kwargs)


@pytest.mark.parametrize("lookahead,sampling", [(1, None), (4, None), (1, dict(temperature=0.7, top_k=5, top_p=0.9))],
                         ids=["greedy", "burst4", "sampled"])
def test_steady_state_step_makes_no_tensor_from_host_data(model, lookahead, sampling):
    engine = make_engine(model, pipeline=True, num_slots=2, prefill_buckets=(8,), prefill_chunk=None)
    engine.admit_many([([3, 1, 4, 1, 5], 40, sampling or {}), ([2, 7], 40, sampling or {})])
    engine.step(lookahead)
    engine.step(lookahead)
    with _NoHostData():
        for _ in range(3):
            assert engine.step(lookahead)


def test_pipeline_stats_shape_and_counters(model):
    engine = make_engine(model, pipeline=True, num_slots=2, prefill_buckets=(8,), prefill_chunk=None)
    engine.generate([3, 1, 4], 5)
    stats = engine.pipeline_stats()
    assert set(stats) == {"depth", "inflight", "step_dispatches", "idle_dispatches", "ema_host_gap_ms",
                          "ema_fetch_block_ms", "graphs"}
    assert stats["depth"] == 1 and stats["step_dispatches"] >= 5 and stats["graphs"] == 0  # no graphs on the CPU
    off = make_engine(model, pipeline=False, num_slots=2, prefill_buckets=(8,), prefill_chunk=None)
    off.generate([3, 1, 4], 5)
    assert off.pipeline_stats()["depth"] == 0
    # unpipelined dispatches find an empty device queue; pipelined ones do not
    assert off.idle_dispatches > 0 and engine.idle_dispatches < off.idle_dispatches
