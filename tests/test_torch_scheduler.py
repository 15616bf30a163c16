"""Port parity: the SLO scheduler (``serving/scheduler.py``) against the JAX package's.

Both schedulers are pure host code. The cases of ``tests/unit/test_scheduler.py:65-194``
(class order, aging, FIFO, the bound's shed and displacement, infeasible
deadlines, expiry, the pool block) run against the port with the JAX tests'
assertions, and seeded random sequences of ``submit``/``pop``/``requeue``/
``take_expired``/``remove``/``pop_ticket``/``peek`` under an injected ``now``
drive both schedulers side by side: the same pop order, the same sheds and
displacements (exception types and messages), and equal ``stats()`` and
``load_signal()`` after every operation.
"""

import numpy as np
import pytest

from unionml_tpu.serving import scheduler as jsched
from unionml_tpu_torch.serving import scheduler as tsched
from unionml_tpu_torch.serving.scheduler import (
    DeadlineInfeasibleError,
    QueueFullError,
    SchedulerConfig,
    SLOScheduler,
    parse_priority,
)

NOW = 1000.0


class _NullSink:
    cancelled = False

    def __init__(self):
        self.failures = []

    def fail(self, exc):
        self.failures.append(exc)


def _ticket(sched, priority="standard", deadline_ms=None, now=NOW, budget=4):
    return sched.make_ticket(np.asarray([1, 2, 3], dtype=np.int32), budget, {}, _NullSink(), priority=priority,
                             deadline_ms=deadline_ms, now=now)


def test_parse_priority_names_and_ints():
    """``test_scheduler.py::test_parse_priority_names_and_ints``."""
    assert [parse_priority(p) for p in ("interactive", "standard", "batch", 2)] == [0, 1, 2, 2]
    for bad in ("urgent", 7, -1, True, 1.5, None):
        with pytest.raises(ValueError) as port_err:
            parse_priority(bad)
        with pytest.raises(ValueError) as jax_err:
            jsched.parse_priority(bad)
        assert str(port_err.value) == str(jax_err.value)
    assert tsched.PRIORITY_CLASSES == jsched.PRIORITY_CLASSES
    assert tsched.class_name(1) == jsched.class_name(1) == "standard"
    assert SchedulerConfig() == SchedulerConfig(**vars(jsched.SchedulerConfig()))


def test_pop_orders_by_class_then_deadline_then_arrival():
    """``test_scheduler.py::test_pop_orders_by_class_then_deadline_then_arrival``."""
    sched = SLOScheduler(SchedulerConfig(aging_s=0))
    tickets = [_ticket(sched, "batch"), _ticket(sched, "standard", deadline_ms=60_000),
               _ticket(sched, "standard", deadline_ms=5_000), _ticket(sched, "interactive")]
    for t in tickets:
        sched.submit(t, now=NOW)
    order = sched.pop(10, now=NOW + 0.25)
    assert order == [tickets[3], tickets[2], tickets[1], tickets[0]]
    assert all(t.queue_wait_ms == 250.0 for t in order)
    assert sched.stats()["admitted"] == 4 and sched.depth == 0


def test_fifo_mode_ignores_priorities():
    """``test_scheduler.py::test_fifo_mode_ignores_priorities``."""
    sched = SLOScheduler(SchedulerConfig(fifo=True))
    first, second = _ticket(sched, "batch"), _ticket(sched, "interactive")
    sched.submit(first, now=NOW)
    sched.submit(second, now=NOW)
    assert sched.best_waiting_priority() is None  # FIFO never drives preemption
    assert sched.pop(2, now=NOW) == [first, second]


@pytest.mark.parametrize("age_s, want", [(1.5, ["fresh_std", "old_batch", "fresh_batch"]),
                                         (5.0, ["old_batch", "fresh_std", "fresh_batch"])],
                         ids=["one_level", "to_the_top"])
def test_aging_promotes_starved_batch_work(age_s, want):
    """``test_scheduler.py::test_aging_promotes_starved_batch_work``: one level
    per ``aging_s`` waited, floored at the top class; the tie goes to arrival."""
    sched = SLOScheduler(SchedulerConfig(aging_s=1.0))
    named = {"old_batch": _ticket(sched, "batch", now=NOW - age_s), "fresh_std": _ticket(sched, "standard"),
             "fresh_batch": _ticket(sched, "batch")}
    for name in ("fresh_std", "fresh_batch", "old_batch"):
        sched.submit(named[name], now=NOW)
    order = sched.pop(3, now=NOW)
    assert [next(k for k, v in named.items() if v is t) for t in order] == want


def test_bounded_queue_sheds_new_request():
    """``test_scheduler.py::test_bounded_queue_sheds_new_request``."""
    sched = SLOScheduler(SchedulerConfig(max_queue=2, retry_after_s=3.0))
    sched.submit(_ticket(sched))
    sched.submit(_ticket(sched))
    with pytest.raises(QueueFullError) as err:
        sched.submit(_ticket(sched))
    assert err.value.reason == "queue_full" and err.value.retry_after_s == 3.0
    assert sched.stats()["shed_queue_full"] == 1 and sched.depth == 2


def test_bounded_queue_displaces_worse_for_strictly_higher_class():
    """``test_scheduler.py::test_bounded_queue_displaces_worse_for_strictly_higher_class``;
    a resume ticket is never displaced."""
    sched = SLOScheduler(SchedulerConfig(max_queue=2))
    keep, worst = _ticket(sched, "standard"), _ticket(sched, "batch")
    sched.submit(keep, now=NOW)
    sched.submit(worst, now=NOW)
    newcomer = _ticket(sched, "interactive")
    displaced = sched.submit(newcomer, now=NOW)
    assert displaced is worst and isinstance(displaced.shed_exc, QueueFullError)
    assert sched.pop(10, now=NOW) == [newcomer, keep]
    for _ in range(2):
        resumed = _ticket(sched, "batch")
        resumed.resume = object()
        sched.requeue(resumed)
    with pytest.raises(QueueFullError):
        sched.submit(_ticket(sched, "interactive"), now=NOW)  # resumes are never displaced
    assert sched.stats()["preemptions"] == 2


def test_deadline_infeasible_sheds_at_submit():
    """``test_scheduler.py::test_deadline_infeasible_sheds_at_submit``."""
    sched = SLOScheduler(SchedulerConfig())
    with sched._lock:
        sched.queue_wait_ema_ms = 5_000.0
    with pytest.raises(DeadlineInfeasibleError) as err:
        sched.submit(_ticket(sched, "interactive", deadline_ms=100), now=NOW)
    assert err.value.reason == "deadline_infeasible" and sched.stats()["shed_deadline_infeasible"] == 1
    assert sched.submit(_ticket(sched, "interactive", deadline_ms=60_000), now=NOW) is None
    for bad in (0, "soon", True):
        with pytest.raises(ValueError):
            _ticket(sched, deadline_ms=bad)


def test_take_expired_removes_and_counts():
    """``test_scheduler.py::test_take_expired_removes_and_counts``."""
    sched = SLOScheduler(SchedulerConfig())
    gone = _ticket(sched, deadline_ms=10, now=NOW - 1.0)
    live = _ticket(sched, deadline_ms=60_000)
    sched.submit(gone, now=NOW - 1.0)
    sched.submit(live, now=NOW)
    assert sched.take_expired(NOW) == [gone]
    assert sched.stats()["deadline_misses_queued"] == 1
    assert sched.pop(10, now=NOW) == [live]


def test_load_signal_and_stats_carry_the_pool_block():
    """``test_scheduler.py::test_load_signal_and_stats_carry_the_pool_block``."""
    sched = SLOScheduler(SchedulerConfig())
    assert sched.load_signal()["pool"] is None and sched.stats()["pool"] is None
    occupancy = {"num_blocks": 64, "free_frac": 0.5, "live_frac": 0.25, "cached_frac": 0.25,
                 "pinned_frac": 0.0, "available_blocks": 48, "pressure": 0.25}
    sched.pool_signal = lambda: occupancy
    signal = sched.load_signal()
    assert signal["pool"] == occupancy and set(signal) == {"depth", "queue_wait_ema_ms", "per_class", "pool"}
    assert sched.stats()["pool"] == occupancy


# ----------------------------------------------------- random sequences vs JAX


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:
        return (type(exc).__name__, str(exc), getattr(exc, "retry_after_s", None))


@pytest.mark.parametrize("seed", range(12))
def test_random_sequences_match_jax(seed):
    """The port's scheduler and JAX's through the same seeded operations on a
    virtual clock: every operation's outcome (tickets by position, shed
    exceptions, displaced tickets and their errors, queue waits) and the
    stats and load signal after it are equal."""
    rng = np.random.default_rng(seed)
    kw = dict(max_queue=int(rng.integers(1, 6)), aging_s=float(rng.choice([0.0, 0.5, 2.0])),
              fifo=bool(seed % 4 == 3), shed_infeasible=bool(rng.random() < 0.8),
              retry_after_s=float(rng.choice([0.5, 1.0])))
    scheds = [SLOScheduler(SchedulerConfig(**kw)), jsched.SLOScheduler(jsched.SchedulerConfig(**kw))]
    pool = {"num_blocks": 8, "free_frac": 1.0, "live_frac": 0.0, "cached_frac": 0.0, "pinned_frac": 0.0,
            "available_blocks": 8, "pressure": 0.0}
    for s in scheds:
        s.pool_signal = lambda: pool
    tickets = [[], []]  # every ticket made, by position, per scheduler
    popped: list = []  # positions handed out and not requeued
    now = NOW

    def pos(side, t):
        return None if t is None else next(i for i, x in enumerate(tickets[side]) if x is t)

    for _ in range(60):
        now += float(rng.uniform(0.0, 0.6))
        op = str(rng.choice(["submit", "submit", "submit", "pop", "requeue", "expire", "remove", "pop_ticket",
                             "peek", "miss"]))
        outcomes = []
        if op == "submit":
            priority = ["interactive", "standard", "batch", 1][int(rng.integers(0, 4))]
            deadline = None if rng.random() < 0.4 else float(rng.uniform(50, 3000))
            for side, s in enumerate(scheds):
                t = s.make_ticket(np.asarray([1, 2], np.int32), 4, {}, None, priority=priority,
                                  deadline_ms=deadline, now=now)
                tickets[side].append(t)
                out = _outcome(lambda: s.submit(t, now=now))
                if out[0] == "ok" and out[1] is not None:
                    out = ("displaced", pos(side, out[1]), str(out[1].shed_exc))
                outcomes.append(out)
        elif op == "pop":
            n = int(rng.integers(0, 4))
            for side, s in enumerate(scheds):
                got = s.pop(n, now=now)
                outcomes.append([(pos(side, t), t.queue_wait_ms) for t in got])
            popped.extend(p for p, _ in outcomes[0])
        elif op == "requeue" and popped:
            p = popped.pop(int(rng.integers(0, len(popped))))
            preemption = bool(rng.random() < 0.5)
            for side, s in enumerate(scheds):
                if preemption:
                    tickets[side][p].resume = "checkpoint"
                s.requeue(tickets[side][p], preemption=preemption)
        elif op == "expire":
            for side, s in enumerate(scheds):
                outcomes.append([pos(side, t) for t in s.take_expired(now)])
        elif op in ("remove", "pop_ticket") and tickets[0]:
            p = int(rng.integers(0, len(tickets[0])))
            for side, s in enumerate(scheds):
                t = tickets[side][p]
                outcomes.append((s.remove(t),) if op == "remove" else (s.pop_ticket(t, now=now), t.queue_wait_ms))
        elif op == "peek":
            for side, s in enumerate(scheds):
                outcomes.append((pos(side, s.peek(now=now)), s.best_waiting_priority()))
        elif op == "miss":
            for s in scheds:
                s.note_deadline_miss_running()
        if outcomes:
            assert outcomes[0] == outcomes[1], (op, outcomes)
        assert scheds[0].stats() == scheds[1].stats(), op
        assert scheds[0].load_signal() == scheds[1].load_signal(), op
        assert scheds[0].depth == scheds[1].depth


def test_concurrent_submits_and_pops_keep_the_counters_whole():
    """Submitters (the event loop's side) and poppers (the worker's) on one
    scheduler from 12 threads with a 1 µs switch interval: every submit is
    popped, displaced, shed or still queued, and the counters say so."""
    import sys
    import threading

    sched = SLOScheduler(SchedulerConfig(max_queue=8))
    popped, errors = [], []

    def submitter(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            try:
                sched.submit(_ticket(sched, ["interactive", "standard", "batch"][int(rng.integers(0, 3))]))
            except QueueFullError:
                pass
            except Exception as exc:  # any other failure fails the test below
                errors.append(exc)

    def popper():
        for _ in range(400):
            popped.extend(sched.pop(2))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(8)]
        threads += [threading.Thread(target=popper) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors
    finally:
        sys.setswitchinterval(interval)
    stats = sched.stats()
    assert stats["submitted"] == 8 * 300 and stats["admitted"] == len(popped) == len(set(map(id, popped)))
    assert stats["submitted"] == stats["admitted"] + stats["depth"] + stats["shed_queue_full"]
