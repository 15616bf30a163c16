"""SLO-aware admission scheduling for the port's batchers.

Port of ``unionml_tpu/serving/scheduler.py`` (the policy layer between the
``/generate`` route and :class:`~unionml_tpu_torch.serving.continuous.DecodeEngine`):

- **Priority classes.** ``interactive`` (0), ``standard`` (1), ``batch`` (2);
  the queue pops in class order.
- **Aging.** A queued request's effective class improves one level per
  ``aging_s`` waited; within a class, earliest deadline first, then arrival.
- **Bounded queue and shedding.** At ``max_queue`` a submit either displaces
  the worst queued request (when its class is strictly better; the displaced
  one fails with :class:`QueueFullError`) or is itself shed.
- **Deadlines.** ``deadline_ms`` is a wall budget from arrival to completion.
  A submit whose deadline is already below the queue-wait EMA sheds with
  :class:`DeadlineInfeasibleError`; one that expires queued or running fails
  with :class:`DeadlineExceededError`.
- **Preempt-to-prefix-cache.** The batcher checkpoints the worst running
  victim (:meth:`DecodeEngine.preempt`) for a strictly higher class and
  re-queues it through :meth:`SLOScheduler.requeue`.

Pure host code: it never touches the engine. ``SchedulerConfig(fifo=True)``
is the plain arrival-order queue (no priorities, no preemption). Every method
that reads the clock takes ``now=``. With ``telemetry=``, each admission
records its queue wait (the class's histogram and the trace's ``queue_wait``
span) outside the scheduler's lock.
"""

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "PRIORITY_CLASSES",
    "DeadlineExceededError",
    "DeadlineInfeasibleError",
    "QueueFullError",
    "SchedulerConfig",
    "SchedulingError",
    "SLOScheduler",
    "Ticket",
    "parse_priority",
]

#: priority class name -> numeric class (lower = more urgent)
PRIORITY_CLASSES: Dict[str, int] = {"interactive": 0, "standard": 1, "batch": 2}
_CLASS_NAMES = {v: k for k, v in PRIORITY_CLASSES.items()}
DEFAULT_PRIORITY = PRIORITY_CLASSES["standard"]


def parse_priority(value: Any) -> int:
    """Normalize a request's priority field: a class name
    (``"interactive"``/``"standard"``/``"batch"``) or its numeric class.
    Raises ``ValueError`` for anything else (the route maps it to HTTP 400)."""
    if isinstance(value, str):
        try:
            return PRIORITY_CLASSES[value]
        except KeyError:
            raise ValueError(
                f"unknown priority {value!r}; expected one of {sorted(PRIORITY_CLASSES)}"
            ) from None
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"priority must be a class name or integer, got {value!r}")
    if value not in _CLASS_NAMES:
        raise ValueError(f"priority must be in {sorted(_CLASS_NAMES)}, got {value}")
    return value


def class_name(priority: int) -> str:
    """Human/stats name for a numeric priority class."""
    return _CLASS_NAMES.get(priority, str(priority))


class SchedulingError(RuntimeError):
    """Base of every structured scheduling rejection.

    ``reason`` is a machine-readable slug the HTTP layer forwards verbatim;
    ``retry_after_s`` (when set) becomes the ``Retry-After`` response header.
    """

    reason = "scheduling"

    def __init__(self, message: str, *, retry_after_s: Optional[float] = None) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s


class QueueFullError(SchedulingError):
    """Shed: the bounded queue is full and the request did not outrank it (HTTP 429)."""

    reason = "queue_full"


class DeadlineInfeasibleError(SchedulingError):
    """Shed: the deadline cannot plausibly be met given current queueing (HTTP 503)."""

    reason = "deadline_infeasible"


class DeadlineExceededError(SchedulingError):
    """The deadline passed while the request was queued or running (HTTP 504)."""

    reason = "deadline_exceeded"


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Policy knobs for :class:`SLOScheduler`.

    :param max_queue: bound on queued (not yet admitted) requests. Submits
        against a full queue shed — the newcomer, or the worst queued request
        when the newcomer's class is strictly better.
    :param aging_s: a queued request's effective class improves one level per
        this many seconds waited (anti-starvation). ``0`` disables aging.
    :param preempt: allow preempt-to-prefix-cache when a strictly-higher-class
        request waits with no free slot (requires the engine's prefix cache).
    :param shed_infeasible: shed submits whose deadline is already smaller
        than the observed queue-wait EMA (:class:`DeadlineInfeasibleError`).
    :param retry_after_s: advisory retry delay attached to shed errors (the
        HTTP layer emits it as ``Retry-After``).
    :param fifo: degrade to pure arrival order — priorities, aging, and
        preemption are ignored (deadlines and the queue bound still apply).
        The control arm of the scheduler-vs-FIFO bench A/B.
    :param speculative_classes: request classes that decode speculatively when
        the engine supports it (:class:`~unionml_tpu_torch.serving.
        speculative.SpeculativeEngine`). Speculation is an ITL play — it spends draft
        compute to shorten per-token latency — so it defaults ON for
        ``interactive`` only: ``batch`` traffic wants plain throughput, and
        ``standard`` sits wherever the operator's bench says. A request's own
        ``sampling={"speculative": ...}`` always overrides the class default.
    """

    max_queue: int = 256
    aging_s: float = 2.0
    preempt: bool = True
    shed_infeasible: bool = True
    retry_after_s: float = 1.0
    fifo: bool = False
    speculative_classes: Tuple[str, ...] = ("interactive",)


@dataclasses.dataclass(eq=False)  # identity semantics: queue membership, not field equality
class Ticket:
    """One queued request: payload plus its SLO and bookkeeping state.

    ``sink`` is whatever completion callback the owning batcher uses (it is
    opaque to the scheduler). ``deadline`` is an absolute ``time.monotonic()``
    instant (or ``None``). ``resume`` holds a
    :class:`~unionml_tpu_torch.serving.continuous.PreemptedSlot` when the ticket is
    a preempted request waiting to re-admit; resume tickets bypass the queue
    bound (shedding one would forfeit work already paid for) and keep their
    original ``enqueued`` time so aging continues across the preemption.
    """

    prompt: Any
    budget: int
    sampling: Dict[str, Any]
    sink: Any
    priority: int = DEFAULT_PRIORITY
    deadline: Optional[float] = None
    enqueued: float = 0.0
    seq: int = -1
    resume: Optional[Any] = None
    #: set by the scheduler when a later, higher-class submit displaces this
    #: queued ticket (the owner delivers/raises it)
    shed_exc: Optional[SchedulingError] = None
    #: queue wait measured at pop time (ms), for TTFT decomposition
    queue_wait_ms: Optional[float] = None
    #: trace correlation id (set by the owning batcher; rides the ticket
    #: across preemption and salvage)
    request_id: Optional[str] = None

    def effective_priority(self, now: float, aging_s: float) -> int:
        """Class after anti-starvation aging: one level better per ``aging_s``
        waited, floored at the most urgent class."""
        if aging_s <= 0:
            return self.priority
        return max(0, self.priority - int((now - self.enqueued) / aging_s))

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class SLOScheduler:
    """Bounded multi-class request queue with aging, shedding, and deadlines.

    Thread-safe: submits arrive from asyncio handler threads while the engine
    worker pops — every mutation runs under the internal lock. The scheduler
    never touches the engine; preemption and cancellation are *decisions*
    surfaced to the owning batcher, which performs the engine work.
    """

    def __init__(self, config: Optional[SchedulerConfig] = None, *, telemetry: Optional[Any] = None) -> None:
        if config is not None and not isinstance(config, SchedulerConfig):
            raise TypeError(f"expected SchedulerConfig, got {type(config)!r}")
        self.config = config or SchedulerConfig()
        #: optional Telemetry; every record site is OUTSIDE _lock (lock-leaf)
        self._telemetry = telemetry
        #: optional zero-arg provider of the engine's block-pool occupancy
        #: (``DecodeEngine.pool_signal``). Set by the owning batcher before
        #: traffic, and invoked OUTSIDE ``_lock`` so the scheduler lock stays
        #: a leaf.
        self.pool_signal: Optional[Callable[[], Optional[Dict[str, Any]]]] = None
        self._lock = threading.Lock()
        self._queued: List[Ticket] = []  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        # lifetime counters (the /stats scheduler block) — guarded-by: _lock
        self.submitted = 0  # guarded-by: _lock
        self.admitted = 0  # guarded-by: _lock
        self.shed_queue_full = 0  # guarded-by: _lock
        self.shed_deadline_infeasible = 0  # guarded-by: _lock
        self.deadline_misses_queued = 0  # guarded-by: _lock
        self.deadline_misses_running = 0  # guarded-by: _lock
        self.preemptions = 0  # guarded-by: _lock
        self.resumes = 0  # guarded-by: _lock
        self.queue_wait_ema_ms: Optional[float] = None  # guarded-by: _lock
        # per-class queue-wait EMAs: interactive traffic should not inherit
        # batch-class waits in the infeasible-deadline estimate — guarded-by: _lock
        self.queue_wait_ema_ms_by_class: Dict[str, Optional[float]] = {
            name: None for name in PRIORITY_CLASSES
        }

    # ------------------------------------------------------------------ intake

    def make_ticket(
        self,
        prompt: Any,
        budget: int,
        sampling: Optional[Dict[str, Any]],
        sink: Any,
        *,
        priority: Any = None,
        deadline_ms: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Ticket:
        """Build (but do not queue) a ticket, validating the SLO fields.

        ``deadline_ms`` is a wall budget from *now* to completion; it must be
        a positive number. ``priority`` accepts a class name or numeric class
        (``None`` = standard).
        """
        now = time.monotonic() if now is None else now
        pr = DEFAULT_PRIORITY if priority is None else parse_priority(priority)
        deadline = None
        if deadline_ms is not None:
            if isinstance(deadline_ms, bool) or not isinstance(deadline_ms, (int, float)):
                raise ValueError(f"deadline_ms must be a number, got {deadline_ms!r}")
            if deadline_ms <= 0:
                raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
            deadline = now + float(deadline_ms) / 1e3
        return Ticket(
            prompt=prompt, budget=budget, sampling=dict(sampling or {}), sink=sink,
            priority=pr, deadline=deadline, enqueued=now,
        )

    def submit(self, ticket: Ticket, *, now: Optional[float] = None) -> Optional[Ticket]:
        """Queue a ticket, shedding on overload.

        Raises :class:`DeadlineInfeasibleError` when the observed queue-wait
        EMA already exceeds the ticket's remaining deadline, and
        :class:`QueueFullError` when the queue is at ``max_queue`` and the
        ticket does not strictly outrank the worst queued request. When it
        *does* outrank one, that request is displaced instead: it is removed,
        its ``shed_exc`` is set, and it is returned for the caller to fail —
        the scheduler never invokes sinks itself.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            self.submitted += 1
            # prefer the ticket's OWN class EMA (an interactive request should
            # not be shed because batch work waited long); fall back to the
            # global EMA until that class has observed a pop
            wait_ema = self.queue_wait_ema_ms_by_class.get(class_name(ticket.priority))
            if wait_ema is None:
                wait_ema = self.queue_wait_ema_ms
            if (
                self.config.shed_infeasible
                and ticket.deadline is not None
                and wait_ema is not None
                and wait_ema / 1e3 > ticket.deadline - now
            ):
                self.shed_deadline_infeasible += 1
                raise DeadlineInfeasibleError(
                    f"deadline {round((ticket.deadline - now) * 1e3)}ms is below the "
                    f"current queue wait (~{round(wait_ema)}ms)",
                    retry_after_s=self.config.retry_after_s,
                )
            displaced: Optional[Ticket] = None
            if len(self._queued) >= self.config.max_queue:
                displaced = self._displaceable(ticket, now)
                if displaced is None:
                    self.shed_queue_full += 1
                    raise QueueFullError(
                        f"queue full ({self.config.max_queue} requests waiting)",
                        retry_after_s=self.config.retry_after_s,
                    )
                self._queued.remove(displaced)
                displaced.shed_exc = QueueFullError(
                    "displaced by a higher-priority request under a full queue",
                    retry_after_s=self.config.retry_after_s,
                )
                self.shed_queue_full += 1
            ticket.seq = self._seq
            self._seq += 1
            self._queued.append(ticket)
            return displaced

    def requeue(self, ticket: Ticket, *, preemption: bool = True) -> None:
        """Put a preempted — or failure-salvaged, with ``preemption=False`` —
        ticket back in the queue (bypasses the bound and the infeasibility
        shed: its work is already partially paid for). Deadlines and class
        ride along unchanged, so SLO enforcement survives recovery."""
        with self._lock:
            ticket.seq = self._seq
            self._seq += 1
            ticket.queue_wait_ms = None
            self._queued.append(ticket)
            if preemption:
                self.preemptions += 1

    # ---------------------------------------------------------------- dispatch

    def _order_key(self, ticket: Ticket, now: float) -> Tuple:
        if self.config.fifo:
            return (ticket.seq,)
        return (
            ticket.effective_priority(now, self.config.aging_s),
            ticket.deadline if ticket.deadline is not None else float("inf"),
            ticket.seq,
        )

    def _displaceable(self, newcomer: Ticket, now: float) -> Optional[Ticket]:
        """Worst queued ticket a strictly-better newcomer may displace (never
        a resume ticket, never under FIFO). Strictly better means a more
        urgent EFFECTIVE class — arrival order never justifies displacing
        (that would turn the bound into a shove-the-queue race)."""
        if self.config.fifo:
            return None
        candidates = [t for t in self._queued if t.resume is None]  # graftlint: disable=data-race -- submit() is the only caller and already holds _lock
        if not candidates:
            return None
        worst = max(candidates, key=lambda t: self._order_key(t, now))
        if newcomer.effective_priority(now, self.config.aging_s) < worst.effective_priority(
            now, self.config.aging_s
        ):
            return worst
        return None

    def take_expired(self, now: Optional[float] = None) -> List[Ticket]:
        """Remove and return every queued ticket whose deadline has passed
        (the caller fails their sinks with :class:`DeadlineExceededError`)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            expired = [t for t in self._queued if t.expired(now)]
            if expired:
                self._queued = [t for t in self._queued if not t.expired(now)]
                self.deadline_misses_queued += len(expired)
            return expired

    def pop(self, max_n: int, now: Optional[float] = None) -> List[Ticket]:
        """Up to ``max_n`` tickets in scheduling order (effective class, then
        earliest deadline, then arrival; pure arrival under FIFO). Records
        each ticket's queue wait into the EMA and ``ticket.queue_wait_ms``."""
        if max_n <= 0:
            return []
        now = time.monotonic() if now is None else now
        with self._lock:
            self._queued.sort(key=lambda t: self._order_key(t, now))
            taken, self._queued = self._queued[:max_n], self._queued[max_n:]
        for ticket in taken:
            self._note_pop(ticket, now)
        return taken

    def pop_ticket(self, ticket: Ticket, now: Optional[float] = None) -> bool:
        """Remove one specific ticket (the speculative facade's turn-taking
        pop); returns False when it is no longer queued (expired/displaced)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            try:
                self._queued.remove(ticket)
            except ValueError:
                return False
        self._note_pop(ticket, now)
        return True

    def _note_pop(self, ticket: Ticket, now: float) -> None:
        """Account one admission (the ticket is already off the queue)."""
        wait_ms = max(0.0, (now - ticket.enqueued) * 1e3)
        ticket.queue_wait_ms = wait_ms
        cls = class_name(ticket.priority)
        with self._lock:
            self.queue_wait_ema_ms = (
                wait_ms
                if self.queue_wait_ema_ms is None
                else 0.8 * self.queue_wait_ema_ms + 0.2 * wait_ms
            )
            prev = self.queue_wait_ema_ms_by_class.get(cls)
            self.queue_wait_ema_ms_by_class[cls] = (
                wait_ms if prev is None else 0.8 * prev + 0.2 * wait_ms
            )
            self.admitted += 1
            if ticket.resume is not None:
                self.resumes += 1
        if self._telemetry is not None:  # outside _lock: telemetry is lock-leaf
            self._telemetry.set_class(ticket.request_id, cls)
            self._telemetry.queue_wait_ms.observe(wait_ms, cls)
            self._telemetry.span(ticket.request_id, "queue_wait", dur_ms=round(wait_ms, 3), cls=cls,
                                 resume=ticket.resume is not None)
            if ticket.resume is not None:
                self._telemetry.resumes_total.inc()

    def peek(self, now: Optional[float] = None) -> Optional[Ticket]:
        """The ticket :meth:`pop` would return first (not removed)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not self._queued:
                return None
            return min(self._queued, key=lambda t: self._order_key(t, now))

    def remove(self, ticket: Ticket) -> bool:
        """Drop one queued ticket (owner-side cancel); False when not queued."""
        with self._lock:
            try:
                self._queued.remove(ticket)
                return True
            except ValueError:
                return False

    def best_waiting_priority(self) -> Optional[int]:
        """The most urgent STATIC class currently queued (``None`` when empty,
        or under FIFO). Static — not aged — on purpose: aging exists to
        guarantee queue admission, not to let batch work preempt runners."""
        if self.config.fifo:
            return None
        with self._lock:
            if not self._queued:
                return None
            return min(t.priority for t in self._queued)

    def note_deadline_miss_running(self) -> None:
        """Count one running request cancelled at its deadline (batcher-side)."""
        with self._lock:
            self.deadline_misses_running += 1

    def drain(self) -> List[Ticket]:
        """Remove and return every queued ticket (batcher close)."""
        with self._lock:
            drained, self._queued = self._queued, []
            return drained

    # ------------------------------------------------------------------- stats

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queued)

    def load_signal(self) -> Dict[str, Any]:
        """The load signal the fleet's router (``EngineFleet._candidates``)
        and the simulator's autoscaler score from: queue depth plus the
        global and per-class queue-wait EMAs
        (taken in one lock hold so the numbers are mutually consistent),
        and — when the owning batcher wired a paged engine's
        ``pool_signal`` provider — the block-pool occupancy under
        ``"pool"`` (``num_blocks`` plus ``free``/``live``/``cached``/
        ``pinned`` fractions, ``available_blocks``, and the scalar
        ``pressure``). The provider is called
        BEFORE the scheduler lock is taken (both locks stay leaves). Cheap
        enough to call on every route decision (host ints/floats only)."""
        provider = self.pool_signal
        pool = provider() if provider is not None else None
        with self._lock:
            return {
                "depth": len(self._queued),
                "queue_wait_ema_ms": self.queue_wait_ema_ms,
                "per_class": dict(self.queue_wait_ema_ms_by_class),
                "pool": pool,
            }

    def stats(self) -> Dict[str, Any]:
        """The ``GET /stats`` → ``generation.scheduler`` block: per-class
        queue depth, queue-wait EMA, shed / preemption / deadline-miss
        counters, the configured policy, and (paged engines) the same
        ``pool`` occupancy block :meth:`load_signal` carries."""
        provider = self.pool_signal
        pool = provider() if provider is not None else None
        with self._lock:
            depth_by_class = {name: 0 for name in PRIORITY_CLASSES}
            for ticket in self._queued:
                depth_by_class[class_name(ticket.priority)] += 1
            return {
                "policy": "fifo" if self.config.fifo else "priority",
                "max_queue": self.config.max_queue,
                "depth": len(self._queued),
                "depth_by_class": depth_by_class,
                "queue_wait_ema_ms": None
                if self.queue_wait_ema_ms is None
                else round(self.queue_wait_ema_ms, 3),
                "per_class": {
                    name: None if ema is None else round(ema, 3)
                    for name, ema in self.queue_wait_ema_ms_by_class.items()
                },
                "submitted": self.submitted,
                "admitted": self.admitted,
                "shed_queue_full": self.shed_queue_full,
                "shed_deadline_infeasible": self.shed_deadline_infeasible,
                "deadline_misses_queued": self.deadline_misses_queued,
                "deadline_misses_running": self.deadline_misses_running,
                "preemptions": self.preemptions,
                "resumes": self.resumes,
                "pool": pool,
            }
