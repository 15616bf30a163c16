"""Deterministic discrete-event fleet simulator driving the REAL policies.

The port's copy of ``unionml_tpu/sim/core.py``, over the port's policies.
The point of this simulator is that it contains almost no policy code of
its own. Routing is the production :class:`~unionml_tpu_torch.serving.fleet.
Router` (prefix-affinity scoring, session stickiness, LRU digest index);
queueing, aging, shedding, displacement, and deadline enforcement are the
production :class:`~unionml_tpu_torch.serving.scheduler.SLOScheduler` (every
method takes ``now=``, so the virtual clock threads straight through);
paged-KV admission is the production ``block_demand`` arithmetic from
``continuous.py``; SLO scoring is the production
:class:`~unionml_tpu_torch.serving.slo.SLOTracker`. What the simulator adds is
only what hardware would: a virtual clock, slot occupancy, a block-pool
ledger per replica (live/cached/pinned counters shaped exactly like
``DecodeEngine.pool_signal``), and a :class:`~unionml_tpu_torch.sim.cost_model.
CostModel` that prices prefill/decode time. Capacity answers therefore
come from the code that will serve the traffic, at ~10⁵–10⁶ requests per
CPU-minute, with bit-for-bit determinism (no wall clock, no unseeded
randomness anywhere).

Two entry points:

- :class:`FleetSimulator` — synthetic workloads (``sim.traces``),
  optional replica-death schedules, optional in-loop
  :class:`~unionml_tpu_torch.sim.autoscaler.Autoscaler` (scale-up warms the new
  replica's router index from ``Router.hot_digests``).
- :func:`replay_journal` — derive every policy counter and the SLO
  good/total ledger from a recorded journal ALONE, for bit-for-bit
  validation against the live process that wrote it (the golden replay
  test).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from unionml_tpu_torch.serving.fleet import FleetConfig, Router
from unionml_tpu_torch.serving.scheduler import (
    PRIORITY_CLASSES,
    SchedulerConfig,
    SchedulingError,
    SLOScheduler,
    Ticket,
    class_name,
)
from unionml_tpu_torch.serving.slo import SLOConfig, SLOTracker
from unionml_tpu_torch.sim.autoscaler import Autoscaler, AutoscalerConfig
from unionml_tpu_torch.sim.cost_model import CostModel
from unionml_tpu_torch.sim.journal import JournalRecord
from unionml_tpu_torch.sim.traces import ReplicaDeath, SimRequest

__all__ = ["FleetSimulator", "SimConfig", "replay_journal"]


@dataclass(frozen=True)
class SimConfig:
    """Fleet shape + policies for one :class:`FleetSimulator` run.

    ``num_replicas`` is the STARTING active count; the router (and the
    autoscaler's headroom) is sized to ``max_replicas``. Per-replica
    capacity mirrors a paged :class:`~unionml_tpu_torch.serving.continuous.
    DecodeEngine`: ``num_slots`` decode slots over a pool of
    ``num_blocks`` KV blocks of ``block_size`` tokens.
    """

    num_replicas: int = 2
    max_replicas: Optional[int] = None  # default: num_replicas (no headroom)
    num_slots: int = 4
    num_blocks: int = 512
    block_size: int = 4
    max_len: int = 512
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    cost: CostModel = field(default_factory=CostModel)
    slo: SLOConfig = field(default_factory=SLOConfig)
    autoscaler: Optional[AutoscalerConfig] = None
    autoscale_interval_s: float = 5.0
    deaths: Tuple[ReplicaDeath, ...] = ()

    def __post_init__(self) -> None:
        if self.num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {self.num_replicas}")
        ceiling = self.num_replicas if self.max_replicas is None else self.max_replicas
        if ceiling < self.num_replicas:
            raise ValueError(
                f"max_replicas ({ceiling}) must be >= num_replicas ({self.num_replicas})"
            )
        if self.num_slots < 1 or self.num_blocks < 1:
            raise ValueError("num_slots and num_blocks must be >= 1")

    @property
    def replica_ceiling(self) -> int:
        return self.num_replicas if self.max_replicas is None else self.max_replicas


class _Entry:
    """One in-flight request's simulator-side state (the ticket's sink)."""

    __slots__ = (
        "request", "ticket", "replica", "demand", "admit_t", "first_token_t",
        "finish_t", "epoch", "remaining_ms", "done",
    )

    def __init__(self, request: SimRequest, ticket: Ticket) -> None:
        self.request = request
        self.ticket = ticket
        self.replica: Optional[int] = None
        self.demand = 0
        self.admit_t = 0.0
        self.first_token_t: Optional[float] = None
        self.finish_t = 0.0
        self.epoch = 0  # bumped on preempt/cancel to invalidate heap events
        self.remaining_ms: Optional[float] = None  # set when preempted
        self.done = False


class _SimReplica:
    """One replica: a REAL scheduler plus the hardware-shaped ledgers the
    policies read (slots, block pool split live/cached/pinned)."""

    __slots__ = (
        "index", "scheduler", "running", "resume_queue", "num_slots",
        "num_blocks", "live_blocks", "cached_blocks", "pinned_blocks",
        "active", "draining", "_pool_key", "_pool_cache",
    )

    def __init__(self, index: int, config: SimConfig) -> None:
        self.index = index
        self.scheduler = SLOScheduler(config.scheduler)
        self.scheduler.pool_signal = self.pool_signal
        self.running: List[_Entry] = []
        # queued preempted tickets, admission order (their checkpoints pin
        # blocks on THIS replica — tracked for the idle-pool deadlock break)
        self.resume_queue: List[Any] = []
        self.num_slots = config.num_slots
        self.num_blocks = config.num_blocks
        self.live_blocks = 0
        self.cached_blocks = 0
        self.pinned_blocks = 0
        self.active = False
        self.draining = False
        self._pool_key: Optional[Tuple[int, int, int]] = None
        self._pool_cache: Dict[str, Any] = {}

    # ---- the SAME shape DecodeEngine.pool_signal exports (continuous.py),
    # so the scheduler's load_signal()["pool"] block — and anything scoring
    # it, router or autoscaler — cannot tell sim from live. Memoized on the
    # counter triple: every arrival reads all replicas' signals but mutates
    # at most one, so the cache absorbs most of the route-time cost.
    def pool_signal(self) -> Dict[str, Any]:
        key = (self.live_blocks, self.cached_blocks, self.pinned_blocks)
        if key == self._pool_key:
            return self._pool_cache
        total = self.num_blocks
        free = total - key[0] - key[1] - key[2]
        available = max(0, min(total, free + self.cached_blocks - self.pinned_blocks))
        self._pool_key = key
        self._pool_cache = {
            "num_blocks": total,
            "free_frac": round(free / total, 4),
            "live_frac": round(self.live_blocks / total, 4),
            "cached_frac": round(self.cached_blocks / total, 4),
            "pinned_frac": round(self.pinned_blocks / total, 4),
            "available_blocks": available,
            "pressure": round(1.0 - available / total, 4),
        }
        return self._pool_cache

    def available_blocks(self) -> int:
        free = (
            self.num_blocks - self.live_blocks - self.cached_blocks - self.pinned_blocks
        )
        return max(
            0, min(self.num_blocks, free + self.cached_blocks - self.pinned_blocks)
        )

    def allocate(self, demand: int) -> None:
        free = (
            self.num_blocks - self.live_blocks - self.cached_blocks - self.pinned_blocks
        )
        evict = max(0, demand - free)
        self.cached_blocks = max(0, self.cached_blocks - evict)
        self.live_blocks += demand

    def release(self, demand: int) -> None:
        # finished/cancelled KV re-enters the radix cache (reclaimable),
        # clamped to pool capacity like the real LRU would enforce
        self.live_blocks = max(0, self.live_blocks - demand)
        self.cached_blocks = min(
            self.cached_blocks + demand,
            self.num_blocks - self.live_blocks - self.pinned_blocks,
        )

    def load(self) -> float:
        """The fleet ``_candidates()`` load formula, verbatim."""
        signal = self.scheduler.load_signal()
        ema_ms = signal.get("queue_wait_ema_ms") or 0.0
        load = (signal["depth"] + len(self.running)) / max(1, self.num_slots)
        load += ema_ms / 1e3
        pool = signal.get("pool")
        if pool:
            load += float(pool.get("pressure", 0.0))
        return load


class FleetSimulator:
    """Run a synthetic workload through the real serving policies.

    Construct, then :meth:`run` once; the report dict is also kept on
    ``self.report_``. Deterministic: same requests + config → same report.
    """

    def __init__(self, config: SimConfig, requests: Sequence[SimRequest]) -> None:
        from unionml_tpu_torch.serving.continuous import block_demand  # real arithmetic

        self._block_demand = block_demand
        self.config = config
        self.requests = list(requests)
        ceiling = config.replica_ceiling
        self.router = Router(
            ceiling, block_size=config.block_size, config=config.fleet
        )
        self.replicas = [_SimReplica(i, config) for i in range(ceiling)]
        for rep in self.replicas[: config.num_replicas]:
            rep.active = True
        self.slo = SLOTracker(config.slo)
        self.autoscaler = (
            None if config.autoscaler is None else Autoscaler(config.autoscaler)
        )
        # events: (t, seq, kind, payload); seq keeps ordering deterministic
        self._events: List[Tuple[float, int, str, Any]] = []
        self._event_seq = 0
        # counters
        self.completed = 0
        self.sheds: Dict[str, int] = {}
        self.failover_adoptions = 0
        self.rebalanced = 0
        self.dead_replicas: List[int] = []
        # replica-seconds integration
        self._occupancy_t = 0.0
        self._replica_seconds = 0.0
        self._min_active = config.num_replicas
        self._max_active = config.num_replicas
        self._shed_total_last_tick = 0
        self.report_: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------- event plumbing

    def _push(self, t: float, kind: str, payload: Any) -> None:
        heapq.heappush(self._events, (t, self._event_seq, kind, payload))
        self._event_seq += 1

    def _active_replicas(self) -> List[_SimReplica]:
        return [r for r in self.replicas if r.active and not r.draining]

    def _occupied_count(self) -> int:
        # draining replicas still consume a machine until empty
        return sum(1 for r in self.replicas if r.active)

    def _note_occupancy(self, now: float) -> None:
        self._replica_seconds += self._occupied_count() * (now - self._occupancy_t)
        self._occupancy_t = now

    # ------------------------------------------------------------------ intake

    def _shed(self, entry: _Entry, reason: str, now: float) -> None:
        ticket = entry.ticket
        if ticket is not None and ticket.resume is not None and entry.replica is not None:
            # a preempted request shed while waiting to resume abandons its
            # pinned checkpoint — un-pin it back to reclaimable cache, or the
            # leak wedges the pool (available shrinks monotonically)
            rep = self.replicas[entry.replica]
            rep.pinned_blocks = max(0, rep.pinned_blocks - entry.demand)
            rep.cached_blocks = min(
                rep.cached_blocks + entry.demand,
                rep.num_blocks - rep.live_blocks - rep.pinned_blocks,
            )
            ticket.resume = None
            if ticket in rep.resume_queue:
                rep.resume_queue.remove(ticket)
        self.sheds[reason] = self.sheds.get(reason, 0) + 1
        # mirrors Telemetry.end_trace: a shed is a bad SLO event, no TTFT
        self.slo.record(entry.request.cls, "shed", None, now=now)
        entry.done = True

    def _arrive(self, request: SimRequest, now: float) -> None:
        active = self._active_replicas()
        if not active:
            entry = _Entry(request, None)  # type: ignore[arg-type]
            self._shed(entry, "no_replicas", now)
            return
        candidates = [(rep.index, 1.0, rep.load()) for rep in active]
        index, _decision = self.router.route(
            request.prompt, candidates, session_id=request.session_id
        )
        rep = self.replicas[index]
        ticket = rep.scheduler.make_ticket(
            request.prompt, request.budget, None, None,
            priority=request.cls, deadline_ms=request.deadline_ms, now=now,
        )
        entry = _Entry(request, ticket)
        ticket.sink = entry
        try:
            displaced = rep.scheduler.submit(ticket, now=now)
        except SchedulingError as exc:
            self._shed(entry, exc.reason, now)
            return
        if displaced is not None:
            self._shed(displaced.sink, displaced.shed_exc.reason, now)
        self._admit_loop(rep, now)

    # --------------------------------------------------------------- admission

    def _entry_demand(self, entry: _Entry) -> int:
        return self._block_demand(
            len(entry.request.prompt), entry.request.budget,
            max_len=self.config.max_len, block_size=self.config.block_size,
        )

    def _admit_loop(self, rep: _SimReplica, now: float) -> None:
        """The batcher admission loop: expire, then admit in scheduler order
        while slots AND blocks allow; head-of-line blocks on block demand
        exactly like the paged engine (no skip-ahead — that would invert
        the priority order the scheduler just computed)."""
        for expired in rep.scheduler.take_expired(now):
            self._shed(expired.sink, "deadline_exceeded", now)
        while True:
            if len(rep.running) >= rep.num_slots:
                if not self._try_preempt(rep, now):
                    return
            ticket = rep.scheduler.peek(now)
            if ticket is None:
                return
            entry: _Entry = ticket.sink
            resume = ticket.resume is not None
            demand = entry.demand if resume else self._entry_demand(entry)
            if not resume and demand > rep.available_blocks():
                # HOL block: pool pressure gates admission — with one escape.
                # When NOTHING is running, no finish can ever grow
                # availability, and a head whose demand exceeds a pool pinned
                # down by queued checkpoints would wedge this replica for the
                # rest of the run (the live batcher reaches the same state
                # but deadline enforcement clears it; a deadline-less head
                # has no such clock). A queued resume admits out of order:
                # resumption adopts its OWN pinned blocks — it allocates
                # nothing — and its eventual finish is the only transition
                # that can un-pin the pool from here.
                if rep.running or not rep.resume_queue:
                    return
                ticket = rep.resume_queue[0]
                entry = ticket.sink
                resume = True
                demand = entry.demand
            if not rep.scheduler.pop_ticket(ticket, now):
                return
            if resume:
                if ticket in rep.resume_queue:
                    rep.resume_queue.remove(ticket)
                # checkpoint blocks un-pin and go live again (transfer)
                rep.pinned_blocks = max(0, rep.pinned_blocks - demand)
                rep.live_blocks += demand
                ticket.resume = None
                service_ms = self.config.cost.dispatch_ms + (entry.remaining_ms or 0.0)
                entry.remaining_ms = None
            else:
                rep.allocate(demand)
                entry.demand = demand
                service_ms = self.config.cost.service_ms(
                    len(entry.request.prompt), entry.request.budget, entry.request.cls,
                    speculative=getattr(entry.request, "speculative", False),
                )
            entry.replica = rep.index
            entry.admit_t = now
            if entry.first_token_t is None:
                entry.first_token_t = now + (
                    self.config.cost.ttft_compute_ms(len(entry.request.prompt)) / 1e3
                )
            entry.finish_t = now + service_ms / 1e3
            entry.epoch += 1
            rep.running.append(entry)
            deadline = ticket.deadline
            if deadline is not None and entry.finish_t > deadline:
                self._push(deadline, "deadline", (rep.index, entry, entry.epoch))
            else:
                self._push(entry.finish_t, "finish", (rep.index, entry, entry.epoch))

    def _try_preempt(self, rep: _SimReplica, now: float) -> bool:
        """Preempt-to-prefix-cache: when a strictly-more-urgent class waits
        with no free slot, checkpoint the worst runner (lowest class, most
        time remaining) and requeue it — the scheduler's counters and the
        resume bookkeeping are the production objects' own."""
        if not self.config.scheduler.preempt:
            return False
        best = rep.scheduler.best_waiting_priority()
        if best is None or not rep.running:
            return False
        victim = max(rep.running, key=lambda e: (e.ticket.priority, e.finish_t))
        if best >= victim.ticket.priority:
            return False
        if victim.admit_t >= now:
            # never preempt work admitted at this same instant — the live
            # batcher interleaves admissions with engine steps, so a runner
            # always holds its slot for at least one step; without this the
            # zero-time admit loop could ping-pong preemptions forever
            return False
        rep.running.remove(victim)
        victim.epoch += 1  # invalidates its finish/deadline heap event
        victim.remaining_ms = max(0.0, (victim.finish_t - now) * 1e3)
        # live blocks become a pinned checkpoint (LRU-eviction-proof)
        rep.live_blocks = max(0, rep.live_blocks - victim.demand)
        rep.pinned_blocks += victim.demand
        victim.ticket.resume = victim  # resume tickets bypass queue bounds
        rep.scheduler.requeue(victim.ticket, preemption=True)
        rep.resume_queue.append(victim.ticket)
        return True

    # ------------------------------------------------------------- completions

    def _finish(self, rep: _SimReplica, entry: _Entry, now: float) -> None:
        rep.running.remove(entry)
        rep.release(entry.demand)
        entry.done = True
        self.completed += 1
        ttft_ms = None
        if entry.first_token_t is not None:
            # journaled at 3 decimals; round HERE so replay cannot disagree
            ttft_ms = round((entry.first_token_t - entry.request.arrival_s) * 1e3, 3)
        self.slo.record(entry.request.cls, "ok", ttft_ms, now=now)
        self._admit_loop(rep, now)

    def _deadline_cancel(self, rep: _SimReplica, entry: _Entry, now: float) -> None:
        rep.running.remove(entry)
        rep.release(entry.demand)
        rep.scheduler.note_deadline_miss_running()
        self._shed(entry, "deadline_exceeded", now)
        self._admit_loop(rep, now)

    # ---------------------------------------------------------------- failover

    def _kill_replica(self, index: int, now: float) -> None:
        rep = self.replicas[index]
        if not rep.active:
            return
        rep.active = False
        rep.draining = False
        self.dead_replicas.append(index)
        self.router.on_replica_failed(index)
        orphans = [t.sink for t in rep.scheduler.drain()]
        orphans.extend(rep.running)
        for entry in orphans:
            # progress — running KV and preempt checkpoints alike — dies
            # with the replica; adoptees restart fresh on the survivor
            entry.epoch += 1
            entry.remaining_ms = None
            entry.first_token_t = None
            entry.ticket.resume = None
        rep.running = []
        rep.resume_queue = []
        rep.live_blocks = rep.cached_blocks = rep.pinned_blocks = 0
        survivors = self._active_replicas()
        for entry in orphans:
            if not survivors:
                self._shed(entry, "no_replicas", now)
                continue
            target = min(survivors, key=lambda r: (r.load(), r.index))
            # the live fleet adopts via requeue(preemption=False): deadline
            # and class ride along, the bound is bypassed (work is owed)
            target.scheduler.requeue(entry.ticket, preemption=False)
            self.failover_adoptions += 1
        for target in survivors:
            self._admit_loop(target, now)

    # -------------------------------------------------------------- autoscaling

    def _total_sheds(self) -> int:
        return sum(self.sheds.values())

    def _autoscale_tick(self, now: float) -> None:
        assert self.autoscaler is not None
        active = self._active_replicas()
        signals = [rep.scheduler.load_signal() for rep in active]
        sheds_now = self._total_sheds()
        shed_rate = (sheds_now - self._shed_total_last_tick) / max(
            1e-9, self.config.autoscale_interval_s
        )
        self._shed_total_last_tick = sheds_now
        delta = self.autoscaler.decide(now, signals, shed_rate)
        if delta > 0:
            self._scale_up(now)
        elif delta < 0:
            self._scale_down(now)

    def _scale_up(self, now: float) -> None:
        for rep in self.replicas:
            if not rep.active and rep.index not in self.dead_replicas:
                self._note_occupancy(now)
                rep.active = True
                rep.draining = False
                # warm the newcomer's affinity index with the fleet's hottest
                # digests so it attracts (not repels) the traffic it is for
                warm = self.config.autoscaler.warm_digests if self.config.autoscaler else 0
                if warm > 0:
                    self.router.warm_replica(rep.index, self.router.hot_digests(warm))
                self._max_active = max(self._max_active, self._occupied_count())
                return

    def _scale_down(self, now: float) -> None:
        candidates = self._active_replicas()
        if len(candidates) <= 1:
            return
        # retire the emptiest replica (highest index breaks ties: scale-down
        # walks back the same order scale-up walked forward)
        rep = min(candidates, key=lambda r: (len(r.running) + r.scheduler.depth, -r.index))
        rep.draining = True
        survivors = self._active_replicas()
        for ticket in rep.scheduler.drain():
            if ticket.resume is not None:
                # the checkpoint's blocks live on the retiring replica; the
                # adopting one cannot resume from them — demote to a fresh
                # admission and release the pin
                entry: _Entry = ticket.sink
                rep.pinned_blocks = max(0, rep.pinned_blocks - entry.demand)
                ticket.resume = None
                entry.remaining_ms = None
                entry.first_token_t = None
            target = min(survivors, key=lambda r: (r.load(), r.index))
            target.scheduler.requeue(ticket, preemption=False)
            self.rebalanced += 1
        rep.resume_queue = []
        for target in survivors:
            self._admit_loop(target, now)
        self._maybe_retire(rep, now)
        self._min_active = min(self._min_active, self._occupied_count())

    def _maybe_retire(self, rep: _SimReplica, now: float) -> None:
        if rep.draining and not rep.running and rep.scheduler.depth == 0:
            self._note_occupancy(now)
            rep.active = False
            rep.draining = False
            rep.live_blocks = rep.cached_blocks = rep.pinned_blocks = 0
            self.router.on_replica_rebuilding(rep.index)  # cache gone; sessions keep

    # --------------------------------------------------------------------- run

    def run(self) -> Dict[str, Any]:
        config = self.config
        for death in config.deaths:
            self._push(death.at_s, "death", death.replica)
        if self.autoscaler is not None:
            self._push(config.autoscale_interval_s, "autoscale", None)
        pointer = 0
        n = len(self.requests)
        now = 0.0
        while True:
            next_arrival = self.requests[pointer].arrival_s if pointer < n else None
            next_event_t = self._events[0][0] if self._events else None
            if next_arrival is None and next_event_t is None:
                break
            if next_event_t is None or (
                next_arrival is not None and next_arrival <= next_event_t
            ):
                now = max(now, next_arrival)
                self._note_occupancy(now)
                self._arrive(self.requests[pointer], now)
                pointer += 1
                continue
            t, _seq, kind, payload = heapq.heappop(self._events)
            now = max(now, t)
            self._note_occupancy(now)
            if kind == "finish" or kind == "deadline":
                index, entry, epoch = payload
                rep = self.replicas[index]
                if entry.epoch != epoch or entry.done or entry not in rep.running:
                    continue  # stale: preempted, cancelled, or replica died
                if kind == "finish":
                    self._finish(rep, entry, now)
                else:
                    self._deadline_cancel(rep, entry, now)
                self._maybe_retire(rep, now)
            elif kind == "death":
                self._kill_replica(int(payload), now)
            elif kind == "autoscale":
                self._autoscale_tick(now)
                # reschedule only while the sim can still make progress:
                # arrivals remain, or something is running (whose finish
                # event will drive admission). A queue with nothing running
                # and no arrivals left is wedged — ticking the autoscaler
                # at +5s forever would never unwedge it (the final sweep
                # below accounts for it instead).
                work_left = pointer < n or any(r.running for r in self.replicas)
                if work_left:
                    self._push(now + config.autoscale_interval_s, "autoscale", None)
        # final sweep: anything still queued when events ran out (e.g. a
        # head-of-line block with no replica left to drain it) must land in
        # the ledger — every request ends completed or shed, never lost
        for rep in self.replicas:
            for expired in rep.scheduler.take_expired(now):
                self._shed(expired.sink, "deadline_exceeded", now)
            for ticket in rep.scheduler.drain():
                self._shed(ticket.sink, "sim_ended", now)
        self._note_occupancy(now)
        self.report_ = self._report(now)
        return self.report_

    # ------------------------------------------------------------------ report

    def _scheduler_totals(self) -> Dict[str, int]:
        keys = (
            "submitted", "admitted", "shed_queue_full", "shed_deadline_infeasible",
            "deadline_misses_queued", "deadline_misses_running", "preemptions",
            "resumes",
        )
        totals = {key: 0 for key in keys}
        for rep in self.replicas:
            for key in keys:
                totals[key] += getattr(rep.scheduler, key)
        return totals

    def _report(self, end_t: float) -> Dict[str, Any]:
        duration = max(end_t, 1e-9)
        totals = self.slo.totals()
        good = sum(c["good"] for c in totals.values())
        total = sum(c["total"] for c in totals.values())
        avg_replicas = self._replica_seconds / duration
        return {
            "duration_s": round(duration, 3),
            "requests": len(self.requests),
            "completed": self.completed,
            "shed": dict(sorted(self.sheds.items())),
            "failover_adoptions": self.failover_adoptions,
            "rebalanced": self.rebalanced,
            "dead_replicas": list(self.dead_replicas),
            "scheduler": self._scheduler_totals(),
            "router": self.router.stats(),
            "replicas": {
                "initial": self.config.num_replicas,
                "ceiling": self.config.replica_ceiling,
                "min": self._min_active,
                "max": self._max_active,
                "avg": round(avg_replicas, 4),
                "replica_seconds": round(self._replica_seconds, 3),
            },
            "autoscaler": None if self.autoscaler is None else self.autoscaler.stats(),
            "slo": self.slo.report(now=end_t),
            "slo_totals": totals,
            "attainment": None if total == 0 else round(good / total, 6),
            "attainment_per_replica": (
                None
                if total == 0 or avg_replicas <= 0
                else round((good / total) / avg_replicas, 6)
            ),
        }


def replay_journal(
    records: Sequence[JournalRecord], slo: Optional[SLOConfig] = None
) -> Dict[str, Any]:
    """Re-derive the policy counters and SLO ledger from a journal ALONE.

    Every number here is computed from journal fields only — no access to
    the process that wrote it — so comparing the result against the live
    scheduler/telemetry counters is a bit-for-bit validation that the
    journal is a sufficient record of what the policies did (the golden
    replay test). Works on v1 journals too; v2 adds the block
    arithmetic fields (``block_demand`` / ``available_blocks``) that are
    checked for internal consistency when present.
    """
    tracker = SLOTracker(slo)
    sheds: Dict[str, int] = {}
    status_counts: Dict[str, int] = {}
    preemptions = 0
    resumes = 0
    failover_adoptions = 0
    deadline_misses_queued = 0
    deadline_misses_running = 0
    by_class = {name: 0 for name in PRIORITY_CLASSES}
    block_demand_violations = 0
    for i, rec in enumerate(records):
        status_counts[rec.status] = status_counts.get(rec.status, 0) + 1
        if rec.cls in by_class:
            by_class[rec.cls] += 1
        if rec.status == "shed":
            reason = rec.reason or "rejected"
            sheds[reason] = sheds.get(reason, 0) + 1
            if reason == "deadline_exceeded":
                # a queued expiry never got a slot; a running cancel did
                if rec.first_span("admitted") is None:
                    deadline_misses_queued += 1
                else:
                    deadline_misses_running += 1
        preemptions += rec.span_count("preempted")
        failover_adoptions += rec.span_count("failover_adopt")
        for span in rec.spans:
            if span.get("kind") == "queue_wait" and span.get("attrs", {}).get("resume"):
                resumes += 1
        demand = rec.block_demand
        available = rec.available_blocks
        if demand is not None and available is not None and rec.first_span("admitted"):
            # v2 invariant: nothing is ADMITTED into more blocks than the
            # pool could reclaim at admission time
            if demand > available:
                block_demand_violations += 1
        # virtual clock: journal emission order at 1ms spacing keeps every
        # record inside the rolling windows without touching wall time
        tracker.record(rec.cls, rec.status, rec.ttft_ms, now=i * 1e-3)
    return {
        "records": len(records),
        "status": dict(sorted(status_counts.items())),
        "by_class": by_class,
        "shed": dict(sorted(sheds.items())),
        "preemptions": preemptions,
        "resumes": resumes,
        "failover_adoptions": failover_adoptions,
        "deadline_misses_queued": deadline_misses_queued,
        "deadline_misses_running": deadline_misses_running,
        "block_demand_violations": block_demand_violations,
        "slo_totals": tracker.totals(),
    }
