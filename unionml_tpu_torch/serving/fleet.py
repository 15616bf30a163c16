"""Fleet serving: replicated engines behind a prefix-affinity router.

The port of ``unionml_tpu/serving/fleet.py``. :class:`EngineFleet` is the
scale-out layer: N supervised replicas, each a ``ContinuousBatcher`` +
``DecodeEngine`` + ``EngineSupervisor``, behind a :class:`Router` that picks a
replica per request by:

- **Radix-prefix affinity.** The router digests the block-aligned prompt
  prefix with the SAME hashing as the engines' radix prefix cache
  (:func:`~unionml_tpu_torch.serving.prefix_cache.prefix_digests`, chained over
  :func:`~unionml_tpu_torch.serving.prefix_cache.block_key`) and keeps a bounded
  recent-prefix digest index per replica; a prompt routes to the replica
  whose cache most likely holds its longest prefix, so shared system prompts
  and chat histories restore instead of re-prefilling on a random replica.
- **Session stickiness.** Multi-turn chat pins a ``session_id`` to its
  replica (TTL-evicted map), keeping every turn's growing transcript against
  the cache that already holds it; a dead/unroutable replica falls back to
  the affinity winner and the session RE-STICKS there.
- **Load + health.** Per-replica queue depth, slot occupancy, and the
  scheduler's queue-wait EMA (:meth:`SLOScheduler.load_signal`) down-rank
  busy replicas; supervisor state gates hard — ``rebuilding``/``failed``
  replicas get zero weight, ``degraded`` is down-weighted.

The score for a healthy replica ``i`` is::

    score_i = weight_i * (1 + affinity_weight * hit_frac_i)
                       / (1 + load_weight * load_i)

with ``weight_i`` 1.0 (``ok``) or ``degraded_weight``, ``hit_frac_i`` the
digest-matched fraction of the prompt's full blocks, and ``load_i`` the
replica's ``(queued + active) / slots + queue_wait_ema_s``. Ties break to
the less-loaded, then lower-indexed replica.

Failure composes with supervised recovery instead of bypassing it:
fleet-level shedding applies the ``/generate`` error contract (429/503 with
Retry-After) at the router BEFORE any replica queue is touched, and a
replica whose rebuild budget exhausts hands its salvageable tickets to the
fleet (``ContinuousBatcher.on_tickets_orphaned``), which RE-ROUTES them to
surviving replicas as resume tickets — transcript-as-prompt, unspent budget,
deadline/priority/sink intact — so an engine death loses zero recoverable
requests fleet-wide.

On one card the replicas share one device and one CUDA context: each engine
issues its work on its own CUDA stream (:attr:`DecodeEngine.stream`), so one
replica's fetch does not wait for another's prefill, and the kernel launch
counts stay exact per thread (:mod:`unionml_tpu_torch.kernels`). A sticky
device error (an illegal address) poisons the context and so every replica on
the card: the failover this module gives there covers host-raised faults and
recoverable engine failures, not a lost device. :func:`split_devices` groups
several cards per replica.

Lock discipline: the router's lock is a LEAF — ``Router`` methods take no
other lock, and the fleet never holds its own counter lock while calling into
a replica's batcher or scheduler. Candidate health/load snapshots are
gathered from supervisor/scheduler locks BEFORE ``Router._lock`` is acquired,
so no ``supervisor._lock -> router._lock`` ordering exists in either
direction.
"""

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.continuous import ContinuousBatcher
from unionml_tpu_torch.serving.faults import EngineFailure
from unionml_tpu_torch.serving.prefix_cache import prefix_digests
from unionml_tpu_torch.serving.scheduler import QueueFullError, SchedulerConfig, SLOScheduler
from unionml_tpu_torch.serving.supervisor import EngineSupervisor

__all__ = ["EngineFleet", "FleetConfig", "Router", "split_devices"]

# lock-order: Router._lock < (nothing) — router lock is a leaf by design
ROUTE_POLICIES = ("affinity", "random", "round_robin")


class FleetConfig:
    """Knobs for :class:`EngineFleet` + :class:`Router`.

    :param policy: ``affinity`` (scored; the default), ``random`` (seeded
        uniform over healthy replicas — the A/B baseline), or
        ``round_robin``.
    :param max_queue: fleet-level admission bound — total queued requests
        across every replica at which the router sheds with 429 BEFORE
        touching any replica queue (each replica's own scheduler bound still
        applies underneath).
    :param retry_after_s: Retry-After hint attached to router-level sheds.
    :param session_ttl_s: idle time after which a session→replica sticky
        mapping is evicted (the next turn re-routes by affinity).
    :param max_sessions: sticky-map capacity; least-recently-routed sessions
        are evicted first.
    :param affinity_index_blocks: per-replica digest-index capacity (LRU) —
        how many recent block-prefixes the router remembers per replica.
    :param affinity_weight: how strongly a digest match attracts (0 disables
        affinity scoring without disabling measurement).
    :param load_weight: how strongly queue depth/occupancy/wait repel.
    :param degraded_weight: score multiplier for ``degraded`` replicas.
    :param seed: seeds the ``random`` policy's RNG (deterministic A/B runs).
    """

    def __init__(
        self,
        *,
        policy: str = "affinity",
        max_queue: int = 512,
        retry_after_s: float = 1.0,
        session_ttl_s: float = 300.0,
        max_sessions: int = 4096,
        affinity_index_blocks: int = 1024,
        affinity_weight: float = 1.0,
        load_weight: float = 1.0,
        degraded_weight: float = 0.5,
        seed: int = 0,
    ) -> None:
        if policy not in ROUTE_POLICIES:
            raise ValueError(f"policy must be one of {ROUTE_POLICIES}, got {policy!r}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.policy = policy
        self.max_queue = int(max_queue)
        self.retry_after_s = float(retry_after_s)
        self.session_ttl_s = float(session_ttl_s)
        self.max_sessions = int(max_sessions)
        self.affinity_index_blocks = int(affinity_index_blocks)
        self.affinity_weight = float(affinity_weight)
        self.load_weight = float(load_weight)
        self.degraded_weight = float(degraded_weight)
        self.seed = int(seed)


class Router:
    """Replica choice: prefix affinity + session stickiness + load/health.

    Pure host bookkeeping — no device work, no engine references. The fleet
    snapshots candidate ``(index, weight, load)`` triples from supervisor/scheduler
    state FIRST and passes them in, so this class's lock nests inside nothing
    and nothing nests inside it (see the module docstring's lock discipline).

    :param num_replicas: fleet size (digest indexes are per-replica).
    :param block_size: the engines' prefix-cache block size — digesting with
        any other granularity would diverge from the radix trees.
    :param config: see :class:`FleetConfig`.
    :param time_fn: injectable clock for TTL tests.
    """

    def __init__(
        self,
        num_replicas: int,
        *,
        block_size: int,
        config: Optional[FleetConfig] = None,
        time_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        import random

        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        self.config = config or FleetConfig()
        self.num_replicas = int(num_replicas)
        self.block_size = int(block_size)
        self._time = time_fn
        self._rng = random.Random(self.config.seed)
        self._lock = threading.Lock()  # lock-leaf (see the module-level lock-order note)
        #: per-replica recent-prefix digest index (insertion-ordered dict as
        #: LRU: re-recording moves to the back, eviction pops the front)
        self._digests: List[Dict[int, None]] = [{} for _ in range(num_replicas)]  # guarded-by: _lock
        #: session_id -> (replica index, last-routed stamp)
        self._sessions: Dict[str, Tuple[int, float]] = {}  # guarded-by: _lock
        self._rr_next = 0  # guarded-by: _lock
        # counters (the /stats generation.fleet.router block) — guarded-by: _lock
        self.lookups = 0  # guarded-by: _lock
        self.lookup_blocks = 0  # guarded-by: _lock
        self.hit_blocks = 0  # guarded-by: _lock
        self.prefix_hits = 0  # guarded-by: _lock
        self.sticky_routes = 0  # guarded-by: _lock
        self.affinity_routes = 0  # guarded-by: _lock
        self.random_routes = 0  # guarded-by: _lock
        self.round_robin_routes = 0  # guarded-by: _lock
        self.dead_session_fallbacks = 0  # guarded-by: _lock
        self.sessions_evicted = 0  # guarded-by: _lock

    # ------------------------------------------------------------------ route

    def route(
        self,
        tokens: Sequence[int],
        candidates: Sequence[Tuple[int, float, float]],
        session_id: Optional[str] = None,
    ) -> Tuple[int, Dict[str, Any]]:
        """Pick a replica for ``tokens`` among healthy ``candidates``.

        ``candidates`` are ``(index, weight, load)`` triples the fleet
        snapshots WITHOUT holding this router's lock — ``weight`` already
        encodes supervisor health (0-weight replicas must not be passed at
        all), ``load`` the replica's occupancy + queue-wait signal. Returns
        ``(index, decision)`` where ``decision`` records how the choice was
        made (``sticky``/``affinity``/``random``/``round_robin``) and the
        digest-matched block count on the CHOSEN replica — the router-level
        prefix-hit measurement both policies share, so an A/B compares like
        with like. Records the prompt's digests on the winner (it will hold
        these blocks once the request prefills) and re-sticks the session.
        """
        if not candidates:
            raise ValueError("route() needs at least one healthy candidate")
        digests = prefix_digests(tokens, self.block_size)
        now = self._time()
        with self._lock:
            self.lookups += 1
            self._expire_sessions(now)
            alive = {int(idx) for idx, _, _ in candidates}
            chosen: Optional[int] = None
            how = self.config.policy
            if session_id is not None:
                entry = self._sessions.get(session_id)
                if entry is not None:
                    if entry[0] in alive:
                        chosen, how = entry[0], "sticky"
                    else:
                        # sticky replica died or is rebuilding: fall back to
                        # the scored choice below and re-stick there
                        self.dead_session_fallbacks += 1
            if chosen is None:
                if self.config.policy == "random":
                    chosen = int(candidates[self._rng.randrange(len(candidates))][0])
                elif self.config.policy == "round_robin":
                    order = sorted(alive)
                    chosen = order[self._rr_next % len(order)]
                    self._rr_next += 1
                else:
                    chosen = self._best(digests, candidates)
            matched = self._matched_blocks(chosen, digests)
            self.lookup_blocks += len(digests)
            self.hit_blocks += matched
            if matched > 0:
                self.prefix_hits += 1
            counter = {
                "sticky": "sticky_routes",
                "affinity": "affinity_routes",
                "random": "random_routes",
                "round_robin": "round_robin_routes",
            }[how]
            setattr(self, counter, getattr(self, counter) + 1)
            self._record(chosen, digests)
            if session_id is not None:
                self._sessions.pop(session_id, None)
                self._sessions[session_id] = (chosen, now)
                while len(self._sessions) > self.config.max_sessions:
                    self._sessions.pop(next(iter(self._sessions)))
                    self.sessions_evicted += 1
            return chosen, {
                "decision": how,
                "matched_blocks": matched,
                "digest_blocks": len(digests),
            }

    def _best(
        self, digests: Sequence[int], candidates: Sequence[Tuple[int, float, float]]
    ) -> int:
        best_idx, best_key = -1, None
        for idx, weight, load in candidates:
            idx = int(idx)
            if digests:
                frac = self._matched_blocks(idx, digests) / len(digests)
            else:
                frac = 0.0
            score = (
                float(weight)
                * (1.0 + self.config.affinity_weight * frac)
                / (1.0 + self.config.load_weight * max(0.0, float(load)))
            )
            key = (-score, float(load), idx)
            if best_key is None or key < best_key:
                best_idx, best_key = idx, key
        return best_idx

    def _matched_blocks(self, index: int, digests: Sequence[int]) -> int:
        # digests are chained, so membership of digests[i] implies the whole
        # prefix through block i was recorded here; walk forward (an LRU
        # eviction of an early digest conservatively truncates the match)
        held = self._digests[index]  # graftlint: disable=data-race -- route() is the only caller and already holds _lock
        matched = 0
        for digest in digests:
            if digest not in held:
                break
            matched += 1
        return matched

    def _record(self, index: int, digests: Sequence[int]) -> None:
        held = self._digests[index]  # graftlint: disable=data-race -- route() is the only caller and already holds _lock
        for digest in digests:
            held.pop(digest, None)
            held[digest] = None
        cap = self.config.affinity_index_blocks
        while len(held) > cap:
            held.pop(next(iter(held)))

    def _expire_sessions(self, now: float) -> None:
        # guarded-by: _lock (route-time sweep; the map is bounded, sessions
        # are insertion-ordered by last route, so expired ones sit in front)
        ttl = self.config.session_ttl_s
        while self._sessions:  # graftlint: disable=data-race -- route() is the only caller and already holds _lock
            sid = next(iter(self._sessions))
            if now - self._sessions[sid][1] <= ttl:
                break
            self._sessions.pop(sid)  # graftlint: disable=lock-discipline -- route() is the only caller and already holds _lock
            self.sessions_evicted += 1  # graftlint: disable=lock-discipline -- route() is the only caller and already holds _lock

    # ------------------------------------------------------------- lifecycle

    def on_replica_rebuilding(self, index: int) -> None:
        """The replica's engine is being rebuilt: its block pool (and so its
        radix cache) will come back empty — forget its digests so affinity
        stops preferring a cache that no longer exists. Sessions stay stuck
        (the replica usually returns); route() excludes it meanwhile."""
        with self._lock:
            self._digests[index].clear()

    def on_replica_failed(self, index: int) -> None:
        """The replica is dead for good (rebuild budget exhausted): drop its
        digests AND its sessions, so every affected session's next turn
        re-routes by affinity — typically to the survivor that adopted the
        session's re-routed transcript."""
        with self._lock:
            self._digests[index].clear()
            for sid in [s for s, (r, _) in self._sessions.items() if r == index]:
                self._sessions.pop(sid)

    def session_replica(self, session_id: str) -> Optional[int]:
        """The replica a session is currently stuck to (None when unmapped)."""
        with self._lock:
            entry = self._sessions.get(session_id)
            return None if entry is None else entry[0]

    # ------------------------------------------------------ autoscaler warm-up

    def hot_digests(self, k: int = 128) -> List[int]:
        """The fleet's ``k`` hottest prefix digests, most recent first —
        drawn round-robin from the tail of every replica's LRU index (the
        tail IS recency). The autoscaler feeds these to
        :meth:`warm_replica` so a scaled-up replica starts with the radix
        paths traffic is actually hitting instead of a cold index that
        repels every affinity score."""
        if k < 1:
            return []
        with self._lock:
            tails = [list(reversed(held)) for held in self._digests if held]
            out: List[int] = []
            seen = set()
            for rank in range(max((len(t) for t in tails), default=0)):
                for tail in tails:
                    if rank < len(tail) and tail[rank] not in seen:
                        seen.add(tail[rank])
                        out.append(tail[rank])
                        if len(out) >= k:
                            return out
            return out

    def warm_replica(self, index: int, digests: Sequence[int]) -> None:
        """Seed ``index``'s digest index (scale-up warm-up): recorded
        oldest-first so the hottest digest (``digests[0]``, per
        :meth:`hot_digests` ordering) lands most-recent in the LRU. The
        replica's radix cache is still cold — the first routed request per
        prefix pays one prefill, after which the advertised affinity is
        real; without seeding, a cold index repels exactly the traffic that
        would warm it."""
        with self._lock:
            self._record(int(index), list(reversed(list(digests))))

    def stats(self) -> Dict[str, Any]:
        """The ``/stats`` → ``generation.fleet.router`` block."""
        with self._lock:
            return {
                "policy": self.config.policy,
                "lookups": self.lookups,
                "lookup_blocks": self.lookup_blocks,
                "hit_blocks": self.hit_blocks,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_rate": (
                    None if self.lookup_blocks == 0
                    else round(self.hit_blocks / self.lookup_blocks, 4)
                ),
                "sticky_routes": self.sticky_routes,
                "affinity_routes": self.affinity_routes,
                "random_routes": self.random_routes,
                "round_robin_routes": self.round_robin_routes,
                "dead_session_fallbacks": self.dead_session_fallbacks,
                "sessions_active": len(self._sessions),
                "sessions_evicted": self.sessions_evicted,
                "indexed_blocks": [len(d) for d in self._digests],
            }


def split_devices(devices: Sequence[Any], n: int) -> List[List[Any]]:
    """Split ``devices`` (``torch.device``\\ s, in order) into ``n`` equal
    contiguous groups, one per replica: the counterpart of JAX's
    ``split_mesh`` (``fleet.py:393-420``) until the port has a mesh, with its
    errors. Replicas that share one card are built with ``device="cuda"``
    each instead."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    devices = list(devices)
    if len(devices) % n != 0:
        raise ValueError(f"cannot split {len(devices)} devices into {n} equal groups")
    per = len(devices) // n
    return [devices[i * per : (i + 1) * per] for i in range(n)]


class _Replica:
    """One fleet member: engine + batcher + supervisor, index-stamped."""

    __slots__ = ("index", "engine", "batcher", "supervisor")

    def __init__(self, index: int, engine: Any, batcher: Any, supervisor: Any) -> None:
        self.index = index
        self.engine = engine
        self.batcher = batcher
        self.supervisor = supervisor


class EngineFleet:
    """N supervised engine replicas behind a :class:`Router`.

    :param engines: the replicas' :class:`DecodeEngine`\\ s (on one card, each
        on its own CUDA stream; or one per :func:`split_devices` group). Each
        gets its OWN ``ContinuousBatcher`` + ``SLOScheduler`` +
        ``EngineSupervisor``.
    :param config: router/shedding knobs (:class:`FleetConfig`).
    :param lookahead: per-replica batcher dispatch-ahead depth.
    :param scheduler: a ``SchedulerConfig`` applied to every replica's own
        scheduler (an ``SLOScheduler`` INSTANCE is rejected: replicas must
        not share a queue).
    :param supervisors: optional pre-built supervisors, one per engine
        (tests inject fault-tuned ones); defaults to fresh supervisors.

    The fleet exposes the same async ``generate``/``stream`` surface as a
    single ``ContinuousBatcher`` (plus ``session_id=``), so
    ``build_aiohttp_app`` serves either transparently; ``is_fleet`` lets the
    route's plain functions (:func:`~unionml_tpu_torch.serving.app.healthz_body`,
    :func:`~unionml_tpu_torch.serving.app.generation_stats`) pick the
    fleet-shaped ``/healthz`` and ``/stats`` bodies.
    """

    is_fleet = True
    #: the HTTP layer may forward its request_id (trace continuity end-to-end)
    accepts_request_id = True

    def __init__(
        self,
        engines: Sequence[Any],
        *,
        config: Optional[FleetConfig] = None,
        lookahead: int = 1,
        scheduler: Optional[SchedulerConfig] = None,
        supervisors: Optional[Sequence[Any]] = None,
        telemetry: Optional[Any] = None,
    ) -> None:
        engines = list(engines)
        if not engines:
            raise ValueError("EngineFleet needs at least one engine")
        if isinstance(scheduler, SLOScheduler):
            raise TypeError(
                "pass a SchedulerConfig: each replica owns its own SLOScheduler "
                "(a shared queue instance would defeat per-replica routing)"
            )
        self.config = config or FleetConfig()
        if supervisors is None:
            supervisors = [EngineSupervisor() for _ in engines]
        supervisors = list(supervisors)
        if len(supervisors) != len(engines):
            raise ValueError(
                f"{len(engines)} engines need {len(engines)} supervisors, "
                f"got {len(supervisors)}"
            )
        block_sizes = {int(e.block_size) for e in engines}
        if len(block_sizes) != 1:
            raise ValueError(
                f"replicas must share one prefix block size, got {sorted(block_sizes)}"
            )
        self.router = Router(
            len(engines), block_size=block_sizes.pop(), config=self.config
        )
        #: ONE Telemetry shared fleet-wide: a trace follows its request across
        #: replicas (failover adoption keeps the same request_id), so the
        #: instruments must not be per-replica (``is not None`` guarded)
        self._telemetry = telemetry
        self._replicas: List[_Replica] = []
        for index, (engine, sup) in enumerate(zip(engines, supervisors)):
            batcher = ContinuousBatcher(
                engine,
                lookahead=lookahead,
                scheduler=SLOScheduler(scheduler),
                supervisor=sup,
                telemetry=telemetry,
                device=engine.device,
            )
            # failover hand-off: the dying replica's worker thread calls this
            # with its orphaned tickets; we re-route them to survivors
            batcher.on_tickets_orphaned = (
                lambda tickets, _i=index: self._reroute_orphans(_i, tickets)
            )
            sup.subscribe(lambda old, new, _i=index: self._on_replica_state(_i, old, new))
            self._replicas.append(_Replica(index, engine, batcher, sup))
        self._lock = threading.Lock()  # lock-leaf -- guards the fleet counters ONLY
        self._closed = False  # guarded-by: _lock
        self.requests_routed = 0  # guarded-by: _lock
        self.shed_queue_full = 0  # guarded-by: _lock
        self.shed_unavailable = 0  # guarded-by: _lock
        self.rerouted_tickets = 0  # guarded-by: _lock
        self.reroute_failed = 0  # guarded-by: _lock

    # ------------------------------------------------------------- structure

    def attach_telemetry(self, telemetry: Any) -> None:
        """Wire ONE span/metrics collector into a prebuilt fleet (no-op when
        one is already attached): shared fleet-wide so traces survive
        cross-replica failover. Call before the first routed request."""
        if telemetry is None or self._telemetry is not None:
            return
        self._telemetry = telemetry
        for rep in self._replicas:
            rep.batcher.attach_telemetry(telemetry)

    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    @property
    def replicas(self) -> List[_Replica]:
        return list(self._replicas)

    @property
    def engine(self) -> Any:
        """Replica 0's engine — the HTTP layer's request-validation surface
        (``max_len``/``bucket_for``); replicas are homogeneous by contract."""
        return self._replicas[0].engine

    @property
    def supervisor(self) -> Any:
        """Replica 0's supervisor (single-replica compatibility shims only;
        fleet-aware callers read :meth:`healthz`)."""
        return self._replicas[0].supervisor

    # --------------------------------------------------------------- routing

    def _candidates(self) -> List[Tuple[int, float, float]]:
        """Snapshot ``(index, weight, load)`` for every routable replica.

        Reads supervisor and scheduler state (their own locks) BEFORE any
        router/fleet lock is taken — the lock-discipline keystone."""
        out: List[Tuple[int, float, float]] = []
        for rep in self._replicas:
            state = rep.supervisor.state
            if state not in ("ok", "degraded"):
                continue  # zero weight: never a candidate
            weight = 1.0 if state == "ok" else self.config.degraded_weight
            signal = rep.batcher.scheduler.load_signal()
            slots = max(1, int(getattr(rep.engine, "num_slots", 1)))
            ema_ms = signal.get("queue_wait_ema_ms") or 0.0
            load = (signal["depth"] + rep.engine.num_active) / slots + ema_ms / 1e3
            pool = signal.get("pool")
            if pool:
                # paged engines: a replica whose block pool is nearly
                # unreclaimable is as unattractive as a full slot table,
                # whatever its queue says (admission will head-of-line block)
                load += float(pool.get("pressure", 0.0))
            out.append((rep.index, weight, load))
        return out

    def _tel_shed(self, request_id: Optional[str], reason: str) -> None:
        """Close a request's trace on a router-level shed (before any replica
        queue was touched); no-op without telemetry or an opened trace."""
        if self._telemetry is None or request_id is None:
            return
        self._telemetry.sheds_total.inc(1.0, reason)
        self._telemetry.end_trace(request_id, "shed", reason=reason)

    def _route(
        self,
        prompt_ids: Sequence[int],
        session_id: Optional[str],
        request_id: Optional[str] = None,
    ) -> _Replica:
        with self._lock:
            if self._closed:
                self._tel_shed(request_id, "batcher_closed")
                raise EngineFailure("fleet is closed", reason="batcher_closed")
        candidates = self._candidates()
        if not candidates:
            with self._lock:
                self.shed_unavailable += 1
            self._tel_shed(request_id, "fleet_unavailable")
            raise EngineFailure(
                "no healthy replica in the fleet",
                reason="fleet_unavailable",
                retryable=True,
            )
        # fleet-level shed BEFORE any replica queue is touched: the 429
        # contract holds at the router, not just per-replica
        total_queued = sum(r.batcher.scheduler.depth for r in self._replicas)
        if total_queued >= self.config.max_queue:
            with self._lock:
                self.shed_queue_full += 1
            self._tel_shed(request_id, "queue_full")
            raise QueueFullError(
                f"fleet queue full ({total_queued} requests waiting across "
                f"{len(self._replicas)} replicas)",
                retry_after_s=self.config.retry_after_s,
            )
        index, decision = self.router.route(prompt_ids, candidates, session_id=session_id)
        with self._lock:
            self.requests_routed += 1
        if self._telemetry is not None:
            # router._lock was released by route(); telemetry is a leaf here
            self._telemetry.route_decisions_total.inc(1.0, str(decision["decision"]))
            if request_id is not None:
                self._telemetry.span(
                    request_id, "route",
                    replica=index,
                    decision=decision["decision"],
                    matched_blocks=decision["matched_blocks"],
                    digest_blocks=decision["digest_blocks"],
                    candidates=len(candidates),
                )
        return self._replicas[index]

    async def generate(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        *,
        session_id: Optional[str] = None,
        priority: Any = None,
        deadline_ms: Optional[float] = None,
        request_id: Optional[str] = None,
        **sampling,
    ) -> List[int]:
        """Route, then delegate to the chosen replica's batcher (same
        contract as ``ContinuousBatcher.generate`` + ``session_id``)."""
        if self._telemetry is not None:
            # open the trace BEFORE routing so the route/shed spans land on it;
            # the replica batcher joins it (new_trace is idempotent on an
            # active request_id)
            request_id = self._telemetry.new_trace(request_id, session_id=session_id)
            replica = self._route(prompt_ids, session_id, request_id)
        else:
            # two-arg call kept for telemetry-less fleets (wrappable in tests)
            replica = self._route(prompt_ids, session_id)
        return await replica.batcher.generate(
            prompt_ids, max_new_tokens, priority=priority, deadline_ms=deadline_ms,
            request_id=request_id, **sampling,
        )

    async def stream(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        *,
        session_id: Optional[str] = None,
        priority: Any = None,
        deadline_ms: Optional[float] = None,
        request_id: Optional[str] = None,
        **sampling,
    ):
        """Route, then stream from the chosen replica (router sheds raise on
        the first ``__anext__``, before any token, like the single-engine
        path)."""
        if self._telemetry is not None:
            request_id = self._telemetry.new_trace(request_id, session_id=session_id)
            replica = self._route(prompt_ids, session_id, request_id)
        else:
            replica = self._route(prompt_ids, session_id)
        async for token in replica.batcher.stream(
            prompt_ids, max_new_tokens, priority=priority, deadline_ms=deadline_ms,
            request_id=request_id, **sampling,
        ):
            yield token

    # -------------------------------------------------------------- failover

    def _on_replica_state(self, index: int, old: str, new: str) -> None:
        # supervisor subscriber: runs OUTSIDE the supervisor lock (see
        # EngineSupervisor.subscribe), so taking the router lock here is safe
        if new == "rebuilding":
            self.router.on_replica_rebuilding(index)
        elif new == "failed":
            self.router.on_replica_failed(index)

    def _reroute_orphans(self, dead_index: int, tickets: List[Any]) -> List[Any]:
        """Place a dead replica's orphaned tickets on survivors.

        Runs on the DEAD replica's worker thread via
        ``ContinuousBatcher.on_tickets_orphaned``. Each ticket already
        carries its transcript as prompt and its unspent budget; its salvage
        pin was released with the dead engine. Routing reuses the affinity
        scorer (the transcript digests then index on the adoptive replica,
        so the session's NEXT turn follows them there). Returns the tickets
        no survivor could adopt — the owner fails those with the structured
        unavailable error.
        """
        unplaced: List[Any] = []
        for ticket in tickets:
            placed = False
            tried = {dead_index}
            rid = getattr(ticket, "request_id", None)
            while not placed:
                candidates = [c for c in self._candidates() if c[0] not in tried]
                if not candidates:
                    break
                index, _ = self.router.route(ticket.prompt, candidates)
                tried.add(index)
                try:
                    self._replicas[index].batcher.adopt_ticket(ticket)
                    placed = True
                except Exception as exc:  # closed/racing replica: try the next
                    logger.warning(
                        "fleet failover: replica %d refused ticket (%s)%s; trying next",
                        index, exc,
                        f" (request_id={rid})" if rid is not None else "",
                    )
            if placed and self._telemetry is not None:
                self._telemetry.failover_adoptions_total.inc()
                if rid is not None:
                    # the trace stays OPEN: the same request_id now decodes on
                    # the adoptive replica — continuity IS the failover pin
                    self._telemetry.span(
                        ticket.request_id, "failover_adopt",
                        from_replica=dead_index, to_replica=index,
                        transcript_tokens=len(ticket.prompt),
                    )
            with self._lock:
                if placed:
                    self.rerouted_tickets += 1
                else:
                    self.reroute_failed += 1
                    unplaced.append(ticket)
        if tickets:
            logger.warning(
                "fleet failover: replica %d died; re-routed %d/%d orphaned tickets",
                dead_index, len(tickets) - len(unplaced), len(tickets),
            )
        return unplaced

    # ------------------------------------------------------------- lifecycle

    def drain(self, timeout_s: float = 5.0) -> None:
        """Graceful shutdown: stop routing (new requests fail fast with the
        structured closed error), then drain every replica within ONE shared
        window — same blocking contract as ``ContinuousBatcher.drain``, so
        the app's cleanup hook treats a fleet and a single batcher alike."""
        with self._lock:
            self._closed = True
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        for rep in self._replicas:
            rep.batcher.drain(max(0.0, deadline - time.monotonic()))

    def close(self) -> None:
        """Shut every replica down (queued requests fail structured)."""
        with self._lock:
            self._closed = True
        for rep in self._replicas:
            rep.batcher.close()

    # ------------------------------------------------------------------ stats

    def healthz(self) -> Dict[str, Any]:
        """The fleet ``/healthz`` body: per-replica supervisor state, overall
        ``ok``/``degraded``/``failed`` (a fleet serves while ANY replica
        does; ``degraded`` says capacity is reduced)."""
        per = []
        serving = 0
        for rep in self._replicas:
            sup_stats = rep.supervisor.stats()
            if sup_stats["health"] in ("ok", "degraded"):
                serving += 1
            per.append(
                {
                    "replica": rep.index,
                    "state": sup_stats["health"],
                    "last_fault": rep.supervisor.last_fault,
                    "rebuilds": sup_stats["rebuilds"],
                    "watchdog_trips": sup_stats["watchdog_trips"],
                }
            )
        if serving == len(per):
            state = "ok"
        elif serving > 0:
            state = "degraded"
        else:
            state = "failed"
        return {
            "state": state,
            "supervised": True,
            "fleet": True,
            "replicas": per,
            "serving_replicas": serving,
        }

    def stats(self) -> Dict[str, Any]:
        """The ``/stats`` → ``generation`` block for a fleet: aggregate
        engine counters plus the ``fleet`` sub-block (router, per-replica
        scheduler/health/prefix-cache state, failover accounting)."""
        with self._lock:
            fleet_counters = {
                "requests_routed": self.requests_routed,
                "shed_queue_full": self.shed_queue_full,
                "shed_unavailable": self.shed_unavailable,
                "rerouted_tickets": self.rerouted_tickets,
                "reroute_failed": self.reroute_failed,
            }
        per_replica = []
        for rep in self._replicas:
            eng = rep.engine
            entry: Dict[str, Any] = {
                "replica": rep.index,
                "state": rep.supervisor.state,
                "active": eng.num_active,
                "num_slots": int(getattr(eng, "num_slots", 0)),
                "scheduler": rep.batcher.scheduler.stats(),
                "supervisor": rep.supervisor.stats(),
            }
            cache = getattr(eng, "prefix_cache", None)
            if cache is not None:
                entry["prefix_cache"] = cache.stats()
            per_replica.append(entry)
        return {
            "num_slots": sum(e["num_slots"] for e in per_replica),
            "active": sum(e["active"] for e in per_replica),
            "max_len": int(getattr(self.engine, "max_len", 0)),
            "fleet": {
                "replicas": len(self._replicas),
                **fleet_counters,
                "router": self.router.stats(),
                "per_replica": per_replica,
            },
        }
