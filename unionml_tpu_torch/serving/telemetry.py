"""Per-request span tracing + replayable event journal for the serving tier.

The port's copy of ``unionml_tpu/serving/telemetry.py`` (standard library
only); its journal lines are the JAX package's, field for field.

Every request admitted with telemetry enabled gets a ``request_id``-keyed
:class:`Trace`: an ordered list of :class:`Span` records covering its whole
lifetime — admission, queue wait (per class), the routing decision, prefix
cache hit/restore, each prefill chunk, decode (per-burst timing piggybacked
on the stamps of the engine's existing burst fetch: ZERO new host↔device
syncs, no ``.item()``/``.cpu()``/``.tolist()`` and no new device tensor), preemption/resume,
quarantine, engine death, and failover adoption. Completed traces land in a
bounded ring journal (``/traces/recent``, ``/trace/{request_id}``) and
optionally a JSONL sink whose schema (v2, the JAX package's
``docs/observability.md``) is the replay input format for the fleet simulator:
v2 stamps the session id and the admission-time block-pool arithmetic onto
every trace so replay needs no side channels.

Hook contract (the FaultPlan pattern): every emitting module holds an
``Optional[Telemetry]`` and guards each record site with a single host
branch — ``if self._telemetry is not None`` — so disabled telemetry costs
one pointer compare. Recording sites are LOCK-LEAF: ``Telemetry`` methods
never call out to other serving components, and callers invoke them
OUTSIDE their own critical sections, keeping graftlint's lock-order rule
at 0 findings.

Headline latency/throughput aggregates mirror into the shared
:class:`~unionml_tpu_torch.serving.metrics.MetricsRegistry` (rendered at
``/metrics``); modules' private ``stats()`` counters are unchanged API.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

from unionml_tpu_torch.serving.metrics import MetricsRegistry, log_buckets
from unionml_tpu_torch.serving.slo import SLOTracker

__all__ = [
    "JOURNAL_SCHEMA_VERSION",
    "Span",
    "Telemetry",
    "Trace",
]

#: bump when the journal JSONL schema changes shape (simulator replay input).
#: v2: top-level ``session_id``; admission spans carry ``block_demand`` +
#: ``available_blocks``; admission/queue_wait spans carry the session id.
JOURNAL_SCHEMA_VERSION = 2

#: latency bucket bounds, ms: 0.25 ms … ~16 s in ×2 steps (17 buckets)
_LATENCY_BUCKETS_MS = log_buckets(0.25, 2.0, 17)


def new_request_id() -> str:
    """A fresh 16-hex request id (also minted route-side in ``app.py``)."""
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One timed event inside a trace.

    ``t_ms`` is milliseconds since the trace started (monotonic clock);
    ``dur_ms`` is None for instantaneous markers. ``attrs`` carries
    kind-specific detail (the span taxonomy of the JAX package's
    ``docs/observability.md``) and must stay JSON-serializable.
    """

    kind: str
    t_ms: float
    dur_ms: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind, "t_ms": round(self.t_ms, 3)}
        if self.dur_ms is not None:
            out["dur_ms"] = round(self.dur_ms, 3)
        if self.attrs:
            out["attrs"] = self.attrs
        return out


@dataclass
class Trace:
    """A request's full timeline; lives in ``Telemetry`` under its lock."""

    request_id: str
    created_unix: float
    t0: float  # monotonic origin for every span's t_ms
    session_id: Optional[str] = None
    cls: str = "standard"
    status: str = "active"
    reason: Optional[str] = None
    tokens_in: int = 0
    tokens_out: int = 0
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    decode_bursts: int = 0
    spans: List[Span] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return (self.first_token_t - self.t0) * 1e3

    @property
    def itl_ms(self) -> Optional[float]:
        if self.first_token_t is None or self.last_token_t is None or self.tokens_out < 2:
            return None
        return (self.last_token_t - self.first_token_t) * 1e3 / (self.tokens_out - 1)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "v": JOURNAL_SCHEMA_VERSION,
            "request_id": self.request_id,
            "created_unix": round(self.created_unix, 6),
            "class": self.cls,
            "status": self.status,
            "tokens_in": self.tokens_in,
            "tokens_out": self.tokens_out,
            "decode_bursts": self.decode_bursts,
            "spans": [s.to_dict() for s in self.spans],
        }
        if self.session_id is not None:
            out["session_id"] = self.session_id
        if self.reason is not None:
            out["reason"] = self.reason
        ttft = self.ttft_ms
        if ttft is not None:
            out["ttft_ms"] = round(ttft, 3)
        itl = self.itl_ms
        if itl is not None:
            out["itl_ms"] = round(itl, 3)
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class Telemetry:
    """Process-wide trace collector + metrics mirror for one serving stack.

    One instance is shared by the whole request path (app → fleet → router
    → batcher → engine → scheduler/supervisor/prefix-cache/faults), so a
    request keeps ONE trace across replica failover. All methods are
    thread-safe behind a single leaf lock and never raise on unknown
    request ids (a span for a request that was never traced, or already
    journaled, is dropped) — recording must never take down serving.

    :param registry: shared :class:`MetricsRegistry`; a fresh one is
        created when omitted.
    :param journal_size: completed traces kept in the in-memory ring
        (``/traces/recent``).
    :param journal_path: optional JSONL file appended one completed trace
        per line — the fleet simulator's replay input.
    :param max_spans: per-trace span cap; beyond it spans are dropped and
        counted in ``attrs["spans_dropped"]`` (bounds runaway requests).
    :param slo: shared :class:`~unionml_tpu_torch.serving.slo.SLOTracker`; a fresh
        default-objective tracker is created when omitted, so every deployment
        shape gets the ``/metrics`` attainment/burn gauges and the
        ``generation.slo`` stats block for free.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        journal_size: int = 256,
        journal_path: Optional[str] = None,
        max_spans: int = 512,
        slo: Optional[SLOTracker] = None,
    ) -> None:
        self.metrics = registry if registry is not None else MetricsRegistry()
        #: the SLO scoring shared with /stats and the fleet simulator —
        #: end_trace feeds it one event per completed request
        self.slo = slo if slo is not None else SLOTracker()
        self._max_spans = int(max_spans)
        #: guards _active/_ring/_completed; LEAF (never calls out — see module doc)
        self._lock = threading.Lock()  # lock-leaf
        self._active: Dict[str, Trace] = {}  # guarded-by: _lock
        self._ring: Deque[Trace] = deque(maxlen=int(journal_size))  # guarded-by: _lock
        self._completed = 0  # guarded-by: _lock
        self._dropped_spans = 0  # guarded-by: _lock
        self.journal_path = journal_path
        #: serializes JSONL appends only; LEAF, never held with _lock
        self._journal_lock = threading.Lock()  # lock-leaf

        m = self.metrics
        self.requests_total = m.counter(
            "unionml_requests_total", "Completed requests by outcome", ("outcome",)
        )
        self.sheds_total = m.counter(
            "unionml_sheds_total", "Requests shed by structured reason", ("reason",)
        )
        self.tokens_in_total = m.counter("unionml_tokens_in_total", "Prompt tokens accepted")
        self.tokens_out_total = m.counter("unionml_tokens_out_total", "Tokens decoded and delivered")
        self.prefill_tokens_total = m.counter(
            "unionml_prefill_tokens_total", "Tokens run through prefill (incl. restored-suffix recompute)"
        )
        self.ttft_ms = m.histogram(
            "unionml_ttft_ms", "Time to first token, ms", _LATENCY_BUCKETS_MS, ("cls",)
        )
        self.itl_ms = m.histogram(
            "unionml_itl_ms", "Mean inter-token latency per request, ms", _LATENCY_BUCKETS_MS, ("cls",)
        )
        self.queue_wait_ms = m.histogram(
            "unionml_queue_wait_ms", "Scheduler queue wait, ms", _LATENCY_BUCKETS_MS, ("cls",)
        )
        self.decode_fetch_ms = m.histogram(
            "unionml_decode_fetch_ms",
            "Host-blocked time per fused decode-burst fetch, ms",
            _LATENCY_BUCKETS_MS,
        )
        self.route_decisions_total = m.counter(
            "unionml_route_decisions_total", "Fleet routing decisions by type", ("decision",)
        )
        self.prefix_lookups_total = m.counter(
            "unionml_prefix_lookups_total", "Prefix-cache lookups"
        )
        self.prefix_hits_total = m.counter(
            "unionml_prefix_hits_total", "Prefix-cache lookups that matched at least one block"
        )
        self.prefix_hit_tokens_total = m.counter(
            "unionml_prefix_hit_tokens_total", "Prompt tokens served from the prefix cache"
        )
        self.preemptions_total = m.counter(
            "unionml_preemptions_total", "Requests preempted to the prefix cache"
        )
        self.resumes_total = m.counter(
            "unionml_resumes_total", "Preempted/salvaged requests re-admitted"
        )
        self.quarantines_total = m.counter(
            "unionml_quarantines_total", "Slots quarantined (NaN logits)"
        )
        self.engine_failures_total = m.counter(
            "unionml_engine_failures_total", "Engine-wide failures by classified reason", ("reason",)
        )
        self.rebuilds_total = m.counter(
            "unionml_rebuilds_total", "Successful in-place engine rebuilds"
        )
        self.health_transitions_total = m.counter(
            "unionml_health_transitions_total", "Supervisor health-state transitions", ("to",)
        )
        self.failover_adoptions_total = m.counter(
            "unionml_failover_adoptions_total", "Orphaned tickets adopted by a surviving replica"
        )
        self.faults_injected_total = m.counter(
            "unionml_faults_injected_total", "Faults injected by the active FaultPlan", ("site",)
        )
        # paged KV pool occupancy: every block is owned by exactly
        # one of free list / live slot / radix index, so these three gauges
        # plus pinned (a subset of cached) give capacity headroom at a glance
        self.pool_free_blocks = m.gauge(
            "unionml_kv_pool_free_blocks", "Paged KV pool blocks on the free list"
        )
        self.pool_live_blocks = m.gauge(
            "unionml_kv_pool_live_blocks", "Paged KV pool blocks owned by live decode slots"
        )
        self.pool_cached_blocks = m.gauge(
            "unionml_kv_pool_cached_blocks", "Paged KV pool blocks held by the radix prefix index"
        )
        self.pool_pinned_blocks = m.gauge(
            "unionml_kv_pool_pinned_blocks", "Paged KV pool blocks pinned by preempt/salvage checkpoints"
        )
        # pool byte footprint: the kv_dtype label says what actually
        # crosses HBM ("int8" under kv_quantize, else the compute dtype), and
        # the dense-equivalent gauge prices the same KV positions at full
        # precision — their ratio is the capacity doubling on dashboards
        self.pool_kv_bytes = m.gauge(
            "unionml_kv_pool_bytes",
            "Paged KV pool resident bytes as stored (scale arrays included)",
            ("kv_dtype",),
        )
        self.pool_kv_bytes_dense_equiv = m.gauge(
            "unionml_kv_pool_bytes_dense_equiv",
            "Same KV pool positions priced at the full compute dtype",
        )
        # info gauge (value pinned to 1): the impl label names the paged
        # attention path the engine's programs run — "kernel" (the hand-written
        # CUDA kernel) or "reference" (the plain PyTorch version).
        # Fleet operators fan this out to see which replicas run the kernel.
        self.paged_attn_impl = m.gauge(
            "unionml_paged_attn_impl",
            "Selected paged decode-attention backend (info gauge, value=1)",
            ("impl",),
        )
        self.blocks_per_request = m.histogram(
            "unionml_kv_blocks_per_request",
            "Pool blocks allocated per admitted request (paged engines)",
            log_buckets(1.0, 2.0, 12),
        )
        # per-class SLO surface: attainment over the longest
        # configured rolling window, and the error-budget burn rate per
        # (class, window) — the same numbers the generation.slo stats block
        # and the simulator's report read from the shared SLOTracker
        self.slo_attainment = m.gauge(
            "unionml_slo_attainment",
            "Rolling-window SLO attainment fraction per class",
            ("cls",),
        )
        self.slo_burn_rate = m.gauge(
            "unionml_slo_burn_rate",
            "Error-budget burn rate per class and rolling window",
            ("cls", "window"),
        )
        # speculative decoding: acceptance EMA per SLO class and the
        # live mean γ tell at a glance whether speculation is paying (α high,
        # γ ramped) or has adaptively degraded to vanilla (γ → 0); the raw
        # proposed/accepted counters give the exact accepted-tokens-per-
        # target-step the bench gates on: (accepted + rounds) / rounds
        self.spec_acceptance = m.gauge(
            "unionml_spec_acceptance",
            "Speculative acceptance EMA (mean over live speculative slots) per class",
            ("cls",),
        )
        self.spec_gamma = m.gauge(
            "unionml_spec_gamma",
            "Current adaptive gamma (mean over live speculative slots)",
        )
        self.spec_proposed_total = m.counter(
            "unionml_spec_proposed_total",
            "Draft tokens proposed by speculative rounds",
        )
        self.spec_accepted_total = m.counter(
            "unionml_spec_accepted_total",
            "Draft proposals accepted by target verification",
        )

    # ------------------------------------------------------------------ traces

    def new_trace(
        self,
        request_id: Optional[str] = None,
        *,
        cls: str = "standard",
        session_id: Optional[str] = None,
        **attrs: Any,
    ) -> str:
        """Open (or join) the trace for ``request_id``; returns the id.

        Idempotent on an already-active id — the fleet opens the trace
        before routing and the replica batcher joins it, so failover
        keeps one trace across engines. Re-opening refreshes nothing but
        merges ``attrs`` (and sets ``session_id`` when newly provided —
        the fleet knows it, the replica batcher does not).
        """
        rid = request_id if request_id else new_request_id()
        with self._lock:
            trace = self._active.get(rid)
            if trace is None:
                trace = Trace(
                    request_id=rid,
                    created_unix=time.time(),
                    t0=time.perf_counter(),
                    cls=cls,
                )
                self._active[rid] = trace
            if session_id is not None:
                trace.session_id = session_id
            if attrs:
                trace.attrs.update(attrs)
            if cls != "standard":
                trace.cls = cls
        return rid

    def set_class(self, request_id: Optional[str], cls: str) -> None:
        if request_id is None:
            return
        with self._lock:
            trace = self._active.get(request_id)
            if trace is not None:
                trace.cls = cls

    def span(
        self,
        request_id: Optional[str],
        kind: str,
        *,
        dur_ms: Optional[float] = None,
        at: Optional[float] = None,
        **attrs: Any,
    ) -> None:
        """Append a span to an active trace (no-op for unknown/ended ids).

        ``at`` is an optional ``time.perf_counter()`` stamp for spans whose
        event happened earlier than the record call (the engine buffers
        slot-keyed spans until the batcher binds the slot's request id)."""
        if request_id is None:
            return
        now = time.perf_counter() if at is None else at
        with self._lock:
            trace = self._active.get(request_id)
            if trace is None:
                return
            if len(trace.spans) >= self._max_spans:
                self._dropped_spans += 1
                trace.attrs["spans_dropped"] = trace.attrs.get("spans_dropped", 0) + 1
                return
            span_attrs = dict(attrs)
            if trace.session_id is not None and kind in ("admission", "queue_wait"):
                # journal v2: the replay loader reads the session off these
                # spans directly (emitters below the fleet never see it)
                span_attrs.setdefault("session_id", trace.session_id)
            trace.spans.append(Span(kind, (now - trace.t0) * 1e3, dur_ms, span_attrs))

    def note_tokens_in(self, request_id: Optional[str], n: int) -> None:
        self.tokens_in_total.inc(n)
        if request_id is None:
            return
        with self._lock:
            trace = self._active.get(request_id)
            if trace is not None:
                trace.tokens_in = int(n)

    def decode_tokens(
        self,
        request_id: Optional[str],
        n: int,
        *,
        at: Optional[float] = None,
        block_ms: Optional[float] = None,
    ) -> None:
        """Record ``n`` tokens surfacing from one fused decode-burst fetch.

        ``at`` is the fetch's existing ``time.perf_counter()`` completion
        stamp and ``block_ms`` its already-measured host-blocked time —
        both piggyback on measurements the engine takes anyway, so the
        decode path pays no new host↔device syncs for tracing.
        """
        self.tokens_out_total.inc(n)
        if block_ms is not None:
            self.decode_fetch_ms.observe(block_ms)
        if request_id is None:
            return
        t = at if at is not None else time.perf_counter()
        first: Optional[Trace] = None
        with self._lock:
            trace = self._active.get(request_id)
            if trace is None:
                return
            trace.tokens_out += int(n)
            trace.decode_bursts += 1
            trace.last_token_t = t
            if trace.first_token_t is None:
                trace.first_token_t = t
                first = trace
        if first is not None:
            ttft = first.ttft_ms
            if ttft is not None:
                self.ttft_ms.observe(ttft, first.cls)

    def end_trace(
        self,
        request_id: Optional[str],
        status: str = "ok",
        *,
        reason: Optional[str] = None,
        **attrs: Any,
    ) -> None:
        """Complete a trace: journal it and observe its latency aggregates.

        A trace survives preemption, quarantine-of-siblings, engine death,
        and failover — only terminal delivery (tokens, structured error,
        or shed) ends it. Ending an unknown id is a no-op.
        """
        if request_id is None:
            return
        now = time.perf_counter()
        with self._lock:
            trace = self._active.pop(request_id, None)
            if trace is None:
                return
            trace.status = status
            trace.reason = reason
            if attrs:
                trace.attrs.update(attrs)
            dur = (now - trace.t0) * 1e3
            if trace.tokens_out > 0 and trace.first_token_t is not None:
                # one aggregated decode span per request (per-burst detail
                # would be unbounded); timing reuses the fused-fetch stamps
                last = trace.last_token_t if trace.last_token_t is not None else trace.first_token_t
                trace.spans.append(
                    Span(
                        "decode",
                        (trace.first_token_t - trace.t0) * 1e3,
                        (last - trace.first_token_t) * 1e3,
                        {"tokens": trace.tokens_out, "bursts": trace.decode_bursts},
                    )
                )
            trace.spans.append(Span("end", dur, None, {"status": status} if reason is None else {"status": status, "reason": reason}))
            self._ring.append(trace)
            self._completed += 1
        self.requests_total.inc(1.0, status)
        itl = trace.itl_ms
        if itl is not None:
            self.itl_ms.observe(itl, trace.cls)
        # SLO scoring: TTFT compared at the journal's 3-decimal precision so
        # live gauges and a simulator replay of this journal line can never
        # disagree on a boundary case; gauges are set OUTSIDE both the
        # tracker's and this object's lock (all three are leaves)
        ttft = trace.ttft_ms
        signal = self.slo.record(
            trace.cls, status, None if ttft is None else round(ttft, 3)
        )
        if signal is not None:
            if signal["attainment"] is not None:
                self.slo_attainment.set(signal["attainment"], trace.cls)
            for window, burn in signal["burn"].items():
                self.slo_burn_rate.set(burn, trace.cls, window)
        if self.journal_path is not None:
            line = json.dumps(trace.to_dict(), separators=(",", ":"))
            try:
                with self._journal_lock, open(self.journal_path, "a") as fh:
                    fh.write(line + "\n")
            except OSError:  # journal loss must never take down serving
                pass

    # ---------------------------------------------------------------- readers

    def get_trace(self, request_id: str) -> Optional[Dict[str, Any]]:
        """The span tree for one request — active traces included."""
        with self._lock:
            trace = self._active.get(request_id)
            if trace is None:
                for t in self._ring:
                    if t.request_id == request_id:
                        trace = t
                        break
            return trace.to_dict() if trace is not None else None

    def recent(self, n: int = 50) -> List[Dict[str, Any]]:
        """The most recently completed traces, newest last."""
        with self._lock:
            items = list(self._ring)[-int(n):]
            return [t.to_dict() for t in items]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active_traces": len(self._active),
                "completed_traces": self._completed,
                "journal_depth": len(self._ring),
                "journal_path": self.journal_path,
                "spans_dropped": self._dropped_spans,
            }

    def assert_balanced(self, *, allow_active: bool = False) -> None:
        """Tests-only invariant check: every completed trace is terminated.

        The dynamic twin of the static ``trace`` resource rule
        (``new_trace`` must reach ``end_trace`` on every path): each trace in
        the completed ring must carry exactly one terminal ``"end"`` span, it
        must be the last span, and the trace status must no longer be
        ``"active"``. Unless ``allow_active`` is set, no trace may still be
        open in ``_active`` — a leftover entry means some code path acquired
        a trace and never ended it.

        Wired into test teardowns; never call this from serving paths.
        """
        with self._lock:
            for trace in self._ring:
                ends = [i for i, s in enumerate(trace.spans) if s.kind == "end"]
                if len(ends) != 1:
                    raise AssertionError(
                        f"trace {trace.request_id!r} has {len(ends)} 'end' "
                        f"spans (want exactly 1)"
                    )
                if ends[0] != len(trace.spans) - 1:
                    raise AssertionError(
                        f"trace {trace.request_id!r} has spans after 'end': "
                        f"{[s.kind for s in trace.spans[ends[0] + 1:]]}"
                    )
                if trace.status == "active":
                    raise AssertionError(
                        f"completed trace {trace.request_id!r} still marked "
                        f"'active'"
                    )
            if not allow_active and self._active:
                raise AssertionError(
                    "unterminated traces at teardown: "
                    f"{sorted(self._active)} — every new_trace() must reach "
                    f"end_trace()"
                )
