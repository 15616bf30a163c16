"""Per-class serving SLOs: rolling-window attainment + multi-window burn rate.

The port's copy of ``unionml_tpu/serving/slo.py`` (standard library only).
Telemetry gives the serving tier raw spans, counters and histograms; this
module turns them into *objectives*. Each priority class carries an
:class:`SLOObjective` — a TTFT bound and an attainment target — and one
:class:`SLOTracker` folds every completed request into:

- **Rolling-window attainment** per class: the fraction of requests inside
  their objective over each configured window (plus lifetime totals).
- **Multi-window burn rate** (the SRE error-budget pattern): how many times
  faster than sustainable the class is consuming its error budget, per
  window. An *alert* fires only when EVERY window burns above
  ``alert_burn`` — the short window proves the problem is current, the long
  window proves it is material, so a blip pages nobody and a slow leak
  still does.

The tracker is deliberately engine-free pure host code with an injectable
clock on every method (``now=``), so the SAME object scores the live
``/metrics`` + ``/stats`` surface (fed by :class:`~unionml_tpu_torch.serving.
telemetry.Telemetry.end_trace`) and the fleet simulator's virtual-clock
replay/synthetic runs (:mod:`unionml_tpu_torch.sim`) — one definition of "meeting
the SLO" everywhere, which is what makes the simulator's golden-replay
equality check meaningful.

Event accounting: a request is **good** when it completed ``ok`` within its
class's TTFT bound (classes with no bound count any ``ok`` as good);
``error``/``shed`` outcomes are bad; ``cancelled`` is excluded entirely
(a client hanging up is not a server SLO violation). TTFT is compared at
millisecond precision as journaled (3 decimals), so live scoring and
journal replay can never disagree on a boundary case.

Lock discipline: the tracker owns one LEAF lock and never calls out to any
other serving component; callers (telemetry, the HTTP stats route, the
simulator) read results after the lock is released.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = [
    "DEFAULT_WINDOWS",
    "SLOConfig",
    "SLOObjective",
    "SLOTracker",
]

#: (name, seconds) rolling windows, shortest first — the classic fast/slow
#: pair: 5m catches a live incident, 1h proves it is spending real budget
DEFAULT_WINDOWS: Tuple[Tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0))


@dataclass(frozen=True)
class SLOObjective:
    """One class's objective: TTFT bound (ms; ``None`` = success-only SLO)
    and the attainment target in ``(0, 1)`` — the error budget is
    ``1 - target``."""

    ttft_ms: Optional[float]
    target: float

    def __post_init__(self) -> None:
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.ttft_ms is not None and self.ttft_ms <= 0:
            raise ValueError(f"ttft_ms must be > 0, got {self.ttft_ms}")


def _default_objectives() -> Dict[str, SLOObjective]:
    # mirrors the scheduler's PRIORITY_CLASSES; interactive is latency-bound,
    # batch only promises completion. Unknown classes fall back to standard.
    return {
        "interactive": SLOObjective(ttft_ms=250.0, target=0.99),
        "standard": SLOObjective(ttft_ms=1000.0, target=0.95),
        "batch": SLOObjective(ttft_ms=None, target=0.90),
    }


@dataclass(frozen=True)
class SLOConfig:
    """Objectives + windows + alerting threshold for one :class:`SLOTracker`.

    :param objectives: per-class :class:`SLOObjective`; classes absent here
        score against ``standard``.
    :param windows: rolling ``(name, seconds)`` windows, shortest first.
    :param alert_burn: burn-rate multiple above which a window counts toward
        the multi-window alert (the alert needs EVERY window above it).
    """

    objectives: Dict[str, SLOObjective] = field(default_factory=_default_objectives)
    windows: Tuple[Tuple[str, float], ...] = DEFAULT_WINDOWS
    alert_burn: float = 2.0

    def __post_init__(self) -> None:
        if not self.windows:
            raise ValueError("need at least one rolling window")
        if self.alert_burn <= 0:
            raise ValueError(f"alert_burn must be > 0, got {self.alert_burn}")
        if "standard" not in self.objectives:
            raise ValueError("objectives must cover the 'standard' fallback class")

    def objective_for(self, cls: str) -> SLOObjective:
        return self.objectives.get(cls, self.objectives["standard"])


class _Window:
    """One class's events inside one rolling window: a deque of
    ``(t, good)`` plus running counts, pruned on every touch so record and
    read are both amortized O(1)."""

    __slots__ = ("seconds", "events", "good", "total")

    def __init__(self, seconds: float) -> None:
        self.seconds = float(seconds)
        self.events: Deque[Tuple[float, bool]] = deque()
        self.good = 0
        self.total = 0

    def add(self, t: float, good: bool) -> None:
        self.events.append((t, good))
        self.total += 1
        if good:
            self.good += 1
        self.prune(t)

    def prune(self, now: float) -> None:
        horizon = now - self.seconds
        while self.events and self.events[0][0] < horizon:
            _, was_good = self.events.popleft()
            self.total -= 1
            if was_good:
                self.good -= 1

    def attainment(self) -> Optional[float]:
        return None if self.total == 0 else self.good / self.total


class _ClassState:
    """Lifetime totals + per-window state for one class."""

    __slots__ = ("good", "total", "windows")

    def __init__(self, windows: Tuple[Tuple[str, float], ...]) -> None:
        self.good = 0
        self.total = 0
        self.windows: Dict[str, _Window] = {name: _Window(s) for name, s in windows}


class SLOTracker:
    """Rolling SLO attainment + burn-rate scoring shared by the live serving
    surface and the fleet simulator.

    Thread-safe behind one leaf lock. Every method takes an optional ``now``
    (``time.monotonic`` when omitted) so a virtual-clock simulator and the
    live path run the identical arithmetic.
    """

    def __init__(self, config: Optional[SLOConfig] = None) -> None:
        self.config = config or SLOConfig()
        self._lock = threading.Lock()
        self._classes: Dict[str, _ClassState] = {}  # guarded-by: _lock

    # ------------------------------------------------------------------ intake

    def record(
        self,
        cls: str,
        status: str,
        ttft_ms: Optional[float] = None,
        *,
        now: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Fold one completed request in; returns the class's refreshed
        signal ``{"attainment": ..., "burn": {window: rate}}`` for the
        caller to mirror into gauges (outside this tracker's lock), or
        ``None`` when the outcome is excluded (``cancelled``)."""
        if status == "cancelled":
            return None
        now = time.monotonic() if now is None else now
        objective = self.config.objective_for(cls)
        good = status == "ok" and (
            objective.ttft_ms is None
            or (ttft_ms is not None and ttft_ms <= objective.ttft_ms)
        )
        budget = 1.0 - objective.target
        with self._lock:
            state = self._classes.get(cls)
            if state is None:
                state = self._classes[cls] = _ClassState(self.config.windows)
            state.total += 1
            if good:
                state.good += 1
            burn: Dict[str, float] = {}
            for name, window in state.windows.items():
                window.add(now, good)
                bad_frac = 1.0 - (window.good / window.total)
                burn[name] = round(bad_frac / budget, 4)
            attainment = state.windows[self.config.windows[-1][0]].attainment()
        return {"attainment": attainment, "burn": burn}

    # ----------------------------------------------------------------- readers

    def totals(self) -> Dict[str, Dict[str, int]]:
        """Lifetime ``{cls: {"good": n, "total": n}}`` — the golden-replay
        equality surface (window-free, so replay timing cannot perturb it)."""
        with self._lock:
            return {
                cls: {"good": s.good, "total": s.total}
                for cls, s in sorted(self._classes.items())
            }

    def report(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/stats`` → ``generation.slo`` block (same shape in the
        simulator's report): objectives, lifetime + per-window attainment,
        burn rates, and the multi-window alert per class."""
        now = time.monotonic() if now is None else now
        out: Dict[str, Any] = {
            "windows": {name: s for name, s in self.config.windows},
            "alert_burn": self.config.alert_burn,
            "per_class": {},
            "alerts": [],
        }
        with self._lock:
            for cls, state in sorted(self._classes.items()):
                objective = self.config.objective_for(cls)
                windows: Dict[str, Any] = {}
                burning: List[bool] = []
                for name, window in state.windows.items():
                    window.prune(now)
                    att = window.attainment()
                    if att is None:
                        burn = 0.0
                    else:
                        burn = round((1.0 - att) / (1.0 - objective.target), 4)
                    burning.append(burn >= self.config.alert_burn)
                    windows[name] = {
                        "total": window.total,
                        "good": window.good,
                        "attainment": None if att is None else round(att, 6),
                        "burn_rate": burn,
                    }
                alert = bool(burning) and all(burning)
                out["per_class"][cls] = {
                    "objective_ttft_ms": objective.ttft_ms,
                    "target": objective.target,
                    "total": state.total,
                    "good": state.good,
                    "attainment": (
                        None if state.total == 0 else round(state.good / state.total, 6)
                    ),
                    "windows": windows,
                    "alert": alert,
                }
                if alert:
                    out["alerts"].append(cls)
        return out
