"""Shared metrics registry with Prometheus text exposition.

The port's copy of ``unionml_tpu/serving/metrics.py`` (standard library
only): for the same operations :meth:`MetricsRegistry.render` prints the
same bytes.

One process-wide :class:`MetricsRegistry` backs every serving module's
headline counters (routing decisions, sheds, rebuilds, cache hits,
tokens in/out) plus the latency histograms (TTFT, ITL, queue wait per
class, decode-burst fetch time). Modules keep their private
``stats()``-shaped counters — those are API surface pinned by tests —
and mirror the headline mutations into the registry at the same sites.

Lock discipline: the registry owns ONE lock and it is a LEAF — no
registry method calls out to user code or any other serving component,
so recording is safe from inside or outside any caller's critical
section (callers still record outside their own locks by convention,
keeping graftlint's lock-order rule trivially clean). No third-party
client library: the exposition renderer is ~40 lines of the stable
`Prometheus text format
<https://prometheus.io/docs/instrumenting/exposition_formats/>`_, which
keeps the container dependency-free.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "log_buckets",
]

#: label-values key for the unlabelled child of a metric
_NO_LABELS: Tuple[str, ...] = ()


def log_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """Geometric histogram bucket upper bounds: ``start * factor**i``.

    Log-spaced buckets give constant *relative* error across decades —
    the right shape for latencies, where 1 ms and 1 s both matter.
    ``+Inf`` is implicit (every histogram gets it).
    """
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(f"log_buckets({start}, {factor}, {count}): need start>0, factor>1, count>=1")
    return tuple(start * factor**i for i in range(count))


def _format_value(v: float) -> str:
    """Render a sample value the way Prometheus expects (no exponent noise)."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_suffix(names: Sequence[str], values: Sequence[str], extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    """Base: a named family of label-keyed children. Registry-lock guarded."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str, labels: Sequence[str] = ()) -> None:
        self._registry = registry
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        #: label-values tuple -> child state; guarded-by: registry._lock
        self._children: Dict[Tuple[str, ...], object] = {}

    def _key(self, label_values: Sequence[str]) -> Tuple[str, ...]:
        if len(label_values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {len(label_values)} values"
            )
        return tuple(str(v) for v in label_values)


class Counter(_Metric):
    """Monotonically increasing count (``_total`` naming convention)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        with self._registry._lock:
            key = self._key(labels)
            self._children[key] = self._children.get(key, 0.0) + amount  # type: ignore[operator]

    def value(self, *labels: str) -> float:
        with self._registry._lock:
            return float(self._children.get(self._key(labels), 0.0))  # type: ignore[arg-type]

    def _render(self, out: List[str]) -> None:
        for key, v in sorted(self._children.items()):
            out.append(f"{self.name}{_labels_suffix(self.label_names, key)} {_format_value(float(v))}")  # type: ignore[arg-type]

    def _snapshot(self) -> object:
        if not self.label_names:
            return float(self._children.get(_NO_LABELS, 0.0))  # type: ignore[arg-type]
        return {",".join(k): float(v) for k, v in sorted(self._children.items())}  # type: ignore[arg-type]


class Gauge(_Metric):
    """Point-in-time value; supports ``set`` and ``inc``/``dec``."""

    kind = "gauge"

    def set(self, value: float, *labels: str) -> None:
        with self._registry._lock:
            self._children[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        with self._registry._lock:
            key = self._key(labels)
            self._children[key] = self._children.get(key, 0.0) + amount  # type: ignore[operator]

    def dec(self, amount: float = 1.0, *labels: str) -> None:
        self.inc(-amount, *labels)

    def value(self, *labels: str) -> float:
        with self._registry._lock:
            return float(self._children.get(self._key(labels), 0.0))  # type: ignore[arg-type]

    _render = Counter._render
    _snapshot = Counter._snapshot


class _HistChild:
    __slots__ = ("counts", "total", "count")

    def __init__(self, nbuckets: int) -> None:
        self.counts = [0] * (nbuckets + 1)  # +1 for the implicit +Inf bucket
        self.total = 0.0
        self.count = 0


class Histogram(_Metric):
    """Cumulative histogram with fixed upper bounds (Prometheus semantics).

    ``observe`` is O(log buckets) via bisection; render emits the
    canonical ``_bucket{le=...}`` cumulative series plus ``_sum`` and
    ``_count``. Use :func:`log_buckets` for latency-shaped bounds.
    """

    kind = "histogram"

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        help: str,
        buckets: Sequence[float],
        labels: Sequence[str] = (),
    ) -> None:
        super().__init__(registry, name, help, labels)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"{name}: histogram needs at least one bucket bound")
        if len(set(bounds)) != len(bounds):
            raise ValueError(f"{name}: duplicate bucket bounds")
        self.buckets = bounds

    def observe(self, value: float, *labels: str) -> None:
        v = float(value)
        with self._registry._lock:
            key = self._key(labels)
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _HistChild(len(self.buckets))
            # linear scan beats bisect for the ~20-bucket latency shapes here
            idx = len(self.buckets)
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    idx = i
                    break
            child.counts[idx] += 1  # type: ignore[union-attr]
            child.total += v  # type: ignore[union-attr]
            child.count += 1  # type: ignore[union-attr]

    def _render(self, out: List[str]) -> None:
        for key, child in sorted(self._children.items()):
            cum = 0
            for bound, n in zip(self.buckets, child.counts):  # type: ignore[union-attr]
                cum += n
                le = _labels_suffix(self.label_names, key, f'le="{_format_value(bound)}"')
                out.append(f"{self.name}_bucket{le} {cum}")
            cum += child.counts[-1]  # type: ignore[union-attr]
            le = _labels_suffix(self.label_names, key, 'le="+Inf"')
            out.append(f"{self.name}_bucket{le} {cum}")
            suffix = _labels_suffix(self.label_names, key)
            out.append(f"{self.name}_sum{suffix} {_format_value(child.total)}")  # type: ignore[union-attr]
            out.append(f"{self.name}_count{suffix} {cum}")

    def _snapshot(self) -> object:
        def one(child: _HistChild) -> dict:
            n = child.count
            return {
                "count": n,
                "sum": round(child.total, 3),
                "mean_ms": round(child.total / n, 3) if n else 0.0,
            }

        if not self.label_names:
            child = self._children.get(_NO_LABELS)
            return one(child) if child is not None else {"count": 0, "sum": 0.0, "mean_ms": 0.0}  # type: ignore[arg-type]
        return {",".join(k): one(c) for k, c in sorted(self._children.items())}  # type: ignore[arg-type]


class MetricsRegistry:
    """Create-once, record-many metric family registry.

    ``counter``/``gauge``/``histogram`` are idempotent on name (the
    existing family is returned, with a type check), so independent
    modules can declare the metrics they record without coordinating
    creation order. ``render()`` produces the Prometheus text
    exposition; ``snapshot()`` a JSON-friendly dict for ``/stats``.
    """

    def __init__(self) -> None:
        #: the one LEAF lock guarding all metric state (see module docstring)
        self._lock = threading.Lock()  # lock-leaf
        #: name -> metric family; guarded-by: _lock
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labels: Sequence[str], **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {type(existing).__name__}"
                        f" with labels {existing.label_names}"
                    )
                return existing
            metric = cls(self, name, help, labels=labels, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str, labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)  # type: ignore[return-value]

    def gauge(self, name: str, help: str, labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)  # type: ignore[return-value]

    def histogram(
        self, name: str, help: str, buckets: Sequence[float], labels: Sequence[str] = ()
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets)  # type: ignore[return-value]

    def render(self) -> str:
        """The `/metrics` payload: Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                metric = self._metrics[name]
                lines.append(f"# HELP {name} {metric.help}")
                lines.append(f"# TYPE {name} {metric.kind}")
                metric._render(lines)
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, object]:
        """JSON-friendly view of every family (backs the `/stats` telemetry block)."""
        with self._lock:
            return {name: m._snapshot() for name, m in sorted(self._metrics.items())}
