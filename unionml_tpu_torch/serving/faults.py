"""Deterministic fault injection and the structured engine-failure error.

The port's copy of ``unionml_tpu/serving/faults.py:43-237`` (numpy only),
with its telemetry mirror (``unionml_faults_injected_total`` by site).

- :class:`FaultPlan` is a schedule-addressable fault script: "fail the 3rd
  step dispatch", "NaN slot 1's logits after dispatch 5", "raise on the 2nd
  prefill", "stall the 4th token fetch 300 ms", "exhaust the block pool on
  the 2nd admission", "fail the first 2 rebuilds". The engine consults it at
  each site behind ``if self._faults is not None``: a plan-less engine pays
  one host branch per site and no device work.
- :class:`FaultError` is what an injected fault raises; the handlers take it
  through the same paths as a real device error.
- :class:`EngineFailure` is the structured error a request receives.

Every index is 1-based against a per-site counter, so the same plan against
the same request schedule injects at the same operations; ``seed`` drives the
optional Bernoulli storm (``step_failure_rate``). A plan belongs to one
engine's worker thread.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["EngineFailure", "FaultError", "FaultPlan"]


class FaultError(RuntimeError):
    """An injected device-side fault; ``site`` names the injection site
    (``step_dispatch``, ``step_fetch``, ``prefill``, ``rebuild``, ...)."""

    def __init__(self, message: str, *, site: str) -> None:
        super().__init__(message)
        self.site = site


class EngineFailure(RuntimeError):
    """A structured engine-side failure delivered to a request.

    ``reason`` is a machine-readable slug (``pool_exhausted``, ``nan_logits``,
    ``prefill_failed``, ``engine_failure``, ``engine_failed``,
    ``request_unrecoverable``, ``batcher_closed``, ...); ``retryable`` states
    whether a client retry can plausibly succeed.
    """

    def __init__(self, message: str, *, reason: str, retryable: bool = True) -> None:
        super().__init__(message)
        self.reason = reason
        self.retryable = retryable


@dataclasses.dataclass
class FaultPlan:
    """A deterministic, schedule-addressable fault-injection script.

    :param step_dispatch_failures: decode dispatch indexes that raise
        :class:`FaultError` instead of dispatching.
    :param step_fetch_failures: token-fetch indexes that raise at the fetch,
        after the burst ran (the deferred-error shape).
    :param prefill_failures: prefill dispatch indexes that raise.
    :param nan_logits: ``(step_dispatch_index, slot)`` pairs: after that
        dispatch the slot's sampling logits are overwritten with NaN, so the
        next step's finiteness flag trips and the slot is quarantined.
    :param fetch_stalls: ``(fetch_index, stall_ms)`` pairs: sleep before that
        fetch (a wedged device queue, for the supervisor's watchdog).
    :param pool_exhausted_admits: ``admit_many`` call indexes during which the
        radix index behaves fully referenced (nothing new is indexed).
    :param rebuild_failures: fail this many rebuild attempts first.
    :param speculative_round_failures: ``SpeculativeBatcher`` round indexes
        that raise.
    :param step_failure_rate: seeded Bernoulli dispatch-failure probability.
    :param seed: seeds that storm.
    """

    step_dispatch_failures: Sequence[int] = ()
    step_fetch_failures: Sequence[int] = ()
    prefill_failures: Sequence[int] = ()
    nan_logits: Sequence[Tuple[int, int]] = ()
    fetch_stalls: Sequence[Tuple[int, float]] = ()
    pool_exhausted_admits: Sequence[int] = ()
    rebuild_failures: int = 0
    speculative_round_failures: Sequence[int] = ()
    step_failure_rate: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        #: optional Telemetry mirror for the injected-fault counter (attach with
        #: ``plan.telemetry = tel``); consulted behind ``is not None`` only
        self.telemetry = None
        self._rng = np.random.default_rng(self.seed)
        self._dispatches = 0
        self._fetches = 0
        self._prefills = 0
        self._admits = 0
        self._rebuilds = 0
        self._spec_rounds = 0
        self._admit_depth = 0
        self._nan_by_step: Dict[int, List[int]] = {}
        for step, slot in self.nan_logits:
            self._nan_by_step.setdefault(int(step), []).append(int(slot))
        self._stall_by_fetch = {int(i): float(ms) for i, ms in self.fetch_stalls}
        #: faults that fired, by site
        self.injected: Dict[str, int] = {}
        #: injected faults the serving stack handled (quarantines, absorbed exhaustion)
        self.observed: Dict[str, int] = {}

    def _count(self, site: str, n: int = 1) -> None:
        self.injected[site] = self.injected.get(site, 0) + n
        if self.telemetry is not None:
            self.telemetry.faults_injected_total.inc(float(n), site)

    def _fire(self, site: str, message: str) -> None:
        self._count(site)
        raise FaultError(message, site=site)

    def check_step_dispatch(self) -> None:
        """Count a decode dispatch; raise when it is scheduled to fail (or the storm fires)."""
        self._dispatches += 1
        if self._dispatches in set(self.step_dispatch_failures):
            self._fire("step_dispatch", f"injected step-dispatch failure #{self._dispatches}")
        if self.step_failure_rate > 0 and self._rng.random() < self.step_failure_rate:
            self._fire("step_dispatch", f"injected storm step failure #{self._dispatches}")

    def take_nan_slots(self) -> List[int]:
        """Slots whose sampling logits the engine poisons after the dispatch just counted."""
        slots = self._nan_by_step.pop(self._dispatches, [])
        if slots:
            self._count("nan_logits", len(slots))
        return slots

    def check_fetch(self) -> None:
        """Count a token fetch; raise when it is scheduled to fail."""
        self._fetches += 1
        if self._fetches in set(self.step_fetch_failures):
            self._fire("step_fetch", f"injected token-fetch failure #{self._fetches}")

    def take_fetch_stall_ms(self) -> Optional[float]:
        """The stall (ms) keyed by the fetches counted so far, or ``None``
        (the engine sleeps it before :meth:`check_fetch`, as JAX's does)."""
        ms = self._stall_by_fetch.pop(self._fetches, None)
        if ms is not None:
            self._count("fetch_stall")
        return ms

    def check_prefill(self) -> None:
        """Count a prefill dispatch; raise when it is scheduled to fail."""
        self._prefills += 1
        if self._prefills in set(self.prefill_failures):
            self._fire("prefill", f"injected prefill failure #{self._prefills}")

    def begin_admit(self) -> None:
        """Enter an ``admit_many`` call (the outermost entry counts one admission)."""
        if self._admit_depth == 0:
            self._admits += 1
            if self._admits in set(self.pool_exhausted_admits):
                self._count("pool_exhausted")
        self._admit_depth += 1

    def end_admit(self) -> None:
        self._admit_depth = max(0, self._admit_depth - 1)

    def pool_exhausted(self) -> bool:
        """Whether the radix index must behave fully referenced right now."""
        return self._admit_depth > 0 and self._admits in set(self.pool_exhausted_admits)

    def check_rebuild(self) -> None:
        """Count a rebuild attempt; raise while scheduled rebuild failures remain."""
        self._rebuilds += 1
        if self._rebuilds <= int(self.rebuild_failures):
            self._fire("rebuild", f"injected rebuild failure #{self._rebuilds}")

    def check_speculative_round(self) -> None:
        """Count a speculative round; raise when it is scheduled to fail."""
        self._spec_rounds += 1
        if self._spec_rounds in set(self.speculative_round_failures):
            self._fire("speculative_round", f"injected speculative-round failure #{self._spec_rounds}")

    def note_observed(self, kind: str) -> None:
        """Count one injected fault the serving stack handled."""
        self.observed[kind] = self.observed.get(kind, 0) + 1

    def stats(self) -> Dict[str, Dict[str, int]]:
        """``{"injected": ..., "observed": ...}``."""
        return {"injected": dict(self.injected), "observed": dict(self.observed)}
