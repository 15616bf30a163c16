"""Supervised engine recovery: health state, watchdog, bounded-backoff rebuild.

The port's copy of ``unionml_tpu/serving/supervisor.py:47-340`` for one
:class:`~unionml_tpu_torch.serving.continuous.DecodeEngine` behind a
:class:`~unionml_tpu_torch.serving.continuous.ContinuousBatcher`, with its
telemetry hooks (health transitions, engine failures, rebuilds); ``GET
/healthz`` serves its state (``serving/app.py``):

- **Health** ``ok -> degraded -> rebuilding -> ok`` on a recovered fault,
  ``rebuilding -> failed`` when the rebuild budget is spent.
- **Watchdog**: the engine stamps a heartbeat at every dispatch and fetch; a
  background thread (or a synchronous :meth:`EngineSupervisor.check` in
  tests) trips when the engine is busy and the heartbeat is older than
  ``stall_timeout_s``: the wedged-queue shape no exception reports.
- **Bounded exponential backoff**: :meth:`EngineSupervisor.run_rebuild`
  retries ``engine.rebuild()`` up to ``max_rebuild_attempts`` times; when it
  gives up, the batcher fails every pending request with a structured
  :class:`~unionml_tpu_torch.serving.faults.EngineFailure`.

The supervisor owns policy and counters only: the engine salvages and
rebuilds, the batcher moves the requests.
"""

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.faults import EngineFailure

__all__ = ["EngineSupervisor", "HEALTH_STATES"]

#: the health states, in degrading order
HEALTH_STATES = ("ok", "degraded", "rebuilding", "failed")


class EngineSupervisor:
    """Health, watchdog and rebuild policy for one supervised engine.

    :param stall_timeout_s: heartbeat staleness (while the engine is busy)
        that trips the watchdog and degrades health.
    :param watchdog_interval_s: the watchdog thread's period; ``0`` runs no
        thread (tests call :meth:`check`).
    :param max_rebuild_attempts: rebuild attempts per incident before ``failed``.
    :param backoff_s: attempt ``k`` sleeps ``backoff_s * 2**(k-1)`` before the
        next, capped at ``backoff_max_s``.
    :param telemetry: optional :class:`~unionml_tpu_torch.serving.telemetry.Telemetry`;
        every record site runs outside the supervisor's lock.
    """

    def __init__(
        self,
        *,
        stall_timeout_s: float = 5.0,
        watchdog_interval_s: float = 0.5,
        max_rebuild_attempts: int = 3,
        backoff_s: float = 0.05,
        backoff_max_s: float = 2.0,
        time_fn: Callable[[], float] = time.monotonic,
        sleep_fn: Callable[[float], None] = time.sleep,
        telemetry: Optional[Any] = None,
    ) -> None:
        #: optional Telemetry; every record site runs OUTSIDE _lock (lock-leaf)
        self._telemetry = telemetry
        self.stall_timeout_s = float(stall_timeout_s)
        self.watchdog_interval_s = float(watchdog_interval_s)
        self.max_rebuild_attempts = max(1, int(max_rebuild_attempts))
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._time = time_fn
        self._sleep = sleep_fn
        self._lock = threading.Lock()
        self._state = "ok"  # guarded-by: _lock
        self._last_fault: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        self._stalled = False  # guarded-by: _lock
        self.watchdog_trips = 0  # guarded-by: _lock
        self.failures = 0  # guarded-by: _lock
        self.rebuilds = 0  # guarded-by: _lock
        self.rebuild_attempts = 0  # guarded-by: _lock
        self.recovered_requests = 0  # guarded-by: _lock
        self.failed_requests = 0  # guarded-by: _lock
        #: wall ms of the last failure -> ok transition
        self.last_recovery_ms: Optional[float] = None  # guarded-by: _lock
        self._failure_at: Optional[float] = None  # guarded-by: _lock
        self._engine: Optional[Any] = None
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: state-transition callbacks, registered before traffic starts
        self._subscribers: List[Callable[[str, str], None]] = []

    def subscribe(self, callback: Callable[[str, str], None]) -> None:
        """Register ``callback(old_state, new_state)``, fired outside the lock
        on every transition, on the thread that made it."""
        self._subscribers.append(callback)  # graftlint: disable=data-race -- documented contract (see docstring): append-only before traffic starts; _notify iterates a list() snapshot

    def _notify(self, old: str, new: str) -> None:
        if old == new:
            return
        if self._telemetry is not None:
            self._telemetry.health_transitions_total.inc(1.0, new)
        for callback in list(self._subscribers):
            try:
                callback(old, new)
            except Exception:
                logger.exception("supervisor state subscriber failed (%s -> %s)", old, new)

    # ------------------------------------------------------------------ health

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def healthy(self) -> bool:
        """Whether this engine should receive traffic (``ok``/``degraded``)."""
        return self.state in ("ok", "degraded")

    @property
    def last_fault(self) -> Optional[Dict[str, Any]]:
        """``{"reason", "detail", "age_s"}`` of the latest fault, or None."""
        with self._lock:
            if self._last_fault is None:
                return None
            fault = dict(self._last_fault)
        fault["age_s"] = round(self._time() - fault.pop("at"), 3)
        return fault

    def _record_fault(self, reason: str, detail: str) -> None:
        # graftlint: disable=lock-discipline -- every caller already holds _lock (the helper exists to keep the fault-record shape in one place)
        self._last_fault = {"reason": reason, "detail": detail, "at": self._time()}

    @staticmethod
    def classify(exc: BaseException) -> str:
        """Machine-readable reason for an engine-side exception: the injection
        site, a structured ``reason``, ``device_oom`` for a CUDA allocation
        failure, ``cuda_error`` for another error the CUDA runtime raised
        (an illegal address leaves the context unusable: every rebuild then
        fails and the supervisor ends ``failed``), else ``device_failure``."""
        site = getattr(exc, "site", None)
        if site is not None:
            return f"injected_{site}"
        reason = getattr(exc, "reason", None)
        if reason is not None:
            return str(reason)
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return "device_oom"
        if isinstance(exc, RuntimeError) and ("CUDA" in str(exc) or "cuda" in str(exc)):
            return "cuda_error"
        return "device_failure"

    # ----------------------------------------------------------- failure flow

    def note_failure(self, exc: BaseException) -> None:
        """An engine failure was caught: record it and enter ``rebuilding``."""
        with self._lock:
            self.failures += 1
            self._failure_at = self._time()
            self._record_fault(self.classify(exc), str(exc))
            old = self._state
            if self._state != "failed":
                self._state = "rebuilding"
            new = self._state
        self._notify(old, new)
        if self._telemetry is not None:
            self._telemetry.engine_failures_total.inc(1.0, self.classify(exc))
        logger.warning("engine failure (%s): entering recovery", self.classify(exc))

    def run_rebuild(self, rebuild: Callable[[], None]) -> bool:
        """Drive ``rebuild()`` with bounded exponential backoff: True on
        success (health ``ok``), False once every attempt failed (``failed``)."""
        for attempt in range(1, self.max_rebuild_attempts + 1):
            with self._lock:
                self.rebuild_attempts += 1
            try:
                rebuild()
            except Exception as exc:
                logger.warning("engine rebuild attempt %d/%d failed: %s", attempt, self.max_rebuild_attempts, exc)
                with self._lock:
                    self._record_fault(self.classify(exc), f"rebuild failed: {exc}")
                if attempt == self.max_rebuild_attempts:
                    break
                self._sleep(min(self.backoff_s * (2 ** (attempt - 1)), self.backoff_max_s))
                continue
            with self._lock:
                self.rebuilds += 1
                old = self._state
                self._state = "ok"
                self._note_recovery_time()
            self._notify(old, "ok")
            if self._telemetry is not None:
                self._telemetry.rebuilds_total.inc()
            logger.info("engine rebuilt (attempt %d/%d)", attempt, self.max_rebuild_attempts)
            return True
        with self._lock:
            old = self._state
            self._state = "failed"
        self._notify(old, "failed")
        logger.error("engine rebuild exhausted %d attempts; supervisor state FAILED", self.max_rebuild_attempts)
        return False

    def _note_recovery_time(self) -> None:
        # every caller holds _lock
        if self._failure_at is not None:
            self.last_recovery_ms = (self._time() - self._failure_at) * 1e3  # graftlint: disable=lock-discipline -- every caller already holds _lock
            self._failure_at = None  # graftlint: disable=lock-discipline -- every caller already holds _lock

    def note_rebuilt(self) -> None:
        """The engine rebuilt itself in place at fault time: count it and
        return to ``ok``."""
        with self._lock:
            self.rebuilds += 1
            old = self._state
            if self._state == "rebuilding":
                self._state = "ok"
            new = self._state
            self._note_recovery_time()
        self._notify(old, new)
        if self._telemetry is not None:
            self._telemetry.rebuilds_total.inc()

    def note_recovered(self, n: int = 1) -> None:
        """Count requests resumed across a rebuild."""
        with self._lock:
            self.recovered_requests += int(n)

    def note_request_failed(self, n: int = 1) -> None:
        """Count requests an engine failure ended (structured, not hung)."""
        with self._lock:
            self.failed_requests += int(n)

    def unavailable_error(self) -> EngineFailure:
        """The structured error a request gets while the engine cannot serve."""
        state = self.state
        return EngineFailure(f"engine is {state}", reason="engine_failed" if state == "failed" else "engine_rebuilding",
                             retryable=state != "failed")

    # -------------------------------------------------------------- watchdog

    def attach(self, engine: Any) -> None:
        """Bind the engine and start the watchdog thread (when
        ``watchdog_interval_s`` > 0). The owning batcher calls this once."""
        self._engine = engine  # graftlint: disable=data-race -- attach() runs once at construction; Thread.start() below orders this write before every _watch read
        if self.watchdog_interval_s > 0 and self._watchdog is None:
            self._watchdog = threading.Thread(target=self._watch, name="engine-watchdog", daemon=True)
            self._watchdog.start()

    def _watch(self) -> None:
        while not self._stop.wait(self.watchdog_interval_s):
            try:
                self.check()
            except Exception:  # the watchdog outlives any probe error
                logger.exception("engine watchdog check failed")

    def check(self, now: Optional[float] = None) -> bool:
        """One watchdog evaluation: trips once per stall episode when the
        engine is busy and its heartbeat is older than ``stall_timeout_s``;
        ``degraded`` returns to ``ok`` when the heartbeat freshens. Returns
        whether a stall is observed now."""
        engine = self._engine
        if engine is None:
            return False
        now = self._time() if now is None else now
        heartbeat = getattr(engine, "last_heartbeat", None)
        busy = bool(getattr(engine, "busy", False))
        stalled = busy and heartbeat is not None and (now - heartbeat) > self.stall_timeout_s
        with self._lock:
            old = self._state
            if stalled and not self._stalled:
                self._stalled = True
                self.watchdog_trips += 1
                self._record_fault("watchdog_stall", f"no engine heartbeat for {now - heartbeat:.3f}s while busy")
                if self._state == "ok":
                    self._state = "degraded"
                logger.warning("engine watchdog tripped: heartbeat stale while busy")
            elif not stalled and self._stalled:
                self._stalled = False
                if self._state == "degraded":
                    self._state = "ok"
            new = self._state
        self._notify(old, new)
        return stalled

    def close(self) -> None:
        """Stop the watchdog thread."""
        self._stop.set()
        watchdog = self._watchdog
        if watchdog is not None and watchdog.is_alive():
            watchdog.join(timeout=2.0)

    # ------------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """Health and recovery counters."""
        with self._lock:
            return {
                "health": self._state,
                "failures": self.failures,
                "rebuilds": self.rebuilds,
                "rebuild_attempts": self.rebuild_attempts,
                "watchdog_trips": self.watchdog_trips,
                "recovered_requests": self.recovered_requests,
                "failed_requests": self.failed_requests,
                "last_recovery_ms": None if self.last_recovery_ms is None else round(self.last_recovery_ms, 3),
            }
