"""Replica-count autoscaler scored against the scheduler's own signals.

The port's copy of ``unionml_tpu/sim/autoscaler.py``.
The policy consumes exactly what the fleet already exports — each
replica's :meth:`~unionml_tpu_torch.serving.scheduler.SLOScheduler.load_signal`
(queue depth, queue-wait EMAs, paged-pool occupancy) plus the fleet-wide
shed rate — and emits an integer replica delta. It is deliberately pure
host arithmetic with an injected clock so the SAME object runs inside the
discrete-event simulator (where it is validated against static
provisioning) and against a live fleet's signals.

Scale-up triggers on ANY pressure source (queue-wait EMA above target,
block-pool pressure above threshold, or live shedding): these fail at
different times — the pool saturates before queue waits move when decodes
are long, shedding spikes before either on a flash crowd. Scale-down
requires EVERY signal comfortable AND a sustained trajectory (consecutive
calm ticks), because adding a replica is cheap but removing one discards
a warm radix cache. Both directions respect ``cooldown_s`` so the policy
cannot flap on its own control lag, and scale-up cooldown is waived when
shedding is active (dropping traffic now outweighs smoothing).

On scale-up the caller should warm the new replica's router index from
:meth:`~unionml_tpu_torch.serving.fleet.Router.hot_digests` (see
``Router.warm_replica``) — a cold affinity index repels exactly the
traffic that would warm it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

__all__ = ["Autoscaler", "AutoscalerConfig"]


@dataclass(frozen=True)
class AutoscalerConfig:
    """Thresholds and pacing for :class:`Autoscaler`.

    :param min_replicas: floor (never scale below).
    :param max_replicas: ceiling (never scale above).
    :param target_queue_wait_ms: mean per-replica queue-wait EMA above which
        the fleet is considered behind.
    :param low_queue_wait_ms: EMA below which a replica is a scale-down
        candidate (hysteresis: well under the target).
    :param pool_pressure_high: block-pool pressure (1 − reclaimable
        fraction) above which paged replicas are memory-bound.
    :param shed_rate_high: sheds/s fleet-wide above which capacity is
        actively dropping traffic (waives the scale-up cooldown).
    :param cooldown_s: minimum time between scaling actions.
    :param calm_ticks: consecutive comfortable evaluations required before
        a scale-down (trajectory, not a single quiet sample).
    :param warm_digests: how many hot prefix digests to seed into a new
        replica's router index on scale-up.
    """

    min_replicas: int = 1
    max_replicas: int = 8
    target_queue_wait_ms: float = 250.0
    low_queue_wait_ms: float = 50.0
    pool_pressure_high: float = 0.85
    shed_rate_high: float = 0.5
    cooldown_s: float = 30.0
    calm_ticks: int = 3
    warm_digests: int = 128

    def __post_init__(self) -> None:
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )
        if self.low_queue_wait_ms >= self.target_queue_wait_ms:
            raise ValueError("low_queue_wait_ms must sit below target_queue_wait_ms")


class Autoscaler:
    """Single-threaded policy object: call :meth:`decide` on a fixed tick.

    Not thread-safe by design — the simulator ticks it on the virtual
    clock; a live deployment ticks it from one control loop.
    """

    def __init__(self, config: Optional[AutoscalerConfig] = None) -> None:
        self.config = config or AutoscalerConfig()
        self._last_action_t: Optional[float] = None
        self._calm_streak = 0
        # lifetime counters (sim report / live stats)
        self.ups = 0
        self.downs = 0
        self.holds = 0

    def decide(
        self,
        now: float,
        signals: Sequence[Dict[str, Any]],
        shed_rate_per_s: float = 0.0,
    ) -> int:
        """Return the replica delta (+1, −1, or 0) for this tick.

        ``signals`` is one ``load_signal()`` dict per ACTIVE replica;
        ``shed_rate_per_s`` is the fleet's shed throughput since the last
        tick. The caller applies the delta (and the router warm-up).
        """
        cfg = self.config
        n = len(signals)
        if n == 0:
            return 0
        # an idle replica's queue-wait EMA is FROZEN at whatever the last
        # storm left there (EMAs only update on pops), so score a replica's
        # wait only while something is actually queued on it — otherwise a
        # replica that stopped receiving traffic pins the fleet "behind"
        # forever and scale-down never fires
        waits = [
            (s.get("queue_wait_ema_ms") or 0.0) if (s.get("depth") or 0) > 0 else 0.0
            for s in signals
        ]
        mean_wait = sum(waits) / n
        pressures = []
        for s in signals:
            pool = s.get("pool")
            if pool:
                pressures.append(float(pool.get("pressure", 0.0)))
        max_pressure = max(pressures) if pressures else 0.0
        behind = (
            mean_wait > cfg.target_queue_wait_ms
            or max_pressure > cfg.pool_pressure_high
            or shed_rate_per_s > cfg.shed_rate_high
        )
        comfortable = (
            mean_wait < cfg.low_queue_wait_ms
            and max_pressure < cfg.pool_pressure_high / 2.0
            and shed_rate_per_s == 0.0
        )
        self._calm_streak = self._calm_streak + 1 if comfortable else 0
        in_cooldown = (
            self._last_action_t is not None
            and now - self._last_action_t < cfg.cooldown_s
        )
        if behind and n < cfg.max_replicas:
            # shedding waives the cooldown: smoothing is pointless while
            # requests are being dropped on the floor
            if not in_cooldown or shed_rate_per_s > cfg.shed_rate_high:
                self._last_action_t = now
                self._calm_streak = 0
                self.ups += 1
                return 1
        elif (
            self._calm_streak >= cfg.calm_ticks
            and n > cfg.min_replicas
            and not in_cooldown
        ):
            self._last_action_t = now
            self._calm_streak = 0
            self.downs += 1
            return -1
        self.holds += 1
        return 0

    def stats(self) -> Dict[str, int]:
        return {"ups": self.ups, "downs": self.downs, "holds": self.holds}
