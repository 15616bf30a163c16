"""Seeded synthetic workload generators for the fleet simulator.

The port's copy of ``unionml_tpu/sim/traces.py``.
One :func:`generate_requests` call turns a :class:`SyntheticConfig` into a
deterministic arrival-ordered request list exhibiting the phenomena that
actually stress a serving fleet:

- **Diurnal rate curve**: arrivals are a thinned Poisson process whose
  instantaneous rate follows ``1 + diurnal_amplitude · sin(...)`` over the
  run, so the autoscaler sees a morning ramp, a peak, and a trough.
- **Bursts**: every ``burst_every_s`` the rate multiplies by
  ``burst_factor`` for ``burst_len_s`` — the flash-crowd that tests
  shedding and scale-up latency.
- **Heavy-tail lengths**: prompt and budget are lognormal (the right tail
  is what fills block pools and starves slots).
- **Hot-prefix skew**: each request prepends one of ``hot_prefixes``
  shared system-prompt blocks chosen Zipf-style, so router prefix
  affinity has something real to exploit; prefix token tuples are shared
  objects (memory stays flat at a million users).
- **Session churn**: users hold multi-turn sessions (geometric turn
  count); each turn reuses the session id so router stickiness and
  session-expiry sweeps are exercised.
- **Replica deaths**: an explicit :class:`ReplicaDeath` schedule for
  failover drills.

Everything derives from one ``random.Random(seed)`` — same config, same
requests, bit for bit.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["ReplicaDeath", "SimRequest", "SyntheticConfig", "generate_requests"]


@dataclass(frozen=True)
class ReplicaDeath:
    """Kill ``replica`` at virtual time ``at_s`` (permanent — the drill is
    failover adoption + re-routing, not supervisor rebuild timing)."""

    at_s: float
    replica: int


@dataclass(frozen=True)
class SimRequest:
    """One synthetic arrival (prompt tokens are ints < 256 so CPython
    interns them — a million-user trace stays in small memory)."""

    arrival_s: float
    session_id: str
    prompt: Tuple[int, ...]
    budget: int
    cls: str
    deadline_ms: Optional[float]
    speculative: bool = False


def _default_class_mix() -> Dict[str, float]:
    return {"interactive": 0.5, "standard": 0.35, "batch": 0.15}


def _default_deadlines() -> Dict[str, Optional[float]]:
    # wall budgets by class; batch runs open-ended
    return {"interactive": 2_000.0, "standard": 10_000.0, "batch": None}


@dataclass(frozen=True)
class SyntheticConfig:
    """Workload shape knobs (see module docstring for what each models).

    ``users`` is the session population; each user opens sessions whose
    turn counts are geometric with mean ``mean_turns``, so total requests
    ≈ ``users · mean_turns``. ``arrival_rate_per_s`` of ``None`` spreads
    that total uniformly-by-curve over ``duration_s``.
    """

    users: int = 1000
    duration_s: float = 600.0
    mean_turns: float = 1.5
    arrival_rate_per_s: Optional[float] = None
    diurnal_amplitude: float = 0.5
    burst_every_s: float = 0.0  # 0 disables bursts
    burst_len_s: float = 5.0
    burst_factor: float = 3.0
    prompt_len_median: float = 24.0
    prompt_len_sigma: float = 0.6  # lognormal sigma (heavy right tail)
    max_prompt_len: int = 512
    budget_median: float = 16.0
    budget_sigma: float = 0.7
    max_budget: int = 512
    hot_prefixes: int = 8
    hot_prefix_blocks: int = 4  # shared system-prompt length, in blocks
    zipf_a: float = 1.2  # hot-prefix popularity skew (>1; higher = hotter head)
    block_size: int = 4
    class_mix: Dict[str, float] = field(default_factory=_default_class_mix)
    deadline_ms_by_class: Dict[str, Optional[float]] = field(
        default_factory=_default_deadlines
    )
    # classes served speculatively (mirrors SchedulerConfig.speculative_classes:
    # the ITL play is for latency-sensitive traffic; the flag only has an
    # effect when the CostModel's spec_alpha term is enabled)
    speculative_classes: Tuple[str, ...] = ("interactive",)
    deaths: Tuple[ReplicaDeath, ...] = ()
    seed: int = 0

    def __post_init__(self) -> None:
        if self.users < 1:
            raise ValueError(f"users must be >= 1, got {self.users}")
        if self.duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {self.duration_s}")
        if self.mean_turns < 1.0:
            raise ValueError(f"mean_turns must be >= 1, got {self.mean_turns}")
        if not self.class_mix or any(w < 0 for w in self.class_mix.values()):
            raise ValueError("class_mix must be non-empty with non-negative weights")


def _rate_multiplier(config: SyntheticConfig, t: float) -> float:
    """Instantaneous arrival-rate multiplier at virtual time ``t`` (peaks
    mid-run; floored at 0.05 so the trough never fully silences traffic)."""
    phase = t / config.duration_s  # one diurnal cycle per run
    rate = 1.0 + config.diurnal_amplitude * math.sin(2.0 * math.pi * (phase - 0.25))
    if config.burst_every_s > 0 and (t % config.burst_every_s) < config.burst_len_s:
        rate *= config.burst_factor
    return max(0.05, rate)


def _zipf_weights(n: int, a: float) -> List[float]:
    weights = [1.0 / (rank ** a) for rank in range(1, n + 1)]
    total = sum(weights)
    return [w / total for w in weights]


def generate_requests(config: SyntheticConfig) -> List[SimRequest]:
    """The deterministic arrival-ordered request list for ``config``."""
    rng = random.Random(config.seed)
    # shared hot-prefix token tuples (one per popularity rank); ids < 256
    # (CPython interns small ints — a million-user trace stays in small
    # memory) drawn via randbytes, which is ~10x randrange per token
    prefix_len = config.hot_prefix_blocks * config.block_size
    prefixes = [
        tuple(rng.randbytes(prefix_len)) for _ in range(max(1, config.hot_prefixes))
    ]
    prefix_weights = _zipf_weights(len(prefixes), config.zipf_a)
    classes = list(config.class_mix)
    class_weights = [config.class_mix[c] for c in classes]

    # --- arrival times: thinned homogeneous Poisson over the rate curve ---
    turns_per_user = [
        1 + _geometric_extra_turns(rng, config.mean_turns) for _ in range(config.users)
    ]
    total = sum(turns_per_user)
    if config.arrival_rate_per_s is not None:
        base_rate = config.arrival_rate_per_s
    else:
        base_rate = total / config.duration_s
    peak = base_rate * (1.0 + config.diurnal_amplitude) * max(1.0, config.burst_factor)
    arrivals: List[float] = []
    t = 0.0
    while len(arrivals) < total:
        t += rng.expovariate(peak)
        if t >= config.duration_s:
            # wrap: the curve is periodic over the run, so restarting keeps
            # the target count without biasing toward the run's tail
            t = t % config.duration_s
        if rng.random() < _rate_multiplier(config, t) / (
            (1.0 + config.diurnal_amplitude) * max(1.0, config.burst_factor)
        ):
            arrivals.append(t)
    arrivals.sort()

    # --- sessions: assign consecutive arrivals of a user's session ---
    requests: List[SimRequest] = []
    arrival_iter = iter(arrivals)
    for user in range(config.users):
        turns = turns_per_user[user]
        session_id = f"u{user}"
        prefix = prefixes[_weighted_index(rng, prefix_weights)]
        cls = classes[_weighted_index(rng, class_weights)]
        for turn in range(turns):
            try:
                arrival = next(arrival_iter)
            except StopIteration:
                break
            suffix_len = min(
                config.max_prompt_len - len(prefix),
                max(1, int(rng.lognormvariate(
                    math.log(config.prompt_len_median), config.prompt_len_sigma
                ))),
            )
            # per-turn unique tail (ids < 256, same interning note as above)
            suffix = tuple(rng.randbytes(max(1, suffix_len)))
            budget = min(
                config.max_budget,
                max(1, int(rng.lognormvariate(
                    math.log(config.budget_median), config.budget_sigma
                ))),
            )
            requests.append(
                SimRequest(
                    arrival_s=arrival,
                    session_id=session_id,
                    prompt=prefix + suffix,
                    budget=budget,
                    cls=cls,
                    deadline_ms=config.deadline_ms_by_class.get(cls),
                    speculative=cls in config.speculative_classes,
                )
            )
    requests.sort(key=lambda r: r.arrival_s)
    return requests


def _geometric_extra_turns(rng: random.Random, mean_turns: float) -> int:
    """Extra turns beyond the first, geometric with mean ``mean_turns - 1``."""
    extra_mean = mean_turns - 1.0
    if extra_mean <= 0:
        return 0
    p = 1.0 / (1.0 + extra_mean)
    count = 0
    while rng.random() > p and count < 64:
        count += 1
    return count


def _weighted_index(rng: random.Random, weights: List[float]) -> int:
    pick = rng.random() * sum(weights)
    acc = 0.0
    for index, weight in enumerate(weights):
        acc += weight
        if pick <= acc:
            return index
    return len(weights) - 1
