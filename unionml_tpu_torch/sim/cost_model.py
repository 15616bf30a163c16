"""Latency cost model for the fleet simulator, fittable from a real journal.

The port's copy of ``unionml_tpu/sim/cost_model.py``. The defaults are
placeholders that :func:`fit_cost_model` replaces from a journal.
The simulator advances a virtual clock; this module decides by how much.
A :class:`CostModel` prices the three timed phases the journal decomposes
a request into:

- **prefill**: affine in prompt tokens (``prefill_base_ms`` +
  ``prefill_ms_per_token`` · tokens_in) — the base term absorbs dispatch
  and bucket-padding overheads that do not scale with length.
- **decode**: one inter-token latency per generated token, optionally
  per class (``itl_ms_by_class``) — batch traffic often decodes alongside
  fuller batches and measures slower than interactive.
- **dispatch**: fixed per-admission overhead (slot bind + first dispatch).

Speculative decoding enters as a multiplicative ITL scale, α-parameterized
after the standard speculative-sampling analysis: a round of γ draft
proposals plus one verify emits ``E[tokens] = (1 − α^(γ+1)) / (1 − α)``
tokens per target step (α the per-token acceptance rate) at relative cost
``γ·ρ + 1`` (ρ the draft/target step-cost ratio), so a speculative
request's ITL scales by ``(γ·ρ + 1) / E[tokens]``. The scale is clamped
at 1.0 because the production engine's γ is *adaptive* — acceptance EMAs
below threshold decay γ to 0 (vanilla decode), so speculation never runs
slower than the baseline; a static-γ model would not earn that clamp.

:func:`fit_cost_model` estimates all of it from journaled ``ok`` records
using medians (robust to the heavy right tail every serving latency
distribution has): prefill compute per request is recovered as
``ttft_ms − queue_wait`` — both journaled per record — then the affine
fit splits records at the median prompt length and solves the two-point
slope between group medians. Too few records (< ``_MIN_FIT_RECORDS``
usable) falls back to the conservative defaults rather than fitting
noise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from unionml_tpu_torch.sim.journal import JournalRecord

__all__ = ["CostModel", "fit_cost_model"]

_MIN_FIT_RECORDS = 8


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return float(ordered[mid])
    return (ordered[mid - 1] + ordered[mid]) / 2.0


@dataclass(frozen=True)
class CostModel:
    """Virtual-clock phase costs (milliseconds). See the module docstring
    for what each term prices; defaults approximate a small paged CPU
    engine and are replaced wholesale by :func:`fit_cost_model` when a
    journal is available."""

    prefill_base_ms: float = 5.0
    prefill_ms_per_token: float = 0.15
    itl_ms: float = 8.0
    itl_ms_by_class: Dict[str, float] = field(default_factory=dict)
    dispatch_ms: float = 1.0
    spec_alpha: float = 0.0  # 0 disables the speculative term entirely
    spec_alpha_by_class: Dict[str, float] = field(default_factory=dict)
    spec_gamma: int = 4
    spec_draft_cost_ratio: float = 0.15  # ρ: draft step cost / target step cost

    def __post_init__(self) -> None:
        for name, value in (
            ("prefill_base_ms", self.prefill_base_ms),
            ("prefill_ms_per_token", self.prefill_ms_per_token),
            ("itl_ms", self.itl_ms),
            ("dispatch_ms", self.dispatch_ms),
            ("spec_draft_cost_ratio", self.spec_draft_cost_ratio),
        ):
            if value < 0:
                raise ValueError(f"{name} must be >= 0, got {value}")
        for cls, alpha in [(None, self.spec_alpha)] + list(
            self.spec_alpha_by_class.items()
        ):
            if not 0.0 <= alpha < 1.0:
                where = f"spec_alpha_by_class[{cls!r}]" if cls else "spec_alpha"
                raise ValueError(f"{where} must be in [0, 1), got {alpha}")
        if self.spec_gamma < 0:
            raise ValueError(f"spec_gamma must be >= 0, got {self.spec_gamma}")

    def prefill_ms(self, tokens_in: int) -> float:
        return self.prefill_base_ms + self.prefill_ms_per_token * max(0, int(tokens_in))

    def ttft_compute_ms(self, tokens_in: int) -> float:
        """Admission-to-first-token compute (excludes queue wait, which the
        real scheduler measures for itself inside the simulator)."""
        return self.dispatch_ms + self.prefill_ms(tokens_in)

    def spec_itl_scale(self, cls: str = "standard") -> float:
        """ITL multiplier for a speculative request of class ``cls``:
        ``min(1, (γ·ρ + 1) / E[tokens])`` with
        ``E[tokens] = (1 − α^(γ+1)) / (1 − α)`` — the clamp models the
        engine's adaptive γ decaying to vanilla on hostile traffic."""
        alpha = self.spec_alpha_by_class.get(cls, self.spec_alpha)
        if alpha <= 0.0 or self.spec_gamma == 0:
            return 1.0
        expected_tokens = (1.0 - alpha ** (self.spec_gamma + 1)) / (1.0 - alpha)
        round_cost = self.spec_gamma * self.spec_draft_cost_ratio + 1.0
        return min(1.0, round_cost / expected_tokens)

    def decode_ms(
        self, tokens_out: int, cls: str = "standard", speculative: bool = False
    ) -> float:
        itl = self.itl_ms_by_class.get(cls, self.itl_ms)
        if speculative:
            itl *= self.spec_itl_scale(cls)
        # first token is priced by prefill; each FURTHER token costs one ITL
        return itl * max(0, int(tokens_out) - 1)

    def service_ms(
        self,
        tokens_in: int,
        tokens_out: int,
        cls: str = "standard",
        speculative: bool = False,
    ) -> float:
        """Slot-occupancy time for one admitted request (no queue wait)."""
        return self.ttft_compute_ms(tokens_in) + self.decode_ms(
            tokens_out, cls, speculative
        )


def fit_cost_model(
    records: Sequence[JournalRecord], default: Optional[CostModel] = None
) -> CostModel:
    """Fit a :class:`CostModel` from journaled completions (see module
    docstring for the estimators). ``default`` supplies every term the
    journal cannot support (too few records, no ITL data for a class)."""
    default = default or CostModel()
    # (tokens_in, compute_ms): ttft minus measured queue wait, floored at 0
    points: List[Tuple[int, float]] = []
    itl_by_class: Dict[str, List[float]] = {}
    for rec in records:
        if rec.status != "ok":
            continue
        if rec.itl_ms is not None:
            itl_by_class.setdefault(rec.cls, []).append(rec.itl_ms)
        if rec.ttft_ms is None:
            continue
        wait = rec.queue_wait_ms or 0.0
        points.append((rec.tokens_in, max(0.0, rec.ttft_ms - wait)))
    if len(points) < _MIN_FIT_RECORDS:
        return default
    split = _median([float(n) for n, _ in points])
    short = [(n, ms) for n, ms in points if n <= split]
    long = [(n, ms) for n, ms in points if n > split]
    if short and long:
        n_short = _median([float(n) for n, _ in short])
        n_long = _median([float(n) for n, _ in long])
        ms_short = _median([ms for _, ms in short])
        ms_long = _median([ms for _, ms in long])
        if n_long > n_short:
            slope = max(0.0, (ms_long - ms_short) / (n_long - n_short))
        else:
            slope = default.prefill_ms_per_token
        base = max(0.0, ms_short - slope * n_short)
    else:
        # all prompts the same length: the slope is unobservable — keep the
        # default slope and absorb the rest into the base
        slope = default.prefill_ms_per_token
        base = max(0.0, _median([ms for _, ms in points]) - slope * points[0][0])
    itl_fit = {cls: round(_median(vals), 4) for cls, vals in itl_by_class.items() if vals}
    all_itl = [v for vals in itl_by_class.values() for v in vals]
    return CostModel(
        prefill_base_ms=round(max(0.0, base - default.dispatch_ms), 4),
        prefill_ms_per_token=round(slope, 6),
        itl_ms=round(_median(all_itl), 4) if all_itl else default.itl_ms,
        itl_ms_by_class=itl_fit,
        dispatch_ms=default.dispatch_ms,
        # journals do not record acceptance; the speculative term rides the
        # defaults through so a CLI-chosen alpha survives the fit
        spec_alpha=default.spec_alpha,
        spec_alpha_by_class=default.spec_alpha_by_class,
        spec_gamma=default.spec_gamma,
        spec_draft_cost_ratio=default.spec_draft_cost_ratio,
    )
