"""Schedules: cron-expression and fixed-rate job specs + an in-framework cron engine.

A copy of ``unionml_tpu/schedule.py`` (it imports no JAX; the port keeps its own).
Reference parity: ``unionml/schedule.py:22-123`` — the ``Schedule`` dataclass and the
exactly-one-of cron/fixed-rate validation of ``create_scheduled_launchplan``. The
reference delegates actual firing to Flyte; here the execution backend owns a scheduler
loop (:mod:`unionml_tpu_torch.backend`) driven by :func:`next_fire_time`, a self-contained
5-field cron evaluator (no croniter dependency).
"""

import calendar
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from enum import Enum
from typing import List, Optional, Set, Union

from unionml_tpu_torch.exceptions import ScheduleError


class ScheduleType(Enum):
    """Allowable schedule types (``schedule.py:12-19``)."""

    trainer = "trainer"
    predictor = "predictor"


#: croniter-style keyword aliases supported by the reference docs
CRON_ALIASES = {
    "@hourly": "0 * * * *",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@weekly": "0 0 * * 0",
    "@monthly": "0 0 1 * *",
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
}


@dataclass
class Schedule:
    """Spec for a recurring training or batch-prediction job (``schedule.py:22-64``)."""

    type: Union[str, ScheduleType]
    name: str
    expression: Optional[str] = None
    offset: Optional[str] = None
    fixed_rate: Optional[timedelta] = None
    time_arg: Optional[str] = None
    inputs: Optional[dict] = None
    activate_on_deploy: bool = True
    launchplan_kwargs: Optional[dict] = None

    def __post_init__(self):
        if isinstance(self.type, str):
            self.type = ScheduleType[self.type]

    def validate(self) -> None:
        """Exactly one of expression / fixed_rate must be given (``schedule.py:98-101``)."""
        if self.expression is not None and self.fixed_rate is not None:
            raise ScheduleError("You must specify exactly one of 'expression' or 'fixed_rate', not both.")
        if self.expression is None and self.fixed_rate is None:
            raise ScheduleError("You must specify exactly one of 'expression' or 'fixed_rate'.")
        if self.expression is not None:
            parse_cron(self.expression)  # raises on malformed expressions

    @property
    def workflow_kind(self) -> str:
        return "train" if self.type == ScheduleType.trainer else "predict"


def _parse_field(spec: str, lo: int, hi: int, names: Optional[dict] = None) -> Set[int]:
    """Parse one cron field: ``*``, ``*/n``, ``a-b``, ``a-b/n``, lists, names."""
    values: Set[int] = set()
    for part in spec.split(","):
        step = 1
        has_step = False
        if "/" in part:
            part, step_s = part.split("/", 1)
            has_step = True
            try:
                step = int(step_s)
            except ValueError as exc:
                raise ScheduleError(f"Invalid cron step {step_s!r}") from exc
            if step <= 0:
                raise ScheduleError(f"Cron step must be positive, got {step}")
        if names:
            part = names.get(part.lower(), part)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            if names:
                a, b = names.get(a.lower(), a), names.get(b.lower(), b)
            try:
                start, end = int(a), int(b)
            except ValueError as exc:
                raise ScheduleError(f"Invalid cron range {part!r}") from exc
        else:
            try:
                start = end = int(part)
            except ValueError as exc:
                raise ScheduleError(f"Invalid cron value {part!r}") from exc
            if has_step:
                # standard cron/croniter semantics: 'N/step' means the range N-hi
                # stepped, e.g. minute '5/15' fires at 5,20,35,50 — not just 5
                end = hi
        if not (lo <= start <= hi and lo <= end <= hi and start <= end):
            raise ScheduleError(f"Cron value {part!r} out of range [{lo}, {hi}]")
        values.update(range(start, end + 1, step))
    return values


_DOW_NAMES = {name.lower(): str(i) for i, name in enumerate(("sun", "mon", "tue", "wed", "thu", "fri", "sat"))}
_MONTH_NAMES = {name.lower(): str(i) for i, name in enumerate(calendar.month_abbr) if name}


class CronSpec:
    """A parsed 5-field cron expression."""

    def __init__(self, minutes: Set[int], hours: Set[int], days: Set[int], months: Set[int], weekdays: Set[int]):
        self.minutes, self.hours, self.days, self.months, self.weekdays = minutes, hours, days, months, weekdays

    def matches(self, ts: datetime) -> bool:
        # cron semantics: when both day-of-month and day-of-week are restricted, either may match
        cron_dow = (ts.weekday() + 1) % 7  # python Mon=0 -> cron Sun=0
        dom_restricted = self.days != set(range(1, 32))
        dow_restricted = self.weekdays != set(range(0, 7))
        if dom_restricted and dow_restricted:
            day_ok = ts.day in self.days or cron_dow in self.weekdays
        else:
            day_ok = ts.day in self.days and cron_dow in self.weekdays
        return ts.minute in self.minutes and ts.hour in self.hours and ts.month in self.months and day_ok


def parse_cron(expression: str) -> CronSpec:
    """Parse a cron expression or keyword alias into a :class:`CronSpec`."""
    expression = CRON_ALIASES.get(expression.strip(), expression.strip())
    parts = expression.split()
    if len(parts) != 5:
        raise ScheduleError(f"Cron expression must have 5 fields (or be a known alias); got {expression!r}")
    minute, hour, dom, month, dow = parts
    return CronSpec(
        minutes=_parse_field(minute, 0, 59),
        hours=_parse_field(hour, 0, 23),
        days=_parse_field(dom, 1, 31),
        months=_parse_field(month, 1, 12, names=_MONTH_NAMES),
        weekdays={v % 7 for v in _parse_field(dow, 0, 7, names=_DOW_NAMES)},
    )


def parse_iso_duration(value: str) -> timedelta:
    """Parse an ISO 8601 duration (``P[nD]T[nH][nM][nS]`` subset) into a timedelta.

    The reference's schedule ``offset`` field takes ISO 8601 durations
    (``unionml/schedule.py:39-44``); weeks/days/hours/minutes/seconds cover cron-offset
    use cases (months/years are ill-defined offsets and rejected).
    """
    import re

    match = re.fullmatch(
        r"P(?:(?P<weeks>\d+(?:\.\d+)?)W)?(?:(?P<days>\d+(?:\.\d+)?)D)?"
        r"(?:T(?:(?P<hours>\d+(?:\.\d+)?)H)?(?:(?P<minutes>\d+(?:\.\d+)?)M)?(?:(?P<seconds>\d+(?:\.\d+)?)S)?)?",
        value.strip(),
    )
    if not match or not any(match.groupdict().values()):
        raise ScheduleError(f"Invalid ISO 8601 duration {value!r} (months/years offsets are not supported)")
    parts = {k: float(v) for k, v in match.groupdict().items() if v}
    return timedelta(**parts)


def next_fire_time(schedule: Schedule, after: datetime) -> datetime:
    """Next time the schedule fires strictly after ``after`` (cron offset applied)."""
    schedule.validate()
    if schedule.fixed_rate is not None:
        return after + schedule.fixed_rate

    offset = parse_iso_duration(schedule.offset) if schedule.offset else timedelta()
    spec = parse_cron(schedule.expression)  # type: ignore[arg-type]
    # search in un-offset time so the returned fire time is cron-match + offset
    base = after - offset
    candidate = base.replace(second=0, microsecond=0) + timedelta(minutes=1)
    # scanning minute-by-minute is plenty for scheduler granularity; bound the search
    for _ in range(366 * 24 * 60):
        if spec.matches(candidate):
            return candidate + offset
        candidate += timedelta(minutes=1)
    raise ScheduleError(f"Cron expression {schedule.expression!r} never fires within a year")


def create_scheduled_job(
    workflow_name: str,
    name: str,
    *,
    expression: Optional[str] = None,
    offset: Optional[str] = None,
    fixed_rate: Optional[timedelta] = None,
    time_arg: Optional[str] = None,
    inputs: Optional[dict] = None,
    **launchplan_kwargs,
) -> Schedule:
    """Validate and build a deployable schedule (``schedule.py:67-123`` analogue).

    The reference returns a flytekit ``LaunchPlan``; here the backend consumes the
    :class:`Schedule` spec directly.
    """
    inputs = dict(inputs or {})
    if "fixed_inputs" in launchplan_kwargs:
        inputs.update(launchplan_kwargs.pop("fixed_inputs"))
    schedule = Schedule(
        type=ScheduleType.trainer if workflow_name.endswith(".train") else ScheduleType.predictor,
        name=name,
        expression=expression,
        offset=offset,
        fixed_rate=fixed_rate,
        time_arg=time_arg,
        inputs=inputs,
        launchplan_kwargs=launchplan_kwargs or None,
    )
    schedule.validate()
    return schedule
