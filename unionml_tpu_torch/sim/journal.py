"""Versioned loader for the serving telemetry journal (JSONL, one trace/line).

The port's copy of ``unionml_tpu/sim/journal.py``.
The journal is written by :class:`~unionml_tpu_torch.serving.telemetry.Telemetry`
(``journal_path=``); its schema version rides on every record as ``"v"``.
This module is the ONLY place the simulator touches raw journal bytes, so
schema evolution is absorbed here:

- **v1**: request_id / class / status / tokens / spans; admission
  spans carry prompt_tokens + budget only.
- **v2**: adds top-level ``session_id`` and admission-span
  ``block_demand`` + ``available_blocks`` (the paged-KV arithmetic at
  admission time), and the ``queue_wait`` span carries ``cls``. v1 records
  load fine — the new fields default to ``None`` and replay simply cannot
  validate block accounting for them.

Unknown FUTURE versions are rejected loudly: silently misreading a v3
journal would poison a replay validation, which is the one thing this
loader must never do.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "SUPPORTED_JOURNAL_VERSIONS",
    "JournalRecord",
    "load_journal",
    "parse_journal_record",
]

#: journal schema versions this loader understands (see module docstring)
SUPPORTED_JOURNAL_VERSIONS: Tuple[int, ...] = (1, 2)


@dataclass(frozen=True)
class JournalRecord:
    """One completed request as journaled — the simulator's unit of replay.

    ``spans`` is the raw span list (dicts) in emission order; the
    convenience accessors below pull out the fields replay and cost-model
    fitting need, returning ``None`` when a span or attribute is absent
    (v1 journals, dense engines, sheds that never queued).
    """

    version: int
    request_id: str
    created_unix: float
    cls: str
    status: str
    tokens_in: int
    tokens_out: int
    reason: Optional[str] = None
    session_id: Optional[str] = None
    ttft_ms: Optional[float] = None
    itl_ms: Optional[float] = None
    spans: List[Dict[str, Any]] = field(default_factory=list)

    def first_span(self, kind: str) -> Optional[Dict[str, Any]]:
        """The first span of ``kind`` (emission order), or ``None``."""
        for span in self.spans:
            if span.get("kind") == kind:
                return span
        return None

    def span_count(self, kind: str) -> int:
        """How many spans of ``kind`` the trace carries (preemptions etc.)."""
        return sum(1 for span in self.spans if span.get("kind") == kind)

    def _admission_attr(self, name: str) -> Optional[Any]:
        span = self.first_span("admission")
        if span is None:
            return None
        return span.get("attrs", {}).get(name)

    @property
    def queue_wait_ms(self) -> Optional[float]:
        span = self.first_span("queue_wait")
        return None if span is None else span.get("dur_ms")

    @property
    def block_demand(self) -> Optional[int]:
        """Blocks the request needed at admission (v2, paged engines)."""
        value = self._admission_attr("block_demand")
        return None if value is None else int(value)

    @property
    def available_blocks(self) -> Optional[int]:
        """Counter-derived reclaimable blocks observed at admission (v2)."""
        value = self._admission_attr("available_blocks")
        return None if value is None else int(value)

    @property
    def deadline_ms(self) -> Optional[float]:
        value = self._admission_attr("deadline_ms")
        return None if value is None else float(value)

    @property
    def replica(self) -> Optional[int]:
        """The fleet replica the request was routed to (solo: ``None``)."""
        span = self.first_span("route")
        if span is None:
            return None
        value = span.get("attrs", {}).get("replica")
        return None if value is None else int(value)


def parse_journal_record(obj: Dict[str, Any]) -> JournalRecord:
    """Build a :class:`JournalRecord` from one decoded journal line.

    Accepts every version in :data:`SUPPORTED_JOURNAL_VERSIONS` (records
    with no ``"v"`` at all are treated as v1 — the field predates the
    versioning convention by zero releases, but a truncated writer should
    not brick a replay). Raises ``ValueError`` for future versions or
    records missing the required identity fields.
    """
    if not isinstance(obj, dict):
        raise ValueError(f"journal record must be an object, got {type(obj).__name__}")
    version = int(obj.get("v", 1))
    if version not in SUPPORTED_JOURNAL_VERSIONS:
        raise ValueError(
            f"unsupported journal schema v{version} "
            f"(supported: {list(SUPPORTED_JOURNAL_VERSIONS)}); "
            "refusing to misread a future journal"
        )
    try:
        request_id = str(obj["request_id"])
        status = str(obj["status"])
    except KeyError as missing:
        raise ValueError(f"journal record missing required field {missing}") from None
    spans = obj.get("spans") or []
    if not isinstance(spans, list):
        raise ValueError(f"journal spans must be a list, got {type(spans).__name__}")
    return JournalRecord(
        version=version,
        request_id=request_id,
        created_unix=float(obj.get("created_unix", 0.0)),
        cls=str(obj.get("class", "standard")),
        status=status,
        tokens_in=int(obj.get("tokens_in", 0)),
        tokens_out=int(obj.get("tokens_out", 0)),
        reason=obj.get("reason"),
        session_id=obj.get("session_id"),  # v2; absent in v1
        ttft_ms=None if obj.get("ttft_ms") is None else float(obj["ttft_ms"]),
        itl_ms=None if obj.get("itl_ms") is None else float(obj["itl_ms"]),
        spans=spans,
    )


def load_journal(path: str) -> List[JournalRecord]:
    """Parse a journal JSONL file into records (emission order preserved).

    Blank lines are skipped; a malformed line raises with its line number —
    replay validation on a corrupt journal must fail, not shrug.
    """
    records: List[JournalRecord] = []
    with open(path, "r", encoding="utf-8") as handle:
        for lineno, line in enumerate(handle, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(parse_journal_record(json.loads(line)))
            except (ValueError, json.JSONDecodeError) as exc:
                raise ValueError(f"{path}:{lineno}: bad journal line: {exc}") from exc
    return records
