"""SARIF 2.1.0 output for graftlint (GitHub code-scanning compatible).

One ``run`` per lint invocation: the tool section carries the full rule
catalog (so code-scanning renders per-rule help), each active finding becomes
a ``level: error`` result, each baselined finding a ``level: note`` result,
and each suppressed finding a result carrying an ``inSource`` suppression with
the author's reason — the reasoned-suppression inventory survives into the
code-scanning UI instead of vanishing at the CLI boundary.

``partialFingerprints`` uses the same line-independent fingerprint as the
``--baseline`` mechanism, so code-scanning alert identity is stable across
unrelated edits.
"""

from pathlib import Path
from typing import Dict, List

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"

#: always present in the catalog even though it registers no check() (the
#: comment parser emits it directly)
_META_RULES = {
    "suppression": "graftlint comments must name known rules and carry a reason",
    "parse": "files that do not parse cannot be linted",
}


def _artifact_uri(path: str) -> str:
    """Repo-relative forward-slash URI; absolute paths keep their tail."""
    p = Path(path)
    if p.is_absolute():
        try:
            p = p.relative_to(Path.cwd())
        except ValueError:
            pass
    return p.as_posix()


def _result(finding, rule_index: Dict[str, int], level: str, occurrence: int) -> Dict:
    out = {
        "ruleId": finding.rule,
        "ruleIndex": rule_index.get(finding.rule, -1),
        "level": level,
        "message": {"text": finding.message + (f" [{finding.symbol}]" if finding.symbol else "")},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {"uri": _artifact_uri(finding.path)},
                    "region": {
                        "startLine": max(1, finding.line),
                        # SARIF columns are 1-based; ast's are 0-based
                        "startColumn": finding.col + 1,
                    },
                }
            }
        ],
        "partialFingerprints": {"graftlint/v1": finding.fingerprint(occurrence)},
    }
    if finding.suppressed:
        out["suppressions"] = [
            {"kind": "inSource", "justification": finding.reason or ""}
        ]
    return out


def to_sarif(result) -> Dict:
    """Build the SARIF document for one :class:`~...core.LintResult`."""
    from unionml_tpu_torch.analysis.core import REPORT_VERSION, RULES

    catalog: List[Dict] = []
    rule_index: Dict[str, int] = {}
    names = sorted(set(RULES) | set(_META_RULES))
    for i, name in enumerate(names):
        rule_index[name] = i
        summary = RULES[name].summary if name in RULES else _META_RULES[name]
        catalog.append(
            {
                "id": name,
                "name": name.replace("-", "_"),
                "shortDescription": {"text": summary},
                "defaultConfiguration": {"level": "error"},
            }
        )

    results: List[Dict] = []
    occurrences: Dict = {}

    def occ(finding) -> int:
        key = (finding.rule, finding.path, finding.symbol)
        n = occurrences.get(key, 0)
        occurrences[key] = n + 1
        return n

    for finding in result.findings:
        results.append(_result(finding, rule_index, "error", occ(finding)))
    for finding in result.baselined:
        results.append(_result(finding, rule_index, "note", occ(finding)))
    for finding in result.suppressed:
        results.append(_result(finding, rule_index, "note", occ(finding)))

    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftlint",
                        "informationUri": "https://github.com/unionai-oss/unionml",
                        "version": str(REPORT_VERSION),
                        "rules": catalog,
                    }
                },
                "columnKind": "utf16CodeUnits",
                "results": results,
            }
        ],
    }
