"""graftlint core: findings, suppressions, source model, rule registry, runner.

The linter is pure ``ast`` + source-comment analysis — it never imports the
code it checks, so it runs in CI without a device (and without paying torch
import time per file). Three source-comment conventions drive it:

- ``# graftlint: disable=RULE[,RULE2] -- reason`` suppresses the named rules on
  that line (inline) or on the next code line (standalone comment line). The
  reason string is REQUIRED: a suppression without one is itself a finding
  (rule ``suppression``), so every silenced site documents why it is safe.
- ``# graftlint: hot-path`` on a ``def`` line declares a host-side hot root for
  the host-sync call-graph walk (e.g. ``DecodeEngine.step``); bodies recorded
  into a CUDA graph or compiled are discovered automatically and need no marker.
- ``# graftlint: off-path`` on a ``def`` line prunes the walk at functions that
  are reachable from a hot root but are not steady-state (admission, error
  recovery, compile paths).
- ``# guarded-by: <lock>`` on a ``self.x = ...`` line in ``__init__`` declares
  the attribute's owning lock for the lock-discipline rule.
- ``# lock-order: a < b`` declares that lock ``a`` may be held while acquiring
  lock ``b`` — a nesting the static walker cannot see (cross-thread
  protocols); the declared edges participate in lock-order cycle detection.
- ``# owns: <resource>`` on a ``def`` line declares that the function takes
  ownership of a resource class (see ``rules_resources``) and must release it;
  ``# transfers: <resource>`` declares that ownership leaves through the
  return value (callers binding the result become owners); ``# holds:
  <resource>`` on a ``self.x = ...`` line in ``__init__`` declares an
  attribute that stores live resources, so overwriting it without a release
  is a leak.
- ``# lock-leaf`` on a lock's ``__init__`` (or module-level) assignment
  declares it a LEAF in the lock hierarchy: no other project lock may be
  acquired and no blocking call made while it is held (rule ``lock-leaf``).
- ``# fires-outside-lock`` on a callback-registration ``def`` (a method that
  appends its callable parameter into instance state) declares that the
  registered callbacks are always invoked OUTSIDE the class's locks; the
  ``callback-under-lock`` rule verifies every firing site.

Suppressions anchor to LOGICAL lines: a finding anywhere inside a multi-line
statement (or on a decorated ``def``'s signature) is silenced by a suppression
on any physical line of that same statement, or on the standalone comment line
above its first line.
"""

import ast
import dataclasses
import hashlib
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: JSON report schema version (bump on any shape change; pinned by tests).
#: v2: interprocedural rule families (lock-order / async-blocking), the
#: ``baselined`` findings list, and SARIF output.
#: v3: the ``timings`` per-family wall-time map (budget regressions must be
#: attributable to a family, not "environmental").
REPORT_VERSION = 3

#: a comment is a DIRECTIVE only when the linter's name is followed by a
#: colon; prose comments that merely mention the linter by name are not parsed
_DIRECTIVE_RE = re.compile(r"graftlint\s*:")
_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$"
)
_MARKER_RE = re.compile(r"#\s*graftlint:\s*(hot-path|off-path)\b")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")
_LOCK_ORDER_RE = re.compile(
    r"#\s*lock-order:\s*([A-Za-z_][A-Za-z0-9_]*)\s*(?:<|->)\s*([A-Za-z_][A-Za-z0-9_]*)"
)
#: resource-contract annotations (rules_resources): comma-separated resource
#: class names from the spec table — the ``owns``/``transfers`` forms sit on a
#: def line, the ``holds`` form on an __init__ attribute assignment
_RESOURCE_LIST = r"([A-Za-z][A-Za-z0-9_\-]*(?:\s*,\s*[A-Za-z][A-Za-z0-9_\-]*)*)"
_OWNS_RE = re.compile(r"#\s*owns:\s*" + _RESOURCE_LIST)
_TRANSFERS_RE = re.compile(r"#\s*transfers:\s*" + _RESOURCE_LIST)
_HOLDS_RE = re.compile(r"#\s*holds:\s*" + _RESOURCE_LIST)
#: concurrency contracts (rules_races): ``lock-leaf`` on a lock assignment,
#: ``fires-outside-lock`` on a callback-registration def
_LOCK_LEAF_RE = re.compile(r"#\s*lock-leaf\b")
_FIRES_OUTSIDE_RE = re.compile(r"#\s*fires-outside-lock\b")

#: substrings that gate the tokenize-based comment pass: a file mentioning
#: none of them carries no graftlint annotation, and re-tokenizing every
#: source was a measurable slice of the lint budget
_COMMENT_KEYWORDS = (
    "graftlint", "guarded-by", "lock-order", "lock-leaf",
    "fires-outside-lock", "owns:", "transfers:", "holds:",
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    #: enclosing function/method qualname ("" at module/class level)
    symbol: str = ""
    suppressed: bool = False
    #: the suppression's reason string (suppressed findings only)
    reason: str = ""

    def format(self) -> str:
        where = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}{where}"

    def fingerprint(self, occurrence: int = 0) -> str:
        """Line-independent identity for the baseline mechanism: editing an
        unrelated part of the file must not invalidate recorded findings, so
        the line number stays out and embedded numbers are normalized."""
        normalized = re.sub(r"\d+", "#", self.message)
        # cwd-relative path: absolute and repo-relative invocations (CI runs
        # from the repo root either way) must produce the same fingerprint
        p = Path(self.path)
        if p.is_absolute():
            try:
                p = p.relative_to(Path.cwd())
            except ValueError:
                pass
        payload = "|".join([self.rule, p.as_posix(), self.symbol, normalized, str(occurrence)])
        return hashlib.sha1(payload.encode()).hexdigest()[:20]

    def as_dict(self) -> Dict[str, object]:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "symbol": self.symbol,
        }
        if self.suppressed:
            d["reason"] = self.reason
        return d


@dataclasses.dataclass
class Suppression:
    """One ``# graftlint: disable=...`` comment (parsed, usage-tracked)."""

    rules: Tuple[str, ...]
    reason: str
    line: int  # the code line it applies to


class SourceModule:
    """One parsed source file: AST + per-line suppressions/markers/annotations."""

    def __init__(self, path: Path, relpath: str, name: str, text: str) -> None:
        self.path = path
        self.relpath = relpath
        #: dotted module name when under a package root, else the bare stem
        self.name = name
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        #: code line -> Suppression
        self.suppressions: Dict[int, Suppression] = {}
        #: logical-line start -> suppressions anchored to that statement
        self._suppressions_by_anchor: Dict[int, List[Suppression]] = {}
        #: def line -> "hot-path" | "off-path"
        self.markers: Dict[int, str] = {}
        #: code line -> lock attribute name (from ``# guarded-by: <lock>``)
        self.guards: Dict[int, str] = {}
        #: ``# lock-order: a < b`` hints: (line, a, b)
        self.lock_hints: List[Tuple[int, str, str]] = []
        #: code line -> resource classes (``# owns:`` / ``# transfers:`` on a
        #: def line, ``# holds:`` on an ``__init__`` attribute assignment)
        self.owns: Dict[int, Tuple[str, ...]] = {}
        self.transfers: Dict[int, Tuple[str, ...]] = {}
        self.holds: Dict[int, Tuple[str, ...]] = {}
        #: code lines of ``lock-leaf`` lock assignments and
        #: ``fires-outside-lock`` registration defs (rules_races contracts)
        self.lock_leaves: set = set()
        self.fires_outside: set = set()
        #: malformed-comment findings emitted by the parse (rule ``suppression``)
        self.comment_findings: List[Finding] = []
        #: physical line -> first line of its logical statement (suppression
        #: anchoring: a multi-line call or a decorated def is ONE logical line).
        #: Built lazily: only annotated files (and files a finding lands in)
        #: ever consult it, and the full-tree walk it needs was a measurable
        #: slice of the lint budget across ~200 unannotated modules.
        self._anchors: Optional[Dict[int, int]] = None
        self._code_lines: List[int] = []
        self._parse_comments()

    def _build_anchors(self) -> None:
        if self._anchors is not None:
            return
        self._anchors = {}
        # ast.walk is breadth-first: parents before children, so inner
        # statements override the span their compound parent claimed — a line
        # anchors to its INNERMOST statement. A def's decorators and signature
        # continuation lines anchor to the decorated-def start (no body
        # statement claims them), which is the decorated-def anchoring rule.
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.stmt):
                continue
            start = min(
                [node.lineno]
                + [d.lineno for d in getattr(node, "decorator_list", [])]
            )
            end = getattr(node, "end_lineno", None) or node.lineno
            for ln in range(start, end + 1):
                self._anchors[ln] = start
        self._code_lines = sorted(self._anchors)

    def logical_anchor(self, line: int) -> int:
        """First line of the logical statement containing ``line``."""
        self._build_anchors()
        return self._anchors.get(line, line)

    def _next_code_line(self, line: int) -> int:
        """The first statement-covered line after ``line`` (standalone-comment
        targets skip blank lines and further comments)."""
        import bisect

        i = bisect.bisect_right(self._code_lines, line)
        if i < len(self._code_lines):
            return self._code_lines[i]
        return line + 1

    def _iter_comments(self):
        """(line, col, comment_text, standalone) for every REAL comment token —
        tokenize-based so docstrings talking about the conventions never match."""
        import io
        import tokenize

        try:
            for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    line, col = tok.start
                    standalone = not self.lines[line - 1][:col].strip()
                    yield line, col, tok.string, standalone
        except tokenize.TokenError:  # unterminated constructs: ast already parsed, skip
            return

    def _parse_comments(self) -> None:
        if not any(k in self.text for k in _COMMENT_KEYWORDS):
            return
        self._build_anchors()
        for line, col, comment, standalone in self._iter_comments():
            # a standalone comment line governs the next code line
            target = self._next_code_line(line) if standalone else line
            if _DIRECTIVE_RE.search(comment):
                self._parse_graftlint_comment(line, col, comment, target)
            guarded = _GUARDED_RE.search(comment)
            if guarded:
                self.guards[target] = guarded.group(1)
            order = _LOCK_ORDER_RE.search(comment)
            if order:
                self.lock_hints.append((line, order.group(1), order.group(2)))
            for regex, table in (
                (_OWNS_RE, self.owns),
                (_TRANSFERS_RE, self.transfers),
                (_HOLDS_RE, self.holds),
            ):
                m = regex.search(comment)
                if m:
                    table[target] = tuple(r.strip() for r in m.group(1).split(","))
            if _LOCK_LEAF_RE.search(comment):
                self.lock_leaves.add(target)
            if _FIRES_OUTSIDE_RE.search(comment):
                self.fires_outside.add(target)

    def _parse_graftlint_comment(self, line: int, col: int, comment: str, target: int) -> None:
        marker = _MARKER_RE.search(comment)
        if marker:
            self.markers[line] = marker.group(1)
            return
        m = _SUPPRESS_RE.search(comment)
        if m is None:
            self.comment_findings.append(
                Finding(
                    "suppression", self.relpath, line, col,
                    "unparseable graftlint comment (expected "
                    "'# graftlint: disable=RULE -- reason' or a hot-path/off-path marker)",
                )
            )
            return
        rules = tuple(r.strip() for r in m.group(1).split(","))
        reason = (m.group("reason") or "").strip()
        if not reason:
            self.comment_findings.append(
                Finding(
                    "suppression", self.relpath, line, col,
                    f"suppression of {', '.join(rules)} requires a reason "
                    "('# graftlint: disable=RULE -- why this is safe')",
                )
            )
            return
        unknown = [r for r in rules if r not in RULES and r != "all"]
        if unknown:
            self.comment_findings.append(
                Finding(
                    "suppression", self.relpath, line, col,
                    f"suppression names unknown rule(s) {', '.join(unknown)} "
                    f"(known: {', '.join(sorted(RULES))})",
                )
            )
            return
        sup = Suppression(rules, reason, target)
        self.suppressions[target] = sup
        self._suppressions_by_anchor.setdefault(self.logical_anchor(target), []).append(sup)

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        """A suppression covering ``line``: same physical line, or anchored to
        the same logical statement (multi-line calls, decorated defs)."""
        candidates = []
        direct = self.suppressions.get(line)
        if direct is not None:
            candidates.append(direct)
        candidates.extend(self._suppressions_by_anchor.get(self.logical_anchor(line), ()))
        for sup in candidates:
            if rule in sup.rules or "all" in sup.rules:
                return sup
        return None


class Rule:
    """A registered lint rule: ``check(project)`` yields raw findings."""

    def __init__(self, name: str, summary: str, check, family: str) -> None:
        self.name = name
        self.summary = summary
        self.check = check
        #: rule family = registering module minus the ``rules_`` prefix
        #: ("races", "resources", ...) — the unit of ``--only`` selection and
        #: of per-family wall-time attribution
        self.family = family


#: rule registry: name -> Rule (populated by the rule modules at import)
RULES: Dict[str, Rule] = {}


def register(name: str, summary: str):
    """Decorator registering ``check(project)`` under ``name``. The family is
    derived from the registering module, so a new rule module lands in the
    ``--only`` catalog, the SARIF catalog, and the timing report with no
    registration beyond its import in :func:`_load_rule_modules`."""

    def wrap(check):
        family = check.__module__.rsplit(".", 1)[-1]
        if family.startswith("rules_"):
            family = family[len("rules_"):]
        RULES[name] = Rule(name, summary, check, family)
        return check

    return wrap


def families() -> Dict[str, List[str]]:
    """family name -> sorted rule names (the ``--only FAMILY`` catalog)."""
    _load_rule_modules()
    out: Dict[str, List[str]] = {}
    for name, rule in RULES.items():
        out.setdefault(rule.family, []).append(name)
    return {fam: sorted(names) for fam, names in out.items()}


def _module_name(path: Path) -> str:
    """Dotted module name by walking up through ``__init__.py`` packages."""
    parts = [path.stem] if path.stem != "__init__" else []
    parent = path.parent
    while (parent / "__init__.py").exists():
        parts.insert(0, parent.name)
        parent = parent.parent
    return ".".join(parts) or path.stem


def collect_files(paths: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
    # never lint generated/compiled droppings
    return [f for f in files if "__pycache__" not in f.parts]


class Project:
    """Every parsed module of one lint invocation plus the shared call graph."""

    def __init__(self, paths: Sequence[str]) -> None:
        # rule modules self-register on import; comment parsing validates
        # disable= names against the registry, so load them first
        _load_rule_modules()

        self.paths = list(paths)
        self.modules: List[SourceModule] = []
        self.errors: List[Finding] = []
        for f in collect_files(paths):
            try:
                text = f.read_text()
                self.modules.append(SourceModule(f, str(f), _module_name(f), text))
            except (SyntaxError, UnicodeDecodeError) as exc:
                self.errors.append(
                    Finding(
                        "parse", str(f), getattr(exc, "lineno", 1) or 1, 0,
                        f"file does not parse: {exc.msg if hasattr(exc, 'msg') else exc}",
                    )
                )
        from unionml_tpu_torch.analysis.callgraph import CallGraph

        self.graph = CallGraph(self.modules)
        self._by_name = {m.name: m for m in self.modules}

    def module(self, name: str) -> Optional[SourceModule]:
        return self._by_name.get(name)


def _load_rule_modules() -> None:
    """Import every rule module for its registration side effect."""
    from unionml_tpu_torch.analysis import (  # noqa: F401
        rules_async,
        rules_deadlock,
        rules_exceptions,
        rules_host_sync,
        rules_locks,
        rules_races,
        rules_recapture,
        rules_resources,
        rules_sharding,
    )


def load_baseline(path: str) -> Dict[str, Dict[str, object]]:
    """Read a ``--baseline`` file: fingerprint -> recorded finding summary."""
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or "findings" not in data:
        raise ValueError(f"{path} is not a graftlint baseline file")
    return dict(data["findings"])


def baseline_payload(findings: Sequence["Finding"]) -> Dict[str, object]:
    """The ``--write-baseline`` file body for the given active findings."""
    recorded: Dict[str, Dict[str, object]] = {}
    counts: Dict[Tuple, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.symbol)
        occurrence = counts.get(key, 0)
        counts[key] = occurrence + 1
        recorded[f.fingerprint(occurrence)] = {
            "rule": f.rule, "path": f.path, "symbol": f.symbol, "message": f.message,
        }
    return {"graftlint_baseline": 1, "findings": recorded}


def _split_baselined(
    findings: List["Finding"], baseline: Dict[str, Dict[str, object]]
) -> Tuple[List["Finding"], List["Finding"]]:
    """Partition findings into (new, baselined) by line-independent
    fingerprint; occurrence counting keeps N recorded duplicates silencing at
    most N live ones."""
    new: List[Finding] = []
    old: List[Finding] = []
    counts: Dict[Tuple, int] = {}
    for f in findings:
        key = (f.rule, f.path, f.symbol)
        occurrence = counts.get(key, 0)
        counts[key] = occurrence + 1
        (old if f.fingerprint(occurrence) in baseline else new).append(f)
    return new, old


def run_lint(
    paths: Sequence[str],
    rules: Optional[Sequence[str]] = None,
    *,
    baseline: Optional[Dict[str, Dict[str, object]]] = None,
    restrict: Optional[Sequence[str]] = None,
) -> "LintResult":
    """Lint ``paths`` with the selected (default: all) rules.

    ``baseline`` (see :func:`load_baseline`) moves findings whose fingerprint
    is recorded into ``result.baselined`` — reported, but not failing — so a
    widened scope can land with its pre-existing findings inventoried and only
    NEW ones breaking the build.

    ``restrict`` keeps the full ``paths`` scan (the interprocedural passes
    need the whole call graph for context) but reports only findings located
    in the named files — the ``--paths`` incremental / pre-commit mode.
    """
    # rule modules self-register on import (Project also does this, but rule
    # selection below needs the registry before any Project exists)
    _load_rule_modules()

    selected = list(rules) if rules else sorted(RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(unknown)} (known: {', '.join(sorted(RULES))})")
    t0 = time.perf_counter()
    project = Project(paths)
    timings: Dict[str, float] = {"parse": time.perf_counter() - t0}
    active: List[Finding] = list(project.errors)
    suppressed: List[Finding] = []
    for mod in project.modules:
        active.extend(mod.comment_findings)  # suppression hygiene is not optional
    mods_by_path = {m.relpath: m for m in project.modules}
    for name in selected:
        t0 = time.perf_counter()
        for finding in RULES[name].check(project):
            mod = mods_by_path.get(finding.path)
            sup = mod.suppression_for(name, finding.line) if mod else None
            if sup is not None:
                suppressed.append(
                    dataclasses.replace(finding, suppressed=True, reason=sup.reason)
                )
            else:
                active.append(finding)
        fam = RULES[name].family
        timings[fam] = timings.get(fam, 0.0) + time.perf_counter() - t0
    if restrict is not None:
        wanted = {Path(p).resolve() for p in restrict}
        active = [f for f in active if Path(f.path).resolve() in wanted]
        suppressed = [f for f in suppressed if Path(f.path).resolve() in wanted]
    active.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    suppressed.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    baselined: List[Finding] = []
    if baseline:
        active, baselined = _split_baselined(active, baseline)
    return LintResult(paths=list(paths), rules=selected, files=len(project.modules),
                      findings=active, suppressed=suppressed, baselined=baselined,
                      timings=timings)


@dataclasses.dataclass
class LintResult:
    """One lint run's outcome; ``report()`` is the machine-readable surface."""

    paths: List[str]
    rules: List[str]
    files: int
    findings: List[Finding]
    suppressed: List[Finding]
    #: pre-existing findings recorded in a ``--baseline`` file: reported, not
    #: failing (``ok`` ignores them) — the widened-scope landing mechanism
    baselined: List[Finding] = dataclasses.field(default_factory=list)
    #: wall seconds per rule family, plus "parse" (project build): the budget
    #: attribution surface — a regression names a family, not "environmental"
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def report(self) -> Dict[str, object]:
        return {
            "graftlint": REPORT_VERSION,
            "paths": self.paths,
            "rules": self.rules,
            "files": self.files,
            "counts": {
                "findings": len(self.findings),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
            },
            "timings": {fam: round(s, 3) for fam, s in sorted(self.timings.items())},
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [f.as_dict() for f in self.suppressed],
            "baselined": [f.as_dict() for f in self.baselined],
        }

    def report_json(self) -> str:
        return json.dumps(self.report(), indent=2)

    def sarif(self) -> Dict[str, object]:
        """The SARIF 2.1.0 document (GitHub code scanning compatible)."""
        from unionml_tpu_torch.analysis.sarif import to_sarif

        return to_sarif(self)

    def sarif_json(self) -> str:
        return json.dumps(self.sarif(), indent=2)
