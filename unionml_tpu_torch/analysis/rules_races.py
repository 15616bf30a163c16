"""Rule family ``data-race`` / ``check-then-act`` / ``lock-leaf`` /
``callback-under-lock``: lock-set analysis over inferred thread roles
(graftlint v4).

v2 checks lock *ordering* and v3 resource *lifetimes*; neither proves the
property the serving stack actually leans on — that every piece of instance
state shared between threads is consistently guarded. This family closes that
gap on the thread-role inference of :mod:`unionml_tpu_torch.analysis.threads`:

- **data-race** — Eraser-style lock-set intersection. For every instance
  attribute of every class, collect all reads/writes outside ``__init__``
  together with the locks *lexically held* at each access. An attribute is a
  race candidate when it is reachable from **>= 2 thread roles** and written
  from at least one of them. For attributes declared ``# guarded-by: <lock>``
  the writes already belong to ``lock-discipline``; this rule adds the
  *reads* that run without the lock (a torn read of state another role
  mutates). For undeclared attributes the candidate lock set is the
  intersection of locks held across all accesses: non-empty means
  consistently guarded (silent); empty means either no lock is ever held
  (one finding per attribute) or most accesses hold a *modal* lock that some
  access skips (one finding per attribute and function, naming the unguarded
  function). Every finding carries the thread-role witness chains that make
  the attribute shared.
- **check-then-act** — a ``# guarded-by:`` attribute is read in an ``if``/
  ``while`` condition under one acquisition of its lock and written under a
  *separate, later* acquisition in the same function: the checked condition
  can go stale between the two hold regions.
- **lock-leaf** — ``# lock-leaf`` on a lock's assignment declares it a leaf:
  a hold region must not acquire any other project lock (directly or through
  a resolved callee, per the v2 acquisition summaries) nor make a blocking
  call. The Router lock and the telemetry/metrics leaf locks turn from
  comment-convention into checked contract.
- **callback-under-lock** — ``# fires-outside-lock`` on a callback
  registration method (``EngineSupervisor.subscribe``) asserts the registered
  callbacks are invoked outside the class's locks. The rule finds the
  registry's firing sites (``for cb in list(self._subscribers): cb(...)``)
  and flags any invocation lexically under a project lock — including calls
  *into* a firing method made while holding one (the regression that
  re-introduces the subscriber deadlock the comment warns about).

Like every graftlint family: pure ``ast``, best-effort resolution, silence
over guessing. Deliberate single-stream designs carry reasoned
``# graftlint: disable=...`` suppressions at the site.
"""

import ast
import dataclasses
from collections import Counter
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from unionml_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo, ModuleIndex, dotted
from unionml_tpu_torch.analysis.core import Finding, Project, register
from unionml_tpu_torch.analysis.dataflow import (
    LockKey,
    LockModel,
    Summaries,
    _call_map,
    blocking_reason,
    own_nodes,
    resolved_edges,
    shared_analyses,
)
from unionml_tpu_torch.analysis.rules_locks import (
    _MUTATORS,
    _collect_guards,
    _self_attr,
    _self_base_attr,
)
from unionml_tpu_torch.analysis.threads import ThreadModel, thread_model

#: threading/queue constructors whose objects are internally synchronized —
#: attributes holding them are not racy shared state themselves
_SYNC_CTORS = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "Event", "Barrier", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
}


def _fmt(key: LockKey) -> str:
    mod, cls, attr = key
    leaf = mod.rsplit(".", 1)[-1]
    return f"{leaf}:{cls}.{attr}" if cls else f"{leaf}:{attr}"


@dataclasses.dataclass
class _Access:
    attr: str
    fn: FunctionInfo
    write: bool
    node: ast.AST
    held: frozenset  # LockKeys lexically held
    in_test: bool  # inside an if/while condition
    region: Optional[ast.With]  # innermost lock-acquiring with-statement


class _AccessWalker(ast.NodeVisitor):
    """Collects guarded-state accesses in ONE method body with the lock set
    lexically held at each node (own frame only — nested defs run later,
    under whichever thread invokes them)."""

    def __init__(
        self,
        idx: ModuleIndex,
        fn: FunctionInfo,
        locks: LockModel,
        attrs: Set[str],
    ) -> None:
        self.idx = idx
        self.fn = fn
        self.locks = locks
        self.attrs = attrs
        self.held: List[LockKey] = []
        self.region_stack: List[ast.With] = []
        self.accesses: List[_Access] = []
        self._skip_reads: Set[int] = set()
        self._test_depth = 0

    def run(self) -> List[_Access]:
        for stmt in self.fn.node.body:
            self.visit(stmt)
        return self.accesses

    # own-frame boundary
    def visit_FunctionDef(self, node) -> None:  # noqa: N802 - ast API
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _record(self, attr: str, node: ast.AST, write: bool) -> None:
        self.accesses.append(
            _Access(
                attr,
                self.fn,
                write,
                node,
                frozenset(self.held),
                self._test_depth > 0,
                self.region_stack[-1] if self.region_stack else None,
            )
        )

    def visit_With(self, node: ast.With) -> None:
        acquired: List[LockKey] = []
        for item in node.items:
            key = self.locks.lock_of(item.context_expr, self.idx, self.fn.class_name)
            if key is not None:
                acquired.append(key)
            self.visit(item.context_expr)
        self.held.extend(acquired)
        if acquired:
            self.region_stack.append(node)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            self.region_stack.pop()
        del self.held[len(self.held) - len(acquired):]

    visit_AsyncWith = visit_With

    def visit_If(self, node: ast.If) -> None:
        self._test_depth += 1
        self.visit(node.test)
        self._test_depth -= 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_While(self, node: ast.While) -> None:
        self._test_depth += 1
        self.visit(node.test)
        self._test_depth -= 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def _check_write_target(self, target: ast.AST, node: ast.AST) -> None:
        attr = _self_attr(target) or _self_base_attr(target)
        if attr in self.attrs:
            self._record(attr, node, write=True)
            # the Load of ``self.x`` inside ``self.x[i] = ...`` is part of the
            # write, not an independent read
            for sub in ast.walk(target):
                if _self_attr(sub) == attr:
                    self._skip_reads.add(id(sub))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            for el in t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]:
                self._check_write_target(el, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_write_target(node.target, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_write_target(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._check_write_target(t, node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value) or _self_base_attr(node.func.value)
            if attr in self.attrs:
                self._record(attr, node, write=True)
                for sub in ast.walk(node.func.value):
                    if _self_attr(sub) == attr:
                        self._skip_reads.add(id(sub))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load) and id(node) not in self._skip_reads:
            attr = _self_attr(node)
            if attr in self.attrs:
                self._record(attr, node, write=False)
        self.generic_visit(node)


def _instance_attrs(idx: ModuleIndex, cls_node: ast.ClassDef) -> Set[str]:
    """Attributes ``__init__`` creates, minus internally-synchronized
    primitives (locks, events, queues) — the candidate shared state."""
    init = next(
        (
            n
            for n in cls_node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name == "__init__"
        ),
        None,
    )
    if init is None:
        return set()
    out: Set[str] = set()
    for node in ast.walk(init):
        targets: List[ast.AST] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        for t in targets:
            for el in t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]:
                attr = _self_attr(el)
                if attr is None:
                    continue
                if (
                    value is not None
                    and isinstance(value, ast.Call)
                    and (dotted(value.func) or "").rsplit(".", 1)[-1] in _SYNC_CTORS
                ):
                    continue
                out.add(attr)
    return out


def _held_at(
    fn: FunctionInfo, idx: ModuleIndex, locks: LockModel, target: ast.AST
) -> frozenset:
    """LockKeys lexically held at ``target`` inside ``fn`` (empty when the
    node is not in this function's own frame)."""

    result: List[frozenset] = []

    def walk(node: ast.AST, held: Tuple[LockKey, ...]) -> None:
        if result:
            return
        if node is target:
            result.append(frozenset(held))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = tuple(
                key
                for item in node.items
                if (key := locks.lock_of(item.context_expr, idx, fn.class_name)) is not None
            )
            for item in node.items:
                walk(item.context_expr, held)
            for stmt in node.body:
                walk(stmt, held + acquired)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for stmt in fn.node.body:
        walk(stmt, ())
    return result[0] if result else frozenset()


class _Analysis:
    """Shared engine behind the four registered rules (built once per lint
    run, cached on the project's call graph)."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.graph: CallGraph = project.graph
        self.model: ThreadModel = thread_model(self.graph)
        self.locks, self.sums = shared_analyses(self.graph)
        self.races: List[Finding] = []
        self.ctas: List[Finding] = []
        self.leaves: List[Finding] = []
        self.callbacks: List[Finding] = []
        for idx in self.graph.indexes:
            for cls_name, cls_node in idx.classes.items():
                self._check_class(idx, cls_name, cls_node)
        self._check_lock_leaves()
        self._check_callbacks()
        for findings in (self.races, self.ctas, self.leaves, self.callbacks):
            findings.sort(key=lambda f: (f.path, f.line, f.col))

    # ------------------------------------------------------------- role helpers

    def _roles_note(self, fns: Sequence[FunctionInfo]) -> str:
        """The thread-role witness clause for a finding message: every role
        that reaches the attribute, each with one entry chain."""
        pairs: Dict[str, str] = {}
        for fn in fns:
            for role in self.model.roles_of(fn):
                pairs.setdefault(role, self.model.witness_of(fn, role))
        return "; ".join(pairs[r] for r in sorted(pairs))

    # ---------------------------------------------------------------- data-race

    def _check_class(self, idx: ModuleIndex, cls_name: str, cls_node: ast.ClassDef) -> None:
        attrs = _instance_attrs(idx, cls_node)
        if not attrs:
            return
        guards = _collect_guards(idx, cls_node, idx.source).guarded
        methods = [
            fn
            for fn in idx.functions.values()
            if fn.class_name == cls_name
            and fn.qualname == f"{cls_name}.{fn.node.name}"
            and fn.node.name != "__init__"
        ]
        if not methods:
            return
        by_attr: Dict[str, List[_Access]] = {}
        for fn in methods:
            for access in _AccessWalker(idx, fn, self.locks, attrs).run():
                by_attr.setdefault(access.attr, []).append(access)
        for attr, accesses in sorted(by_attr.items()):
            roles = set()
            for a in accesses:
                roles |= self.model.roles_of(a.fn)
            if len(roles) < 2 or not any(a.write for a in accesses):
                continue
            if attr in guards:
                self._check_guarded_reads(idx, cls_name, attr, guards[attr], accesses, roles)
                self._check_check_then_act(idx, cls_name, attr, guards[attr], accesses)
            else:
                self._check_lockset(idx, cls_name, attr, accesses, roles)

    def _check_guarded_reads(
        self,
        idx: ModuleIndex,
        cls_name: str,
        attr: str,
        lock_attr: str,
        accesses: List[_Access],
        roles: Set[str],
    ) -> None:
        lock_key = (idx.name, cls_name, lock_attr)
        flagged: Set[Tuple[str, str]] = set()
        for a in accesses:
            if a.write or lock_key in a.held:
                continue
            if not self.model.roles_of(a.fn):
                continue
            dedup = (attr, a.fn.qualname)
            if dedup in flagged:
                continue
            flagged.add(dedup)
            self.races.append(
                Finding(
                    "data-race",
                    idx.source.relpath,
                    a.node.lineno,
                    a.node.col_offset,
                    f"self.{attr} is declared '# guarded-by: {lock_attr}' and is "
                    f"shared across thread roles [{self._roles_note([x.fn for x in accesses])}] "
                    f"with at least one writer, but this read runs without "
                    f"'with self.{lock_attr}:' — a concurrent write can tear the value",
                    symbol=a.fn.qualname,
                )
            )

    def _check_lockset(
        self,
        idx: ModuleIndex,
        cls_name: str,
        attr: str,
        accesses: List[_Access],
        roles: Set[str],
    ) -> None:
        """Eraser-lite: the candidate lock set is the intersection of locks
        held across all accesses; a non-empty intersection proves consistent
        guarding, an empty one yields the findings."""
        locksets = [a.held for a in accesses]
        common = frozenset.intersection(*locksets)
        if common:
            return
        ever_held = [k for a in accesses for k in a.held]
        role_note = self._roles_note([a.fn for a in accesses])
        modal = Counter(ever_held).most_common(1)[0][0] if ever_held else None
        guarded_count = (
            sum(1 for a in accesses if modal in a.held) if modal is not None else 0
        )
        if guarded_count * 2 < len(accesses):
            # no lock is a *convention* for this attribute (held at under half
            # the accesses — incidental, e.g. a closed-flag check that happens
            # to sit in a locked region): one finding per attribute, at the
            # first write, is the actionable unit
            first_write = min(
                (a for a in accesses if a.write), key=lambda a: a.node.lineno
            )
            held_note = (
                "NO lock is ever held at any of its "
                f"{len(accesses)} accesses"
                if modal is None
                else f"no consistent lock guards it (self.{modal[2]} is held at "
                f"only {guarded_count} of {len(accesses)} accesses)"
            )
            self.races.append(
                Finding(
                    "data-race",
                    idx.source.relpath,
                    first_write.node.lineno,
                    first_write.node.col_offset,
                    f"self.{attr} is written here and shared across thread roles "
                    f"[{role_note}] but {held_note} — guard it (and declare "
                    f"'# guarded-by:') or document the single-stream design "
                    f"with a reasoned suppression",
                    symbol=first_write.fn.qualname,
                )
            )
            return
        flagged: Set[Tuple[str, str]] = set()
        for a in accesses:
            if modal in a.held or not self.model.roles_of(a.fn):
                continue
            dedup = (attr, a.fn.qualname)
            if dedup in flagged:
                continue
            flagged.add(dedup)
            self.races.append(
                Finding(
                    "data-race",
                    idx.source.relpath,
                    a.node.lineno,
                    a.node.col_offset,
                    f"self.{attr} is {'written' if a.write else 'read'} without "
                    f"'with self.{modal[2]}:' here, but {guarded_count} of "
                    f"{len(accesses)} accesses hold that lock and the attribute "
                    f"is shared across thread roles [{role_note}] — the lock set "
                    f"intersection is empty",
                    symbol=a.fn.qualname,
                )
            )

    # ------------------------------------------------------------ check-then-act

    def _check_check_then_act(
        self,
        idx: ModuleIndex,
        cls_name: str,
        attr: str,
        lock_attr: str,
        accesses: List[_Access],
    ) -> None:
        lock_key = (idx.name, cls_name, lock_attr)
        by_fn: Dict[str, List[_Access]] = {}
        for a in accesses:
            by_fn.setdefault(a.fn.qualname, []).append(a)
        for qualname, fn_accesses in sorted(by_fn.items()):
            checks = [
                a
                for a in fn_accesses
                if not a.write and a.in_test and a.region is not None and lock_key in a.held
            ]
            writes = [
                a
                for a in fn_accesses
                if a.write and a.region is not None and lock_key in a.held
            ]
            for w in writes:
                stale = next(
                    (
                        c
                        for c in checks
                        if c.region is not w.region
                        and (c.region.end_lineno or c.region.lineno) < w.region.lineno
                    ),
                    None,
                )
                if stale is not None:
                    self.ctas.append(
                        Finding(
                            "check-then-act",
                            idx.source.relpath,
                            w.node.lineno,
                            w.node.col_offset,
                            f"self.{attr} was read in a condition under 'with "
                            f"self.{lock_attr}:' at line {stale.node.lineno} and is "
                            f"written here under a SEPARATE acquisition — the "
                            f"checked condition can go stale between the two hold "
                            f"regions; merge them or re-check under this one",
                            symbol=qualname,
                        )
                    )
                    break  # one finding per (attr, function)

    # ------------------------------------------------------------------ lock-leaf

    def _leaf_keys(self) -> Dict[LockKey, Tuple[str, int]]:
        """Declared leaf locks -> (relpath, line), plus hygiene findings for
        annotations not attached to a lock assignment."""
        out: Dict[LockKey, Tuple[str, int]] = {}
        for idx in self.graph.indexes:
            source = idx.source
            if not source.lock_leaves:
                continue
            matched: Set[int] = set()
            for node in source.tree.body:
                if isinstance(node, ast.Assign) and node.lineno in source.lock_leaves:
                    if LockModel._is_lock_ctor(node.value, idx):
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                out[(idx.name, None, t.id)] = (source.relpath, node.lineno)
                                matched.add(node.lineno)
            for cls_name, cls_node in idx.classes.items():
                for node in ast.walk(cls_node):
                    if not (
                        isinstance(node, ast.Assign)
                        and node.lineno in source.lock_leaves
                        and LockModel._is_lock_ctor(node.value, idx)
                    ):
                        continue
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            out[(idx.name, cls_name, attr)] = (source.relpath, node.lineno)
                            matched.add(node.lineno)
            for line in sorted(source.lock_leaves - matched):
                self.leaves.append(
                    Finding(
                        "lock-leaf",
                        source.relpath,
                        line,
                        0,
                        "'# lock-leaf' annotation is not attached to a lock "
                        "assignment (threading.Lock()/RLock()/... target)",
                    )
                )
        return out

    def _check_lock_leaves(self) -> None:
        leaf_keys = self._leaf_keys()
        if not leaf_keys:
            return
        for idx in self.graph.indexes:
            for fn in idx.functions.values():
                callee_by_call = {
                    id(call): callee for callee, call in resolved_edges(self.graph, fn)
                }
                for node in own_nodes(fn.node):
                    if not isinstance(node, (ast.With, ast.AsyncWith)):
                        continue
                    held_leaf = None
                    for item in node.items:
                        key = self.locks.lock_of(item.context_expr, idx, fn.class_name)
                        if key in leaf_keys:
                            held_leaf = key
                    if held_leaf is None:
                        continue
                    self._check_leaf_region(idx, fn, node, held_leaf, callee_by_call)

    def _check_leaf_region(
        self,
        idx: ModuleIndex,
        fn: FunctionInfo,
        region: ast.With,
        leaf: LockKey,
        callee_by_call: Dict[int, FunctionInfo],
    ) -> None:
        for stmt in region.body:
            for node in own_nodes(stmt):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        key = self.locks.lock_of(item.context_expr, idx, fn.class_name)
                        if key is not None and key != leaf:
                            self.leaves.append(
                                Finding(
                                    "lock-leaf",
                                    idx.source.relpath,
                                    node.lineno,
                                    node.col_offset,
                                    f"{_fmt(leaf)} is declared '# lock-leaf' but its "
                                    f"hold region acquires {_fmt(key)} — a leaf lock "
                                    f"must stay the innermost lock",
                                    symbol=fn.qualname,
                                )
                            )
                if not isinstance(node, ast.Call):
                    continue
                reason = blocking_reason(node, idx)
                if reason is not None and not self._is_lock_wait(node, idx, fn):
                    self.leaves.append(
                        Finding(
                            "lock-leaf",
                            idx.source.relpath,
                            node.lineno,
                            node.col_offset,
                            f"{_fmt(leaf)} is declared '# lock-leaf' but its hold "
                            f"region blocks: {reason} — every other thread touching "
                            f"the leaf stalls behind it",
                            symbol=fn.qualname,
                        )
                    )
                callee = callee_by_call.get(id(node))
                if callee is None or callee.key == fn.key:
                    continue
                acquired = self.sums.acquires.get(callee.key, set()) - {leaf}
                if acquired:
                    self.leaves.append(
                        Finding(
                            "lock-leaf",
                            idx.source.relpath,
                            node.lineno,
                            node.col_offset,
                            f"{_fmt(leaf)} is declared '# lock-leaf' but "
                            f"'{callee.qualname}()' (called in its hold region) "
                            f"acquires {', '.join(sorted(_fmt(k) for k in acquired))}",
                            symbol=fn.qualname,
                        )
                    )
                blocked = self.sums.blocking.get(callee.key)
                if blocked is not None:
                    self.leaves.append(
                        Finding(
                            "lock-leaf",
                            idx.source.relpath,
                            node.lineno,
                            node.col_offset,
                            f"{_fmt(leaf)} is declared '# lock-leaf' but "
                            f"'{callee.qualname}()' (called in its hold region) "
                            f"blocks: {blocked.reason} "
                            f"(via {' -> '.join(blocked.chain)})",
                            symbol=fn.qualname,
                        )
                    )

    def _is_lock_wait(self, call: ast.Call, idx: ModuleIndex, fn: FunctionInfo) -> bool:
        """``cond.wait()`` on a declared lock releases it while parked — the
        condition-variable protocol, not a hold-region stall."""
        if isinstance(call.func, ast.Attribute) and call.func.attr == "wait":
            return self.locks.lock_of(call.func.value, idx, fn.class_name) is not None
        return False

    # --------------------------------------------------------- callback contracts

    def _check_callbacks(self) -> None:
        for idx in self.graph.indexes:
            source = idx.source
            for line in sorted(source.fires_outside):
                fn = self._fn_at_line(idx, line)
                if fn is None:
                    self.callbacks.append(
                        Finding(
                            "callback-under-lock",
                            source.relpath,
                            line,
                            0,
                            "'# fires-outside-lock' annotation is not attached to "
                            "a function definition",
                        )
                    )
                    continue
                regs = [
                    reg
                    for reg in self.model.registries.values()
                    if any(m.key == fn.key for m in reg.register_methods)
                ]
                if not regs:
                    self.callbacks.append(
                        Finding(
                            "callback-under-lock",
                            source.relpath,
                            line,
                            0,
                            f"'{fn.qualname}' is declared '# fires-outside-lock' "
                            f"but stores no callable parameter into instance "
                            f"state — the annotation belongs on the registration "
                            f"method",
                            symbol=fn.qualname,
                        )
                    )
                    continue
                for reg in regs:
                    self._check_fire_sites(fn, reg)

    def _check_fire_sites(self, register_fn: FunctionInfo, reg) -> None:
        for fire_fn, call in reg.fire_sites:
            fire_idx = fire_fn.module
            held = _held_at(fire_fn, fire_idx, self.locks, call)
            if held:
                self.callbacks.append(
                    Finding(
                        "callback-under-lock",
                        fire_idx.source.relpath,
                        call.lineno,
                        call.col_offset,
                        f"callbacks registered by '{register_fn.qualname}' "
                        f"(declared '# fires-outside-lock') are invoked here "
                        f"while holding {', '.join(sorted(_fmt(k) for k in held))}",
                        symbol=fire_fn.qualname,
                    )
                )
        # one level up: a firing method invoked while the caller holds a lock
        fire_keys = {fire_fn.key: fire_fn for fire_fn, _ in reg.fire_sites}
        if not fire_keys:
            return
        for idx in self.graph.indexes:
            for fn in idx.functions.values():
                for callee, call in resolved_edges(self.graph, fn):
                    if callee.key not in fire_keys:
                        continue
                    held = _held_at(fn, idx, self.locks, call)
                    if held:
                        self.callbacks.append(
                            Finding(
                                "callback-under-lock",
                                idx.source.relpath,
                                call.lineno,
                                call.col_offset,
                                f"'{callee.qualname}()' fires callbacks registered "
                                f"by '{register_fn.qualname}' (declared "
                                f"'# fires-outside-lock') but is called here while "
                                f"holding "
                                f"{', '.join(sorted(_fmt(k) for k in held))}",
                                symbol=fn.qualname,
                            )
                        )

    @staticmethod
    def _fn_at_line(idx: ModuleIndex, line: int) -> Optional[FunctionInfo]:
        """The function whose def statement (decorators through signature)
        covers ``line`` — innermost when nested."""
        best: Optional[FunctionInfo] = None
        best_start = -1
        for fn in idx.functions.values():
            node = fn.node
            start = min(
                [node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])]
            )
            body = getattr(node, "body", None)
            end = body[0].lineno - 1 if body else node.lineno
            if start <= line <= max(end, node.lineno) and start > best_start:
                best, best_start = fn, start
        return best


def _analysis(project: Project) -> _Analysis:
    cached = getattr(project.graph, "_graftlint_races", None)
    if cached is None:
        cached = _Analysis(project)
        project.graph._graftlint_races = cached
    return cached


@register(
    "data-race",
    "unguarded access to instance state shared across >= 2 inferred thread roles (lock-set)",
)
def check_races(project: Project) -> Iterator[Finding]:
    yield from _analysis(project).races


@register(
    "check-then-act",
    "guarded field read in a condition, then written under a separate acquisition of its lock",
)
def check_check_then_act(project: Project) -> Iterator[Finding]:
    yield from _analysis(project).ctas


@register(
    "lock-leaf",
    "'# lock-leaf' hold regions must not acquire other project locks or block",
)
def check_lock_leaves(project: Project) -> Iterator[Finding]:
    yield from _analysis(project).leaves


@register(
    "callback-under-lock",
    "'# fires-outside-lock' callbacks invoked while a project lock is held",
)
def check_callbacks(project: Project) -> Iterator[Finding]:
    yield from _analysis(project).callbacks
