"""Rule ``lock-order``: deadlock cycles and blocking calls held under a lock.

The serving stack runs three kinds of threads against shared locks: asyncio
handler threads (submit paths), the engine worker, and background builders.
Two hazards follow, both checked over the dataflow layer's lock model and
interprocedural summaries (:mod:`unionml_tpu_torch.analysis.dataflow`):

- **lock-order cycles.** Every lexical ``with <lock>:`` acquisition made while
  another lock is held adds an edge ``held -> acquired`` to a project-wide
  graph — including acquisitions made by CALLEES, resolved through the call
  graph (``with self._lock: self.scheduler.submit(...)`` contributes
  ``batcher._lock -> scheduler._lock`` because ``submit`` acquires the
  scheduler's lock). A cycle in that graph means two threads can interleave
  the orders and deadlock; every edge of the cycle is reported at its site.
  ``# lock-order: a < b`` comment hints declare nesting the walker cannot see
  (cross-thread protocols); hint edges participate in cycle detection and are
  reported with the hint's location.

- **blocking-under-lock.** A call that blocks unboundedly — ``.result()`` /
  ``.join()`` / ``.wait()`` without timeouts, ``lock.acquire()``,
  ``time.sleep``, ``subprocess.run``, device waits (``torch.cuda.synchronize()``,
  a stream's or an event's ``.synchronize()``) — while a lock is held stalls every thread that
  needs the lock for as long as the blocker runs, which is how a "2ms
  critical section" becomes a seconds-long convoy. Interprocedural: a call
  into a scanned function that transitively blocks is flagged with its chain.
  ``cond.wait()`` on the HELD condition is exempt (the wait releases it — the
  condition-variable protocol).

Scope note: nested ``def``s inside a ``with`` block are skipped — they run
later, under their own frames, not under this acquisition.
"""

import ast
from typing import Dict, List, Optional, Set, Tuple

from unionml_tpu_torch.analysis.callgraph import FunctionInfo, ModuleIndex
from unionml_tpu_torch.analysis.core import Finding, Project, register
from unionml_tpu_torch.analysis.dataflow import (
    LockKey,
    LockModel,
    Summaries,
    _wait_receiver,
    blocking_reason,
    shared_analyses,
)


def _fmt(key: LockKey) -> str:
    mod, cls, attr = key
    short = mod.rsplit(".", 1)[-1]
    return f"{short}.{cls}.{attr}" if cls else f"{short}.{attr}"


class _HeldWalker(ast.NodeVisitor):
    """Walks one function with the lexical stack of held locks."""

    def __init__(
        self,
        fn: FunctionInfo,
        idx: ModuleIndex,
        locks: LockModel,
        summaries: Summaries,
        edges: Dict[Tuple[LockKey, LockKey], List[Tuple[str, int, str]]],
    ) -> None:
        self.fn = fn
        self.idx = idx
        self.locks = locks
        self.summaries = summaries
        self.edges = edges
        self.held: List[LockKey] = []
        self.findings: List[Finding] = []
        self._depth = 0

    def visit(self, node):  # noqa: D102 - skip nested frames
        if self._depth and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            return
        self._depth += 1
        super().visit(node)
        self._depth -= 1

    def _visit_with(self, node) -> None:
        acquired: List[LockKey] = []
        for item in node.items:
            key = self.locks.lock_of(item.context_expr, self.idx, self.fn.class_name)
            if key is not None:
                for held in self.held:
                    if held != key:
                        self.edges.setdefault((held, key), []).append(
                            (self.idx.source.relpath, node.lineno, self.fn.qualname)
                        )
                acquired.append(key)
        self.held.extend(acquired)
        self.generic_visit(node)
        for _ in acquired:
            self.held.pop()

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def visit_Call(self, node: ast.Call) -> None:
        if self.held:
            self._check_call_under_lock(node)
        self.generic_visit(node)

    def _check_call_under_lock(self, node: ast.Call) -> None:
        reason = blocking_reason(node, self.idx)
        if reason is not None:
            recv = _wait_receiver(node)
            if recv is not None:
                key = self.locks.lock_of(recv, self.idx, self.fn.class_name)
                if key is not None and key in self.held:
                    return  # cond.wait() releases the held condition: the protocol
            self.findings.append(
                Finding(
                    "lock-order",
                    self.idx.source.relpath,
                    node.lineno,
                    node.col_offset,
                    f"blocking call under lock {_fmt(self.held[-1])}: {reason} — "
                    f"every thread needing the lock convoys behind it; move the "
                    f"blocking work outside the critical section",
                    symbol=self.fn.qualname,
                )
            )
            return
        callee = self.summaries.resolve_call(self.fn, node)
        if callee is None:
            return
        info = self.summaries.blocking.get(callee.key)
        if info is not None:
            chain = " -> ".join(info.chain)
            self.findings.append(
                Finding(
                    "lock-order",
                    self.idx.source.relpath,
                    node.lineno,
                    node.col_offset,
                    f"call under lock {_fmt(self.held[-1])} blocks: {chain} "
                    f"reaches '{info.reason}' — move the blocking work outside "
                    f"the critical section",
                    symbol=self.fn.qualname,
                )
            )
            return
        callee_locks = self.summaries.acquires.get(callee.key)
        if callee_locks:
            for held in self.held:
                for key in callee_locks:
                    if held != key:
                        self.edges.setdefault((held, key), []).append(
                            (self.idx.source.relpath, node.lineno,
                             f"{self.fn.qualname} via {callee.qualname}")
                        )


def _order(key: LockKey) -> Tuple[str, bool, str, str]:
    """A total order on lock keys: a module-level lock's class is ``None``,
    which does not compare with a class name, so it sorts first instead."""
    module, cls, attr = key
    return (module, cls is not None, cls or "", attr)


def _find_cycles(
    edges: Dict[Tuple[LockKey, LockKey], List[Tuple[str, int, str]]]
) -> List[List[LockKey]]:
    """Elementary cycles in the (tiny) lock graph via DFS; each reported once,
    anchored at its smallest node for determinism."""
    graph: Dict[LockKey, Set[LockKey]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycles: List[List[LockKey]] = []
    seen_cycles: Set[Tuple[LockKey, ...]] = set()

    def dfs(start: LockKey, node: LockKey, path: List[LockKey]) -> None:
        for nxt in sorted(graph.get(node, ()), key=_order):
            if nxt == start:
                # canonicalize rotation so each cycle reports once
                cycle = path[:]
                pivot = min(range(len(cycle)), key=lambda i: _order(cycle[i]))
                canon = tuple(cycle[pivot:] + cycle[:pivot])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(list(canon))
            elif nxt not in path and _order(nxt) > _order(start):
                dfs(start, nxt, path + [nxt])

    for start in sorted(graph, key=_order):
        dfs(start, start, [start])
    return cycles


@register(
    "lock-order",
    "lock-acquisition cycles (deadlock) and blocking calls held under a lock",
)
def check(project: Project):
    graph = project.graph
    locks, summaries = shared_analyses(graph)
    if not locks.locks:
        return
    edges: Dict[Tuple[LockKey, LockKey], List[Tuple[str, int, str]]] = {}
    walkers: List[_HeldWalker] = []
    for idx in graph.indexes:
        for fn in idx.functions.values():
            walker = _HeldWalker(fn, idx, locks, summaries, edges)
            walker.visit(fn.node)
            walkers.append(walker)
    # declared-order hints contribute edges the walker cannot see
    for idx in graph.indexes:
        for line, a, b in getattr(idx.source, "lock_hints", []):
            for ka in locks.by_attr(idx.name, a):
                for kb in locks.by_attr(idx.name, b):
                    if ka != kb:
                        edges.setdefault((ka, kb), []).append(
                            (idx.source.relpath, line, "# lock-order hint")
                        )
    for walker in walkers:
        yield from walker.findings
    for cycle in _find_cycles(edges):
        order = " -> ".join(_fmt(k) for k in cycle + [cycle[0]])
        # report the cycle at every participating edge site so each side of
        # the inversion sees it in review
        for i, a in enumerate(cycle):
            b = cycle[(i + 1) % len(cycle)]
            for path, line, symbol in edges.get((a, b), [])[:1]:
                yield Finding(
                    "lock-order",
                    path,
                    line,
                    0,
                    f"lock-order cycle {order}: two threads taking these locks "
                    f"in different orders can deadlock; pick one global order "
                    f"(declare it with '# lock-order: a < b') and restructure "
                    f"this acquisition",
                    symbol=symbol,
                )
