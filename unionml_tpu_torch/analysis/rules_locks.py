"""Rule ``lock-discipline``: guarded host state written outside its lock.

The serving stack shares mutable host state between the request side and the
engine worker thread (pending request queues, slot→sink maps, RNG keys,
lifetime counters). The owning lock is declared in source with::

    self._pending = collections.deque()  # guarded-by: _lock

on the attribute's ``__init__`` assignment (or the line above it). The rule
then walks every OTHER method of the class and flags any write to the guarded
attribute that is not lexically inside ``with self.<lock>:`` — direct
assignment, augmented assignment, subscript/del, or a call of a known mutating
method (``append``, ``pop``, ``clear``, ...). Constructor writes are exempt
(the object is not shared yet); reads are out of scope (some lock-free reads
are deliberate snapshots — flagging them would drown the writes that corrupt).
"""

import ast
from typing import Dict, Iterator, List, Optional, Set

from unionml_tpu_torch.analysis.core import Finding, Project, register

#: method names that mutate their receiver in place
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "add", "discard", "update",
    "setdefault", "sort", "reverse",
}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _self_base_attr(node: ast.AST) -> Optional[str]:
    """The attribute hung directly off ``self`` at the base of an lvalue chain:
    ``self.engine.tokens_decoded`` / ``self._pending[i]`` both mutate the object
    held by that base attribute, so the base carries the guard."""
    prev = None
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        prev, node = node, node.value
    if isinstance(node, ast.Name) and node.id == "self" and isinstance(prev, ast.Attribute):
        return prev.attr
    return None


class _ClassGuards:
    def __init__(self) -> None:
        #: attr name -> lock attr name
        self.guarded: Dict[str, str] = {}


def _collect_guards(idx, cls_node: ast.ClassDef, source) -> _ClassGuards:
    guards = _ClassGuards()
    init = next(
        (n for n in cls_node.body
         if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == "__init__"),
        None,
    )
    if init is None:
        return guards
    for node in ast.walk(init):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            attr = _self_attr(t)
            if attr and node.lineno in source.guards:
                guards.guarded[attr] = source.guards[node.lineno]
    return guards


class _MethodWalker(ast.NodeVisitor):
    """Tracks which guarded locks are held (lexically) at each node."""

    def __init__(self, guards: _ClassGuards, relpath: str, qualname: str) -> None:
        self.guards = guards
        self.relpath = relpath
        self.qualname = qualname
        self.held: Set[str] = set()
        self.findings: List[Finding] = []

    def visit_With(self, node: ast.With) -> None:
        acquired = set()
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is None and isinstance(item.context_expr, ast.Call):
                attr = _self_attr(item.context_expr.func)  # with self._lock.acquire_timeout(...)
            if attr is not None:
                acquired.add(attr)
        self.held |= acquired
        self.generic_visit(node)
        self.held -= acquired

    visit_AsyncWith = visit_With

    def _flag(self, node: ast.AST, attr: str, verb: str) -> None:
        lock = self.guards.guarded[attr]
        self.findings.append(
            Finding(
                "lock-discipline", self.relpath, node.lineno, node.col_offset,
                f"self.{attr} is declared '# guarded-by: {lock}' but is {verb} "
                f"outside 'with self.{lock}:'",
                symbol=self.qualname,
            )
        )

    def _check_write(self, target: ast.AST, node: ast.AST) -> None:
        # self.x = ..., self.x[i] = ..., self.x.y = ..., del self.x[i]: all
        # mutate the object the base attribute holds, so the base's guard rules
        attr = _self_attr(target) or _self_base_attr(target)
        if attr in self.guards.guarded and self.guards.guarded[attr] not in self.held:
            self._flag(node, attr, "written")

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                self._check_write(el, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_write(node.target, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_write(node.target, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._check_write(t, node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value) or _self_base_attr(node.func.value)
            if attr in self.guards.guarded \
                    and self.guards.guarded[attr] not in self.held:
                self._flag(node, attr, f"mutated via .{node.func.attr}()")
        self.generic_visit(node)


@register("lock-discipline", "writes to '# guarded-by' host state outside the owning lock")
def check(project: Project) -> Iterator[Finding]:
    for idx in project.graph.indexes:
        source = idx.source
        if not source.guards:
            continue
        for node in ast.walk(source.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            guards = _collect_guards(idx, node, source)
            if not guards.guarded:
                continue
            for method in node.body:
                if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if method.name == "__init__":
                    continue  # the object is not shared during construction
                walker = _MethodWalker(
                    guards, source.relpath, f"{node.name}.{method.name}"
                )
                walker.visit(method)
                yield from walker.findings
