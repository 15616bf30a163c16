"""Thread-role inference for graftlint v4: who can execute each function.

The serving stack is concurrent by construction — a batcher worker thread, a
supervisor watchdog, a backend loop thread, HTTP handler threads, and
subscriber callbacks fired across all of them — but the v2/v3 rule families
reason about locks and lifetimes without knowing WHICH threads reach a
function. This pass closes that gap: it discovers thread entry points,
propagates *roles* through the resolved call graph, and hands
:mod:`unionml_tpu_torch.analysis.rules_races` the per-function role sets its
lock-set analysis intersects.

**Role vocabulary.**

- ``thread:<name>`` — the body of ``threading.Thread(target=f, name="<name>")``
  (falling back to the target's qualname when the name is not a literal), and
  ``threading.Timer(t, f)`` bodies.
- ``pool:<qualname>`` — a callable handed to ``executor.submit(f, ...)``; each
  submitted target is its own role (two different pooled tasks can interleave;
  a pooled task racing *itself* is out of static reach and documented as such).
- ``api`` — the ambient caller's thread. Every non-traced function with no
  resolved in-project caller that is not itself a thread/pool/callback target
  seeds this role: module entry points, FastAPI endpoints (sync endpoints run
  on the server threadpool, one handler thread per in-flight request), test
  bodies, and public methods the graph cannot see callers for. They all share
  ONE role — the analysis deliberately under-approximates api-side
  concurrency and leans on the explicit thread roles for the second role a
  race needs.

Roles flow down resolved call edges (caller's roles reach every callee) and
across **callback-registration edges**: a method that appends its callable
parameter into instance state (``self._subscribers.append(callback)``) is a
*registration method*; methods of the same class that invoke elements of that
attribute (``for cb in list(self._subscribers): cb(...)``) are its *firing
methods*; any callable passed to a resolved call of the registration method
inherits the firing methods' roles — the supervisor-subscriber protocol,
statically. Lambdas register the functions their bodies call.

Every (function, role) pair keeps a witness chain from the role's entry point
so findings can say *how* a thread reaches the access, not just that it does.
Best-effort like the rest of graftlint: unresolvable targets drop out, and a
function with an empty role set is simply invisible to the race rules.
"""

import ast
from typing import Dict, List, Optional, Set, Tuple

from unionml_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo, ModuleIndex, dotted
from unionml_tpu_torch.analysis.dataflow import own_nodes, resolved_edges

#: (module, qualname) — one function's identity, as in the call graph
FnKey = Tuple[str, str]

#: container-mutating method names a registration method may use to store its
#: callable parameter
_STORE_METHODS = {"append", "add", "appendleft", "insert"}

#: iterable-wrapping callables a firing loop may apply to the registry
#: (``for cb in list(self._subscribers)``)
_ITER_WRAPPERS = {"list", "tuple", "sorted", "reversed", "set"}


def _self_attr_of(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class Registry:
    """One callback registry: ``self.<attr>`` filled by registration methods
    and invoked by firing methods of the same class."""

    def __init__(self, module: str, cls: str, attr: str) -> None:
        self.module = module
        self.cls = cls
        self.attr = attr
        self.register_methods: List[FunctionInfo] = []
        #: (firing function, the ``cb(...)`` Call node)
        self.fire_sites: List[Tuple[FunctionInfo, ast.Call]] = []
        #: scanned callables observed being registered
        self.registered: List[FunctionInfo] = []

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.module, self.cls, self.attr)


class ThreadModel:
    """Per-function thread-role sets with entry-point witnesses."""

    def __init__(self, graph: CallGraph) -> None:
        self.graph = graph
        self.roles: Dict[FnKey, Set[str]] = {}
        #: (fn key, role) -> qualname chain from the role's entry point
        self.witness: Dict[Tuple[FnKey, str], Tuple[str, ...]] = {}
        #: functions that are thread/pool/callback targets (never api roots)
        self.entry_targets: Set[FnKey] = set()
        self.registries: Dict[Tuple[str, str, str], Registry] = {}
        #: extra role-flow edges beyond the call graph (firing fn -> callback)
        self._callback_edges: List[Tuple[FnKey, FnKey]] = []
        self._collect_registries()
        self._collect_entries()
        self._seed_ambient()
        self._propagate()

    # ------------------------------------------------------------- entry points

    def _collect_entries(self) -> None:
        seeds: List[Tuple[FunctionInfo, str]] = []
        for idx in self.graph.indexes:
            for fn in idx.functions.values():
                for node in own_nodes(fn.node):
                    if not isinstance(node, ast.Call):
                        continue
                    target, role = self._thread_entry(node, idx, fn)
                    if target is None:
                        target, role = self._pool_entry(node, idx, fn)
                    if target is not None:
                        seeds.append((target, role))
                        self.entry_targets.add(target.key)
        # callback targets: arguments of registration-method calls. Resolved
        # edges carry most sites; an unresolved receiver (``sup.subscribe(...)``
        # where ``sup`` came out of a zip/tuple unpacking the per-function type
        # tracking cannot see) falls back to the bare method name when exactly
        # one FIRING registry tree-wide registers under that name.
        reg_by_key: Dict[FnKey, List[Registry]] = {}
        reg_by_name: Dict[str, List[Registry]] = {}
        for reg in self.registries.values():
            for m in reg.register_methods:
                reg_by_key.setdefault(m.key, []).append(reg)
                if reg.fire_sites:
                    lst = reg_by_name.setdefault(m.node.name, [])
                    if reg not in lst:
                        lst.append(reg)
        for idx in self.graph.indexes:
            for fn in idx.functions.values():
                resolved = {
                    id(call): callee for callee, call in resolved_edges(self.graph, fn)
                }
                for _cands, call in fn.calls:
                    if not call.args:
                        continue
                    callee = resolved.get(id(call))
                    if callee is not None:
                        regs = reg_by_key.get(callee.key, [])
                    elif isinstance(call.func, ast.Attribute):
                        regs = reg_by_name.get(call.func.attr, [])
                        if len(regs) != 1:
                            regs = []
                    else:
                        regs = []
                    if not regs:
                        continue
                    for cb in self._callables_of(call.args[0], idx, fn):
                        for reg in regs:
                            reg.registered.append(cb)
                        self.entry_targets.add(cb.key)
        for reg in self.registries.values():
            for fire_fn, _call in reg.fire_sites:
                for cb in reg.registered:
                    self._callback_edges.append((fire_fn.key, cb.key))
        for target, role in seeds:
            self.roles.setdefault(target.key, set()).add(role)
            self.witness.setdefault((target.key, role), (target.qualname,))

    def _thread_entry(
        self, call: ast.Call, idx: ModuleIndex, fn: FunctionInfo
    ) -> Tuple[Optional[FunctionInfo], str]:
        """(target, role) for ``threading.Thread(target=..., name=...)`` and
        ``threading.Timer(interval, f)`` constructions."""
        name = dotted(call.func) or ""
        leaf = name.rsplit(".", 1)[-1]
        if leaf not in ("Thread", "Timer"):
            return None, ""
        root = name.split(".", 1)[0]
        if leaf != root and idx.imports.get(root, root) != "threading":
            return None, ""
        target_expr: Optional[ast.AST] = None
        if leaf == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
        elif len(call.args) >= 2:  # Timer(interval, f)
            target_expr = call.args[1]
        if target_expr is None:
            return None, ""
        target = self._resolve_callable(target_expr, idx, fn)
        if target is None:
            return None, ""
        thread_name = next(
            (
                kw.value.value
                for kw in call.keywords
                if kw.arg == "name"
                and isinstance(kw.value, ast.Constant)
                and isinstance(kw.value.value, str)
            ),
            target.qualname,
        )
        return target, f"thread:{thread_name}"

    def _pool_entry(
        self, call: ast.Call, idx: ModuleIndex, fn: FunctionInfo
    ) -> Tuple[Optional[FunctionInfo], str]:
        """(target, role) for ``executor.submit(f, ...)`` — only when the first
        argument resolves to a scanned function (``scheduler.submit(ticket)``
        and friends fall out naturally: a ticket is not a callable)."""
        if not (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "submit"
            and call.args
        ):
            return None, ""
        target = self._resolve_callable(call.args[0], idx, fn, calls_only=False)
        if target is None:
            return None, ""
        return target, f"pool:{target.qualname}"

    def _resolve_callable(
        self,
        expr: ast.AST,
        idx: ModuleIndex,
        fn: FunctionInfo,
        *,
        calls_only: bool = True,
    ) -> Optional[FunctionInfo]:
        """The scanned function a callable expression denotes: ``self.m``, a
        lexically visible name, or ``x.m`` through recorded instance types."""
        attr = _self_attr_of(expr)
        if attr is not None and fn.class_name is not None:
            return self.graph.by_key.get((idx.name, f"{fn.class_name}.{attr}"))
        if isinstance(expr, ast.Name):
            scope = fn.qualname.split(".")
            for i in range(len(scope), -1, -1):
                cand = idx.functions.get(".".join(scope[:i] + [expr.id]))
                if cand is not None:
                    return cand
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            key = fn.instance_types.get(expr.value.id)
            if key is not None:
                return self.graph.by_key.get((key[0], f"{key[1]}.{expr.attr}"))
        return None

    def _callables_of(
        self, expr: ast.AST, idx: ModuleIndex, fn: FunctionInfo
    ) -> List[FunctionInfo]:
        """Scanned functions a registration argument hands over — a direct
        callable reference, or (for a lambda) every scanned function its body
        calls: ``subscribe(lambda old, new: self._on_state(old, new))``
        registers ``_on_state`` for role purposes."""
        direct = self._resolve_callable(expr, idx, fn)
        if direct is not None:
            return [direct]
        if isinstance(expr, ast.Lambda):
            out = []
            call_ids = {id(node) for node in ast.walk(expr) if isinstance(node, ast.Call)}
            for callee, call in resolved_edges(self.graph, fn):
                if id(call) in call_ids:
                    out.append(callee)
            return out
        return []

    # --------------------------------------------------------------- registries

    def _collect_registries(self) -> None:
        for idx in self.graph.indexes:
            for cls_name in idx.classes:
                self._collect_class_registries(idx, cls_name)

    def _collect_class_registries(self, idx: ModuleIndex, cls_name: str) -> None:
        methods = [
            fn
            for fn in idx.functions.values()
            if fn.class_name == cls_name
            and fn.qualname == f"{cls_name}.{fn.node.name}"
        ]
        # registration methods: a callable PARAMETER stored into self.<attr>
        for fn in methods:
            params = {a.arg for a in fn.node.args.args if a.arg != "self"}
            if not params:
                continue
            for node in own_nodes(fn.node):
                attr = None
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _STORE_METHODS
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in params
                ):
                    attr = _self_attr_of(node.func.value)
                elif (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in params
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Subscript)
                ):
                    attr = _self_attr_of(node.targets[0].value)
                if attr is None:
                    continue
                reg = self.registries.setdefault(
                    (idx.name, cls_name, attr), Registry(idx.name, cls_name, attr)
                )
                if fn not in reg.register_methods:
                    reg.register_methods.append(fn)
        if not any(k[0] == idx.name and k[1] == cls_name for k in self.registries):
            return
        # firing methods: invoke elements of the registry attribute
        for fn in methods:
            for attr, call in _fire_sites(fn):
                reg = self.registries.get((idx.name, cls_name, attr))
                if reg is not None:
                    reg.fire_sites.append((fn, call))

    # -------------------------------------------------------------- propagation

    def _seed_ambient(self) -> None:
        """Seed the ambient ``api`` role at every plausible external surface."""
        called: Set[FnKey] = set()
        for fn in self.graph.by_key.values():
            for callee, _call in resolved_edges(self.graph, fn):
                if callee.key != fn.key:
                    called.add(callee.key)
        for idx in self.graph.indexes:
            for fn in idx.functions.values():
                name = fn.qualname.rsplit(".", 1)[-1]
                parent = fn.qualname.rsplit(".", 1)[0] if "." in fn.qualname else ""
                if (
                    fn.key in called
                    or fn.key in self.entry_targets
                    or fn.traced
                    or (name.startswith("__") and name.endswith("__"))
                    or (parent and parent in idx.functions)  # nested def
                ):
                    continue
                self.roles.setdefault(fn.key, set()).add("api")
                self.witness.setdefault((fn.key, "api"), (fn.qualname,))

    def _propagate(self) -> None:
        edges: Dict[FnKey, List[FnKey]] = {}
        for fn in self.graph.by_key.values():
            for callee, _call in resolved_edges(self.graph, fn):
                if callee.key != fn.key:
                    edges.setdefault(fn.key, []).append(callee.key)
        for src, dst in self._callback_edges:
            if src != dst:
                edges.setdefault(src, []).append(dst)
        frontier = list(self.roles)
        while frontier:
            src = frontier.pop()
            src_roles = self.roles.get(src, ())
            for dst in edges.get(src, ()):
                have = self.roles.setdefault(dst, set())
                grew = False
                for role in src_roles:
                    if role not in have:
                        have.add(role)
                        chain = self.witness.get((src, role), ())
                        if len(chain) < 8:
                            self.witness[(dst, role)] = chain + (dst[1],)
                        else:
                            self.witness[(dst, role)] = chain
                        grew = True
                if grew:
                    frontier.append(dst)

    # ------------------------------------------------------------------ queries

    def roles_of(self, fn: FunctionInfo) -> Set[str]:
        return self.roles.get(fn.key, set())

    def witness_of(self, fn: FunctionInfo, role: str) -> str:
        """``role (via a -> b -> c)`` — the entry chain that carries ``role``
        to ``fn`` (just the role name when the chain is trivial)."""
        chain = self.witness.get((fn.key, role), ())
        if len(chain) > 1:
            return f"{role} (via {' -> '.join(chain)})"
        return role


def _fire_sites(fn: FunctionInfo) -> List[Tuple[str, ast.Call]]:
    """(registry attr, Call) for invocations of registry elements in ``fn``:
    ``for cb in self._subs: cb(...)`` (through list()/tuple()/sorted() wraps)
    and direct ``self._subs[k](...)`` subscript calls."""
    out: List[Tuple[str, ast.Call]] = []
    loop_vars: Dict[str, str] = {}  # loop variable -> registry attr
    for node in own_nodes(fn.node):
        if isinstance(node, (ast.For, ast.AsyncFor)) and isinstance(node.target, ast.Name):
            attr = _registry_iter_attr(node.iter)
            if attr is not None:
                loop_vars[node.target.id] = attr
    for node in own_nodes(fn.node):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id in loop_vars:
            out.append((loop_vars[node.func.id], node))
        elif isinstance(node.func, ast.Subscript):
            attr = _self_attr_of(node.func.value)
            if attr is not None:
                out.append((attr, node))
    return out


def _registry_iter_attr(iter_expr: ast.AST) -> Optional[str]:
    """The ``self.<attr>`` a firing loop iterates, unwrapping ``list(...)``-
    style copies and ``.values()`` views."""
    expr = iter_expr
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Name)
        and expr.func.id in _ITER_WRAPPERS
        and expr.args
    ):
        expr = expr.args[0]
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr in ("values", "copy")
        and not expr.args
    ):
        expr = expr.func.value
    return _self_attr_of(expr)


def thread_model(graph: CallGraph) -> ThreadModel:
    """One :class:`ThreadModel` per call graph, cached like the dataflow
    summaries — the four rules_races families all read it."""
    cached = getattr(graph, "_graftlint_threads", None)
    if cached is None:
        cached = ThreadModel(graph)
        graph._graftlint_threads = cached
    return cached
