"""Project-wide AST index: functions, call edges, capture roots.

Static call resolution is deliberately best-effort (a linter, not a compiler):

- ``f(...)`` resolves through the lexical scope chain — enclosing function's
  nested defs, then module-level defs, then imports into other scanned modules.
- ``self.m(...)`` resolves to the enclosing class's method ``m``.
- ``alias.f(...)`` resolves when ``alias`` imports a scanned module.
- anything else (callables from parameters, attributes of objects, returns of
  factories) is skipped — unresolvable edges drop out of the walk rather than
  producing noise.

Trace roots are the functions whose bodies are recorded into a CUDA graph or
compiled, where a host sync either fails the capture or bakes a constant into
the graph. They are discovered from:

- ``@torch.compile`` / ``@torch.compile(...)`` decorators and the first
  argument of ``torch.compile(f)`` / ``torch.cuda.make_graphed_callables(f)``;
- every callee of a call made inside a ``with torch.cuda.graph(...)`` body;
- capture wrappers, found by a fixpoint over the call graph: a traced body
  that calls a parameter of its own or of an enclosing function makes that
  function a wrapper at that parameter (``_graphs.capture``'s nested ``run``
  calls ``capture``'s ``fn``), and a function that forwards its own parameter
  to a wrapper's position is a wrapper too (``DecodeEngine._run_program``,
  ``GraphCache.lookup``). Whatever a call passes at a wrapper's position is
  traced: a function name, a bound method (``self._burst``), a
  ``functools.partial`` of one, or a ``lambda``, whose callees are traced.

Graph builders (``torch.cuda.CUDAGraph()``, ``torch.compile``,
``torch.cuda.make_graphed_callables`` and every function that builds a graph
itself) are recorded with the loops they sit in for the ``recapture`` rule.

Instance types: ``x = ClassName(...)`` (locals, lexically visible to nested
defs) and ``self.attr = ClassName(...)`` in ``__init__`` are recorded when
``ClassName`` is a scanned class — same module or imported from one — so
``x.m(...)`` and ``self.attr.m(...)`` resolve to ``ClassName.m`` across
modules. This is what lets the dataflow rules follow a lock acquisition or a
blocking call into another module's class.
"""

import ast
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

FnKey = Tuple[str, str]
#: one argument of a call as the capture inference sees it: the function
#: whose parameter it names (or None), that parameter's name, the callee
#: candidates of every function it denotes, and the (owner, parameter) pairs
#: a ``lambda`` argument calls
ArgRec = Tuple[Optional[FnKey], Optional[str], List[List[FnKey]], List[Tuple[FnKey, str]]]

#: torch callables whose first argument becomes a compiled or captured body
_TORCH_WRAPPERS = ("torch.compile", "torch.cuda.make_graphed_callables")
#: torch callables that build a graph or a compiled callable (recapture rule)
TORCH_BUILDERS = ("torch.compile", "torch.cuda.make_graphed_callables", "torch.cuda.CUDAGraph")
#: the context manager whose body is recorded into a CUDA graph
_GRAPH_CONTEXTS = ("torch.cuda.graph",)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class FunctionInfo:
    """One function/method definition and its outgoing call edges."""

    def __init__(self, module: "ModuleIndex", qualname: str, node: ast.AST,
                 class_name: Optional[str]) -> None:
        self.module = module
        self.qualname = qualname
        self.node = node
        self.class_name = class_name
        self.traced = False  # body is recorded into a CUDA graph or compiled
        self.marker: Optional[str] = None  # "hot-path" | "off-path"
        self.is_async = isinstance(node, ast.AsyncFunctionDef)
        #: raw call sites: (callee key candidates, Call node)
        self.calls: List[Tuple[List[Tuple[str, str]], ast.Call]] = []
        #: local name -> (module, ClassName) for ``x = ClassName(...)`` bindings
        self.instance_types: Dict[str, Tuple[str, str]] = {}
        args = node.args
        #: positional parameter names, and every parameter name
        self.params: List[str] = [a.arg for a in args.posonlyargs + args.args]
        self.all_params: Set[str] = set(self.params) | {a.arg for a in args.kwonlyargs} | {
            a.arg for a in (args.vararg, args.kwarg) if a is not None}
        self.is_static = any(dotted(d) == "staticmethod" for d in node.decorator_list)
        #: id(Call) -> [(position or keyword, ArgRec)] (capture inference)
        self.call_args: Dict[int, List[Tuple[object, ArgRec]]] = {}
        #: (function, parameter) pairs this body calls: a parameter of its own
        #: or of an enclosing function (capture inference)
        self.param_calls: List[Tuple[FnKey, str]] = []
        #: the body builds a CUDA graph or a compiled callable itself
        self.builds_graph = False

    @property
    def key(self) -> Tuple[str, str]:
        return (self.module.name, self.qualname)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<fn {self.module.name}:{self.qualname}{' traced' if self.traced else ''}>"


class ModuleIndex(ast.NodeVisitor):
    """Per-module symbol table (functions, imports, aliases, capture sites)."""

    def __init__(self, source) -> None:
        self.source = source
        self.name = source.name
        self.functions: Dict[str, FunctionInfo] = {}
        #: local name -> imported dotted target ("np" -> "numpy",
        #: "init_cache" -> "unionml_tpu_torch.models.gpt.init_cache")
        self.imports: Dict[str, str] = {}
        #: class name -> ClassDef node (instance-type resolution)
        self.classes: Dict[str, ast.ClassDef] = {}
        #: class name -> {attr: (module, ClassName)} for ``self.x = Cls(...)``
        #: bindings in ``__init__`` (cross-module method resolution)
        self.attr_types: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: callee candidates whose functions are traced outright: callees in
        #: ``with torch.cuda.graph`` bodies, ``torch.compile``'s argument
        self.trace_seeds: List[List[FnKey]] = []
        #: (function, parameter) pairs called inside a ``with torch.cuda.graph``
        #: body: the function is a capture wrapper at that parameter
        self.wrapper_seeds: List[Tuple[FnKey, str]] = []
        #: calls made inside a loop or comprehension: (owner, candidates, Call)
        self.loop_calls: List[Tuple[Optional[FunctionInfo], List[FnKey], ast.Call]] = []
        self._scope: List[str] = []
        self._class: List[str] = []
        self._loops = 0
        self._graph_depth = 0
        self.visit(source.tree)
        self._attach_markers()

    # ---------------------------------------------------------------- helpers

    def expand(self, node: ast.AST) -> Optional[str]:
        """The dotted name ``node`` denotes, its root import alias expanded
        (``np.asarray`` -> ``numpy.asarray``); None for other expressions."""
        name = dotted(node)
        if name is None:
            return None
        root, _, rest = name.partition(".")
        if root in self.imports:
            return self.imports[root] + (("." + rest) if rest else "")
        return name

    def resolves_to(self, node: ast.AST, *targets: str) -> bool:
        """True when the call's func node denotes any of the dotted ``targets``
        (through import aliases: ``np.asarray`` -> ``numpy.asarray``)."""
        name = dotted(node)
        if name is None:
            return False
        return self.expand(node) in targets or name in targets

    def _qual(self, name: str) -> str:
        return ".".join(self._scope + [name]) if self._scope else name

    def _attach_markers(self) -> None:
        for line, marker in self.source.markers.items():
            for fn in self.functions.values():
                start = min(
                    [fn.node.lineno] + [d.lineno for d in fn.node.decorator_list]
                )
                if start <= line <= fn.node.body[0].lineno - 1 or line == fn.node.lineno:
                    fn.marker = marker
                    break

    # ---------------------------------------------------------------- imports

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.imports[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module is None or node.level:
            return  # relative imports: out of scope for a best-effort graph
        for a in node.names:
            self.imports[a.asname or a.name] = f"{node.module}.{a.name}"

    # -------------------------------------------------------------- definitions

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if not self._scope:
            self.classes[node.name] = node
        self._scope.append(node.name)
        self._class.append(node.name)
        self.generic_visit(node)
        self._class.pop()
        self._scope.pop()

    def _visit_function(self, node) -> None:
        qual = self._qual(node.name)
        info = FunctionInfo(self, qual, node, self._class[-1] if self._class else None)
        self.functions[qual] = info
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if self.resolves_to(target, *_TORCH_WRAPPERS):
                info.traced = True
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # ------------------------------------------------------------- assignments

    def visit_Assign(self, node: ast.Assign) -> None:
        self._bind_instance_type(node)
        self.generic_visit(node)

    def _class_key_of(self, value: ast.AST) -> Optional[Tuple[str, str]]:
        """(module, ClassName) when ``value`` constructs a (possibly) scanned
        class — ``Cls(...)``, ``mod.Cls(...)``, or a conditional expression with
        such an arm. Liberal: non-class callees simply never resolve later."""
        if isinstance(value, ast.IfExp):
            return self._class_key_of(value.body) or self._class_key_of(value.orelse)
        if not isinstance(value, ast.Call):
            return None
        name = dotted(value.func)
        if name is None:
            return None
        root, _, rest = name.partition(".")
        if rest:  # mod.Cls(...): resolve the module alias
            target = self.imports.get(root)
            if target is not None:
                return (target, rest)
            return None
        if name in self.classes:
            return (self.name, name)
        target = self.imports.get(name)
        if target is not None and "." in target:
            mod, _, cls = target.rpartition(".")
            return (mod, cls)
        return None

    def _bind_instance_type(self, node: ast.Assign) -> None:
        """Record ``x = Cls(...)`` (function locals) and ``self.a = Cls(...)``
        (``__init__`` attrs) so method calls resolve across modules."""
        key = self._class_key_of(node.value)
        if key is None or len(node.targets) != 1:
            return
        target = node.targets[0]
        owner = self._enclosing_function()
        if isinstance(target, ast.Name) and owner is not None:
            owner.instance_types[target.id] = key
        elif (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
            and self._class
            and owner is not None
            and owner.qualname.endswith("__init__")
        ):
            self.attr_types.setdefault(self._class[-1], {})[target.attr] = key

    # ------------------------------------------------------------------- loops

    def _visit_loop(self, node) -> None:
        self._loops += 1
        self.generic_visit(node)
        self._loops -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop
    visit_ListComp = _visit_loop
    visit_SetComp = _visit_loop
    visit_DictComp = _visit_loop
    visit_GeneratorExp = _visit_loop

    # ------------------------------------------------------------ graph bodies

    def _visit_with(self, node) -> None:
        graph = any(
            isinstance(item.context_expr, ast.Call)
            and self.resolves_to(item.context_expr.func, *_GRAPH_CONTEXTS)
            for item in node.items
        )
        for item in node.items:
            self.visit(item)
        if graph:
            owner = self._enclosing_function()
            if owner is not None:
                owner.builds_graph = True
            self._graph_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if graph:
            self._graph_depth -= 1

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    # ------------------------------------------------------------------- calls

    def visit_Call(self, node: ast.Call) -> None:
        candidates = self._callee_candidates(node.func)
        owner = self._enclosing_function() if self._scope else None
        if owner is not None:
            owner.calls.append((candidates, node))
            owner.call_args[id(node)] = self._arg_records(node)
            if isinstance(node.func, ast.Name):
                param_owner = self._param_owner(node.func.id)
                if param_owner is not None:
                    owner.param_calls.append((param_owner, node.func.id))
        if self._graph_depth:
            self.trace_seeds.append(candidates)
            if isinstance(node.func, ast.Name):
                param_owner = self._param_owner(node.func.id)
                if param_owner is not None:
                    self.wrapper_seeds.append((param_owner, node.func.id))
        if self.resolves_to(node.func, *_TORCH_WRAPPERS) and node.args:
            self.trace_seeds.extend(self.function_targets(node.args[0]))
        if owner is not None and self.resolves_to(node.func, *TORCH_BUILDERS):
            owner.builds_graph = True
        if self._loops:
            self.loop_calls.append((owner, candidates, node))
        self.generic_visit(node)

    def _enclosing_function(self) -> Optional[FunctionInfo]:
        # innermost enclosing def in the qualname chain
        for i in range(len(self._scope), 0, -1):
            info = self.functions.get(".".join(self._scope[:i]))
            if info is not None:
                return info
        return None

    def _param_owner(self, name: str) -> Optional[FnKey]:
        """The innermost enclosing function with a parameter ``name``."""
        for i in range(len(self._scope), 0, -1):
            info = self.functions.get(".".join(self._scope[:i]))
            if info is not None and name in info.all_params:
                return info.key
        return None

    def function_targets(self, arg: ast.AST) -> List[List[FnKey]]:
        """Callee candidates of the functions an argument denotes: a name or a
        bound method, a ``functools.partial`` of one, or a lambda's callees."""
        if isinstance(arg, (ast.Name, ast.Attribute)):
            return [self._callee_candidates(arg)]
        if isinstance(arg, ast.Lambda):
            return [self._callee_candidates(c.func) for c in ast.walk(arg.body) if isinstance(c, ast.Call)]
        if isinstance(arg, ast.Call) and (dotted(arg.func) or "").rsplit(".", 1)[-1] == "partial" and arg.args:
            return self.function_targets(arg.args[0])
        return []

    def _arg_record(self, arg: ast.AST) -> ArgRec:
        owner = self._param_owner(arg.id) if isinstance(arg, ast.Name) else None
        inner: List[Tuple[FnKey, str]] = []
        if isinstance(arg, ast.Lambda):
            for c in ast.walk(arg.body):
                if isinstance(c, ast.Call) and isinstance(c.func, ast.Name):
                    param_owner = self._param_owner(c.func.id)
                    if param_owner is not None:
                        inner.append((param_owner, c.func.id))
        return (owner, arg.id if owner else None, self.function_targets(arg), inner)

    def _arg_records(self, call: ast.Call) -> List[Tuple[object, ArgRec]]:
        out: List[Tuple[object, ArgRec]] = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break  # positions past a splat are unknowable
            out.append((i, self._arg_record(arg)))
        for kw in call.keywords:
            if kw.arg is not None:
                out.append((kw.arg, self._arg_record(kw.value)))
        return out

    def _callee_candidates(self, func: ast.AST) -> List[Tuple[str, str]]:
        """(module, qualname) candidates for one call's callee."""
        out: List[Tuple[str, str]] = []
        if isinstance(func, ast.Name):
            # nested defs visible from the current scope, innermost first
            for i in range(len(self._scope), -1, -1):
                out.append((self.name, ".".join(self._scope[:i] + [func.id])))
            target = self.imports.get(func.id)
            if target and "." in target:
                mod, _, fn = target.rpartition(".")
                out.append((mod, fn))
        elif isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name) and base.id == "self" and self._class:
                out.append((self.name, f"{self._class[-1]}.{func.attr}"))
                # an inherited method: the scanned base classes', nearest first
                out.extend((mod, f"{cls}.{func.attr}") for mod, cls in self._bases(self._class[-1]))
                # self.attr.m(...) is handled below; self.m(...) may also be an
                # attr holding an instance of a scanned class — not expressible
            elif isinstance(base, ast.Name):
                key = self._instance_type_of(base.id)
                if key is not None:
                    out.append((key[0], f"{key[1]}.{func.attr}"))
                if base.id in self.imports:
                    out.append((self.imports[base.id], func.attr))
            elif (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and self._class
            ):
                # self.attr.m(...): attr's class recorded from __init__
                key = self.attr_types.get(self._class[-1], {}).get(base.attr)
                if key is not None:
                    out.append((key[0], f"{key[1]}.{func.attr}"))
        return out

    def _bases(self, cls_name: str, depth: int = 0) -> List[Tuple[str, str]]:
        """(module, ClassName) of ``cls_name``'s base classes: same-module
        bases recursively, imported ones one level deep."""
        node = self.classes.get(cls_name)
        if node is None or depth > 4:
            return []
        out: List[Tuple[str, str]] = []
        for base in node.bases:
            name = dotted(base)
            if name is None:
                continue
            if name in self.classes:
                out.append((self.name, name))
                out.extend(self._bases(name, depth + 1))
                continue
            target = self.imports.get(name.split(".", 1)[0])
            if target is None:
                continue
            if "." in name:  # mod.Base
                out.append((target, name.split(".", 1)[1]))
            elif "." in target:  # from mod import Base
                mod, _, cls = target.rpartition(".")
                out.append((mod, cls))
        return out

    def _instance_type_of(self, name: str) -> Optional[Tuple[str, str]]:
        """``name``'s recorded instance class, searching the lexical chain of
        enclosing functions innermost-first (a nested def sees its enclosing
        function's locals)."""
        for i in range(len(self._scope), 0, -1):
            info = self.functions.get(".".join(self._scope[:i]))
            if info is not None and name in info.instance_types:
                return info.instance_types[name]
        return None


class CallGraph:
    """All modules' indexes plus reachability over resolved call edges."""

    def __init__(self, modules: Sequence) -> None:
        self.indexes: List[ModuleIndex] = [ModuleIndex(m) for m in modules]
        self.by_key: Dict[Tuple[str, str], FunctionInfo] = {}
        for idx in self.indexes:
            for fn in idx.functions.values():
                self.by_key[fn.key] = fn
        #: capture wrappers: function -> the parameters whose argument is
        #: recorded into a graph (see the module's docstring)
        self.wrappers: Dict[FnKey, Set[str]] = {}
        self._infer_capture()

    def _infer_capture(self) -> None:
        for idx in self.indexes:
            for candidates in idx.trace_seeds:
                fn = self._resolve(candidates)
                if fn is not None:
                    fn.traced = True
            for owner, name in idx.wrapper_seeds:
                self._add_wrapper(owner, name)
        edges = []
        for fn in self.by_key.values():
            for candidates, call in fn.calls:
                callee = self._resolve(candidates)
                if callee is not None:
                    edges.append((fn, callee, call))
        changed = True
        while changed:
            changed = False
            for fn in self.by_key.values():
                if fn.traced:
                    for owner, name in fn.param_calls:
                        changed |= self._add_wrapper(owner, name)
            for fn, callee, call in edges:
                names = self.wrappers.get(callee.key)
                if not names:
                    continue
                for owner, name, targets, inner in self.args_at(callee, call, fn.call_args.get(id(call), ()), names):
                    if owner is not None:
                        changed |= self._add_wrapper(owner, name)
                    for inner_owner, inner_name in inner:
                        changed |= self._add_wrapper(inner_owner, inner_name)
                    for candidates in targets:
                        target = self._resolve(candidates)
                        if target is not None and not target.traced:
                            target.traced = True
                            changed = True

    def _add_wrapper(self, key: FnKey, name: str) -> bool:
        names = self.wrappers.setdefault(key, set())
        if name in names:
            return False
        names.add(name)
        return True

    @staticmethod
    def args_at(callee: FunctionInfo, call: ast.Call, records, names: Set[str]) -> List[ArgRec]:
        """The records of ``call``'s arguments that land in ``callee``'s
        parameters ``names`` (a bound method's ``self`` takes no argument)."""
        bound = callee.class_name is not None and not callee.is_static and isinstance(call.func, ast.Attribute)
        positional = callee.params[1:] if bound else callee.params
        out: List[ArgRec] = []
        for slot, rec in records:
            name = positional[slot] if isinstance(slot, int) and slot < len(positional) else slot
            if name in names:
                out.append(rec)
        return out

    def trace_roots(self) -> List[FunctionInfo]:
        return [fn for fn in self.by_key.values() if fn.traced]

    def hot_roots(self) -> List[FunctionInfo]:
        return [fn for fn in self.by_key.values() if fn.marker == "hot-path"]

    def reachable(self, roots: Sequence[FunctionInfo], *,
                  stop_markers: Sequence[str] = (),
                  skip_traced: bool = False,
                  parents: Optional[Dict[FnKey, Optional[FnKey]]] = None) -> Set[Tuple[str, str]]:
        """Breadth-first walk over resolved call edges from ``roots``.

        ``stop_markers`` prunes functions carrying those graftlint markers
        (e.g. ``off-path`` branches of a hot root); ``skip_traced`` keeps a
        host-side walk from descending into captured bodies. ``parents``,
        when given, receives each reached function's caller on a shortest
        path from a root (None for the roots): the witness chains.
        """
        seen: Set[Tuple[str, str]] = set()
        frontier = deque((fn, None) for fn in roots)
        while frontier:
            fn, parent = frontier.popleft()
            if fn.key in seen:
                continue
            seen.add(fn.key)
            if parents is not None:
                parents[fn.key] = parent
            for candidates, _node in fn.calls:
                callee = self._resolve(candidates)
                if callee is None or callee.key in seen:
                    continue
                if callee.marker in stop_markers:
                    continue
                if skip_traced and callee.traced:
                    continue
                frontier.append((callee, fn.key))
        return seen

    def _resolve(self, candidates: Sequence[Tuple[str, str]]) -> Optional[FunctionInfo]:
        for key in candidates:
            fn = self.by_key.get(key)
            if fn is not None:
                return fn
        return None
