"""Interprocedural dataflow for graftlint: provenance, blocking, locks.

The shared machinery the rule families build on:

- **Provenance.** Every tracked value is ``host``, ``device`` or unknown::

        unknown  (nothing provable — rules stay silent)
        host     (numpy arrays, python scalars, tensors made with
                  ``pin_memory=True`` or on the CPU, results of ``.cpu()`` /
                  ``.numpy()`` / ``.tolist()`` / ``.item()``, shape metadata)
        device   (torch factories and ``.to(...)`` / ``.cuda()`` onto a
                  device that is not the CPU, ops on device values, module
                  parameters and buffers, ``*_dev`` names and attributes)

  An unprovable provenance produces silence, never a guess: aliasing is
  tracked through plain assignments and attribute loads, and values of
  unscanned callees stay unknown. A name or class attribute assigned both a
  host and a device value is unknown.

- **Blocking summaries** (:class:`Summaries`): per-function "does calling this
  stall the calling thread" — direct primitives (``time.sleep``, unbounded
  ``.wait()``/``.join()``/``.result()``/``.acquire()``, ``subprocess.run``,
  ``torch.cuda.synchronize()``, ``.synchronize()`` of a stream or an event,
  and JAX's ``jax.device_get``/``.block_until_ready()``, which the shared
  fixture corpus keeps) propagated up resolved call edges to a fixpoint, with
  the call chain kept for the finding message.

- **Lock model** (:class:`LockModel`): lock identities ((module, class, attr)
  for ``self._lock = threading.Lock()`` in ``__init__``, (module, None, name)
  for module-level locks) and per-function acquisition summaries, again
  propagated interprocedurally so ``with self._lock: self.scheduler.submit()``
  yields the cross-class edge ``batcher._lock -> scheduler._lock``.

- **Device aliasing** (:func:`class_provenance` / :func:`local_provenance`):
  ``x = self._tokens`` followed by ``bool(x)`` is caught because
  ``self._tokens`` was assigned a device tensor in ``__init__`` and the local
  ``x`` inherits its provenance; the engine's pinned fetch buffers and numpy
  mirrors come out host, so reading them is no sync.
"""

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from unionml_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo, ModuleIndex, dotted

#: (module, class-or-None, attribute/name) — one lock's identity
LockKey = Tuple[str, Optional[str], str]

#: threading constructors that create a mutual-exclusion (``with``-able) lock
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

#: subprocess entry points that wait for the child
_SUBPROCESS_BLOCKING = {"run", "call", "check_call", "check_output", "communicate"}


def own_nodes(root: ast.AST) -> List[ast.AST]:
    """Walk ``root`` without descending into nested function/class bodies or
    lambdas — the nodes that execute as part of *this* function's frame.

    Function roots cache the materialized walk on the node: every rule family
    sweeps every function at least once, and re-generating the same ~300k
    nodes per family was a measurable slice of the lint budget."""
    is_fn = isinstance(root, (ast.FunctionDef, ast.AsyncFunctionDef))
    if is_fn:
        cached = getattr(root, "_graftlint_own", None)
        if cached is not None:
            return cached
    out: List[ast.AST] = []
    stack: List[ast.AST] = [root]
    first = True
    while stack:
        node = stack.pop()
        if not first and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            continue
        first = False
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    if is_fn:
        root._graftlint_own = out
    return out


def _call_map(fn: FunctionInfo) -> Dict[int, List[Tuple[str, str]]]:
    """id(Call node) -> callee candidates, cached per function (rules resolve
    individual sites; the list scan would be quadratic)."""
    cache = getattr(fn, "_graftlint_call_map", None)
    if cache is None:
        cache = {id(node): cands for cands, node in fn.calls}
        fn._graftlint_call_map = cache
    return cache


def resolved_edges(graph: CallGraph, fn: FunctionInfo) -> List[Tuple[FunctionInfo, ast.Call]]:
    """``fn``'s call sites with a scanned callee, resolved ONCE and cached —
    every interprocedural fixpoint iterates call edges repeatedly, and
    re-running candidate resolution each sweep dominated the lint wall time."""
    cache = getattr(fn, "_graftlint_edges", None)
    if cache is None:
        cache = []
        for candidates, call in fn.calls:
            callee = graph._resolve(candidates)
            if callee is not None:
                cache.append((callee, call))
        fn._graftlint_edges = cache
    return cache


def _has_timeout(call: ast.Call) -> bool:
    """True when the call passes any positional arg or a ``timeout=`` kwarg —
    bounded waits are stalls, not deadlocks, and stay out of scope."""
    return bool(call.args) or any(kw.arg == "timeout" for kw in call.keywords)


def blocking_reason(call: ast.Call, idx: ModuleIndex) -> Optional[str]:
    """Why this call blocks the current thread indefinitely (None if it
    doesn't, or if we cannot prove it does)."""
    name = dotted(call.func)
    if name is not None:
        root, _, rest = name.partition(".")
        expanded = idx.imports.get(root, root) + (("." + rest) if rest else "")
        if expanded == "time.sleep":
            return "time.sleep() sleeps the thread"
        if expanded in ("jax.device_get",):
            return "jax.device_get() blocks on the device stream"
        if expanded == "torch.cuda.synchronize":
            return "torch.cuda.synchronize() waits for the device"
        leaf = expanded.rsplit(".", 1)[-1]
        if expanded.startswith("subprocess.") and leaf in _SUBPROCESS_BLOCKING:
            return f"subprocess.{leaf}() waits for the child process"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr == "block_until_ready":
            return ".block_until_ready() blocks on the device stream"
        if attr == "synchronize" and not call.args and not call.keywords:
            return ".synchronize() waits for the device"
        if attr == "result" and not call.args and not call.keywords:
            return ".result() without a timeout blocks until the future resolves"
        if attr == "join" and not _has_timeout(call):
            # str.join always takes an iterable argument, so a zero-arg join is
            # a thread/process join
            return ".join() without a timeout blocks until the worker exits"
        if attr == "wait" and not _has_timeout(call):
            return ".wait() without a timeout blocks unboundedly"
        if attr == "acquire" and not _has_timeout(call):
            if not any(
                isinstance(kw.value, ast.Constant) and kw.value.value is False
                for kw in call.keywords
                if kw.arg == "blocking"
            ):
                return ".acquire() without a timeout blocks until the lock frees"
    return None


def _wait_receiver(call: ast.Call) -> Optional[ast.AST]:
    """The receiver of a ``.wait()`` call (condition-variable exemption)."""
    if isinstance(call.func, ast.Attribute) and call.func.attr == "wait":
        return call.func.value
    return None


# --------------------------------------------------------------------- locks


class LockModel:
    """Every lock the tree declares, plus helpers to name an acquisition."""

    def __init__(self, graph: CallGraph) -> None:
        self.locks: Set[LockKey] = set()
        #: parsed ``# lock-order: a < b`` hints: (module, line, a, b)
        self.hints: List[Tuple[str, int, str, str]] = []
        for idx in graph.indexes:
            self._collect_module(idx)

    def _collect_module(self, idx: ModuleIndex) -> None:
        for node in idx.source.tree.body:
            if isinstance(node, ast.Assign) and self._is_lock_ctor(node.value, idx):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.locks.add((idx.name, None, t.id))
        for cls_name, cls_node in idx.classes.items():
            for sub in ast.walk(cls_node):
                if isinstance(sub, ast.Assign) and self._is_lock_ctor(sub.value, idx):
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            self.locks.add((idx.name, cls_name, t.attr))

    @staticmethod
    def _is_lock_ctor(value: ast.AST, idx: ModuleIndex) -> bool:
        if not isinstance(value, ast.Call):
            return False
        name = dotted(value.func) or ""
        leaf = name.rsplit(".", 1)[-1]
        if leaf not in _LOCK_CTORS:
            return False
        root = name.split(".", 1)[0]
        target = idx.imports.get(root, root)
        # threading.Lock() / Lock() (from threading import Lock) /
        # multiprocessing.Lock(); a same-named user class would need the
        # ``# lock-order:`` hint instead
        return leaf == root or target in ("threading", "multiprocessing")

    def lock_of(self, expr: ast.AST, idx: ModuleIndex, cls: Optional[str]) -> Optional[LockKey]:
        """The lock an acquisition expression names, or None."""
        if isinstance(expr, ast.Call):  # with self._lock.acquire_timeout(...)
            expr = expr.func
            if isinstance(expr, ast.Attribute):
                expr = expr.value
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls is not None
        ):
            key = (idx.name, cls, expr.attr)
            return key if key in self.locks else None
        if isinstance(expr, ast.Name):
            key = (idx.name, None, expr.id)
            return key if key in self.locks else None
        return None

    def by_attr(self, module: str, attr: str) -> List[LockKey]:
        """Locks in ``module`` whose attribute/name is ``attr`` (hint lookup)."""
        return [k for k in self.locks if k[0] == module and k[2] == attr]


# ----------------------------------------------------------------- summaries


class BlockInfo:
    """Why a function blocks: the primitive's reason plus the call chain."""

    def __init__(self, reason: str, line: int, chain: Tuple[str, ...]) -> None:
        self.reason = reason
        self.line = line  # line of the primitive in ITS function
        self.chain = chain  # qualnames from this function down to the primitive

    def via(self, qualname: str) -> "BlockInfo":
        return BlockInfo(self.reason, self.line, (qualname,) + self.chain)


class Summaries:
    """Per-function interprocedural facts: blocking, lock acquisition.

    Both are least-fixpoints over resolved call edges; unresolvable calls
    contribute nothing (best-effort: silence over noise).
    """

    def __init__(self, graph: CallGraph, locks: LockModel) -> None:
        self.graph = graph
        self.locks = locks
        self.blocking: Dict[Tuple[str, str], BlockInfo] = {}
        self.acquires: Dict[Tuple[str, str], Set[LockKey]] = {}
        self._compute_direct()
        self._fixpoint()

    def _compute_direct(self) -> None:
        for idx in self.graph.indexes:
            for fn in idx.functions.values():
                acquired: Set[LockKey] = set()
                for node in own_nodes(fn.node):
                    if isinstance(node, (ast.With, ast.AsyncWith)):
                        for item in node.items:
                            key = self.locks.lock_of(item.context_expr, idx, fn.class_name)
                            if key is not None:
                                acquired.add(key)
                    elif isinstance(node, ast.Call) and fn.key not in self.blocking:
                        reason = blocking_reason(node, idx)
                        if reason is not None and not self._is_condition_wait(node, idx, fn):
                            self.blocking[fn.key] = BlockInfo(
                                reason, node.lineno, (fn.qualname,)
                            )
                if acquired:
                    self.acquires[fn.key] = acquired

    def _is_condition_wait(self, call: ast.Call, idx: ModuleIndex, fn: FunctionInfo) -> bool:
        """``cond.wait()`` where ``cond`` is a declared lock: the wait RELEASES
        the lock while parked (the condition-variable protocol), so it is not
        a blocking primitive for the under-lock rule; the surrounding loop's
        progress is the scheduler's business, not the linter's."""
        recv = _wait_receiver(call)
        return recv is not None and self.locks.lock_of(recv, idx, fn.class_name) is not None

    def _fixpoint(self) -> None:
        changed = True
        while changed:
            changed = False
            for idx in self.graph.indexes:
                for fn in idx.functions.values():
                    for callee, call in resolved_edges(self.graph, fn):
                        if callee.key == fn.key:
                            continue
                        info = self.blocking.get(callee.key)
                        if info is not None and fn.key not in self.blocking:
                            if len(info.chain) < 6:  # chains longer than this are noise
                                self.blocking[fn.key] = info.via(fn.qualname)
                                changed = True
                        callee_locks = self.acquires.get(callee.key)
                        if callee_locks:
                            mine = self.acquires.setdefault(fn.key, set())
                            if not callee_locks <= mine:
                                mine |= callee_locks
                                changed = True

    def resolve_call(self, fn: FunctionInfo, call: ast.Call) -> Optional[FunctionInfo]:
        """The scanned callee of one recorded call site of ``fn`` (None when
        unresolved or not this exact node)."""
        candidates = _call_map(fn).get(id(call))
        return self.graph._resolve(candidates) if candidates else None


def shared_analyses(graph: CallGraph) -> Tuple[LockModel, "Summaries"]:
    """One (LockModel, Summaries) pair per call graph — the lock-order and
    async-blocking rules share the fixpoint instead of recomputing it."""
    cached = getattr(graph, "_graftlint_analyses", None)
    if cached is None:
        locks = LockModel(graph)
        cached = (locks, Summaries(graph, locks))
        graph._graftlint_analyses = cached
    return cached




# ---------------------------------------------------------------- provenance

HOST = "host"
DEVICE = "device"

#: tensor methods whose result is a host value: a fetch, or metadata
HOST_METHODS = {
    "cpu", "numpy", "tolist", "item", "pin_memory",
    "size", "dim", "ndimension", "numel", "nelement", "stride", "data_ptr",
    "element_size", "storage_offset", "get_device", "is_contiguous",
    "is_floating_point", "is_complex",
}
#: tensor attributes that are host metadata
META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad", "is_leaf"}
#: torch factories: where no ``device=`` says otherwise, the result is on the CPU
_FACTORIES = {
    "zeros", "ones", "empty", "full", "arange", "linspace", "logspace", "eye", "rand",
    "randn", "randint", "randperm", "tensor", "as_tensor", "from_numpy", "empty_strided",
    "scalar_tensor", "frombuffer",
}
#: ``*_like`` factories: the device of their first argument unless ``device=`` is given
_LIKE = {"zeros_like", "ones_like", "empty_like", "full_like", "rand_like", "randn_like", "randint_like"}
#: torch functions whose result is a host value, not a tensor on a device
TORCH_HOST_FUNCS = {
    "is_tensor", "is_floating_point", "is_complex", "numel", "device", "dtype", "Size",
    "finfo", "iinfo", "get_default_dtype", "is_grad_enabled", "is_inference_mode_enabled",
    "result_type", "promote_types", "can_cast", "Generator", "no_grad", "enable_grad",
    "inference_mode", "manual_seed", "initial_seed", "get_rng_state",
}
#: builtins whose result is a host value
_HOST_BUILTINS = {"len", "int", "float", "bool", "str", "range", "isinstance", "hasattr", "repr", "id", "type"}


def device_literal(node: ast.AST) -> Optional[str]:
    """``"cpu"`` or ``"cuda"`` for a literal device (``"cuda:0"``,
    ``torch.device("cpu")``), else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if node.value.startswith("cpu"):
            return "cpu"
        if node.value.startswith("cuda"):
            return "cuda"
        return None
    if isinstance(node, ast.Call) and (dotted(node.func) or "").endswith("device") and node.args:
        return device_literal(node.args[0])
    return None


def _join(values) -> Optional[str]:
    """device when any value is, host when every value is, else unknown."""
    values = list(values)
    if DEVICE in values:
        return DEVICE
    if values and all(v == HOST for v in values):
        return HOST
    return None


def _names_device(node: ast.AST) -> bool:
    """A ``.to(...)`` argument that names a device by a variable."""
    name = dotted(node) or ""
    leaf = name.rsplit(".", 1)[-1].lower()
    return leaf.endswith("device") or leaf in ("dev", "device")


class Provenance:
    """Provenance of expressions in one function: the class attributes and
    the locals it knows to be host or device values."""

    def __init__(self, idx: ModuleIndex, dev_attrs: Set[str] = frozenset(), host_attrs: Set[str] = frozenset(),
                 dev_locals: Set[str] = frozenset(), host_locals: Set[str] = frozenset()) -> None:
        self.idx = idx
        self.dev_attrs, self.host_attrs = dev_attrs, host_attrs
        self.dev_locals, self.host_locals = dev_locals, host_locals

    def of(self, node: ast.AST) -> Optional[str]:
        """``HOST``, ``DEVICE`` or None (unknown) for one expression."""
        if isinstance(node, ast.Constant) or isinstance(node, ast.JoinedStr):
            return HOST
        if isinstance(node, ast.Name):
            if node.id.endswith("_dev") or node.id in self.dev_locals:
                return DEVICE
            if node.id.endswith("_host") or node.id in self.host_locals:
                return HOST
            return None
        if isinstance(node, ast.Attribute):
            if node.attr in META_ATTRS:
                return HOST
            if node.attr.endswith("_dev"):
                return DEVICE
            if node.attr.endswith("_host"):
                return HOST
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                if node.attr in self.dev_attrs:
                    return DEVICE
                if node.attr in self.host_attrs:
                    return HOST
                return None
            if node.attr in ("T", "mT", "real", "imag"):
                return self.of(node.value)
            return None
        if isinstance(node, ast.Subscript):
            return self.of(node.value)
        if isinstance(node, ast.Starred):
            return self.of(node.value)
        if isinstance(node, ast.BinOp):
            return _join((self.of(node.left), self.of(node.right)))
        if isinstance(node, ast.UnaryOp):
            return self.of(node.operand)
        if isinstance(node, ast.Compare):
            return _join([self.of(node.left)] + [self.of(c) for c in node.comparators])
        if isinstance(node, ast.BoolOp):
            return _join(self.of(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            body, orelse = self.of(node.body), self.of(node.orelse)
            return body if body == orelse else None
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            return _join(self.of(e) for e in node.elts)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            return self.of(node.elt)
        if isinstance(node, ast.Call):
            return self._of_call(node)
        return None

    def _of_call(self, call: ast.Call) -> Optional[str]:
        idx = self.idx
        name = idx.expand(call.func) or ""
        root, _, rest = name.partition(".")
        if root in ("numpy", "math"):
            return HOST
        if not rest and name in _HOST_BUILTINS:
            return HOST
        if root == "torch" and rest:
            leaf = rest.rsplit(".", 1)[-1]
            if leaf in TORCH_HOST_FUNCS or rest.startswith("cuda."):
                return HOST
            placed = self._placement(call)
            if leaf in _FACTORIES:
                return placed or HOST
            if leaf in _LIKE:
                return placed or (self.of(call.args[0]) if call.args else None)
            return _join(self.of(a) for a in call.args) if any(
                self.of(a) == DEVICE for a in call.args) else None
        if isinstance(call.func, ast.Attribute):
            method, recv = call.func.attr, call.func.value
            if method in HOST_METHODS:
                return HOST
            if method == "cuda":
                return DEVICE
            if method == "to":
                return self._placement(call, positional=True) or self.of(recv)
            if not (isinstance(recv, ast.Name) and recv.id in ("self", "cls")):
                return self.of(recv)  # a tensor method: where its receiver is
        return None

    def _placement(self, call: ast.Call, positional: bool = False) -> Optional[str]:
        """Where ``device=`` (or, for ``.to``, a positional device or tensor)
        puts a call's result: HOST, DEVICE or None (not said)."""
        for kw in call.keywords:
            if kw.arg == "pin_memory" and isinstance(kw.value, ast.Constant) and kw.value.value:
                return HOST
        candidates = [kw.value for kw in call.keywords if kw.arg == "device"]
        if positional:
            candidates += list(call.args)
        for arg in candidates:
            lit = device_literal(arg)
            if lit is not None:
                return HOST if lit == "cpu" else DEVICE
            if isinstance(arg, ast.Constant) and arg.value is None:
                continue
            if _names_device(arg):
                return DEVICE
            if positional and not (dotted(arg) or "").endswith("dtype") and self.of(arg) == DEVICE:
                return DEVICE  # .to(other_tensor)
            if not positional:
                return DEVICE  # device=<an expression>: the device the caller chose
        return None


def _assign_pairs(node: ast.AST) -> Iterator[Tuple[ast.AST, ast.AST]]:
    """(target, value) pairs of an assignment, tuples unpacked pairwise."""
    if isinstance(node, ast.Assign):
        targets, value = node.targets, node.value
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        targets, value = [node.target], node.value
    else:
        return
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)) and isinstance(value, (ast.Tuple, ast.List)) \
                and len(t.elts) == len(value.elts):
            yield from zip(t.elts, value.elts)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                yield el, value
        else:
            yield t, value


def _settle(found: Dict[str, Set[str]]) -> Tuple[Set[str], Set[str]]:
    """(device, host) names from every provenance each was assigned; a name
    assigned both, or any unknown value, is neither."""
    dev = {n for n, kinds in found.items() if kinds == {DEVICE}}
    host = {n for n, kinds in found.items() if kinds == {HOST}}
    return dev, host


def class_provenance(idx: ModuleIndex, cls_name: Optional[str]) -> Tuple[Set[str], Set[str]]:
    """(device, host) attributes of ``cls_name``: ``self.x`` assigned only
    device (host) values anywhere in the class body. ``nn.Parameter(...)``
    values and ``register_buffer`` names are device."""
    cache = idx.__dict__.setdefault("_graftlint_class_provenance", {})
    if cls_name in cache:
        return cache[cls_name]
    cls = idx.classes.get(cls_name) if cls_name else None
    if cls is None:
        return set(), set()
    dev: Set[str] = set()
    host: Set[str] = set()
    for _ in range(3):  # attribute-to-attribute chains are short
        prov = Provenance(idx, dev, host)
        found: Dict[str, Set[str]] = {}
        for node in ast.walk(cls):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "register_buffer" and node.args \
                    and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                found.setdefault(node.args[0].value, set()).add(DEVICE)
            for target, value in _assign_pairs(node):
                if isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name) \
                        and target.value.id == "self":
                    if isinstance(value, ast.Call) and (idx.expand(value.func) or "").endswith("nn.Parameter"):
                        kind = DEVICE
                    else:
                        kind = prov.of(value)
                    found.setdefault(target.attr, set()).add(kind)
        new_dev, new_host = _settle(found)
        if (new_dev, new_host) == (dev, host):
            break
        dev, host = new_dev, new_host
    cache[cls_name] = (dev, host)
    return dev, host


def local_provenance(fn: FunctionInfo) -> Provenance:
    """The provenance of ``fn``'s expressions: its class's attributes plus
    the locals its own assignments bind (a bounded forward fixpoint)."""
    cached = getattr(fn, "_graftlint_provenance", None)
    if cached is not None:
        return cached
    idx = fn.module
    dev_attrs, host_attrs = class_provenance(idx, fn.class_name)
    prov = Provenance(idx, dev_attrs, host_attrs, set(), set())
    for _ in range(3):  # alias chains are short; bounded fixpoint
        found: Dict[str, Set[str]] = {}
        for node in own_nodes(fn.node):
            for target, value in _assign_pairs(node):
                if isinstance(target, ast.Name):
                    found.setdefault(target.id, set()).add(prov.of(value))
        dev, host = _settle(found)
        if (dev, host) == (prov.dev_locals, prov.host_locals):
            break
        prov = Provenance(idx, dev_attrs, host_attrs, dev, host)
    fn._graftlint_provenance = prov
    return prov


def _mentions_shape(node: ast.AST, shape_names: Set[str]) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in ("shape", "ndim", "size", "dtype"):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) and sub.func.id == "len":
            return True
        if isinstance(sub, ast.Name) and sub.id in shape_names:
            return True
    return False


def shape_locals(fn: FunctionInfo) -> Set[str]:
    """Local names carrying shape arithmetic: assigned from expressions
    mentioning ``.shape``/``.ndim``/``.size``/``len()`` or other shape locals
    (``num_tokens, num_experts = gates.shape``). Conversions of these are
    python ints, never host syncs."""
    out: Set[str] = set()
    for _ in range(3):
        before = len(out)
        for node in own_nodes(fn.node):
            if not isinstance(node, ast.Assign):
                continue
            if not _mentions_shape(node.value, out):
                continue
            for t in node.targets:
                targets = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for el in targets:
                    if isinstance(el, ast.Name):
                        out.add(el.id)
        if len(out) == before:
            break
    return out
