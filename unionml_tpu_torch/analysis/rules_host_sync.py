"""Rule ``host-sync``: host synchronization and host↔device traffic in hot code.

Two walks, two severity models:

1. **Captured bodies** (functions reachable from a body recorded into a CUDA
   graph or compiled: see :mod:`.callgraph`): here a host sync is a
   *correctness* hazard. ``.item()``, ``.tolist()``, ``.cpu()``,
   ``.numpy()``, ``.to("cpu")``, ``bool()/int()/float()`` of a tensor,
   ``if``/``while`` on a tensor expression and the data-dependent-shape ops
   (``nonzero``, ``masked_select``, ``unique``, ``equal``, ``is_nonzero``)
   wait for the device, which a capture refuses (or a compiled body breaks
   its graph on), and a copy of host data onto the device is baked into the
   graph as the value it had at capture time.
2. **Host hot paths** (functions reachable from a ``# graftlint: hot-path``
   root, pruned at ``# graftlint: off-path``): here the hazard is a *stall*.
   The same syncs on device values, plus ``torch.cuda.synchronize()`` and a
   stream's or an event's ``.synchronize()``, serialize the host on the
   device, which is exactly what the pipelined decode engine exists to
   avoid. The designed once-per-burst fetch carries a reasoned suppression;
   anything new fails CI. A finding names its witness: the call chain from
   the root.

The walk is a call-graph traversal (``CallGraph.reachable``), not a
syntactic scan: a helper three calls below ``DecodeEngine.step`` is as hot as
``step``. Values are judged by their provenance (:mod:`.dataflow`): the
engine's pinned fetch buffers and numpy mirrors are host values, so reading
them is no sync. Shape arithmetic (``.shape``, ``.size()``, ``len()``) is
host metadata and never one.
"""

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from unionml_tpu_torch.analysis.callgraph import FunctionInfo, dotted
from unionml_tpu_torch.analysis.core import Finding, Project, register
from unionml_tpu_torch.analysis.dataflow import (
    DEVICE,
    HOST,
    TORCH_HOST_FUNCS,
    Provenance,
    device_literal,
    local_provenance,
    shape_locals,
)

#: tensor methods that copy a value to the host
_FETCH_METHODS = ("item", "tolist", "cpu", "numpy")
#: ops whose output shape depends on the data: they wait for the device
#: (``_graphs._SYNCING_OPS``, by their Python names)
_SYNCING_OPS = {"nonzero", "masked_select", "unique", "unique_consecutive", "equal", "is_nonzero", "argwhere"}
#: numpy entry points that pull a tensor to the host
_NP_SYNCS = {"asarray", "array"}
#: conversions that read a tensor's value on the host
_CONVERSIONS = {"bool", "int", "float"}

FnKey = Tuple[str, str]


def _expr_mentions_shape(node: ast.AST) -> bool:
    """Shape/size arithmetic is host metadata — never a sync."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in ("shape", "ndim", "size", "dtype"):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) and sub.func.id == "len":
            return True
    return False


def _torch_op_in(node: ast.AST, idx) -> bool:
    """The expression calls a torch op that yields a tensor."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = idx.expand(sub.func) or ""
            root, _, rest = name.partition(".")
            if root == "torch" and rest and rest.rsplit(".", 1)[-1] not in TORCH_HOST_FUNCS \
                    and not rest.startswith("cuda."):
                return True
    return False


def _witness(key: FnKey, parents: Dict[FnKey, Optional[FnKey]], graph) -> str:
    chain: List[str] = []
    seen: Set[FnKey] = set()
    while key is not None and key not in seen:
        seen.add(key)
        chain.append(graph.by_key[key].qualname)
        key = parents.get(key)
    return " -> ".join(reversed(chain))


def _finding(fn: FunctionInfo, node: ast.AST, message: str, where: str) -> Finding:
    return Finding(
        "host-sync", fn.module.source.relpath, node.lineno, node.col_offset,
        f"{message} ({where})", symbol=fn.qualname,
    )


def _is_cpu_move(call: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(device="cpu")``."""
    args = list(call.args) + [kw.value for kw in call.keywords if kw.arg == "device"]
    return any(device_literal(a) == "cpu" for a in args)


def _host_store(node: ast.AST, prov: Provenance) -> Optional[ast.AST]:
    """The target of ``x_dev[i] = v`` (or ``x_dev[i] += v``) where ``x_dev``
    is a device tensor and ``v`` no device value: PyTorch copies ``v`` from
    the host, and the card's sync debug mode reports the copy as a sync."""
    if isinstance(node, ast.Assign):
        targets, value = node.targets, node.value
    elif isinstance(node, ast.AugAssign):
        targets, value = [node.target], node.value
    else:
        return None
    for target in targets:
        if isinstance(target, ast.Subscript) and prov.of(target.value) == DEVICE and prov.of(value) != DEVICE:
            return target
    return None


def _syncing_op(call: ast.Call, idx, prov: Provenance, on_device_only: bool) -> Optional[str]:
    """The name of a data-dependent-shape op this call runs, if any."""
    name = idx.expand(call.func) or ""
    root, _, rest = name.partition(".")
    if root == "torch" and rest in _SYNCING_OPS:
        args = call.args
    elif root == "torch" and rest == "where" and len(call.args) == 1 and not call.keywords:
        return "torch.where(condition)"
    elif isinstance(call.func, ast.Attribute) and call.func.attr in _SYNCING_OPS:
        args = [call.func.value]
    else:
        return None
    if on_device_only and not any(prov.of(a) == DEVICE for a in args):
        return None
    if not on_device_only and args and all(prov.of(a) == HOST for a in args):
        return None
    return rest if root == "torch" else f".{call.func.attr}()"


def _check_captured_body(fn: FunctionInfo, where: str) -> Iterator[Finding]:
    idx = fn.module
    prov = local_provenance(fn)
    shape_derived: Set[str] = None  # lazily: aliases of shape arithmetic
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call):
            func = node.func
            name = idx.expand(func) or ""
            method = func.attr if isinstance(func, ast.Attribute) else None
            recv = func.value if isinstance(func, ast.Attribute) else None
            op = _syncing_op(node, idx, prov, on_device_only=False)
            if op is not None:
                yield _finding(fn, node, f"{op} inside a captured body has a data-dependent shape: "
                               "it waits for the device, which a CUDA graph cannot hold", where)
            elif method in _FETCH_METHODS and not node.args and prov.of(recv) != HOST:
                yield _finding(fn, node, f".{method}() inside a captured body copies to the host: "
                               "the capture fails, or the graph bakes the value in", where)
            elif method == "to" and _is_cpu_move(node) and prov.of(recv) != HOST:
                yield _finding(fn, node, '.to("cpu") inside a captured body copies to the host: '
                               "the capture fails, or the graph bakes the value in", where)
            elif name == "torch.cuda.synchronize" or (method == "synchronize" and not node.args):
                yield _finding(fn, node, f"{dotted(func) or method}() inside a captured body "
                               "waits for the device", where)
            elif name in ("torch.tensor", "torch.as_tensor") and any(
                    kw.arg == "device" and device_literal(kw.value) != "cpu" for kw in node.keywords) and (
                    name == "torch.tensor" or not node.args or prov.of(node.args[0]) != DEVICE):
                yield _finding(fn, node, f"{name}() of host data onto the device inside a captured body: "
                               "the graph replays the copy of the value it had at capture time", where)
            elif method in ("to", "cuda") and not _is_cpu_move(node) and prov.of(recv) == HOST \
                    and prov.of(node) == DEVICE:
                yield _finding(fn, node, f".{method}() of a host value inside a captured body: "
                               "the graph replays the copy of the value it had at capture time", where)
            elif name.startswith("numpy.") and name.rsplit(".", 1)[-1] in _NP_SYNCS and node.args and (
                    prov.of(node.args[0]) == DEVICE or _torch_op_in(node.args[0], idx)):
                yield _finding(fn, node, f"{dotted(func)}() of a tensor inside a captured body copies "
                               "it to the host", where)
            elif isinstance(func, ast.Name) and func.id in _CONVERSIONS and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) or _expr_mentions_shape(arg):
                    continue
                if prov.of(arg) != DEVICE and not _torch_op_in(arg, idx):
                    continue  # a python value: read at capture time, no sync
                if shape_derived is None:
                    shape_derived = shape_locals(fn)
                if {sub.id for sub in ast.walk(arg) if isinstance(sub, ast.Name)} & shape_derived:
                    continue
                yield _finding(fn, node, f"{func.id}() of a tensor inside a captured body reads it "
                               "on the host (the capture fails, or the graph bakes the value in)", where)
        elif isinstance(node, (ast.If, ast.While)) and not _expr_mentions_shape(node.test) and (
                prov.of(node.test) == DEVICE or _torch_op_in(node.test, idx)):
            yield _finding(fn, node.test, "branching on a tensor inside a captured body is an implicit "
                           "bool() host sync; use torch.where", where)
        elif _host_store(node, prov) is not None:
            yield _finding(fn, node, "storing a host value into a device tensor inside a captured body copies "
                           "it from the host: the graph replays the value it had at capture time", where)


def _device_names_in(arg: ast.AST, prov: Provenance) -> List[str]:
    """Names/attrs in ``arg`` provably holding device values."""
    hits: List[str] = []
    for sub in ast.walk(arg):
        if isinstance(sub, (ast.Name, ast.Attribute)) and prov.of(sub) == DEVICE:
            hits.append(dotted(sub) or ast.unparse(sub))
    return hits


def _check_host_hot_path(fn: FunctionInfo, where: str) -> Iterator[Finding]:
    idx = fn.module
    prov = local_provenance(fn)
    for node in ast.walk(fn.node):
        if isinstance(node, (ast.If, ast.While)):
            if not _expr_mentions_shape(node.test) and prov.of(node.test) == DEVICE:
                yield _finding(fn, node.test, "branching on a device tensor on the steady-state host path "
                               "fetches it every tick; keep the decision on the device", where)
            continue
        if _host_store(node, prov) is not None:
            yield _finding(fn, node, "storing a host value into a device tensor on the steady-state host "
                           "path is a blocking host-to-device copy; keep the value on the device", where)
            continue
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = idx.expand(func) or ""
        method = func.attr if isinstance(func, ast.Attribute) else None
        recv = func.value if isinstance(func, ast.Attribute) else None
        op = _syncing_op(node, idx, prov, on_device_only=True)
        if name == "torch.cuda.synchronize" or (method == "synchronize" and not node.args and not node.keywords):
            yield _finding(fn, node, f"{dotted(func) or method}() on the steady-state host path waits "
                           "for the device and stalls dispatch-ahead", where)
        elif op is not None:
            yield _finding(fn, node, f"{op} of a device tensor on the steady-state host path has a "
                           "data-dependent shape and waits for the device", where)
        elif method in _FETCH_METHODS and not node.args and prov.of(recv) == DEVICE:
            yield _finding(fn, node, f".{method}() of a device tensor on the steady-state host path "
                           "blocks on the device stream; fuse it into the designed fetch", where)
        elif method == "to" and _is_cpu_move(node) and prov.of(recv) == DEVICE:
            yield _finding(fn, node, '.to("cpu") of a device tensor on the steady-state host path '
                           "blocks on the device stream", where)
        elif name.startswith("numpy.") and name.rsplit(".", 1)[-1] in _NP_SYNCS and node.args \
                and prov.of(node.args[0]) == DEVICE:
            yield _finding(fn, node, f"{dotted(func)}() of a device tensor on the steady-state host "
                           "path copies it to the host", where)
        elif isinstance(func, ast.Name) and func.id in _CONVERSIONS and node.args:
            arg = node.args[0]
            if _expr_mentions_shape(arg) or prov.of(arg) != DEVICE:
                continue
            hits = _device_names_in(arg, prov) or [ast.unparse(arg)]
            yield _finding(
                fn, node,
                f"{func.id}() on device-resident value(s) {', '.join(sorted(set(hits)))} "
                "fetches to the host every tick; keep the decision on device "
                "or batch the fetch", where,
            )


def hot_set(graph, parents: Optional[Dict[FnKey, Optional[FnKey]]] = None) -> Set[FnKey]:
    """The functions of the host hot path: reachable from a ``hot-path`` root,
    pruned at ``off-path`` and at captured bodies (``parents``: see
    ``CallGraph.reachable``)."""
    return graph.reachable(graph.hot_roots(), stop_markers=("off-path",), skip_traced=True, parents=parents)


def _function_at(idx, line: int) -> Optional[FunctionInfo]:
    """The innermost function of a module whose body spans ``line``."""
    best = None
    for fn in idx.functions.values():
        if fn.node.lineno <= line <= fn.node.end_lineno and (best is None or fn.node.lineno > best.node.lineno):
            best = fn
    return best


def runtime_site(project: Project, stack: Sequence) -> Optional[Dict[str, object]]:
    """Where a sync observed at run time lies for this rule.

    ``stack`` is the Python stack at the sync, outermost frame first (a
    ``traceback.extract_stack()``). Returns None when no frame lies in a
    linted file; else, for the innermost linted frame: its ``path``,
    ``line`` and ``function``; ``static_hot``, whether the function is in
    the rule's hot set (:func:`hot_set`); ``dynamic_hot``, whether the
    run-time path reached it from a ``hot-path`` root through no ``off-path``
    or captured function (the run-time counterpart of the hot set); and
    ``suppression``, the reason of a ``host-sync`` suppression at the line,
    or None. A sync with ``dynamic_hot`` true and no suppression is one the
    rule should have flagged."""
    graph = project.graph
    cached = getattr(project, "_graftlint_runtime", None)
    if cached is None:
        cached = project._graftlint_runtime = (
            {str(Path(idx.source.path).resolve()): idx for idx in graph.indexes}, hot_set(graph))
    by_path, hot = cached
    frames = []
    for frame in stack:
        idx = by_path.get(str(Path(frame.filename).resolve()))
        if idx is not None:
            frames.append((idx, frame, _function_at(idx, frame.lineno)))
    if not frames:
        return None
    idx, frame, fn = frames[-1]
    dynamic = False
    for i, (_, _, caller) in enumerate(frames):
        if caller is not None and caller.marker == "hot-path":
            dynamic = all(f is None or (f.marker != "off-path" and not f.traced) for _, _, f in frames[i + 1:])
            break
    sup = idx.source.suppression_for("host-sync", frame.lineno)
    return {
        "path": idx.source.relpath, "line": frame.lineno, "function": fn.qualname if fn is not None else None,
        "static_hot": fn is not None and fn.key in hot, "dynamic_hot": dynamic,
        "suppression": sup.reason if sup is not None else None,
    }


@register(
    "host-sync",
    "host syncs/transfers inside captured bodies or hot host paths (call-graph walk)",
)
def check(project: Project) -> Iterator[Finding]:
    graph = project.graph
    traced_parents: Dict[FnKey, Optional[FnKey]] = {}
    traced = graph.reachable(graph.trace_roots(), parents=traced_parents)
    hot_parents: Dict[FnKey, Optional[FnKey]] = {}
    hot = hot_set(graph, hot_parents)
    emitted: List[Finding] = []
    seen: Set[Tuple] = set()
    for key in sorted(traced):
        where = "captured: " + _witness(key, traced_parents, graph)
        for f in _check_captured_body(graph.by_key[key], where):
            if (f.path, f.line, f.col) not in seen:  # a nested def is walked with its parent too
                seen.add((f.path, f.line, f.col))
                emitted.append(f)
    for key in sorted(hot - traced):
        where = "hot: " + _witness(key, hot_parents, graph)
        for f in _check_host_hot_path(graph.by_key[key], where):
            if (f.path, f.line, f.col) not in seen:
                seen.add((f.path, f.line, f.col))
                emitted.append(f)
    yield from emitted
