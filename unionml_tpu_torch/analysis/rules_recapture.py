"""Rule ``recapture``: graph and compiled-callable patterns that capture or
compile again and again.

The port's counterpart of a ``jax.jit`` executable is a CUDA graph (one per
key of a :class:`~unionml_tpu_torch._graphs.GraphCache` or an engine's
program table) or a ``torch.compile`` callable. A capture costs two eager
runs and a recording; a compile costs far more. Checks:

- **unbucketed key** — the ``key`` a capture wrapper caches its graph under
  (``GraphCache.lookup(key, ...)``, ``DecodeEngine._run_program(key, ...)``)
  is built from a runtime size (``.shape``, ``.size()``, ``len()``,
  ``.numel()``) that no bucketing call rounds first: one capture per distinct
  size, without bound. A key drawn from a bucket ladder passes.
- **built per call** — a graph builder's result called on the spot
  (``torch.compile(f)(x)``, ``capture(f, args, kwargs)(tree)``): nothing
  keeps it, so every call captures or compiles anew.
- **built in a loop** — ``torch.cuda.CUDAGraph()``, ``torch.compile``,
  ``torch.cuda.make_graphed_callables`` or a function that builds a graph
  itself, called inside a ``for``/``while`` body or a comprehension: a new
  graph per iteration.
"""

import ast
from typing import Iterator

from unionml_tpu_torch.analysis.callgraph import TORCH_BUILDERS, FunctionInfo
from unionml_tpu_torch.analysis.core import Finding, Project, register
from unionml_tpu_torch.analysis.dataflow import _call_map


def _is_builder(call: ast.Call, idx, graph, candidates) -> bool:
    if idx.resolves_to(call.func, *TORCH_BUILDERS):
        return True
    callee = graph._resolve(candidates) if candidates else None
    return callee is not None and callee.builds_graph


def _runtime_size(node: ast.AST) -> bool:
    """The expression reads a runtime size that no bucketing call rounds."""
    if isinstance(node, ast.Call):
        name = ast.unparse(node.func).lower()
        if "bucket" in name:
            return False
        if isinstance(node.func, ast.Name) and node.func.id == "len":
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr in ("size", "numel"):
            return True
    if isinstance(node, ast.Attribute) and node.attr == "shape":
        return True
    return any(_runtime_size(child) for child in ast.iter_child_nodes(node))


def _key_arg(callee: FunctionInfo, call: ast.Call):
    """The argument ``call`` passes at ``callee``'s parameter ``key``."""
    for kw in call.keywords:
        if kw.arg == "key":
            return kw.value
    bound = callee.class_name is not None and not callee.is_static and isinstance(call.func, ast.Attribute)
    position = callee.params.index("key") - (1 if bound else 0)
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            return None
        if i == position:
            return arg
    return None


@register("recapture", "CUDA-graph/compiled-callable patterns that capture or compile per call")
def check(project: Project) -> Iterator[Finding]:
    graph = project.graph
    for idx in graph.indexes:
        relpath = idx.source.relpath
        for owner, candidates, call in idx.loop_calls:
            if _is_builder(call, idx, graph, candidates):
                yield Finding(
                    "recapture", relpath, call.lineno, call.col_offset,
                    f"{ast.unparse(call.func)}() inside a loop builds a new graph or compiled "
                    "callable per iteration; hoist it out of the loop or cache it by key",
                    symbol=owner.qualname if owner is not None else "",
                )
        for fn in idx.functions.values():
            for candidates, call in fn.calls:
                if isinstance(call.func, ast.Call) and _is_builder(
                        call.func, idx, graph, _call_map(fn).get(id(call.func))):
                    yield Finding(
                        "recapture", relpath, call.lineno, call.col_offset,
                        f"{ast.unparse(call.func.func)}(...) is called on the spot: nothing keeps the "
                        "graph or compiled callable, so every call builds it anew; build it once",
                        symbol=fn.qualname,
                    )
                callee = graph._resolve(candidates)
                if callee is None or callee.key not in graph.wrappers or "key" not in callee.params:
                    continue
                arg = _key_arg(callee, call)
                if arg is not None and _runtime_size(arg):
                    yield Finding(
                        "recapture", relpath, arg.lineno, arg.col_offset,
                        f"the key of capture wrapper '{callee.qualname}' is built from a runtime "
                        "size no bucketing call rounds: one capture per distinct size, without "
                        "bound; round it to a bucket ladder first",
                        symbol=fn.qualname,
                    )
