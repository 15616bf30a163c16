"""Rule ``async-blocking``: blocking calls inside ``async def`` bodies.

The serving surface is a single asyncio event loop (`serving/app.py`,
`serving/batcher.py`, the FastAPI adapter): one handler that blocks — a
compiled predictor call, a device fetch, an unbounded ``.result()`` — stalls
EVERY in-flight request, not just its own. The engine code routes such work
through ``run_in_executor``; this rule mechanically holds that line:

- direct blocking primitives in an async body (``time.sleep``, unbounded
  ``.wait()`` / ``.join()`` / ``.result()`` / ``.acquire()``,
  ``subprocess.run``, ``torch.cuda.synchronize()``, ``.synchronize()``);
- calls that resolve — through the call graph, including instance types
  (``predictor = ResidentPredictor(...)`` then ``predictor.predict(...)``) —
  to a scanned function that TRANSITIVELY blocks; the finding carries the
  chain down to the primitive.

Awaited calls are exempt (``await queue.get()`` parks the coroutine, not the
loop), and nested ``def`` / ``lambda`` bodies are skipped — they execute under
whatever frame actually calls them (usually an executor thread, which is the
fix this rule suggests).
"""

import ast
from typing import Iterator, Set

from unionml_tpu_torch.analysis.callgraph import FunctionInfo, ModuleIndex
from unionml_tpu_torch.analysis.core import Finding, Project, register
from unionml_tpu_torch.analysis.dataflow import (
    Summaries,
    blocking_reason,
    own_nodes,
    shared_analyses,
)


def _awaited_calls(fn_node: ast.AST) -> Set[int]:
    """ids of Call nodes directly under an Await (parked, not blocking)."""
    out: Set[int] = set()
    for node in own_nodes(fn_node):
        if isinstance(node, ast.Await) and isinstance(node.value, ast.Call):
            out.add(id(node.value))
    return out


def _check_async_fn(
    fn: FunctionInfo, idx: ModuleIndex, summaries: Summaries
) -> Iterator[Finding]:
    awaited = _awaited_calls(fn.node)
    for node in own_nodes(fn.node):
        if not isinstance(node, ast.Call) or id(node) in awaited:
            continue
        reason = blocking_reason(node, idx)
        if reason is not None:
            yield Finding(
                "async-blocking",
                idx.source.relpath,
                node.lineno,
                node.col_offset,
                f"blocking call in async handler: {reason} — the event loop "
                f"stalls for every in-flight request; await an async "
                f"equivalent or run it in an executor",
                symbol=fn.qualname,
            )
            continue
        callee = summaries.resolve_call(fn, node)
        if callee is None:
            continue
        info = summaries.blocking.get(callee.key)
        if info is not None:
            chain = " -> ".join(info.chain)
            yield Finding(
                "async-blocking",
                idx.source.relpath,
                node.lineno,
                node.col_offset,
                f"call in async handler blocks the event loop: {chain} reaches "
                f"'{info.reason}'; run it in an executor "
                f"(loop.run_in_executor) or make the handler sync so the "
                f"framework threadpools it",
                symbol=fn.qualname,
            )


@register(
    "async-blocking",
    "blocking calls inside async def handlers (event-loop stalls; dataflow chains)",
)
def check(project: Project):
    graph = project.graph
    _locks, summaries = shared_analyses(graph)
    for idx in graph.indexes:
        for fn in idx.functions.values():
            if fn.is_async:
                yield from _check_async_fn(fn, idx, summaries)
