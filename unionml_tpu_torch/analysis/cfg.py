"""Intra-procedural control-flow graphs with exception edges (graftlint v3).

The v2 rule families walk statements linearly; that cannot answer the question
the resource rules ask — "is there an *execution path* from this acquire to a
function exit that skips the release?". This module builds a per-function CFG
whose edges make every such path explicit, including the ones Python hides:

- **Exception edges.** Every content block carries exactly one ``except`` edge
  to the innermost construct that would see an exception raised there: the
  enclosing ``try``'s handler-dispatch block, a ``finally`` copy, or the
  function's exceptional exit (``rexit``). The edge is *explicit* when the
  block's statement is a ``raise`` (it WILL fire) and *implicit* otherwise (it
  MAY fire — a call or subscript could throw). Rules choose which implicit
  edges to believe; ``assert`` is deliberately implicit so test files stay
  quiet.
- **Handler dispatch.** A ``try`` with handlers gets a synthetic ``dispatch``
  block: ``handler`` edges fan out to each handler's entry, and a
  ``propagate`` edge continues to the outer context for the unmatched case —
  unless some handler is broad (bare / ``Exception`` / ``BaseException``),
  which provably terminates propagation.
- **``finally`` duplication.** A ``finally`` body runs on normal completion,
  on every ``return``/``break``/``continue`` that jumps over it, and on
  exception propagation — each with a different continuation. The body is
  built once per *continuation* (blocks duplicated, AST nodes shared) and
  memoized, so ``return`` inside nested ``try/finally`` chains the copies
  innermost-first exactly as the interpreter does.
- **Loops.** ``while``/``for`` headers are branch blocks (``true`` enters the
  body, ``false`` leaves); the body's fall-through returns on a ``back`` edge,
  which is how a loop-carried acquire (re-acquired before the previous
  iteration released) becomes plain graph reachability.
- **Granularity.** One simple statement per block. Compound headers contribute
  ``(node, role)`` items: ``("test")`` for ``if``/``while`` conditions,
  ``("for")`` for loop headers (binds the target, iterates the iterable),
  ``("with")`` for ``with`` headers, ``("handler")`` for ``except`` clauses.
  Nested ``def``/``class`` statements are opaque single items (analyzed under
  their own frame); ``match`` is opaque too.
- **Regions.** Every block records the tuple of ``except`` handlers lexically
  enclosing it, so the swallowed-exception rule can ask "does this handler
  fall through into code outside itself?" without re-walking the AST.

``with`` is modeled without ``__exit__`` edges (context managers release their
own resource; the resource rules skip acquires in ``withitem.context_expr``
entirely). The graph is best-effort in the graftlint tradition: anything it
cannot model precisely errs toward *fewer* paths, so rules stay silent rather
than guessing.
"""

import ast
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Block", "Edge", "CFG", "build_cfg", "reachable", "path_to"]

#: edge kinds every rule follows unconditionally (``except`` is the only
#: conditional kind: explicit edges fire for sure, implicit ones only may)
ALWAYS_KINDS = frozenset({"flow", "true", "false", "back", "handler", "propagate", "return"})


class Edge:
    """One directed CFG edge. ``kind`` ∈ {flow, true, false, back, handler,
    propagate, return, except}; ``explicit`` is meaningful for ``except`` only
    (True: the source block is a ``raise`` statement)."""

    __slots__ = ("dst", "kind", "explicit")

    def __init__(self, dst: int, kind: str, explicit: bool = False) -> None:
        self.dst = dst
        self.kind = kind
        self.explicit = explicit

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        mark = "!" if self.explicit else ""
        return f"-{self.kind}{mark}->{self.dst}"


class Block:
    """One CFG node: at most one simple statement (or one compound header).

    ``kind`` ∈ {entry, exit, rexit, normal, branch, join, dispatch, handler,
    finally}; ``items`` is a list of ``(ast node, role)`` pairs with role ∈
    {stmt, test, for, with, handler}; ``regions`` the enclosing
    ``ast.ExceptHandler`` nodes, innermost last.
    """

    __slots__ = ("id", "kind", "items", "edges", "regions")

    def __init__(self, bid: int, kind: str, regions: Tuple[ast.ExceptHandler, ...]) -> None:
        self.id = bid
        self.kind = kind
        self.items: List[Tuple[ast.AST, str]] = []
        self.edges: List[Edge] = []
        self.regions = regions

    @property
    def line(self) -> int:
        """First source line of the block's content (0 for synthetic blocks)."""
        for node, _role in self.items:
            ln = getattr(node, "lineno", None)
            if ln is not None:
                return ln
        return 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<block {self.id} {self.kind} L{self.line} {self.edges}>"


class CFG:
    """A function's (or module's) control-flow graph."""

    def __init__(self, func: ast.AST) -> None:
        self.func = func
        self.blocks: Dict[int, Block] = {}
        self._next = 0
        self.entry = self._new("entry", ()).id
        self.exit = self._new("exit", ()).id
        self.rexit = self._new("rexit", ()).id
        self._preds: Optional[Dict[int, List[Tuple[int, Edge]]]] = None

    def _new(self, kind: str, regions: Tuple[ast.ExceptHandler, ...]) -> Block:
        b = Block(self._next, kind, regions)
        self._next += 1
        self.blocks[b.id] = b
        return b

    def preds(self) -> Dict[int, List[Tuple[int, Edge]]]:
        """Reverse adjacency: block id -> [(source block id, edge)]."""
        if self._preds is None:
            p: Dict[int, List[Tuple[int, Edge]]] = {bid: [] for bid in self.blocks}
            for b in self.blocks.values():
                for e in b.edges:
                    p[e.dst].append((b.id, e))
            self._preds = p
        return self._preds


def _handler_is_broad(handler: ast.ExceptHandler) -> bool:
    """Bare ``except`` / ``Exception`` / ``BaseException`` (incl. in tuples):
    provably terminates propagation, so the dispatch gets no outward edge."""
    t = handler.type
    if t is None:
        return True
    for n in t.elts if isinstance(t, ast.Tuple) else [t]:
        leaf = n.attr if isinstance(n, ast.Attribute) else getattr(n, "id", "")
        if leaf in ("Exception", "BaseException"):
            return True
    return False


_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_TRYS = (ast.Try,) + ((ast.TryStar,) if hasattr(ast, "TryStar") else ())


class _Builder:
    """Sequential CFG construction with a dangling-edge cursor.

    ``frames`` is the stack of enclosing constructs that reroute nonlocal
    exits (raise / return / break / continue): ``("trybody", try_node,
    dispatch_block_or_None, snapshot)`` while building a ``try`` body,
    ``("tryrest", try_node, snapshot)`` in its handlers/else (where a raise
    runs the ``finally`` and propagates OUTWARD, not into this try's own
    handlers), and ``("loop", after_id, header_id)``. ``snapshot`` captures
    the (frames, regions) surrounding the try — ``finally`` copies are built
    under it, because code in a ``finally`` raises into the try's *outer*
    context.
    """

    def __init__(self, func: ast.AST) -> None:
        self.cfg = CFG(func)
        self.frames: List[tuple] = []
        self.regions: Tuple[ast.ExceptHandler, ...] = ()
        #: (source block, edge kind, explicit) awaiting the next block
        self.dangling: List[Tuple[int, str, bool]] = []
        self._fin_memo: Dict[Tuple[int, int], int] = {}

    def build(self) -> CFG:
        self.dangling = [(self.cfg.entry, "flow", False)]
        self._build_stmts(self.cfg.func.body)
        self._connect(self.cfg.exit, "flow")
        return self.cfg

    # ------------------------------------------------------------------ cursor

    def _connect(self, target: int, kind: Optional[str] = None) -> None:
        for src, k, ex in self.dangling:
            self.cfg.blocks[src].edges.append(Edge(target, kind or k, ex))
        self.dangling = []

    def _start_block(self, kind: str = "normal") -> Block:
        b = self.cfg._new(kind, self.regions)
        self._connect(b.id)
        return b

    # ----------------------------------------------------------------- routing

    def _route(self, kind: str) -> int:
        """Target block for a nonlocal exit of ``kind`` from here, chaining
        ``finally`` copies innermost-first like the interpreter."""
        fins: List[tuple] = []
        base: Optional[int] = None
        for frame in reversed(self.frames):
            tag = frame[0]
            if tag == "trybody":
                _, tnode, dispatch, snap = frame
                if kind == "raise" and dispatch is not None:
                    base = dispatch.id  # handlers first; finally runs later
                    break
                if tnode.finalbody:
                    fins.append((tnode, snap))
            elif tag == "tryrest":
                _, tnode, snap = frame
                if tnode.finalbody:
                    fins.append((tnode, snap))
            elif tag == "loop" and kind in ("break", "continue"):
                base = frame[1] if kind == "break" else frame[2]
                break
        if base is None:
            base = self.cfg.rexit if kind == "raise" else self.cfg.exit
        for tnode, snap in reversed(fins):  # outermost copy built first
            base = self._finally_copy(tnode, base, snap)
        return base

    def _finally_copy(self, node: ast.AST, continuation: int, snapshot: tuple) -> int:
        """Blocks for ``node.finalbody`` ending in an edge to ``continuation``
        — one copy per continuation, memoized (AST nodes shared between
        copies). Built under the try's OUTER context: a raise inside the
        ``finally`` replaces the in-flight exception and propagates outward."""
        key = (id(node), continuation)
        got = self._fin_memo.get(key)
        if got is not None:
            return got
        saved = (self.frames, self.regions, self.dangling)
        self.frames, self.regions = list(snapshot[0]), snapshot[1]
        entry = self.cfg._new("finally", self.regions)
        self._fin_memo[key] = entry.id  # before building: recursion guard
        self.dangling = [(entry.id, "flow", False)]
        self._build_stmts(node.finalbody)
        self._connect(continuation)
        self.frames, self.regions, self.dangling = saved
        return entry.id

    # -------------------------------------------------------------- statements

    def _build_stmts(self, stmts) -> None:
        for stmt in stmts:
            self._build_stmt(stmt)

    def _build_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.If):
            self._build_if(stmt)
        elif isinstance(stmt, _LOOPS):
            self._build_loop(stmt)
        elif isinstance(stmt, _TRYS):
            self._build_try(stmt)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._build_with(stmt)
        else:
            self._build_simple(stmt)

    def _build_simple(self, stmt: ast.stmt) -> None:
        b = self._start_block()
        b.items.append((stmt, "stmt"))
        b.edges.append(Edge(self._route("raise"), "except", isinstance(stmt, ast.Raise)))
        if isinstance(stmt, ast.Raise):
            return  # the except edge is the only successor
        if isinstance(stmt, ast.Return):
            b.edges.append(Edge(self._route("return"), "return"))
            return
        if isinstance(stmt, ast.Break):
            b.edges.append(Edge(self._route("break"), "flow"))
            return
        if isinstance(stmt, ast.Continue):
            b.edges.append(Edge(self._route("continue"), "flow"))
            return
        self.dangling = [(b.id, "flow", False)]

    def _build_if(self, node: ast.If) -> None:
        b = self._start_block("branch")
        b.items.append((node.test, "test"))
        b.edges.append(Edge(self._route("raise"), "except", False))
        self.dangling = [(b.id, "true", False)]
        self._build_stmts(node.body)
        then_d = self.dangling
        self.dangling = [(b.id, "false", False)]
        self._build_stmts(node.orelse)
        self.dangling = self.dangling + then_d

    def _build_loop(self, node) -> None:
        header = self._start_block("branch")
        if isinstance(node, ast.While):
            header.items.append((node.test, "test"))
        else:
            header.items.append((node, "for"))
        header.edges.append(Edge(self._route("raise"), "except", False))
        after = self.cfg._new("join", self.regions)
        self.frames.append(("loop", after.id, header.id))
        self.dangling = [(header.id, "true", False)]
        self._build_stmts(node.body)
        self._connect(header.id, "back")
        self.frames.pop()
        self.dangling = [(header.id, "false", False)]
        self._build_stmts(node.orelse)  # runs on exhaustion, skipped by break
        self._connect(after.id)
        self.dangling = [(after.id, "flow", False)]

    def _build_with(self, node) -> None:
        b = self._start_block()
        b.items.append((node, "with"))
        b.edges.append(Edge(self._route("raise"), "except", False))
        self.dangling = [(b.id, "flow", False)]
        self._build_stmts(node.body)

    def _build_try(self, node) -> None:
        snapshot = (list(self.frames), self.regions)
        has_fin = bool(node.finalbody)
        dispatch = self.cfg._new("dispatch", self.regions) if node.handlers else None
        self.frames.append(("trybody", node, dispatch, snapshot))
        self._build_stmts(node.body)
        self.frames.pop()
        if node.orelse:
            # exceptions in ``else`` are NOT caught by this try's handlers
            self.frames.append(("tryrest", node, snapshot))
            self._build_stmts(node.orelse)
            self.frames.pop()
        body_d = self.dangling
        handler_d: List[Tuple[int, str, bool]] = []
        if dispatch is not None:
            for h in node.handlers:
                self.frames.append(("tryrest", node, snapshot))
                self.regions = self.regions + (h,)
                self.dangling = [(dispatch.id, "handler", False)]
                hb = self._start_block("handler")
                hb.items.append((h, "handler"))
                hb.edges.append(Edge(self._route("raise"), "except", False))
                self.dangling = [(hb.id, "flow", False)]
                self._build_stmts(h.body)
                handler_d.extend(self.dangling)
                self.dangling = []
                self.regions = self.regions[:-1]
                self.frames.pop()
            if not any(_handler_is_broad(h) for h in node.handlers):
                # unmatched exception: runs the finally, then propagates
                saved = (self.frames, self.regions)
                self.frames, self.regions = list(snapshot[0]), snapshot[1]
                target = self._route("raise")
                if has_fin:
                    target = self._finally_copy(node, target, snapshot)
                self.frames, self.regions = saved
                dispatch.edges.append(Edge(target, "propagate"))
        self.dangling = body_d + handler_d
        if has_fin:
            # the normal-completion finally is built inline (the canonical
            # copy); nonlocal exits got their own copies via _route
            saved = (self.frames, self.regions)
            self.frames, self.regions = list(snapshot[0]), snapshot[1]
            self._build_stmts(node.finalbody)
            self.frames, self.regions = saved


def build_cfg(func: ast.AST) -> CFG:
    """CFG for a ``FunctionDef`` / ``AsyncFunctionDef`` / ``Module`` (any node
    with a statement-list ``body``)."""
    return _Builder(func).build()


def reachable(
    cfg: CFG,
    start: int,
    *,
    follow: Callable[[Block, Edge], bool],
    stop: Optional[Callable[[Block], bool]] = None,
) -> Dict[int, Optional[int]]:
    """BFS parent map from ``start``. ``follow(block, edge)`` gates each edge;
    a block matching ``stop`` is visited but not expanded (its successors stay
    unreachable through it). ``start`` itself is always expanded."""
    parents: Dict[int, Optional[int]] = {start: None}
    frontier = [start]
    while frontier:
        bid = frontier.pop()
        block = cfg.blocks[bid]
        if stop is not None and bid != start and stop(block):
            continue
        for e in block.edges:
            if e.dst not in parents and follow(block, e):
                parents[e.dst] = bid
                frontier.append(e.dst)
    return parents


def path_to(parents: Dict[int, Optional[int]], target: int) -> List[int]:
    """Block-id path from the BFS start to ``target`` (inclusive)."""
    out: List[int] = []
    cur: Optional[int] = target
    while cur is not None:
        out.append(cur)
        cur = parents.get(cur)
    out.reverse()
    return out
