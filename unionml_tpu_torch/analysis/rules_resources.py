"""Rule family ``resource-leak`` / ``double-release`` / ``unbalanced-transfer``:
path-sensitive paired-resource lifetime checking (graftlint v3).

The serving stack is full of linear resources — things acquired by one call
that MUST reach exactly one release: KV-block pins, prefix-cache refcounts,
engine slots, scheduler tickets, telemetry traces, file handles. v2's rules
could not see the paths between acquire and release; chaos tests found the
leaks, but only on the schedules they happened to exercise. This family walks
the :mod:`unionml_tpu_torch.analysis.cfg` exception-edge CFG instead, so "an
exception between ``pin`` and ``requeue`` drops the pin on the floor" becomes
plain graph reachability.

**Resource spec table.** Each :class:`ResourceSpec` names a resource class and
its acquire/release signatures. Matching is *textual* (leaf method name plus a
receiver-hint substring), deliberately: the acquiring objects are usually
constructor parameters (``self._engine``, ``self.prefix_cache``), which the
call graph cannot type, and a lifetime checker that only fires on resolvable
receivers would be blind exactly where it matters.

========  ===========================================  =============================
class     acquires                                     releases
========  ===========================================  =============================
kv-pin    ``*prefix_cache*.pin(k)``,                   ``*prefix_cache*.unpin(k)``,
          ``k = *engine*.preempt(...)``                ``*engine*.release_preempted(k)``
kv-block  ``k = *allocator*.alloc_blocks(...)``,       ``*allocator*.free_blocks(k)``,
          ``k = self._alloc_slot_blocks(...)``         ``self._free_slot_blocks(k)``,
                                                       ``*prefix_cache*.adopt(k, ...)``
kv-ref    ``k, _ = *prefix_cache*.match(...)``,        ``*prefix_cache*.release(k)``
          ``k, _ = *prefix_cache*.extend(...)``
trace     ``k = *telemetry*.new_trace(...)``           ``*telemetry*.end_trace(k)``
slot      ``k = *engine*.admit(...)`` / ``admit_many`` ``*engine*.cancel(k)``
ticket    ``k = *scheduler*.make_ticket(...)``         ``*scheduler*.submit(k)``,
                                                       ``*scheduler*.requeue(k)``
handle    ``k = open(...)``                            ``k.close()``, ``os.close(k)``
========  ===========================================  =============================

**Finding shapes.**

- *leak-on-exception-path* (rule ``resource-leak``): from an acquire, a path
  along exception edges reaches the function's exceptional exit without a
  release, an ownership transfer, or the value escaping (returned, raised,
  stored into state, handed to another call). Implicit (may-throw) exception
  edges are followed only for ``strict`` resource classes, and only out of
  blocks that call back into project code; explicit ``raise`` edges always.
  The same walk reports *normal-exit* leaks (classes with ``exit_leak``) and
  *loop-carried* acquires (the back edge re-runs the acquire while the
  previous one is still held).
- *double-release* (rule ``double-release``): from a release, a path with no
  re-acquire, rebind, or escape of the key reaches a second release.
- *unbalanced-transfer* (rule ``unbalanced-transfer``): a function annotated
  ``# transfers: <class>`` releases the resource on a path that still returns
  it — both sides of the transfer would release.

**Ownership contracts.** Three comment annotations (parsed in
:mod:`unionml_tpu_torch.analysis.core`, same family as ``# guarded-by:``):

- ``# transfers: <class>`` on a ``def``: the return value carries the
  resource; callers acquire it, this function must not also release what it
  returns.
- ``# owns: <class>`` on a ``def``: this function is the release point for
  resources handed to it. The contract is checked — a function annotated
  ``owns`` that no longer releases (directly or via a callee that
  releases/owns) is itself a finding, with its callers as the witness chain.
- ``# holds: <class>`` on a ``self.<attr> = ...`` line in ``__init__``: the
  attribute stores live resources; any other plain overwrite of it must sit
  in a function that releases the class (or is annotated ``owns``), and
  swap-reads (``a, self.x = self.x, []``) are exempt.

Summaries (which functions release/return which classes) propagate over v2's
resolved call graph to a fixpoint, so ``self.discard_salvage()`` counts as a
kv-pin release inside ``_capture_salvage`` without any annotation. Everything
unprovable errs toward silence: unresolvable keys, attribute-bound results,
and container round-trips drop out of tracking rather than guessing.
"""

import ast
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from unionml_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo, ModuleIndex
from unionml_tpu_torch.analysis.cfg import (
    ALWAYS_KINDS,
    CFG,
    Block,
    build_cfg,
    path_to,
    reachable,
)
from unionml_tpu_torch.analysis.core import Finding, Project, register
from unionml_tpu_torch.analysis.dataflow import _call_map, own_nodes, resolved_edges

#: interprocedural summary chains stop growing past this depth (mirrors
#: dataflow.Summaries — deep chains stop being actionable witnesses)
_MAX_CHAIN = 6


class Sig:
    """One acquire/release signature: leaf method name, receiver-hint
    substring ('' = any receiver, including none), and where the key lives —
    ``arg`` (first positional), ``result`` (assigned name), ``recv``
    (the receiver itself, e.g. ``f.close()``)."""

    __slots__ = ("method", "hint", "keyed")

    def __init__(self, method: str, hint: str, keyed: str) -> None:
        self.method = method
        self.hint = hint
        self.keyed = keyed


class ResourceSpec:
    """One resource class in the spec table."""

    __slots__ = (
        "name", "noun", "acquires", "releases", "strict", "escape_call_arg",
        "raise_ok", "exit_leak",
    )

    def __init__(
        self,
        name: str,
        noun: str,
        acquires: Tuple[Sig, ...],
        releases: Tuple[Sig, ...],
        *,
        strict: bool = False,
        escape_call_arg: bool = False,
        raise_ok: bool = False,
        exit_leak: bool = True,
    ) -> None:
        self.name = name
        self.noun = noun
        self.acquires = acquires
        self.releases = releases
        #: follow implicit (may-throw) exception edges out of blocks that call
        #: project code — device-memory pins justify the extra paths
        self.strict = strict
        #: any call taking the key escapes it (loose handoff protocols)
        self.escape_call_arg = escape_call_arg
        #: exceptions are an accepted exit (the surrounding failure machinery
        #: reclaims the resource) — no except edges at all
        self.raise_ok = raise_ok
        #: falling off the end without a release is a leak too
        self.exit_leak = exit_leak


SPECS: Tuple[ResourceSpec, ...] = (
    ResourceSpec(
        "kv-pin",
        "KV-block pin",
        acquires=(Sig("pin", "prefix_cache", "arg"), Sig("preempt", "engine", "result")),
        releases=(
            Sig("unpin", "prefix_cache", "arg"),
            Sig("release_preempted", "engine", "arg"),
        ),
        strict=True,
        exit_leak=False,
    ),
    ResourceSpec(
        # paged serving: a block-table grant out of the shared KV pool. The
        # engine acquires on admit/splice (_alloc_slot_blocks, which records
        # the grant in _slot_block_map and returns the ids — '# transfers:'),
        # and releases on finish/cancel/preempt/rebuild (_free_slot_blocks,
        # the '# owns:' release point) or by adoption into the radix index.
        # kv_quantize="int8" adds no paths here: the scale arrays are pool
        # device leaves indexed by the SAME block ids this grant tracks, so
        # the existing acquire/release sites cover their lifetime too. The
        # speculative draft pool (SpeculativeEngine._draft_pool) is the same
        # story one level up: draft K/V leaves are a SECOND set of pool
        # arrays indexed by the one shared block table — there is no draft
        # allocator and no draft grant, so freeing the target grant IS
        # freeing the draft blocks, and any new draft-side alloc/free
        # entry point must route through _alloc_slot_blocks /
        # _free_slot_blocks to stay inside this spec.
        "kv-block",
        "slot-owned KV block grant",
        acquires=(
            Sig("alloc_blocks", "allocator", "result"),
            # empty hint, NOT "self": a "self" hint would enter _ALL_HINTS and
            # exempt every self.<method>(key) call from escape analysis
            Sig("_alloc_slot_blocks", "", "result"),
        ),
        releases=(
            Sig("free_blocks", "allocator", "arg"),
            Sig("_free_slot_blocks", "", "arg"),
            Sig("adopt", "prefix_cache", "arg"),
        ),
        strict=True,
        exit_leak=False,
    ),
    ResourceSpec(
        "kv-ref",
        "prefix-cache block reference",
        acquires=(
            Sig("match", "prefix_cache", "result"),
            Sig("extend", "prefix_cache", "result"),
        ),
        releases=(Sig("release", "prefix_cache", "arg"),),
    ),
    ResourceSpec(
        "trace",
        "telemetry trace",
        acquires=(Sig("new_trace", "telemetry", "result"),),
        releases=(Sig("end_trace", "telemetry", "arg"),),
    ),
    ResourceSpec(
        "slot",
        "engine slot",
        acquires=(Sig("admit", "engine", "result"), Sig("admit_many", "engine", "result")),
        releases=(Sig("cancel", "engine", "arg"),),
        escape_call_arg=True,
        raise_ok=True,
        exit_leak=False,
    ),
    ResourceSpec(
        "ticket",
        "scheduler ticket",
        acquires=(Sig("make_ticket", "scheduler", "result"),),
        releases=(Sig("submit", "scheduler", "arg"), Sig("requeue", "scheduler", "arg")),
        escape_call_arg=True,
        raise_ok=True,
        exit_leak=False,
    ),
    ResourceSpec(
        "handle",
        "file handle",
        acquires=(Sig("open", "", "result"),),
        releases=(Sig("close", "", "recv"), Sig("close", "os", "arg")),
    ),
)

SPEC_BY_NAME: Dict[str, ResourceSpec] = {s.name: s for s in SPECS}
#: leaf method names the family cares about at all (cheap per-function filter)
_METHOD_NAMES = frozenset(
    sig.method for spec in SPECS for sig in spec.acquires + spec.releases
)
#: non-empty receiver hints: calls on these receivers are part of the resource
#: protocol, so they never count as a generic escape of somebody's key
_ALL_HINTS = frozenset(
    sig.hint for spec in SPECS for sig in spec.acquires + spec.releases if sig.hint
)
#: container/sink methods that take ownership of their argument
_SINK_METHODS = frozenset(
    {"append", "add", "appendleft", "put", "put_nowait", "extend", "insert",
     "push", "setdefault", "send"}
)

# ------------------------------------------------------------- text utilities

#: keyed by id(node) and pinning the node itself — the reference keeps the
#: address from being reused by a later Project's AST (same-process reruns)
_UNPARSE_CACHE: Dict[int, Tuple[ast.AST, str]] = {}


def _unp(node: ast.AST) -> str:
    got = _UNPARSE_CACHE.get(id(node))
    if got is not None and got[0] is node:
        return got[1]
    try:
        text = ast.unparse(node)
    except (ValueError, AttributeError, RecursionError):  # pragma: no cover
        text = ""
    _UNPARSE_CACHE[id(node)] = (node, text)
    return text


_MENTION_CACHE: Dict[str, "re.Pattern[str]"] = {}


def _mention_re(key: str) -> "re.Pattern[str]":
    got = _MENTION_CACHE.get(key)
    if got is None:
        got = re.compile(
            r"(?<![A-Za-z0-9_.])" + re.escape(key) + r"(?![A-Za-z0-9_])"
        )
        _MENTION_CACHE[key] = got
    return got


def _mentions(node: ast.AST, key: str) -> bool:
    text = _unp(node)
    if key not in text:
        return False
    return _mention_re(key).search(text) is not None


def _base(key: str) -> str:
    """``ticket.resume`` -> ``ticket``; rebinding the base kills the key."""
    return key.split(".", 1)[0].split("[", 1)[0]


def _leaf_and_recv(call: ast.Call) -> Tuple[Optional[str], str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr, _unp(f.value)
    if isinstance(f, ast.Name):
        return f.id, ""
    return None, ""


def _sig_matches(sig: Sig, leaf: Optional[str], recv: str) -> bool:
    return leaf == sig.method and (not sig.hint or sig.hint in recv)


def _any_sig_matches(leaf: Optional[str], recv: str) -> bool:
    if leaf not in _METHOD_NAMES:
        return False
    for spec in SPECS:
        for sig in spec.acquires + spec.releases:
            if _sig_matches(sig, leaf, recv):
                return True
    return False


def _arg_exprs(call: ast.Call) -> Iterator[ast.AST]:
    for a in call.args:
        yield a.value if isinstance(a, ast.Starred) else a
    for kw in call.keywords:
        yield kw.value


def _result_key(stmt: ast.AST) -> Optional[str]:
    """The tracked name a result-keyed acquire binds: a plain ``Name`` target
    (first element for tuple unpacking). Attribute/subscript targets escape
    into state immediately — untracked, deliberately."""
    if isinstance(stmt, ast.Assign) and stmt.targets:
        target = stmt.targets[0]
    elif isinstance(stmt, ast.AnnAssign):
        target = stmt.target
    else:
        return None
    if isinstance(target, (ast.Tuple, ast.List)) and target.elts:
        target = target.elts[0]
    return target.id if isinstance(target, ast.Name) else None


def _collect_targets(t: ast.AST, out: Set[str]) -> None:
    if isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            _collect_targets(e, out)
    elif isinstance(t, ast.Starred):
        _collect_targets(t.value, out)
    else:
        out.add(_unp(t))


# -------------------------------------------------------------- per-block view

_OPAQUE = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _block_exprs(block: Block) -> Iterator[ast.AST]:
    """Nodes evaluated as part of this block (nested defs/lambdas excluded;
    ``with`` headers contribute only their ``as`` bindings — the context
    manager releases its own resource)."""
    for node, role in block.items:
        if role == "stmt":
            if isinstance(node, _OPAQUE):
                continue
            yield from own_nodes(node)
        elif role == "test":
            yield from own_nodes(node)
        elif role == "for":
            yield from own_nodes(node.iter)


class _Facts:
    """Per-block facts the reachability walks consult."""

    __slots__ = ("calls", "bindings", "resolved_call", "releases", "acquires")

    def __init__(self) -> None:
        #: (leaf, recv, call) for every call evaluated in the block
        self.calls: List[Tuple[Optional[str], str, ast.Call]] = []
        #: unparsed assignment/for/with/handler/del target texts
        self.bindings: Set[str] = set()
        #: the block calls back into scanned project code
        self.resolved_call = False
        #: (class name, key, call) direct textual releases
        self.releases: List[Tuple[str, str, ast.Call]] = []
        #: (spec, key, call) acquires that bind a trackable key
        self.acquires: List[Tuple[ResourceSpec, str, ast.Call]] = []


def _build_facts(fn: FunctionInfo, cfg: CFG, graph: CallGraph,
                 acquires_ret: Dict[Tuple[str, str], Set[str]]) -> Dict[int, _Facts]:
    callmap = _call_map(fn)
    facts: Dict[int, _Facts] = {}
    for bid, block in cfg.blocks.items():
        f = _Facts()
        facts[bid] = f
        for node in _block_exprs(block):
            if not isinstance(node, ast.Call):
                continue
            leaf, recv = _leaf_and_recv(node)
            f.calls.append((leaf, recv, node))
            cands = callmap.get(id(node))
            callee = graph._resolve(cands) if cands else None
            if callee is not None and callee is not fn:
                f.resolved_call = True
            for spec in SPECS:
                for sig in spec.releases:
                    if not _sig_matches(sig, leaf, recv):
                        continue
                    if sig.keyed == "recv":
                        key = recv
                    else:
                        key = _unp(node.args[0]) if node.args else ""
                    if key:
                        f.releases.append((spec.name, key, node))
                for sig in spec.acquires:
                    if not _sig_matches(sig, leaf, recv):
                        continue
                    if sig.keyed == "arg":
                        key = _unp(node.args[0]) if node.args else None
                    else:  # result-keyed: only a plain assignment binds it
                        key = _stmt_result_key(block, node)
                    if key:
                        f.acquires.append((spec, key, node))
            if callee is not None:
                classes = acquires_ret.get(callee.key)
                if classes:
                    key = _stmt_result_key(block, node)
                    if key:
                        for cls in classes:
                            spec = SPEC_BY_NAME.get(cls)
                            if spec is not None:
                                f.acquires.append((spec, key, node))
        # de-duplicate acquires (textual sig + summary may both fire)
        seen: Set[Tuple[str, str]] = set()
        uniq = []
        for spec, key, call in f.acquires:
            if (spec.name, key) not in seen:
                seen.add((spec.name, key))
                uniq.append((spec, key, call))
        f.acquires = uniq
        for node, role in block.items:
            if role == "stmt":
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        _collect_targets(t, f.bindings)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    _collect_targets(node.target, f.bindings)
                elif isinstance(node, ast.Delete):
                    for t in node.targets:
                        f.bindings.add(_unp(t))
                elif isinstance(node, _OPAQUE):
                    f.bindings.add(node.name)
            elif role == "for":
                _collect_targets(node.target, f.bindings)
            elif role == "with":
                for item in node.items:
                    if item.optional_vars is not None:
                        _collect_targets(item.optional_vars, f.bindings)
            elif role == "handler" and node.name:
                f.bindings.add(node.name)
    return facts


def _stmt_result_key(block: Block, call: ast.Call) -> Optional[str]:
    """For a result-keyed match: the call must be the whole RHS of the
    block's (single) assignment statement."""
    for node, role in block.items:
        if role == "stmt" and isinstance(node, (ast.Assign, ast.AnnAssign)):
            if getattr(node, "value", None) is call:
                return _result_key(node)
    return None


def _rebinds(f: _Facts, key: str) -> bool:
    return key in f.bindings or _base(key) in f.bindings


def _escapes(block: Block, f: _Facts, key: str, spec: ResourceSpec) -> bool:
    """The key's resource is handed to something that may own it now: returned,
    raised, yielded, stored into state, put in a container, passed to a
    constructor — or passed to any call at all for ``escape_call_arg``
    classes. Calls that are part of a resource protocol (matching any spec
    signature, or on a hinted receiver) never count: ``release(path)`` on the
    prefix cache must not hide ``path``'s pin from the walk."""
    for node, role in block.items:
        if role != "stmt":
            continue
        if isinstance(node, ast.Return):
            if node.value is not None and _mentions(node.value, key):
                return True
        elif isinstance(node, ast.Raise):
            if node.exc is not None and _mentions(node.exc, key):
                return True
        elif isinstance(node, ast.Assign):
            # storing the key into state escapes it; so does registering
            # state UNDER the key (``bookkeeping[slot] = ...``)
            if _mentions_any_store_target(node) and (
                _mentions(node.value, key)
                or any(_mentions(t, key) for t in node.targets)
            ):
                return True
    for node in _block_exprs(block):
        if isinstance(node, (ast.Yield, ast.YieldFrom, ast.Await)):
            if _mentions(node, key):
                return True
        if isinstance(node, ast.Call):
            leaf, recv = _leaf_and_recv(node)
            arg_hit = any(_mentions(a, key) for a in _arg_exprs(node))
            if not arg_hit:
                continue
            if spec.escape_call_arg:
                return True
            if leaf in _SINK_METHODS:
                return True
            if leaf and leaf[:1].isupper():  # constructor-like: Foo(key)
                return True
            if _any_sig_matches(leaf, recv):
                continue
            if any(h in recv for h in _ALL_HINTS):
                continue
            return True
    return False


def _mentions_any_store_target(node: ast.Assign) -> bool:
    for t in node.targets:
        elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
        for e in elts:
            if isinstance(e, (ast.Attribute, ast.Subscript)):
                return True
    return False


def _pruned_kind(block: Block, key: str) -> Optional[str]:
    """None-guard path sensitivity: on ``if key is None: ...`` the true branch
    cannot hold the resource. Returns the edge kind to skip, if any."""
    if block.kind != "branch":
        return None
    test = next((n for n, r in block.items if r == "test"), None)
    if test is None:
        return None
    text = _unp(test)
    if text == f"{key} is None" or text == f"not {key}":
        return "true"
    if text == f"{key} is not None" or text == key:
        return "false"
    return None


def _witness(cfg: CFG, parents: Dict[int, Optional[int]], target: int,
             extra: Sequence[int] = ()) -> str:
    lines: List[int] = []
    for bid in list(path_to(parents, target)) + list(extra):
        ln = cfg.blocks[bid].line
        if ln and (not lines or lines[-1] != ln):
            lines.append(ln)
    shown = lines[:_MAX_CHAIN]
    tail = "..." if len(lines) > _MAX_CHAIN else ""
    return "->".join(str(ln) for ln in shown) + tail


def _verbs(spec: ResourceSpec) -> str:
    return "/".join(
        sorted({f"{sig.method}()" for sig in spec.releases})
    )


# ------------------------------------------------------- summaries + contracts


class ResourceSummaries:
    """Per-function resource facts propagated over the resolved call graph:
    which classes a function releases (directly, via a releasing callee, or by
    ``# owns:`` contract) and which classes its return value carries
    (``# transfers:`` or an acquire that flows into a ``return``)."""

    def __init__(self, graph: CallGraph) -> None:
        self.graph = graph
        self.owns_annot: Dict[Tuple[str, str], Tuple[str, ...]] = {}
        self.transfers_annot: Dict[Tuple[str, str], Tuple[str, ...]] = {}
        #: fn key -> class -> qualname witness chain
        self.releases: Dict[Tuple[str, str], Dict[str, Tuple[str, ...]]] = {}
        #: classes a direct textual release touches in the fn's own body
        self.direct_releases: Dict[Tuple[str, str], Set[str]] = {}
        #: fn key -> classes its return value carries
        self.acquires_ret: Dict[Tuple[str, str], Set[str]] = {}
        #: leaf method name -> qualnames of functions calling it (textual —
        #: the witness chain for broken ``# owns:`` contracts)
        self.callers_by_leaf: Dict[str, Set[str]] = {}
        #: (relpath, line, message) annotation hygiene problems
        self.hygiene: List[Tuple[str, int, str]] = []
        #: fn key -> resolved callees of ``return f(...)`` statements — walked
        #: once here so the fixpoint never re-walks function bodies
        self._ret_call_callees: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        self._collect_annotations()
        self._collect_direct()
        self._fixpoint()

    # -- annotations ------------------------------------------------------

    def _collect_annotations(self) -> None:
        known = set(SPEC_BY_NAME)
        for idx in self.graph.indexes:
            mod = idx.source
            for table, label in ((mod.owns, "owns"), (mod.transfers, "transfers")):
                for line, classes in table.items():
                    fn = self._fn_at_line(idx, line)
                    if fn is None:
                        self.hygiene.append((
                            mod.relpath, line,
                            f"'# {label}:' annotation is not attached to a "
                            f"function definition",
                        ))
                        continue
                    good = tuple(c for c in classes if c in known)
                    for c in classes:
                        if c not in known:
                            self.hygiene.append((
                                mod.relpath, line,
                                f"'# {label}:' names unknown resource class "
                                f"'{c}' (known: {', '.join(sorted(known))})",
                            ))
                    if not good:
                        continue
                    table_out = (
                        self.owns_annot if label == "owns" else self.transfers_annot
                    )
                    prev = table_out.get(fn.key, ())
                    table_out[fn.key] = prev + tuple(
                        c for c in good if c not in prev
                    )
            for line, classes in mod.holds.items():
                for c in classes:
                    if c not in known:
                        self.hygiene.append((
                            mod.relpath, line,
                            f"'# holds:' names unknown resource class '{c}' "
                            f"(known: {', '.join(sorted(known))})",
                        ))

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

    # -- direct facts -----------------------------------------------------

    def _collect_direct(self) -> None:
        for fn in self.graph.by_key.values():
            rel: Set[str] = set()
            acq: List[Tuple[str, str]] = []  # (class, key)
            returns: List[ast.AST] = []
            ret_callees: List[Tuple[str, str]] = []
            for node in own_nodes(fn.node):
                if isinstance(node, ast.Return) and node.value is not None:
                    returns.append(node.value)
                    if isinstance(node.value, ast.Call):
                        cands = _call_map(fn).get(id(node.value))
                        callee = self.graph._resolve(cands) if cands else None
                        if callee is not None and callee is not fn:
                            ret_callees.append(callee.key)
                if not isinstance(node, ast.Call):
                    continue
                leaf, recv = _leaf_and_recv(node)
                if leaf is not None:
                    self.callers_by_leaf.setdefault(leaf, set()).add(fn.qualname)
                if leaf not in _METHOD_NAMES:
                    continue
                for spec in SPECS:
                    for sig in spec.releases:
                        if _sig_matches(sig, leaf, recv):
                            rel.add(spec.name)
                    for sig in spec.acquires:
                        if _sig_matches(sig, leaf, recv):
                            if sig.keyed == "arg" and node.args:
                                acq.append((spec.name, _unp(node.args[0])))
                            elif sig.keyed == "result":
                                # resolved precisely in the CFG pass; here the
                                # summary only needs "this fn pulls one out"
                                acq.append((spec.name, ""))
            if rel:
                self.direct_releases[fn.key] = rel
                self.releases[fn.key] = {c: (fn.qualname,) for c in rel}
            ret_classes: Set[str] = set(self.transfers_annot.get(fn.key, ()))
            for cls, key in acq:
                if key and any(_mentions(r, key) for r in returns):
                    ret_classes.add(cls)
            if ret_classes:
                self.acquires_ret[fn.key] = ret_classes
            for cls in self.owns_annot.get(fn.key, ()):
                self.releases.setdefault(fn.key, {}).setdefault(
                    cls, (fn.qualname + " (# owns contract)",)
                )
            if ret_callees:
                self._ret_call_callees[fn.key] = ret_callees

    # -- propagation ------------------------------------------------------

    def _fixpoint(self) -> None:
        changed = True
        while changed:
            changed = False
            for fn in self.graph.by_key.values():
                for callee, call in resolved_edges(self.graph, fn):
                    if callee is fn:
                        continue
                    for cls, chain in self.releases.get(callee.key, {}).items():
                        mine = self.releases.setdefault(fn.key, {})
                        if cls not in mine and len(chain) < _MAX_CHAIN:
                            mine[cls] = (fn.qualname,) + chain
                            changed = True
                for callee_key in self._ret_call_callees.get(fn.key, ()):
                    inherited = self.acquires_ret.get(callee_key)
                    if inherited:
                        mine = self.acquires_ret.setdefault(fn.key, set())
                        if not inherited <= mine:
                            mine |= inherited
                            changed = True

    # -- contract queries -------------------------------------------------

    def fn_releases_cls(self, fn: FunctionInfo, cls: str) -> bool:
        """Does ``fn`` provably release ``cls`` — a direct textual release or
        a resolved call into a releasing/owning callee? (``fn``'s own
        ``# owns:`` annotation deliberately does NOT satisfy this: it is the
        claim under test.)"""
        if cls in self.direct_releases.get(fn.key, ()):
            return True
        for callee, _call in resolved_edges(self.graph, fn):
            if callee is fn:
                continue
            if cls in self.releases.get(callee.key, {}):
                return True
        return False


# ------------------------------------------------------------------ analysis


class _Analysis:
    """Shared engine behind the three registered rules (built once per lint
    run, cached on the project's call graph)."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.graph = project.graph
        self.sums = ResourceSummaries(self.graph)
        self.leaks: List[Finding] = []
        self.doubles: List[Finding] = []
        self.transfers: List[Finding] = []
        for relpath, line, msg in self.sums.hygiene:
            self.leaks.append(Finding("resource-leak", relpath, line, 0, msg))
        for idx in self.graph.indexes:
            self._check_holds(idx)
            for fn in idx.functions.values():
                self._check_fn(fn, idx)
        self.leaks.sort(key=lambda f: (f.path, f.line, f.col))
        self.doubles.sort(key=lambda f: (f.path, f.line, f.col))
        self.transfers.sort(key=lambda f: (f.path, f.line, f.col))

    # -- per-function -----------------------------------------------------

    def _check_fn(self, fn: FunctionInfo, idx: ModuleIndex) -> None:
        relevant = False
        for _cands, call in fn.calls:
            leaf, _recv = _leaf_and_recv(call)
            if leaf in _METHOD_NAMES:
                relevant = True
                break
        self._check_owns(fn, idx)
        if not relevant:
            return
        cfg = build_cfg(fn.node)
        facts = _build_facts(fn, cfg, self.graph, self.sums.acquires_ret)
        for bid, f in facts.items():
            for spec, key, call in f.acquires:
                self._check_leak(fn, idx, cfg, facts, spec, key, bid, call)
        self._check_doubles(fn, idx, cfg, facts)
        self._check_transfers(fn, idx, cfg, facts)

    # -- leak-on-path -----------------------------------------------------

    def _leak_stop(self, facts: Dict[int, _Facts], fn: FunctionInfo,
                   spec: ResourceSpec, key: str):
        callmap = _call_map(fn)

        def stop(block: Block) -> bool:
            f = facts[block.id]
            for cls, k, _call in f.releases:
                if cls == spec.name and k == key:
                    return True
            for leaf, recv, call in f.calls:
                cands = callmap.get(id(call))
                callee = self.graph._resolve(cands) if cands else None
                if callee is None or callee is fn:
                    continue
                if spec.name in self.sums.releases.get(callee.key, {}):
                    if any(_mentions(a, key) for a in _arg_exprs(call)):
                        return True
            if _escapes(block, f, key, spec):
                return True
            return _rebinds(f, key)

        return stop

    def _check_leak(self, fn: FunctionInfo, idx: ModuleIndex, cfg: CFG,
                    facts: Dict[int, _Facts], spec: ResourceSpec, key: str,
                    b0: int, call: ast.Call) -> None:
        def follow(block: Block, edge) -> bool:
            if edge.kind == "except":
                if spec.raise_ok or block.id == b0:
                    return False
                if edge.explicit:
                    return True
                return spec.strict and facts[block.id].resolved_call
            if edge.kind not in ALWAYS_KINDS:
                return False
            pruned = _pruned_kind(block, key)
            return pruned is None or edge.kind != pruned

        stop = self._leak_stop(facts, fn, spec, key)
        parents = reachable(cfg, b0, follow=follow, stop=stop)
        verbs = _verbs(spec)
        line, col = call.lineno, call.col_offset

        loop_src: Optional[int] = None
        for bid in parents:
            if bid != b0 and stop(cfg.blocks[bid]):
                continue
            for e in cfg.blocks[bid].edges:
                if e.dst == b0 and follow(cfg.blocks[bid], e):
                    loop_src = bid
                    break
            if loop_src is not None:
                break
        if loop_src is not None:
            self.leaks.append(Finding(
                "resource-leak", idx.source.relpath, line, col,
                f"{spec.noun} '{key}' is re-acquired on a loop back-edge "
                f"(lines {_witness(cfg, parents, loop_src, (b0,))}) while the "
                f"previous acquisition is still held — release with {verbs} "
                f"before the next iteration",
                symbol=fn.qualname,
            ))
            return
        if cfg.rexit in parents:
            self.leaks.append(Finding(
                "resource-leak", idx.source.relpath, line, col,
                f"{spec.noun} '{key}' can leak on an exception path (lines "
                f"{_witness(cfg, parents, cfg.rexit)}): the error escapes "
                f"before any {verbs} — release in a handler/finally or "
                f"annotate the receiving function with "
                f"'# owns: {spec.name}'",
                symbol=fn.qualname,
            ))
            return
        if spec.exit_leak and cfg.exit in parents:
            self.leaks.append(Finding(
                "resource-leak", idx.source.relpath, line, col,
                f"{spec.noun} '{key}' leaks on a normal exit path (lines "
                f"{_witness(cfg, parents, cfg.exit)}): no {verbs} before the "
                f"function returns — release it, or annotate the transfer "
                f"with '# transfers: {spec.name}'",
                symbol=fn.qualname,
            ))

    # -- double-release ---------------------------------------------------

    def _check_doubles(self, fn: FunctionInfo, idx: ModuleIndex, cfg: CFG,
                       facts: Dict[int, _Facts]) -> None:
        reported: Set[Tuple[int, int, str, str]] = set()
        for b0, f0 in facts.items():
            for cls, key, call0 in f0.releases:
                spec = SPEC_BY_NAME[cls]

                def follow(block: Block, edge) -> bool:
                    if edge.kind not in ALWAYS_KINDS:
                        return False
                    pruned = _pruned_kind(block, key)
                    return pruned is None or edge.kind != pruned

                def stop(block: Block) -> bool:
                    fb = facts[block.id]
                    for sp2, k2, _c in fb.acquires:
                        if sp2.name == cls and k2 == key:
                            return True
                    for c2, k2, _c in fb.releases:
                        if c2 == cls and k2 == key:
                            return True
                    if _escapes(block, fb, key, spec):
                        return True
                    return _rebinds(fb, key)

                parents = reachable(cfg, b0, follow=follow, stop=stop)
                hits = []
                for bid in parents:
                    if bid == b0:
                        continue
                    fb = facts[bid]
                    if _mentions_release(fb, cls, key) and not _reacquires(fb, cls, key):
                        hits.append(bid)
                for bid in sorted(hits, key=lambda b: cfg.blocks[b].line):
                    pair = (min(b0, bid), max(b0, bid), cls, key)
                    if pair in reported:
                        continue
                    reported.add(pair)
                    rel = next(
                        c for c2, k2, c in facts[bid].releases
                        if c2 == cls and k2 == key
                    )
                    self.doubles.append(Finding(
                        "double-release", idx.source.relpath,
                        rel.lineno, rel.col_offset,
                        f"{spec.noun} '{key}' released twice: already "
                        f"released at line {call0.lineno}, and no path in "
                        f"between re-acquires or rebinds it (path: lines "
                        f"{_witness(cfg, parents, bid)})",
                        symbol=fn.qualname,
                    ))
                    break  # one finding per source release

    # -- unbalanced-transfer ----------------------------------------------

    def _check_transfers(self, fn: FunctionInfo, idx: ModuleIndex, cfg: CFG,
                         facts: Dict[int, _Facts]) -> None:
        transfer_classes = self.sums.transfers_annot.get(fn.key, ())
        if not transfer_classes:
            return
        for b0, f0 in facts.items():
            for cls, key, call0 in f0.releases:
                if cls not in transfer_classes:
                    continue
                spec = SPEC_BY_NAME[cls]

                def follow(block: Block, edge) -> bool:
                    if edge.kind not in ALWAYS_KINDS:
                        return False
                    pruned = _pruned_kind(block, key)
                    return pruned is None or edge.kind != pruned

                def stop(block: Block) -> bool:
                    fb = facts[block.id]
                    for sp2, k2, _c in fb.acquires:
                        if sp2.name == cls and k2 == key:
                            return True
                    return _rebinds(fb, key)

                parents = reachable(cfg, b0, follow=follow, stop=stop)
                for bid in sorted(parents, key=lambda b: cfg.blocks[b].line):
                    if bid == b0:
                        continue
                    ret = _returns_key(cfg.blocks[bid], key)
                    if ret is None:
                        continue
                    self.transfers.append(Finding(
                        "unbalanced-transfer", idx.source.relpath,
                        call0.lineno, call0.col_offset,
                        f"function transfers {spec.noun} ownership to its "
                        f"caller ('# transfers: {cls}') but releases '{key}' "
                        f"here while a path (lines "
                        f"{_witness(cfg, parents, bid)}) still returns it — "
                        f"both sides of the transfer would release",
                        symbol=fn.qualname,
                    ))
                    break

    # -- ownership contracts ----------------------------------------------

    def _check_owns(self, fn: FunctionInfo, idx: ModuleIndex) -> None:
        for cls in self.sums.owns_annot.get(fn.key, ()):
            if self.sums.fn_releases_cls(fn, cls):
                continue
            spec = SPEC_BY_NAME[cls]
            leaf = fn.qualname.rsplit(".", 1)[-1]
            callers = sorted(
                q for q in self.sums.callers_by_leaf.get(leaf, ())
                if q != fn.qualname
            )[:3]
            relied = (
                f"; relied on by {', '.join(callers)}" if callers else ""
            )
            self.leaks.append(Finding(
                "resource-leak", idx.source.relpath,
                fn.node.lineno, fn.node.col_offset,
                f"function is annotated '# owns: {cls}' but no path releases "
                f"a {spec.noun} ({_verbs(spec)} or a releasing callee)"
                f"{relied} — the contract callers rely on is broken",
                symbol=fn.qualname,
            ))

    def _check_holds(self, idx: ModuleIndex) -> None:
        mod = idx.source
        if not mod.holds:
            return
        #: attr text -> (classes, annotation line), per enclosing class
        held: Dict[Tuple[str, str], Tuple[Tuple[str, ...], int]] = {}
        consumed: Set[int] = set()
        for fn in idx.functions.values():
            if not fn.qualname.endswith("__init__") or fn.class_name is None:
                continue
            for node in own_nodes(fn.node):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                end = getattr(node, "end_lineno", node.lineno) or node.lineno
                classes = None
                for line in range(node.lineno, end + 1):
                    if line in mod.holds:
                        classes = tuple(
                            c for c in mod.holds[line] if c in SPEC_BY_NAME
                        )
                        consumed.add(line)
                        break
                if not classes:
                    continue
                targets: Set[str] = set()
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        _collect_targets(t, targets)
                else:
                    _collect_targets(node.target, targets)
                for attr in targets:
                    if attr.startswith("self."):
                        held[(fn.class_name, attr)] = (classes, node.lineno)
        for line in mod.holds:
            if line not in consumed:
                self.leaks.append(Finding(
                    "resource-leak", mod.relpath, line, 0,
                    "'# holds:' annotation is not attached to a "
                    "'self.<attr> = ...' assignment in __init__",
                ))
        if not held:
            return
        for fn in idx.functions.values():
            if fn.class_name is None or fn.qualname.endswith("__init__"):
                continue
            owned = self.sums.owns_annot.get(fn.key, ())
            for node in own_nodes(fn.node):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                    for e in elts:
                        attr = _unp(e)
                        entry = held.get((fn.class_name, attr))
                        if entry is None:
                            continue
                        classes, _decl = entry
                        if _mentions(node.value, attr):
                            continue  # swap-read: old value was taken out
                        for cls in classes:
                            if cls in owned:
                                continue  # the owner reassigns by contract
                            if self.sums.fn_releases_cls(fn, cls):
                                continue
                            spec = SPEC_BY_NAME[cls]
                            self.leaks.append(Finding(
                                "resource-leak", mod.relpath,
                                node.lineno, node.col_offset,
                                f"'{attr}' holds live {spec.noun}s "
                                f"('# holds: {cls}') but is overwritten "
                                f"without releasing the previous contents "
                                f"({_verbs(spec)} or a releasing callee "
                                f"first)",
                                symbol=fn.qualname,
                            ))


def _mentions_release(fb: _Facts, cls: str, key: str) -> bool:
    return any(c2 == cls and k2 == key for c2, k2, _c in fb.releases)


def _reacquires(fb: _Facts, cls: str, key: str) -> bool:
    return any(sp.name == cls and k2 == key for sp, k2, _c in fb.acquires)


def _returns_key(block: Block, key: str) -> Optional[ast.Return]:
    for node, role in block.items:
        if role == "stmt" and isinstance(node, ast.Return):
            if node.value is not None and _mentions(node.value, key):
                return node
    return None


def _analysis(project: Project) -> _Analysis:
    cached = getattr(project.graph, "_graftlint_resources", None)
    if cached is None:
        cached = _Analysis(project)
        project.graph._graftlint_resources = cached
    return cached


@register(
    "resource-leak",
    "paired resources (pins/refs/traces/slots/tickets/handles) with a path "
    "that escapes without release or ownership transfer",
)
def check_leaks(project: Project) -> Iterator[Finding]:
    yield from _analysis(project).leaks


@register(
    "double-release",
    "a resource released twice along one path with no re-acquire or rebind "
    "in between",
)
def check_doubles(project: Project) -> Iterator[Finding]:
    yield from _analysis(project).doubles


@register(
    "unbalanced-transfer",
    "ownership annotated as transferred ('# transfers:') but a path releases "
    "on the transferring side too",
)
def check_transfers(project: Project) -> Iterator[Finding]:
    yield from _analysis(project).transfers
