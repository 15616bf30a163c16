"""Rule ``swallowed-exception``: broad handlers that bury the error.

The serving core's failure taxonomy only works if failures actually
REACH it: a ``except Exception: pass`` between a device fault and the
supervisor turns a recoverable incident into a silent wedge — the request
hangs, the health state stays green, and the only evidence is a missing
response. This rule mechanically forbids that shape: every broad handler
(``except Exception:``, ``except BaseException:``, or a bare ``except:``)
must do at least one of

- **re-raise** — a ``raise`` anywhere in the handler body (plain or a new,
  typically structured, exception);
- **log** — a call whose method name is a logging verb (``debug``/``info``/
  ``warning``/``error``/``exception``/``critical``/``log``);
- **record** — *use the bound exception* (``except Exception as exc:`` with
  ``exc`` read somewhere in the body): passing it to a sink/callback,
  embedding it in a structured response or message, stashing it on state.

Three shapes are recognized as *handling by construction* (v3, CFG-aware) and
exempted without a suppression:

- **best-effort release** — the ``try`` body is nothing but release-verb
  calls (``close``/``release``/``unpin``/``unregister``/``shutdown``/... )
  and the handler is ``pass``-only: teardown that must never raise
  (``__del__``, ``__exit__``, unsubscribe-on-drift). The error has no
  consumer by definition.
- **cleanup-release handler** — the handler releases resources
  (a release-verb call) and every CFG path from the handler's entry to code
  outside the handler passes through a release call: the handler IS the
  release-on-error path the resource-lifetime rules demand, and flagging it
  would pit one rule family against another.
- **fallback binding** — the handler only assigns names that the ``try``
  body also binds (``raw = probe() ... except Exception: raw = {}``): the
  fallback value is the documented handling; nothing is swallowed.

A handler that intentionally does none of these still needs the standard
reasoned suppression — ``# graftlint: disable=swallowed-exception -- why
silence is safe here`` — so every silenced failure path documents its
justification in the diff.

Narrow handlers (``except ValueError:`` etc.) are exempt: naming the expected
exception is itself the evidence that the swallow is deliberate and bounded.
"""

import ast
from typing import Iterator, List, Set, Tuple

from unionml_tpu_torch.analysis.cfg import ALWAYS_KINDS, build_cfg, reachable
from unionml_tpu_torch.analysis.core import Finding, Project, register

#: method names that count as logging the failure
LOG_METHODS = frozenset(
    {"debug", "info", "warning", "error", "exception", "critical", "log"}
)
#: exception types broad enough to catch arbitrary failures
BROAD_TYPES = frozenset({"Exception", "BaseException"})
#: leaf-name prefixes (leading underscores stripped) that read as "give the
#: resource back" — the vocabulary shared with rules_resources' spec table
RELEASE_VERBS = (
    "close", "release", "unpin", "unregister", "unsubscribe", "unlink",
    "shutdown", "stop", "cancel", "discard", "end_trace", "terminate",
    "disconnect",
)


def _is_broad(handler: ast.ExceptHandler) -> bool:
    node = handler.type
    if node is None:
        return True  # bare except:
    if isinstance(node, ast.Name):
        return node.id in BROAD_TYPES
    if isinstance(node, ast.Attribute):
        return node.attr in BROAD_TYPES
    if isinstance(node, ast.Tuple):
        return any(
            _is_broad(ast.ExceptHandler(type=el, name=None, body=[])) for el in node.elts
        )
    return False


def _handles_failure(handler: ast.ExceptHandler) -> bool:
    """Whether the handler re-raises, logs, or uses the bound exception."""
    bound = handler.name
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(node, ast.Raise):
            return True
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in LOG_METHODS
        ):
            return True
        if (
            bound
            and isinstance(node, ast.Name)
            and node.id == bound
            and isinstance(node.ctx, ast.Load)
        ):
            return True
    return False


# --------------------------------------------------------------- exemptions


def _is_release_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    leaf = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
    return leaf is not None and leaf.lstrip("_").startswith(RELEASE_VERBS)


def _pass_only(handler: ast.ExceptHandler) -> bool:
    return all(isinstance(s, ast.Pass) for s in handler.body)


def _best_effort_release(try_node: ast.AST, handler: ast.ExceptHandler) -> bool:
    """``try: <release calls only> except Exception: pass`` — teardown that
    must never raise; there is no consumer for the error."""
    if not _pass_only(handler) or not try_node.body:
        return False
    return all(
        isinstance(stmt, ast.Expr) and _is_release_call(stmt.value)
        for stmt in try_node.body
    )


def _bound_names(stmts) -> Set[str]:
    """Names a statement list binds: assignments (plain/ann/aug), loop and
    ``with`` targets, and import aliases."""
    names: Set[str] = set()

    def targets(t: ast.AST) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                targets(e)
        elif isinstance(t, ast.Starred):
            targets(t.value)
        elif isinstance(t, ast.Name):
            names.add(t.id)

    for node in ast.walk(ast.Module(body=list(stmts), type_ignores=[])):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                targets(t)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            targets(node.target)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    targets(item.optional_vars)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add(alias.asname or alias.name.split(".", 1)[0])
    return names


def _fallback_binding(try_node: ast.AST, handler: ast.ExceptHandler) -> bool:
    """The handler only assigns fallback values for names the ``try`` body
    binds — the assignment IS the handling."""
    assigned: Set[str] = set()
    for stmt in handler.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    assigned.add(t.id)
                else:
                    return False
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            assigned.add(stmt.target.id)
        else:
            return False
    return bool(assigned) and bool(assigned & _bound_names(try_node.body))


def _releases_then_falls_through(scope: ast.AST, handler: ast.ExceptHandler) -> bool:
    """CFG check: the handler contains a release-verb call, and every path
    from its entry to code outside the handler passes through one — i.e. the
    handler is a release-on-error cleanup, not a swallow."""
    if not any(
        _is_release_call(n)
        for n in ast.walk(ast.Module(body=handler.body, type_ignores=[]))
    ):
        return False
    cfg = build_cfg(scope)
    entry = None
    for block in cfg.blocks.values():
        if block.kind == "handler" and any(n is handler for n, _r in block.items):
            entry = block.id
            break
    if entry is None:  # unreachable in practice: the builder saw the same AST
        return False

    def releases(block) -> bool:
        return any(
            _is_release_call(n)
            for item, role in block.items
            if role == "stmt"
            for n in ast.walk(item)
        )

    parents = reachable(
        cfg, entry,
        follow=lambda _b, e: e.kind in ALWAYS_KINDS,
        stop=lambda b: releases(b),
    )
    for bid in parents:
        block = cfg.blocks[bid]
        if handler not in block.regions and not releases(block):
            return False  # a path leaves the handler without releasing
    return True


class _Visitor(ast.NodeVisitor):
    """Collects offending handlers with their enclosing symbol qualname."""

    def __init__(self, tree: ast.Module) -> None:
        self.tree = tree
        self.stack: List[str] = []
        #: innermost enclosing function node (module tree at top level)
        self.scopes: List[ast.AST] = [tree]
        self.found: List[Tuple[ast.ExceptHandler, str]] = []

    def _visit_scope(self, node: ast.AST, name: str, is_func: bool) -> None:
        self.stack.append(name)
        if is_func:
            self.scopes.append(node)
        self.generic_visit(node)
        if is_func:
            self.scopes.pop()
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_scope(node, node.name, True)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_scope(node, node.name, True)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._visit_scope(node, node.name, False)

    def _check_try(self, node) -> None:
        for handler in node.handlers:
            if not _is_broad(handler) or _handles_failure(handler):
                continue
            if _best_effort_release(node, handler):
                continue
            if _fallback_binding(node, handler):
                continue
            if _releases_then_falls_through(self.scopes[-1], handler):
                continue
            self.found.append((handler, ".".join(self.stack)))
        self.generic_visit(node)

    def visit_Try(self, node: ast.Try) -> None:
        self._check_try(node)

    if hasattr(ast, "TryStar"):  # pragma: no branch - version-dependent
        def visit_TryStar(self, node) -> None:  # noqa: N802 - ast API
            self._check_try(node)


@register(
    "swallowed-exception",
    "broad except handlers that neither re-raise, log, nor record the failure",
)
def check(project: Project) -> Iterator[Finding]:
    for mod in project.modules:
        visitor = _Visitor(mod.tree)
        visitor.visit(mod.tree)
        for handler, symbol in visitor.found:
            what = "bare except" if handler.type is None else "broad except"
            yield Finding(
                "swallowed-exception",
                mod.relpath,
                handler.lineno,
                handler.col_offset,
                f"{what} swallows the error: the handler neither re-raises, "
                f"logs, nor records the exception — a failure here vanishes "
                f"without a trace; narrow the except, handle the failure, or "
                f"suppress with a reason",
                symbol=symbol,
            )
