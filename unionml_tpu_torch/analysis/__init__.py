"""graftlint for the PyTorch port — static analysis over the serving stack.

An AST linter that checks, on every CI run, the invariants a reviewer would
otherwise re-derive by hand: no host sync on the decode hot path, no capture
churn, guarded state written under its lock, locks taken in one order,
async handlers that do not block, exceptions that are not swallowed, and
pins, references, slots, tickets and traces released on every path. It
never imports the code it checks, so it runs without a device.

The analysis layers: a call graph with the bodies recorded into CUDA graphs
or compiled (:mod:`.callgraph`), value provenance (host / device) and
interprocedural blocking and lock summaries (:mod:`.dataflow`), thread roles
(:mod:`.threads`) and a control-flow graph with exception edges (:mod:`.cfg`).

Rules (``--list-rules`` prints the catalog):

- ``host-sync`` — ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
  ``bool()/int()/float()`` of a tensor, data-dependent-shape ops and
  host-to-device copies inside captured bodies; the same syncs on device
  values plus ``torch.cuda.synchronize()`` and a stream's or an event's
  ``.synchronize()`` on ``# graftlint: hot-path`` host paths.
- ``recapture`` — a capture key built from an unbucketed runtime size, and a
  graph or compiled callable built per call or in a loop.
- ``lock-discipline`` — writes to ``# guarded-by: <lock>`` host state outside
  the owning lock.
- ``lock-order`` — lock-acquisition cycles (potential deadlocks) and blocking
  calls held under a lock, interprocedural.
- ``async-blocking`` — blocking calls inside ``async def`` handlers that
  stall the event loop.
- ``swallowed-exception`` — broad handlers that neither re-raise, log nor
  record the error.
- ``data-race``, ``check-then-act``, ``lock-leaf``, ``callback-under-lock`` —
  lock-set analysis over the inferred thread roles.
- ``resource-leak`` — an acquired resource (pin/ref/trace/slot/ticket/handle)
  with a CFG path — normal or exceptional — out of the function that skips
  every release, escape, and transfer.
- ``double-release`` — two releases of the same resource key on one path.
- ``unbalanced-transfer`` — ``# owns:`` / ``# transfers:`` contract comments
  whose bodies don't release / whose callers drop the handed-over resource.
- ``sharding`` — a ``Spec`` axis no mesh of the tree declares, and a
  ``NamedSharding`` cut off another mesh than the function's own.
- ``suppression`` — always-on hygiene: every ``# graftlint: disable=`` needs a
  known rule name and a reason string.

Run it as ``python -m unionml_tpu_torch.analysis unionml_tpu_torch/`` (exit 1
on findings) or programmatically via :func:`run_lint`. CI surfaces:
``--sarif`` (GitHub code scanning), ``--baseline`` (land widened scopes
incrementally), ``--budget`` (lint-runtime contract).
"""

from unionml_tpu_torch.analysis.core import (  # noqa: F401
    REPORT_VERSION,
    Finding,
    LintResult,
    Project,
    RULES,
    baseline_payload,
    load_baseline,
    run_lint,
)

__all__ = [
    "Finding",
    "LintResult",
    "Project",
    "RULES",
    "REPORT_VERSION",
    "baseline_payload",
    "load_baseline",
    "run_lint",
]
