"""Debug & sanitization utilities: NaN guard, purity check, recompile monitor.

Port of ``unionml_tpu/debug.py``. The port's compiled form of a function is a
CUDA graph (:func:`unionml_tpu_torch._graphs.capture`) on CUDA tensors and a
``torch.jit.trace`` on CPU tensors: like a JAX trace, each runs the Python
body while it records and freezes the Python-side state it read then. The
failure modes these helpers surface are the JAX package's: impure functions
(side effects frozen at record time), NaN-producing steps, and recompiles
from shape or dtype churn.

``check_tracer_leaks`` is not ported: it turns on JAX's check for traced
values escaping their trace, and neither compiled form has such values (a
graph's outputs are cloned out of its static buffers at every replay, a
traced function returns ordinary tensors).
"""

import contextlib
import warnings
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from unionml_tpu_torch._graphs import capture, signature
from unionml_tpu_torch._logging import logger


class _NaNCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first operator whose floating
    output holds a NaN (each check reads a flag back from the device)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in _pytree.tree_leaves(out):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and bool(torch.isnan(leaf).any()):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enabled: bool = True) -> Iterator[None]:
    """Raise ``FloatingPointError`` at the operator that first produces a NaN
    (eager forward code), and let autograd's anomaly mode raise at the
    backward operator that does; both states are put back on exit. A captured
    CUDA graph replays without dispatch, so its operators are not checked."""
    if not enabled:
        yield
        return
    previous = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        with _NaNCheck():
            yield
    finally:
        torch.autograd.set_detect_anomaly(*previous)


def _compiled(fn: Callable, args: Tuple[Any, ...]) -> Callable[..., Any]:
    """``fn`` recorded once at ``args``: a CUDA graph when a tensor argument
    lies on a CUDA device, else a ``torch.jit.trace``."""
    tensors = [leaf for leaf in _pytree.tree_leaves(args) if isinstance(leaf, torch.Tensor)]
    if any(t.is_cuda for t in tensors):
        graph = capture(fn, args, {})
        return lambda *call_args: graph((call_args, {}))
    specs = []

    def flat(*call_args):
        # the trace returns the output's leaves; the structure is the one it recorded
        leaves, spec = _pytree.tree_flatten(fn(*call_args))
        specs.append(spec)
        return tuple(leaves)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # torch.jit.trace's own notice
        traced = torch.jit.trace(flat, args, check_trace=False, strict=False)
    return lambda *call_args: _pytree.tree_unflatten(list(traced(*call_args)), specs[0])


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).cpu().numpy()
    return np.asarray(leaf)


def assert_pure(fn: Callable, *example_args: Any, atol: float = 1e-5) -> None:
    """Assert ``fn`` is record-pure: eager and compiled evaluations agree in
    structure and values (``atol=0`` demands exact equality).

    Catches functions that read mutable Python state or mutate their inputs:
    those behave differently between eager calls and their once-recorded
    compiled form.
    """
    eager = fn(*example_args)
    compiled = _compiled(fn, example_args)(*example_args)
    eager_tree = _pytree.tree_structure(eager)
    compiled_tree = _pytree.tree_structure(compiled)
    assert eager_tree == compiled_tree, (
        f"output structure differs between eager ({eager_tree}) and compiled ({compiled_tree}) evaluation"
    )
    for e_leaf, c_leaf in zip(_pytree.tree_leaves(eager), _pytree.tree_leaves(compiled)):
        np.testing.assert_allclose(_host(e_leaf), _host(c_leaf), atol=atol)


class RetraceMonitor:
    """Counts how often a function is compiled again (shape/dtype churn detector).

    Each new input signature (the tensors' shapes, dtypes and devices, and
    the other arguments' values: :func:`unionml_tpu_torch._graphs.signature`)
    records a new compiled form, as ``jax.jit``
    traces once per signature; a repeated signature reuses its form. Excess
    recompiles are the compiled-framework performance bug: every new
    signature pays a full recording. Wrap the function, run the workload,
    then check ``monitor.traces``.
    """

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.traces = 0
        self.name = name or getattr(fn, "__name__", "fn")
        self._fn = fn
        self._forms: Dict[Tuple, Callable[..., Any]] = {}

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        key = signature((args, kwargs))
        form = self._forms.get(key)
        if form is None:
            self.traces += 1
            if self.traces > 1:
                logger.warning("%s re-traced (trace #%d) — check for shape/dtype churn", self.name, self.traces)
            bound = (lambda *a: self._fn(*a, **kwargs)) if kwargs else self._fn
            form = self._forms[key] = _compiled(bound, args)
        return form(*args)
