"""Stage runtime: the choke point where user functions become executable pipeline stages.

Port of ``unionml_tpu/stage.py``. :class:`Stage` is the same plain Python
callable with a typed keyword-only interface, resource request, optional
content-hash result caching and a serializable address ``(module, variable,
stage_name)``.

:class:`TracedFunction` wraps user ``trainer``/``predictor``/``evaluator``
callables with the JAX package's compilation policy; its compiled path is a
CUDA graph per trace key (:mod:`unionml_tpu_torch._graphs`) where the JAX
package has a ``jax.jit`` executable:

- ``jit=False`` runs eagerly;
- ``"auto"`` captures when every argument leaf is a tensor, a numpy array, a
  python scalar or a resident object (an ``nn.Module``, or a dataclass such as
  ``TrainState`` holding one), and runs opaque model objects (sklearn
  estimators) eagerly for good; a capture failure (a host sync inside the
  function) runs that call eagerly and blacklists only its trace key, with the
  same 128-key bound; errors of the function itself propagate;
- ``True`` raises :class:`StageError` when capture fails.

A call whose tensors lie on the CPU, or that carries numpy arrays, has no
graph: it runs eagerly (the caller asked for the CPU).
"""

import hashlib
import inspect
import os
import pickle
import time
from collections import OrderedDict
from functools import wraps
from pathlib import Path
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree

from unionml_tpu_torch import _graphs
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.defaults import DEFAULT_RESOURCES, Resources
from unionml_tpu_torch.exceptions import StageError

_EMPTY = inspect.Parameter.empty

#: leaf types that can cross into a captured graph (tensors as inputs, the rest baked in)
_TRACEABLE_LEAVES = (torch.Tensor, np.ndarray, np.generic, float, int, bool, complex, type(None))
#: leaf types treated as static (baked into the graph) when auto-capturing
_STATIC_LEAVES = (str, bytes, type(None))
_TRACE_FAILED_KEYS_MAX = 128


def is_tensor_compatible(tree: Any) -> bool:
    """True when every leaf of ``tree`` can take part in a captured graph:
    tensors, numpy arrays and scalars, python scalars, ``None``, and resident
    objects (see :func:`unionml_tpu_torch._graphs.is_resident`)."""
    return all(
        isinstance(leaf, _TRACEABLE_LEAVES) or _graphs.is_resident(leaf) for leaf in _pytree.tree_leaves(tree)
    )


def _scalarize(value: Any) -> Any:
    """Convert 0-d tensors and numpy arrays to python scalars (for metrics dict parity)."""
    if isinstance(value, (torch.Tensor, np.ndarray)) and value.ndim == 0:
        return value.item()
    return value


class TracedFunction:
    """A user callable with a capture policy and eager fallback.

    :param fn: the user function.
    :param jit: ``True`` (always capture; failures raise), ``False`` (never),
        or ``"auto"`` (capture when the inputs allow it; eager otherwise).
    :param static_argnames: kwarg names baked into the graph (part of its key).
    """

    def __init__(self, fn: Callable, *, jit: Union[bool, str] = "auto", static_argnames: Sequence[str] = ()):
        wraps(fn)(self)
        self._fn = fn
        self._policy = jit
        self._static_argnames = tuple(static_argnames)
        self._eager = jit is False
        self._cache = _graphs.GraphCache(max_failed=_TRACE_FAILED_KEYS_MAX)

    @property
    def fn(self) -> Callable:
        return self._fn

    @property
    def uses_jit(self) -> bool:
        return not self._eager

    def _auto_static_names(self, kwargs: Mapping[str, Any]) -> Tuple[str, ...]:
        names = set(self._static_argnames)
        for key, value in kwargs.items():
            if isinstance(value, _STATIC_LEAVES) or not is_tensor_compatible(value):
                names.add(key)
        return tuple(sorted(names))

    def _trace_key(self, static_names: Tuple[str, ...], args: Tuple, kwargs: Mapping[str, Any]) -> Tuple:
        """Identity of one call's graph: static names AND values, plus the
        signature of the rest (:func:`unionml_tpu_torch._graphs.signature`:
        tensor shapes and dtypes, resident objects by identity, scalars by
        value, since a graph bakes them in). Unhashable static values degrade
        to their type name."""
        vals = []
        for name in static_names:
            if name in kwargs:
                value = kwargs[name]
                try:
                    hash(value)
                except TypeError:
                    value = type(value).__name__
                vals.append((name, value))
        traced = {k: v for k, v in kwargs.items() if k not in static_names}
        return (static_names, tuple(vals), _graphs.signature((args, traced)))

    def __call__(self, *args, **kwargs):
        if self._eager:
            return self._fn(*args, **kwargs)

        if not is_tensor_compatible(args):
            if self._policy == "auto":
                # opaque model objects (sklearn) can never be captured: permanent eager
                self._eager = True
                logger.debug("%s: inputs are not tensor-compatible; running eagerly.",
                             getattr(self._fn, "__name__", self._fn))
                return self._fn(*args, **kwargs)
            raise StageError(f"CUDA-graph capture of {self._fn} failed: its arguments are not tensor-compatible")

        if not _graphs.capturable((args, kwargs)):
            # CPU tensors (the caller asked for the CPU) or host arrays: no graph
            return self._fn(*args, **kwargs)

        static_names = self._auto_static_names(kwargs)
        key = self._trace_key(static_names, args, kwargs)
        try:
            graph = self._cache.lookup(key, self._fn, args, dict(kwargs))
        except _graphs.CaptureError as exc:
            if self._policy != "auto":
                raise StageError(f"CUDA-graph capture of {self._fn} failed") from exc
            logger.info(
                "%s: CUDA-graph capture failed (%s); falling back to eager execution for this call signature.",
                getattr(self._fn, "__name__", self._fn),
                exc,
            )
            return self._fn(*args, **kwargs)
        if graph is None:
            # this exact call signature failed to capture before; run it eagerly
            # without downgrading other (capturable) call shapes on the instance
            if self._policy != "auto":
                raise StageError(f"CUDA-graph capture of {self._fn} failed before for this call signature")
            return self._fn(*args, **kwargs)
        # replay errors (and errors the function raised in its eager warm-up) propagate
        return graph((args, kwargs))


def _default_cache_root() -> Path:
    return Path(os.getenv("UNIONML_TPU_TORCH_HOME", Path.home() / ".unionml-tpu-torch")) / "cache"


def _fingerprint(payload: Any) -> str:
    try:
        raw = pickle.dumps(payload)
    except Exception:  # graftlint: disable=swallowed-exception -- unpicklable payloads get an empty fingerprint, which disables caching for them by design
        return ""
    return hashlib.sha256(raw).hexdigest()


class Stage:
    """An executable pipeline stage with a typed keyword-only interface.

    Stages are the unit the workflow engine wires together and the unit the execution
    backend ships to workers. A stage's address is ``(app module, tracked variable,
    stage name)`` — see :mod:`unionml_tpu_torch.tracker`.
    """

    def __init__(
        self,
        fn: Callable,
        *,
        name: str,
        owner: Any = None,
        inputs: "OrderedDict[str, inspect.Parameter]",
        output_annotation: Any = _EMPTY,
        requests: Resources = DEFAULT_RESOURCES,
        limits: Resources = DEFAULT_RESOURCES,
        cache: bool = False,
        cache_version: str = "0",
        **extra_options: Any,
    ):
        self._fn = fn
        self.name = name
        self.owner = owner
        self.inputs: "OrderedDict[str, inspect.Parameter]" = inputs
        self.output_annotation = output_annotation
        self.requests = requests
        self.limits = limits
        self.cache = cache
        self.cache_version = cache_version
        self.options = extra_options
        self.last_duration: Optional[float] = None

    @property
    def python_interface(self) -> "StageInterface":
        return StageInterface(
            inputs=OrderedDict((k, p.annotation) for k, p in self.inputs.items()),
            outputs=_output_mapping(self.output_annotation),
        )

    def _cache_path(self, digest: str) -> Path:
        safe_name = self.name.replace("/", "_")
        return _default_cache_root() / safe_name / self.cache_version / f"{digest}.pkl"

    def __call__(self, **kwargs: Any) -> Any:
        unknown = set(kwargs) - set(self.inputs)
        if unknown:
            raise StageError(f"Stage {self.name} received unknown arguments: {sorted(unknown)}")

        digest = ""
        if self.cache:
            digest = _fingerprint((self.name, self.cache_version, sorted(kwargs.items(), key=lambda kv: kv[0])))
            if digest:
                path = self._cache_path(digest)
                if path.exists():
                    logger.debug("Stage %s: cache hit (%s)", self.name, digest[:12])
                    with path.open("rb") as f:
                        return pickle.load(f)

        start = time.perf_counter()
        result = self._fn(**kwargs)
        self.last_duration = time.perf_counter() - start
        logger.debug("Stage %s ran in %.4fs", self.name, self.last_duration)

        if self.cache and digest:
            path = self._cache_path(digest)
            path.parent.mkdir(parents=True, exist_ok=True)
            try:
                with path.open("wb") as f:
                    pickle.dump(result, f)
            except Exception as exc:  # unpicklable results simply skip the cache
                logger.debug("Stage %s: result not cacheable (%s)", self.name, exc)
        return result

    def __repr__(self) -> str:
        return f"Stage(name={self.name!r}, inputs={list(self.inputs)}, cache={self.cache})"


class StageInterface:
    """Typed input/output view of a stage (flytekit ``python_interface`` analogue)."""

    def __init__(self, inputs: "OrderedDict[str, Any]", outputs: "OrderedDict[str, Any]"):
        self.inputs = inputs
        self.outputs = outputs


def _output_mapping(annotation: Any) -> "OrderedDict[str, Any]":
    """Expose NamedTuple outputs as named fields, everything else as a single output ``o0``."""
    fields = getattr(annotation, "_fields", None)
    if fields is not None and hasattr(annotation, "__annotations__"):
        return OrderedDict((f, annotation.__annotations__.get(f, Any)) for f in fields)
    return OrderedDict([("o0", annotation)])


def stage(
    fn: Optional[Callable] = None,
    *,
    unionml_obj: Any,
    input_parameters: Optional[Mapping[str, inspect.Parameter]] = None,
    return_annotation: Any = _EMPTY,
    **stage_kwargs: Any,
) -> Union[Callable, Stage]:
    """Build a :class:`Stage` from a closure defined inside Dataset/Model.

    The synthesized interface is keyword-only, named ``{obj.name}.{fn.__name__}`` —
    reference parity with ``inner_task`` (``unionml/utils.py:40-60``).
    """
    if fn is None:
        def _bind(inner_fn: Callable) -> Stage:
            return stage(
                inner_fn,
                unionml_obj=unionml_obj,
                input_parameters=input_parameters,
                return_annotation=return_annotation,
                **stage_kwargs,
            )
        return _bind

    fn_sig = inspect.signature(fn)
    params = input_parameters if input_parameters is not None else fn_sig.parameters
    interface = OrderedDict(
        (name, p.replace(kind=inspect.Parameter.KEYWORD_ONLY)) for name, p in params.items()
    )
    output = fn_sig.return_annotation if return_annotation is _EMPTY else return_annotation

    known = {"requests", "limits", "cache", "cache_version"}
    core = {k: v for k, v in stage_kwargs.items() if k in known}
    extra = {k: v for k, v in stage_kwargs.items() if k not in known}
    built = Stage(
        fn,
        name=f"{unionml_obj.name}.{fn.__name__}",
        owner=unionml_obj,
        inputs=interface,
        output_annotation=output,
        **core,
        **extra,
    )
    return built
