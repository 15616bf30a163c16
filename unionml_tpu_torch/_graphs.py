"""CUDA-graph capture: the port's counterpart of a ``jax.jit`` executable.

:func:`capture` records one call of a function as a ``torch.cuda.CUDAGraph``
over static input buffers; :class:`CapturedGraph` replays it for new inputs of
the same shapes. :class:`~unionml_tpu_torch.stage.TracedFunction` keeps one
graph per trace key and :class:`~unionml_tpu_torch.serving.resident.
ResidentPredictor` one per (batch bucket, sequence bucket); both go through
this module, and both keep their graphs in a :class:`GraphCache`.

The arguments are a tree (``torch.utils._pytree``: dicts, lists, tuples).
Its tensor leaves are the graph's inputs, copied into static buffers before
every replay; every other leaf (python scalars, strings, ``None``, an
``nn.Module`` or a dataclass holding one) is baked into the graph, so a
caller keys its graphs by those leaves' values (:func:`signature`). A module's
parameters are read at their addresses, so in-place updates reach the graph.
A key names a resident object by its ``id``, so a graph must not outlive the
objects it reads: :class:`GraphCache` drops a key's graph when one of them is
freed, before CPython can hand the id to a new object.

A capture runs the function eagerly twice first (on a side stream, as
CUDA-graph capture requires), then records it. The first warm-up
run goes under a check (:class:`_HostSyncCheck`, a thread-local dispatch
mode) that stops at the first operation a graph cannot hold: a host sync
(``.item()``, ``float()``, ``.cpu()``, ``nonzero``) or a copy between host
and device. That is the counterpart of a trace failure: :class:`CaptureError`
is raised before recording starts. The check matters beyond the message: a
recording that CUDA aborts leaves PyTorch's CUDA generator in capture mode,
and every later random draw on the device fails. An error of the
function's own in a warm-up run propagates unchanged.

The recording launches nothing, so the kernel launch counts
(:mod:`unionml_tpu_torch.kernels`) its wrappers add on the capturing thread
are taken back and kept on the graph, which adds them at every replay: a count
is then the launches that really ran, eager or replayed, whichever thread ran
them.
"""

import threading
import time
import weakref
from collections import deque
from dataclasses import fields, is_dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from unionml_tpu_torch import kernels

__all__ = ["CaptureError", "CapturedGraph", "GraphCache", "capture", "capturable", "is_resident", "signature"]

# one capture at a time in the process: capture puts the allocator and the
# capture stream in a mode no second capture may share
_CAPTURE_LOCK = threading.Lock()
#: eager runs before the recording: the first under :class:`_HostSyncCheck`,
#: the second plain (lazy initialisations done in the first settle)
_WARMUP_RUNS = 2


class CaptureError(RuntimeError):
    """A call cannot be recorded as a CUDA graph (it syncs with the host)."""


# operators that wait for the device (a scalar or a data-dependent shape comes back to the host)
_SYNCING_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select", "equal", "is_nonzero",
                          "_unique2", "unique_consecutive", "unique_dim"})


def _device_types(values) -> set:
    return {v.device.type for v in values if isinstance(v, torch.Tensor)}


class _HostSyncCheck(TorchDispatchMode):
    """Raise :class:`CaptureError` at the first operator a CUDA graph cannot
    hold: one that syncs with the host, or a copy between host and device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        crosses = False
        if name == "_to_copy" and kwargs.get("device") is not None:
            crosses = len(_device_types(args[:1]) | {torch.device(kwargs["device"]).type}) > 1
        elif name == "copy_":
            crosses = len(_device_types(args[:2])) > 1
        if name in _SYNCING_OPS or crosses:
            raise CaptureError(f"{func} {'copies between host and device' if crosses else 'syncs with the host'}, "
                               "which a CUDA graph cannot hold")
        return func(*args, **kwargs)


def is_resident(leaf: Any) -> bool:
    """An ``nn.Module``, or a dataclass instance with an ``nn.Module`` field
    (the port's ``TrainState``): an object whose tensors stay where they are
    and are read in place by a captured graph."""
    if isinstance(leaf, nn.Module):
        return True
    if is_dataclass(leaf) and not isinstance(leaf, type):
        return any(isinstance(getattr(leaf, f.name), nn.Module) for f in fields(leaf))
    return False


def _leaf_key(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    if is_resident(leaf):
        return ("resident", type(leaf).__name__, id(leaf))
    try:
        hash(leaf)
    except TypeError:
        return type(leaf).__name__
    return (type(leaf).__name__, leaf)


def signature(tree: Any) -> Tuple:
    """What a graph of ``tree`` depends on: the tree's structure, each
    tensor's shape, dtype and device, each resident object's identity and
    every other leaf's value (its type name where it is unhashable)."""
    leaves, spec = _pytree.tree_flatten(tree)
    return (str(spec), tuple(_leaf_key(leaf) for leaf in leaves))


def capturable(tree: Any) -> bool:
    """True when a graph of ``tree`` can be captured: some tensor leaf lies
    on a CUDA device and no leaf is host data that a graph cannot read (a
    CPU tensor or a numpy array)."""
    leaves = _pytree.tree_leaves(tree)
    tensors = [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)]
    if any(isinstance(leaf, np.ndarray) for leaf in leaves):
        return False
    return bool(tensors) and all(t.is_cuda for t in tensors)


class CapturedGraph:
    """One recorded call: replay it with new tensor leaves of the same shapes.

    Replays of one graph are serialized: they share the static buffers, so a
    lock covers the copy in, the replay and the clone of the outputs, and an
    event orders each replay on the device after the previous one's clone,
    whichever stream either ran on.
    """

    def __init__(self, graph: "torch.cuda.CUDAGraph", spec: Any, n_leaves: int, slots: List[int],
                 static: List[torch.Tensor], output: Any, capture_ms: float, device: torch.device,
                 launches: Optional[Dict[str, int]] = None):
        self._graph = graph
        self._device = device
        self._spec = spec
        self._n_leaves = n_leaves
        self._slots = slots
        self._static = static
        self._output = output
        self._lock = threading.Lock()
        self._done = None  # guarded-by: _lock
        #: wall ms of :func:`capture`: the eager warm-up runs and the recording
        self.capture_ms = capture_ms
        #: kernel launches per replay, by kernel name (what the recording counted)
        self.launches = dict(launches or {})
        self.replays = 0  # guarded-by: _lock

    @property
    def shapes(self) -> List[Tuple[int, ...]]:
        """The shapes of the graph's tensor inputs, in tree order."""
        return [tuple(buf.shape) for buf in self._static]

    def __call__(self, tree: Any) -> Any:
        leaves, spec = _pytree.tree_flatten(tree)
        if str(spec) != str(self._spec) or len(leaves) != self._n_leaves:
            raise ValueError("CapturedGraph called with a tree of another structure than it was captured with")
        with self._lock:
            stream = torch.cuda.current_stream(self._device)
            if self._done is not None:
                stream.wait_event(self._done)
            with torch.no_grad():
                for slot, buf in zip(self._slots, self._static):
                    buf.copy_(leaves[slot])
            self._graph.replay()
            for name, count in self.launches.items():
                kernels.note_launch(name, count)
            out = _pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, self._output)
            self._done = torch.cuda.Event()
            self._done.record(stream)
            self.replays += 1
        return out


def capture(fn: Callable, args: Tuple, kwargs: dict, *, device: Optional[torch.device] = None,
            generators: Tuple[torch.Generator, ...] = (), stream: Optional["torch.cuda.Stream"] = None
            ) -> CapturedGraph:
    """Record ``fn(*args, **kwargs)`` as a CUDA graph (see the module's
    docstring). The returned graph has not run yet: call it to replay.

    ``device`` names the CUDA device of a function with no tensor arguments
    (one that reads and writes tensors it holds, such as a decode step over
    an engine's static buffers). ``generators`` are the ``torch.Generator``
    objects the function draws from besides the default one: each is
    registered with the graph, so every replay draws fresh numbers from it.
    ``stream`` is the stream to record on (default: PyTorch's one capture
    stream). Graphs that replay at once on different streams must be
    recorded on different streams: cuBLAS takes its workspace per (thread,
    stream), so two graphs recorded by one thread on one stream read and
    write the same workspace, and overlapping replays corrupt each other.

    :raises CaptureError: the call cannot be recorded (see the module's
        docstring); nothing of the graph is kept.
    """
    leaves, spec = _pytree.tree_flatten((args, kwargs))
    slots = [i for i, leaf in enumerate(leaves) if isinstance(leaf, torch.Tensor)]
    if slots:
        if not capturable((args, kwargs)):
            raise CaptureError("a CUDA graph needs CUDA tensor inputs and no host arrays")
        device = leaves[slots[0]].device
    elif device is None or torch.device(device).type != "cuda" or any(
            isinstance(leaf, np.ndarray) for leaf in leaves):
        raise CaptureError("a CUDA graph needs CUDA tensor inputs (or a CUDA device) and no host arrays")
    device = torch.device(device)
    t0 = time.perf_counter()
    with _CAPTURE_LOCK, torch.cuda.device(device):
        static = [leaves[i].detach().clone() for i in slots]
        filled = list(leaves)
        for slot, buf in zip(slots, static):
            filled[slot] = buf

        def run():
            call_args, call_kwargs = _pytree.tree_unflatten(filled, spec)
            return fn(*call_args, **call_kwargs)

        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            with _HostSyncCheck():  # first, so a function that syncs stops after one partial run
                run()
            for _ in range(_WARMUP_RUNS - 1):
                run()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for generator in generators:
            graph.register_generator_state(generator)
        try:
            # the recording launched nothing: its counts (this thread's only)
            # move to the graph
            with kernels.recording() as recorded, torch.cuda.graph(graph, stream=stream,
                                                                   capture_error_mode="thread_local"):
                output = run()
        except Exception as exc:
            raise CaptureError(f"capturing {getattr(fn, '__name__', fn)} failed: {type(exc).__name__}: {exc}") from exc
        capture_ms = (time.perf_counter() - t0) * 1e3
    return CapturedGraph(graph, spec, len(leaves), slots, static, output, capture_ms, device, recorded)


class GraphCache:
    """Graphs by key, each captured once, and the keys whose capture failed.

    :meth:`lookup` is the one place where both callers (``TracedFunction``
    and ``ResidentPredictor``) capture: under one lock, so racing first calls
    of a key capture it once. A failed key is remembered and runs eagerly
    from then on; the failed set is cleared when it reaches ``max_failed``
    keys, the bound the JAX package puts on its trace blacklist. Every eager
    run in place of a graph counts in :attr:`eager_fallbacks`.

    A key names each resident object of the call by its ``id``. The cache
    holds no reference to those objects (a graph must not keep a freed
    model's memory alive), so it watches them: when one is freed, every key
    that named it is dropped with its graph at the next lookup. CPython calls
    the weakref callback before the object's memory, and so its id, can be
    reused, so a new object never meets a graph of the freed one. An object
    that takes no weak reference is pinned instead, which keeps its id its own.
    """

    def __init__(self, max_failed: int = 128):
        self._max_failed = max_failed
        self._lock = threading.Lock()
        self.graphs: Dict[Any, CapturedGraph] = {}  # guarded-by: _lock
        self.failed: Set[Any] = set()  # guarded-by: _lock
        self.eager_fallbacks = 0  # guarded-by: _lock
        self._keys_of: Dict[int, Set[Any]] = {}  # guarded-by: _lock
        self._pinned: Dict[int, Any] = {}  # guarded-by: _lock
        # ids of freed resident objects; appended by weakref callbacks, which
        # may run on any thread and inside any allocation, so without the lock
        self._freed: deque = deque()

    @staticmethod
    def _note_freed(cache_ref: "weakref.ref", ident: int) -> None:
        cache = cache_ref()
        if cache is not None:
            cache._freed.append(ident)

    def _drop_freed(self) -> None:
        while self._freed:
            for key in self._keys_of.pop(self._freed.popleft(), ()):
                self.graphs.pop(key, None)
                self.failed.discard(key)

    def _watch(self, key: Any, tree: Any) -> None:
        for leaf in _pytree.tree_leaves(tree):
            if not is_resident(leaf):
                continue
            ident = id(leaf)
            if ident not in self._keys_of:
                try:
                    weakref.finalize(leaf, GraphCache._note_freed, weakref.ref(self), ident).atexit = False
                except TypeError:
                    self._pinned[ident] = leaf
                self._keys_of[ident] = set()
            self._keys_of[ident].add(key)

    def captured(self) -> List[CapturedGraph]:
        """The graphs held now."""
        with self._lock:
            return list(self.graphs.values())

    def note_fallback(self) -> None:
        """Count an eager run that no key stands for (features that do not pad)."""
        with self._lock:
            self.eager_fallbacks += 1

    def lookup(self, key: Any, fn: Callable, args: Tuple, kwargs: dict) -> Optional[CapturedGraph]:
        """The graph of ``key`` for ``fn(*args, **kwargs)``, captured on first
        use; ``None`` when the key's capture failed before (the caller runs
        eagerly, counted as a fallback).

        :raises CaptureError: the capture fails now; the key is remembered
            and the eager run the caller makes instead is counted.
        """
        with self._lock:
            self._drop_freed()
            graph = self.graphs.get(key)
            if graph is not None:
                return graph
            if key in self.failed:
                self.eager_fallbacks += 1
                return None
            try:
                graph = capture(fn, args, kwargs)
            except CaptureError:
                if len(self.failed) >= self._max_failed:
                    # per-call static values (ids, dates) would grow the set for
                    # the process lifetime; clearing means an occasional re-attempted capture
                    self.failed.clear()
                    for keys in self._keys_of.values():
                        keys.intersection_update(self.graphs)
                self.failed.add(key)
                self._watch(key, (args, kwargs))
                self.eager_fallbacks += 1
                raise
            self.graphs[key] = graph
            self._watch(key, (args, kwargs))
            return graph
