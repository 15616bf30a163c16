"""Resident predictor: the model on the card, one CUDA graph per padded request shape.

Port of ``unionml_tpu/serving/resident.py``. Where the JAX package keeps one
compiled XLA executable per bucket, this keeps one ``torch.cuda.CUDAGraph``
per (batch bucket, sequence bucket), captured on the first request of that
shape (or at warm-up) through :mod:`unionml_tpu_torch._graphs`, so a request
is: pad, copy into the graph's static inputs, replay, copy the output to the
host. The model object stays on the device.

The bucketing is the JAX package's (SURVEY.md §7 "hard parts"): requests pad
their batch (dim 0) up ``buckets``; with ``seq_buckets``, integer leaves of
DICT features (token ids, masks) also pad dim 1 up a second ladder, and
predictions slice back to the request's rows. Padding rows are all zeros:
their attention mask is empty, so each padding row's output is garbage that
is sliced off, and no predictor may reduce across the batch.

Execution modes, decided once at setup:

- a tensor-compatible model object on a CUDA ``device``: CUDA graphs. A
  capture failure (the predictor syncs the host) serves that shape eagerly
  from then on and counts an eager fallback (:attr:`eager_fallbacks`); an
  error on replay propagates — there is no fallback that hides the kernels;
- on the CPU (``device="cpu"``, asked for explicitly): the same padding, with
  the predictor run eagerly;
- an opaque model object (sklearn): ``model.predict`` per request.

Replays of one graph are serialized (they share its static buffers); the
output is cloned before the next replay may start.
"""

import threading
import time
from collections import deque
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import _pytree

from unionml_tpu_torch import _graphs
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.stage import is_tensor_compatible
from unionml_tpu_torch.utils import hard_sync

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _ladder_value(ladder: Tuple[int, ...], n: int) -> int:
    """Smallest ladder entry >= n; oversize rounds up to a multiple of the largest."""
    for rung in ladder:
        if rung >= n:
            return rung
    largest = ladder[-1]
    return ((n + largest - 1) // largest) * largest


def _is_integer(a: Any) -> bool:
    if isinstance(a, torch.Tensor):
        return not (a.dtype.is_floating_point or a.dtype.is_complex or a.dtype == torch.bool)
    return np.issubdtype(a.dtype, np.integer)


def to_host(tree: Any) -> Any:
    """Every tensor of ``tree`` as a host numpy array (bf16 as float32): the
    device-to-host fetch that ends a request, and its barrier."""

    def fetch(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()

    return _pytree.tree_map(fetch, tree)


def _place(model_object: Any, device: torch.device) -> Any:
    """The model object on ``device``: modules (and a ``TrainState``'s
    model) move in place; tensor trees are copied."""
    if isinstance(model_object, nn.Module):
        return model_object.to(device)
    module = getattr(model_object, "model", None)
    if isinstance(module, nn.Module) and _graphs.is_resident(model_object):
        module.to(device)
        return model_object
    return _pytree.tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, model_object)


class ResidentPredictor:
    """Holds a model artifact on the device with a CUDA graph per request shape.

    :param device: where the model object lives and requests run; ``"cuda"``
        (default) raises without a CUDA device unless ``"cpu"`` is asked for.
    """

    def __init__(
        self,
        model: Any,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        warmup: bool = True,
        seq_buckets: Optional[Sequence[int]] = None,
        example_features: Optional[Any] = None,
        mesh: Optional[Any] = None,
        param_specs: Optional[Any] = None,
        device: Any = "cuda",
    ):
        if mesh is not None or param_specs is not None:
            raise NotImplementedError("mesh / param_specs (a mesh-resident predictor) is not ported yet (ROADMAP: M12)")
        self._model = model
        self._device = resolve_device(device)
        self._buckets = tuple(sorted(buckets))
        self._seq_buckets = tuple(sorted(seq_buckets)) if seq_buckets else None
        self._example_features = example_features
        self._warmup = warmup
        self._predictor_fn = None
        self._device_model_object = None
        # serializes setup(): predict() runs on executor threads, and several
        # first requests can race into the lazy init — exactly one may place
        # the artifact on the device and warm it (the rest wait, then see _ready)
        self._setup_lock = threading.Lock()
        self._ready = False  # guarded-by: _setup_lock
        # one CUDA graph per padded shape signature (and model object)
        self._cache = _graphs.GraphCache()
        # per-request latency (pad, replay, device->host fetch), ms: the
        # server-side half of the device/HTTP latency split that /stats quotes
        self._device_times_ms: deque = deque(maxlen=2048)
        self._device_times_lock = threading.Lock()
        # shape signatures that have already run once: the FIRST call at a new
        # padded shape pays the capture, which must not count as steady state
        self._timed_shapes: set = set()

    @property
    def uses_graphs(self) -> bool:
        return self._predictor_fn is not None and self._device.type == "cuda"

    def device_stats(self) -> dict:
        """Percentiles of the per-request wall time of warm shapes."""
        with self._device_times_lock:
            times = sorted(self._device_times_ms)
        if not times:
            return {"count": 0}
        at = lambda q: round(times[min(int(len(times) * q), len(times) - 1)], 3)
        return {
            "count": len(times),
            "device_p50_ms": at(0.50),
            "device_p90_ms": at(0.90),
            "device_p99_ms": at(0.99),
        }

    @property
    def eager_fallbacks(self) -> int:
        """Requests served eagerly although the predictor runs CUDA graphs (a
        shape whose capture failed, or features that do not pad)."""
        return self._cache.eager_fallbacks

    def graph_stats(self) -> list:
        """Each captured graph: its padded input shapes, capture ms and replays."""
        return [{"shapes": graph.shapes, "capture_ms": graph.capture_ms, "replays": graph.replays}
                for graph in self._cache.captured()]

    def setup(self) -> None:
        """Place the model object on the device and warm the smallest bucket.

        Idempotent and thread-safe: concurrent first requests race through
        predict()'s fast-path readiness check, so the body runs under
        ``_setup_lock`` and re-checks."""
        with self._setup_lock:
            if self._ready:
                return
            artifact = self._model.artifact
            if artifact is None:
                raise RuntimeError("ResidentPredictor.setup requires a loaded model artifact.")
            predictor = self._model._predictor
            model_object = artifact.model_object
            if is_tensor_compatible(model_object):
                self._device_model_object = _place(model_object, self._device)  # graftlint: disable=data-race -- published once under _setup_lock; readers run only after the _ready check, which happens-after this write
                self._predictor_fn = getattr(predictor, "fn", predictor)  # graftlint: disable=data-race -- published once under _setup_lock, as above
                if self._warmup:
                    self._warm()  # graftlint: disable=lock-order -- one-time init: racing first requests MUST wait for capture+warm before serving, so blocking under _setup_lock is the contract
            else:
                logger.info("Model object is not tensor-compatible; serving will run the predictor eagerly.")
            self._ready = True

    def _warm(self) -> None:
        """Capture (or, on the CPU, run) the smallest bucket ahead of the first request."""
        try:
            example = self._example_processed(self._buckets[0])
            if example is None:
                logger.info("No warmup template (pass example_features to serve()); first request will capture.")
                return
            hard_sync(self._run(example))
            logger.info("Resident predictor warmed (bucket=%d).", self._buckets[0])
        except Exception as exc:
            # the synthetic example may simply have the wrong dtype/shape for
            # this model; the first real request still captures
            logger.info("Warmup skipped (%s: %s); first request will capture.", type(exc).__name__, exc)

    def _example_processed(self, batch: int) -> Optional[Any]:
        """A processed, bucket-shaped feature tree for warm-up: the user's
        ``example_features`` rows through the real feature pipeline and padding,
        else zero features from flat feature-column metadata."""
        if self._example_features is not None:
            example = self._example_features
            if isinstance(example, list) and example:
                # resize the example rows to the requested bucket so warmup captures
                # the graph real requests will actually hit (smallest bucket)
                example = [example[i % len(example)] for i in range(batch)]
            processed = self._model.dataset.get_features(example)
            padded, _, _ = self._pad_to_buckets(processed)
            return padded
        feature_columns = getattr(self._model.dataset, "_features", None)
        if feature_columns:
            return torch.zeros((batch, len(feature_columns)), dtype=torch.float32, device=self._device)
        return None

    def _bucket_for(self, n: int) -> int:
        return _ladder_value(self._buckets, n)

    # ------------------------------------------------------------------ padding

    def _array_leaves(self, processed: Any):
        """Flatten processed features; returns (leaves, spec, n) or None if any
        leaf is not a batch-dim array (opaque features run eagerly)."""
        leaves, spec = _pytree.tree_flatten(processed)
        if not leaves:
            return None
        for leaf in leaves:
            if not isinstance(leaf, (torch.Tensor, np.ndarray)) or leaf.ndim < 1:
                return None
        n = leaves[0].shape[0]
        if any(a.shape[0] != n for a in leaves):
            return None
        return leaves, spec, n

    def _pad_to_buckets(self, processed: Any):
        """Pad every array leaf's batch dim (and sequence dim, when configured) up the
        bucket ladders, on the predictor's device. Returns (padded_tree,
        original_batch, batch_bucket).

        Sequence-dim padding applies only to DICT (multi-input/tokenized) features: a
        single flat feature MATRIX — even an integer one (ordinal/categorical
        encodings) — has a fixed width that must never grow fabricated columns."""
        is_multi_input = isinstance(processed, dict)
        flat = self._array_leaves(processed)
        if flat is None:
            raise ValueError("features are not a batch-dim array tree")
        arrays, spec, n = flat
        bucket = self._bucket_for(n)
        padded = []
        for a in arrays:
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32) if a.dtype == np.float64 else a))
            elif a.dtype == torch.float64:
                a = a.float()
            a = a.to(self._device)
            pad = [(0, 0)] * a.ndim
            if bucket != n:
                pad[0] = (0, bucket - n)
            # dim 1 is a sequence axis for integer leaves (token ids / masks) and
            # rank>=3 leaves (batch, seq, features); a rank-2 FLOAT leaf is a flat
            # feature matrix whose width must never be padded
            is_seq_leaf = _is_integer(a) or a.ndim >= 3
            if self._seq_buckets is not None and a.ndim >= 2 and is_seq_leaf and is_multi_input:
                seq = a.shape[1]
                seq_bucket = _ladder_value(self._seq_buckets, seq)
                if seq_bucket != seq:
                    pad[1] = (0, seq_bucket - seq)
            if any(p != (0, 0) for p in pad):
                a = F.pad(a, [side for lo_hi in reversed(pad) for side in lo_hi])
            padded.append(a.contiguous())
        return _pytree.tree_unflatten(padded, spec), n, bucket

    # ------------------------------------------------------------------ execution

    def _eager(self, model_object: Any, padded: Any) -> Any:
        with torch.no_grad():
            return self._predictor_fn(model_object, padded)

    def _run(self, padded: Any) -> Any:
        """The predictor on one padded batch: its shape's graph on the card
        (captured on first use), the eager predictor on the CPU. Raises
        :class:`~unionml_tpu_torch._graphs.CaptureError` once per shape whose
        capture fails; that shape runs eagerly from then on."""
        call = (self._device_model_object, padded)
        if self._device.type != "cuda":
            return self._eager(*call)
        graph = self._cache.lookup(_graphs.signature(call), self._eager, call, {})
        if graph is None:
            return self._eager(*call)
        return graph((call, {}))

    # ------------------------------------------------------------------ request path

    def predict(self, features: Any = None, **reader_kwargs) -> Any:
        """Request-path prediction: host numpy predictions of the request's rows."""
        if not self._ready:  # graftlint: disable=data-race -- benign double-checked fast path; setup() re-checks under _setup_lock before doing any work
            self.setup()
        if self._predictor_fn is None or features is None:
            return self._model.predict(features=features, **reader_kwargs)

        processed = self._model.dataset.get_features(features)
        try:
            padded, n, bucket = self._pad_to_buckets(processed)
        except ValueError:
            if self.uses_graphs:
                self._cache.note_fallback()
            return self._model.predict(features=features, **reader_kwargs)

        shape_sig = _graphs.signature(padded)
        # warm status is snapshotted BEFORE dispatch: only requests that start
        # after a shape was marked warm may record a steady-state sample
        with self._device_times_lock:
            was_warm = shape_sig in self._timed_shapes
        t0 = time.perf_counter()
        try:
            predictions = self._run(padded)
        except _graphs.CaptureError as exc:
            logger.info("Resident capture failed (%s); this shape is served eagerly.", exc)
            predictions = self._eager(self._device_model_object, padded)
        predictions = to_host(predictions)  # the fetch is the device barrier
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        with self._device_times_lock:
            if was_warm:
                self._device_times_ms.append(elapsed_ms)
            else:  # this call (and any concurrent peer) paid the capture: never record it
                self._timed_shapes.add(shape_sig)
        # slice the padding off every batch-shaped leaf (predictor outputs may be trees)
        result = _pytree.tree_map(
            lambda leaf: leaf[:n]
            if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] == bucket
            else leaf,
            predictions,
        )
        self._model._run_predict_callbacks(self._device_model_object, processed, result)
        return result
