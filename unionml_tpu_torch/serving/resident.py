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

On a mesh (``mesh=``, ``resident.py:61-140``) the predictor is SPMD over
``torch.distributed``: every rank builds it, rank 0 takes the requests and
the other ranks :meth:`ResidentPredictor.follow`, replaying each
``predict`` rank 0 sends them over the lead protocol
(:mod:`~unionml_tpu_torch.serving.lead`) until :meth:`ResidentPredictor.close`
releases them; an idle leader keeps them alive from a thread of its own.
A padded bucket that the batch's ranks (data×fsdp) divide is split over
them and each rank's rows are gathered back; any other bucket runs whole on
every rank (``resident.py:249-262``). Each rank keeps one CUDA graph per
bucket, with the tensor axis's collectives captured in it. The parameters
are replicated, or laid out by ``param_specs``: for the port's BERT and GPT
(a module, or a ``TrainState`` holding one) a spec that names ``tensor`` is
the family's ``param_shardings`` and the model runs its tensor-parallel
forward (``tensor_parallel``); a GPT's decoder blocks split over ``fsdp``
as the engines split them, BERT's ``fsdp`` entries are served whole (FSDP2 is
a training layout). Unlike XLA, eager PyTorch cannot split an arbitrary
callable, so a spec that names ``tensor`` for any other model object raises
``ValueError``; replicated data-parallel serving works for every predictor.

A BERT or GPT whose config splits rows over a ``sequence`` axis (ring or
Ulysses attention over its ``sp_mesh``) serves as it is over a mesh with
that axis (``resident.py:213-260``): each request's token arrays are cut
into the ranks' chunks (the sequence ladder's rungs must be multiples of the
axis size, else JAX's ``ValueError``; without a ladder the rows pad up to
one), BERT's pooler reads ``[CLS]`` on every rank and a GPT's per-chunk
logits are gathered back into whole rows. Beside a ``tensor`` axis
(``{"sequence": S, "tensor": T}`` with the family's ``param_specs``) the
tensor-parallel copy serves each chunk at the rank's heads. Ulysses
(all-to-alls) replays graphs as any model does; a ring over several ranks
runs eagerly (:attr:`ResidentPredictor.mode`), its point-to-point hops not
being recorded into graphs. Over any other mesh such a model attends densely.
"""

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils import _pytree

from unionml_tpu_torch import _graphs
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.lead import MeshLead, lead_calls
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


def _serving_module(model_object: Any) -> Any:
    """The module a model object computes with (itself, or a ``TrainState``'s
    model), or None."""
    if isinstance(model_object, nn.Module):
        return model_object
    module = getattr(model_object, "model", None)
    return module if isinstance(module, nn.Module) else None


def _whole(model_object: Any) -> Any:
    """A ``TrainState`` laid out on a mesh as one whose model holds every
    parameter whole (its leaves gathered from every rank: a collective);
    anything else as it is."""
    layout = getattr(model_object, "layout", None)
    if layout is None:
        return model_object
    return dataclasses.replace(model_object, model=layout.whole_model(model_object.params), layout=None)


def _mesh_layout(model_object: Any, mesh: Any, param_specs: Any) -> Any:
    """``model_object`` as this rank serves it under ``param_specs``: its
    module's tensor-parallel copy where a spec names ``tensor`` (the BERT or
    GPT family's ``param_shardings`` only), else itself (replicated; ``fsdp``
    entries are served whole)."""
    from unionml_tpu_torch.models._sharding import names_axis
    from unionml_tpu_torch.parallel.mesh import TENSOR_AXIS, axis_names

    names = axis_names(mesh)
    if param_specs is None or TENSOR_AXIS not in names or not names_axis(param_specs, TENSOR_AXIS):
        return model_object
    from unionml_tpu_torch.models.training import _family

    module = _serving_module(model_object)
    family = _family(module) if module is not None else None
    if family is None:
        raise ValueError(
            f"param_specs name the {TENSOR_AXIS!r} axis, but the model object ({type(model_object).__name__}) is "
            "not a model the port splits over it (BERT or GPT, or a TrainState holding one): XLA partitions any "
            "jitted predictor by its specs, eager PyTorch cannot split an arbitrary callable. Serve it replicated "
            "(param_specs=None), which is data-parallel for every predictor.")
    tensor_parallel, param_shardings, _ = family
    wanted = param_shardings(dict(module.named_parameters()), names)
    off = [n for n in wanted if n not in param_specs or tuple(param_specs[n]) != tuple(wanted[n])]
    if off:
        raise ValueError(f"the port's tensor-parallel forward computes the Megatron split of param_shardings "
                         f"only; param_specs differ at {off[:4]}")
    shard, _ = tensor_parallel(module, mesh)
    return shard if isinstance(model_object, nn.Module) else dataclasses.replace(model_object, model=shard)


def _sequence_config(model_object: Any) -> Any:
    """The config of the BERT or GPT ``model_object`` computes with when it
    splits rows over a ``sequence`` axis (``attention_impl`` ring or
    ulysses), else None."""
    from unionml_tpu_torch.models._layers import SEQUENCE_IMPLS

    cfg = getattr(_serving_module(model_object), "config", None)
    return cfg if getattr(cfg, "attention_impl", None) in SEQUENCE_IMPLS else None


def _serving_attention(model_object: Any, mesh: Any) -> Any:
    """``model_object`` as serving runs it. A BERT or GPT whose config splits
    rows over a ``sequence`` axis (``attention_impl`` ring or ulysses) is
    served as it is over a mesh with a ``sequence`` axis the size of its
    ``sp_mesh``'s (the predictor cuts each request's tokens into the
    ranks' chunks; beside a ``tensor`` axis the tensor-parallel copy keeps
    the config and each rank attends at its heads); over any other mesh, or
    none, it attends densely (a request's rows arrive whole), sharing its
    parameters. A ``sequence`` axis of another size than ``sp_mesh``'s
    raises ``ValueError``."""
    from unionml_tpu_torch.models._layers import dense_attention_copy
    from unionml_tpu_torch.parallel.mesh import SEQUENCE_AXIS, axis_names, sequence_size

    cfg = _sequence_config(model_object)
    if cfg is None:
        return model_object
    if mesh is not None and SEQUENCE_AXIS in axis_names(mesh):
        if sequence_size(cfg.sp_mesh) != sequence_size(mesh):
            raise ValueError(f"attention_impl={cfg.attention_impl!r} serves on a mesh with a {SEQUENCE_AXIS!r} axis "
                             f"the size of sp_mesh's ({sequence_size(cfg.sp_mesh)}), not {sequence_size(mesh)}")
        return model_object
    dense = dense_attention_copy(_serving_module(model_object))
    return dense if isinstance(model_object, nn.Module) else dataclasses.replace(model_object, model=dense)


def _is_sequence_leaf(a: Any) -> bool:
    """Dim 1 of a feature leaf is a sequence: an integer leaf of rank >= 2
    (token ids, masks) or a leaf of rank >= 3 (batch, seq, features)."""
    return a.ndim >= 2 and (_is_integer(a) or a.ndim >= 3)


class ResidentPredictor:
    """Holds a model artifact on the device with a CUDA graph per request shape.

    :param mesh: a ``DeviceMesh`` over the ``torch.distributed`` world (see
        the module docstring): every rank builds the predictor, rank 0
        predicts and the others :meth:`follow`.
    :param param_specs: the parameters' layout on ``mesh`` (a family's
        ``param_shardings``), or None to replicate them.
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
        if param_specs is not None and mesh is None:
            raise ValueError("param_specs lay the parameters out on a mesh: pass the mesh too")
        self._model = model
        self._mesh = mesh
        self._param_specs = param_specs
        #: the lead protocol of a mesh of several ranks (rank 0 predicts, the others follow)
        self._lead: Optional[MeshLead] = None
        #: the batch's ranks, this rank's group over them (None: one rank) and
        #: the group rank at each batch index (``batch_order``; None: the same)
        self._shards, self._batch_group, self._batch_order = 1, None, None
        if mesh is not None:
            from unionml_tpu_torch.parallel.distributed import collective_timeout_s
            from unionml_tpu_torch.parallel.mesh import batch_axis_size, batch_group, batch_order

            self._shards, self._batch_group = batch_axis_size(mesh), batch_group(mesh)
            self._batch_order = batch_order(mesh)
            if mesh.mesh.numel() > 1:
                self._lead = MeshLead(mesh, collective_timeout_s(), ("_serve",))
        # the leader's led calls one at a time (predict() runs on executor
        # threads), and its keep-alive thread between them
        self._serial = threading.Lock()
        self._keepalive: Optional[threading.Thread] = None
        self._closing = threading.Event()
        self._device = resolve_device(device)
        self._buckets = tuple(sorted(buckets))
        self._seq_buckets = tuple(sorted(seq_buckets)) if seq_buckets else None
        self._example_features = example_features
        self._warmup = warmup
        self._predictor_fn = None
        self._device_model_object = None
        #: the ``sequence`` axis a ring or Ulysses model is served over (a
        #: ``SequenceParallel``; None when rows run whole): each request's
        #: token arrays are cut into the ranks' chunks
        self._sequence = None
        #: the model's outputs are per position (a GPT's logits): gathered
        #: over the sequence axis back into whole rows
        self._per_position = False
        #: a ring over several ranks runs eagerly on the card: its
        #: point-to-point hops are not recorded into graphs (decided at set-up
        #: from the model's config, never by a failed capture)
        self._eager_mode = False
        #: requests served eagerly by that mode
        self.eager_requests = 0
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
        return self._predictor_fn is not None and self._device.type == "cuda" and not self._eager_mode

    @property
    def mode(self) -> str:
        """How requests run: ``"graphs"`` (one CUDA graph per padded shape),
        ``"eager"`` (the card, without graphs: a ring over several ranks),
        ``"cpu"``, or ``"opaque"`` (``model.predict``; also before set-up)."""
        if self._predictor_fn is None:
            return "opaque"
        if self._device.type != "cuda":
            return "cpu"
        return "eager" if self._eager_mode else "graphs"

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
                placed = _serving_attention(_place(_whole(model_object), self._device), self._mesh)
                if self._mesh is not None:
                    placed = _mesh_layout(placed, self._mesh, self._param_specs)
                cfg = _sequence_config(placed)
                if cfg is not None:  # served sequence-parallel (see _serving_attention)
                    from unionml_tpu_torch.models._layers import SequenceParallel
                    from unionml_tpu_torch.models.gpt import GPTLMHeadModel
                    from unionml_tpu_torch.parallel.mesh import SEQUENCE_AXIS

                    self._sequence = SequenceParallel.of(cfg.sp_mesh, SEQUENCE_AXIS)
                    self._per_position = isinstance(_serving_module(placed), GPTLMHeadModel)
                    self._eager_mode = cfg.attention_impl == "ring" and self._sequence.size > 1
                self._device_model_object = placed  # graftlint: disable=data-race -- published once under _setup_lock; readers run only after the _ready check, which happens-after this write
                self._predictor_fn = getattr(predictor, "fn", predictor)  # graftlint: disable=data-race -- published once under _setup_lock, as above
                if self._warmup:
                    self._warm()  # graftlint: disable=lock-order -- one-time init: racing first requests MUST wait for capture+warm before serving, so blocking under _setup_lock is the contract
            else:
                logger.info("Model object is not tensor-compatible; serving will run the predictor eagerly.")
            if self._lead is not None and self._lead.is_leader:
                self._keepalive = threading.Thread(target=self._keep_alive, name="resident-keepalive", daemon=True)
                self._keepalive.start()
            self._ready = True

    # ------------------------------------------------------------------ mesh

    def follow(self) -> int:
        """On a rank other than rank 0 of a meshed predictor: replay rank 0's
        predictions until it releases this rank (:meth:`close`); returns how
        many ran. Raises :class:`~unionml_tpu_torch.serving.lead.MeshDivergence`
        when a prediction raised on some ranks only, and the process group's
        error when rank 0 is gone (within the collective timeout)."""
        if self._lead is None or self._lead.is_leader:
            raise RuntimeError("follow() runs on the ranks that follow rank 0 of a meshed predictor")
        if not self._ready:
            self.setup()
        with self._serial:  # the lead's state is only ever touched under it
            return self._lead.follow(self)

    def close(self) -> None:
        """On rank 0 of a meshed predictor: stop the keep-alive and release
        the followers (their :meth:`follow` returns). A no-op otherwise."""
        self._closing.set()
        if self._keepalive is not None:
            self._keepalive.join(timeout=60)
        if self._lead is not None and self._lead.is_leader:
            with self._serial:
                self._lead.stop()

    def _keep_alive(self) -> None:
        """Rank 0's idle followers wait inside a collective: a no-op message
        every so often keeps that wait below the side group's timeout."""
        period = self._lead.keepalive_s / 2
        while not self._closing.wait(period):
            with self._serial:
                try:
                    self._lead.keep_alive()
                except Exception:  # a follower is gone, or the last call diverged: the next predict raises
                    logger.exception("meshed predictor keep-alive failed")
                    return

    def _split(self, padded: Any, bucket: int) -> Tuple[Any, bool]:
        """This rank's rows of a padded batch whose bucket the batch's ranks
        divide (``True``), else the whole batch (``False``)."""
        if self._batch_group is None or bucket % self._shards:
            return padded, False
        from unionml_tpu_torch.parallel.mesh import batch_index

        part, index = bucket // self._shards, batch_index(self._mesh)
        return _pytree.tree_map(lambda a: a[index * part:(index + 1) * part].contiguous(), padded), True

    def _gather(self, predictions: Any) -> Any:
        """The batch's ranks' rows of every tensor output, in batch order."""

        def gather(leaf: Any) -> Any:
            if not isinstance(leaf, torch.Tensor) or leaf.ndim < 1:
                return leaf
            pieces = [torch.empty_like(leaf) for _ in range(self._shards)]
            dist.all_gather(pieces, leaf.contiguous(), group=self._batch_group)
            return torch.cat(pieces if self._batch_order is None else [pieces[p] for p in self._batch_order])

        return _pytree.tree_map(gather, predictions)

    def _cut(self, local: Any) -> Tuple[Any, int]:
        """``(this rank's chunk of every sequence leaf, the chunk's length)``
        for a model served over a ``sequence`` axis (``(local, 0)`` for any
        other). Raises JAX's ``ValueError`` where the axis does not divide a
        padded sequence (a ladder it cannot divide)."""
        if self._sequence is None or not isinstance(local, dict):
            return local, 0
        n, index, chunk = self._sequence.size, self._sequence.index, 0

        def cut(leaf: Any) -> Any:
            nonlocal chunk
            if not isinstance(leaf, torch.Tensor) or not _is_sequence_leaf(leaf):
                return leaf
            if leaf.shape[1] % n:
                raise ValueError(
                    f"the padded sequence of shape {tuple(leaf.shape)} (seq_buckets {self._seq_buckets}) is not evenly "
                    f"divisible by the corresponding mesh axis sizes: the 'sequence' axis has {n} ranks, and "
                    f"{n} does not evenly divide {leaf.shape[1]}")
            chunk = leaf.shape[1] // n
            return leaf[:, index * chunk:(index + 1) * chunk].contiguous()

        return _pytree.tree_map(cut, local), chunk

    def _join(self, out: Any, chunk: int) -> Any:
        """A per-position model's outputs for this rank's chunk gathered over
        the ``sequence`` axis back into whole rows (dimension 1, in rank
        order); any other model's outputs are every rank's alike."""
        if not self._per_position or self._sequence.size == 1:
            return out

        def gather(leaf: Any) -> Any:
            if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2 or leaf.shape[1] != chunk:
                return leaf
            pieces = [torch.empty_like(leaf) for _ in range(self._sequence.size)]
            dist.all_gather(pieces, leaf.contiguous(), group=self._sequence.group)
            return torch.cat(pieces, dim=1)

        return _pytree.tree_map(gather, out)

    def _forward(self, padded: Any, bucket: int, eager: bool = False) -> Any:
        """The predictor on a padded bucket: this rank's rows of it (gathered
        back) where the batch's ranks divide it, else all of it; over a
        ``sequence`` axis, this rank's chunk of every row (a GPT's chunks
        gathered back). ``eager`` runs it without a graph."""
        local, split = self._split(padded, bucket)
        local, chunk = self._cut(local)
        out = self._eager(self._device_model_object, local) if eager else self._run(local)
        if chunk:
            out = self._join(out, chunk)
        return self._gather(out) if split else out

    def _warm(self) -> None:
        """Capture (or, on the CPU, run) the smallest bucket ahead of the first request."""
        try:
            example = self._example_processed(self._buckets[0])
            if example is None:
                logger.info("No warmup template (pass example_features to serve()); first request will capture.")
                return
            hard_sync(self._forward(example, self._buckets[0]))
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
            # a rank-2 FLOAT leaf is a flat feature matrix whose width must never be padded
            if self._seq_buckets is not None and _is_sequence_leaf(a) and is_multi_input:
                seq = a.shape[1]
                seq_bucket = _ladder_value(self._seq_buckets, seq)
                if seq_bucket != seq:
                    pad[1] = (0, seq_bucket - seq)
            elif self._sequence is not None and _is_sequence_leaf(a) and is_multi_input:
                # no ladder: the rows round up to a multiple of the sequence axis
                pad[1] = (0, -a.shape[1] % self._sequence.size)
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
        if self._device.type != "cuda" or self._eager_mode:
            if self._eager_mode:
                self.eager_requests += 1
            return self._eager(*call)
        graph = self._cache.lookup(_graphs.signature(call), self._eager, call, {})
        if graph is None:
            return self._eager(*call)
        return graph((call, {}))

    # ------------------------------------------------------------------ request path

    def predict(self, features: Any = None, **reader_kwargs) -> Any:
        """Request-path prediction: host numpy predictions of the request's rows.
        On rank 0 of a meshed predictor every rank computes it (a led call)."""
        if not self._ready:  # graftlint: disable=data-race -- benign double-checked fast path; setup() re-checks under _setup_lock before doing any work
            self.setup()
        if self._lead is None:
            return self._serve(features, **reader_kwargs)
        with self._serial:
            return self._serve(features, **reader_kwargs)

    def _serve(self, features: Any = None, **reader_kwargs) -> Any:
        """One prediction on this rank (rank 0's led call on a mesh; set up
        first, by :meth:`predict` or :meth:`follow`)."""
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
            predictions = self._forward(padded, bucket)
        except _graphs.CaptureError as exc:
            logger.info("Resident capture failed (%s); this shape is served eagerly.", exc)
            predictions = self._forward(padded, bucket, eager=True)
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


lead_calls(ResidentPredictor, ("_serve",))
