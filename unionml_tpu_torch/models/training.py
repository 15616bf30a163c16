"""Training loops for the port's classifiers and causal LMs: AdamW with optax's arithmetic.

Port of ``unionml_tpu/models/training.py`` for one device, run eagerly (no
``torch.compile``):

- :func:`create_train_state` — AdamW (b1 0.9, b2 0.999, eps 1e-8 added after
  the square root, decoupled weight decay on every parameter), global-norm
  clipping and a linear-warmup / cosine-decay schedule, written as plain
  torch (``torch._foreach_*``) with the arithmetic of ``optax.chain(
  clip_by_global_norm, adamw)`` (``training.py:56-75``). ``torch.optim.AdamW``
  is not used: it has no ``mu_dtype`` and ``clip_grad_norm_`` adds 1e-6.
- :func:`make_classifier_train_step` / :func:`make_classifier_eval_step` —
  the step functions ``(state, batch) -> (state, metrics)`` and ``(state,
  batch) -> metrics``. Metrics stay device tensors: a step never syncs with
  the host.
- :func:`make_lm_train_step` / :func:`make_lm_eval_step` — the causal-LM
  steps of ``training.py:217-311`` (packed rows carry ``segment_ids``);
  :func:`fit_lm` packs ragged sequences (or right-pads them one per row) and
  runs them through :func:`fit` (``training.py:524-603``).
- :func:`fit` — the loop of ``training.py:363-521``: the first step runs
  outside the timed window, the barrier is a host fetch of the loss; with
  ``checkpoint_dir`` it resumes from the latest step checkpoint, saves every
  step the interval admits and flushes at the end (``training.py:465-508``).
  ``prefetch=True`` feeds it from the native
  :class:`~unionml_tpu_torch.native.PrefetchLoader` (:func:`prefetched_batches`).

Unlike the JAX package, the train step updates the state IN PLACE (the
model's parameters and the moments) and returns the same object.
A sparse GPT's expert weights are parameters in the compute dtype (bf16 in
a bf16 config, as flax makes them): their AdamW moments follow each leaf's
dtype, as optax's do, and ``moe_aux=True`` adds the router losses
(:func:`~unionml_tpu_torch.models.moe.collect_aux_losses`) to the LM loss.

Sharded training (``mesh=``/``param_spec=``, ``training.py:113-214``) is SPMD
over ``torch.distributed``: every rank runs the same step on its rows of the
batch (``dict_batches(mesh=...)`` gives them, ragged tails wrapped onto
real rows) and on its shard of the state, and the collectives XLA inserts in
the JAX package are explicit (NCCL on the card, gloo on the CPU). The first
meshed step lays the state out (:func:`shard_train_state`) by the three axes:

- ``data`` (and ``param_spec=None``): parameters replicated; the gradients go
  through one bucketed all-reduce (a mean over the batch's ranks) before
  :meth:`TrainState.apply_gradients`. torch's ``DistributedDataParallel``
  does not fit: it reduces in ``.backward()`` hooks, and the step takes its
  gradients with ``torch.autograd.grad``;
- ``fsdp`` (a ``param_spec`` that names it): FSDP2, ``fully_shard`` on each
  encoder or decoder block and on the root, hybrid (replicated over
  ``data``) when the mesh has both. Each rank holds dimension 0's shard of
  every parameter and of ``mu`` and ``nu``; the step takes its gradients by
  ``loss.backward()`` (FSDP2 reduce-scatters them into each shard's
  ``.grad``; ``torch.autograd.grad`` cannot see through its parameters) and
  the AdamW update runs on each rank's local shard;
- ``tensor`` (the BERT or GPT ``param_shardings``): the Megatron split of
  the family's ``tensor_parallel``, differentiable; the gradients that are
  each rank's part of a sum (``tp_partial``) are summed over the axis.

- ``expert`` (a sparse GPT whose ``ep_mesh`` is the step's mesh,
  ``{"expert": N}`` or ``{"data": M, "expert": N}``): the ranks of one data
  index hold the same rows, as JAX's ``batch_sharding`` lays them, and each
  holds its ``1/N`` of every sparse block's experts (``w_in``/``w_out``
  split on their leading dimension). The sparse blocks exchange over the
  axis (``moe_dispatch="a2a"`` or ``"gshard"``, ``models/moe.py``); every
  leaf outside the experts takes the same gradient on every rank of the
  axis, and an expert leaf's gradient, whole on its own rank, is averaged
  over data×fsdp only. On any mesh the layout binds the batch's ranks to
  every sparse block (``MoEMlp.token_group``), so the blocks route over the
  global tokens: capacity, slots and the balance loss's means are the
  whole batch's, as in JAX's one program. Beside ``fsdp``, ``tensor`` or
  ``sequence`` (the ``ep_mesh`` laid out so too, ``param_spec`` the family's
  ``param_shardings``) the stacks take JAX's ``P(expert, fsdp, tensor)`` /
  ``P(expert, tensor, fsdp)``: under FSDP2 a rank's experts are sharded over
  ``fsdp`` (units of their own, gathered before use), under ``tensor`` each
  expert's hidden width is column/row split and the partial outputs are
  summed over expert×tensor; the expert leaves' gradients are averaged
  over data×fsdp×sequence like every other's.

- ``sequence`` (a BERT or GPT config with ``attention_impl="ring"`` or
  ``"ulysses"`` and ``sp_mesh`` the step's mesh; ``{"sequence": N}``, with
  ``data``, ``fsdp`` or ``tensor`` axes beside it or not): the ranks of one
  data×fsdp index hold the same rows, and the step cuts every token array
  to this rank's chunk of the sequence. An LM batch is cut after its targets are shifted on the
  whole row: the chunk's last position predicts the next chunk's first
  token, and the row's last position, which has no target, lies on the last
  chunk. The gradient group spans data×fsdp×sequence (each parameter's
  gradient is the sum of the chunks' partials, averaged over the batch's
  ranks, exactly once). Each rank differentiates its part of the global
  objective: an LM rank its chunk's mean cross-entropy over its own
  transitions, scaled by the ranks' number times its share of all their
  transitions (``Layout.weight_share``), so the mean over the ranks is the
  global batch's mean over its real transitions; a classifier rank its
  data shard's mean loss, which every sequence rank of that shard computes
  from the same broadcast ``[CLS]``: the mean over the sequence ranks
  counts it once, and the broadcast's backward sums the ranks' ``[CLS]``
  gradients onto the first chunk. Beside ``tensor`` the model is the
  Megatron copy and each chunk attends at the rank's heads; the ranks of
  one tensor group hold the same chunk and draw the same dropout masks.
  Beside ``fsdp`` FSDP2 runs hybrid, replicated over data×sequence
  (``parallel/mesh.py::fsdp_mesh``). Sparse blocks route the batch's chunks
  together in JAX's token order (``parallel/ep.py::_global_slots``). The eval steps take whole rows and cut them by
  the model's ``sp_mesh`` as the train step does; an LM eval's loss is the
  rows' mean over all their transitions (each chunk's mean weighted by its
  transitions, summed over the ``sequence`` axis).

Metrics are global-batch values, the same on every rank: the loss and
accuracy are means over the batch's ranks, and ``grad_norm`` is the norm of
the whole gradient (each shard's squares summed over the axes that split
it), which is also the norm clipping uses. A mesh whose axes each span one
rank exchanges nothing and computes bit for bit what the unmeshed step
does.
"""

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.models.gpt import lm_loss, lm_targets
from unionml_tpu_torch.models.moe import collect_aux_losses
from unionml_tpu_torch.ops.losses import cross_entropy_and_accuracy
from unionml_tpu_torch.ops.packing import pack_sequences, packing_efficiency

__all__ = [
    "FitResult",
    "Layout",
    "TrainState",
    "bert_flops_per_token",
    "classifier_grads",
    "create_train_state",
    "dict_batches",
    "dropout_generator",
    "fit",
    "fit_lm",
    "lm_grads",
    "make_classifier_eval_step",
    "make_classifier_train_step",
    "make_lm_eval_step",
    "make_lm_train_step",
    "prefetched_batches",
    "shard_train_state",
]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it: the float32
    0.999 is 1.3e-5 away from 0.999 in relative terms after ``1 - b2``."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


@dataclass(eq=False)
class TrainState:
    """A model, its AdamW moments and the step count.

    ``params`` are the model's parameters in ``model.named_parameters()``
    order (``names``); ``mu`` (in ``mu_dtype`` when given) and ``nu`` follow
    the same order. ``step`` counts applied updates, as optax's count does.
    """

    model: nn.Module = field(repr=False)
    names: List[str] = field(repr=False)
    params: List[torch.Tensor] = field(repr=False)
    mu: List[torch.Tensor] = field(repr=False)
    nu: List[torch.Tensor] = field(repr=False)
    learning_rate: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    max_grad_norm: float
    seed: int
    mu_dtype: Optional[torch.dtype] = None
    step: int = 0
    #: where the leaves lie on a mesh (:func:`shard_train_state`); None unmeshed
    layout: Optional["Layout"] = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def learning_rate_at(self, count: int) -> float:
        """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, max(total,
        warmup + 1))`` (end value 0) at ``count``, in float32 as optax
        evaluates it; the constant ``lr`` without warmup."""
        if self.warmup_steps <= 0:
            return self.learning_rate
        f32 = np.float32
        peak, warmup = f32(self.learning_rate), self.warmup_steps
        if count < warmup:
            frac = f32(1.0) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float((f32(0.0) - peak) * frac + peak)
        decay = f32(max(self.total_steps, warmup + 1) - warmup)
        t = min(f32(count - warmup), decay)
        return float(peak * (f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t / decay))))

    @torch.no_grad()
    def apply_gradients(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """One optimizer update in place; returns the global norm of ``grads``
        (before clipping) as a float32 device tensor.

        Each leaf's norm is taken in float32. optax sums a bf16 leaf's squares
        in bf16 (``optax.global_norm``), so with bf16 leaves (a sparse
        model's experts in a bf16 config) the two norms differ by the
        rounding of those leaves' sums (about 2^-8 of their share); f32
        leaves agree to rounding. On a mesh that splits the parameters the
        norm is the whole gradient's (:meth:`Layout.global_norm`), and the
        update runs on this rank's shards.

        optax's arithmetic: ``g if norm < max else g / norm * max`` (here
        ``g / denom * max`` with ``denom = max`` below the threshold: exact for
        the default max 1.0, within an ulp otherwise); adam moments
        ``(1-b)*g^k + b*m``, bias correction (in float32) at the incremented count,
        ``mu_hat / (sqrt(nu_hat) + eps)``, plus ``weight_decay * p``, times
        ``-lr`` at the pre-increment count, added to the parameters.
        """
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        if self.layout is not None and self.layout.exchanges_norm:
            norm = self.layout.global_norm(norms)
        else:
            norm = torch.linalg.vector_norm(torch.stack(norms))
        denom = torch.where(norm < self.max_grad_norm, torch.full_like(norm, self.max_grad_norm), norm)
        clipped = torch._foreach_div(grads, denom)
        torch._foreach_mul_(clipped, self.max_grad_norm)

        if self.mu_dtype is not None:
            # optax's weak-typed ``b1 * mu`` runs in mu_dtype, b1 rounded to
            # it first (0.8984375 in bf16); the sum with the f32 gradient term is f32
            b1 = float(torch.tensor(_B1, dtype=self.mu_dtype))
            mu = [m.float() for m in torch._foreach_mul(self.mu, b1)]
        else:
            mu = self.mu
            torch._foreach_mul_(mu, _B1)
        torch._foreach_add_(mu, clipped, alpha=1.0 - _B1)
        torch._foreach_mul_(self.nu, _B2)
        torch._foreach_addcmul_(self.nu, clipped, clipped, value=1.0 - _B2)
        count = self.step + 1
        updates = torch._foreach_div(mu, _bias_correction(_B1, count))
        denoms = torch._foreach_div(self.nu, _bias_correction(_B2, count))
        torch._foreach_sqrt_(denoms)
        torch._foreach_add_(denoms, _EPS)
        torch._foreach_div_(updates, denoms)
        torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(updates, -self.learning_rate_at(self.step))
        torch._foreach_add_(self.params, updates)
        if self.mu_dtype is not None:
            for stored, value in zip(self.mu, mu):
                stored.copy_(value)
        self.step = count
        return norm


def create_train_state(
    model: nn.Module,
    learning_rate: float = 2e-5,
    weight_decay: float = 0.01,
    warmup_steps: int = 0,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
    seed: int = 0,
    mu_dtype: Optional[torch.dtype] = None,
) -> TrainState:
    """AdamW + linear warmup / cosine decay + global-norm clipping (the BERT
    fine-tune recipe) over ``model``'s parameters.

    ``mu_dtype`` (e.g. ``torch.bfloat16``) stores adam's first moment in
    reduced precision; the second moment stays in the parameters' dtype.
    ``seed`` seeds the per-step dropout generators.
    """
    names, params = zip(*model.named_parameters())
    return TrainState(
        model=model,
        names=list(names),
        params=list(params),
        mu=[torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params],
        nu=[torch.zeros_like(p) for p in params],
        learning_rate=learning_rate,
        weight_decay=weight_decay,
        warmup_steps=warmup_steps,
        total_steps=total_steps,
        max_grad_norm=max_grad_norm,
        seed=seed,
        mu_dtype=mu_dtype,
    )


def _family(model: nn.Module):
    """``(tensor_parallel, param_shardings, blocks)`` of a model family the
    port splits over a tensor axis (BERT, GPT), else None."""
    from unionml_tpu_torch.models import bert, gpt

    if isinstance(model, bert.BertForSequenceClassification):
        return bert.tensor_parallel, bert.param_shardings, list(model.bert.encoder.layers)
    if isinstance(model, gpt.GPTLMHeadModel):
        return gpt.tensor_parallel, gpt.param_shardings, list(model.layers)
    return None


def _gather_over(local: torch.Tensor, dim: int, parts: int, group: Any, size: int) -> torch.Tensor:
    """The inverse of ``NamedSharding.shard`` along ``dim`` over one axis:
    the ranks' shards gathered in rank order, part by part."""
    pieces = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(pieces, local.contiguous(), group=group)
    chunks = [piece.chunk(parts, dim) for piece in pieces]
    return torch.cat([c[j] for j in range(parts) for c in chunks], dim)


@dataclass(eq=False)
class Layout:
    """Where a :class:`TrainState`'s leaves lie on a mesh (:func:`shard_train_state`).

    Per parameter, in ``names`` order: its spec over the ``tensor`` axis (the
    Megatron split; ``fsdp`` entries dropped), the module's parameter
    (a ``DTensor`` under FSDP2), and whether its gradient is each rank's
    part of a sum over the tensor axis. ``fsdp``: FSDP2 holds dimension 0's
    shard of every parameter (of its tensor shard) on this rank."""

    mesh: Any
    specs: List[Any]
    module_params: List[nn.Parameter]
    partial: List[bool]
    fsdp: bool
    #: the unsplit module the layout was cut from (:meth:`whole_model`)
    source: nn.Module = field(repr=False)
    names: List[str] = field(repr=False)

    def __post_init__(self) -> None:
        from unionml_tpu_torch.parallel.mesh import (
            EXPERT_AXIS, FSDP_AXIS, TENSOR_AXIS, axis_group, axis_size, batch_axis_size, batch_group, batch_index,
        )

        self.tensor_group = axis_group(self.mesh, TENSOR_AXIS)
        self.tensor_size = axis_size(self.mesh, TENSOR_AXIS)
        self.expert_group = axis_group(self.mesh, EXPERT_AXIS)
        self.expert_size = axis_size(self.mesh, EXPERT_AXIS)
        self.fsdp_group = axis_group(self.mesh, FSDP_AXIS) if self.fsdp else None
        # the ranks whose gradients and loss weights are summed: data×fsdp
        # (the rows) × sequence (the chunks of each row)
        self.batch_group = batch_group(self.mesh, sequence=True)
        self.batch_size = batch_axis_size(self.mesh, sequence=True)
        #: the dropout generator's shard word (None where the batch spans one
        #: rank); chunks of one row draw distinct masks
        self.dropout_shard = batch_index(self.mesh, sequence=True) if self.batch_size > 1 else None
        self.tensor_split = [self.tensor_group is not None and TENSOR_AXIS in tuple(spec) for spec in self.specs]
        #: the leaves whose leading dimension is split over ``expert`` (each
        #: rank holds its experts of a sparse block)
        self.expert_split = [self.expert_group is not None and EXPERT_AXIS in tuple(spec) for spec in self.specs]
        #: whether the global norm needs an exchange (else the unmeshed formula)
        self.exchanges_norm = self.fsdp_group is not None or any(self.tensor_split) or any(self.expert_split)

    def take_shard_grads(self) -> List[torch.Tensor]:
        """This rank's gradient shards after FSDP2's backward (zeros for a
        parameter that took none); the parameters' ``.grad`` are cleared."""
        grads = []
        for param in self.module_params:
            grad = param.grad
            local = param.to_local() if hasattr(param, "to_local") else param
            grads.append(torch.zeros_like(local) if grad is None else
                         (grad.to_local() if hasattr(grad, "to_local") else grad))
            param.grad = None
        return grads

    @torch.no_grad()
    def reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """In place: the partial gradients summed over the tensor axis, then
        (without FSDP2, which reduces its own) every gradient's mean over the
        batch's ranks (data×fsdp×sequence), one all-reduce per dtype."""
        if self.tensor_group is not None:
            partial = [g for g, p in zip(grads, self.partial) if p]
            if partial:
                _all_reduce_flat(partial, self.tensor_group, 1)
        if not self.fsdp and self.batch_group is not None:
            _all_reduce_flat(grads, self.batch_group, self.batch_size)

    def weight_share(self, weight: torch.Tensor) -> torch.Tensor:
        """The batch's ranks times this rank's share of their summed ``weight``."""
        weight = weight.detach().float()
        total = weight.clone()
        dist.all_reduce(total, group=self.batch_group)
        return self.batch_size * weight / torch.clamp(total, min=1e-8)

    def batch_mean(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each metric's mean over the batch's ranks (as they are on one rank)."""
        if self.batch_group is None:
            return values
        stacked = torch.stack([v.float() for v in values])
        dist.all_reduce(stacked, group=self.batch_group)
        stacked = stacked / self.batch_size
        return [stacked[i].to(v.dtype) for i, v in enumerate(values)]

    def global_norm(self, norms: List[torch.Tensor]) -> torch.Tensor:
        """The whole gradient's norm from each local leaf's: the squares of
        FSDP2 shards summed over ``fsdp``, those of tensor shards over
        ``tensor`` and of expert shards over ``expert`` (an expert stack
        split over both, over both), each replicated leaf counted once."""
        squares = torch.stack(norms) ** 2
        split = torch.tensor(self.tensor_split, device=squares.device)
        experts = torch.tensor(self.expert_split, device=squares.device)
        sums = torch.stack([squares[split & ~experts].sum(), squares[experts & ~split].sum(),
                            squares[split & experts].sum(), squares[~split & ~experts].sum()])
        if self.fsdp_group is not None:
            dist.all_reduce(sums, group=self.fsdp_group)
        parts = list(sums.unbind())
        for i, groups in ((0, (self.tensor_group,)), (1, (self.expert_group,)),
                          (2, (self.tensor_group, self.expert_group))):
            for group in groups:
                if group is not None:
                    part = parts[i].clone()
                    dist.all_reduce(part, group=group)
                    parts[i] = part
        return torch.sqrt(torch.stack(parts).sum())

    @torch.no_grad()
    def gather(self, index: int, local: torch.Tensor, experts: bool = True) -> torch.Tensor:
        """The whole leaf of parameter ``index`` (its value, or a moment)
        from this rank's shard: a collective every rank joins. ``experts=False``
        leaves an expert stack with this rank's experts (gathered over the
        other axes only)."""
        full = local
        if self.fsdp:
            from torch.distributed.tensor import DTensor

            param = self.module_params[index]
            full = DTensor.from_local(local, param.device_mesh, param.placements, run_check=False,
                                      shape=param.shape, stride=param.stride()).full_tensor()
        spec = self.specs[index]
        if self.tensor_split[index]:
            dim = tuple(spec).index("tensor")
            full = _gather_over(full, dim, spec.parts, self.tensor_group, self.tensor_size)
        if self.expert_split[index] and experts:
            full = _gather_over(full, 0, 1, self.expert_group, self.expert_size)
        return full

    @torch.no_grad()
    def whole_model(self, params: List[torch.Tensor]) -> nn.Module:
        """The unsplit module with every parameter set to its whole value
        gathered from ``params`` (this rank's shards): a collective. A model
        whose sparse blocks hold a share of the experts keeps this rank's
        share (``ep_mesh``'s, its stacks gathered over fsdp and tensor),
        which the engines serve over that mesh."""
        whole = dict(self.source.named_parameters())
        for i, (name, local) in enumerate(zip(self.names, params)):
            value = self.gather(i, local, experts=False)
            if whole[name] is not local:
                whole[name].copy_(value)
        return self.source

    @torch.no_grad()
    def shard(self, index: int, full: torch.Tensor, held: bool = False) -> torch.Tensor:
        """This rank's shard of a whole leaf of parameter ``index`` (no
        collective); ``held``: of an expert stack that holds this rank's
        experts already (cut over the other axes only)."""
        from unionml_tpu_torch.parallel.mesh import FSDP_AXIS, NamedSharding, Spec, axis_index, axis_size

        spec = self.specs[index]
        if held:
            spec = Spec(None, *tuple(spec)[1:], parts=spec.parts)
        local = NamedSharding(self.mesh, spec).shard(full)
        if self.fsdp:
            ways, at = axis_size(self.mesh, FSDP_AXIS), axis_index(self.mesh, FSDP_AXIS)
            chunks = torch.chunk(local, ways, dim=0)
            local = chunks[at] if at < len(chunks) else local[:0]
        return local


def _all_reduce_flat(tensors: List[torch.Tensor], group: Any, divide: int) -> None:
    """Sum ``tensors`` over ``group`` in place through one flat buffer per
    dtype (a bucketed all-reduce), then divide by ``divide``."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for bucket in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        if divide > 1:
            flat.div_(divide)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def shard_train_state(state: TrainState, mesh: Any, param_spec: Any = None) -> TrainState:
    """A :class:`TrainState` laid out on ``mesh`` from ``state`` (which every
    rank holds whole, as built from the same seed or checkpoint; it is left
    as it is), per ``param_spec``: a :class:`~unionml_tpu_torch.parallel.mesh.Spec`
    per parameter name, as the family's ``param_shardings`` gives it, or
    None to replicate every parameter (the data-parallel default,
    ``training.py:195-214``).

    A spec that names ``tensor`` is the Megatron split of a BERT or GPT
    model (the family's ``tensor_parallel``, the only layout its forward
    computes); any other spec over a tensor axis of more than one rank, or
    a tensor spec for another model, raises ``ValueError``. A spec that
    names ``fsdp`` (with the mesh's ``fsdp`` axis) puts the model under
    FSDP2 (``models/_sharding.py``). The expert stacks of a model whose
    ``ep_mesh`` splits them are laid out over ``expert`` whatever
    ``param_spec`` says (the model holds only its rank's experts already).
    ``mu`` and ``nu`` are cut like their parameters; the step count and
    hyperparameters carry over.

    The laid-out state's model is a copy under a tensor or fsdp split, and
    ``state.model`` itself when every parameter is replicated (its
    parameters then train in place, as an unmeshed step's do). Its sparse
    blocks are bound to the mesh's batch ranks (``MoEMlp.token_group``,
    data×fsdp×sequence): from then on their capacity-bounded forwards route
    over the global batch, and a dropless (inference) forward exchanges
    nothing. A sequence-parallel model is laid out over ``tensor`` and
    ``fsdp`` as any other; its copy keeps the config and ``sp_mesh``."""
    from unionml_tpu_torch.models._layers import shared_configs
    from unionml_tpu_torch.models._sharding import _without_fsdp, fully_shard_model, names_axis
    from unionml_tpu_torch.models.moe import MoEMlp
    from unionml_tpu_torch.parallel.ep import batch_ranks
    from unionml_tpu_torch.parallel.mesh import EXPERT_AXIS, FSDP_AXIS, TENSOR_AXIS, Spec, axis_names, axis_size

    if state.layout is not None:
        raise ValueError("this state is laid out on a mesh already")
    names = axis_names(mesh)
    model = state.model
    family = _family(model)
    experts = _expert_leaves(model)
    if param_spec is not None:
        missing = set(state.names) ^ set(param_spec)
        if missing:
            raise ValueError(f"param_spec does not match the state's parameters: {sorted(missing)}")
    tensor = param_spec is not None and TENSOR_AXIS in names and names_axis(param_spec, TENSOR_AXIS)
    fsdp = param_spec is not None and FSDP_AXIS in names and names_axis(param_spec, FSDP_AXIS)
    partial = frozenset()
    if tensor:
        if family is None:
            raise ValueError(f"a tensor-parallel param_spec needs a model the port splits over the tensor axis "
                             f"(BERT or GPT); {type(model).__name__} computes only whole")
        tensor_parallel, param_shardings, _ = family
        wanted = param_shardings(dict(model.named_parameters()), names)
        off = [n for n in state.names if tuple(wanted[n]) != tuple(param_spec[n])]
        if off:
            raise ValueError(f"the port's tensor-parallel forward computes the Megatron split of "
                             f"param_shardings only; param_spec differs at {off[:4]}")
        model, _ = tensor_parallel(model, mesh, trainable=True)
        # the split the copy was cut by (column-parallel biases with their outputs)
        partial, specs = model.tp_partial, [model.tp_specs[n] for n in state.names]
    else:
        specs = [Spec() for _ in state.names]
    if experts:  # each rank holds its experts of every sparse block: their stacks split over "expert"
        specs = [Spec(EXPERT_AXIS, *tuple(spec)[1:]) if n in experts else spec for n, spec in zip(state.names, specs)]
    if fsdp:
        if not tensor:  # parameters of its own for FSDP2 to shard; the configs (and their meshes) shared
            model = copy.deepcopy(model, memo=shared_configs(model))
        fully_shard_model(model, mesh, _family(model)[2] if family is not None else [])
    module_params = [dict(model.named_parameters())[n] for n in state.names]
    token_group = batch_ranks(mesh, sequence=True)
    for module in model.modules():
        if isinstance(module, MoEMlp):
            module.token_group = token_group
    layout = Layout(mesh=mesh, specs=[_without_fsdp(s) for s in specs], module_params=module_params,
                    partial=[n in partial for n in state.names], fsdp=fsdp, source=state.model,
                    names=list(state.names))
    with torch.no_grad():
        params = [p.to_local() if hasattr(p, "to_local") else p for p in module_params]
        # an expert stack's moments hold this rank's experts already, as its parameter does
        mu = [layout.shard(i, m, held=layout.expert_split[i]).clone() for i, m in enumerate(state.mu)]
        nu = [layout.shard(i, v, held=layout.expert_split[i]).clone() for i, v in enumerate(state.nu)]
    for p, m in zip(params, mu):
        if p.shape != m.shape:
            raise AssertionError(f"a moment's shard {tuple(m.shape)} does not match its parameter's {tuple(p.shape)}")
    return TrainState(
        model=model, names=list(state.names), params=params, mu=mu, nu=nu, learning_rate=state.learning_rate,
        weight_decay=state.weight_decay, warmup_steps=state.warmup_steps, total_steps=state.total_steps,
        max_grad_norm=state.max_grad_norm, seed=state.seed, mu_dtype=state.mu_dtype, step=state.step,
        layout=layout,
    )


def _expert_leaves(model: nn.Module) -> frozenset:
    """The names of ``model``'s expert stacks that hold a share of their
    sparse block's experts (an ``ep_mesh`` over more than one rank)."""
    from unionml_tpu_torch.models.moe import MoEMlp

    return frozenset(f"{name}.{leaf}" for name, module in model.named_modules()
                     if isinstance(module, MoEMlp) and module.experts.size > 1 for leaf in ("w_in", "w_out"))


def _check_experts(model: nn.Module, mesh: Any) -> None:
    """A model whose sparse blocks hold a share of the experts trains on a
    mesh laid out as its ``ep_mesh`` (the step's rows and the experts'
    exchanges must agree), fsdp, tensor or sequence axes beside ``expert``
    included. Sparse blocks with whole experts train on any mesh (under
    sequence parallelism they route the chunks together)."""
    from unionml_tpu_torch.parallel.mesh import EXPERT_AXIS, axis_names, axis_size

    cfg = getattr(model, "config", None)
    if getattr(cfg, "moe_every", 0) <= 0:
        return
    ep_mesh = getattr(cfg, "ep_mesh", None)
    if axis_size(ep_mesh, EXPERT_AXIS) == 1:
        return
    layout = [(a, axis_size(ep_mesh, a)) for a in axis_names(ep_mesh)]
    if mesh is None or [(a, axis_size(mesh, a)) for a in axis_names(mesh)] != layout:
        raise ValueError(f"this model's experts are split over its ep_mesh {dict(layout)}: train it on that "
                         "mesh (mesh=config.ep_mesh)")


#: the word that marks a batch shard's index in a dropout seed
_SHARD_WORD = 0x5EED


def dropout_generator(seed: int, step: int, device: torch.device, index: Optional[int] = None,
                      shard: Optional[int] = None) -> torch.Generator:
    """The dropout generator of one step (and microbatch ``index``): seeded
    from ``(seed, step[, index])``, the counterpart of the JAX step's
    ``fold_in(dropout_rng, step)`` (``training.py:136``).

    ``shard`` is this rank's index over the batch's ranks (data×fsdp×sequence)
    on a mesh where they are more than one: ranks with different rows, or
    different chunks of one row, draw distinct masks, and the ranks of one
    tensor group, which share an index and hold the same replicated
    activations at every dropout site, draw identical ones. Where the batch spans one rank ``shard`` is None and the
    generator is the unmeshed step's."""
    words = [seed, step] if index is None else [seed, step, index]
    if shard is not None:
        words += [_SHARD_WORD, shard]
    generator = torch.Generator(device=device)
    generator.manual_seed(int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return generator


def _sequence_config(model: nn.Module) -> Any:
    """The config of a BERT or GPT model that splits rows over a ``sequence``
    axis (``attention_impl`` ring or ulysses), else None."""
    from unionml_tpu_torch.models._layers import SEQUENCE_IMPLS

    if _family(model) is None:
        return None
    return model.config if model.config.attention_impl in SEQUENCE_IMPLS else None


def _check_sequence(model: nn.Module, mesh: Any) -> None:
    """A sequence-parallel config trains on a mesh whose ``sequence`` axis is
    its ``sp_mesh``'s (the step cuts the rows by it, the attention exchanges
    over it; ``data``, ``fsdp`` and ``tensor`` axes may lie beside it); a
    mesh that splits the sequence needs such a config."""
    from unionml_tpu_torch.parallel.mesh import SEQUENCE_AXIS, axis_names, sequence_size

    cfg = _sequence_config(model)
    names = axis_names(mesh) if mesh is not None else ()
    if cfg is None:
        if sequence_size(mesh) > 1:
            raise ValueError(f"a mesh whose {SEQUENCE_AXIS!r} axis spans {sequence_size(mesh)} ranks splits every "
                             "row: train a BERT or GPT config with attention_impl='ring' or 'ulysses' on it")
        return
    if SEQUENCE_AXIS not in names or sequence_size(cfg.sp_mesh) != sequence_size(mesh):
        raise ValueError(f"attention_impl={cfg.attention_impl!r} trains on a mesh with a {SEQUENCE_AXIS!r} axis the "
                         f"size of sp_mesh's ({sequence_size(cfg.sp_mesh)}): pass mesh=config.sp_mesh to the step")


def _sequence_span(model: nn.Module, seq: int) -> Optional[Tuple[int, int]]:
    """``(start, length)`` of this rank's chunk of a row of ``seq`` tokens,
    cut by the model's ``sp_mesh``; None for a model that takes whole rows."""
    from unionml_tpu_torch.parallel.mesh import sequence_index, sequence_size

    cfg = _sequence_config(model)
    if cfg is None:
        return None
    n = sequence_size(cfg.sp_mesh)
    if seq % n:
        raise ValueError(f"the sequence axis ({n} ranks) must divide the rows' length ({seq})")
    return sequence_index(cfg.sp_mesh) * (seq // n), seq // n


def _sequence_inputs(model: nn.Module, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
    """This rank's chunk of each token array for a sequence-parallel model
    (cut by its ``sp_mesh``); the arrays as they are for any other."""
    from unionml_tpu_torch.parallel.mesh import shard_sequence

    cfg = _sequence_config(model)
    return inputs if cfg is None or cfg.sp_mesh is None else shard_sequence(inputs, cfg.sp_mesh)


def _microbatch_grads(
    state: TrainState, batch: Dict[str, torch.Tensor], grad_accum: int, loss_fn: Callable,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``(grads, values)`` of one step, dropout on: ``loss_fn(microbatch,
    generator)`` returns the loss to differentiate first, then any metrics.

    With ``grad_accum > 1`` the batch splits into equal sequential
    microbatches (each with its own dropout generator), whose gradients and
    values are summed and divided by ``grad_accum``: the mean of means of
    ``_accumulated_value_and_grad`` (``training.py:78-109``).

    On a mesh the loss is this rank's part of the mean over the batch's
    ranks that follows (an LM loss scales itself, :func:`lm_grads`).
    """
    rows = len(next(iter(batch.values())))
    if rows % grad_accum:
        raise ValueError(f"grad_accum={grad_accum} must divide the batch size ({rows})")
    layout = state.layout
    shard = layout.dropout_shard if layout is not None else None
    backward = layout is not None and layout.fsdp
    size = rows // grad_accum
    total = sums = None
    for index in range(grad_accum):
        micro = batch if grad_accum == 1 else {k: v[index * size:(index + 1) * size] for k, v in batch.items()}
        generator = dropout_generator(state.seed, state.step, state.device, None if grad_accum == 1 else index,
                                      shard=shard)
        loss, *extras = loss_fn(micro, generator)
        values = [loss.detach(), *extras]
        if backward:
            # FSDP2 reduce-scatters each backward into (and adds to) the shards' .grad
            loss.backward()
            grads = None
        elif layout is None:
            grads = list(torch.autograd.grad(loss, state.params))
        else:
            # a row-parallel bias takes no gradient on the tensor ranks that do not add it
            grads = [torch.zeros_like(p) if g is None else g for p, g in
                     zip(state.params, torch.autograd.grad(loss, state.params, allow_unused=True))]
        if sums is None:
            total, sums = grads, values
        else:
            if grads is not None:
                torch._foreach_add_(total, grads)
            sums = [a + b for a, b in zip(sums, values)]
    if backward:
        total = layout.take_shard_grads()
    if grad_accum > 1:
        torch._foreach_div_(total, grad_accum)
        sums = [v / grad_accum for v in sums]
    if layout is not None:
        layout.reduce_grads(total)
        sums = layout.batch_mean(sums)
    return total, sums


def classifier_grads(
    state: TrainState, batch: Dict[str, torch.Tensor], input_signature: Tuple[str, ...], grad_accum: int = 1
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """``(grads, loss, accuracy)`` of one classifier train step, dropout on,
    over ``grad_accum`` microbatches (see :func:`_microbatch_grads`)."""

    def loss_fn(micro, generator):
        inputs = _sequence_inputs(state.model, [micro[k] for k in input_signature])
        logits = state.model(*inputs, deterministic=False, generator=generator)
        return cross_entropy_and_accuracy(logits, micro["labels"])

    grads, (loss, acc) = _microbatch_grads(state, batch, grad_accum, loss_fn)
    return grads, loss, acc


def _lm_loss(model: nn.Module, batch: Dict[str, torch.Tensor], packed: bool, moe_aux: bool = False,
             **kwargs) -> torch.Tensor:
    """``lm_loss`` of ``model`` on an LM batch: ``input_ids``, ``segment_ids``
    (looked up strictly) when packed, and an optional ``mask``; with
    ``moe_aux`` plus the sparse blocks' router losses (``training.py:239-260``).
    A sequence-parallel model sees this rank's chunk of the rows and the loss
    is its chunk's mean over its own transitions (:func:`_sequence_span`)."""
    loss, aux = _lm_terms(model, batch, packed, moe_aux, **kwargs)
    return loss if aux is None else aux + loss


def _lm_terms(model: nn.Module, batch: Dict[str, torch.Tensor], packed: bool, moe_aux: bool = False,
              **kwargs) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(lm_loss, router losses or None)`` of :func:`_lm_loss`."""
    # strict lookup: a packed step fed a batch without segment ids must fail,
    # not silently train across packed-sequence boundaries (training.py:250-252)
    segment_ids = batch["segment_ids"] if packed else None
    ids = batch["input_ids"]
    span = _sequence_span(model, ids.shape[1])
    chunk_ids, chunk_segments = ids, segment_ids
    if span is not None:  # this rank's chunk of the rows
        cut = slice(span[0], span[0] + span[1])
        chunk_ids = ids[:, cut]
        chunk_segments = None if segment_ids is None else segment_ids[:, cut]
    if moe_aux:
        logits, aux = model(chunk_ids, segment_ids=chunk_segments, return_aux=True, **kwargs)
    else:
        logits, aux = model(chunk_ids, segment_ids=chunk_segments, **kwargs), None
    loss = lm_loss(logits, ids, mask=batch.get("mask"), segment_ids=segment_ids, span=span)
    return loss, None if aux is None else collect_aux_losses(aux).to(loss.device)


def lm_grads(
    state: TrainState, batch: Dict[str, torch.Tensor], packed: bool = False, grad_accum: int = 1,
    moe_aux: bool = False,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(grads, loss)`` of one causal-LM train step, dropout (and router
    jitter) on, over ``grad_accum`` microbatches (each weighted equally, as
    in JAX); ``moe_aux`` folds the router losses into the loss.

    On a mesh whose batch spans several ranks the LM loss (a mean over this
    rank's real transitions) is scaled by the rank's share of the ranks'
    total transitions (times their number), so the mean over the ranks is
    the global batch's weighted mean, as XLA computes it over the whole
    batch. The router losses are not scaled: their values are the global
    batch's on every rank already (the balance loss's means are taken over
    the step's token group) or means over equal shares (the z-loss)."""
    layout = state.layout

    def loss_fn(micro, generator):
        loss, aux = _lm_terms(state.model, micro, packed, moe_aux, deterministic=False, generator=generator)
        if layout is not None and layout.batch_group is not None:
            loss = loss * layout.weight_share(_lm_weight(state.model, micro, packed))
        return (loss if aux is None else aux + loss,)

    grads, (loss,) = _microbatch_grads(state, batch, grad_accum, loss_fn)
    return grads, loss


def _lm_weight(model: nn.Module, batch: Dict[str, torch.Tensor], packed: bool) -> torch.Tensor:
    """The weight :func:`lm_loss` averages over: the batch's real next-token
    transitions (within one segment when packed, under the mask if any),
    those from this rank's chunk for a sequence-parallel model."""
    targets, weights = lm_targets(batch["input_ids"], batch.get("mask"), batch["segment_ids"] if packed else None,
                                  _sequence_span(model, batch["input_ids"].shape[1]))
    return torch.ones_like(targets, dtype=torch.float32).sum() if weights is None else weights.sum()


def make_classifier_train_step(
    mesh: Any = None,
    param_spec: Any = None,
    input_signature: Tuple[str, ...] = ("inputs",),
    light_metrics: bool = False,
    grad_accum: int = 1,
) -> Callable:
    """The train step ``(state, batch) -> (state, metrics)``.

    ``batch`` is a dict of device tensors with the ``input_signature`` keys
    and ``"labels"``. Metrics: ``loss``, ``accuracy`` and, unless
    ``light_metrics``, ``grad_norm`` (before clipping), all device tensors.
    ``grad_accum=N`` splits each batch into N sequential microbatches whose
    gradients average before the one optimizer step.

    With a ``mesh`` the step is sharded (see the module docstring): ``batch``
    holds this rank's rows (``dict_batches(mesh=...)`` or
    :func:`~unionml_tpu_torch.parallel.mesh.shard_batch`), the first call
    lays the state out by ``param_spec`` (:func:`shard_train_state`;
    replicated when None) and returns the laid-out state, and ``grad_accum``
    splits this rank's rows.
    """
    _check_options(mesh, param_spec, grad_accum)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state = _on_mesh(state, mesh, param_spec)
        grads, loss, acc = classifier_grads(state, batch, input_signature, grad_accum)
        norm = state.apply_gradients(grads)
        metrics = {"loss": loss, "accuracy": acc}
        if not light_metrics:
            metrics["grad_norm"] = norm
        return state, metrics

    return train_step


def make_classifier_eval_step(input_signature: Tuple[str, ...] = ("inputs",)) -> Callable:
    """The eval step ``(state, batch) -> {"loss", "accuracy"}``, dropout off.
    A sequence-parallel model takes this rank's chunk of each token array
    (cut by its ``sp_mesh``); every rank of the axis calls the step together
    and gets the whole rows' metrics (``[CLS]`` is broadcast)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        logits = state.model(*_sequence_inputs(state.model, [batch[k] for k in input_signature]), deterministic=True)
        loss, acc = cross_entropy_and_accuracy(logits, batch["labels"])
        return {"loss": loss, "accuracy": acc}

    return eval_step


def _check_options(mesh, param_spec, grad_accum: int) -> None:
    if param_spec is not None and mesh is None:
        raise ValueError("param_spec lays the state out on a mesh: pass the mesh too")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")


def _on_mesh(state: TrainState, mesh: Any, param_spec: Any) -> TrainState:
    """``state`` laid out on ``mesh`` (on the first meshed step); an unmeshed
    step takes it as it is."""
    if mesh is None:
        if state.layout is not None:
            raise ValueError("this state is laid out on a mesh: step it with a meshed step")
        _check_sequence(state.model, None)
        _check_experts(state.model, None)
        return state
    if state.layout is None:
        _check_sequence(state.model, mesh)
        _check_experts(state.model, mesh)
        return shard_train_state(state, mesh, param_spec)
    if state.layout.mesh is not mesh:
        raise ValueError("this state is laid out on another mesh")
    return state


def make_lm_train_step(
    packed: bool = False,
    light_metrics: bool = False,
    grad_accum: int = 1,
    moe_aux: bool = False,
    mesh: Any = None,
    param_spec: Any = None,
) -> Callable:
    """The causal-LM train step ``(state, batch) -> (state, metrics)``
    (``training.py:217-288``).

    ``batch`` carries ``"input_ids"`` plus, with ``packed=True``, the
    ``"segment_ids"`` of :func:`~unionml_tpu_torch.ops.packing.pack_sequences`;
    unpacked batches may carry a ``"mask"`` (1 = real token). Metrics:
    ``loss`` and, unless ``light_metrics``, ``grad_norm`` (before clipping),
    device tensors. ``grad_accum=N`` averages N sequential microbatches.
    ``moe_aux=True`` (sparse decoders) adds the router z-loss and
    load-balancing loss to the objective; the router jitter draws from the
    step's dropout generator. The reported ``loss`` includes them, as JAX's.
    ``mesh``/``param_spec`` shard the step as
    :func:`make_classifier_train_step` does.
    """
    _check_options(mesh, param_spec, grad_accum)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state = _on_mesh(state, mesh, param_spec)
        grads, loss = lm_grads(state, batch, packed, grad_accum, moe_aux)
        norm = state.apply_gradients(grads)
        metrics = {"loss": loss}
        if not light_metrics:
            metrics["grad_norm"] = norm
        return state, metrics

    return train_step


def make_lm_eval_step(packed: bool = False) -> Callable:
    """The causal-LM eval step ``(state, batch) -> {"loss", "perplexity"}``,
    dropout off (``training.py:291-311``): the masked mean next-token
    cross-entropy over the batch's real transitions and its exp. A
    sequence-parallel model takes this rank's chunk of the rows (cut by its
    ``sp_mesh``); every rank of the axis calls the step together and gets
    the whole rows' loss: each chunk's mean weighted by its transitions,
    summed over the axis."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        from unionml_tpu_torch.parallel.mesh import SEQUENCE_AXIS, axis_group

        loss = _lm_loss(state.model, batch, packed, deterministic=True)
        cfg = _sequence_config(state.model)
        group = None if cfg is None or cfg.sp_mesh is None else axis_group(cfg.sp_mesh, SEQUENCE_AXIS)
        if group is not None:
            weight = _lm_weight(state.model, batch, packed)
            sums = torch.stack([loss * weight, weight])
            dist.all_reduce(sums, group=group)
            loss = sums[0] / torch.clamp(sums[1], min=1e-8)
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return eval_step


@dataclass
class FitResult:
    state: TrainState
    metrics_history: list = field(default_factory=list)
    steps: int = 0
    wall_time_s: float = 0.0
    steps_per_s: float = 0.0
    examples_per_s: float = 0.0


def dict_batches(
    data: Dict[str, np.ndarray],
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    device: Any = "cuda",
    drop_remainder: bool = True,
    mesh: Any = None,
) -> Iterable[Dict[str, torch.Tensor]]:
    """Static-shape dict batches of host ``data``, each copied to ``device``.

    With a ``mesh``, each batch is this rank's rows of the global batch
    (``training.py:339-360``): a ragged batch first wraps real rows up to a
    multiple of the batch's ranks (:func:`~unionml_tpu_torch.parallel.mesh.wrapped_row_indices`),
    then each rank gathers and copies only its own share."""
    device = resolve_device(device)
    host = {k: np.asarray(v) for k, v in data.items()}
    n_rows = len(next(iter(host.values())))
    indices = np.arange(n_rows) if rng is None else rng.permutation(n_rows)
    end = (n_rows // batch_size) * batch_size if drop_remainder else n_rows
    if end == 0:
        end = n_rows
    rows = rank_rows(mesh) if mesh is not None else None
    for start in range(0, end, batch_size):
        idx = indices[start:start + batch_size]
        if rows is not None:
            idx = rows(idx)
        yield {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(device) for k, v in host.items()}


def rank_rows(mesh: Any) -> Callable[[np.ndarray], np.ndarray]:
    """A map from a global batch's row indices to this rank's: wrapped up to
    a multiple of the batch's ranks with real rows, then this rank's
    contiguous share (what ``jax.device_put`` with the batch sharding lays
    on this rank's device)."""
    from unionml_tpu_torch.parallel.mesh import batch_axis_size, batch_sharding, wrapped_row_indices

    ways, sharding = batch_axis_size(mesh), batch_sharding(mesh)

    def rows(idx: np.ndarray) -> np.ndarray:
        wrap = wrapped_row_indices(len(idx), ways)
        return sharding.shard(idx if wrap is None else idx[wrap])

    return rows


def prefetched_batches(loader: Any, rng: Optional[np.random.Generator], device: torch.device
                       ) -> Iterable[Dict[str, torch.Tensor]]:
    """One epoch of ``loader``'s batches (a
    :class:`~unionml_tpu_torch.native.PrefetchLoader`) on ``device``, in
    ``dict_batches``' order for the same ``rng``.

    On a CUDA device each batch leaves its pinned slot by an asynchronous
    copy on a stream of its own, issued while the previous step computes
    (``training.py:414-466`` overlaps the transfer the same way): the compute
    stream waits on the copy's event before the step reads the batch, the
    batch's memory is recorded on the compute stream so the allocator does
    not reuse it under a later step, and a slot is released only once its
    copy has completed, one batch behind. On the CPU the batches are the
    loader's own copies."""
    if device.type != "cuda":
        yield from loader.epoch(rng=rng, copy=True)
        return
    compute = torch.cuda.current_stream(device)
    copies = torch.cuda.Stream(device)
    queue = []  # (batch, copy event, release), oldest first: handed over, to hand over, in flight
    try:
        for views, release in loader.epoch(rng=rng, copy=False, defer_release=True):
            with torch.cuda.stream(copies):
                batch = {k: v.to(device, non_blocking=True) for k, v in views.items()}
                done = torch.cuda.Event()
                done.record(copies)
            queue.append((batch, done, release))
            if len(queue) > 2:  # the slot of the batch handed over last: its copy has long completed
                _, old_done, old_release = queue.pop(0)
                old_done.synchronize()
                old_release()
            if len(queue) > 1:
                yield _handed_over(queue[-2], compute)
        if queue:
            yield _handed_over(queue[-1], compute)
    finally:
        # an abandoned epoch (fit's first step takes one batch) must not leave a
        # copy reading a slot that the next epoch's workers refill
        copies.synchronize()


def _handed_over(entry, compute: torch.cuda.Stream) -> Dict[str, torch.Tensor]:
    """The batch of ``entry``, ordered after its copy on ``compute`` and its
    memory recorded there (the allocator must not reuse it under a later
    step)."""
    batch, done, _ = entry
    compute.wait_event(done)
    for tensor in batch.values():
        tensor.record_stream(compute)
    return batch


def fit(
    state: TrainState,
    data: Dict[str, np.ndarray],
    *,
    batch_size: int,
    num_epochs: int = 1,
    num_steps: Optional[int] = None,
    mesh: Any = None,
    param_spec: Any = None,
    input_signature: Tuple[str, ...] = ("inputs",),
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    log_every: int = 50,
    seed: int = 0,
    prefetch: bool = False,
    prefetch_convert: Optional[Dict[str, str]] = None,
    step_fn: Optional[Callable] = None,
    grad_accum: int = 1,
) -> FitResult:
    """Run the train loop over host ``data`` on the state's device.

    The first step runs outside the timed window; ``num_steps`` (counting
    that first step) overrides ``num_epochs``. Every ``log_every`` steps the
    metrics are fetched to the host into ``metrics_history``.

    ``checkpoint_dir`` turns on step checkpoints
    (:class:`~unionml_tpu_torch.checkpoint.Checkpointer`, every
    ``checkpoint_every`` steps, with the SIGTERM flush): a directory that
    already holds one resumes from its latest step, restored in place into
    ``state``.

    ``prefetch=True`` gathers batches with the native threaded prefetcher
    into pinned slots and copies each to the card on its own stream while
    the previous step computes (:func:`prefetched_batches`); the batches and
    their order are ``dict_batches``'. ``prefetch_convert`` (e.g.
    ``{"inputs": "float32", "labels": "int32"}`` for float64/int64 data, or
    ``{"inputs": "bfloat16"}``) converts in the gather workers and requires
    ``prefetch=True``.

    ``mesh``/``param_spec`` train sharded (see the module docstring): each
    rank's batches are its rows (:func:`dict_batches`; with ``prefetch`` the
    native gather reads only those), the built-in step is
    ``make_classifier_train_step(mesh=..., param_spec=...)``, and a
    ``step_fn`` of your own must be built for the same mesh.
    ``FitResult.state`` is the laid-out state; ``examples_per_s`` counts the
    global batch. With ``checkpoint_dir`` every rank takes part in each
    save's gather, rank 0 writes, and a resume (at the same world size)
    restores into each rank's shards.
    """
    if step_fn is not None and grad_accum != 1:
        raise ValueError("grad_accum applies to the built-in step; pass it to your step builder")
    if prefetch_convert and not prefetch:
        raise ValueError("prefetch_convert requires prefetch=True (conversion runs in the native gather workers)")
    if step_fn is None:
        step_fn = make_classifier_train_step(mesh=mesh, param_spec=param_spec, input_signature=input_signature,
                                             grad_accum=grad_accum)
    elif param_spec is not None:
        raise ValueError("param_spec applies to the built-in step; pass it to your step builder")
    device = state.device

    def batches(epoch_rng):
        if loader is not None:
            return prefetched_batches(loader, epoch_rng, device)
        return dict_batches(data, batch_size, rng=epoch_rng, device=device, mesh=mesh)

    checkpointer = None
    if checkpoint_dir is not None:
        from unionml_tpu_torch.checkpoint import Checkpointer, install_preemption_handler

        checkpointer = Checkpointer(checkpoint_dir, save_interval_steps=checkpoint_every)
        install_preemption_handler(checkpointer)
        latest = checkpointer.latest_step()
        if latest is not None:
            logger.info("Resuming from checkpoint step %d", latest)
            state = checkpointer.restore(state)

    loader = None
    try:
        if prefetch:
            from unionml_tpu_torch.native import PrefetchLoader

            loader = PrefetchLoader(data, batch_size, convert=prefetch_convert, pin_memory=device.type == "cuda",
                                    rows=rank_rows(mesh) if mesh is not None else None)
        rng = np.random.default_rng(seed)
        history = []
        step = start_step = state.step
        # the first step (allocator and library warm-up) runs outside the timed window
        state, metrics = step_fn(state, next(iter(batches(rng))))
        float(metrics["loss"])  # host fetch = barrier
        step += 1

        t0 = time.perf_counter()
        done = False
        epochs = num_epochs if num_steps is None else max(num_epochs, 10**9)
        for _ in range(epochs):
            for batch in batches(rng):
                state, metrics = step_fn(state, batch)
                step += 1
                if step % log_every == 0:
                    metrics_host = {k: float(v) for k, v in metrics.items()}
                    history.append({"step": step, **metrics_host})
                    logger.info("step %d: %s", step, metrics_host)
                if checkpointer is not None:
                    checkpointer.save(step, state)
                if num_steps is not None and step - start_step >= num_steps:
                    done = True
                    break
            if done:
                break
        float(metrics["loss"])  # host fetch = barrier for the timed window
        wall = time.perf_counter() - t0
    finally:
        if checkpointer is not None:
            checkpointer.close()  # flushes the pending writes
        if loader is not None:
            loader.close()
    if checkpointer is not None and mesh is not None and dist.get_world_size() > 1:
        # rank 0 wrote the last checkpoint: no rank reads the directory before it landed
        dist.barrier()

    executed = step - start_step - 1  # the first step is excluded from the timing
    return FitResult(
        state=state,
        metrics_history=history,
        steps=step,
        wall_time_s=wall,
        steps_per_s=executed / wall if wall > 0 else 0.0,
        examples_per_s=executed * batch_size / wall if wall > 0 else 0.0,
    )


def fit_lm(
    state: TrainState,
    sequences: Sequence[np.ndarray],
    *,
    seq_len: int,
    batch_size: int,
    pack: bool = True,
    max_segments_per_row: int = 0,
    num_epochs: int = 1,
    num_steps: Optional[int] = None,
    mesh: Any = None,
    param_spec: Any = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    log_every: int = 50,
    seed: int = 0,
    prefetch: bool = False,
    prefetch_convert: Optional[Dict[str, str]] = None,
    grad_accum: int = 1,
    moe_aux: bool = False,
) -> FitResult:
    """Causal-LM training over ragged token sequences through :func:`fit`
    (``training.py:524-603``).

    ``pack=True`` (the default) runs :func:`pack_sequences`: several short
    sequences share each ``seq_len`` row, segment ids confine attention and
    restart positions per segment, and cross-segment transitions are masked
    out of the loss. ``pack=False`` right-pads one sequence per row with a
    loss mask. ``FitResult.examples_per_s`` counts rows. ``mesh``/``param_spec``
    shard the training as :func:`fit` does.
    """
    if pack:
        packed = pack_sequences(sequences, seq_len, max_segments_per_row=max_segments_per_row)
        data = {"input_ids": packed["input_ids"], "segment_ids": packed["segment_ids"]}
        logger.info(
            "packed %d sequences into %d rows of %d (efficiency %.1f%%, %d truncated)",
            len(sequences), packed["input_ids"].shape[0], seq_len,
            100.0 * packing_efficiency(packed["segment_ids"]), packed["truncated"],
        )
    else:
        input_ids = np.zeros((len(sequences), seq_len), dtype=np.int32)
        mask = np.zeros((len(sequences), seq_len), dtype=np.float32)
        truncated = 0
        for i, seq in enumerate(sequences):
            arr = np.asarray(seq).reshape(-1)[:seq_len]
            truncated += int(np.asarray(seq).size > seq_len)
            input_ids[i, : arr.size] = arr
            mask[i, : arr.size] = 1.0
        if truncated:
            logger.info("truncated %d sequences to seq_len=%d", truncated, seq_len)
        data = {"input_ids": input_ids, "mask": mask}

    step_fn = make_lm_train_step(packed=pack, grad_accum=grad_accum, moe_aux=moe_aux, mesh=mesh,
                                 param_spec=param_spec)
    return fit(
        state, data, batch_size=batch_size, num_epochs=num_epochs, num_steps=num_steps, mesh=mesh,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, log_every=log_every, seed=seed,
        prefetch=prefetch, prefetch_convert=prefetch_convert, step_fn=step_fn,
    )


def bert_flops_per_token(config: Any) -> float:
    """Approximate training FLOPs per token for MFU accounting (6 * params-ish),
    as ``training.py:606-612`` counts them."""
    hidden, layers, inter = config.hidden_size, config.num_layers, config.intermediate_size
    per_layer = 4 * hidden * hidden + 2 * hidden * inter  # attn projections + mlp
    fwd = layers * 2 * per_layer  # 2 flops per MAC; embedding lookups are negligible
    return 3.0 * fwd  # fwd + bwd ~ 3x forward
