"""Flax-style mixed-precision layer helpers shared by the port's models.

Parameters stay float32; each layer casts its weight and input to the
compute dtype in ``forward``, as ``nn.Dense(dtype=...)`` does. LayerNorm
takes its statistics and affine in float32 and returns the compute dtype.
Dropout draws its masks from an explicit ``torch.Generator``;
:func:`recomputed` runs a block under activation recompute (``remat``) with
the same masks in the recompute as in the forward.

Weight-only int8 for serving (``unionml_tpu/ops/quant.py``): :func:`quantize_model`
gives a model whose selected ``nn.Linear`` layers are :class:`QuantizedLinear`
(int8 codes and per-output f32 scales), every other parameter shared with the
original. :func:`_dense` dequantizes such a layer's weight just before its
product, into the leaf's own dtype, then casts it as any other weight: one
layer's full-precision weight is live at a time.

Mesh collectives (:class:`AxisGroup`): one axis (or a product of axes)
through this rank and its differentiable collectives. In a forward that
autograd records, they are conjugate pairs: ``enter`` (identity forward,
all-reduce backward) before a computation each rank does in part, ``reduce``
(all-reduce forward, identity backward) after it; ``take`` (this rank's
block of the tokens; the blocks' gradients gathered backward) and
``gather``; ``exchange`` (the all-to-all, its own adjoint) and ``total`` (a
sum whose gradient is summed too). Without a graph (inference,
``torch.no_grad``) each is the plain collective. Expert parallelism runs
over the ``expert`` axis (beside ``tensor``, over expert×tensor) and the batch's ranks.

Tensor parallelism (:class:`TensorParallel`, an ``AxisGroup``): one rank's
share of a Megatron-split model: ``enter`` before a column-parallel product,
``reduce`` after a row-parallel one, and the vocab-parallel lookup and the
all-gather of the tied head's logits built on them.

Sequence parallelism (:class:`SequenceParallel`, an ``AxisGroup``): the
collectives of the mesh's ``sequence`` axis, where each rank holds one
contiguous chunk of every row. :meth:`SequenceParallel.to_heads` and
:meth:`SequenceParallel.to_sequence` are Ulysses's two all-to-alls (each the
other's backward), :meth:`SequenceParallel.broadcast_first` gives every rank
the first chunk's value (BERT's ``[CLS]``; its gradient is summed onto the
first rank) and :meth:`SequenceParallel.shift` moves blocks one hop around
the ring (the point-to-point exchange inside ring attention's forward and
backward, not differentiable on its own). Over one rank each is the
identity and runs no operation.
"""

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unionml_tpu_torch.ops.quant import QuantizedArray, quantize_tree


class QuantizedLinear(nn.Module):
    """An ``nn.Linear`` whose weight is stored as int8 codes ``q`` ``(out,
    in)`` and f32 scales ``scale`` ``(out, 1)``; ``weight`` is the
    :class:`~unionml_tpu_torch.ops.quant.QuantizedArray` over them."""

    def __init__(self, weight: QuantizedArray, bias: Optional[nn.Parameter]) -> None:
        super().__init__()
        self.register_buffer("q", weight.q)
        self.register_buffer("scale", weight.scale)
        self.register_parameter("bias", bias)
        self.weight_dtype = weight.dtype

    @property
    def weight(self) -> QuantizedArray:
        return QuantizedArray(q=self.q, scale=self.scale, dtype=self.weight_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``nn.Linear``'s product in the leaf's dtype (a layer called as a module)."""
        return F.linear(x, self.weight.dequantize(), self.bias)


class _Enter(torch.autograd.Function):
    """Identity forward, sum over the tensor axis backward: the input of a
    column-parallel product, whose gradient each rank holds only in part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """Sum over the tensor axis forward, identity backward: the partial
    products of a row-parallel layer (its gradient is every rank's own)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    """All-gather of the last dimension forward (rank order), this rank's
    slice of it backward: the tied head's vocab-parallel logits."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp._gather_last(x)

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        part = grad.shape[-1] // tp.size
        return grad[..., tp.index * part:(tp.index + 1) * part].contiguous(), None


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_to_all(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``all_to_all_single`` of ``x``'s leading dimension (one part per rank)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _gather_rows(x: torch.Tensor, group: Any, size: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dimension 0, in rank order."""
    x = x.contiguous()
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(out, x, group=group)
    return out


class _Take(torch.autograd.Function):
    """This rank's block of dimension 0 forward; backward, the blocks'
    gradients gathered from every rank (each rank's input reached only its
    own block, and every rank holds the same input)."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.size = group, size
        n = x.shape[0] // size
        return x[index * n:(index + 1) * n].clone()

    @staticmethod
    def backward(ctx, grad):
        return _gather_rows(grad, ctx.group, ctx.size), None, None, None


class _Gather(torch.autograd.Function):
    """The ranks' blocks of dimension 0 gathered forward; backward, this
    rank's block of the gradient (every rank computes the same after it)."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.index, ctx.rows = index, x.shape[0]
        return _gather_rows(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows].contiguous(), None, None, None


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` of dimension 0 forward and backward: the
    exchange is its own adjoint (part j goes to rank j, whose part i came
    from rank i)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


class _Total(torch.autograd.Function):
    """The sum over the group forward and backward: each rank's share of a
    total that every rank's objective reads (the router's mean gate over
    the global tokens); the gradient of a share is the sum of the ranks'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis (or a product of axes) through this rank: its process
    group (None over one rank), its size and this rank's index on it, and
    the differentiable collectives over it. In a forward that autograd
    records they are conjugate pairs: :meth:`enter` (identity forward, sum
    backward) with :meth:`reduce` (sum forward, identity backward), and
    :meth:`take` with :meth:`gather`; :meth:`exchange` is its own adjoint
    and :meth:`total` sums both ways. Without a graph (inference) each is
    the plain collective; over one rank each is the identity and runs no
    operation. A copy of a module that holds one shares it (a process group
    cannot be copied)."""

    group: Any
    size: int
    index: int

    @classmethod
    def of(cls, mesh: Any, axis: str) -> "AxisGroup":
        from unionml_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

        if mesh is None:
            return cls(None, 1, 0)
        return cls(axis_group(mesh, axis), axis_size(mesh, axis), axis_index(mesh, axis))

    @classmethod
    def over(cls, mesh: Any, axes: Tuple[str, ...]) -> "AxisGroup":
        """The product of ``axes`` through this rank (one rank for ``None`` or
        where the mesh lacks them); ``index`` is the rank's place in the
        group's rank order, the order :meth:`gather` returns
        (``parallel/mesh.py::axes_order`` maps it to the axes')."""
        from unionml_tpu_torch.parallel.mesh import axes_group, axes_size

        group = None if mesh is None else axes_group(mesh, axes)
        if group is None:
            return cls(None, 1, 0)
        return cls(group, axes_size(mesh, axes), dist.get_group_rank(group, dist.get_rank()))

    def __deepcopy__(self, memo: Dict[int, Any]) -> "AxisGroup":
        return self

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a computation each rank does only in part (a
        column-parallel product): itself, and in a recorded forward its
        gradient summed over the group (over one rank the graph is the
        unsplit model's, so its gradients sum in the same order)."""
        return _Enter.apply(x, self.group) if self.size > 1 and _recorded(x) else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group: in place without a graph, else a new
        tensor whose gradient passes through as it is."""
        if self.size == 1:
            return x
        if _recorded(x):
            return _Reduce.apply(x, self.group)
        dist.all_reduce(x, group=self.group)
        return x

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, its gradient summed over the group too."""
        if self.size == 1:
            return x
        if _recorded(x):
            return _Total.apply(x, self.group)
        return self.reduce(x)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of dimension 0 (see :class:`_Take`)."""
        if self.size == 1:
            return x
        if _recorded(x):
            return _Take.apply(x, self.group, self.size, self.index)
        n = x.shape[0] // self.size
        return x[self.index * n:(self.index + 1) * n]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of dimension 0 in rank order (see :class:`_Gather`)."""
        if self.size == 1:
            return x
        if _recorded(x):
            return _Gather.apply(x, self.group, self.size, self.index)
        return _gather_rows(x, self.group, self.size)

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Part j of dimension 0 to rank j, part i of the result from rank i."""
        if self.size == 1:
            return x
        return _Exchange.apply(x, self.group) if _recorded(x) else _all_to_all(x, self.group)


@dataclasses.dataclass(frozen=True)
class TokenGroup(AxisGroup):
    """The ranks a training batch's tokens are split over, as a sparse
    block routes them together: data×fsdp, each rank holding a block of
    whole rows, times ``chunks`` sequence ranks, each holding one chunk of
    every row of its block. ``index`` is the rank's block times ``chunks``
    plus its chunk (``batch_index(mesh, sequence=True)``); ``order`` puts a
    :meth:`gather` over the group in that order where the group numbers its
    ranks otherwise (``batch_order``; None: it does not)."""

    chunks: int = 1
    order: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class TensorParallel(AxisGroup):
    """How one rank of a tensor-parallel model computes: the tensor axis
    (``index`` is this rank's place on it, which fixes its shard of every
    split weight) and the attention heads this rank holds (``num_heads /
    size``, or all of them when the axis does not divide the heads and q, k,
    v stay whole). The input of a column-parallel product goes through
    :meth:`enter`, the partial outputs of a row-parallel one through
    :meth:`reduce`."""

    heads: int
    split_heads: bool

    def lookup(self, ids: torch.Tensor, weight: torch.Tensor, embed=F.embedding) -> torch.Tensor:
        """A vocab- (or position-) parallel embedding: this rank's rows of the
        table answer the ids in its range, zeros the rest, and the sum over
        the axis is every id's row (exact: one addend is not zero). Its
        gradient reaches this rank's rows only. ``embed(ids, table)`` looks
        the local rows up (:func:`one_hot_embedding` for a table of a few rows)."""
        rows = weight.shape[0]
        local = ids - self.index * rows
        inside = (local >= 0) & (local < rows)
        out = embed(torch.where(inside, local, torch.zeros_like(local)), weight)
        return self.reduce(torch.where(inside[..., None], out, torch.zeros_like(out)))

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' shards of the last dimension concatenated in rank order
        (the tied head's vocab-parallel logits)."""
        return _GatherLast.apply(x, self) if _recorded(x) else self._gather_last(x)

    def _gather_last(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        out = torch.empty((self.size * flat.shape[0], flat.shape[1]), dtype=x.dtype, device=x.device)
        # torch 2.13 deprecates all_gather_into_tensor (a FutureWarning) for
        # all_gather_single, which torch 2.11 does not have
        (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(out, flat, group=self.group)
        out = out.reshape(self.size, flat.shape[0], flat.shape[1]).transpose(0, 1)
        return out.reshape(*x.shape[:-1], self.size * x.shape[-1])


def _seq_to_heads(x: torch.Tensor, group: Any, size: int) -> torch.Tensor:
    """``(P, heads, L, d)`` (this rank's chunk of every head) to ``(P,
    heads / size, size * L, d)`` (the whole sequence of this rank's heads):
    head part j goes to rank j, chunk j comes back from it, in rank order."""
    p, h, seq, d = x.shape
    parts = x.reshape(p, size, h // size, seq, d).transpose(0, 1)
    return _all_to_all(parts, group).permute(1, 2, 0, 3, 4).reshape(p, h // size, size * seq, d)


def _heads_to_seq(x: torch.Tensor, group: Any, size: int) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`: ``(P, heads / size, size * L, d)``
    to ``(P, heads, L, d)``."""
    p, h, seq, d = x.shape
    parts = x.reshape(p, h, size, seq // size, d).permute(2, 0, 1, 3, 4)
    return _all_to_all(parts, group).transpose(0, 1).reshape(p, size * h, seq // size, d)


class _ToHeads(torch.autograd.Function):
    """Sequence chunks to head shards forward, the inverse exchange backward."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _seq_to_heads(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        return _heads_to_seq(grad, ctx.group, ctx.size), None, None


class _ToSequence(torch.autograd.Function):
    """Head shards to sequence chunks forward, the inverse exchange backward."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _heads_to_seq(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        return _seq_to_heads(grad, ctx.group, ctx.size), None, None


class _BroadcastFirst(torch.autograd.Function):
    """The first rank's value on every rank forward; backward, the ranks'
    gradients summed onto the first rank (the others' inputs reached no
    output: zeros)."""

    @staticmethod
    def forward(ctx, x, group, first):
        ctx.group, ctx.first = group, first
        out = x.contiguous().clone()
        dist.broadcast(out, src=first, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.reduce(grad, dst=ctx.first, group=ctx.group)
        if dist.get_rank() != ctx.first:
            grad = torch.zeros_like(grad)
        return grad, None, None


@dataclasses.dataclass(frozen=True)
class SequenceParallel(AxisGroup):
    """The ``sequence`` axis through this rank; its ``index`` is the chunk
    of every row the rank holds."""

    def _peer(self, index: int) -> int:
        """The global rank of the axis's rank ``index``."""
        return dist.get_global_rank(self.group, index % self.size)

    def to_heads(self, x: torch.Tensor) -> torch.Tensor:
        """Ulysses's first all-to-all (see :func:`_seq_to_heads`), differentiable."""
        return x if self.size == 1 else _ToHeads.apply(x, self.group, self.size)

    def to_sequence(self, x: torch.Tensor) -> torch.Tensor:
        """Ulysses's second all-to-all (see :func:`_heads_to_seq`), differentiable."""
        return x if self.size == 1 else _ToSequence.apply(x, self.group, self.size)

    def broadcast_first(self, x: torch.Tensor) -> torch.Tensor:
        """The first chunk's ``x`` on every rank, its gradient summed there."""
        return x if self.size == 1 else _BroadcastFirst.apply(x, self.group, self._peer(0))

    def shift(self, tensors: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        """One hop around the ring: ``tensors`` go to the next rank, the
        previous rank's come back (one batch of point-to-point operations)."""
        if self.size == 1:
            return tensors
        nxt, prev = self._peer(self.index + 1), self._peer(self.index - 1)
        received = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, self.group, tag) for tag, t in enumerate(tensors)]
        ops += [dist.P2POp(dist.irecv, r, prev, self.group, tag) for tag, r in enumerate(received)]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return tuple(received)


#: the attention impls that split the sequence over the mesh's ``sequence`` axis
SEQUENCE_IMPLS = ("ring", "ulysses")


def shared_configs(model: nn.Module) -> Dict[int, Any]:
    """A ``copy.deepcopy`` memo under which a copy of ``model`` shares its
    modules' configs (frozen dataclasses, which may hold the meshes whose
    process groups ``sp_mesh``/``ep_mesh`` name: a copy keeps those very
    meshes)."""
    configs = (getattr(module, "config", None) for module in model.modules())
    return {id(cfg): cfg for cfg in configs if cfg is not None}


def dense_attention_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose sequence-parallel configs (``attention_impl``
    ring or ulysses) attend densely instead (``"auto"``, no ``sp_mesh``): what
    serving runs, since a request's rows arrive whole on one rank. The copy
    shares every parameter and buffer with ``model``, which is left as it is."""
    memo: Dict[int, Any] = {id(t): t for t in (*model.parameters(), *model.buffers())}
    for module in model.modules():
        cfg = getattr(module, "config", None)
        if getattr(cfg, "attention_impl", None) in SEQUENCE_IMPLS:
            memo[id(cfg)] = dataclasses.replace(cfg, attention_impl="auto", sp_mesh=None)
    return copy.deepcopy(model, memo=memo)


def one_hot_embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, weight)`` as a one-hot product, for a table of a
    few rows (BERT's token types): exact (each output row is one times its
    table row, with float32 products), and its gradient is a matrix product,
    which sums in a fixed order on the card. The embedding backward's
    atomics do not: with every id alike (8192 token types of 0 in a B64
    S128 batch) its gradient moved in the last bits from run to run."""
    return torch.matmul(F.one_hot(ids.long(), weight.shape[0]).to(weight.dtype), weight)


def _kernel(layer: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """A dense layer's weight in the compute dtype (an int8 weight dequantized
    first, into its leaf's dtype, as JAX's ``dequantize_tree`` does)."""
    weight = layer.weight
    if isinstance(weight, QuantizedArray):
        weight = weight.dequantize()
    return weight.to(dtype)


def _dense(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype, bias: bool = True) -> torch.Tensor:
    """``nn.Dense(dtype=...)``: input, kernel and bias cast to the compute
    dtype. ``bias=False`` leaves the bias out (a row-parallel shard of a
    tensor-parallel layer on every rank but one)."""
    bias = layer.bias.to(dtype) if bias and layer.bias is not None else None
    return F.linear(x.to(dtype), _kernel(layer, dtype), bias)


def quantize_model(model: nn.Module) -> Tuple[nn.Module, Dict[str, Any]]:
    """``(quantized copy, weight tree)``: :func:`~unionml_tpu_torch.ops.quant.quantize_tree`
    of ``model``'s named parameters (a flat dict keyed by parameter name), and
    a copy of ``model`` whose every ``nn.Linear`` with a quantized weight is a
    :class:`QuantizedLinear`. The copy shares every other parameter (and the
    quantized layers' biases) with ``model``, which is left untouched."""
    tree = quantize_tree(dict(model.named_parameters()))
    # the module structure is copied, no parameter is: the memo maps each to itself
    qmodel = copy.deepcopy(model, memo={id(p): p for p in model.parameters()})
    for name, leaf in tree.items():
        if not isinstance(leaf, QuantizedArray):
            continue
        layer_name, _, attr = name.rpartition(".")
        owner_name, _, child = layer_name.rpartition(".")
        owner = qmodel.get_submodule(owner_name)
        layer = getattr(owner, child)
        if attr != "weight" or not isinstance(layer, nn.Linear):
            raise ValueError(f"{name}: only nn.Linear weights can be served as int8")
        setattr(owner, child, QuantizedLinear(leaf, layer.bias))
    return qmodel, tree


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 statistics and affine, output in the compute dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale kept
    values by ``1 / (1 - rate)``; ``generator=None`` is deterministic."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def recomputed(layer: nn.Module, generator: Optional[torch.Generator], *args: Any) -> Any:
    """``layer(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped after the forward and recomputed in the backward
    pass, as ``nn.remat`` does in the JAX package. ``generator`` is one of
    ``args`` (the dropout and router-jitter draws): the recompute rewinds it
    to its state before the layer, so it draws the forward's masks again, and
    then puts it back where it found it, so after the backward pass the
    generator stands where a forward without recompute leaves it."""
    if generator is None:
        return checkpoint(layer, *args, use_reentrant=False)
    before = generator.get_state()
    calls = [0]

    def run(*inputs):
        calls[0] += 1
        if calls[0] == 1:  # the forward itself: the generator advances as usual
            return layer(*inputs)
        found = generator.get_state()
        generator.set_state(before)
        try:
            return layer(*inputs)
        finally:
            generator.set_state(found)

    return checkpoint(run, *args, use_reentrant=False)
