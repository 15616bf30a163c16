"""Shared machinery for rule-based parameter sharding tables.

Port of ``unionml_tpu/models/_sharding.py``: a model family declares only its
``spec_for`` rule; walking the tree by name and laying it out live here.
The port's parameter tree is a dict keyed by parameter name
(``dict(model.named_parameters())``, or nested dicts), and a rank keeps only
its own shard of each leaf (SPMD), so :func:`place_by_specs` returns local
shards where JAX's ``device_put`` returns global arrays.

An ``fsdp`` entry is laid out by FSDP2 (:func:`fully_shard_model`), not by
:func:`place_by_specs`: ``torch.distributed.fsdp.fully_shard`` shards
dimension 0 of every parameter of the modules it wraps, which for a torch
``(out, in)`` weight is the output dimension, where JAX's spec shards the
flax kernel's input dimension (the same dimension in the port's flipped
spec would be the last). The values are the same; only where the bytes live
differs. The weights are not transposed to copy JAX's layout.

Serving lays an ``fsdp`` entry out without FSDP2 (:func:`split_fsdp_weights`,
for the engines' GPT): each rank keeps a contiguous ``1/N`` of the leaf's
storage at rest (dimension 0's shard, as FSDP2's), and each decoder block
all-gathers its pieces into whole buffers shared by the blocks just before
it computes (:class:`FsdpGather`), inside the engines' captured graphs.
"""

import copy
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from unionml_tpu_torch.models._layers import QuantizedLinear, shared_configs
from unionml_tpu_torch.ops.quant import QuantizedArray
from unionml_tpu_torch.parallel.mesh import FSDP_AXIS, NamedSharding, Spec, _tree_map, fsdp_mesh


def shard_by_rules(
    params: Any,
    spec_for: Callable[[Tuple[str, ...], Any], Any],
    is_leaf: Optional[Callable[[Any], bool]] = None,
) -> Any:
    """Apply ``spec_for((path parts), leaf) -> Spec`` over a parameter tree.
    A key's dotted name splits into parts (``"layers.0.qkv.weight"`` is
    ``("layers", "0", "qkv", "weight")``); ``is_leaf`` stops the walk at
    composite leaves (``QuantizedArray``) so ``spec_for`` sees the whole node."""
    leaf_of = is_leaf or (lambda x: False)

    def walk(tree: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict) and not leaf_of(tree):
            return {key: walk(value, path + tuple(str(key).split("."))) for key, value in tree.items()}
        return spec_for(path, tree)

    return walk(params, ())


def _without_fsdp(spec: Spec) -> Spec:
    """``spec`` with its ``fsdp`` entries dropped (FSDP2 lays those out)."""

    def keep(entry: Any) -> Any:
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a != FSDP_AXIS)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return None if entry == FSDP_AXIS else entry

    return Spec(*(keep(e) for e in spec), parts=spec.parts)


def names_axis(spec_tree: Any, axis: str) -> bool:
    """Whether any :class:`Spec` of ``spec_tree`` shards a dimension over ``axis``."""
    found = []

    def visit(spec: Any) -> Any:
        specs = [spec.q, spec.scale] if isinstance(spec, QuantizedArray) else [spec]
        for s in specs:
            for entry in s:
                if entry == axis or (isinstance(entry, tuple) and axis in entry):
                    found.append(True)
        return spec

    _tree_map(visit, spec_tree, is_leaf=lambda x: isinstance(x, (Spec, QuantizedArray)))
    return bool(found)


def place_by_specs(params: Any, mesh: Any, spec_tree: Any) -> Any:
    """This rank's shard of every leaf of ``params`` under the matching spec
    tree: the serving-side layout of a full tree that every rank holds. A
    ``QuantizedArray`` node's codes and scales each take their own spec.
    ``fsdp`` entries are left to FSDP2 (:func:`fully_shard_model`): here
    those dimensions stay whole. Raises ``ValueError`` where an axis does not
    divide a dimension."""

    def place(leaf: Any, spec: Any) -> Any:
        if isinstance(leaf, QuantizedArray):
            return QuantizedArray(q=NamedSharding(mesh, _without_fsdp(spec.q)).shard(leaf.q),
                                  scale=NamedSharding(mesh, _without_fsdp(spec.scale)).shard(leaf.scale),
                                  dtype=leaf.dtype)
        return NamedSharding(mesh, _without_fsdp(spec)).shard(leaf)

    return _tree_map(place, params, spec_tree, is_leaf=lambda x: isinstance(x, QuantizedArray))


def weight_tree(model: nn.Module) -> dict:
    """``model``'s parameters by name, an int8 layer's weight as its
    :class:`~unionml_tpu_torch.ops.quant.QuantizedArray`."""
    tree = dict(model.named_parameters())
    for name, module in model.named_modules():
        if isinstance(module, QuantizedLinear):
            tree[f"{name}.weight"] = module.weight
    return tree


def shard_model(model: nn.Module, mesh: Any, specs: Any, tp: Any, tp_modules: Tuple[type, ...],
                partial: Iterable[str] = (), trainable: bool = False) -> Tuple[nn.Module, dict]:
    """``(this rank's copy of model, its weight tree)``: the module structure
    of ``model`` copied (no weight is), each weight replaced by its shard
    under ``specs`` (:func:`place_by_specs`), and ``tp`` (a
    :class:`~unionml_tpu_torch.models._layers.TensorParallel`) set on every
    module of the ``tp_modules`` types. The copy's ``tp_specs`` are the
    ``specs`` it was cut by, and its ``tp_partial`` the set ``partial`` of
    parameters whose gradients are each rank's part of a sum over the
    tensor axis. ``trainable=True`` gives parameters of their own
    (copied, gradients on); else they share memory with ``model``'s where
    they are whole, and take no gradients. The copy shares ``model``'s
    configs (a ring or Ulysses config keeps its ``sp_mesh``)."""
    with torch.no_grad():
        local = place_by_specs(weight_tree(model), mesh, specs)
    shard = copy.deepcopy(model, memo={**shared_configs(model),
                                       **{id(t): t for t in [*model.parameters(), *model.buffers()]}})
    for name, leaf in local.items():
        owner_name, _, attr = name.rpartition(".")
        owner = shard.get_submodule(owner_name)
        if isinstance(leaf, QuantizedArray):
            owner.q, owner.scale = leaf.q, leaf.scale
        elif trainable:
            setattr(owner, attr, nn.Parameter(leaf.detach().clone()))
        else:
            setattr(owner, attr, nn.Parameter(leaf, requires_grad=False))
    for module in shard.modules():
        if isinstance(module, tp_modules):
            module.tp = tp
    shard.tp_specs, shard.tp_partial = specs, frozenset(partial)
    return shard, local


class FsdpGather:
    """One decoder block's weights split over the ``fsdp`` axis for serving:
    this rank keeps, at rest, its ``1/N`` of each split leaf (``pairs``:
    ``(piece, whole)``, the piece a contiguous ``1/N`` of the leaf's storage,
    as FSDP2 keeps dimension 0's), and :meth:`gather` all-gathers every
    piece into its whole buffer just before the block computes. The whole
    buffers are shared by every block of one shape (:func:`split_fsdp_weights`),
    so a rank holds one block's weights whole at a time. Over NCCL the
    gathers are recorded into the engine's captured graphs like the tensor
    axis's all-reduces. A copy of a module that holds one shares it (a
    process group cannot be copied)."""

    def __init__(self, group: Any) -> None:
        self.group = group
        self.pairs: list = []

    def __deepcopy__(self, memo: dict) -> "FsdpGather":
        return self

    @torch.no_grad()
    def gather(self) -> None:
        gather_into = getattr(torch.distributed, "all_gather_single", None) or torch.distributed.all_gather_into_tensor
        for piece, whole in self.pairs:
            gather_into(whole.view(-1), piece, group=self.group)


def _fsdp_only(spec: Spec) -> Spec:
    """``spec`` with only its ``fsdp`` entries kept (one part per dimension)."""
    return Spec(*(FSDP_AXIS if e == FSDP_AXIS or (isinstance(e, tuple) and FSDP_AXIS in e) else None for e in spec))


def split_fsdp_weights(model: nn.Module, tree: dict, specs: dict, mesh: Any,
                       blocks: Sequence[Tuple[str, nn.Module]]) -> dict:
    """Split, in place, the weights of ``blocks`` (``(name, module)`` of
    ``model``, each with an ``fsdp`` attribute) whose spec names ``fsdp``
    over the mesh's ``fsdp`` axis, for serving: each such leaf's module
    attribute becomes a whole buffer shared by the blocks (by leaf name
    within the block, shape and dtype), each block's :class:`FsdpGather`
    keeps this rank's piece and fills the buffer. An int8 leaf's codes and
    scales split each by its own spec. Returns ``tree`` with the pieces in
    place of the split leaves (what this rank holds at rest). Raises JAX's
    ``ValueError`` where the axis does not divide the dimension the spec
    names."""
    from unionml_tpu_torch.parallel.mesh import axis_index, axis_size

    size, index, group = axis_size(mesh, FSDP_AXIS), axis_index(mesh, FSDP_AXIS), mesh.get_group(FSDP_AXIS)
    shared: dict = {}
    at_rest = dict(tree)

    def split(key: Tuple[Any, ...], leaf: torch.Tensor, spec: Spec, gather: FsdpGather) -> Tuple[Any, Any]:
        """``(whole buffer, piece)``, or ``(leaf, leaf)`` for a leaf the spec keeps whole."""
        if not names_axis(spec, FSDP_AXIS):
            return leaf, leaf
        NamedSharding(mesh, _fsdp_only(spec)).shard(torch.empty(leaf.shape, device="meta"))
        whole = shared.setdefault(key + (tuple(leaf.shape), leaf.dtype), torch.empty_like(leaf))
        piece = leaf.reshape(-1).chunk(size)[index].clone()
        gather.pairs.append((piece, whole))
        return whole, piece

    for prefix, block in blocks:
        gather = FsdpGather(group)
        for name, leaf in tree.items():
            if not name.startswith(prefix + "."):
                continue
            owner_name, _, attr = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            suffix = name[len(prefix) + 1:]
            if isinstance(leaf, QuantizedArray):
                (owner.q, q), (owner.scale, scale) = (split((suffix, "q"), leaf.q, specs[name].q, gather),
                                                      split((suffix, "scale"), leaf.scale, specs[name].scale, gather))
                at_rest[name] = QuantizedArray(q=q, scale=scale, dtype=leaf.dtype)
                continue
            whole, piece = split((suffix,), leaf, specs[name], gather)
            if whole is not leaf:
                setattr(owner, attr, nn.Parameter(whole, requires_grad=False))
                at_rest[name] = piece
        block.fsdp = gather if gather.pairs else None
    return at_rest


def fully_shard_model(model: nn.Module, mesh: Any, blocks: Sequence[nn.Module]) -> nn.Module:
    """FSDP2 over ``mesh``'s ``fsdp`` axis (hybrid, replicated over
    data×sequence, when the mesh has either, :func:`~unionml_tpu_torch.parallel.mesh.fsdp_mesh`:
    a sequence rank's gradients are its chunks' part of the sum, which the
    all-reduce over the replicate dimension completes): each of ``blocks`` (the encoder or
    decoder layers) and then the root become one unit each, so a rank holds
    dimension 0's shard of every parameter and gathers one block's weights
    at a time. A sparse block's router and expert stacks are units of their
    own inside it (FSDP2 gathers one dtype per unit, and the stacks are in
    the compute dtype): a rank holds dimension 0's shard of its experts,
    and its ranks over ``fsdp`` hold the same experts of the ``expert``
    axis. In place; returns ``model``."""
    from torch.distributed.fsdp import fully_shard

    from unionml_tpu_torch.models.moe import MoEMlp

    group_mesh = fsdp_mesh(mesh)
    for block in blocks:
        for module in block.modules():
            if isinstance(module, MoEMlp):
                fully_shard(module.router, mesh=group_mesh)
                fully_shard(module, mesh=group_mesh)
        fully_shard(block, mesh=group_mesh)
    fully_shard(model, mesh=group_mesh)
    return model
