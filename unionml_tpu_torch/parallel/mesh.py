"""Device meshes and sharding specs over ``torch.distributed``.

Port of ``unionml_tpu/parallel/mesh.py``. The JAX package expresses
communication as ``PartitionSpec`` annotations over one controller's
``Mesh`` and lets XLA insert the collectives. The port is SPMD: one process
per card, a ``torch.distributed.device_mesh.DeviceMesh`` over the world
(:func:`make_mesh`), and each process holds only its shard of a sharded
tensor. :class:`Spec` is the ``PartitionSpec`` counterpart (one axis name,
a tuple of names, or ``None`` per tensor dimension) and
:class:`NamedSharding` binds one to a mesh; ``NamedSharding.shard`` cuts a
full tensor down to this rank's shard, which is what ``jax.device_put``
with that sharding lays on each device. The collectives themselves are
issued by the code that computes on the shards (the tensor-parallel GPT,
``models/gpt.py``).

Axis convention (used across models/, parallel/ and serving/):

- ``"data"`` — batch sharding (DP)
- ``"fsdp"`` — parameter sharding along the data axis (ZeRO-style)
- ``"tensor"`` — tensor parallelism within attention/MLP blocks
- ``"sequence"`` — sequence/context parallelism (ring attention)
- ``"expert"`` — expert parallelism (each rank holds ``1/N`` of a sparse
  block's experts; rows are not split over it, as in JAX's
  ``batch_sharding``)
"""

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "EXPERT_AXIS",
    "FSDP_AXIS",
    "SEQUENCE_AXIS",
    "TENSOR_AXIS",
    "MeshSpec",
    "NamedSharding",
    "Spec",
    "axis_group",
    "axis_index",
    "axis_names",
    "axis_size",
    "axes_group",
    "axes_index",
    "axes_order",
    "axes_size",
    "batch_axis_size",
    "batch_group",
    "batch_index",
    "batch_order",
    "batch_sharding",
    "fsdp_mesh",
    "logical_to_sharding",
    "make_hybrid_mesh",
    "make_mesh",
    "named_sharding_tree",
    "replicated",
    "sequence_index",
    "sequence_size",
    "shard_batch",
    "shard_sequence",
    "wrapped_row_indices",
]

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQUENCE_AXIS = "sequence"
EXPERT_AXIS = "expert"


class Spec(tuple):
    """``PartitionSpec`` counterpart: one entry per tensor dimension, each an
    axis name, a tuple of axis names, or ``None`` (not sharded). Trailing
    dimensions left out are not sharded. It compares equal to the tuple of
    its entries.

    ``parts`` > 1 marks a dimension that concatenates that many equal parts
    (the fused ``qkv`` projection's q, k and v): each part splits over the
    axis on its own, so a rank's shard holds its slice of every part. JAX's
    spec splits such a dimension contiguously and XLA reshards after the
    reshape; a rank of the port computes on its shard in place, so it needs
    its own heads of q, k and v."""

    def __new__(cls, *axes: Any, parts: int = 1) -> "Spec":
        spec = super().__new__(cls, axes)
        spec.parts = int(parts)
        return spec

    def __repr__(self) -> str:
        entries = ", ".join(repr(a) for a in self)
        return f"Spec({entries}{', parts=' + str(self.parts) if self.parts > 1 else ''})"

    def __reduce__(self):
        return (_spec, (tuple(self), self.parts))


def _spec(axes: Tuple[Any, ...], parts: int) -> Spec:
    return Spec(*axes, parts=parts)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape: ordered mapping of axis name -> size.

    A size of ``-1`` means "all remaining ranks" (at most one axis may use it).
    """

    axes: Tuple[Tuple[str, int], ...] = ((DATA_AXIS, -1),)

    @classmethod
    def from_dict(cls, axes: Mapping[str, int]) -> "MeshSpec":
        return cls(tuple(axes.items()))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    def resolve_shape(self, n_devices: int) -> Tuple[int, ...]:
        sizes = [size for _, size in self.axes]
        wildcards = [i for i, s in enumerate(sizes) if s == -1]
        if len(wildcards) > 1:
            raise ValueError(f"At most one mesh axis may be -1; got {self.axes}")
        fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
        if wildcards:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wildcards[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"Mesh axes {self.axes} require {fixed} devices; found {n_devices}")
        return tuple(sizes)

    def build(self, device="cuda"):
        return make_mesh(dict(self.axes), device=device)


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the torch.distributed world: call "
                           "unionml_tpu_torch.parallel.initialize_distributed first")
    return dist.get_world_size()


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None, device="cuda"):
    """A ``DeviceMesh`` over every rank of the world (one card each, or the
    CPU with ``device="cpu"``). ``axis_sizes=None`` is a 1-D data-parallel
    mesh. Ranks fill the mesh row-major, so the last axis joins neighbouring
    ranks (the cards of one host under torchrun)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world_size()
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: world}
    spec = MeshSpec.from_dict(axis_sizes)
    shape = spec.resolve_shape(world)
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=spec.axis_names)


def make_hybrid_mesh(ici_axes: Mapping[str, int], dcn_axes: Mapping[str, int], device="cuda"):
    """Multi-host mesh: ``dcn_axes`` span hosts, ``ici_axes`` the cards of
    one host (NVLink); an axis in both has the product of its extents, its
    host part varying slowest. torchrun numbers ranks host by host, so the
    host axes take the leading factors of the rank order."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(dict.fromkeys([*dcn_axes, *ici_axes]))
    ici_shape = [int(ici_axes.get(name, 1)) for name in names]
    dcn_shape = [int(dcn_axes.get(name, 1)) for name in names]
    total = [i * d for i, d in zip(ici_shape, dcn_shape)]
    world = _world_size()
    if int(np.prod(total)) != world:
        raise ValueError(f"Mesh axes {dict(zip(names, total))} require {int(np.prod(total))} devices; found {world}")
    ranks = torch.arange(world).reshape(dcn_shape + ici_shape)
    order = [i for k in range(len(names)) for i in (k, len(names) + k)]
    ranks = ranks.permute(order).reshape(total)
    return DeviceMesh(torch.device(device).type, ranks, mesh_dim_names=tuple(names))


def axis_names(mesh: Any) -> Tuple[str, ...]:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def axis_size(mesh: Any, name: str) -> int:
    """Ranks along ``name`` (1 when the mesh lacks the axis)."""
    names = axis_names(mesh)
    return int(mesh.size(names.index(name))) if name in names else 1


def axis_index(mesh: Any, name: str) -> int:
    """This rank's coordinate along ``name`` (0 when the mesh lacks it)."""
    return int(mesh.get_local_rank(name)) if name in axis_names(mesh) else 0


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`Spec` bound to a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec

    def shard(self, tensor: Any) -> Any:
        """This rank's shard of the full ``tensor`` (a torch tensor or a numpy
        array), contiguous. Raises ``ValueError`` when an axis does not
        divide its dimension, or when the spec names an axis the mesh lacks,
        as ``jax.device_put`` does."""
        names = axis_names(self.mesh)
        out = tensor
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            ways, index = 1, 0
            for axis in axes:
                if axis not in names:
                    raise ValueError(f"Resource axis: {axis} of {self.spec!r} is not found in mesh: {names}.")
                size = axis_size(self.mesh, axis)
                ways, index = ways * size, index * size + axis_index(self.mesh, axis)
            if ways == 1:
                continue
            shape = tuple(out.shape)
            parts = self.spec.parts
            if shape[dim] % ways or (shape[dim] // parts) % ways:
                sizes = {name: axis_size(self.mesh, name) for name in names}
                raise ValueError(
                    f"a tensor given the sharding {self.spec!r} over mesh axes {sizes} implies that the global "
                    f"size of its dimension {dim} should be divisible by {ways}"
                    f"{f' in each of its {parts} parts' if parts > 1 else ''}, but it is equal to {shape[dim]} "
                    f"(full shape: {shape})")
            part = shape[dim] // parts
            step = part // ways
            split = out.reshape(shape[:dim] + (parts, part) + shape[dim + 1:])
            split = split[(slice(None),) * (dim + 1) + (slice(index * step, (index + 1) * step),)]
            out = split.reshape(shape[:dim] + (parts * step,) + shape[dim + 1:])
        return out.contiguous() if torch.is_tensor(out) else np.ascontiguousarray(out)


def replicated(mesh: Any) -> NamedSharding:
    return NamedSharding(mesh, Spec())


def _batch_axes(mesh: Any, axis: str, sequence: bool = False) -> Tuple[str, ...]:
    names = axis_names(mesh)
    axes = (axis, FSDP_AXIS) if axis == DATA_AXIS else (axis,)
    if sequence:
        axes += (SEQUENCE_AXIS,)
    return tuple(a for a in axes if a in names)


def sequence_size(mesh: Any) -> int:
    """Ranks along the ``sequence`` axis (1 for ``None`` or a mesh without it)."""
    return axis_size(mesh, SEQUENCE_AXIS) if mesh is not None else 1


def sequence_index(mesh: Any) -> int:
    """This rank's chunk of the sequence: it holds positions ``[index * L,
    (index + 1) * L)`` of every row (0 for ``None`` or a mesh without the axis)."""
    return axis_index(mesh, SEQUENCE_AXIS) if mesh is not None else 0


def batch_sharding(mesh: Any, axis: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) dimension across ``axis`` (``data`` also
    spans ``fsdp`` when the mesh has it)."""
    present = _batch_axes(mesh, axis)
    return NamedSharding(mesh, Spec(present if len(present) > 1 else (present[0] if present else None)))


def batch_axis_size(mesh: Any, axis: str = DATA_AXIS, sequence: bool = False) -> int:
    """Ranks the leading (batch) dim is sharded over under :func:`batch_sharding`
    — the data×fsdp product when both axes are present; with ``sequence``,
    times the ``sequence`` axis (the ranks a train step's gradients and loss
    weights are reduced over)."""
    return axes_size(mesh, _batch_axes(mesh, axis, sequence))


def axis_group(mesh: Any, name: str) -> Any:
    """The process group of ``name`` through this rank (``None`` when the
    mesh lacks the axis or it spans one rank: nothing to exchange)."""
    return mesh.get_group(name) if axis_size(mesh, name) > 1 else None


#: (id(mesh), axes) -> (mesh, this rank's group over those axes, or for the
#: key ``("fsdp_mesh",)`` the mesh's :func:`fsdp_mesh`); the mesh is kept so
#: that its id is not reused while the entry stands
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, Any]] = {}


def _present(mesh: Any, axes: Tuple[str, ...]) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in axes if a in names)


def axes_size(mesh: Any, axes: Tuple[str, ...]) -> int:
    """Ranks over the product of ``axes`` (those the mesh lacks count 1)."""
    size = 1
    for a in _present(mesh, axes):
        size *= axis_size(mesh, a)
    return size


def axes_group(mesh: Any, axes: Tuple[str, ...]) -> Any:
    """The process group over the product of ``axes`` through this rank
    (``None`` when it spans one rank). A group over several axes is made
    once per mesh, by every rank of the world in the same order
    (``torch.distributed.new_group`` is collective), and kept in
    ``_GROUPS``. Its ranks are numbered in global-rank order, which is not
    :func:`axes_index`'s order on every mesh: a gather over it is put in
    that order by :func:`axes_order`."""
    axes = _present(mesh, axes)
    size = axes_size(mesh, axes)
    if size == 1:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = axis_names(mesh)
        dims = [names.index(a) for a in axes]
        others = [i for i in range(len(names)) if i not in dims]
        grid = mesh.mesh.permute(others + dims).reshape(-1, size)
        me, mine = dist.get_rank(), None
        for row in grid.tolist():
            group = dist.new_group([int(r) for r in row], backend=dist.get_backend())
            if me in row:
                mine = group
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


def axes_index(mesh: Any, axes: Tuple[str, ...]) -> int:
    """This rank's index over the product of ``axes``, row-major in the
    order ``axes`` lists them."""
    index = 0
    for a in _present(mesh, axes):
        index = index * axis_size(mesh, a) + axis_index(mesh, a)
    return index


def axes_order(mesh: Any, axes: Tuple[str, ...]) -> Optional[Tuple[int, ...]]:
    """Where each rank lands in a gather over :func:`axes_group`: entry
    ``b`` is the group rank of the rank whose :func:`axes_index` is ``b``,
    so ``gathered[order]`` is in that order. ``torch.distributed`` numbers a
    group's ranks by their global ranks, which follow the mesh's axis order
    (on ``{"sequence": 2, "data": 2}`` global rank 1 holds data×sequence
    index 2). ``None`` where the two orders agree, or the group spans one
    rank."""
    group = axes_group(mesh, axes)
    if group is None:
        return None
    names, axes = axis_names(mesh), _present(mesh, axes)
    order = [0] * axes_size(mesh, axes)
    for position, rank in enumerate(dist.get_process_group_ranks(group)):
        coords = (mesh.mesh == rank).nonzero()[0].tolist()
        index = 0
        for a in axes:
            index = index * axis_size(mesh, a) + coords[names.index(a)]
        order[index] = position
    return None if order == list(range(len(order))) else tuple(order)


def batch_group(mesh: Any, axis: str = DATA_AXIS, sequence: bool = False) -> Any:
    """The process group the batch is sharded over under :func:`batch_sharding`:
    ``data`` (or ``axis``) alone, or data×fsdp when the mesh has both; with
    ``sequence``, the group over data×fsdp×sequence (a sequence-parallel
    step's gradients are each rank's part of the sum over its chunks).
    ``None`` when it spans one rank (:func:`axes_group`; a gather over it is
    put in batch order by :func:`batch_order`)."""
    return axes_group(mesh, _batch_axes(mesh, axis, sequence))


def batch_index(mesh: Any, axis: str = DATA_AXIS, sequence: bool = False) -> int:
    """This rank's shard of the batch under :func:`batch_sharding` (row-major
    over data×fsdp, as ``NamedSharding.shard`` cuts it); with ``sequence``,
    its index over data×fsdp×sequence (the chunk varying fastest)."""
    return axes_index(mesh, _batch_axes(mesh, axis, sequence))


def batch_order(mesh: Any, axis: str = DATA_AXIS, sequence: bool = False) -> Optional[Tuple[int, ...]]:
    """Where each shard of the batch lands in a gather over
    :func:`batch_group` (:func:`axes_order`): the batch's order is data,
    fsdp, sequence whatever the mesh lists first."""
    return axes_order(mesh, _batch_axes(mesh, axis, sequence))


def fsdp_mesh(mesh: Any) -> Any:
    """The ``DeviceMesh`` FSDP2 shards parameters over: the ``fsdp`` axis
    alone, or, when the mesh has a ``data`` or ``sequence`` axis too, a 2-D
    (replicate, fsdp) mesh, which FSDP2 takes as hybrid sharding: the
    gradients reduce-scattered over ``fsdp`` and all-reduced over the
    replicate dimension, data×sequence (the ranks that hold other rows, or
    other chunks of the same rows), whatever the axes' order. The 2-D mesh
    is a new ``DeviceMesh`` over the same ranks, made once per mesh by every
    rank of the world in the same order (its groups are made collectively)."""
    names = axis_names(mesh)
    if FSDP_AXIS not in names:
        raise ValueError(f"mesh axes {names} have no {FSDP_AXIS!r} axis")
    replicate = [a for a in (DATA_AXIS, SEQUENCE_AXIS) if a in names]
    if not replicate:
        return mesh[FSDP_AXIS]
    key = (id(mesh), ("fsdp_mesh",))
    if key not in _GROUPS:
        from torch.distributed.device_mesh import DeviceMesh

        dims = [names.index(a) for a in replicate] + [names.index(FSDP_AXIS)]
        others = [i for i in range(len(names)) if i not in dims]
        rest = int(np.prod([mesh.size(i) for i in others])) if others else 1
        ranks = mesh.mesh.permute(others + dims).reshape(rest, -1, axis_size(mesh, FSDP_AXIS))
        whole = DeviceMesh(mesh.device_type, ranks, mesh_dim_names=("rest", "replicate", FSDP_AXIS))
        _GROUPS[key] = (mesh, whole["replicate", FSDP_AXIS])
    return _GROUPS[key][1]


def wrapped_row_indices(n_rows: int, multiple: int):
    """Row indices that wrap-fill ``n_rows`` up to a multiple of ``multiple``.

    Returns ``None`` when already aligned. The fill repeats REAL rows
    (wrap-around) instead of fabricating zero rows, so a ragged batch rescued
    onto a mesh never trains or evaluates on fake data."""
    if multiple <= 1 or n_rows % multiple == 0:
        return None
    target = ((n_rows // multiple) + 1) * multiple
    return np.resize(np.arange(n_rows), target)


def _tree_map(fn: Callable[..., Any], tree: Any, *rest: Any, is_leaf: Callable[[Any], bool] = lambda x: False) -> Any:
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
            return type(tree)(_tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf) for i, v in enumerate(tree))
    return fn(tree, *rest)


def shard_batch(batch: Any, mesh: Any, axis: str = DATA_AXIS) -> Any:
    """This rank's rows of a host batch (a tree of tensors or numpy arrays),
    sharded along the leading dim: what ``jax.device_put`` with
    :func:`batch_sharding` lays on this rank's device."""
    sharding = batch_sharding(mesh, axis)
    return _tree_map(sharding.shard, batch)


def shard_sequence(batch: Any, mesh: Any) -> Any:
    """This rank's chunk of the sequence (dimension 1) of every array in a
    tree of token arrays ``(rows, seq, ...)``: positions ``[r * L, (r + 1) *
    L)`` at :func:`sequence_index` r, as ``jax.device_put`` with ``Spec(None,
    "sequence")`` lays them. Raises ``ValueError`` when the axis does not
    divide the sequence."""
    sharding = NamedSharding(mesh, Spec(None, SEQUENCE_AXIS)) if SEQUENCE_AXIS in axis_names(mesh) else None
    return batch if sharding is None else _tree_map(sharding.shard, batch)


def logical_to_sharding(mesh: Any, *spec: Any) -> NamedSharding:
    """``Spec(*spec)`` bound to ``mesh``, dropping absent axes."""
    names = axis_names(mesh)
    return NamedSharding(mesh, Spec(*(s if (s is None or s in names) else None for s in spec)))


def named_sharding_tree(mesh: Any, spec_tree: Any) -> Any:
    """Bind a :class:`Spec` tree to ``mesh`` as a matching
    :class:`NamedSharding` tree (``param_shardings`` tables produce spec
    trees; the engine binds them here)."""
    return _tree_map(lambda spec: NamedSharding(mesh, spec), spec_tree, is_leaf=lambda x: isinstance(x, Spec))

