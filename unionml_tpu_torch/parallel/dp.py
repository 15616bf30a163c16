"""Data-parallel steps and batches over a ``torch.distributed`` mesh.

Port of ``unionml_tpu/parallel/dp.py``. The JAX package jits a step with the
batch sharded over the ``data`` axis and lets XLA insert the ``psum`` its
replicated outputs imply. The port is SPMD: every rank runs the step on its
rows of the batch, and the outputs are averaged over the batch's ranks
(data×fsdp) by an explicit all-reduce, so each rank holds the mesh's result.

The canonical usage::

    step = data_parallel_step(train_step, mesh)   # once, outside the loop
    for batch in batches(X, y, batch_size=bs, mesh=mesh):
        state, metrics = step(state, batch)        # this rank's rows

The port's own train steps reduce their gradients themselves: pass
``mesh=``/``param_spec=`` to ``make_classifier_train_step`` or ``fit``
(``models/training.py``) rather than wrapping them here.
"""

from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree

from unionml_tpu_torch.parallel.mesh import DATA_AXIS, batch_axis_size, batch_group, make_mesh, shard_batch

__all__ = ["batches", "data_parallel_eval", "data_parallel_step", "pad_to_multiple"]


def _as_tensor(leaf: Any) -> Any:
    return torch.from_numpy(np.ascontiguousarray(leaf)) if isinstance(leaf, np.ndarray) else leaf


def _mesh_mean(tree: Any, mesh: Any, batch_axis: str) -> Any:
    """Every floating tensor of ``tree`` averaged over the batch's ranks
    (other leaves as they are): the replicated output of the JAX step."""
    group = batch_group(mesh, batch_axis)
    if group is None:
        return tree
    n = batch_axis_size(mesh, batch_axis)

    def mean(leaf: Any) -> Any:
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            return leaf
        out = leaf.detach().clone()
        dist.all_reduce(out, group=group)
        return out / n

    return _pytree.tree_map(mean, tree)


def _local(batch: Any, mesh: Any, batch_axis: str) -> Any:
    """This rank's rows of a host batch (numpy leaves become tensors)."""
    return _pytree.tree_map(_as_tensor, shard_batch(batch, mesh, batch_axis))


def data_parallel_step(
    step_fn: Callable,
    mesh: Optional[Any] = None,
    *,
    batch_axis: str = DATA_AXIS,
    donate_state: bool = True,
) -> Callable:
    """``step_fn(state, batch) -> (state, aux)`` run data-parallel
    (``dp.py:30-52``): ``batch`` is the global host batch, and each rank
    runs ``step_fn`` on its rows of it (sharded along the leading dimension;
    an axis that does not divide it raises ``ValueError``, as JAX's layout
    does). Every floating tensor of the returned ``(state, aux)`` is the mean
    over the batch's ranks, so a rank's outputs are the mesh's: for a step
    linear in a mean loss over its rows (a gradient step, the loss itself)
    that is the full batch's value. ``state`` should be replicated.

    ``donate_state`` is accepted for the JAX signature and does nothing:
    eager PyTorch has no buffer donation (a step that updates its state in
    place already reuses its memory)."""
    mesh = mesh or make_mesh()

    def step(state: Any, batch: Any) -> Any:
        return _mesh_mean(step_fn(state, _local(batch, mesh, batch_axis)), mesh, batch_axis)

    return step


def data_parallel_eval(
    eval_fn: Callable,
    mesh: Optional[Any] = None,
    *,
    batch_axis: str = DATA_AXIS,
) -> Callable:
    """``eval_fn(state, batch) -> metrics`` on each rank's rows of the global
    batch, the metrics averaged over the batch's ranks (``dp.py:55-66``)."""
    mesh = mesh or make_mesh()

    def evaluate(state: Any, batch: Any) -> Any:
        with torch.no_grad():
            return _mesh_mean(eval_fn(state, _local(batch, mesh, batch_axis)), mesh, batch_axis)

    return evaluate


def batches(
    *arrays: Any,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    drop_remainder: bool = True,
    mesh: Optional[Any] = None,
) -> Iterator[Any]:
    """Host-side batch iterator (``dp.py:69-104``): with a ``mesh``, each
    batch is this rank's rows of the global batch as tensors (a ragged batch
    wraps real rows up to a multiple of the batch's ranks first), as the JAX
    package lays each batch onto the mesh. ``drop_remainder`` keeps shapes
    static; a dataset smaller than one batch yields its one short batch."""
    from unionml_tpu_torch.models.training import rank_rows

    host_arrays = tuple(np.asarray(a) for a in arrays)  # one host copy, not one per batch
    n_rows = host_arrays[0].shape[0]
    indices = np.arange(n_rows) if rng is None else rng.permutation(n_rows)
    end = (n_rows // batch_size) * batch_size if drop_remainder else n_rows
    if end == 0:
        end = n_rows  # degenerate tiny datasets: yield one short batch
    rows = rank_rows(mesh) if mesh is not None else None
    for start in range(0, end, batch_size):
        batch_idx = indices[start:start + batch_size]
        if rows is not None:
            batch_idx = rows(batch_idx)
        batch = tuple(a[batch_idx] for a in host_arrays)
        if mesh is not None:
            batch = tuple(_as_tensor(b) for b in batch)
        yield batch if len(batch) > 1 else batch[0]


def pad_to_multiple(array: Any, multiple: int, axis: int = 0, pad_value: float = 0.0) -> Tuple[Any, int]:
    """Pad ``axis`` up to a multiple of ``multiple``; returns ``(padded,
    original_len)`` (``dp.py:107-122``). A tensor pads as a tensor, anything
    else as a numpy array."""
    if not isinstance(array, torch.Tensor):
        array = np.asarray(array)
    length = array.shape[axis]
    remainder = length % multiple
    if remainder == 0:
        return array, length
    if isinstance(array, torch.Tensor):
        pad = [0, 0] * (array.ndim - axis - 1) + [0, multiple - remainder]
        return torch.nn.functional.pad(array, pad, value=pad_value), length
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, multiple - remainder)
    return np.pad(array, pad_width, constant_values=pad_value), length
