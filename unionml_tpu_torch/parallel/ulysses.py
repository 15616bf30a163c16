"""Ulysses sequence parallelism: all-to-all head/sequence re-sharding.

Port of ``unionml_tpu/parallel/ulysses.py``, the second long-context
strategy beside :mod:`~unionml_tpu_torch.parallel.ring`. Each rank arrives
with its chunk of the sequence for every head; one all-to-all over the
``sequence`` axis turns that into the whole sequence for ``heads / N`` heads
(:meth:`~unionml_tpu_torch.models._layers.SequenceParallel.to_heads`, q, k
and v in one exchange), attention runs unmodified on those heads
(:func:`~unionml_tpu_torch.ops.attention.attention` with the rows'
``kv_lens``: K1 forward and K2/K3 backward on the card, the plain version on
the CPU), and a second all-to-all restores the sequence chunks. The
exchanges are differentiable: each one's backward is the other.

Trade-off against the ring: two all-to-alls of the full activations, and
O(seq) activation memory per rank for its heads, where the ring keeps O(seq
/ N). The axis size must divide the head count.

Beside a ``tensor`` axis (``tensor_axis=``, a Megatron-split model: each
rank arrives with its ``H / T`` heads) the exchange runs over the rank's
heads, each sequence rank attending over ``(H / T) / N`` of them. JAX's
``shard_map`` replicates the heads over ``tensor`` and checks ``H % N``
over all of them, so where N divides ``H`` but not ``H / T`` the chunk's
heads are first gathered over the tensor axis (every tensor rank of the
chunk then attends over ``H / N`` heads, the same ones) and each rank keeps
its own heads of the output; the gather's backward hands each rank the
gradient of its own heads, the only ones its output reached.
"""

from typing import Optional

import torch

from unionml_tpu_torch.models._layers import AxisGroup, SequenceParallel
from unionml_tpu_torch.ops.attention import attention
from unionml_tpu_torch.parallel.mesh import DATA_AXIS, SEQUENCE_AXIS, axis_size

__all__ = ["ulysses_attention"]


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    seq_axis: str = SEQUENCE_AXIS,
    batch_axis: str = DATA_AXIS,
    tensor_axis: Optional[str] = None,
) -> torch.Tensor:
    """Sequence-parallel attention by head/sequence all-to-all re-sharding.

    ``q``, ``k``, ``v`` are THIS rank's chunk ``(batch rows, heads, L,
    head_dim)`` of the sequence; the model's heads must be divisible by the
    axis size. ``kv_lens`` ``(batch rows,)`` are the whole rows' valid
    lengths (right padding). The local heads attend through
    :func:`~unionml_tpu_torch.ops.attention.attention` (the kernels on CUDA
    tensors). ``tensor_axis`` names the mesh axis the model's heads are
    split over (``heads`` is then this rank's share; see the module
    docstring). Returns this rank's output chunk; every rank of the axis
    calls it together."""
    del batch_axis
    size = axis_size(mesh, seq_axis)
    tp = AxisGroup.of(mesh, tensor_axis)  # one rank where tensor_axis is None
    local = q.shape[1]
    heads = local * tp.size
    if heads % size:
        raise ValueError(
            f"ulysses_attention requires heads ({heads}) divisible by the {seq_axis!r} "
            f"axis size ({size}); use ring_attention otherwise."
        )
    sp = SequenceParallel.of(mesh, seq_axis)
    gather = tp.size > 1 and local % size != 0
    if gather:  # the chunk's heads of every tensor rank, in head order
        q, k, v = (tp.gather(x.transpose(0, 1)).transpose(0, 1) for x in (q, k, v))
    if sp.size > 1:
        batch = q.shape[0]
        q, k, v = sp.to_heads(torch.cat([q, k, v])).split(batch)
    out = sp.to_sequence(attention(q, k, v, kv_lens=kv_lens, causal=causal, sm_scale=sm_scale))
    return out[:, tp.index * local:(tp.index + 1) * local] if gather else out
