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
"""

from typing import Optional

import torch

from unionml_tpu_torch.models._layers import SequenceParallel
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
) -> torch.Tensor:
    """Sequence-parallel attention by head/sequence all-to-all re-sharding.

    ``q``, ``k``, ``v`` are THIS rank's chunk ``(batch rows, heads, L,
    head_dim)`` of the sequence; ``heads`` must be divisible by the axis
    size. ``kv_lens`` ``(batch rows,)`` are the whole rows' valid lengths
    (right padding). The local heads attend through
    :func:`~unionml_tpu_torch.ops.attention.attention` (the kernels on CUDA
    tensors). Returns this rank's output chunk; every rank of the axis calls
    it together."""
    del batch_axis
    size = axis_size(mesh, seq_axis)
    heads = q.shape[1]
    if heads % size:
        raise ValueError(
            f"ulysses_attention requires heads ({heads}) divisible by the {seq_axis!r} "
            f"axis size ({size}); use ring_attention otherwise."
        )
    sp = SequenceParallel.of(mesh, seq_axis)
    if sp.size > 1:
        batch = q.shape[0]
        q, k, v = sp.to_heads(torch.cat([q, k, v])).split(batch)
    out = attention(q, k, v, kv_lens=kv_lens, causal=causal, sm_scale=sm_scale)
    return sp.to_sequence(out)
