"""Ring attention: sequence (context) parallelism over the mesh's ``sequence`` axis.

Port of ``unionml_tpu/parallel/ring.py``. Sequence rank r of N holds
positions ``[r * L, (r + 1) * L)`` of every row (JAX's contiguous chunks,
:func:`sequence_sharding`): its query chunk stays put while the key/value
chunks travel one hop around the ring per step, so no rank ever holds more
than one visiting block. At step t rank r folds the block of rank ``src = (r
- t) mod N``:

- ``src < r``: a full block, K1 (``ops/attention.py::_flash_forward``)
  without the causal mask;
- ``src == r``: the diagonal block, K1 causal (when the call is);
- ``src > r`` under causal: every key lies ahead of every query, so the
  block is skipped and nothing is launched.

A block's ``kv_lens`` is ``clamp(kv_lens - src * L, 0, L)`` (right padding
of the whole row). K1 returns each block's output, already normalised, and
its f32 logsumexp; the blocks merge in f32 under a running logsumexp and the
output is cast once at the end. A row that sees no key in a block gets
zeros and an lse of -1e30 from K1, and takes no weight in the merge (the
guard of JAX's ``ring.py:50-55``), so a row that sees no key at all writes
zeros.

The backward is a second pass around the ring (JAX differentiates its
``scan`` of ``ppermute``s; PyTorch has no transpose of a send): each block
runs K2 and K3 (:func:`~unionml_tpu_torch.ops.attention.flash_attention_backward`)
with the MERGED output and logsumexp, so ``delta = rowsum(dO * O)`` and ``P =
exp(S - lse)`` are the whole row's. dQ sums on its rank in f32; the f32 dK
and dV accumulators travel with their K/V block and arrive back on the rank
that owns it after one last hop. Skipped blocks are skipped in the backward
too.

The schedule, the merge and the backward run over an exchange: in use,
point-to-point sends over the axis's process group (:class:`_GroupRing`,
``SequenceParallel.shift``); for tests in one process, a rotation over N
chunks held in a list (:class:`_LocalRing`, :func:`_in_process_ring_attention`),
the same code otherwise. On CPU tensors each block's K1/K2/K3 call runs its
plain version. :func:`reference_ring_attention` is the plain f32 fold of the
JAX package (``_local_block_attention``), in one process over N chunks.
"""

from typing import List, Optional, Sequence, Tuple

import torch

from unionml_tpu_torch.models._layers import SequenceParallel
from unionml_tpu_torch.ops.attention import _flash_backward, _flash_forward
from unionml_tpu_torch.parallel.mesh import DATA_AXIS, SEQUENCE_AXIS, NamedSharding, Spec, axis_names

__all__ = ["reference_ring_attention", "ring_attention", "sequence_sharding"]

_NEG_INF = -1e30


def _local_block_attention(q, k_blk, v_blk, acc, row_max, row_sum, q_offset, k_offset, causal, sm_scale,
                           kv_lens=None):
    """Fold one visiting K/V block into the f32 online-softmax accumulator
    (``ring.py:31-62``): q ``(b, h, Lq, d)``, the block ``(b, h, Lk, d)`` at
    global offsets ``q_offset``/``k_offset``; ``kv_lens`` ``(b,)`` right
    padding of the whole row."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_blk.float()) * sm_scale
    k_pos = k_offset + torch.arange(scores.shape[-1], device=q.device)
    masked = torch.full_like(scores, _NEG_INF)
    if kv_lens is not None:
        scores = torch.where(k_pos < kv_lens.to(q.device)[:, None, None, None], scores, masked)
    if causal:
        q_pos = q_offset + torch.arange(scores.shape[-2], device=q.device)
        scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores, masked)
    new_max = torch.maximum(row_max, scores.amax(dim=-1, keepdim=True))
    correction = torch.exp(row_max - new_max)
    # a row whose every score so far is masked keeps new_max == -1e30: it
    # takes no probability mass until a visible key arrives
    probs = torch.where(new_max > _NEG_INF / 2, torch.exp(scores - new_max), torch.zeros_like(scores))
    acc = acc * correction + torch.einsum("bhqk,bhkd->bhqd", probs, v_blk.float())
    row_sum = row_sum * correction + probs.sum(dim=-1, keepdim=True)
    return acc, new_max, row_sum


def reference_ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                             kv_lens: Optional[torch.Tensor] = None, causal: bool = False,
                             sm_scale: Optional[float] = None) -> List[torch.Tensor]:
    """The plain version of the ring: JAX's f32 fold (every block folded,
    masks and all) run for each of the N chunks ``qs[r]``, ``ks[r]``,
    ``vs[r]`` in one process; returns each rank's output in q's dtype.
    Differentiable by autograd."""
    n, local = len(qs), qs[0].shape[-2]
    scale = sm_scale if sm_scale is not None else qs[0].shape[-1] ** -0.5
    outs = []
    for r, q in enumerate(qs):
        acc = torch.zeros(q.shape[:-1] + (vs[0].shape[-1],), dtype=torch.float32, device=q.device)
        row_max = torch.full(q.shape[:-1] + (1,), _NEG_INF, dtype=torch.float32, device=q.device)
        row_sum = torch.zeros_like(row_max)
        for t in range(n):
            src = (r - t) % n
            acc, row_max, row_sum = _local_block_attention(q, ks[src], vs[src], acc, row_max, row_sum, r * local,
                                                           src * local, causal, scale, kv_lens)
        outs.append((acc / torch.clamp(row_sum, min=1e-30)).to(q.dtype))
    return outs


class _GroupRing:
    """The exchange over the ``sequence`` axis's process group: this
    process is one rank of the ring."""

    def __init__(self, sp: SequenceParallel) -> None:
        self.sp, self.size, self.ranks = sp, sp.size, (sp.index,)

    def shift(self, blocks: List[Tuple[torch.Tensor, ...]]) -> List[Tuple[torch.Tensor, ...]]:
        return [self.sp.shift(blocks[0])]


class _LocalRing:
    """The exchange of N ranks held in one process (tests): rank i receives
    what rank i - 1 sends."""

    def __init__(self, size: int) -> None:
        self.size, self.ranks = size, tuple(range(size))

    def shift(self, blocks: List[Tuple[torch.Tensor, ...]]) -> List[Tuple[torch.Tensor, ...]]:
        return [blocks[(i - 1) % self.size] for i in range(self.size)]


def _block_lens(kv_lens: Optional[torch.Tensor], src: int, local: int) -> Optional[torch.Tensor]:
    """The right-padding lengths of the block of rank ``src``."""
    return None if kv_lens is None else torch.clamp(kv_lens - src * local, 0, local).to(torch.int32)


def _visits(ring, causal: bool):
    """``(step, slot, rank, src)`` of every block folded, in order: step t,
    local rank ``rank`` (at ``slot``) folds the block of rank ``src``."""
    for t in range(ring.size):
        for slot, r in enumerate(ring.ranks):
            src = (r - t) % ring.size
            if not (causal and src > r):
                yield t, slot, r, src


def _merge(out: Optional[torch.Tensor], lse: Optional[torch.Tensor], out_b: torch.Tensor, lse_b: torch.Tensor):
    """The running (output, logsumexp) with a block's, in f32. The first
    block is taken as it is (one block is K1's output bit for bit). A side
    whose lse is -1e30 (no key seen) takes no weight; a row with none on
    either side keeps zeros and -1e30."""
    if out is None:
        return out_b, lse_b
    top = torch.maximum(lse, lse_b)
    w = torch.where(lse > _NEG_INF / 2, torch.exp(lse - top), torch.zeros_like(lse))
    w_b = torch.where(lse_b > _NEG_INF / 2, torch.exp(lse_b - top), torch.zeros_like(lse_b))
    total = w + w_b
    seen = total > 0
    merged = (out.float() * w[..., None] + out_b.float() * w_b[..., None]) / torch.where(
        seen, total, torch.ones_like(total))[..., None]
    return merged, torch.where(seen, top + torch.log(torch.where(seen, total, torch.ones_like(total))),
                               torch.full_like(top, _NEG_INF))


def _add(acc: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``acc + x`` in f32 (the first addend as it is)."""
    return x if acc is None else acc.float() + x.float()


def _ring_forward(ring, qs, ks, vs, lens, causal: bool, scale: float):
    local = qs[0].shape[-2]
    outs, lses = [None] * len(qs), [None] * len(qs)
    blocks = [(k, v) for k, v in zip(ks, vs)]
    step = 0
    for t, slot, r, src in _visits(ring, causal):
        while step < t:  # every local rank has folded step `step`: the blocks move on
            blocks, step = ring.shift(blocks), step + 1
        k, v = blocks[slot]
        out_b, lse_b, _ = _flash_forward(qs[slot], k, v, _block_lens(lens[slot], src, local), causal and src == r,
                                         scale, return_lse=True)
        outs[slot], lses[slot] = _merge(outs[slot], lses[slot], out_b, lse_b)
    while step < ring.size - 1:  # under causal a rank's last steps fold nothing, but its blocks pass on
        blocks, step = ring.shift(blocks), step + 1
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def _ring_backward(ring, qs, ks, vs, outs, lses, d_outs, lens, causal: bool, scale: float):
    local = qs[0].shape[-2]
    dqs = [None] * len(qs)
    # each local rank's visiting block: its K, V and the dK, dV summed for it so far
    blocks = [(k, v, None, None) for k, v in zip(ks, vs)]
    step = 0

    def moved(blocks):
        return ring.shift([(k, v, dk.float(), dv.float()) for k, v, dk, dv in blocks])

    for t, slot, r, src in _visits(ring, causal):
        while step < t:
            blocks, step = moved(blocks), step + 1
        k, v, dk, dv = blocks[slot]
        dq_b, dk_b, dv_b = _flash_backward(qs[slot], k, v, outs[slot], lses[slot], d_outs[slot],
                                           _block_lens(lens[slot], src, local), causal and src == r, scale, None)
        dqs[slot] = _add(dqs[slot], dq_b)
        blocks[slot] = (k, v, _add(dk, dk_b), _add(dv, dv_b))
    while step < ring.size - 1:
        blocks, step = moved(blocks), step + 1
    home = [(dk, dv) for _, _, dk, dv in blocks]
    if ring.size > 1:  # the last hop brings each block's dK, dV to the rank that owns it
        home = ring.shift([(dk.float(), dv.float()) for dk, dv in home])
    dks = [dk.to(k.dtype) for (dk, _), k in zip(home, ks)]
    dvs = [dv.to(v.dtype) for (_, dv), v in zip(home, vs)]
    return [dq.to(q.dtype) for dq, q in zip(dqs, qs)], dks, dvs


class _RingAttention(torch.autograd.Function):
    """The kernel arm: K1 per block under one merged lse forward, K2/K3 per
    block backward (see the module docstring). Takes the q chunks, then the
    k chunks, then the v chunks of the ring's local ranks."""

    @staticmethod
    def forward(ctx, ring, lens, causal: bool, scale: float, *qkv):
        n = len(ring.ranks)
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        outs, lses = _ring_forward(ring, qs, ks, vs, lens, causal, scale)
        ctx.save_for_backward(*qkv, *outs, *lses)
        ctx.ring, ctx.lens, ctx.causal, ctx.scale = ring, lens, causal, scale
        for lse in lses:
            ctx.mark_non_differentiable(lse)
        return (*outs, *lses)

    @staticmethod
    def backward(ctx, *grads):
        n = len(ctx.ring.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        dqs, dks, dvs = _ring_backward(ctx.ring, qs, ks, vs, outs, lses, grads[:n], ctx.lens, ctx.causal, ctx.scale)
        return (None, None, None, None, *dqs, *dks, *dvs)


def _ring_apply(ring, qs, ks, vs, lens, causal: bool, sm_scale: Optional[float]) -> List[torch.Tensor]:
    scale = float(sm_scale) if sm_scale is not None else qs[0].shape[-1] ** -0.5
    out = _RingAttention.apply(ring, list(lens), bool(causal), scale, *qs, *ks, *vs)
    return list(out[:len(qs)])


def ring_attention(
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
    """Sequence-parallel attention over ``mesh``'s ``seq_axis``.

    ``q``, ``k``, ``v`` are THIS rank's chunk ``(batch rows, heads, L,
    head_dim)`` of the sequence (positions ``[r * L, (r + 1) * L)``, the
    layout of :func:`sequence_sharding`); returns this rank's output chunk.
    ``kv_lens`` ``(batch rows,)`` are the whole rows' valid lengths (right
    padding). ``batch_axis`` names the axis the rows are split over (each
    rank passes its own rows; kept for the JAX signature). Every rank of the
    axis calls it together."""
    del batch_axis
    ring = _GroupRing(SequenceParallel.of(mesh, seq_axis))
    return _ring_apply(ring, [q], [k], [v], [kv_lens], causal, sm_scale)[0]


def _in_process_ring_attention(qs, ks, vs, kv_lens=None, causal: bool = False,
                               sm_scale: Optional[float] = None) -> List[torch.Tensor]:
    """The kernel arm over N chunks held in this process (a test seam: the
    ring's schedule, merge and backward without N processes); each rank's
    output, differentiable."""
    return _ring_apply(_LocalRing(len(qs)), qs, ks, vs, [kv_lens] * len(qs), causal, sm_scale)


def sequence_sharding(mesh, batch_axis: str = DATA_AXIS, seq_axis: str = SEQUENCE_AXIS) -> NamedSharding:
    """Sharding of ``(batch, heads, seq, head_dim)`` activations in the ring
    layout (``ring.py:143-151``): rows over ``batch_axis`` where the mesh has
    it, the sequence over ``seq_axis``."""
    batch = batch_axis if batch_axis in axis_names(mesh) else None
    return NamedSharding(mesh, Spec(batch, None, seq_axis, None))
