"""Attention ops: the K1 flash-forward and K2/K3 flash-backward CUDA kernels,
and their plain PyTorch versions.

Port of ``unionml_tpu/ops/attention.py``. Shapes follow the (batch, heads,
seq, head_dim) convention of the JAX package.

- :func:`reference_attention` — the plain version, with the semantics of the
  JAX ``xla_attention`` (``attention.py:45-80``): f32 scores, optional dense
  boolean mask, causal (top-left aligned) masking and packed ``segment_ids``,
  f32 softmax, weights cast to ``v``'s dtype for the value product. A row that
  sees no key at all writes zeros, as the flash kernels do.
- :func:`flash_attention` — K1 (``csrc/flash_fwd.cu``, replacing the Pallas
  ``_flash_kernel``). On CUDA tensors it launches the kernel or raises; on CPU
  tensors it runs :func:`reference_attention`. Causal, ``kv_lens``
  (right-padding) and ``segment_ids`` (packing) masks, any ``Sq``/``Sk``, bf16
  (the tensor-core body; q, k, v 16-byte aligned) or f32 (the CUDA-core body),
  head_dim 64 or 128. When grad mode is on and q, k or v requires grad
  it runs through :class:`_FlashAttention`, whose backward is
  :func:`flash_attention_backward`.
- :func:`flash_attention_backward` — K2 (dQ) then K3 (dK/dV)
  (``csrc/flash_bwd.cu``, replacing the Pallas ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``; bf16 runs the tensor-core bodies, with q, k, v and
  d_out 16-byte aligned, f32 the CUDA-core ones) on CUDA tensors,
  :func:`reference_attention_backward` on CPU tensors. Unlike the JAX
  package, which differentiates ``xla_attention`` for shapes that are not
  tile-aligned, the kernels mask ragged tiles.
- :func:`attention` — the dispatcher the model calls: ``impl="auto"`` runs the
  kernel for CUDA tensors without a dense mask and the plain version
  otherwise; ``"kernel"`` and ``"reference"`` force one side. The port keeps
  no measured dispatch table yet.

Packed ``segment_ids`` (batch, S_ids) follow the t5x convention: 0 is
padding, and a query attends a key iff both carry the same positive id. Ids
are sliced per axis (``ids[:, :Sq]`` for queries, ``ids[:, :Sk]`` for keys),
so cross-length calls take one array. The kernels get the per-row
``kv_len`` (last nonzero key id + 1) and :func:`_segment_ranges`, the skip
map: for each position, the range on the other axis that its id occupies.
Each kernel reduces the ranges over its own tile, so the map does not depend
on tile sizes; the bf16 bodies also take a work order after it
(:func:`_work_order`). A differentiable call builds the map once: the
backward reuses K1's (:func:`_backward_maps`).
"""

from typing import Optional, Tuple, Union

import torch

from unionml_tpu_torch import kernels
from unionml_tpu_torch.kernels import _build

__all__ = [
    "attention",
    "flash_attention",
    "flash_attention_backward",
    "reference_attention",
    "reference_attention_backward",
]

_NEG_INF = -1e30


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the plain versions' compute dtype: float32 (float64 inputs
    stay float64, so ``torch.autograd.gradcheck`` can run in double)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _kv_lens_to_mask(kv_lens: torch.Tensor, seq_k: int) -> torch.Tensor:
    """(batch,) valid lengths -> (batch, 1, 1, seq_k) boolean padding mask."""
    positions = torch.arange(seq_k, device=kv_lens.device)[None, :]
    return (positions < kv_lens[:, None])[:, None, None, :]


def _segment_mask(segment_ids: torch.Tensor, seq_q: int, seq_k: int) -> torch.Tensor:
    """(batch, S_ids) packed ids -> (batch, 1, Sq, Sk) mask: same positive id."""
    ids_q, ids_k = segment_ids[:, :seq_q], segment_ids[:, :seq_k]
    same = ids_q[:, :, None] == ids_k[:, None, :]
    return (same & (ids_q > 0)[:, :, None] & (ids_k > 0)[:, None, :])[:, None]


def _combined_mask(mask, kv_lens, segment_ids, seq_q: int, seq_k: int):
    """The dense mask, the ``kv_lens`` mask and the segment mask, and-ed (or None)."""
    parts = [m for m in (
        mask,
        _kv_lens_to_mask(kv_lens, seq_k) if kv_lens is not None else None,
        _segment_mask(segment_ids, seq_q, seq_k) if segment_ids is not None else None,
    ) if m is not None]
    if not parts:
        return None
    out = parts[0]
    for part in parts[1:]:
        out = out & part
    return out


def _valid(mask, causal, seq_q, seq_k, device) -> torch.Tensor:
    """Boolean keep mask broadcastable to (batch, heads, Sq, Sk)."""
    valid = torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    valid = (torch.tril(valid) if causal else valid)[None, None]
    return valid & mask if mask is not None else valid


def _masked_logits(q, k, mask, causal, scale):
    """Scaled scores in the compute dtype with masked keys at -1e30, and the keep mask."""
    logits = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) * scale
    valid = _valid(mask, causal, logits.shape[-2], logits.shape[-1], q.device)
    return torch.where(valid, logits, torch.full_like(logits, _NEG_INF)), valid


def _check_no_kv_lens(kv_lens, segment_ids) -> None:
    if segment_ids is not None and kv_lens is not None:
        raise ValueError("segment_ids already encodes padding; pass kv_lens=None")


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain softmax(q k^T) v with the JAX ``xla_attention`` arithmetic.

    ``mask`` broadcasts against ``(batch, heads, Sq, Sk)``; True keeps a key.
    ``segment_ids`` (batch, S_ids >= max(Sq, Sk)) adds the packed-sequence mask.
    """
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    mask = _combined_mask(mask, None, segment_ids, q.shape[-2], k.shape[-2])
    logits, valid = _masked_logits(q, k, mask, causal, scale)
    weights = torch.softmax(logits, dim=-1)
    # a row that sees no key softmaxes to a uniform average: zero it, as the
    # flash kernels write zeros for such rows
    weights = torch.where(valid.any(dim=-1, keepdim=True), weights, torch.zeros_like(weights))
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def reference_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2 and K3: ``(dq, dk, dv)`` of attention given the
    forward's output ``out`` and f32 logsumexp ``lse`` (batch, heads, Sq).

    The arithmetic of the JAX kernels (``attention.py:353-504``), in f32,
    outputs in q/k/v's dtype: ``delta = rowsum(dO * O)``, ``P = exp(q*scale
    k^T - lse)`` where a key is visible and exactly 0 elsewhere (whatever lse
    holds), ``dV = P^T dO``, ``dS = P * (dO V^T - delta)``, ``dQ = scale dS K``,
    ``dK = dS^T (q*scale)``.
    """
    _check_no_kv_lens(kv_lens, segment_ids)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    seq_q, seq_k = q.shape[-2], k.shape[-2]
    mask = _combined_mask(None, kv_lens, segment_ids, seq_q, seq_k)
    qs, kf, vf, do = _acc(q) * scale, _acc(k), _acc(v), _acc(d_out)
    scores = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    valid = _valid(mask, causal, seq_q, seq_k, q.device)
    probs = torch.where(valid, torch.exp(scores - _acc(lse)[..., None]), torch.zeros_like(scores))
    delta = torch.sum(do * _acc(out), dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", probs, do)
    dscores = probs * (torch.einsum("bhqd,bhkd->bhqk", do, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", dscores, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dscores, qs)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _segment_kv_lens(ids: torch.Tensor, seq_k: int) -> torch.Tensor:
    """(batch,) int32: the last nonzero key id's index + 1 (``attention.py:
    198-208``), not the count of nonzero ids, so interior zeros never cut
    off live keys behind them."""
    if seq_k == 0:
        return torch.zeros(ids.shape[0], dtype=torch.int32, device=ids.device)
    positions = torch.arange(1, seq_k + 1, device=ids.device, dtype=torch.int32)[None, :]
    return torch.where(ids[:, :seq_k] > 0, positions, torch.zeros_like(positions)).amax(dim=-1)


def _segment_ranges(own_ids: torch.Tensor, other_ids: torch.Tensor) -> torch.Tensor:
    """The skip map: ``(batch, S_own, 2)`` int32 ``[start, end)`` per position
    of the own axis, the positions on the other axis that carry its id.

    An id's first and end positions on the other axis are those of ``JAX``'s
    scatter-min/max (``attention.py:234-245``), found here by a stable sort of
    the other axis's ids and a binary search for each own id (a scatter-min
    whose positions pile onto a few ids serialises on the card), so an id that
    recurs non-contiguously gets its whole extent (a superset: the kernels'
    in-tile id test keeps it exact). Ids outside ``[0, max(S_own, S_other)]``
    clip into one shared bucket, supersets again. Padding positions (id <= 0)
    and ids absent from the other axis get the empty range ``[S_other, 0)``.
    Torch ops on the ids' device, no host sync.
    """
    batch, s_own = own_ids.shape
    s_other = other_ids.shape[1]
    if s_other == 0:
        return torch.zeros((batch, s_own, 2), dtype=torch.int32, device=own_ids.device)
    cap = max(s_own, s_other)
    own = own_ids.long().clamp(0, cap).contiguous()
    values, order = torch.sort(other_ids.long().clamp(0, cap), dim=1, stable=True)
    lo = torch.searchsorted(values, own, side="left")
    hi = torch.searchsorted(values, own, side="right")
    found = (hi > lo) & (own_ids > 0)
    # the sort is stable, so positions ascend inside each id's run of slots
    first = torch.gather(order, 1, lo.clamp(max=s_other - 1))
    last = torch.gather(order, 1, (hi - 1).clamp(min=0))
    start = torch.where(found, first, s_other)
    stop = torch.where(found, last + 1, 0)
    return torch.stack([start, stop], dim=-1).to(torch.int32)


#: rows per tile of the bf16 (tensor-core) bodies: K1 and K2 own 128 query
#: rows per CTA, K3 128 keys (64 at head_dim 128, one warpgroup); each
#: streams the other axis in tiles of 64
_K1_BLOCK_Q, _K1_BLOCK_K = 128, 64
_DKV_BLOCKS = {64: 128, 128: 64}


def _tile_ranges(ranges: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)``, each ``(batch, ceil(S_own / block))``: the skip map
    ``ranges`` (:func:`_segment_ranges`) reduced over tiles of ``block``
    positions of the own axis, as a kernel reduces it over its rows (rows past
    the end count as empty)."""
    batch, s_own, _ = ranges.shape
    n_tiles = -(-s_own // block)
    pad = n_tiles * block - s_own
    lo = torch.nn.functional.pad(ranges[..., 0], (0, pad), value=torch.iinfo(torch.int32).max)
    hi = torch.nn.functional.pad(ranges[..., 1], (0, pad), value=0)
    return lo.view(batch, n_tiles, block).amin(-1), hi.view(batch, n_tiles, block).amax(-1)


def _tile_work(ranges: torch.Tensor, kv_lens: torch.Tensor, causal: bool, block: int,
               keys: bool = False) -> torch.Tensor:
    """``(batch, n_tiles)``: how many 64-row tiles of the other axis a bf16
    body's CTA scans for each tile of ``block`` own rows in packed mode.

    Query tiles (K1, K2; ``keys=False``) scan the keys in [lo, hi) of their
    rows ∩ [0, kv_len) ∩ the causal limit (the tile's last row + 1). Key
    tiles (K3; ``keys=True``) scan the queries in [lo, hi) from the tile's
    first key on under causal, and none if the tile starts at or past kv_len.
    """
    lo, hi = _tile_ranges(ranges, block)
    lens = kv_lens.to(hi.dtype)[:, None]
    starts = torch.arange(lo.shape[1], device=lo.device, dtype=hi.dtype)[None, :] * block
    if keys:
        begin = torch.maximum(lo, starts) if causal else lo
        end = torch.where(starts < lens, hi, torch.zeros_like(hi))
    else:
        begin = lo
        end = torch.minimum(hi, lens)
        if causal:
            end = torch.minimum(end, (starts + block).clamp(max=ranges.shape[1]))
    tile = _K1_BLOCK_K
    return torch.where(end > begin, (end + tile - 1) // tile - begin // tile, torch.zeros_like(end))


def _work_order(ranges: torch.Tensor, kv_lens: torch.Tensor, causal: bool, block: int,
                keys: bool = False) -> torch.Tensor:
    """A bf16 body's work order in packed mode: ``(batch * n_tiles,)`` int32
    ``b * n_tiles + m`` of every tile, by descending :func:`_tile_work`, ties
    in index order. Torch ops on the ranges' device, no host sync."""
    work = _tile_work(ranges, kv_lens, causal, block, keys)
    return torch.sort(work.flatten(), descending=True, stable=True).indices.to(torch.int32)


def _skip_map(ids: torch.Tensor, lens: torch.Tensor, seq_own: int, seq_other: int, causal: bool, bf16: bool,
              block: int, keys: bool = False, ranges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A kernel's flat int32 skip map: the ``(batch, seq_own, 2)`` ranges of
    the own axis (``ranges``, or :func:`_segment_ranges` of the id slices),
    followed for the bf16 bodies by their :func:`_work_order`. ``keys``: the
    own axis is the keys (K3), the ranges are of queries."""
    if ranges is None:
        ranges = _segment_ranges(ids[:, :seq_own], ids[:, :seq_other])
    if not bf16:
        return ranges.flatten()
    return torch.cat([ranges.flatten(), _work_order(ranges, lens, causal, block, keys=keys)])


def _backward_maps(ids, lens, seq_q: int, seq_k: int, causal: bool, head_dim: int, bf16: bool,
                   fwd_map: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat skip maps of K2 and K3 (:func:`_skip_map`). ``fwd_map`` is
    K1's map for the same call (its ranges, then its work order for bf16):
    K2 owns query tiles of K1's size and scans keys by K1's rule, so it takes
    that map as it is, and for self-attention (Sq == Sk, both axes read one
    id slice) K3's ranges are the same tensor; only K3's work order, and the
    transposed ranges of a cross-length call, are computed here."""
    if fwd_map is None:
        fwd_map = _skip_map(ids, lens, seq_q, seq_k, causal, bf16, _K1_BLOCK_Q)
    ranges = fwd_map[: ids.shape[0] * seq_q * 2].view(ids.shape[0], seq_q, 2)
    k_ranges = ranges if seq_q == seq_k else None
    k_map = _skip_map(ids, lens, seq_k, seq_q, causal, bf16, _DKV_BLOCKS[head_dim], keys=True, ranges=k_ranges)
    return fwd_map, k_map


def _check_flash_inputs(q, k, v, kv_lens, name: str = "flash_attention", segment_ids=None) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name}: the kernel needs CUDA tensors; got q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k and v must lie on one CUDA device; got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (batch, heads, seq, head_dim)")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    batch, heads, seq_q, head_dim = q.shape
    if head_dim not in (64, 128):
        raise ValueError(f"{name} kernel takes head_dim 64 or 128, got {head_dim}")
    if k.shape[:2] != (batch, heads) or v.shape != k.shape or k.shape[-1] != head_dim:
        raise ValueError(f"{name}: incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous q, k, v")
    if kv_lens is not None and (kv_lens.shape != (batch,) or kv_lens.device != q.device):
        raise ValueError(f"{name}: kv_lens must be a (batch,) tensor on q's device")
    if segment_ids is not None:
        seq_k = k.shape[-2]
        if (segment_ids.dim() != 2 or segment_ids.shape[0] != batch or segment_ids.shape[1] < max(seq_q, seq_k)
                or segment_ids.device != q.device or segment_ids.is_floating_point()):
            raise ValueError(f"{name}: segment_ids must be an integer (batch, S >= max(Sq, Sk)) tensor on q's "
                             f"device; got {segment_ids.dtype} {tuple(segment_ids.shape)} on {segment_ids.device}")


def _kernel_masks(kv_lens, segment_ids, seq_k: int):
    """``(ids, kv_lens)`` as the kernels take them, int32 and contiguous (or
    None): with segment ids, kv_len is the last nonzero key id's index + 1."""
    if segment_ids is None:
        return None, kv_lens.to(torch.int32).contiguous() if kv_lens is not None else None
    ids = segment_ids.to(torch.int32).contiguous()
    return ids, _segment_kv_lens(ids, seq_k)


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _flash_forward(q, k, v, kv_lens, causal: bool, scale: float, return_lse: bool, segment_ids=None):
    """(out, lse or None, skip map or None): K1 on CUDA tensors, the plain
    version on CPU ones. The skip map is the flat one K1 took in packed mode
    (:func:`_skip_map`), which the backward reuses."""
    if q.device.type == "cpu":
        mask = _combined_mask(None, kv_lens, segment_ids, q.shape[-2], k.shape[-2])
        out = reference_attention(q, k, v, mask=mask, causal=causal, sm_scale=scale)
        if not return_lse:
            return out, None, None
        return out, torch.logsumexp(_masked_logits(q, k, mask, causal, scale)[0], dim=-1), None
    _check_flash_inputs(q, k, v, kv_lens, segment_ids=segment_ids)
    batch, heads, seq_q, head_dim = q.shape
    seq_k = k.shape[-2]
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q.device) if return_lse else None
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        # the bf16 body reads q, k, v through TMA, which takes 16-byte aligned tensors
        raise ValueError("flash_attention: the bf16 kernel needs 16-byte aligned q, k, v (e.g. .clone() a view)")
    ids, lens = _kernel_masks(kv_lens, segment_ids, seq_k)
    ranges = None
    if ids is not None:  # the bf16 body reads its work order after the ranges
        ranges = _skip_map(ids, lens, seq_q, seq_k, causal, q.dtype == torch.bfloat16, _K1_BLOCK_Q)
    if seq_q and batch * heads:
        fn = _build.library("flash_fwd").flash_fwd
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lens), _ptr(ids), _ptr(ranges),
            out.data_ptr(), _ptr(lse),
            batch, heads, seq_q, seq_k, head_dim, ids.shape[1] if ids is not None else 0,
            _build.DTYPE_CODES[q.dtype], int(bool(causal)), scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(status, "flash_fwd")
        kernels.note_launch("flash_fwd")
    return out, lse, ranges


class _FlashAttention(torch.autograd.Function):
    """K1 forward (with its logsumexp residual), K2 + K3 backward: the port's
    counterpart of the JAX ``custom_vjp`` (``attention.py:658``/``:756``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, segment_ids, causal: bool, sm_scale: float):
        out, lse, skip_map = _flash_forward(q, k, v, kv_lens, causal, sm_scale, return_lse=True,
                                            segment_ids=segment_ids)
        # K1's skip map goes to the backward, which builds no map of its own
        # for self-attention (see _backward_maps)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens, segment_ids, skip_map)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        q, k, v, out, lse, kv_lens, segment_ids, skip_map = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, d_out, kv_lens, ctx.causal, ctx.sm_scale, segment_ids,
                                     fwd_map=skip_map)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Blocked flash attention forward (K1), differentiable through K2/K3.

    :param kv_lens: optional ``(batch,)`` int valid KV lengths: keys at
        positions ``>= kv_lens[b]`` are masked for every head and query of row b.
    :param segment_ids: optional ``(batch, S_ids)`` int packed segment ids
        (0 = padding); queries attend only keys of their own segment. Mutually
        exclusive with ``kv_lens``.
    :param return_lse: also return the f32 ``(batch, heads, Sq)`` logsumexp of
        the scaled, masked scores (the residual the backward pass reuses).
    """
    _check_no_kv_lens(kv_lens, segment_ids)
    scale = float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, kv_lens, segment_ids, bool(causal), scale)
    else:
        out, lse, _ = _flash_forward(q, k, v, kv_lens, causal, scale, return_lse, segment_ids=segment_ids)
    return (out, lse) if return_lse else out


def _check_backward_inputs(q, k, v, out, lse, d_out, kv_lens, segment_ids) -> None:
    _check_flash_inputs(q, k, v, kv_lens, name="flash_attention_backward", segment_ids=segment_ids)
    if out.shape != q.shape or d_out.shape != q.shape or out.dtype != q.dtype or d_out.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward: out {tuple(out.shape)} {out.dtype} and d_out "
                         f"{tuple(d_out.shape)} {d_out.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: lse must be float32 {tuple(q.shape[:3])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(t.device != q.device for t in (out, lse, d_out)):
        raise ValueError("flash_attention_backward: out, lse and d_out must lie on q's device")


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    d_out: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: K2 then K3 on CUDA tensors (``csrc/flash_bwd.cu``),
    :func:`reference_attention_backward` on CPU tensors. ``out`` and ``lse``
    are K1's outputs for the same inputs; ``d_out`` may be non-contiguous (a
    bf16 ``d_out`` must still lie 16-byte aligned: the bf16 bodies read it
    through TMA)."""
    scale = float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5
    return _flash_backward(q, k, v, out, lse, d_out, kv_lens, causal, scale, segment_ids)


def _flash_backward(q, k, v, out, lse, d_out, kv_lens, causal: bool, scale: float, segment_ids,
                    fwd_map: Optional[torch.Tensor] = None):
    """:func:`flash_attention_backward` with K1's skip map of the same call
    (``fwd_map``, from :func:`_flash_forward`) where the caller has it."""
    _check_no_kv_lens(kv_lens, segment_ids)
    if q.device.type == "cpu":
        return reference_attention_backward(q, k, v, out, lse, d_out, kv_lens, causal, scale, segment_ids)
    d_out, out, lse = d_out.contiguous(), out.contiguous(), lse.contiguous()
    _check_backward_inputs(q, k, v, out, lse, d_out, kv_lens, segment_ids)
    batch, heads, seq_q, head_dim = q.shape
    seq_k = k.shape[-2]
    if not (seq_q and seq_k and batch * heads):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v, d_out)):
        # the bf16 bodies read q, k, v and d_out through TMA, which takes 16-byte aligned tensors
        raise ValueError("flash_attention_backward: the bf16 kernels need 16-byte aligned q, k, v and d_out "
                         "(e.g. .clone() a view)")
    # delta_i = rowsum(dO * O), outside the kernels as in the JAX package (:532)
    delta = torch.sum(d_out.float() * out.float(), dim=-1).contiguous()
    ids, lens = _kernel_masks(kv_lens, segment_ids, seq_k)
    # the skip maps of each kernel's own axis: key ranges per query (K2),
    # query ranges per key (K3), each followed by its work order in bf16
    q_map = k_map = None
    if ids is not None:
        q_map, k_map = _backward_maps(ids, lens, seq_q, seq_k, causal, head_dim, bf16, fwd_map)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (batch, heads, seq_q, seq_k, head_dim, ids.shape[1] if ids is not None else 0,
              _build.DTYPE_CODES[q.dtype], int(bool(causal)), scale, stream)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              _ptr(lens), _ptr(ids))
    _build.check(lib.flash_bwd_dq(*inputs, _ptr(q_map), dq.data_ptr(), *common), "flash_bwd_dq")
    kernels.note_launch("flash_bwd_dq")
    _build.check(lib.flash_bwd_dkv(*inputs, _ptr(k_map), dk.data_ptr(), dv.data_ptr(), *common), "flash_bwd_dkv")
    kernels.note_launch("flash_bwd_dkv")
    return dq, dk, dv


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatching attention entry point used by the models.

    ``impl="auto"``: the kernels for CUDA tensors without a dense ``mask``,
    the plain version otherwise. ``"kernel"`` forces :func:`flash_attention`
    (which runs the plain version for CPU tensors); ``"reference"`` forces
    :func:`reference_attention`. ``segment_ids`` and ``kv_lens`` together
    raise, on either side (``attention.py:794-797``).
    """
    _check_no_kv_lens(kv_lens, segment_ids)
    if impl == "auto":
        impl = "kernel" if q.is_cuda and mask is None else "reference"
    if impl == "kernel":
        if mask is not None:
            raise ValueError(
                "attention(impl='kernel') does not take dense masks; pass kv_lens / segment_ids / causal, "
                "or use impl='reference' for arbitrary masks"
            )
        return flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, sm_scale=sm_scale, segment_ids=segment_ids)
    if impl == "reference":
        if mask is None and kv_lens is not None:
            mask = _kv_lens_to_mask(kv_lens, k.shape[-2])
        return reference_attention(q, k, v, mask=mask, causal=causal, sm_scale=sm_scale, segment_ids=segment_ids)
    raise ValueError(f"Unknown attention impl {impl!r}; expected 'auto', 'kernel', or 'reference'")
