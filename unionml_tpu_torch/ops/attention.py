"""Attention ops: the K1 flash-forward CUDA kernel and its plain PyTorch version.

Port of ``unionml_tpu/ops/attention.py``. Shapes follow the (batch, heads,
seq, head_dim) convention of the JAX package.

- :func:`reference_attention` — the plain version, with the semantics of the
  JAX ``xla_attention`` (``attention.py:45-80``): f32 scores, optional dense
  boolean mask and causal (top-left aligned) masking, f32 softmax, weights cast
  to ``v``'s dtype for the value product. A row that sees no key at all writes
  zeros, as the flash kernels do.
- :func:`flash_attention` — K1 (``csrc/flash_fwd.cu``, replacing the Pallas
  ``_flash_kernel``). On CUDA tensors it launches the kernel or raises; on CPU
  tensors it runs :func:`reference_attention`. Causal and ``kv_lens``
  (right-padding) masks, any ``Sq``/``Sk``, bf16 or f32, head_dim 64 or 128.
  Packed ``segment_ids`` and the backward kernels are not ported yet.
- :func:`attention` — the dispatcher the model calls: ``impl="auto"`` runs the
  kernel for CUDA tensors without a dense mask and the plain version
  otherwise; ``"kernel"`` and ``"reference"`` force one side. The port keeps
  no measured dispatch table yet.
"""

from typing import Optional, Tuple, Union

import torch

from unionml_tpu_torch import kernels
from unionml_tpu_torch.kernels import _build

__all__ = ["attention", "flash_attention", "reference_attention"]

_NEG_INF = -1e30


def _kv_lens_to_mask(kv_lens: torch.Tensor, seq_k: int) -> torch.Tensor:
    """(batch,) valid lengths -> (batch, 1, 1, seq_k) boolean padding mask."""
    positions = torch.arange(seq_k, device=kv_lens.device)[None, :]
    return (positions < kv_lens[:, None])[:, None, None, :]


def _masked_logits(q, k, mask, causal, scale):
    """f32 scaled scores with masked keys at -1e30, and the keep mask."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = torch.ones(logits.shape[-2:], dtype=torch.bool, device=q.device)
    valid = (torch.tril(valid) if causal else valid)[None, None]
    if mask is not None:
        valid = valid & mask
    return torch.where(valid, logits, torch.full_like(logits, _NEG_INF)), valid


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain softmax(q k^T) v with the JAX ``xla_attention`` arithmetic.

    ``mask`` broadcasts against ``(batch, heads, Sq, Sk)``; True keeps a key.
    """
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    logits, valid = _masked_logits(q, k, mask, causal, scale)
    weights = torch.softmax(logits, dim=-1)
    # a row that sees no key softmaxes to a uniform average: zero it, as the
    # flash kernels write zeros for such rows
    weights = torch.where(valid.any(dim=-1, keepdim=True), weights, torch.zeros_like(weights))
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def _check_flash_inputs(q, k, v, kv_lens) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k and v must all lie on the same device")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (batch, heads, seq, head_dim)")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    batch, heads, _, head_dim = q.shape
    if head_dim not in (64, 128):
        raise ValueError(f"flash_attention kernel takes head_dim 64 or 128, got {head_dim}")
    if k.shape[:2] != (batch, heads) or v.shape != k.shape or k.shape[-1] != head_dim:
        raise ValueError(f"flash_attention: incompatible shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    if kv_lens is not None and (kv_lens.shape != (batch,) or kv_lens.device != q.device):
        raise ValueError("flash_attention: kv_lens must be a (batch,) tensor on q's device")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Blocked flash attention forward (K1).

    :param kv_lens: optional ``(batch,)`` int valid KV lengths: keys at
        positions ``>= kv_lens[b]`` are masked for every head and query of row b.
    :param return_lse: also return the f32 ``(batch, heads, Sq)`` logsumexp of
        the scaled, masked scores (the residual a backward pass reuses).
    """
    scale = float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        mask = _kv_lens_to_mask(kv_lens, k.shape[-2]) if kv_lens is not None else None
        out = reference_attention(q, k, v, mask=mask, causal=causal, sm_scale=scale)
        if not return_lse:
            return out
        return out, torch.logsumexp(_masked_logits(q, k, mask, causal, scale)[0], dim=-1)
    _check_flash_inputs(q, k, v, kv_lens)
    batch, heads, seq_q, head_dim = q.shape
    seq_k = k.shape[-2]
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q.device) if return_lse else None
    lens = kv_lens.to(torch.int32).contiguous() if kv_lens is not None else None
    if seq_q and batch * heads:
        fn = _build.library("flash_fwd").flash_fwd
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lens.data_ptr() if lens is not None else None,
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            batch, heads, seq_q, seq_k, head_dim, _build.DTYPE_CODES[q.dtype], int(bool(causal)), scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(status, "flash_fwd")
        kernels.launches["flash_fwd"] += 1
    return (out, lse) if return_lse else out


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention entry point used by the model.

    ``impl="auto"``: the K1 kernel for CUDA tensors without a dense ``mask``,
    the plain version otherwise. ``"kernel"`` forces :func:`flash_attention`
    (which runs the plain version for CPU tensors); ``"reference"`` forces
    :func:`reference_attention`.
    """
    if impl == "auto":
        impl = "kernel" if q.is_cuda and mask is None else "reference"
    if impl == "kernel":
        if mask is not None:
            raise ValueError(
                "attention(impl='kernel') does not take dense masks; pass kv_lens / causal, "
                "or use impl='reference' for arbitrary masks"
            )
        return flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, sm_scale=sm_scale)
    if impl == "reference":
        if mask is None and kv_lens is not None:
            mask = _kv_lens_to_mask(kv_lens, k.shape[-2])
        return reference_attention(q, k, v, mask=mask, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"Unknown attention impl {impl!r}; expected 'auto', 'kernel', or 'reference'")
