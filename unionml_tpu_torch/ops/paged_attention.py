"""Paged attention: the K4 CUDA kernel off the KV block pool, and its plain version.

Port of ``unionml_tpu/ops/paged_attention.py``. Layout contract (matches
``models.gpt.init_block_pool``): pool leaves are ``(num_blocks, heads,
block_size, head_dim)``; int8 pools carry ``(num_blocks, heads, 1, 1)`` f32
scales; ``block_table`` is ``(batch, width)`` int32; query ``s`` of row ``b``
sits at logical position ``base_positions[b] + s`` and attends keys at logical
positions ``<= base + s``, where logical column ``w * block_size + o`` lives in
pool block ``block_table[b, w]``. Table columns past a row's live range point
at the engine's scratch block; the positional mask discards them.

- :func:`reference_paged_attention` — the plain version, after the JAX
  ``xla_paged_attention`` (``paged_attention.py:56-89``): gather the table,
  dequantize as ``(codes.f32 * scale).astype(out_dtype)``, attend dense under
  the positional mask.
- :func:`paged_attention` — K4 (``csrc/paged_attention.cu``, replacing the
  Pallas ``_paged_kernel``). On CUDA tensors it launches the kernel or
  raises; on CPU tensors (or with ``impl="reference"``) it runs the plain
  version. The kernel reads the int8
  codes and scales straight from the pool and walks only the table columns the
  row's last query can see.
- :func:`fused_hbm_bytes` — the device-memory bytes the fused kernel must move
  for one call's KV, the kernel's byte bound.
"""

from typing import Optional

import torch

from unionml_tpu_torch import kernels
from unionml_tpu_torch.kernels import _build
from unionml_tpu_torch.ops.attention import reference_attention

__all__ = ["fused_hbm_bytes", "paged_attention", "reference_paged_attention"]


def reference_paged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_table: torch.Tensor,
    base_positions: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Gather the table, dequantize, attend dense under the positional mask."""
    batch, heads, S, head_dim = q.shape
    block_size = k.shape[2]
    width = block_table.shape[1]
    capacity = width * block_size
    out_dtype = q.dtype if out_dtype is None else out_dtype
    table = block_table.long()

    def gather(pool_leaf, scale_leaf):
        blocks = pool_leaf[table]  # (batch, width, heads, bs, hd)
        if scale_leaf is not None:
            blocks = (blocks.float() * scale_leaf[table]).to(out_dtype)
        return blocks.transpose(1, 2).reshape(batch, heads, capacity, head_dim)

    k_pos = torch.arange(capacity, device=q.device)
    q_pos = base_positions.to(torch.int64)[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None, :, :]
    return reference_attention(q, gather(k, k_scale), gather(v, v_scale), mask=mask)


def _check_paged_inputs(q, k, v, block_table, base_positions, k_scale, v_scale, out_dtype) -> None:
    tensors = [q, k, v, block_table, base_positions] + [t for t in (k_scale, v_scale) if t is not None]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention: every tensor must lie on q's CUDA device")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("paged_attention: q is (batch, heads, S, head_dim), pools (blocks, heads, bs, head_dim)")
    batch, heads, _, head_dim = q.shape
    if q.dtype not in _build.DTYPE_CODES or out_dtype != q.dtype:
        raise ValueError(f"paged_attention kernel takes float32 or bfloat16 q with out_dtype == q.dtype, "
                         f"got {q.dtype} -> {out_dtype}")
    if head_dim not in (64, 128) or k.shape[1] != heads or k.shape[3] != head_dim:
        raise ValueError(f"paged_attention kernel takes head_dim 64 or 128 and matching pool heads, got "
                         f"q {tuple(q.shape)}, pool {tuple(k.shape)}")
    if k_scale is not None:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError("paged_attention: scales come with int8 pools")
        expected = (k.shape[0], heads, 1, 1)
        if k_scale.shape != expected or v_scale.shape != expected or k_scale.dtype != torch.float32 \
                or v_scale.dtype != torch.float32:
            raise ValueError(f"paged_attention: scales must be float32 {expected}")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"paged_attention kernel takes a full-precision pool in q's dtype, got {k.dtype}")
    if block_table.dim() != 2 or block_table.shape[0] != batch or base_positions.shape != (batch,):
        raise ValueError("paged_attention: block_table is (batch, width), base_positions (batch,)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel needs contiguous inputs")


def paged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_table: torch.Tensor,
    base_positions: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attend ``q`` over each row's paged KV through its block-table row (K4).

    :param q: ``(batch, heads, S, head_dim)``: ``S == 1`` for decode, the
        chunk for batch-1 chunked prefill.
    :param k / v: pool leaves, int8 codes when ``k_scale``/``v_scale`` ride
        along, else the compute dtype.
    :param block_table: ``(batch, width)`` int32 logical-block -> pool block.
    :param base_positions: ``(batch,)`` int32 position of each row's query 0.
    :param out_dtype: dequant target and output dtype; defaults to ``q.dtype``
        (the kernel requires them equal).
    :param impl: ``"auto"``/``"kernel"`` run K4 for CUDA tensors and the plain
        version for CPU tensors; ``"reference"`` runs the plain version.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if impl not in ("auto", "kernel", "reference"):
        raise ValueError(f"Unknown paged attention impl {impl!r}; expected 'auto', 'kernel', or 'reference'")
    if impl == "reference" or q.device.type == "cpu":
        return reference_paged_attention(
            q, k, v, block_table, base_positions, k_scale=k_scale, v_scale=v_scale, out_dtype=out_dtype
        )
    table = block_table.to(torch.int32).contiguous()
    base = base_positions.to(torch.int32).contiguous()
    _check_paged_inputs(q, k, v, table, base, k_scale, v_scale, out_dtype)
    batch, heads, S, head_dim = q.shape
    out = torch.empty_like(q)
    if S and batch * heads:
        fn = _build.library("paged_attention").paged_attention
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            table.data_ptr(), base.data_ptr(), out.data_ptr(),
            batch, heads, S, head_dim, k.shape[2], table.shape[1],
            _build.DTYPE_CODES[q.dtype], int(k_scale is not None), head_dim ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(status, "paged_attention")
        kernels.launches["paged_attention"] += 1
    return out


def fused_hbm_bytes(
    table_width: int, block_size: int, heads: int, head_dim: int,
    quantized: bool, dense_itemsize: int = 2,
) -> int:
    """Device-memory bytes of one row's KV reads in the fused kernel: K + V
    codes of ``table_width`` columns at their stored width (int8 under
    quantization, else the dense dtype) plus the f32 scales. Nothing else of
    the KV crosses device memory: the kernel dequantizes in registers and
    never writes a gathered copy. Pass the columns a call actually reads
    (those up to ``(base + S - 1) // block_size``) for the bound of a call."""
    kv_positions = 2 * table_width * block_size * heads * head_dim
    codes = kv_positions * (1 if quantized else dense_itemsize)
    scales = 2 * table_width * heads * 4 if quantized else 0
    return codes + scales
