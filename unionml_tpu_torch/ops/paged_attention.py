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
  version. The kernels read the int8 codes and scales straight from the pool
  and walk only the table columns a query can see.
- :func:`launch_plan` — which of K4's bodies a call takes, from host-known
  facts only (shapes, dtypes, table width, block size; never the bases): the
  split-key decode body for ``S <= DECODE_MAX_S`` (fixed runs of
  ``SPLIT_COLUMNS`` table columns, merged by a second kernel), else a
  query-tile body (tensor cores for bf16, CUDA cores for f32).
- :func:`fused_hbm_bytes` — the device-memory bytes the fused kernel must move
  for one call's KV, the kernel's byte bound.
"""

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from unionml_tpu_torch import kernels
from unionml_tpu_torch.kernels import _build
from unionml_tpu_torch.ops.attention import reference_attention

__all__ = [
    "DECODE_MAX_S", "SPLIT_COLUMNS", "PagedPlan", "fused_hbm_bytes", "launch_plan", "paged_attention",
    "reference_paged_attention",
]

#: table columns per split of the decode body (``kSplitCols`` in the source)
SPLIT_COLUMNS = 16
#: the longest query chunk the decode body takes; longer ones take a query tile
DECODE_MAX_S = 8
_BODIES = {"decode": 0, "tile": 1}
_TILE_ROWS = {torch.bfloat16: 64, torch.float32: 32}
_SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on the H100
_DECODE_STAGES, _DECODE_STAGE_BYTES = 4, 8192  # the decode body's cp.async ring (see the source)


@dataclass(frozen=True)
class PagedPlan:
    """One K4 launch: the body, its grid ``(x, y, z)``, the kernels it runs
    (by the names the profiler shows), and for the decode body the number of
    key splits and the f32 workspace its partials need."""

    body: str
    grid: Tuple[int, int, int]
    kernels: Tuple[str, ...]
    width: int
    splits: int = 1
    workspace_floats: int = 0

    def split_columns(self, i: int) -> range:
        """The table columns split ``i`` covers: a fixed run of
        ``SPLIT_COLUMNS`` for the decode body (whatever the width, batch or
        S; the last run is cut at the table's end), the whole table for a
        query tile."""
        if self.body != "decode":
            return range(self.width)
        return range(i * SPLIT_COLUMNS, min((i + 1) * SPLIT_COLUMNS, self.width))


@functools.lru_cache(maxsize=256)
def launch_plan(
    batch: int, heads: int, S: int, head_dim: int, dtype: torch.dtype, kv_dtype: torch.dtype,
    width: int, block_size: int,
) -> PagedPlan:
    """The K4 body for these host-known facts. Raises ``ValueError`` for a
    combination no body takes (before any launch; nothing falls back)."""
    if dtype not in _TILE_ROWS or head_dim not in (64, 128) or min(batch, heads, S, width, block_size) < 1:
        raise ValueError(f"paged_attention: no K4 body for {dtype}, head_dim {head_dim}, batch {batch}, "
                         f"heads {heads}, S {S}, width {width}, block size {block_size}")
    kv_size = kv_dtype.itemsize
    if S <= DECODE_MAX_S:
        col_bytes = 2 * block_size * head_dim * kv_size
        ring = _DECODE_STAGES * min(SPLIT_COLUMNS, max(1, _DECODE_STAGE_BYTES // col_bytes)) * col_bytes
        if ring + (3 * SPLIT_COLUMNS + 16 + 8 * head_dim) * 4 > _SMEM_LIMIT:
            raise ValueError(f"paged_attention: block size {block_size} is too large for the decode body")
        splits = -(-width // SPLIT_COLUMNS)
        return PagedPlan(
            "decode", (splits, S * heads, batch), ("paged_decode_kernel", "paged_merge_kernel"), width,
            splits, batch * heads * S * splits * (head_dim + 2),
        )
    rows = _TILE_ROWS[dtype]
    grid = (-(-S // rows), heads, batch)
    if dtype == torch.float32:
        return PagedPlan("tile", grid, ("paged_tile_f32_kernel",), width)
    quant = kv_dtype == torch.int8
    raw = 64 * head_dim * (1 if quant else 2)
    smem = 64 * head_dim * 2 + 3 * 2 * raw + (2 * 64 * head_dim * 2 if quant else 0) + 1024 + width * (12 if quant else 4)
    if 64 % block_size or smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: the bf16 query-tile body takes block sizes that divide 64 and tables "
                         f"of at most a few thousand columns, got block size {block_size}, width {width}")
    return PagedPlan("tile", grid, ("paged_tile_wgmma_kernel",), width)


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
        plan = launch_plan(batch, heads, S, head_dim, q.dtype, k.dtype, table.shape[1], k.shape[2])
        if any(t.data_ptr() % 16 for t in (q, k, v, out)):
            raise ValueError("paged_attention kernel copies 16-byte chunks: q and the pools must be 16-byte aligned")
        ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=q.device) if plan.workspace_floats else None
        fn = _build.library("paged_attention").paged_attention
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            table.data_ptr(), base.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
            batch, heads, S, head_dim, k.shape[2], table.shape[1],
            _build.DTYPE_CODES[q.dtype], int(k_scale is not None), _BODIES[plan.body], plan.splits,
            head_dim ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
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
