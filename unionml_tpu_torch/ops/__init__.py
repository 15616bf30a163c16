"""Attention, paged attention, blockwise int8 quantization and token sampling."""

from unionml_tpu_torch.ops.attention import attention, flash_attention, reference_attention
from unionml_tpu_torch.ops.paged_attention import (
    fused_hbm_bytes,
    paged_attention,
    reference_paged_attention,
)
from unionml_tpu_torch.ops.quant import dequantize_blockwise, quantize_blockwise
from unionml_tpu_torch.ops.sampling import apply_top_k, apply_top_p, sample_logits, validate_sampling

__all__ = [
    "apply_top_k",
    "apply_top_p",
    "attention",
    "dequantize_blockwise",
    "flash_attention",
    "fused_hbm_bytes",
    "paged_attention",
    "quantize_blockwise",
    "reference_attention",
    "reference_paged_attention",
    "sample_logits",
    "validate_sampling",
]
