"""Attention (forward and backward, with packed segment ids), paged attention,
classification losses, sequence packing, int8 quantization (KV blocks and
weight-only) and token sampling."""

from unionml_tpu_torch.ops.attention import (
    attention,
    flash_attention,
    flash_attention_backward,
    reference_attention,
    reference_attention_backward,
)
from unionml_tpu_torch.ops.losses import accuracy, cross_entropy_and_accuracy, cross_entropy_with_integer_labels
from unionml_tpu_torch.ops.packing import pack_sequences, packing_efficiency
from unionml_tpu_torch.ops.paged_attention import (
    fused_hbm_bytes,
    paged_attention,
    reference_paged_attention,
)
from unionml_tpu_torch.ops.quant import (
    QuantizedArray,
    default_should_quantize,
    dequantize_blockwise,
    dequantize_tree,
    quantize_array,
    quantize_blockwise,
    quantize_tree,
    quantized_bytes,
)
from unionml_tpu_torch.ops.sampling import apply_top_k, apply_top_p, sample_logits, validate_sampling

__all__ = [
    "QuantizedArray",
    "accuracy",
    "apply_top_k",
    "apply_top_p",
    "attention",
    "cross_entropy_and_accuracy",
    "cross_entropy_with_integer_labels",
    "default_should_quantize",
    "dequantize_blockwise",
    "dequantize_tree",
    "flash_attention",
    "flash_attention_backward",
    "fused_hbm_bytes",
    "pack_sequences",
    "packing_efficiency",
    "paged_attention",
    "quantize_array",
    "quantize_blockwise",
    "quantize_tree",
    "quantized_bytes",
    "reference_attention",
    "reference_attention_backward",
    "reference_paged_attention",
    "sample_logits",
    "validate_sampling",
]
