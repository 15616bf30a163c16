"""Blockwise symmetric int8 quantization for the paged KV pool.

Port of the KV half of ``unionml_tpu/ops/quant.py`` (``quantize_blockwise`` /
``dequantize_blockwise``, ``:77-99``) and its pinned quality budgets. The
arithmetic is float32 op for op as in the reference — absmax over the reduced
axes, ``scale = absmax / 127``, round half to even, clip to ±127, scale 0 for an
all-zero block — so codes and scales match the JAX package bit for bit on the
same float32 inputs. Weight-only ``QuantizedArray`` is not ported yet.
"""

from typing import Sequence, Tuple

import torch

__all__ = [
    "KV_INT8_GREEDY_DIVERGENCE_BUDGET",
    "KV_INT8_LOGPROB_DELTA_BUDGET",
    "dequantize_blockwise",
    "quantize_blockwise",
]

# Same pinned budgets as the JAX package: max |Δ logprob| of the
# full-precision-greedy token, and max fraction of tokens past the first split,
# on the pre-divergence prefix of an int8-pool stream.
KV_INT8_LOGPROB_DELTA_BUDGET = 0.15
KV_INT8_GREEDY_DIVERGENCE_BUDGET = 0.35


def quantize_blockwise(x: torch.Tensor, reduce_axes: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with per-block absmax scales.

    A block is one element of the axes NOT in ``reduce_axes``; the returned
    scale keeps the reduced axes at size 1. An all-zero block stores scale 0
    (the KV pool's monotone-scale convention) and codes 0.
    """
    x32 = x.to(torch.float32)
    absmax = x32.abs().amax(dim=tuple(reduce_axes), keepdim=True)
    scale = absmax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x32 / safe), -127, 127)
    return q.to(torch.int8), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` up to rounding: ``q * scale`` in
    float32, cast to ``dtype``."""
    return (q.to(torch.float32) * scale).to(dtype)
