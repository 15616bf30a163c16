"""Flax-style mixed-precision layer helpers shared by the port's models.

Parameters stay float32; each layer casts its weight and input to the
compute dtype in ``forward``, as ``nn.Dense(dtype=...)`` does. LayerNorm
takes its statistics and affine in float32 and returns the compute dtype.
Dropout draws its masks from an explicit ``torch.Generator``.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Dense(dtype=...)``: input, kernel and bias cast to the compute dtype."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 statistics and affine, output in the compute dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale kept
    values by ``1 / (1 - rate)``; ``generator=None`` is deterministic."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
