"""Flax-style mixed-precision layer helpers shared by the port's models.

Parameters stay float32; each layer casts its weight and input to the
compute dtype in ``forward``, as ``nn.Dense(dtype=...)`` does. LayerNorm
takes its statistics and affine in float32 and returns the compute dtype.
Dropout draws its masks from an explicit ``torch.Generator``.

Weight-only int8 for serving (``unionml_tpu/ops/quant.py``): :func:`quantize_model`
gives a model whose selected ``nn.Linear`` layers are :class:`QuantizedLinear`
(int8 codes and per-output f32 scales), every other parameter shared with the
original. :func:`_dense` dequantizes such a layer's weight just before its
product, into the leaf's own dtype, then casts it as any other weight: one
layer's full-precision weight is live at a time.
"""

import copy
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch.ops.quant import QuantizedArray, quantize_tree


class QuantizedLinear(nn.Module):
    """An ``nn.Linear`` whose weight is stored as int8 codes ``q`` ``(out,
    in)`` and f32 scales ``scale`` ``(out, 1)``; ``weight`` is the
    :class:`~unionml_tpu_torch.ops.quant.QuantizedArray` over them."""

    def __init__(self, weight: QuantizedArray, bias: Optional[nn.Parameter]) -> None:
        super().__init__()
        self.register_buffer("q", weight.q)
        self.register_buffer("scale", weight.scale)
        self.register_parameter("bias", bias)
        self.weight_dtype = weight.dtype

    @property
    def weight(self) -> QuantizedArray:
        return QuantizedArray(q=self.q, scale=self.scale, dtype=self.weight_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``nn.Linear``'s product in the leaf's dtype (a layer called as a module)."""
        return F.linear(x, self.weight.dequantize(), self.bias)


def _kernel(layer: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """A dense layer's weight in the compute dtype (an int8 weight dequantized
    first, into its leaf's dtype, as JAX's ``dequantize_tree`` does)."""
    weight = layer.weight
    if isinstance(weight, QuantizedArray):
        weight = weight.dequantize()
    return weight.to(dtype)


def _dense(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Dense(dtype=...)``: input, kernel and bias cast to the compute dtype."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), _kernel(layer, dtype), bias)


def quantize_model(model: nn.Module) -> Tuple[nn.Module, Dict[str, Any]]:
    """``(quantized copy, weight tree)``: :func:`~unionml_tpu_torch.ops.quant.quantize_tree`
    of ``model``'s named parameters (a flat dict keyed by parameter name), and
    a copy of ``model`` whose every ``nn.Linear`` with a quantized weight is a
    :class:`QuantizedLinear`. The copy shares every other parameter (and the
    quantized layers' biases) with ``model``, which is left untouched."""
    tree = quantize_tree(dict(model.named_parameters()))
    # the module structure is copied, no parameter is: the memo maps each to itself
    qmodel = copy.deepcopy(model, memo={id(p): p for p in model.parameters()})
    for name, leaf in tree.items():
        if not isinstance(leaf, QuantizedArray):
            continue
        layer_name, _, attr = name.rpartition(".")
        owner_name, _, child = layer_name.rpartition(".")
        owner = qmodel.get_submodule(owner_name)
        layer = getattr(owner, child)
        if attr != "weight" or not isinstance(layer, nn.Linear):
            raise ValueError(f"{name}: only nn.Linear weights can be served as int8")
        setattr(owner, child, QuantizedLinear(leaf, layer.bias))
    return qmodel, tree


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
