"""Symmetric int8 quantization: the paged KV pool's blocks and weight-only
int8 for serving.

Port of ``unionml_tpu/ops/quant.py``: ``quantize_blockwise`` /
``dequantize_blockwise`` (``:77-99``) and the KV pool's pinned quality
budgets, then the weight half (``:54-176``): :class:`QuantizedArray`,
:func:`quantize_array`, :func:`default_should_quantize`, the tree transforms
and :func:`quantized_bytes`. The arithmetic is float32 op for op as in the
reference — absmax over the reduced axes, ``scale = absmax / 127``, round half
to even, clip to ±127 — so codes and scales match the JAX package bit for bit
on the same float32 inputs. An all-zero KV block stores scale 0, an all-zero
weight channel scale 1.0, as in the reference.

One layout difference: the port's 2-D weights are ``nn.Linear`` weights,
``(out, in)``, where JAX's Dense kernels are ``(in, out)``. The per-output
channel is therefore axis 0 here (:func:`quantize_array`'s default) and a
kernel's scale is ``(out, 1)``: JAX's ``(1, out)``, transposed.
"""

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

__all__ = [
    "KV_INT8_GREEDY_DIVERGENCE_BUDGET",
    "KV_INT8_LOGPROB_DELTA_BUDGET",
    "QuantizedArray",
    "default_should_quantize",
    "dequantize_blockwise",
    "dequantize_tree",
    "quantize_array",
    "quantize_blockwise",
    "quantize_tree",
    "quantized_bytes",
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


@dataclasses.dataclass(eq=False)
class QuantizedArray:
    """int8 codes plus per-channel f32 scales standing in for a float tensor."""

    q: torch.Tensor  # int8, the original shape
    scale: torch.Tensor  # f32, the original shape with every axis but the channel axis at size 1
    dtype: torch.dtype  # the dequantization target (the original leaf's dtype)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dequantize(self) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale).to(self.dtype)


def quantize_array(w: torch.Tensor, channel_axis: int = 0) -> QuantizedArray:
    """Symmetric per-channel int8 (``quant.py:102-116``). ``channel_axis``
    keeps its own scales (default 0: the output axis of an ``nn.Linear``
    weight); the absmax runs over every other axis. An all-zero channel
    stores scale 1.0."""
    w32 = w.detach().to(torch.float32)
    reduce_axes = tuple(i for i in range(w32.dim()) if i != channel_axis % w32.dim())
    q, scale = quantize_blockwise(w32, reduce_axes)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return QuantizedArray(q=q, scale=scale, dtype=w.dtype)


def default_should_quantize(path: Tuple[str, ...], leaf: Any) -> bool:
    """2-D matmul weights of meaningful size (``quant.py:119-133``): no
    embedding (``wte``/``wpe``/``embed`` in the path: the token embedding is
    also the LM head), no norm or bias (1-D), no projection whose smaller side
    is under 64 (the MoE router), no 3-D expert stack."""
    if not hasattr(leaf, "dim") or leaf.dim() != 2:
        return False
    if min(leaf.shape) < 64:
        return False
    lowered = "/".join(str(p) for p in path).lower()
    return not any(name in lowered for name in ("wte", "wpe", "embed"))


def _tree_map(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any, path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value, path + (str(key),)) for key, value in tree.items()}
    return fn(path, tree)


def quantize_tree(params: Any, should_quantize: Optional[Callable[[Tuple[str, ...], Any], bool]] = None) -> Any:
    """``params`` (nested dicts of tensors, e.g. ``dict(model.named_parameters())``)
    with the leaves ``should_quantize(path, leaf)`` selects (default
    :func:`default_should_quantize`) replaced by :class:`QuantizedArray`;
    every other leaf is the same tensor object."""
    pred = should_quantize or default_should_quantize
    with torch.no_grad():
        return _tree_map(lambda path, leaf: quantize_array(leaf) if pred(path, leaf) else leaf, params)


def dequantize_tree(params: Any) -> Any:
    """Full-precision leaves again (each :class:`QuantizedArray` dequantized)."""
    return _tree_map(lambda _, leaf: leaf.dequantize() if isinstance(leaf, QuantizedArray) else leaf, params)


def quantized_bytes(params: Any) -> Tuple[int, int]:
    """``(bytes as stored, bytes at full precision)`` over the tree: int8
    codes plus f32 scales for each :class:`QuantizedArray`, every other leaf
    at its own dtype in both."""
    stored = full = 0

    def visit(_, leaf):
        nonlocal stored, full
        if isinstance(leaf, QuantizedArray):
            stored += leaf.q.numel() + leaf.scale.numel() * 4
            full += leaf.q.numel() * leaf.dtype.itemsize
        elif torch.is_tensor(leaf):
            stored += leaf.numel() * leaf.element_size()
            full += leaf.numel() * leaf.element_size()

    _tree_map(visit, params)
    return stored, full
