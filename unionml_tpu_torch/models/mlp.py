"""Small dense models: MLP classifier (digits quickstart) and CNN (MNIST recipe).

Port of ``unionml_tpu/models/mlp.py`` as ``nn.Module``s with float32
parameters computing in ``dtype`` (the head in float32), as flax's
``nn.Dense(dtype=...)`` does. Flax infers input widths at ``init``; here the
constructor takes them (``in_features``, ``in_shape``). The CNN takes NHWC
images as the JAX one does and flattens its feature maps in NHWC order, so
weights carried across by
:func:`~unionml_tpu_torch.models.convert.mlp_params_from_jax` /
:func:`~unionml_tpu_torch.models.convert.cnn_params_from_jax` give the same
logits. Neither model has dropout: ``deterministic`` and ``generator`` are
accepted for the train step's call signature.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models._layers import _dense

__all__ = ["CNNClassifier", "MLPClassifier"]


class MLPClassifier(nn.Module):
    """Dense ReLU stack with a linear head; float32 logits out."""

    def __init__(self, in_features: int, hidden_sizes: Sequence[int] = (128,), num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, device="cuda") -> None:
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=torch.float32)
        widths = [in_features, *hidden_sizes]
        self.dtype = dtype
        self.hidden = nn.ModuleList(nn.Linear(a, b, **kw) for a, b in zip(widths[:-1], widths[1:]))
        self.head = nn.Linear(widths[-1], num_classes, **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for layer in self.hidden:
            x = F.relu(_dense(layer, x, self.dtype))
        return _dense(self.head, x, torch.float32)


class CNNClassifier(nn.Module):
    """Conv -> pool x2 -> dense head (the Keras-MNIST tutorial shape).

    ``in_shape`` is one image's (height, width, channels); inputs are NHWC,
    or NHW for one channel.
    """

    def __init__(self, in_shape: Tuple[int, int, int] = (28, 28, 1), num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, device="cuda") -> None:
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=torch.float32)
        height, width, channels = in_shape
        self.dtype = dtype
        self.conv_0 = nn.Conv2d(channels, 32, 3, padding=1, **kw)  # flax's SAME padding at 3x3, stride 1
        self.conv_1 = nn.Conv2d(32, 64, 3, padding=1, **kw)
        self.dense = nn.Linear((height // 4) * (width // 4) * 64, 128, **kw)
        self.head = nn.Linear(128, num_classes, **kw)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), conv.bias.to(self.dtype), padding=1)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self._conv(self.conv_0, x)), 2)
        x = F.max_pool2d(F.relu(self._conv(self.conv_1, x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order, as flax does
        x = F.relu(_dense(self.dense, x, self.dtype))
        return _dense(self.head, x, torch.float32)
