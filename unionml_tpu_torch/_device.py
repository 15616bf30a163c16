"""Device policy of the port.

Entry points take ``device`` (default ``"cuda"``). Without a CUDA device they
raise unless the caller asked for the CPU explicitly: the port never falls back
to the CPU quietly. The float32 matmul precision is pinned here too — TF32 off
for both cuBLAS and cuDNN — so float32 runs on the card keep full precision and
stay comparable with the JAX reference.
"""

from typing import Union

import torch

__all__ = ["resolve_device", "set_precision_flags"]


def set_precision_flags() -> None:
    """Full float32 matmuls and convolutions (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    :raises RuntimeError: a CUDA device was asked for (the default) and none
        is available. Pass ``device="cpu"`` to run the plain PyTorch path.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        set_precision_flags()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev
