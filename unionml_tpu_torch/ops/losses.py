"""Classification losses: cross-entropy with integer labels, and accuracy.

Port of ``unionml_tpu/ops/losses.py``: logits are promoted to float32 whatever
the compute dtype, and the optional ``weights`` normalise by their sum,
guarded by ``max(sum, 1e-8)`` for the all-zero case.
"""

from typing import Optional, Tuple

import torch

__all__ = ["accuracy", "cross_entropy_and_accuracy", "cross_entropy_with_integer_labels"]


def cross_entropy_with_integer_labels(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean (optionally weighted) softmax cross-entropy; labels are class indices."""
    logits = logits.float()
    log_z = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    losses = log_z - label_logits
    if weights is not None:
        weights = weights.float()
        return torch.sum(losses * weights) / torch.clamp(torch.sum(weights), min=1e-8)
    return torch.mean(losses)


def accuracy(logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    correct = (torch.argmax(logits, dim=-1) == labels.long()).float()
    if weights is not None:
        weights = weights.float()
        return torch.sum(correct * weights) / torch.clamp(torch.sum(weights), min=1e-8)
    return torch.mean(correct)


def cross_entropy_and_accuracy(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    return cross_entropy_with_integer_labels(logits, labels, weights), accuracy(logits, labels, weights)
