"""Token-sampling transforms for batched decoding (temperature, top-k, top-p).

Port of ``unionml_tpu/ops/sampling.py:29-103``. Every transform is per row over
``(batch, vocab)`` logits with per-row controls, so one decode step serves slots
with different request settings: ``top_k == 0`` and ``top_p >= 1`` are no-ops,
``temperature == 0`` selects the greedy argmax.

Randomness comes from an explicit ``torch.Generator`` where the JAX package
takes a key. Sampling is Gumbel-argmax, as ``jax.random.categorical`` is, but
the two generators give different bits from the same seed: sampled streams
match the JAX package in distribution and in their support set, never
bitwise.
"""

from typing import Optional

import torch

__all__ = ["apply_top_k", "apply_top_p", "sample_logits", "validate_sampling"]


def validate_sampling(temperature=None, top_k=0, top_p=1.0):
    """Validate and normalize the sampling contract shared by every entry point.

    ``temperature=None`` passes through (the caller's default applies).
    :returns: ``(temperature, top_k, top_p)`` as ``(Optional[float], int, float)``.
    :raises ValueError: temperature < 0, top_k < 0, or top_p outside ``(0, 1]``.
    """
    if temperature is not None:
        if isinstance(temperature, bool):
            raise ValueError("temperature must be a number")
        temperature = float(temperature)
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
    if isinstance(top_k, bool):
        raise ValueError("top_k must be an integer")
    try:
        if int(top_k) != top_k:
            raise ValueError(f"top_k must be an integer, got {top_k!r}")
    except TypeError:
        raise ValueError(f"top_k must be an integer, got {top_k!r}")
    top_k = int(top_k)
    if top_k < 0:
        raise ValueError("top_k must be >= 0")
    if isinstance(top_p, bool):
        raise ValueError("top_p must be a number")
    top_p = float(top_p)
    if not 0.0 < top_p <= 1.0:
        raise ValueError("top_p must be in (0, 1]")
    return temperature, top_k, top_p


def apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Mask each row to its ``top_k[i]`` highest logits (ties at the threshold kept).

    :param logits: ``(batch, vocab)``.
    :param top_k: ``(batch,)`` int; ``0`` disables the filter for that row.
    """
    vocab = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.clamp(top_k.to(torch.int64), 1, vocab)
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    keep = (logits >= kth) | (top_k <= 0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, float("-inf")))


def apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filter: keep each row's smallest prefix of probability mass >= ``top_p[i]``.

    At least one token (the argmax) always survives; ``top_p >= 1`` disables
    the filter for that row. The sorted keep mask is scattered back through the
    sort permutation, so tokens outside the nucleus that tie the boundary
    probability are dropped, as in the reference.
    """
    probs = torch.softmax(logits, dim=-1)
    sort_idx = torch.argsort(-probs, dim=-1, stable=True)  # ties broken by index
    sorted_probs = torch.gather(probs, -1, sort_idx)
    cumulative = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cumulative - sorted_probs) < top_p[:, None]
    inv_idx = torch.argsort(sort_idx, dim=-1)
    keep = torch.gather(keep_sorted, -1, inv_idx) | (top_p >= 1.0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, float("-inf")))


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,
    top_k: Optional[torch.Tensor] = None,
    top_p: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample one token per row honoring per-row temperature / top-k / top-p.

    Rows with ``temperature == 0`` take the greedy argmax of the raw logits;
    the rest sample from the filtered, temperature-scaled distribution by
    Gumbel-argmax with noise drawn from ``generator``.

    :param logits: ``(batch, vocab)`` float32.
    :param generator: a ``torch.Generator`` on the logits' device.
    :param temperature: ``(batch,)`` float ``>= 0``.
    :returns: ``(batch,)`` int64 token ids.
    """
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if top_k is not None:
        scaled = apply_top_k(scaled, top_k)
    if top_p is not None:
        scaled = apply_top_p(scaled, top_p)
    uniform = torch.rand(scaled.shape, generator=generator, device=scaled.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(uniform, min=tiny)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature > 0, sampled, greedy)
