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

Keyed selection is the exception (:func:`keyed_select`, the selection rule of
``unionml_tpu/serving/speculative.py:241-253``): a token is a pure function of
(slot key, position). It ports JAX's threefry2x32 (``jax_threefry_partitionable``
on, the JAX default) in int64 torch ops, so :func:`fold_in` and
:func:`random_bits` give JAX's bits exactly and :func:`keyed_categorical` draws
what ``jax.random.categorical`` draws (up to the last bit of ``log``). A
``torch.Generator`` cannot give a per-(row, position) stream inside one CUDA
graph; a function of its inputs can.
"""

from typing import Optional

import torch

__all__ = [
    "apply_top_k", "apply_top_p", "fold_in", "keyed_categorical", "keyed_select", "random_bits", "sample_logits",
    "threefry2x32", "validate_sampling",
]

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


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


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) as ``jax._src.prng`` computes it.

    Every argument holds uint32 values in an int64 tensor (broadcastable
    shapes); returns the two uint32 output words, int64 as well.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK32, (x2 + ks[1]) & _MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x[0], x[1]


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of raw threefry keys, row by row.

    :param keys: ``(..., 2)`` int64 holding uint32 key words.
    :param data: ``(...)`` integers below 2**32 (the JAX engine folds in int32
        positions cast to uint32).
    :returns: ``(..., 2)`` int64, the folded keys.
    """
    k1, k2 = keys[..., 0], keys[..., 1]
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(k1), data.long() & _MASK32)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each row of ``keys``
    ``(rows, 2)`` under the partitionable threefry layout: element ``i`` is
    the XOR of the two words of ``threefry2x32(key, (0, i))``. Returns
    ``(rows, n)`` int64."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(counts), counts)
    return b1 ^ b2


def keyed_categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)``: Gumbel-argmax with
    the uniforms built from :func:`random_bits` as ``jax.random.uniform``
    builds them (23 mantissa bits, then ``[tiny, 1)``). ``logits`` is
    ``(rows, vocab)`` float32; returns ``(rows,)`` int64."""
    bits = random_bits(keys, logits.shape[-1])
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    uniform = torch.clamp_min(floats + tiny, tiny)
    return torch.argmax(-torch.log(-torch.log(uniform)) + logits, dim=-1)


def keyed_select(logits: torch.Tensor, keys: torch.Tensor, positions: torch.Tensor,
                 temperature: torch.Tensor) -> torch.Tensor:
    """THE selection rule of the speculative round: greedy argmax where a
    row's temperature is 0, else a categorical at that temperature keyed by
    ``fold_in(slot key, position)``, so one position always draws one token
    whichever program or round evaluates it.

    :param logits: ``(rows, vocab)``; ``keys`` ``(rows, 2)``; ``positions``
        ``(rows,)``; ``temperature`` ``(rows,)``. Returns ``(rows,)`` int64.
    """
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp_min(temperature, 1e-6)[:, None]
    drawn = keyed_categorical(fold_in(keys, positions), scaled)
    return torch.where(temperature > 0, drawn, greedy)
