"""Sequence packing: several short sequences per training row.

Port of ``unionml_tpu/ops/packing.py`` (host-side numpy, no torch needed):
greedy first-fit packing into fixed-length rows with t5x/flax segment ids
(0 = padding, 1..n = the row's packed sequences, restarting from 1 in every
row) and per-segment positions. The attention kernels confine each query to
the keys of its own segment, and the GPT model restarts its positions at
every segment start, so a packed row trains as its sequences would alone.

The output is byte-identical to the JAX package's Python path, which its
native packer also matches; the port's copy of the native packer
(``native/pack.cpp``) is not ported yet, so ``impl="native"`` raises.
"""

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["pack_sequences", "packing_efficiency"]


def pack_sequences(
    sequences: Sequence[np.ndarray],
    seq_len: int,
    *,
    pad_id: int = 0,
    max_segments_per_row: int = 0,
    impl: str = "auto",
) -> Dict[str, np.ndarray]:
    """Greedy first-fit packing of token sequences into fixed-length rows.

    :param sequences: 1-D int token arrays (ragged lengths). Empty ones are
        dropped; longer than ``seq_len`` ones are cut to ``seq_len`` and counted
        in the result's ``truncated``.
    :param pad_id: token id written into padding slots.
    :param max_segments_per_row: cap on sequences per row (0 = unlimited).
    :param impl: ``"auto"`` or ``"python"`` (the same loop); ``"native"``
        raises ``NotImplementedError``.
    :returns: ``input_ids``, ``segment_ids`` and ``positions`` (rows,
        seq_len) int32 arrays, and ``truncated`` (int).
    """
    if seq_len <= 0:
        raise ValueError(f"seq_len must be positive, got {seq_len}")
    if impl not in ("auto", "python", "native"):
        raise ValueError(f"impl must be 'auto', 'python', or 'native', got {impl!r}")
    if impl == "native":
        raise NotImplementedError("the native packer is not ported yet (ROADMAP: native packer, Queue 1)")

    arrays: List[np.ndarray] = []
    truncated = 0
    for seq in sequences:
        arr = np.asarray(seq).reshape(-1)
        if arr.size == 0:
            continue
        if arr.size > seq_len:
            arr = arr[:seq_len]
            truncated += 1
        arrays.append(arr)

    rows: List[List[np.ndarray]] = []
    row_space: List[int] = []
    row_segments: List[int] = []
    for arr in arrays:
        # first fit: the earliest row with room (and segment headroom)
        for i in range(len(rows)):
            if row_space[i] >= arr.size and (max_segments_per_row <= 0 or row_segments[i] < max_segments_per_row):
                rows[i].append(arr)
                row_space[i] -= arr.size
                row_segments[i] += 1
                break
        else:
            rows.append([arr])
            row_space.append(seq_len - arr.size)
            row_segments.append(1)

    n_rows = max(len(rows), 1)
    input_ids = np.full((n_rows, seq_len), pad_id, dtype=np.int32)
    segment_ids = np.zeros((n_rows, seq_len), dtype=np.int32)
    positions = np.zeros((n_rows, seq_len), dtype=np.int32)
    for r, row in enumerate(rows):
        offset = 0
        for s, arr in enumerate(row, start=1):
            end = offset + arr.size
            input_ids[r, offset:end] = arr
            segment_ids[r, offset:end] = s
            positions[r, offset:end] = np.arange(arr.size)
            offset = end
    return {"input_ids": input_ids, "segment_ids": segment_ids, "positions": positions, "truncated": truncated}


def packing_efficiency(segment_ids: np.ndarray) -> float:
    """Fraction of token slots carrying real tokens (1.0 = no padding at all)."""
    total = np.asarray(segment_ids).size
    return float((np.asarray(segment_ids) > 0).sum()) / total if total else 0.0
