"""Sequence packing: several short sequences per training row.

Port of ``unionml_tpu/ops/packing.py`` (host-side numpy, no torch needed):
greedy first-fit packing into fixed-length rows with t5x/flax segment ids
(0 = padding, 1..n = the row's packed sequences, restarting from 1 in every
row) and per-segment positions. The attention kernels confine each query to
the keys of its own segment, and the GPT model restarts its positions at
every segment start, so a packed row trains as its sequences would alone.

The output is byte-identical to the JAX package's Python path, which its
native packer also matches. ``impl="native"`` (and ``"auto"`` for corpora of
``NATIVE_PACK_THRESHOLD`` or more sequences) runs the port's own copy of that
packer (``native/pack.cpp``, :func:`~unionml_tpu_torch.native.pack_sequences_native`),
the same first fit in C++; without a compiler it falls back to the Python
loop, as the JAX package does.
"""

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["NATIVE_PACK_THRESHOLD", "pack_sequences", "packing_efficiency"]

#: corpora at least this large route to the native packer under impl="auto"
#: (``unionml_tpu/ops/packing.py:26-28``): below it the ctypes marshalling
#: rivals the Python loop's cost
NATIVE_PACK_THRESHOLD = 2048


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
    :param impl: ``"python"``, ``"native"`` (the C++ packer, built on first
        use; the Python loop when no compiler is found) or ``"auto"`` (native
        for ``NATIVE_PACK_THRESHOLD`` or more sequences). Both run the same
        first fit and give byte-identical arrays.
    :returns: ``input_ids``, ``segment_ids`` and ``positions`` (rows,
        seq_len) int32 arrays, and ``truncated`` (int).
    """
    if seq_len <= 0:
        raise ValueError(f"seq_len must be positive, got {seq_len}")
    if impl not in ("auto", "python", "native"):
        raise ValueError(f"impl must be 'auto', 'python', or 'native', got {impl!r}")

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

    if impl == "native" or (impl == "auto" and len(arrays) >= NATIVE_PACK_THRESHOLD):
        from unionml_tpu_torch.native import pack_sequences_native

        lengths = np.asarray([a.size for a in arrays], dtype=np.int64)
        flat = (np.concatenate([a.astype(np.int32, copy=False) for a in arrays]) if arrays
                else np.empty((0,), dtype=np.int32))
        packed = pack_sequences_native(flat, lengths, seq_len, pad_id, max_segments_per_row)
        if packed is not None:
            packed["truncated"] = truncated
            return packed
        # no toolchain: the Python loop below

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
