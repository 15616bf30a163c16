"""Host-side native components (C++), consumed through ``ctypes``.

Port of ``unionml_tpu/native/__init__.py`` over the port's own copies of its
sources (``pack.cpp``, ``prefetch.cpp``):

- :func:`pack_sequences_native` — the first-fit sequence packer behind
  ``pack_sequences(impl="native")`` (and ``"auto"`` for large corpora);
- :class:`PrefetchLoader` — the threaded batch gatherer behind
  ``fit(prefetch=True)``. Its slots are torch tensors, pinned when the loader
  feeds a CUDA device, and the C++ workers gather (and convert) rows straight
  into them, so a batch goes to the card by one asynchronous copy.

Both sources compile into one shared library with the system toolchain
(``g++ -O3 -shared -fPIC -pthread -std=c++17``) on first use, never at import.
It lands in ``build/torch_native/`` at the repository root under a name that
carries a hash of the sources and flags, as the CUDA kernels' builds do
(``kernels/_build.py``): an edited source builds anew, an unchanged one
loads. Without a compiler the callers take the Python paths, as the JAX
package's do (``native_available()`` and ``PrefetchLoader.uses_native`` say
which ran); a cached library that lacks a symbol is rebuilt once from the
sources before the Python paths are taken.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from unionml_tpu_torch._logging import logger

__all__ = ["BUILD_DIR", "PrefetchLoader", "load_native_library", "native_available", "pack_sequences_native"]

_SOURCES = (
    Path(__file__).parent / "prefetch.cpp",
    Path(__file__).parent / "pack.cpp",
)
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

#: worker-side dtype conversions (mirrors the Conv enum in prefetch.cpp):
#: "source->target" -> conv code
_CONV_CODES = {
    "float64->float32": 1,
    "int64->int32": 2,
    "float32->bfloat16": 3,
}


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256()
    for src in _SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libunionml_native-{digest.hexdigest()[:16]}.so"


def _compile(lib_path: Path) -> None:
    """Compile every native source into ``lib_path`` (through a temporary
    file, so a concurrent loader never maps a half-written library)."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, *[str(src) for src in _SOURCES], "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)
    logger.info("Built the native library -> %s", lib_path)


def _build_and_load(lib_path: Path) -> ctypes.CDLL:
    """Compile (when missing) and dlopen the native library.

    Raises ``subprocess.CalledProcessError`` / ``OSError`` on toolchain or
    loader failure: the caller decides the fallback.
    """
    if not lib_path.exists():
        _compile(lib_path)
    return ctypes.CDLL(str(lib_path))


def _rebuild_and_load_fresh(lib_path: Path) -> ctypes.CDLL:
    """Replace a bad cached library and dlopen the REBUILT code in this process.

    The canonical path gets the fresh build (later processes load it), but
    glibc dedupes ``dlopen`` by pathname, so reopening ``lib_path`` here would
    hand back the stale mapping: this process maps the rebuilt library
    through a unique alias (unlinked at once; the mapping outlives the name).
    """
    lib_path.unlink(missing_ok=True)
    _compile(lib_path)
    alias = lib_path.with_name(f"{lib_path.stem}.heal-{os.getpid()}-{time.monotonic_ns()}.so")
    try:
        shutil.copy2(lib_path, alias)
        return ctypes.CDLL(str(alias))
    finally:
        alias.unlink(missing_ok=True)


def load_native_library() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native library; None when unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib_path = library_path()
        try:
            # graftlint: disable=lock-order -- the lock serializes the ONE-TIME g++ build: concurrent first callers wait for the compile rather than race it; every later call returns the cached handle
            lib = _build_and_load(lib_path)
        except (subprocess.CalledProcessError, OSError) as exc:
            detail = getattr(exc, "stderr", b"")
            logger.warning(
                "Native library unavailable (%s %s); falling back to the Python paths.",
                exc,
                detail.decode(errors="replace")[:500] if isinstance(detail, bytes) else detail,
            )
            _build_failed = True
            return None

        for attempt in (0, 1):
            try:
                _bind_symbols(lib)
                break
            except AttributeError as exc:
                # a cached library that lacks a symbol (a truncated or foreign
                # build at the hashed path): rebuild from the sources ONCE
                if attempt == 0:
                    logger.warning("Native library at %s is missing symbols (%s); rebuilding from source.",
                                   lib_path, exc)
                    try:
                        # graftlint: disable=lock-order -- the same one-time-build serialization as above
                        lib = _rebuild_and_load_fresh(lib_path)
                        continue
                    except (subprocess.CalledProcessError, OSError) as build_exc:
                        logger.warning("Native rebuild failed (%s); falling back to Python.", build_exc)
                else:
                    logger.warning("Rebuilt native library still missing symbols (%s); falling back to "
                                   "Python. Delete %s to force another rebuild.", exc, lib_path)
                _build_failed = True
                return None
        _lib = lib
        return _lib


def _bind_symbols(lib: ctypes.CDLL) -> None:
    """Declare every C-ABI signature; AttributeError if any symbol is absent."""
    lib.upf_create.restype = ctypes.c_void_p
    lib.upf_create.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
        ctypes.c_long,
    ]
    lib.upf_start.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.upf_next.restype = ctypes.c_long
    lib.upf_next.argtypes = [ctypes.c_void_p]
    lib.upf_release.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.upf_destroy.argtypes = [ctypes.c_void_p]
    lib.upk_pack.restype = ctypes.c_longlong
    lib.upk_pack.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_int32,
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.upk_count_rows.restype = ctypes.c_longlong
    lib.upk_count_rows.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_longlong,
    ]


def native_available() -> bool:
    return load_native_library() is not None


def pack_sequences_native(
    flat_tokens: np.ndarray,
    lengths: np.ndarray,
    seq_len: int,
    pad_id: int,
    max_segments_per_row: int,
) -> Optional[Dict[str, np.ndarray]]:
    """First-fit packing through the native library; None when it is unavailable.

    Inputs are normalized by :func:`unionml_tpu_torch.ops.packing.pack_sequences`
    (empties dropped, overlong sequences cut, tokens concatenated); the
    wrapper checks that ``lengths`` sums to ``flat_tokens.size`` (the C side
    walks the buffer unchecked) and runs the two-pass protocol: count rows,
    allocate exact outputs, pack. The arrays are byte-identical to the
    Python path's.
    """
    lib = load_native_library()
    if lib is None:
        return None
    flat_tokens = np.ascontiguousarray(flat_tokens, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    if int(lengths.sum()) != flat_tokens.size:
        # a short buffer would be an out-of-bounds READ in upk_pack: reject the
        # call and let the Python path (which indexes safely) report the inputs
        logger.warning(
            "Native packer input mismatch: lengths sum to %d but flat_tokens has %d tokens; using the Python path.",
            int(lengths.sum()), flat_tokens.size,
        )
        return None
    n_seqs = int(lengths.size)
    lengths_ptr = lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    # two passes: count rows first, then allocate exact outputs (a worst-case
    # (n_seqs, seq_len) x3 allocation is multi-GB at the corpus scales this
    # packer exists for); the count runs the identical first-fit loop
    n_rows = lib.upk_count_rows(lengths_ptr, n_seqs, seq_len, max_segments_per_row)
    if n_rows < 0:
        logger.warning("Native packer rejected inputs (rc=%d); using the Python path.", n_rows)
        return None
    input_ids = np.empty((n_rows, seq_len), dtype=np.int32)
    segment_ids = np.empty((n_rows, seq_len), dtype=np.int32)
    positions = np.empty((n_rows, seq_len), dtype=np.int32)

    def as_i32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    packed_rows = lib.upk_pack(as_i32(flat_tokens), lengths_ptr, n_seqs, seq_len, pad_id, max_segments_per_row,
                               as_i32(input_ids), as_i32(segment_ids), as_i32(positions))
    if packed_rows != n_rows:  # the two passes must agree exactly
        logger.warning("Native packer row-count mismatch (%d vs %d); using the Python path.", packed_rows, n_rows)
        return None
    return {"input_ids": input_ids, "segment_ids": segment_ids, "positions": positions}


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _resolve_conversion(array: np.ndarray, target: Optional[str]) -> Tuple[int, torch.dtype]:
    """(conv code, destination torch dtype) for one source array."""
    source = _torch_dtype(array.dtype)
    if target is None:
        return 0, source
    target_dtype = torch.bfloat16 if target == "bfloat16" else _torch_dtype(np.dtype(target))
    if target_dtype == source:
        return 0, source  # a no-op conversion request: plain gather
    key = f"{array.dtype.name}->{target}"
    code = _CONV_CODES.get(key)
    if code is None:
        raise ValueError(f"Unsupported native conversion {key!r}; supported: {sorted(_CONV_CODES)}")
    return code, target_dtype


class PrefetchLoader:
    """Iterate dict batches of host tensors gathered by the native threaded
    prefetcher (``unionml_tpu/native/__init__.py::PrefetchLoader``).

    Wraps a mapping of name -> contiguous host array; each epoch yields dict
    batches in shuffled order, the gather running in C++ threads while the
    consumer computes.

    - Slot buffers are torch tensors OWNED BY PYTHON (pinned with
      ``pin_memory=True``, which needs a CUDA device); the C++ workers gather
      straight into them, so a ``copy=False`` consumer copies a batch to the
      card asynchronously with no further host copy. A slot recycles only
      once it is released (``defer_release``) or the generator resumes.
    - ``convert={"name": "float32" | "int32" | "bfloat16"}`` runs the dtype
      conversion inside the workers (f64->f32, i64->i32, f32->bf16 with
      round-to-nearest-even into a ``torch.bfloat16`` slot).

    - ``rows`` maps each batch's row indices (in epoch order) to the rows
      this process gathers: a mesh rank's share of the global batch
      (``models/training.py::rank_rows``), so the workers read only those.

    Falls back to gathering in Python when the native library cannot build
    (``uses_native`` is then False).
    """

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        batch_size: int,
        *,
        n_slots: int = 4,
        n_threads: int = 2,
        drop_remainder: bool = True,
        convert: Optional[Dict[str, str]] = None,
        pin_memory: bool = False,
        rows: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        self._keys = list(data)
        self._arrays = [np.ascontiguousarray(np.asarray(data[k])) for k in self._keys]
        n_rows = {a.shape[0] for a in self._arrays}
        if len(n_rows) != 1:
            raise ValueError(f"All arrays must share the leading dimension; got {n_rows}")
        self.n_rows = n_rows.pop()
        self.batch_size = batch_size
        self._rows = rows
        #: rows one slot holds: a batch's, or this process's share of one (``rows``)
        self.slot_rows = batch_size if rows is None else len(rows(np.arange(batch_size)))
        self.n_slots = n_slots
        self.n_threads = n_threads
        self.drop_remainder = drop_remainder
        self.pin_memory = pin_memory

        convert = convert or {}
        unknown = set(convert) - set(self._keys)
        if unknown:
            raise ValueError(f"convert refers to unknown arrays: {sorted(unknown)}")
        self._conv_codes: List[int] = []
        self._dst_dtypes: List[torch.dtype] = []
        for key, array in zip(self._keys, self._arrays):
            code, dst = _resolve_conversion(array, convert.get(key))
            self._conv_codes.append(code)
            self._dst_dtypes.append(dst)

        self._lib = load_native_library()
        self._handle = None
        self._slots: List[List[torch.Tensor]] = []
        self._slot_ptr_table = None
        if self._lib is not None:
            n = len(self._arrays)
            sources = (ctypes.c_void_p * n)(*[a.ctypes.data_as(ctypes.c_void_p).value for a in self._arrays])
            row_bytes = (ctypes.c_long * n)(*[a.strides[0] for a in self._arrays])
            dst_row_bytes = (ctypes.c_long * n)(*self._dst_row_bytes())
            conv_codes = (ctypes.c_long * n)(*self._conv_codes)
            self._handle = self._lib.upf_create(sources, row_bytes, conv_codes, dst_row_bytes, n, self.n_rows)
            self._allocate_slots()

    def _dst_row_bytes(self) -> List[int]:
        out = []
        for array, dst in zip(self._arrays, self._dst_dtypes):
            row_elems = int(np.prod(array.shape[1:], dtype=np.int64)) if array.ndim > 1 else 1
            out.append(row_elems * dst.itemsize)
        return out

    def _allocate_slots(self) -> None:
        """Python-owned destination tensors: [n_slots][n_arrays]."""
        self._slots = []
        pointers = []
        for _ in range(self.n_slots):
            slot = []
            for array, dst in zip(self._arrays, self._dst_dtypes):
                buf = torch.empty((self.slot_rows,) + array.shape[1:], dtype=dst, pin_memory=self.pin_memory)
                slot.append(buf)
                pointers.append(buf.data_ptr())
            self._slots.append(slot)
        self._slot_ptr_table = (ctypes.c_void_p * len(pointers))(*pointers)

    @property
    def uses_native(self) -> bool:
        return self._handle is not None

    def _python_batch(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        if self._rows is not None:
            idx = self._rows(idx)
        return {key: torch.from_numpy(array[idx]).to(dst)
                for key, array, dst in zip(self._keys, self._arrays, self._dst_dtypes)}

    def epoch(
        self,
        rng: Optional[np.random.Generator] = None,
        copy: bool = True,
        defer_release: bool = False,
    ) -> Iterator[Any]:
        """Yield one epoch of dict batches in shuffled order
        (``rng.permutation(n_rows)``, as ``dict_batches`` draws it).

        ``copy=True`` (default) yields tensors of their own: safe for any
        consumer. ``copy=False`` yields the slot tensors themselves, which
        recycle after the generator resumes (or, with ``defer_release``,
        once released): the consumer must be done reading them by then.

        ``defer_release=True`` yields ``(views, release)`` pairs: the slot
        recycles only when ``release()`` is called, so a consumer may hold a
        batch (an asynchronous device copy in flight) while pulling the next.
        Release in yield order; holding more than ``n_slots - 1`` unreleased
        batches stalls the workers.
        """
        indices = (np.arange(self.n_rows, dtype=np.int64) if rng is None
                   else rng.permutation(self.n_rows).astype(np.int64))
        # the native path only gathers FULL batches (its slots are fixed-size);
        # a ragged tail comes from the Python gather below
        n_full = self.n_rows // self.batch_size
        remainder = self.n_rows - n_full * self.batch_size

        def emit(views, release=None):
            # Python-gathered batches are fresh tensors: release is a no-op
            return (views, release or (lambda: None)) if defer_release else views

        def tail_batches():
            if not self.drop_remainder and remainder:
                yield emit(self._python_batch(indices[n_full * self.batch_size:]))
            elif n_full == 0:
                # a dataset smaller than one batch yields its one true batch
                yield emit(self._python_batch(indices))

        if self._handle is None or n_full == 0:
            for b in range(n_full):
                yield emit(self._python_batch(indices[b * self.batch_size:(b + 1) * self.batch_size]))
            yield from tail_batches()
            return

        full = indices[: n_full * self.batch_size]
        if self._rows is not None:
            # each batch's share of this process, gathered natively in slots of that size
            full = np.concatenate([self._rows(full[b * self.batch_size:(b + 1) * self.batch_size])
                                   for b in range(n_full)]).astype(np.int64)
        indices_c = np.ascontiguousarray(full)
        self._lib.upf_start(self._handle, indices_c.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_full,
                            self.slot_rows, self.n_slots, self.n_threads, self._slot_ptr_table)
        try:
            while True:
                batch = self._lib.upf_next(self._handle)
                if batch < 0:
                    break
                slot = self._slots[batch % self.n_slots]
                views = {key: (buf.clone() if copy else buf) for key, buf in zip(self._keys, slot)}
                if defer_release:
                    released = [False]

                    def release(b=batch, flag=released):
                        if not flag[0] and self._handle is not None:
                            flag[0] = True
                            self._lib.upf_release(self._handle, b)

                    yield views, release
                else:
                    yield views
                    self._lib.upf_release(self._handle, batch)
            yield from tail_batches()
        finally:
            del indices_c

    def close(self) -> None:
        if self._handle is not None and self._lib is not None:
            self._lib.upf_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:  # best-effort-release shape: recognized by the lint
            pass
