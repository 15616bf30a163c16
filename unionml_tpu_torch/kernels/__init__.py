"""Hand-written CUDA kernels of the port and their launch counts.

``launches`` counts every kernel launch by kernel name. Each wrapper adds one
(:func:`note_launch`) where it launches its kernel and nowhere else, so a
caller can set the counts to 0, drive a path, and read which kernels that path
went through. A wrapper called while a CUDA graph records launches nothing
then: the graph takes those counts back (:func:`recording`) and adds them at
each replay (:class:`unionml_tpu_torch._graphs.CapturedGraph`).

The counts stay exact when several threads launch at once (the replicas of an
engine fleet sharing one card, each on its own worker thread): every thread
adds to a tally of its own, which no other thread writes, and ``launches``
reads the sum of the tallies. A recording takes back only what its own thread
counted while it was open, so a launch another thread made meanwhile stays
where it ran.
"""

import contextlib
import threading
from collections.abc import Mapping
from typing import Dict, Iterator

__all__ = ["launches", "note_launch", "recording", "reset_launches", "tallies"]

KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_attention")

_lock = threading.Lock()
#: thread ident -> that thread's launches per kernel; each dict is written
#: only by its own thread (a reused ident continues the same tally, which
#: keeps every sum exact)
_tallies: Dict[int, Dict[str, int]] = {}  # guarded-by: _lock (the map; each tally is its thread's own)
_local = threading.local()


def _own() -> Dict[str, int]:
    tally = getattr(_local, "tally", None)
    if tally is None:
        with _lock:
            tally = _tallies.setdefault(threading.get_ident(), dict.fromkeys(KERNEL_NAMES, 0))
        _local.tally = tally
    return tally


def note_launch(name: str, count: int = 1) -> None:
    """Add ``count`` launches of kernel ``name`` to this thread's tally."""
    tally = _own()
    tally[name] += count


class _Launches(Mapping):
    """Launches per kernel name, summed over every thread's tally."""

    def __getitem__(self, name: str) -> int:
        if name not in KERNEL_NAMES:
            raise KeyError(name)
        with _lock:
            return sum(tally[name] for tally in _tallies.values())

    def __iter__(self) -> Iterator[str]:
        return iter(KERNEL_NAMES)

    def __len__(self) -> int:
        return len(KERNEL_NAMES)

    def __repr__(self) -> str:
        return repr(dict(self))


#: launches per kernel since the last :func:`reset_launches`
launches = _Launches()


def tallies() -> Dict[int, Dict[str, int]]:
    """A copy of every thread's tally, by thread ident (their sum is ``launches``)."""
    with _lock:
        return {ident: dict(tally) for ident, tally in _tallies.items()}


def reset_launches() -> None:
    """Set every count to 0 (call it while no thread launches)."""
    with _lock:
        for tally in _tallies.values():
            for name in tally:
                tally[name] = 0


@contextlib.contextmanager
def recording():
    """Take back what this thread counts inside the block (a CUDA graph's
    recording, which launches nothing): yields a dict that holds, on exit,
    the launches by name the block counted on this thread, already removed
    from its tally. Other threads' counts are untouched."""
    tally = _own()
    before = dict(tally)
    recorded: Dict[str, int] = {}
    try:
        yield recorded
    finally:
        for name in KERNEL_NAMES:
            count = tally[name] - before[name]
            if count:
                tally[name] -= count
                recorded[name] = count
