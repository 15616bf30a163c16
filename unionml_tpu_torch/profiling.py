"""Tracing & profiling: per-stage timing plus ``torch.profiler`` capture.

Port of ``unionml_tpu/profiling.py``. Every :class:`~unionml_tpu_torch.stage.Stage`
records its last wall-clock duration (surfaced via :func:`workflow_timings` and
the CLI's ``train --profile-dir``); :func:`xprof_trace` captures a
``torch.profiler`` trace around any block (a Chrome trace JSON, viewable in
Perfetto or ``chrome://tracing``: host operators, and the card's kernels when
CUDA is available); :func:`device_memory_stats` reports each CUDA device's
memory.
"""

import contextlib
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from unionml_tpu_torch._logging import logger


@contextlib.contextmanager
def xprof_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host operators, plus CUDA kernels
    when a CUDA device is available) into ``log_dir`` as a Chrome trace file."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    logger.info("Starting profiler trace -> %s", log_dir)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("Profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a region in profiler traces (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


def workflow_timings(workflow: Any) -> Dict[str, Optional[float]]:
    """Last-run durations of every stage in a workflow (None = not yet run)."""
    return {node.stage.name: node.stage.last_duration for node in workflow.nodes}


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-device memory statistics: bytes in use, their peak and the card's
    total memory for each CUDA device; without one, a single CPU entry whose
    values are None (the JAX package's answer for a backend that reports no
    memory statistics)."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None, "bytes_limit": None, "peak_bytes_in_use": None}]
    stats = []
    for index in range(torch.cuda.device_count()):
        raw = torch.cuda.memory_stats(index)
        stats.append(
            {
                "device": f"cuda:{index}",
                "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
                "bytes_limit": torch.cuda.mem_get_info(index)[1],
                "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
            }
        )
    return stats
