"""Hand-written CUDA kernels of the port and their launch counts.

``launches`` counts every kernel launch by kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a caller can set the counts
to 0, drive a path, and read which kernels that path went through. A wrapper
called while a CUDA graph records launches nothing then: the graph takes
those counts back and adds them at each replay
(:class:`unionml_tpu_torch._graphs.CapturedGraph`).
"""

from typing import Dict

__all__ = ["launches", "reset_launches"]

#: launches per kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "paged_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
