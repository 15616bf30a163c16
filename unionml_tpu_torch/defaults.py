"""Default resource requests for the port's stages.

Port of ``unionml_tpu/defaults.py``: the same frozen ``Resources`` spec
attached to every stage, naming GPUs (a count and the memory of each card)
where the JAX package names a TPU accelerator type and topology.
"""

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Resources:
    """Resource request attached to a stage / job spec.

    ``gpu`` is the number of CUDA devices a stage asks for (0 for a host-only
    stage) and ``gpu_memory`` the device memory it needs on each (e.g.
    ``"80Gi"``); ``host_count`` > 1 asks for several hosts.
    """

    cpu: str = "1"
    mem: str = "1Gi"
    gpu: int = 0
    gpu_memory: Optional[str] = None
    host_count: int = 1


DEFAULT_RESOURCES = Resources(cpu="1", mem="1Gi")
