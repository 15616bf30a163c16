"""The port's GPT serving path: the paged ``DecodeEngine`` and the asyncio
``ContinuousBatcher`` (see :mod:`unionml_tpu_torch.serving.continuous`)."""

from unionml_tpu_torch.serving.continuous import ContinuousBatcher, DecodeEngine, StepEvent
from unionml_tpu_torch.serving.faults import EngineFailure
from unionml_tpu_torch.serving.scheduler import QueueFullError

__all__ = ["ContinuousBatcher", "DecodeEngine", "EngineFailure", "QueueFullError", "StepEvent"]
