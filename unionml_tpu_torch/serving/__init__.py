"""The port's serving: the resident predictor behind ``/predict`` (a CUDA graph
per padded request shape, :mod:`unionml_tpu_torch.serving.resident`), its
request coalescing and aiohttp app, and the GPT path's ``DecodeEngine`` (paged
or dense, full-precision or int8 weights) and asyncio ``ContinuousBatcher`` (:mod:`unionml_tpu_torch.serving.continuous`),
its SLO admission scheduler (:mod:`unionml_tpu_torch.serving.scheduler`) behind
the ``/generate`` route, its radix prefix cache
(:mod:`unionml_tpu_torch.serving.prefix_cache`), fault
injection and supervised recovery (:mod:`unionml_tpu_torch.serving.faults`,
:mod:`unionml_tpu_torch.serving.supervisor`), speculative decoding on that
engine (:mod:`unionml_tpu_torch.serving.speculative`), the telemetry
behind ``/metrics`` and ``/trace`` (:mod:`unionml_tpu_torch.serving.telemetry`,
:mod:`unionml_tpu_torch.serving.metrics`, :mod:`unionml_tpu_torch.serving.slo`),
and the engine fleet behind its prefix-affinity router
(:mod:`unionml_tpu_torch.serving.fleet`)."""

from typing import Any, Optional

from unionml_tpu_torch.serving.app import build_aiohttp_app, jsonable, load_model_artifact, run_app
from unionml_tpu_torch.serving.batcher import RequestBatcher
from unionml_tpu_torch.serving.continuous import (
    ContinuousBatcher,
    DecodeEngine,
    PreemptedSlot,
    SalvagedSlot,
    StepEvent,
)
from unionml_tpu_torch.serving.faults import EngineFailure, FaultError, FaultPlan
from unionml_tpu_torch.serving.fleet import EngineFleet, FleetConfig, Router, split_devices
from unionml_tpu_torch.serving.metrics import MetricsRegistry
from unionml_tpu_torch.serving.prefix_cache import PrefixCache
from unionml_tpu_torch.serving.resident import ResidentPredictor
from unionml_tpu_torch.serving.scheduler import (
    PRIORITY_CLASSES,
    DeadlineExceededError,
    DeadlineInfeasibleError,
    QueueFullError,
    SchedulerConfig,
    SchedulingError,
    SLOScheduler,
    parse_priority,
)
from unionml_tpu_torch.serving.slo import SLOConfig, SLOObjective, SLOTracker
from unionml_tpu_torch.serving.speculative import SpeculativeBatcher, SpeculativeEngine
from unionml_tpu_torch.serving.supervisor import EngineSupervisor
from unionml_tpu_torch.serving.telemetry import Telemetry


def serving_app(
    model: Any,
    app: Any = None,
    remote: bool = False,
    app_version: Optional[str] = None,
    model_version: str = "latest",
    resident: bool = True,
    **serving_kwargs: Any,
):
    """Build a serving app for a model (``unionml_tpu/serving/__init__.py:24-61``).

    ``app=None`` returns the native aiohttp application; extra kwargs
    (``buckets``, ``seq_buckets``, ``example_features``, ``coalesce``,
    ``device``, ``generator`` and the ``generate_*`` options of
    ``/generate``, ...) flow to :func:`build_aiohttp_app`. Any other ``app``
    raises ``TypeError``: the FastAPI adapter is not ported yet (as the JAX
    package answers when fastapi is missing).
    """
    if app is None:
        return build_aiohttp_app(
            model,
            remote=remote,
            app_version=app_version,
            model_version=model_version,
            resident=resident,
            **serving_kwargs,
        )
    raise TypeError(
        f"Unsupported app type {type(app)!r}: pass None for the native app (the FastAPI adapter is not ported yet)."
    )


__all__ = [
    "PRIORITY_CLASSES",
    "ContinuousBatcher",
    "DeadlineExceededError",
    "DeadlineInfeasibleError",
    "DecodeEngine",
    "EngineFailure",
    "EngineFleet",
    "EngineSupervisor",
    "FaultError",
    "FaultPlan",
    "FleetConfig",
    "MetricsRegistry",
    "PreemptedSlot",
    "PrefixCache",
    "QueueFullError",
    "RequestBatcher",
    "ResidentPredictor",
    "Router",
    "SLOConfig",
    "SLOObjective",
    "SLOScheduler",
    "SLOTracker",
    "SalvagedSlot",
    "SchedulerConfig",
    "SchedulingError",
    "SpeculativeBatcher",
    "SpeculativeEngine",
    "StepEvent",
    "Telemetry",
    "build_aiohttp_app",
    "jsonable",
    "load_model_artifact",
    "parse_priority",
    "run_app",
    "serving_app",
    "split_devices",
]
