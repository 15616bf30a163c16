"""The port's serving: the resident predictor behind ``/predict`` (a CUDA graph
per padded request shape, :mod:`unionml_tpu_torch.serving.resident`), its
request coalescing and aiohttp app, and the GPT path's paged ``DecodeEngine``
and asyncio ``ContinuousBatcher`` (:mod:`unionml_tpu_torch.serving.continuous`)."""

from typing import Any, Optional

from unionml_tpu_torch.serving.app import build_aiohttp_app, jsonable, load_model_artifact, run_app
from unionml_tpu_torch.serving.batcher import RequestBatcher
from unionml_tpu_torch.serving.continuous import ContinuousBatcher, DecodeEngine, StepEvent
from unionml_tpu_torch.serving.faults import EngineFailure
from unionml_tpu_torch.serving.resident import ResidentPredictor
from unionml_tpu_torch.serving.scheduler import QueueFullError


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
    ``device``, ...) flow to :func:`build_aiohttp_app`. Any other ``app``
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
    "ContinuousBatcher",
    "DecodeEngine",
    "EngineFailure",
    "QueueFullError",
    "RequestBatcher",
    "ResidentPredictor",
    "StepEvent",
    "build_aiohttp_app",
    "jsonable",
    "load_model_artifact",
    "run_app",
    "serving_app",
]
