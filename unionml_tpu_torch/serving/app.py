"""Native HTTP serving app (aiohttp): ``/``, ``/health``, ``/healthz``, ``/predict``, ``/stats``.

Port of the prediction half of ``unionml_tpu/serving/app.py``: the same
request contract (``inputs`` = reader kwargs, or ``features`` = raw
features), the same status codes (422 for a body that is not JSON, 500 for a
missing payload or a failed prediction) and the same startup model load from
``UNIONML_MODEL_PATH``. Predictions go through
:class:`~unionml_tpu_torch.serving.resident.ResidentPredictor` (a CUDA graph
per padded request shape) and, for row-list payloads, the coalescing
:class:`~unionml_tpu_torch.serving.batcher.RequestBatcher`.

``aiohttp`` is imported inside :func:`build_aiohttp_app` and :func:`run_app`
only. The ``/generate`` route and its ``generator``/``generate_*`` options
are not ported yet (ROADMAP slice 7); remote model resolution waits for M14.
"""

import os
from http import HTTPStatus
from typing import Any, Optional

import numpy as np
import torch

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.resident import DEFAULT_BUCKETS, ResidentPredictor

_INDEX_HTML = """
<html>
  <head><title>unionml-tpu-torch</title></head>
  <body>
    <h1>unionml-tpu-torch</h1>
    <p>Model training and serving on CUDA</p>
  </body>
</html>
"""


def jsonable(value: Any) -> Any:
    """Convert predictions (tensors, numpy, pandas) to JSON-serializable values."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        value = (value.float() if value.dtype == torch.bfloat16 else value).cpu().numpy()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.generic,)):
        return value.item()
    if hasattr(value, "to_dict") and not isinstance(value, dict):
        try:
            return value.to_dict(orient="records")
        except TypeError:
            return value.to_dict()
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    if isinstance(value, dict):
        return {k: jsonable(v) for k, v in value.items()}
    return value


def load_model_artifact(
    model: Any,
    remote: bool = False,
    app_version: Optional[str] = None,
    model_version: str = "latest",
    model_path: Optional[str] = None,
) -> None:
    """Startup model resolution (``fastapi.py:22-34`` parity): the local path
    from ``model_path`` or ``UNIONML_MODEL_PATH``."""
    if model.artifact is not None:
        return
    if remote:
        raise NotImplementedError("remote model resolution is not ported yet (ROADMAP: M14, the deploy surface)")
    model_path = model_path or os.getenv("UNIONML_MODEL_PATH")
    if model_path is None:
        raise ValueError("Model artifact path not specified: set UNIONML_MODEL_PATH (local mode).")
    model.load(model_path)


def build_aiohttp_app(
    model: Any,
    remote: bool = False,
    app_version: Optional[str] = None,
    model_version: str = "latest",
    resident: bool = True,
    coalesce: bool = True,
    max_batch: int = 64,
    max_wait_ms: float = 2.0,
    buckets: Optional[Any] = None,
    seq_buckets: Optional[Any] = None,
    example_features: Optional[Any] = None,
    generator: Optional[Any] = None,
    mesh: Optional[Any] = None,
    param_specs: Optional[Any] = None,
    device: Any = "cuda",
    **generate_options: Any,
):
    """Create the aiohttp application with a resident predictor.

    ``coalesce=True`` merges concurrent row-list ``features`` requests into shared
    predictor calls (see :mod:`unionml_tpu_torch.serving.batcher`); requests whose
    payloads don't fit the row-list contract fall back to per-request prediction.
    ``buckets``, ``seq_buckets`` and ``example_features`` shape the resident
    predictor's graphs (see :class:`ResidentPredictor`), which live on ``device``
    (``"cuda"`` by default: it raises without a CUDA device unless ``"cpu"``
    is asked for).
    """
    unknown = sorted(k for k in generate_options if not k.startswith("generate_") and k != "retry_jitter_rng")
    if unknown:
        raise TypeError(f"build_aiohttp_app() got unexpected keyword arguments {unknown}")
    if generator is not None or generate_options:
        raise NotImplementedError("generator / generate_* (the /generate route) is not ported yet (ROADMAP: slice 7)")
    from aiohttp import web

    app = web.Application()
    predictor = (
        ResidentPredictor(
            model,
            buckets=buckets or DEFAULT_BUCKETS,
            seq_buckets=seq_buckets,
            example_features=example_features,
            mesh=mesh,
            param_specs=param_specs,
            device=device,
        )
        if resident
        else None
    )
    batcher = None
    if coalesce and predictor is not None:
        from unionml_tpu_torch.serving.batcher import RequestBatcher

        batcher = RequestBatcher(
            lambda rows: predictor.predict(features=rows),
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
        )

    async def on_startup(app):
        load_model_artifact(model, remote=remote, app_version=app_version, model_version=model_version)
        if predictor is not None:
            # graftlint: disable=async-blocking -- startup hook: the warmup capture runs before the server accepts any traffic, so blocking the (idle) loop here is the point
            predictor.setup()
        logger.info("Serving app ready (model=%s).", model.name)

    async def on_cleanup(app):
        if batcher is not None:
            batcher.close()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    async def index(request):
        return web.Response(text=_INDEX_HTML, content_type="text/html")

    async def health(request):
        if model.artifact is None:
            return web.json_response({"detail": "Model artifact not found."}, status=500)
        return web.json_response({"message": HTTPStatus.OK.phrase, "status": HTTPStatus.OK.value})

    async def healthz(request):
        """Load-balancer health: without a supervised generator the app
        reports on the model artifact alone."""
        state = "ok" if model.artifact is not None else "failed"
        body = {"state": state, "supervised": False, "last_fault": None}
        return web.json_response(body, status=200 if state == "ok" else 503)

    async def predict(request):
        try:
            payload = await request.json()
        except Exception as exc:
            return web.json_response({"detail": f"Request body must be JSON: {exc}"}, status=422)
        inputs = payload.get("inputs")
        features = payload.get("features")
        if inputs is None and features is None:
            return web.json_response({"detail": "inputs or features must be supplied."}, status=500)
        import asyncio

        loop = asyncio.get_running_loop()
        try:
            # empty {} means reader-defaults ONLY when no features came along —
            # a boilerplate empty inputs key must not shadow a real features payload
            if inputs is not None and (inputs or features is None):
                # off the event loop: predictor calls block for milliseconds+
                result = await loop.run_in_executor(
                    None,
                    lambda: predictor.predict(**inputs) if predictor is not None else model.predict(**inputs),
                )
            else:
                result = None
                if batcher is not None and isinstance(features, list):
                    try:
                        result = await batcher.submit(features)
                    except Exception as exc:
                        logger.info("Coalesced path failed (%s); serving this request directly.", exc)
                if result is None:
                    # model.predict runs the feature pipeline itself; don't pre-process here
                    result = await loop.run_in_executor(
                        None,
                        lambda: predictor.predict(features=features)
                        if predictor is not None
                        else model.predict(features=features),
                    )
            # jsonable() may fetch device tensors: off the event loop, like the predictor calls above
            payload = await loop.run_in_executor(None, jsonable, result)
            return web.json_response(payload)
        except Exception as exc:
            logger.exception("Prediction failed")
            return web.json_response({"detail": f"Prediction failed: {exc}"}, status=500)

    async def stats(request):
        payload = {"model": model.name, "resident": predictor is not None}
        if predictor is not None:
            # server-side latency (pad, replay, fetch), split from HTTP RTT
            payload["device_latency"] = predictor.device_stats()
            payload["eager_fallbacks"] = predictor.eager_fallbacks
        if batcher is not None:
            payload["coalescing"] = dict(batcher.stats)
            if batcher.ema_gap_ms is not None:
                payload["coalescing"]["ema_gap_ms"] = round(batcher.ema_gap_ms, 3)
        return web.json_response(payload)

    app.router.add_get("/", index)
    app.router.add_get("/health", health)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/stats", stats)
    app.router.add_post("/predict", predict)
    app["unionml_model"] = model
    app["resident_predictor"] = predictor
    app["request_batcher"] = batcher
    return app


def run_app(app, host: str = "127.0.0.1", port: int = 8000) -> None:
    from aiohttp import web

    web.run_app(app, host=host, port=port)
