"""FastAPI adapter: attach the port's serving endpoints to a user's FastAPI app.

Port of ``unionml_tpu/serving/fastapi_adapter.py`` (reference parity:
``unionml/fastapi.py:15-70``) with the identical endpoint contract: ``/``, a
sync ``/predict`` and ``/health``. ``fastapi`` (an optional dependency) is
imported when an app is attached; the native aiohttp app
(:mod:`unionml_tpu_torch.serving.app`) is the default serving surface.
"""

from http import HTTPStatus
from typing import Any, Dict, List, Optional, Union

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.app import _INDEX_HTML, jsonable, load_model_artifact
from unionml_tpu_torch.serving.resident import DEFAULT_BUCKETS, ResidentPredictor


def attach_fastapi(
    model: Any,
    app: Any,
    remote: bool = False,
    app_version: Optional[str] = None,
    model_version: str = "latest",
    resident: bool = True,
    buckets: Optional[Any] = None,
    seq_buckets: Optional[Any] = None,
    example_features: Optional[Any] = None,
    mesh: Optional[Any] = None,
    param_specs: Optional[Any] = None,
    device: Any = "cuda",
    **unsupported: Any,
) -> Any:
    """Attach ``/``, ``/predict`` and ``/health`` to ``app`` (a ``fastapi.FastAPI``,
    in place) and return it.

    At startup the model artifact loads (``UNIONML_MODEL_PATH``, or the
    backend's lineage with ``remote=True``) and, with ``resident=True``, a
    :class:`~unionml_tpu_torch.serving.resident.ResidentPredictor` on
    ``device`` (``"cuda"`` by default; it raises without a CUDA device unless
    ``"cpu"`` is asked for) captures its graphs. Options the aiohttp app has
    and this path lacks (request coalescing, ``/generate``) are logged and
    dropped. ``mesh``/``param_specs`` make the predictor meshed (see
    :class:`~unionml_tpu_torch.serving.resident.ResidentPredictor`): every
    rank attaches the app, rank 0 serves it and the other ranks follow
    (``app.resident_predictor.follow()``) until its shutdown.
    """
    from fastapi import Body, HTTPException
    from fastapi.responses import HTMLResponse

    if unsupported:
        logger.warning("attach_fastapi ignoring unsupported serving options: %s", sorted(unsupported))

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
    # the followers' handle on the predictor (every rank attaches the app)
    app.resident_predictor = predictor

    @app.on_event("startup")
    async def setup_model():
        load_model_artifact(model, remote=remote, app_version=app_version, model_version=model_version)
        if predictor is not None:
            # graftlint: disable=async-blocking -- startup hook: the warmup capture runs before the server accepts any traffic, so blocking the (idle) loop here is the point
            predictor.setup()

    @app.on_event("shutdown")
    async def release_followers():
        if predictor is not None:
            # graftlint: disable=async-blocking -- shutdown hook: a meshed predictor's release is one small message to the followers
            predictor.close()

    @app.get("/", response_class=HTMLResponse)
    def root():
        return _INDEX_HTML

    # SYNC on purpose: the predictor's replay and its device fetch block for
    # milliseconds+, which on an ``async def`` endpoint would stall the event
    # loop for every in-flight request. FastAPI runs sync endpoints in its
    # threadpool (the aiohttp app routes through run_in_executor for the same
    # reason).
    @app.post("/predict")
    def predict(
        inputs: Optional[Union[Dict[str, Any], None]] = Body(None),
        features: Optional[List[Any]] = Body(None),
    ):
        if inputs is None and features is None:
            raise HTTPException(status_code=500, detail="inputs or features must be supplied.")
        # empty {} means reader-defaults ONLY when no features came along (matches app.py)
        if inputs is not None and (inputs or features is None):
            result = predictor.predict(**inputs) if predictor is not None else model.predict(**inputs)
        else:
            # model.predict runs the feature pipeline itself; don't pre-process here
            result = (
                predictor.predict(features=features)
                if predictor is not None
                else model.predict(features=features)
            )
        return jsonable(result)

    @app.get("/health")
    async def health():
        if model.artifact is None:
            raise HTTPException(status_code=500, detail="Model artifact not found.")
        return {"message": HTTPStatus.OK.phrase, "status": HTTPStatus.OK.value}

    return app
