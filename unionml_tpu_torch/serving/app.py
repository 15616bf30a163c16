"""Native HTTP serving app (aiohttp): ``/``, ``/health``, ``/healthz``, ``/predict``,
``/generate``, ``/stats``, ``/metrics``, ``/trace/{request_id}``, ``/traces/recent``.

Port of ``unionml_tpu/serving/app.py``: the same ``/predict`` contract
(``inputs`` = reader kwargs, or ``features`` = raw features; 422 for a body
that is not JSON, 500 for a missing payload or a failed prediction) and the
same startup model load from ``UNIONML_MODEL_PATH``. Predictions go through
:class:`~unionml_tpu_torch.serving.resident.ResidentPredictor` (a CUDA graph
per padded request shape) and, for row-list payloads, the coalescing
:class:`~unionml_tpu_torch.serving.batcher.RequestBatcher`.

``POST /generate`` serves a decoder through
:class:`~unionml_tpu_torch.serving.continuous.ContinuousBatcher` (or a
:class:`~unionml_tpu_torch.serving.speculative.SpeculativeBatcher`, or
``generate_replicas`` engines behind an
:class:`~unionml_tpu_torch.serving.fleet.EngineFleet`) with the
JAX route's status contract: ``priority`` and ``deadline_ms`` in the payload,
400 for an invalid request, 429/503 for sheds and 504 for an expired
deadline (with a jittered ``Retry-After``), 500/503 for engine failures, all
in one envelope ``{"error": {"code", "reason", "detail", "retry_after_ms"?,
"request_id"}}``. The payload checks (:func:`parse_generate_payload`), the
exception mapping (:func:`error_for`), the ``/stats`` and ``/healthz``
bodies and the telemetry routes' answers (:func:`metrics_answer`,
:func:`trace_answer`, :func:`traces_recent_answer`) are plain functions that
import no ``aiohttp``: the routes call them, and so can a caller without
``aiohttp``.

``aiohttp`` is imported inside :func:`build_aiohttp_app` and :func:`run_app`
only. With ``remote=True`` the model loads from the execution backend's
lineage at startup (:func:`unionml_tpu_torch.remote.get_model_artifact`).
"""

import dataclasses
import os
import random
from http import HTTPStatus
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.ops.sampling import validate_sampling
from unionml_tpu_torch.serving.faults import EngineFailure
from unionml_tpu_torch.serving.resident import DEFAULT_BUCKETS, ResidentPredictor
from unionml_tpu_torch.serving.scheduler import (
    DeadlineExceededError,
    DeadlineInfeasibleError,
    QueueFullError,
    SchedulingError,
    parse_priority,
)
from unionml_tpu_torch.serving.telemetry import Telemetry, new_request_id

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
    from ``model_path`` or ``UNIONML_MODEL_PATH``, or with ``remote=True`` the
    trained model ``model_version`` of ``app_version`` from the backend."""
    if model.artifact is not None:
        return
    if remote:
        from unionml_tpu_torch.remote import get_model_artifact

        model.artifact = get_model_artifact(model, app_version=app_version, model_version=model_version)
        return
    model_path = model_path or os.getenv("UNIONML_MODEL_PATH")
    if model_path is None:
        raise ValueError("Model artifact path not specified: set UNIONML_MODEL_PATH (local mode).")
    model.load(model_path)


def error_envelope(status: int, reason: str, detail: str, *, retry_after_s: Optional[float] = None,
                   request_id: Optional[str] = None, rng: Optional[random.Random] = None
                   ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
    """The one error envelope of every non-200 ``/generate`` answer:
    ``(status, {"error": {"code", "reason", "detail", "retry_after_ms"?,
    "request_id"?}}, headers)``. ``retry_after_ms`` and the ``Retry-After``
    header carry ±25% jitter drawn from ``rng`` (default: the module's
    global generator), so a shed wave does not retry in lockstep."""
    error: Dict[str, Any] = {"code": int(status), "reason": reason, "detail": detail}
    if request_id is not None:
        error["request_id"] = request_id
    headers: Dict[str, str] = {}
    if retry_after_s:
        draw = rng.random if rng is not None else random.random
        jittered = float(retry_after_s) * (0.75 + 0.5 * draw())
        error["retry_after_ms"] = int(jittered * 1000)
        headers["Retry-After"] = str(max(1, round(jittered)))
    return int(status), {"error": error}, headers


def error_for(exc: BaseException, *, request_id: Optional[str] = None,
              rng: Optional[random.Random] = None) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
    """Map a generation failure to its envelope: a queue-full shed is 429,
    an infeasible deadline 503 (both with ``Retry-After``), an expired one
    504; an ``EngineFailure`` is 503 with ``Retry-After`` when retryable,
    else 500; a ``ValueError`` is 400; anything else 500 ``internal``."""
    if isinstance(exc, SchedulingError):
        if isinstance(exc, QueueFullError):
            status = 429
        elif isinstance(exc, DeadlineInfeasibleError):
            status = 503
        elif isinstance(exc, DeadlineExceededError):
            status = 504
        else:
            status = 500
        return error_envelope(status, exc.reason, str(exc), retry_after_s=exc.retry_after_s,
                              request_id=request_id, rng=rng)
    if isinstance(exc, EngineFailure):
        retryable = bool(exc.retryable)
        return error_envelope(503 if retryable else 500, exc.reason, str(exc),
                              retry_after_s=1.0 if retryable else None, request_id=request_id, rng=rng)
    if isinstance(exc, ValueError):
        return error_envelope(400, getattr(exc, "reason", "invalid_request"), str(exc), request_id=request_id)
    return error_envelope(500, "internal", f"Generation failed: {exc}", request_id=request_id)


class PayloadError(ValueError):
    """A ``/generate`` payload the route rejects with 400 and ``reason``."""

    def __init__(self, detail: str, reason: str = "invalid_request") -> None:
        super().__init__(detail)
        self.reason = reason


@dataclasses.dataclass
class GenerateRequest:
    """A checked ``/generate`` payload: one prompt (``prompt_ids``) or a batch
    (``prompts``), the budget, the SLO keywords (``priority``,
    ``deadline_ms``) and the sampling keywords to forward, and ``stream``."""

    prompt_ids: Optional[List[int]]
    prompts: Optional[List[Any]]
    max_new_tokens: int
    slo: Dict[str, Any]
    sampling: Dict[str, Any]
    stream: bool


def parse_generate_payload(payload: Any, gen: Any) -> GenerateRequest:
    """Check a ``/generate`` payload against generator ``gen`` in the JAX
    route's order; raises :class:`PayloadError` with its message and reason.
    Every prompt is checked before any is scheduled. ``session_id`` is
    checked and forwarded to a fleet only (stickiness is the router's; a solo
    generator takes no such keyword)."""
    if not isinstance(payload, dict):
        raise PayloadError("prompt_ids (one prompt) or prompts (a batch) must be supplied.")
    prompt_ids, prompts = payload.get("prompt_ids"), payload.get("prompts")
    if prompt_ids is None and prompts is None:
        raise PayloadError("prompt_ids (one prompt) or prompts (a batch) must be supplied.")
    try:
        max_new = int(payload.get("max_new_tokens", 32))
    except (TypeError, ValueError):
        raise PayloadError("max_new_tokens must be an integer.") from None
    if max_new < 1:
        # checked here so a stream rejects before its 200 status line
        raise PayloadError("max_new_tokens must be >= 1.")
    try:
        for p in [prompt_ids] if prompt_ids is not None else prompts:
            seq = np.asarray(p, dtype=np.int32).reshape(-1)
            if seq.size == 0:
                raise ValueError("empty prompt")
            if seq.size >= gen.engine.max_len:
                raise ValueError(f"prompt length {seq.size} >= max_len ({gen.engine.max_len})")
            gen.engine.bucket_for(seq.size)
    except (TypeError, ValueError) as exc:
        raise PayloadError(f"invalid prompt payload: {exc}") from None
    slo: Dict[str, Any] = {}
    if payload.get("priority") is not None:
        try:
            slo["priority"] = parse_priority(payload["priority"])
        except ValueError as exc:
            raise PayloadError(str(exc)) from None
    if payload.get("deadline_ms") is not None:
        deadline_ms = payload["deadline_ms"]
        if isinstance(deadline_ms, bool) or not isinstance(deadline_ms, (int, float)) or deadline_ms <= 0:
            raise PayloadError(f"deadline_ms must be a positive number, got {deadline_ms!r}")
        slo["deadline_ms"] = float(deadline_ms)
    if payload.get("session_id") is not None:
        session_id = payload["session_id"]
        if not isinstance(session_id, str) or not session_id:
            raise PayloadError(f"session_id must be a non-empty string, got {session_id!r}")
        if getattr(gen, "is_fleet", False):
            slo["session_id"] = session_id
    try:
        temp, top_k, top_p = validate_sampling(
            payload.get("temperature"),
            payload.get("top_k") if payload.get("top_k") is not None else 0,
            payload.get("top_p") if payload.get("top_p") is not None else 1.0,
        )
    except (TypeError, ValueError) as exc:
        raise PayloadError(f"invalid sampling params: {exc}") from None
    sampling: Dict[str, Any] = {}
    if payload.get("temperature") is not None:
        sampling["temperature"] = temp
    if payload.get("top_k") is not None:
        sampling["top_k"] = top_k
    if payload.get("top_p") is not None:
        sampling["top_p"] = top_p
    stream = bool(payload.get("stream"))
    if stream and prompt_ids is None:
        raise PayloadError("stream=true requires a single prompt_ids prompt.")
    return GenerateRequest(prompt_ids=prompt_ids, prompts=prompts, max_new_tokens=max_new, slo=slo,
                           sampling=sampling, stream=stream)


def generation_stats(gen: Any, telemetry: Any = None) -> Dict[str, Any]:
    """The ``GET /stats`` → ``generation`` block: engine counters, then
    ``speculation``, ``pipeline``, ``prefix_cache`` (with the pool's bytes and
    ``prefill_tokens_computed``), ``scheduler`` and ``robustness`` where the
    generator has them, and with ``telemetry`` its per-class ``slo`` report.
    A fleet answers with its own block (aggregate counters and ``fleet``: the
    router, per-replica scheduler, supervisor and prefix-cache state, and the
    failover counts)."""
    if getattr(gen, "is_fleet", False):
        out = gen.stats()
        if telemetry is not None:
            out["slo"] = telemetry.slo.report()
        return out
    engine = gen.engine
    out: Dict[str, Any] = {
        "num_slots": engine.num_slots,
        "active": engine.num_active,
        "max_len": engine.max_len,
        "requests_admitted": getattr(engine, "requests_admitted", 0),
        "tokens_decoded": getattr(engine, "tokens_decoded", 0),
    }
    for key, name in (("speculation", "speculation_stats"), ("pipeline", "pipeline_stats")):
        fn = getattr(engine, name, None)
        if callable(fn):
            out[key] = fn()
    if getattr(engine, "prefix_cache", None) is not None:
        out["prefix_cache"] = engine.prefix_cache.stats()
        out["prefill_tokens_computed"] = engine.prefill_tokens_computed
        out["prefix_cache"].update(engine.kv_pool_stats())
    sched = getattr(gen, "scheduler", None)
    if sched is not None:
        out["scheduler"] = sched.stats()
    robustness: Dict[str, Any] = {}
    engine_stats = getattr(engine, "robustness_stats", None)
    if callable(engine_stats):
        robustness.update(engine_stats())
    sup = getattr(gen, "supervisor", None)
    if sup is not None:
        robustness.update(sup.stats())
    if robustness:
        out["robustness"] = robustness
    if telemetry is not None:
        out["slo"] = telemetry.slo.report()
    return out


_TELEMETRY_OFF = "Telemetry is not enabled on this app."


def metrics_answer(telemetry: Any) -> Tuple[int, Any, Dict[str, str]]:
    """``GET /metrics``: ``(200, the registry's Prometheus text (format
    0.0.4), headers)``, or the 404 ``not_enabled`` envelope."""
    if telemetry is None:
        return error_envelope(404, "not_enabled", _TELEMETRY_OFF)
    return 200, telemetry.metrics.render(), {"Content-Type": "text/plain; version=0.0.4; charset=utf-8"}


def trace_answer(telemetry: Any, request_id: str) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
    """``GET /trace/{request_id}``: the request's span tree (active or
    recently completed), 404 ``trace_not_found`` for an unknown id, 404
    ``not_enabled`` without telemetry."""
    if telemetry is None:
        return error_envelope(404, "not_enabled", _TELEMETRY_OFF)
    trace = telemetry.get_trace(request_id)
    if trace is None:
        return error_envelope(404, "trace_not_found", f"no active or recent trace for request_id {request_id!r} "
                              f"(the journal ring may have evicted it)", request_id=request_id)
    return 200, trace, {}


def traces_recent_answer(telemetry: Any, n: Any = 50) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
    """``GET /traces/recent?n=K``: the journal ring's ``K`` latest completed
    traces, oldest first; 400 when ``n`` is not an integer."""
    if telemetry is None:
        return error_envelope(404, "not_enabled", _TELEMETRY_OFF)
    try:
        n = int(n)
    except (TypeError, ValueError):
        return error_envelope(400, "invalid_request", "n must be an integer.")
    return 200, {"traces": telemetry.recent(n)}, {}


def healthz_body(gen: Any, model: Any) -> Tuple[int, Dict[str, Any]]:
    """``GET /healthz``: the supervisor's state machine (200 while
    ``ok``/``degraded``, 503 while ``rebuilding``/``failed``, with the last
    fault); without a supervised generator, the model artifact alone. A fleet
    reports each replica's state and serves (200) while any replica does."""
    if gen is not None and getattr(gen, "is_fleet", False):
        body = gen.healthz()
        return (200 if body["state"] in ("ok", "degraded") else 503), body
    sup = getattr(gen, "supervisor", None) if gen is not None else None
    if sup is None:
        state = "ok" if model.artifact is not None else "failed"
        body: Dict[str, Any] = {"state": state, "supervised": False, "last_fault": None}
    else:
        stats = sup.stats()
        body = {"state": stats["health"], "supervised": True, "last_fault": sup.last_fault,
                "watchdog_trips": stats["watchdog_trips"], "rebuilds": stats["rebuilds"]}
    return (200 if body["state"] in ("ok", "degraded") else 503), body


def build_generator(generator: Any, *, lookahead: int = 1, prefix_cache_blocks: int = 0,
                    prefix_block_size: int = 16, scheduler: Any = None, supervisor: Any = None,
                    telemetry: Any = None, replicas: int = 1, fleet_config: Any = None,
                    device: Any = "cuda") -> Any:
    """What ``/generate`` serves: a prebuilt batcher or fleet as it is, or a
    bare :class:`~unionml_tpu_torch.serving.continuous.DecodeEngine` (or a
    zero-arg callable returning either) wrapped in a ``ContinuousBatcher``.
    ``prefix_cache_blocks`` turns the engine's prefix cache on unless it has
    one; ``supervisor=None`` builds an ``EngineSupervisor`` and ``False``
    serves unsupervised. ``telemetry`` is attached to a batcher or fleet that
    has none (a caller's own wins).

    ``replicas > 1`` with a factory (JAX ``app.py:262-310``): the factory
    builds one bare engine per replica (called with ``replica=i`` when its
    signature takes it; on one card each engine runs on its own CUDA stream)
    and an :class:`~unionml_tpu_torch.serving.fleet.EngineFleet` with one
    supervisor and one scheduler per replica serves them, routed by
    ``fleet_config``. ``supervisor`` must then be None and ``scheduler`` a
    ``SchedulerConfig``."""
    import inspect

    from unionml_tpu_torch._device import resolve_device
    from unionml_tpu_torch.serving.continuous import ContinuousBatcher, DecodeEngine
    from unionml_tpu_torch.serving.fleet import EngineFleet
    from unionml_tpu_torch.serving.scheduler import SLOScheduler
    from unionml_tpu_torch.serving.speculative import SpeculativeBatcher
    from unionml_tpu_torch.serving.supervisor import EngineSupervisor

    def enable_cache(engine):
        if prefix_cache_blocks and isinstance(engine, DecodeEngine) and engine.prefix_cache is None:
            engine.enable_prefix_cache(prefix_cache_blocks, prefix_block_size)

    prebuilt = isinstance(generator, (DecodeEngine, ContinuousBatcher, SpeculativeBatcher, EngineFleet))
    if int(replicas) > 1 and not prebuilt:
        if supervisor is not None:
            # False would drop the failover the fleet stands on, and one
            # supervisor cannot watch several engines (EngineFleet takes supervisors=)
            raise ValueError("generate_replicas > 1 builds one supervisor per replica; "
                             "generate_supervisor must be left None")
        if isinstance(scheduler, SLOScheduler):
            raise ValueError("generate_replicas > 1 needs a SchedulerConfig (each replica owns its own "
                             "scheduler), not an SLOScheduler")
        takes_replica = "replica" in inspect.signature(generator).parameters
        kind = resolve_device(device).type
        engines = []
        for i in range(int(replicas)):
            engine = generator(replica=i) if takes_replica else generator()
            if not isinstance(engine, DecodeEngine):
                raise TypeError(f"fleet generator must return a DecodeEngine per replica, got {type(engine)!r}")
            if engine.device.type != kind:
                raise ValueError(f"replica {i}'s engine runs on {engine.device}, the app's device is {device}")
            enable_cache(engine)
            engines.append(engine)
        return EngineFleet(engines, config=fleet_config, lookahead=lookahead, scheduler=scheduler,
                           telemetry=telemetry)
    built = generator() if callable(generator) and not prebuilt else generator
    if isinstance(built, EngineFleet):
        for rep in built.replicas:
            enable_cache(rep.engine)
    else:
        enable_cache(built.engine if isinstance(built, ContinuousBatcher) else built)
    if isinstance(built, DecodeEngine):
        if supervisor is None:
            supervisor = EngineSupervisor()
        elif supervisor is False:
            supervisor = None
        built = ContinuousBatcher(built, lookahead=lookahead, scheduler=scheduler, supervisor=supervisor,
                                  device=device)
    if telemetry is not None and isinstance(built, (ContinuousBatcher, EngineFleet)):
        built.attach_telemetry(telemetry)
    return built


def build_predict_route(
    model: Any,
    *,
    resident: bool = True,
    coalesce: bool = True,
    max_batch: int = 64,
    max_wait_ms: float = 2.0,
    buckets: Optional[Any] = None,
    seq_buckets: Optional[Any] = None,
    example_features: Optional[Any] = None,
    mesh: Optional[Any] = None,
    param_specs: Optional[Any] = None,
    device: Any = "cuda",
) -> Tuple[Optional[ResidentPredictor], Optional[Any]]:
    """What ``/predict`` serves through: ``(predictor, batcher)``, the
    :class:`ResidentPredictor` (None unless ``resident``) and the coalescing
    :class:`~unionml_tpu_torch.serving.batcher.RequestBatcher` over it (None
    unless ``coalesce``). Under a ``mesh`` the predictor is meshed (rank 0
    serves, the other ranks :meth:`ResidentPredictor.follow`;
    ``param_specs`` lays the parameters out, else they replicate) and
    coalesced flushes prefer multiples of the batch's ranks, so merged
    batches split evenly over them instead of running whole
    (``app.py:213-228``)."""
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

        preferred_multiple = None
        if mesh is not None:
            from unionml_tpu_torch.parallel.mesh import batch_axis_size

            n_shards = batch_axis_size(mesh)
            preferred_multiple = n_shards if n_shards > 1 else None
        batcher = RequestBatcher(
            lambda rows: predictor.predict(features=rows),
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            preferred_multiple=preferred_multiple,
        )
    return predictor, batcher


async def predict_answer(payload: Any, model: Any, predictor: Optional[ResidentPredictor],
                         batcher: Optional[Any]) -> Tuple[int, Any]:
    """``/predict``'s ``(status, body)`` for a parsed JSON ``payload``: reader
    kwargs (``inputs``) or raw ``features``; row-list features coalesce
    through ``batcher`` when there is one. The predictor's calls block, so
    they run on the loop's executor."""
    import asyncio

    if not isinstance(payload, dict):
        return 500, {"detail": "inputs or features must be supplied."}
    inputs = payload.get("inputs")
    features = payload.get("features")
    if inputs is None and features is None:
        return 500, {"detail": "inputs or features must be supplied."}
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
        return 200, await loop.run_in_executor(None, jsonable, result)
    except Exception as exc:
        logger.exception("Prediction failed")
        return 500, {"detail": f"Prediction failed: {exc}"}


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
    generate_lookahead: int = 1,
    generate_prefix_cache_blocks: int = 0,
    generate_prefix_block_size: int = 16,
    generate_scheduler: Optional[Any] = None,
    generate_supervisor: Optional[Any] = None,
    generate_drain_s: float = 5.0,
    generate_replicas: int = 1,
    generate_fleet_config: Optional[Any] = None,
    generate_telemetry: Any = True,
    generate_trace_journal: Optional[str] = None,
    retry_jitter_rng: Optional[random.Random] = None,
    mesh: Optional[Any] = None,
    param_specs: Optional[Any] = None,
    device: Any = "cuda",
):
    """Create the aiohttp application with a resident predictor.

    ``coalesce=True`` merges concurrent row-list ``features`` requests into shared
    predictor calls (see :mod:`unionml_tpu_torch.serving.batcher`); requests whose
    payloads don't fit the row-list contract fall back to per-request prediction.
    ``buckets``, ``seq_buckets`` and ``example_features`` shape the resident
    predictor's graphs (see :class:`ResidentPredictor`), which live on ``device``
    (``"cuda"`` by default: it raises without a CUDA device unless ``"cpu"``
    is asked for).

    ``generator`` enables ``POST /generate``: a
    :class:`~unionml_tpu_torch.serving.continuous.DecodeEngine`, a
    ``ContinuousBatcher`` or ``SpeculativeBatcher``, or a zero-arg callable
    returning one, evaluated at startup after the model artifact loads (see
    :func:`build_generator`). For a bare engine: ``generate_lookahead`` is the
    batcher's burst length, ``generate_scheduler`` its
    :class:`~unionml_tpu_torch.serving.scheduler.SchedulerConfig` or
    ``SLOScheduler``, and ``generate_supervisor`` its supervisor (``None``
    builds an ``EngineSupervisor``, ``False`` serves unsupervised).
    ``generate_prefix_cache_blocks`` > 0 turns the engine's prefix cache on
    (``generate_prefix_block_size`` tokens per block). Shutdown drains for up
    to ``generate_drain_s`` seconds. ``retry_jitter_rng`` (a
    ``random.Random``) seeds the ``Retry-After`` jitter.

    ``generate_telemetry`` wires a
    :class:`~unionml_tpu_torch.serving.telemetry.Telemetry` into the generator
    at startup: per-request traces (``GET /trace/{request_id}``, ``GET
    /traces/recent``), Prometheus metrics (``GET /metrics``), a ``telemetry``
    block and ``generation.slo`` under ``GET /stats``. ``True`` (default)
    builds one, a ``Telemetry`` instance is used as it is, ``False``/``None``
    turns it off (each hook is then one host branch).
    ``generate_trace_journal`` names a JSONL file that completed traces append
    to. Every ``/generate`` answer carries a ``request_id``; for one prompt it
    keys the trace.

    ``mesh`` serves the resident predictor across a ``torch.distributed``
    mesh (:func:`build_predict_route`): every rank builds the app's
    predictor, rank 0 serves and the other ranks follow
    (``app["resident_predictor"].follow()``) until the app shuts down;
    ``param_specs`` lays the parameters out (a BERT or GPT
    ``param_shardings``), else they replicate.

    ``generate_replicas > 1`` serves the factory's engines behind an
    :class:`~unionml_tpu_torch.serving.fleet.EngineFleet` routed by
    ``generate_fleet_config`` (a
    :class:`~unionml_tpu_torch.serving.fleet.FleetConfig`; see
    :func:`build_generator`): ``/generate`` then honours ``session_id``, and
    ``/healthz`` and ``/stats`` answer per replica.
    """
    from aiohttp import web

    app = web.Application()
    predictor, batcher = build_predict_route(
        model, resident=resident, coalesce=coalesce, max_batch=max_batch, max_wait_ms=max_wait_ms,
        buckets=buckets, seq_buckets=seq_buckets, example_features=example_features, mesh=mesh,
        param_specs=param_specs, device=device)

    async def on_startup(app):
        load_model_artifact(model, remote=remote, app_version=app_version, model_version=model_version)
        if predictor is not None:
            # graftlint: disable=async-blocking -- startup hook: the warmup capture runs before the server accepts any traffic, so blocking the (idle) loop here is the point
            predictor.setup()
        if generator is not None:
            telemetry = None
            if generate_telemetry:
                telemetry = (generate_telemetry if isinstance(generate_telemetry, Telemetry)
                             else Telemetry(journal_path=generate_trace_journal))
            built = build_generator(
                generator, lookahead=generate_lookahead, prefix_cache_blocks=generate_prefix_cache_blocks,
                prefix_block_size=generate_prefix_block_size, scheduler=generate_scheduler,
                supervisor=generate_supervisor, telemetry=telemetry, replicas=generate_replicas,
                fleet_config=generate_fleet_config, device=device)
            app["telemetry"] = getattr(built, "_telemetry", None) or telemetry
            app["continuous_batcher"] = built
        logger.info("Serving app ready (model=%s).", model.name)

    async def on_cleanup(app):
        if batcher is not None:
            batcher.close()
        if predictor is not None:
            # a meshed predictor's followers return from follow()
            predictor.close()
        gen = app.get("continuous_batcher")
        if gen is not None:
            # stop admitting, let in-flight work finish for the bounded window, close
            drain = getattr(gen, "drain", None)
            if callable(drain):
                # graftlint: disable=async-blocking -- shutdown hook: the server stopped accepting, so blocking the loop for the bounded drain is the point
                drain(generate_drain_s)
            else:
                gen.close()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    async def index(request):
        return web.Response(text=_INDEX_HTML, content_type="text/html")

    async def health(request):
        if model.artifact is None:
            return web.json_response({"detail": "Model artifact not found."}, status=500)
        return web.json_response({"message": HTTPStatus.OK.phrase, "status": HTTPStatus.OK.value})

    async def healthz(request):
        """Load-balancer health: the supervisor's state machine, 503 while the
        engine cannot serve, so a router drains this replica."""
        status, body = healthz_body(request.app.get("continuous_batcher"), model)
        return web.json_response(body, status=status)

    def respond(envelope):
        status, body, headers = envelope
        return web.json_response(body, status=status, headers=headers)

    async def metrics_route(request):
        status, body, headers = metrics_answer(request.app.get("telemetry"))
        if status != 200:
            return web.json_response(body, status=status, headers=headers)
        return web.Response(body=body.encode("utf-8"), headers=headers)

    async def trace_route(request):
        return respond(trace_answer(request.app.get("telemetry"), request.match_info["request_id"]))

    async def traces_recent(request):
        return respond(traces_recent_answer(request.app.get("telemetry"), request.query.get("n", 50)))

    async def generate_route(request):
        import asyncio
        import contextlib
        import json

        # minted at entry, so every outcome, 400s included, carries one; for a
        # single prompt the same id keys the trace (GET /trace/{request_id})
        request_id = new_request_id()
        gen = request.app.get("continuous_batcher")
        if gen is None:
            return respond(error_envelope(404, "not_enabled", "Generation is not enabled on this app.",
                                          request_id=request_id))
        try:
            payload = await request.json()
        except Exception as exc:
            return respond(error_envelope(400, "invalid_json", f"Request body must be JSON: {exc}",
                                          request_id=request_id))
        try:
            req = parse_generate_payload(payload, gen)
        except PayloadError as exc:
            return respond(error_envelope(400, exc.reason, str(exc), request_id=request_id))
        kwargs = {**req.slo, **req.sampling}
        rid = {"request_id": request_id} if getattr(gen, "accepts_request_id", False) else {}

        def failed(exc):
            if not isinstance(exc, (SchedulingError, EngineFailure, ValueError)):
                logger.exception("Generation failed (request_id=%s)", request_id)
            return respond(error_for(exc, request_id=request_id, rng=retry_jitter_rng))

        if req.stream:
            # pull the FIRST token before the 200 status line, so a shed or an
            # expired deadline surfaces as its own status, not in-band
            stream_it = gen.stream(req.prompt_ids, req.max_new_tokens, **kwargs, **rid)
            exhausted, first = False, None
            try:
                first = await anext(stream_it)
            except StopAsyncIteration:
                exhausted = True  # nothing emitted (an immediate eos)
            except Exception as exc:
                await stream_it.aclose()
                return failed(exc)
            # ndjson: one {"token": N} line per token, then a {"done": true,
            # "tokens": [...]} trailer; a later failure goes in-band
            response = web.StreamResponse()
            response.content_type = "application/x-ndjson"
            await response.prepare(request)
            tokens = []
            try:
                # closing the iterator early (a client disconnect) cancels the slot
                async with contextlib.aclosing(stream_it) as it:
                    if not exhausted:
                        tokens.append(first)
                        await response.write((json.dumps({"token": first}) + "\n").encode())
                        async for token in it:
                            tokens.append(token)
                            await response.write((json.dumps({"token": token}) + "\n").encode())
                await response.write((json.dumps({"done": True, "tokens": tokens}) + "\n").encode())
            except Exception as exc:
                logger.warning("Streaming generation ended early (request_id=%s): %s", request_id, exc)
                line = {"error": str(exc), "request_id": request_id}
                if getattr(exc, "reason", None) is not None:
                    line["reason"] = exc.reason
                try:  # the transport may be what failed
                    await response.write((json.dumps(line) + "\n").encode())
                except Exception:  # graftlint: disable=swallowed-exception -- the in-band error line to a transport that may itself be the failure: nothing is left to tell
                    pass
            try:
                await response.write_eof()
            except Exception:  # graftlint: disable=swallowed-exception -- eof on a possibly dead transport: the request is finished either way
                pass
            return response
        try:
            if req.prompt_ids is not None:
                tokens = await gen.generate(req.prompt_ids, req.max_new_tokens, **kwargs, **rid)
                return web.json_response({"tokens": tokens, "request_id": request_id})
            completions = await asyncio.gather(
                *(gen.generate(p, req.max_new_tokens, **kwargs) for p in req.prompts))
            return web.json_response({"completions": list(completions), "request_id": request_id})
        except Exception as exc:
            return failed(exc)

    async def predict(request):
        try:
            payload = await request.json()
        except Exception as exc:
            return web.json_response({"detail": f"Request body must be JSON: {exc}"}, status=422)
        status, body = await predict_answer(payload, model, predictor, batcher)
        return web.json_response(body, status=status)

    async def stats(request):
        payload = {"model": model.name, "resident": predictor is not None}
        if predictor is not None:
            # server-side latency (pad, replay, fetch), split from HTTP RTT
            payload["device_latency"] = predictor.device_stats()
            payload["eager_fallbacks"] = predictor.eager_fallbacks
        gen = request.app.get("continuous_batcher")
        tel = request.app.get("telemetry")
        if gen is not None:
            payload["generation"] = generation_stats(gen, tel)
        if tel is not None:
            # trace and journal state plus every registry instrument (what /metrics renders)
            payload["telemetry"] = {**tel.stats(), "metrics": tel.metrics.snapshot()}
        if batcher is not None:
            payload["coalescing"] = dict(batcher.stats)
            if batcher.ema_gap_ms is not None:
                payload["coalescing"]["ema_gap_ms"] = round(batcher.ema_gap_ms, 3)
        return web.json_response(payload)

    app.router.add_get("/", index)
    app.router.add_get("/health", health)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/stats", stats)
    app.router.add_get("/metrics", metrics_route)
    app.router.add_get("/trace/{request_id}", trace_route)
    app.router.add_get("/traces/recent", traces_recent)
    app.router.add_post("/predict", predict)
    app.router.add_post("/generate", generate_route)
    app["unionml_model"] = model
    app["resident_predictor"] = predictor
    app["request_batcher"] = batcher
    app["telemetry"] = None  # set at startup when a generator is wired
    return app


def run_app(app, host: str = "127.0.0.1", port: int = 8000) -> None:
    from aiohttp import web

    web.run_app(app, host=host, port=port)
