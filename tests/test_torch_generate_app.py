"""Port parity: ``POST /generate``, ``/healthz`` and ``/stats`` against the JAX app.

The port's app and the JAX package's are built over the same tiny GPT
(weights carried across) and take the same requests through
``aiohttp.test_utils``. Counterpart of ``tests/unit/test_scheduler.py::
test_http_status_codes_and_reasons`` and the ``/generate`` parts of
``unionml_tpu/serving/app.py``: equal tokens, equal status codes and equal
envelopes (``request_id`` aside, a seeded ``retry_jitter_rng``) for 400,
404, 429, 503 and 504, the 500 and 503 of an ``EngineFailure``, streaming
ndjson lines and trailer, ``/healthz`` through ``ok`` → ``rebuilding`` →
``failed`` under a ``FaultPlan``, and ``/stats`` → ``generation`` with JAX's
keys, its ``slo`` block included.

No sleep races a decode: each engine's ``step`` is gated by a test-local
``threading.Event`` (monkeypatched on the instance), so a hog holds its slot
for exactly as long as the test needs; the tests poll for a state (a slot
taken, a queue depth, a settled supervisor) and never for a decode to have
got somewhere. Where an answer prints a time left, the clock the scheduler
reads is pinned.
"""

import asyncio
import contextlib
import functools
import json
import random
import threading
import time
import types

import pytest
from aiohttp.test_utils import TestClient, TestServer

from tests.test_torch_prefix_cache import Pair
from unionml_tpu.serving import build_aiohttp_app as j_build_app
from unionml_tpu.serving.continuous import DecodeEngine as JaxEngine
from unionml_tpu.serving.faults import FaultPlan as JaxFaultPlan
from unionml_tpu.serving.scheduler import SchedulerConfig as JaxConfig
from unionml_tpu.serving.supervisor import EngineSupervisor as JaxSupervisor
from unionml_tpu_torch.serving import DecodeEngine, EngineSupervisor, FaultPlan, SchedulerConfig
from unionml_tpu_torch.serving import build_aiohttp_app as t_build_app
from unionml_tpu_torch.serving.app import GenerateRequest, PayloadError, error_for, parse_generate_payload

ENGINE_KW = dict(num_slots=1, max_len=64, prefill_buckets=(4, 8))
BAD_PAYLOADS = [
    {},
    {"prompt_ids": [1, 2], "max_new_tokens": 0},
    {"prompt_ids": [1, 2], "max_new_tokens": "many"},
    {"prompt_ids": [], "max_new_tokens": 4},
    {"prompt_ids": [1] * 9, "max_new_tokens": 4},
    {"prompt_ids": [1, 2], "max_new_tokens": 4, "priority": "urgent"},
    {"prompt_ids": [1, 2], "max_new_tokens": 4, "deadline_ms": -5},
    {"prompt_ids": [1, 2], "max_new_tokens": 4, "deadline_ms": True},
    {"prompt_ids": [1, 2], "max_new_tokens": 4, "session_id": ""},
    {"prompt_ids": [1, 2], "max_new_tokens": 4, "top_p": 0},
    {"prompt_ids": [1, 2], "max_new_tokens": 4, "top_k": 1.5},
    {"prompts": [[1, 2], [3]], "max_new_tokens": 4, "stream": True},
]


@pytest.fixture(scope="module")
def gpt():
    return Pair()


def gated(engine, gate):
    """Hold the engine's decode while ``gate`` is clear: ``step`` then waits
    10 ms and returns no events, so the worker loop (admission, deadlines)
    keeps turning."""
    real = engine.step

    def step(lookahead=1):
        if not gate.is_set():
            gate.wait(0.01)
            return []
        return real(lookahead)

    engine.step = step
    return engine


def make_app(gpt, kind, gate, *, scheduler=None, faults=None, supervisor=None, **engine_kw):
    stub = types.SimpleNamespace(name="slo-app", artifact=object())
    kw = dict(ENGINE_KW, **engine_kw)
    if kind == "jax":
        plan = JaxFaultPlan(**faults) if faults else None

        def factory():
            return gated(JaxEngine(gpt.jmodel, gpt.variables, faults=plan, **kw), gate)

        return j_build_app(stub, resident=False, coalesce=False, generator=factory,
                           generate_scheduler=JaxConfig(**scheduler) if scheduler else None,
                           generate_supervisor=supervisor, retry_jitter_rng=random.Random(0))
    plan = FaultPlan(**faults) if faults else None

    def factory():
        return gated(DecodeEngine(gpt.tmodel, faults=plan, device="cpu", **kw), gate)

    return t_build_app(stub, resident=False, coalesce=False, generator=factory, device="cpu",
                       generate_scheduler=SchedulerConfig(**scheduler) if scheduler else None,
                       generate_supervisor=supervisor, retry_jitter_rng=random.Random(0))


async def answer(client, payload=None, data=None):
    """(status, body without request_id, whether Retry-After came)."""
    resp = await (client.post("/generate", json=payload) if data is None else client.post("/generate", data=data))
    text = await resp.text()
    try:
        body = json.loads(text)
    except ValueError:
        body = [json.loads(line) for line in text.splitlines()]  # ndjson
    if isinstance(body, dict):
        assert isinstance(body.pop("request_id", None) or body.get("error", {}).pop("request_id", None), str)
    return resp.status, body, "Retry-After" in resp.headers


async def until(predicate):
    """Poll for a state (60 s at most: a loaded host may compile meanwhile)."""
    for _ in range(12000):
        if predicate():
            return
        await asyncio.sleep(0.005)
    raise AssertionError("state never reached")


def pin_wait_ema(sched, value):
    with sched._lock:
        sched.queue_wait_ema_ms = value
        for name in sched.queue_wait_ema_ms_by_class:
            sched.queue_wait_ema_ms_by_class[name] = value


@contextlib.contextmanager
def pinned_clock(sched):
    """Pin the ``now`` the scheduler reads at submit: an infeasible deadline's
    detail prints the time left then, ``round((deadline - now) * 1e3)``."""
    now = time.monotonic()
    sched.make_ticket = functools.partial(sched.make_ticket, now=now)
    sched.submit = functools.partial(sched.submit, now=now)
    try:
        yield
    finally:
        del sched.make_ticket, sched.submit


def slo_counts(report):
    """``generation.slo`` less what depends on measured TTFTs (good,
    attainment, burn rates, alerts): objectives, windows and totals."""
    keep = {}
    for cls, row in report["per_class"].items():
        keep[cls] = (row["objective_ttft_ms"], row["target"], row["total"],
                     {name: w["total"] for name, w in row["windows"].items()})
    return report["windows"], report["alert_burn"], keep


def contract_run(gpt, kind):
    """The status contract's requests, in order, against one app (a bound-2
    queue: a two-prompt batch always fits, whenever the worker pops)."""
    gate = threading.Event()
    gate.set()
    app = make_app(gpt, kind, gate, scheduler=dict(max_queue=2, preempt=False))
    out = {}

    async def main():
        async with TestClient(TestServer(app)) as client:
            out["bad"] = [await answer(client, p) for p in BAD_PAYLOADS]
            out["not_json"] = await answer(client, data=b"not json")
            out["one"] = await answer(client, {"prompt_ids": [3, 1, 4], "max_new_tokens": 6, "priority": "batch"})
            out["batch"] = await answer(client, {"prompts": [[3, 1, 4], [2, 7]], "max_new_tokens": 4})
            out["stream"] = await answer(client, {"prompt_ids": [3, 1, 4], "max_new_tokens": 6, "stream": True})
            gen = app["continuous_batcher"]
            engine, sched = gen.engine, gen.scheduler
            # 429: the slot held, the bound-2 queue full
            gate.clear()
            hog = asyncio.ensure_future(answer(client, {"prompt_ids": [9, 9, 1, 2], "max_new_tokens": 40}))
            await until(lambda: engine.num_active)
            filler = asyncio.ensure_future(answer(client, {"prompts": [[2, 7], [6, 1]], "max_new_tokens": 4}))
            await until(lambda: sched.depth == 2)
            out["full"] = await answer(client, {"prompt_ids": [5, 5], "max_new_tokens": 4})
            out["full_stream"] = await answer(client, {"prompt_ids": [5, 5], "max_new_tokens": 4, "stream": True})
            gate.set()
            out["hog"], out["filler"] = await hog, await filler
            # 504: queued behind a held hog past its deadline
            pin_wait_ema(sched, None)
            gate.clear()
            hog = asyncio.ensure_future(answer(client, {"prompt_ids": [8, 8, 8], "max_new_tokens": 30}))
            await until(lambda: engine.num_active)
            out["expired"] = await answer(client, {"prompt_ids": [4, 4], "max_new_tokens": 4, "deadline_ms": 25})
            gate.set()
            out["hog2"] = await hog
            # 503: the observed queue wait makes the deadline infeasible
            pin_wait_ema(sched, 60_000.0)
            with pinned_clock(sched):
                out["infeasible"] = await answer(client, {"prompt_ids": [1, 2], "max_new_tokens": 4,
                                                          "deadline_ms": 50})
                out["infeasible_stream"] = await answer(
                    client, {"prompt_ids": [1, 2], "max_new_tokens": 4, "deadline_ms": 50, "stream": True})
            pin_wait_ema(sched, None)
            stats = await (await client.get("/stats")).json()
            out["stats_keys"] = sorted(stats["generation"])
            out["slo"] = slo_counts(stats["generation"]["slo"])
            block = stats["generation"]["scheduler"]
            out["scheduler"] = {k: v for k, v in block.items() if k not in ("queue_wait_ema_ms", "per_class")}
            out["engine"] = {k: stats["generation"][k] for k in ("num_slots", "active", "max_len",
                                                                 "requests_admitted", "tokens_decoded")}

    asyncio.run(main())
    return out


def test_status_contract_matches_jax(gpt):
    """400 with JAX's reasons and details, 200 with JAX's tokens (one prompt,
    a batch, a stream's ndjson lines and trailer), 429 ``queue_full`` with a
    seeded ``retry_after_ms`` in [750, 1250] (as a stream's first ``anext``
    too), 504 ``deadline_exceeded``, 503 ``deadline_infeasible`` (also for a
    stream), and the same ``/stats`` keys, scheduler counters and SLO totals."""
    port, jax = contract_run(gpt, "torch"), contract_run(gpt, "jax")
    assert port.keys() == jax.keys()
    for key in port:
        assert port[key] == jax[key], key
    assert all(status == 400 and body["error"]["reason"] == "invalid_request" for status, body, _ in port["bad"])
    assert port["not_json"][0] == 400 and port["not_json"][1]["error"]["reason"] == "invalid_json"
    assert port["one"][0] == 200 and port["one"][1]["tokens"] == gpt.engine(
        "torch", blocks=0, **ENGINE_KW).generate([3, 1, 4], 6)
    stream = port["stream"]
    assert stream[0] == 200 and stream[1][-1] == {"done": True, "tokens": port["one"][1]["tokens"]}
    assert [line["token"] for line in stream[1][:-1]] == port["one"][1]["tokens"]
    status, body, retry = port["full"]
    assert (status, body["error"]["reason"], retry) == (429, "queue_full", True)
    assert 750 <= body["error"]["retry_after_ms"] <= 1250
    assert port["full_stream"][0] == 429 and port["hog"][0] == port["filler"][0] == 200
    assert port["expired"][0] == 504 and port["expired"][1]["error"]["reason"] == "deadline_exceeded"
    assert port["infeasible"][0] == port["infeasible_stream"][0] == 503 and port["infeasible"][2]
    sched = port["scheduler"]
    assert sched["policy"] == "priority" and sched["shed_queue_full"] == 2
    assert sched["shed_deadline_infeasible"] == 2 and sched["deadline_misses_queued"] == 1
    assert set(sched["depth_by_class"]) == {"interactive", "standard", "batch"}
    assert port["infeasible"][1]["error"]["detail"].startswith("deadline 50ms is below")
    assert port["slo"][2]["batch"][2] == 1 and port["slo"][2]["standard"][2] == 12  # every ended trace


@pytest.mark.parametrize("case", ["prefill_failed", "batcher_closed"])
def test_engine_failure_envelopes_match_jax(gpt, case):
    """An ``EngineFailure`` that ends one request maps as JAX's does: a
    failed prefill (``injected_prefill``) and a closed batcher
    (``batcher_closed``, retryable as in JAX) are 503 with ``Retry-After``;
    a prefill failure costs only its request. (The non-retryable 500,
    ``engine_failed``, is in the ``/healthz`` test.)"""
    def run(kind):
        gate = threading.Event()
        gate.set()
        faults = dict(prefill_failures=(1,)) if case == "prefill_failed" else None
        app = make_app(gpt, kind, gate, faults=faults, supervisor=False)

        async def main():
            async with TestClient(TestServer(app)) as client:
                first = await answer(client, {"prompt_ids": [3, 1, 4], "max_new_tokens": 4})
                if case == "batcher_closed":
                    app["continuous_batcher"].close()
                second = await answer(client, {"prompt_ids": [3, 1, 4], "max_new_tokens": 4})
                return first, second

        return asyncio.run(main())

    port, jax = run("torch"), run("jax")
    assert port == jax
    failed = port[0] if case == "prefill_failed" else port[1]
    assert failed[0] == 503 and failed[2] and failed[1]["error"]["retry_after_ms"] > 0
    assert failed[1]["error"]["reason"] == ("injected_prefill" if case == "prefill_failed" else "batcher_closed")
    assert (port[1] if case == "prefill_failed" else port[0])[0] == 200


def test_not_enabled_is_404(gpt):
    """Without a generator ``/generate`` answers 404 ``not_enabled`` in both apps."""
    stub = types.SimpleNamespace(name="no-gen", artifact=object())

    async def ask(app):
        async with TestClient(TestServer(app)) as client:
            return await answer(client, {"prompt_ids": [1, 2]})

    port = asyncio.run(ask(t_build_app(stub, resident=False, coalesce=False, device="cpu")))
    jax = asyncio.run(ask(j_build_app(stub, resident=False, coalesce=False)))
    assert port == jax and port[0] == 404 and port[1]["error"]["reason"] == "not_enabled"


def settled(gen, kind):
    """Whether the supervised batcher reached the state the ``/healthz`` test
    reads after the rebuild budget is spent. The port's worker parks once the
    supervisor is ``failed``. JAX's keeps stepping the failed engine: each
    ``step`` retries the rebuild lazily (``DecodeEngine._ensure_usable``),
    each raise re-enters recovery, and once the plan's rebuild failures are
    spent a rebuild succeeds and ``run_rebuild`` returns the supervisor to
    ``ok`` with the engine idle (ROADMAP Queue 3)."""
    if kind == "jax":
        return gen.supervisor.state == "ok" and not gen.engine.busy
    return gen.supervisor.state == "failed"


def test_healthz_follows_the_supervisor_through_a_failed_rebuild(gpt):
    """``/healthz`` reads ``ok`` (200), then ``rebuilding`` (503, with the
    last fault) while the supervisor backs off between rebuild attempts,
    then ``failed`` (503) once they are spent; requests then fail with
    ``engine_failed`` (500). The backoff sleep is held by a test-local gate,
    and each later read waits for the settled state. JAX's arm settles in
    ``ok`` and serves again (see :func:`settled`); up to the failed request
    the two arms answer alike."""
    def run(kind):
        gate, backoff, released = threading.Event(), threading.Event(), threading.Event()
        gate.set()

        def held_sleep(seconds):
            backoff.set()
            released.wait(30)

        cls = JaxSupervisor if kind == "jax" else EngineSupervisor
        sup = cls(watchdog_interval_s=0, max_rebuild_attempts=2, sleep_fn=held_sleep)
        app = make_app(gpt, kind, gate, faults=dict(step_dispatch_failures=(2,), rebuild_failures=10),
                       supervisor=sup)

        async def health(client):
            resp = await client.get("/healthz")
            body = await resp.json()
            return resp.status, body["state"], body["supervised"], (body.get("last_fault") or {}).get("reason")

        async def main():
            async with TestClient(TestServer(app)) as client:
                seen = [await health(client)]
                doomed = asyncio.ensure_future(answer(client, {"prompt_ids": [3, 1, 4], "max_new_tokens": 8}))
                await until(backoff.is_set)
                seen.append(await health(client))
                released.set()
                seen.append((await doomed)[:2])
                await until(lambda: settled(app["continuous_batcher"], kind))
                seen.append(await health(client))
                seen.append((await answer(client, {"prompt_ids": [3, 1, 4], "max_new_tokens": 8}))[:2])
                return seen

        return asyncio.run(main())

    port, jax = run("torch"), run("jax")
    assert port[:3] == jax[:3]
    assert [s[:2] for s in (port[0], port[1], port[3])] == [(200, "ok"), (503, "rebuilding"), (503, "failed")]
    assert port[1][3] == port[3][3] == "injected_rebuild" and port[2][0] == port[4][0] == 500
    assert port[2][1]["error"]["reason"] == port[4][1]["error"]["reason"] == "engine_failed"
    assert jax[3][:2] == (200, "ok") and jax[4][0] == 200 and len(jax[4][1]["tokens"]) == 8


def test_payload_checks_and_error_mapping_are_plain_functions(gpt):
    """The route's pieces import no ``aiohttp``: the payload check returns the
    forwarded keywords, rejects with the route's reasons, and the exception
    mapping gives each failure its status."""
    from unionml_tpu_torch.serving import DeadlineExceededError, DeadlineInfeasibleError, EngineFailure, QueueFullError

    gen = types.SimpleNamespace(engine=gpt.engine("torch", blocks=0, **ENGINE_KW))
    req = parse_generate_payload({"prompt_ids": [1, 2], "max_new_tokens": 3, "priority": "batch",
                                  "deadline_ms": 500, "session_id": "s", "temperature": 0.5}, gen)
    assert req == GenerateRequest(prompt_ids=[1, 2], prompts=None, max_new_tokens=3,
                                  slo={"priority": 2, "deadline_ms": 500.0}, sampling={"temperature": 0.5},
                                  stream=False)
    with pytest.raises(PayloadError, match="empty prompt"):
        parse_generate_payload({"prompt_ids": []}, gen)
    rng = random.Random(0)
    cases = [(QueueFullError("full", retry_after_s=1.0), 429), (DeadlineInfeasibleError("late", retry_after_s=1.0), 503),
             (DeadlineExceededError("gone"), 504), (EngineFailure("x", reason="pool_exhausted", retryable=True), 503),
             (EngineFailure("x", reason="engine_failed", retryable=False), 500), (ValueError("bad"), 400), (KeyError("k"), 500)]
    for exc, status in cases:
        got, body, headers = error_for(exc, request_id="r", rng=rng)
        assert got == status == body["error"]["code"] and body["error"]["request_id"] == "r"
        assert ("Retry-After" in headers) == ("retry_after_ms" in body["error"]) == (status in (429, 503))


def test_model_serve_adds_generate_healthz_and_stats(gpt):
    """The user's entry point: ``Model.serve(generator=..., generate_scheduler=...,
    generate_prefix_cache_blocks=..., generate_supervisor=...)`` of the port
    serves ``/generate`` (tokens equal the engine alone), ``/healthz`` from
    the given supervisor and ``/stats`` → ``generation`` with the scheduler
    and prefix-cache blocks, beside the app's own ``/predict``."""
    import unionml_tpu_torch as T
    from tests.test_torch_model import sklearn_app

    model = sklearn_app(T)
    model.train(hyperparameters={"max_iter": 200})
    app = model.serve(resident=False, device="cpu", generate_scheduler=SchedulerConfig(max_queue=8),
                      generator=lambda: DecodeEngine(gpt.tmodel, device="cpu", **ENGINE_KW),
                      generate_prefix_cache_blocks=16, generate_prefix_block_size=4,
                      generate_supervisor=EngineSupervisor(watchdog_interval_s=0))

    async def main():
        async with TestClient(TestServer(app)) as client:
            gen = await answer(client, {"prompt_ids": [3, 1, 4], "max_new_tokens": 6, "priority": "interactive"})
            health = await (await client.get("/healthz")).json()
            stats = (await (await client.get("/stats")).json())["generation"]
            predict = await client.post("/predict", json={"features": [{"x1": 0.1, "x2": -0.3}]})
            return gen, health, stats, predict.status

    (status, body, _), health, stats, predict_status = asyncio.run(main())
    assert status == 200 and body["tokens"] == gpt.engine("torch", blocks=0, **ENGINE_KW).generate([3, 1, 4], 6)
    assert health["state"] == "ok" and health["supervised"] is True
    assert stats["scheduler"]["admitted"] == 1 and stats["scheduler"]["per_class"]["interactive"] is not None
    assert stats["prefix_cache"]["block_size"] == 4 and predict_status == 200
