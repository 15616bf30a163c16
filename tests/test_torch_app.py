"""The port's aiohttp app against the JAX package's, through aiohttp's test client.

The same apps are served by both packages after a ``Model.save`` and a
startup load through ``UNIONML_MODEL_PATH``: the tiny f32 BERT app
(labels out; its weights carried across) and the sklearn app of
``tests/unit/model_fixtures.py``. Every request below, including the
verify skill's probes (empty body, ``GET /predict``, ``{"inputs": {}}``,
garbage features, a body that is not JSON), must get the same status code
and the same JSON from both; where the JSON carries an exception's own text
(a failed prediction), the two packages' exceptions differ and only the
status and the ``"Prediction failed:"`` prefix are compared.
"""

import asyncio
import json

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import unionml_tpu as J
import unionml_tpu_torch as T
from unionml_tpu.serving import serving_app as j_serving_app
from unionml_tpu_torch.serving import FleetConfig
from unionml_tpu_torch.serving import serving_app as t_serving_app
from unionml_tpu_torch.serving.app import jsonable

from tests.test_torch_model import bert_weights, jax_bert_app, port_bert_app, request_rows, sklearn_app  # noqa: F401

PROBES = {
    "empty_body": ("POST", "/predict", b"{}"),
    "get_predict": ("GET", "/predict", None),
    "not_json": ("POST", "/predict", b"{not json"),
    "inputs_defaults": ("POST", "/predict", b'{"inputs": {}}'),
    "garbage_features": ("POST", "/predict", b'{"features": [{"nope": "x"}]}'),
    "health": ("GET", "/health", None),
    "healthz": ("GET", "/healthz", None),
}


async def _ask(app, requests):
    out = []
    async with TestClient(TestServer(app)) as client:
        for method, path, body in requests:
            resp = await client.request(method, path, data=body, headers={"Content-Type": "application/json"})
            text = await resp.text()
            try:
                payload = json.loads(text)
            except ValueError:
                payload = None
            out.append((resp.status, payload))
    return out


def _serve_both(japp, tapp, tmp_path, monkeypatch, requests, **kwargs):
    """Save each trained app, drop its artifact and answer ``requests`` from
    an app that loads it at startup through UNIONML_MODEL_PATH."""
    answers = []
    for name, app, serving_app, extra in (("j", japp, j_serving_app, {}), ("t", tapp, t_serving_app, {"device": "cpu"})):
        path = tmp_path / f"{name}.model"
        app.save(path)
        app.artifact = None
        monkeypatch.setenv("UNIONML_MODEL_PATH", str(path))
        answers.append(asyncio.run(_ask(serving_app(app, **kwargs, **extra), requests)))
    return answers


def _assert_same(jax_answers, port_answers, names):
    for name, (js, jp), (ts, tp) in zip(names, jax_answers, port_answers):
        assert ts == js, name
        if js == 500 and isinstance(jp, dict) and jp.get("detail", "").startswith("Prediction failed:"):
            assert tp["detail"].startswith("Prediction failed:"), name
        else:
            assert tp == jp, name


@pytest.fixture
def bert_pair(bert_weights):  # noqa: F811 (fixture)
    cfg, variables, params = bert_weights
    japp, tapp = jax_bert_app(cfg, variables, logits=False), port_bert_app(params, logits=False)
    japp.train()
    tapp.train()
    return japp, tapp


def test_bert_app_predict_json_matches(bert_pair, tmp_path, monkeypatch):
    japp, tapp = bert_pair
    requests, names = [], []
    for seed, n in ((0, 1), (1, 4), (2, 7)):
        body = json.dumps({"features": request_rows(n, seed)}).encode()
        requests.append(("POST", "/predict", body))
        names.append(f"features-{n}")
    requests += list(PROBES.values())
    names += list(PROBES)
    jax_answers, port_answers = _serve_both(japp, tapp, tmp_path, monkeypatch, requests,
                                            buckets=(1, 2, 4, 8), seq_buckets=(8, 16))
    _assert_same(jax_answers, port_answers, names)
    assert [s for s, _ in port_answers[:3]] == [200, 200, 200]
    assert [len(p) for _, p in port_answers[:3]] == [1, 4, 7]
    assert port_answers[names.index("get_predict")][0] == 405
    assert port_answers[names.index("empty_body")] == (500, {"detail": "inputs or features must be supplied."})
    assert port_answers[names.index("not_json")][0] == 422


def test_sklearn_app_predict_json_matches(tmp_path, monkeypatch):
    japp, tapp = sklearn_app(J), sklearn_app(T)
    japp.train(hyperparameters={"max_iter": 200})
    tapp.train(hyperparameters={"max_iter": 200})
    rows = [{"x1": 0.1 * i, "x2": -0.3 * i} for i in range(5)]
    requests = [("POST", "/predict", json.dumps({"features": rows}).encode()),
                ("POST", "/predict", json.dumps({"inputs": {"sample_frac": 0.1}}).encode()),
                ("POST", "/predict", json.dumps({"inputs": {}, "features": rows[:2]}).encode()),
                *PROBES.values()]
    names = ["features", "inputs", "features-win", *PROBES]
    jax_answers, port_answers = _serve_both(japp, tapp, tmp_path, monkeypatch, requests)
    _assert_same(jax_answers, port_answers, names)
    assert port_answers[0][0] == 200 and len(port_answers[0][1]) == 5


def test_stats_and_index(bert_pair, tmp_path, monkeypatch):
    _, tapp = bert_pair
    path = tmp_path / "t.model"
    tapp.save(path)
    tapp.artifact = None
    monkeypatch.setenv("UNIONML_MODEL_PATH", str(path))
    app = t_serving_app(tapp, device="cpu", buckets=(2,), seq_buckets=(16,))
    body = json.dumps({"features": request_rows(2, 0)}).encode()
    (_, _), (_, _), (status, stats), (index_status, _) = asyncio.run(_ask(app, [
        ("POST", "/predict", body), ("POST", "/predict", body), ("GET", "/stats", None), ("GET", "/", None)]))
    assert status == 200 and index_status == 200
    assert stats["model"] == "bert_app" and stats["resident"] is True and stats["eager_fallbacks"] == 0
    assert stats["device_latency"]["count"] >= 1 and stats["coalescing"]["requests"] == 2


def test_app_options_not_ported_raise():
    app = sklearn_app(T)
    # telemetry is wired now: both options build, with the JAX app's routes
    for kw in (dict(generator=object(), generate_telemetry=True), dict(generate_trace_journal="journal.jsonl")):
        built = t_serving_app(app, resident=False, device="cpu", **kw)
        routes = {r.resource.canonical for r in built.router.routes()}
        assert {"/metrics", "/trace/{request_id}", "/traces/recent"} <= routes and built["telemetry"] is None
    # the fleet is wired too: generate_replicas > 1 builds (its engines are made at startup)
    built = t_serving_app(app, resident=False, generator=object(), generate_replicas=2, device="cpu",
                          generate_fleet_config=FleetConfig(policy="random"))
    assert "/generate" in {r.resource.canonical for r in built.router.routes()}
    with pytest.raises(TypeError, match="unexpected keyword"):
        t_serving_app(app, no_such_option=1, device="cpu")
    with pytest.raises(TypeError, match="Unsupported app type"):
        t_serving_app(app, app=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_serving_app(app)


def test_jsonable():
    value = {"a": torch.tensor([1.5, 2.0], dtype=torch.bfloat16), "b": [np.int64(3), np.ones(2)], "c": "x"}
    assert jsonable(value) == {"a": [1.5, 2.0], "b": [3, [1.0, 1.0]], "c": "x"}
