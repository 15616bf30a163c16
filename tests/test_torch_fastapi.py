"""The port's FastAPI adapter beside the JAX package's, without the fastapi dependency.

Twin of ``tests/unit/test_fastapi_adapter.py``: the same duck-typed ``fastapi``
modules go into ``sys.modules``, both REAL adapters attach to fake apps, and
every route handler runs (the resident predictor of the port on the CPU). The
two apps' answers are equal for the same requests; ``serving_app`` hands a
``FastAPI`` instance to the adapter and refuses any other object; a mesh
passes through to the meshed predictor.
"""

import asyncio
import sys
import types

import pytest

import unionml_tpu as J
import unionml_tpu_torch as T

from tests.test_torch_model import sklearn_app
from tests.torch_sharded_ranks import fake_world
from unionml_tpu_torch.parallel import make_mesh


class _FakeHTTPException(Exception):
    def __init__(self, status_code: int, detail: str = ""):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


class _FakeApp:
    """Records routes the way the adapter registers them; replays handlers."""

    def __init__(self):
        self.routes = {}
        self.startup_hooks = []

    def _register(self, method, path):
        def deco(fn):
            self.routes[(method, path)] = fn
            return fn

        return deco

    def get(self, path, **kwargs):
        return self._register("GET", path)

    def post(self, path, **kwargs):
        return self._register("POST", path)

    def on_event(self, event):
        def deco(fn):
            if event == "startup":
                self.startup_hooks.append(fn)
            return fn

        return deco


def _fake_fastapi_modules():
    fastapi = types.ModuleType("fastapi")

    def Body(default=None, **kwargs):
        return default

    fastapi.FastAPI = _FakeApp
    fastapi.Body = Body
    fastapi.HTTPException = _FakeHTTPException
    responses = types.ModuleType("fastapi.responses")

    class HTMLResponse:
        pass

    responses.HTMLResponse = HTMLResponse
    fastapi.responses = responses
    return {"fastapi": fastapi, "fastapi.responses": responses}


_JAX_ADAPTER = "unionml_tpu.serving.fastapi_adapter"


@pytest.fixture()
def fake_fastapi_env(monkeypatch):
    """Install the fake fastapi. JAX's adapter imports fastapi at module level,
    so a fake-bound copy of it is evicted afterwards; the port's imports it
    where an app is attached."""
    for name, module in _fake_fastapi_modules().items():
        monkeypatch.setitem(sys.modules, name, module)
    saved = sys.modules.pop(_JAX_ADAPTER, None)
    yield
    sys.modules.pop(_JAX_ADAPTER, None)
    if saved is not None:
        sys.modules[_JAX_ADAPTER] = saved


def _attached(pkg, tmp_path, monkeypatch, **kwargs):
    model = sklearn_app(pkg)
    model.train(hyperparameters={"C": 1.0, "max_iter": 300})
    path = tmp_path / f"{pkg.__name__}.joblib"
    model.save(path)
    model._artifact = None
    monkeypatch.setenv("UNIONML_MODEL_PATH", str(path))
    app = _FakeApp()
    if pkg is T:
        from unionml_tpu_torch.serving.fastapi_adapter import attach_fastapi

        attach_fastapi(model, app, device="cpu", **kwargs)
    else:
        from unionml_tpu.serving.fastapi_adapter import attach_fastapi

        attach_fastapi(model, app, **kwargs)
    for hook in app.startup_hooks:  # simulate server startup: loads the artifact
        asyncio.run(hook())
    return app, model


@pytest.fixture()
def adapter_apps(tmp_path, monkeypatch, fake_fastapi_env):
    """(JAX app, port app), each on the same seeded sklearn app."""
    return _attached(J, tmp_path, monkeypatch)[0], _attached(T, tmp_path, monkeypatch)[0]


def test_routes_registered(adapter_apps):
    japp, tapp = adapter_apps
    assert set(tapp.routes) == set(japp.routes) == {("GET", "/"), ("GET", "/health"), ("POST", "/predict")}
    assert "<html>" in tapp.routes[("GET", "/")]()


def test_health_after_startup(adapter_apps):
    japp, tapp = adapter_apps
    want = asyncio.run(japp.routes[("GET", "/health")]())
    assert asyncio.run(tapp.routes[("GET", "/health")]()) == want == {"message": "OK", "status": 200}


def test_predict_handler_is_sync_so_fastapi_threadpools_it(adapter_apps):
    _, tapp = adapter_apps
    assert not asyncio.iscoroutinefunction(tapp.routes[("POST", "/predict")])


@pytest.mark.parametrize("payload", [
    {"inputs": None, "features": [{"x1": 2.0, "x2": 2.0}, {"x1": -3.0, "x2": -3.0}, {"x1": 0.1, "x2": -0.3}]},
    {"inputs": {"sample_frac": 0.1, "random_state": 1}, "features": None},
    {"inputs": {}, "features": None},  # empty {}: the reader with its defaults, as the aiohttp app does
    {"inputs": {}, "features": [{"x1": 1.0, "x2": 0.5}]},  # features win over an empty inputs
], ids=["features", "inputs", "empty_inputs", "empty_inputs_with_features"])
def test_predict_paths_match_jax(adapter_apps, payload):
    japp, tapp = adapter_apps
    got = tapp.routes[("POST", "/predict")](**payload)
    assert got == japp.routes[("POST", "/predict")](**payload)
    assert isinstance(got, list) and got


def test_predict_requires_payload(adapter_apps):
    for app in adapter_apps:
        with pytest.raises(_FakeHTTPException) as excinfo:
            app.routes[("POST", "/predict")](inputs=None, features=None)
        assert excinfo.value.status_code == 500
        assert "inputs or features" in excinfo.value.detail


def test_health_without_artifact(fake_fastapi_env):
    from unionml_tpu_torch.serving.fastapi_adapter import attach_fastapi

    app = _FakeApp()
    attach_fastapi(sklearn_app(T), app, resident=False)
    # startup NOT run: no artifact
    with pytest.raises(_FakeHTTPException) as excinfo:
        asyncio.run(app.routes[("GET", "/health")]())
    assert excinfo.value.status_code == 500


def test_serving_app_dispatches_a_fastapi_instance(fake_fastapi_env, monkeypatch, tmp_path):
    from unionml_tpu_torch._logging import logger

    warned = []
    monkeypatch.setattr(logger, "warning", lambda msg, *args: warned.append(msg % args))
    model = sklearn_app(T)
    app = _FakeApp()
    assert model.serve(app=app, resident=False, coalesce=False) is app  # an aiohttp-only option: dropped
    assert set(app.routes) == {("GET", "/"), ("GET", "/health"), ("POST", "/predict")}
    assert warned == ["attach_fastapi ignoring unsupported serving options: ['coalesce']"]
    with pytest.raises(TypeError, match="Unsupported app type"):
        model.serve(app=object())
    # a mesh passes through to a meshed predictor (tests/test_torch_mesh_serving.py): one rank answers as none
    payload = {"inputs": None, "features": [{"x1": 2.0, "x2": 2.0}, {"x1": -3.0, "x2": -3.0}]}
    with fake_world(1):
        mesh = make_mesh({"data": 1}, device="cpu")
        meshed, _ = _attached(T, tmp_path, monkeypatch, mesh=mesh)
        assert meshed.resident_predictor._mesh is mesh
        got = meshed.routes[("POST", "/predict")](**payload)
    plain, _ = _attached(T, tmp_path, monkeypatch)
    assert got == plain.routes[("POST", "/predict")](**payload)
