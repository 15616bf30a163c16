"""The port's service adapters beside the JAX package's.

Twin of ``tests/unit/test_services.py``: the serverless event handler of both
packages answers the same API-Gateway and storage events on the same seeded
sklearn app with equal status codes and bodies; the BentoML adapter runs
end to end against the same duck-typed ``bentoml`` stand-in (only the external
library is faked), its runnable declaring ``"nvidia.com/gpu"`` where JAX's
declares ``"google.com/tpu"``.
"""

import json

import pytest

import unionml_tpu as J
import unionml_tpu_torch as T
from unionml_tpu.services import make_event_handler as jax_event_handler
from unionml_tpu_torch.services import make_event_handler

from tests.test_torch_model import sklearn_app
from tests.unit.test_services import _FakeBentoml


def _trained(pkg, tmp_path):
    model = sklearn_app(pkg)
    model.train(hyperparameters={"C": 1.0, "max_iter": 300})
    path = tmp_path / f"{pkg.__name__}.joblib"
    model.save(path)
    model._artifact = None
    return model, path


@pytest.fixture()
def handlers(tmp_path):
    """(JAX handler, port handler, port model, port model path)."""
    jmodel, jpath = _trained(J, tmp_path)
    tmodel, tpath = _trained(T, tmp_path)
    return jax_event_handler(jmodel, model_path=str(jpath)), make_event_handler(tmodel, model_path=str(tpath)), tmodel, tpath


@pytest.mark.parametrize("event,status", [
    ({"body": json.dumps({"features": [{"x1": 1.0, "x2": 1.0}, {"x1": -1.5, "x2": 0.2}]})}, 200),
    ({"body": json.dumps({"inputs": {"sample_frac": 0.1, "random_state": 3}})}, 200),
    ({"body": {"features": [{"x1": 0.3, "x2": -0.4}]}}, 200),  # an already-decoded body
    ({"body": json.dumps({})}, 500),
    ({"body": "{not json"}, 400),
    ({"something": 1}, 400),
], ids=["features", "inputs", "dict_body", "empty_body", "bad_json", "unrecognized"])
def test_events_answer_as_jax(handlers, event, status):
    jax_handler, handler, _, _ = handlers
    response = handler(event, None)
    assert response == jax_handler(event, None)
    assert response["statusCode"] == status
    if status == 200:
        assert json.loads(response["body"])


def test_inputs_event_predicts_ten_rows(handlers):
    _, handler, _, _ = handlers
    response = handler({"body": json.dumps({"inputs": {"sample_frac": 0.1, "random_state": 3}})}, None)
    assert response["statusCode"] == 200 and len(json.loads(response["body"])) == 10


def test_storage_event_routes_through_feature_loader(handlers, tmp_path):
    jax_handler, _, model, path = handlers
    features_file = tmp_path / "bucket" / "features.json"
    features_file.parent.mkdir(parents=True)
    features_file.write_text(json.dumps([{"x1": 0.5, "x2": 0.5}, {"x1": -0.5, "x2": -2.0}]))
    handler = make_event_handler(model, model_path=str(path), path_resolver=lambda p: tmp_path / p)
    event = {"Records": [{"s3": {"bucket": {"name": "bucket"}, "object": {"key": "features.json"}}},
                         {"bucket": "bucket", "name": "features.json"}]}
    response = handler(event, None)
    assert response["statusCode"] == 200
    results = json.loads(response["body"])
    assert list(results) == ["bucket/features.json"] and len(results["bucket/features.json"]) == 2


def test_model_load_failure(monkeypatch):
    monkeypatch.delenv("UNIONML_MODEL_PATH", raising=False)
    response = make_event_handler(sklearn_app(T))({"body": json.dumps({"features": []})}, None)
    assert response["statusCode"] == 500
    assert "Model load failed" in response["body"]


@pytest.fixture()
def fake_bentoml(monkeypatch):
    import unionml_tpu_torch.services.bentoml_service as bs

    fake = _FakeBentoml()
    monkeypatch.setattr(bs, "bentoml", fake)
    return fake


def test_bentoml_adapter_executes_end_to_end(fake_bentoml):
    """save_model -> configure -> API handler -> prediction, all adapter code live."""
    from unionml_tpu_torch.services import BentoMLService

    model = sklearn_app(T)
    model.train(hyperparameters={"C": 1.0, "max_iter": 300})
    rows = [{"x1": 1.0, "x2": 1.0}, {"x1": -2.0, "x2": -2.0}]
    want = model.predict(features=rows)
    service = BentoMLService(model, device="cpu")

    tag = service.save_model()
    assert tag.tag == model.name
    assert service.load_model(model.name) is model.artifact.model_object

    svc = service.configure(model.name)
    assert svc.name == model.name and len(svc.runners) == 1
    assert len(svc.apis) == 1
    assert svc.apis[0]["input"].kind == "json" and svc.apis[0]["output"].kind == "json"
    # the registered API handler serves real predictions through the runner
    assert svc.apis[0]["handler"](rows) == want


def test_bentoml_async_api(fake_bentoml):
    import asyncio

    from unionml_tpu_torch.services import create_service

    model = sklearn_app(T)
    model.train(hyperparameters={"C": 1.0, "max_iter": 300})
    from unionml_tpu_torch.services import BentoMLService

    BentoMLService(model).save_model()
    svc = create_service(model, model.name, name="svc", enable_async=True, device="cpu")
    rows = [{"x1": 0.5, "x2": 0.5}]
    assert svc.name == "svc" and asyncio.run(svc.apis[0]["handler"](rows)) == model.predict(features=rows)


def test_bentoml_runnable_declares_gpu_resources(fake_bentoml, monkeypatch):
    import unionml_tpu.services.bentoml_service as jbs
    from unionml_tpu.services import create_runnable as jax_create_runnable
    from unionml_tpu_torch.services import BentoMLService, create_runnable

    monkeypatch.setattr(jbs, "bentoml", fake_bentoml)
    model = sklearn_app(T)
    model.train(hyperparameters={"C": 1.0, "max_iter": 300})
    BentoMLService(model).save_model()
    runnable = create_runnable(model, model.name, device="cpu")
    assert runnable.SUPPORTED_RESOURCES == ("cpu", "nvidia.com/gpu")
    assert jax_create_runnable(sklearn_app(J), model.name).SUPPORTED_RESOURCES == ("cpu", "google.com/tpu")


def test_bentoml_io_inference(fake_bentoml):
    from unionml_tpu_torch.services import infer_io_descriptors

    input_io, output_io = infer_io_descriptors(sklearn_app(T))
    assert input_io.kind == "json" and output_io.kind == "json"  # List[float] predictions


def test_bentoml_clear_error_without_dep(monkeypatch):
    import sys

    import unionml_tpu_torch.services.bentoml_service as bs
    from unionml_tpu_torch.services import BentoMLService

    monkeypatch.setattr(bs, "bentoml", None)
    monkeypatch.setitem(sys.modules, "bentoml", None)  # as on a machine without it
    with pytest.raises(ImportError, match="bentoml is not installed"):
        BentoMLService(sklearn_app(T)).load_model("x")
