"""The port's project templates against the JAX package's.

- ``list_templates()`` is JAX's twelve names (``data-parallel`` trains in a
  gloo world in ``tests/test_torch_sharded_training.py``);
- each renders, compiles, carries ``.git`` and JAX's file set, and has no
  ``{{app_name}}`` left (``tests/unit/test_cli_templates.py:31-50``); its
  ``app.py`` imports neither JAX nor the JAX package, and the six that run
  on the card only the standard library, torch, numpy and the port; the
  renderer's validations are JAX's;
- ``moe-textgen`` and ``packed-textgen`` train and generate through the
  decorator API, as ``test_cli_templates.py:155-185`` runs JAX's; ``basic``,
  ``jax-digits``, ``torch-digits``, ``mnist-cnn`` and ``keras-mnist`` train
  and predict on the template's request body at their smallest size. The
  apps run on the CPU here (``UNIONML_DEVICE=cpu``).
"""

import ast
import json
import py_compile
import runpy
import sys

import numpy as np
import pytest
import torch

from unionml_tpu.templates import list_templates as jax_templates
from unionml_tpu.templates import template_description as jax_description
from unionml_tpu_torch.templates import list_templates, render_template, template_description

PORTED = ["basic", "bentoml-serving", "bert-finetune", "data-parallel", "gpt-textgen", "jax-digits", "keras-mnist",
          "mnist-cnn", "moe-textgen", "packed-textgen", "serverless", "torch-digits"]
#: the templates the card runs: the card's machine has no pandas, sklearn or keras
ON_CARD = {"bert-finetune", "data-parallel", "gpt-textgen", "mnist-cnn", "moe-textgen", "packed-textgen"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tiny models gain nothing from more, and the
    suite's workers share the cores (threads spinning at each op's barrier
    while descheduled slowed this file many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_list_templates_is_nine_of_jax():
    assert list_templates() == PORTED
    assert set(PORTED) <= set(jax_templates())
    assert set(jax_templates()) == set(PORTED)
    for name in PORTED:
        assert template_description(name) and jax_description(name)


@pytest.mark.parametrize("template", PORTED)
def test_render_template_compiles(template, tmp_path):
    target = render_template(template, "my_app", tmp_path)
    app_py = target / "app.py"
    content = app_py.read_text()
    assert "{{app_name}}" not in content and "my_app" in content
    py_compile.compile(str(app_py), doraise=True)
    assert (target / ".git").exists()  # app versioning needs a git repo
    for aux in ("Dockerfile", "requirements.txt", ".gitignore", "README.md"):
        assert (target / aux).exists(), f"{template} missing {aux}"
        assert "{{app_name}}" not in (target / aux).read_text()
    reqs = [r.strip() for r in (target / "requirements.txt").read_text().splitlines() if r.strip()]
    assert "unionml-tpu" in reqs and "torch" in reqs
    sample = json.loads((target / "data" / "sample_features.json").read_text())
    assert isinstance(sample, dict) and ("features" in sample or "inputs" in sample)
    imported = set()
    for node in ast.walk(ast.parse(content)):
        if isinstance(node, ast.Import):
            imported.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module.split(".")[0])
    assert "unionml_tpu_torch" in imported and not imported & {"jax", "flax", "optax", "unionml_tpu"}
    if template in ON_CARD:
        assert imported <= {"torch", "numpy", "unionml_tpu_torch"} | set(sys.stdlib_module_names), imported


def test_render_template_validations(tmp_path):
    with pytest.raises(ValueError, match="identifier"):
        render_template("basic", "bad-name", tmp_path)
    with pytest.raises(ValueError, match="Unknown template"):
        render_template("nope", "ok_name", tmp_path)
    assert (render_template("data-parallel", "ok_name", tmp_path) / "app.py").exists()  # ported: it renders
    render_template("basic", "dup", tmp_path)
    with pytest.raises(FileExistsError):
        render_template("basic", "dup", tmp_path)


def _app(template, tmp_path, monkeypatch):
    monkeypatch.setenv("UNIONML_DEVICE", "cpu")
    target = render_template(template, template.replace("-", "_") + "_app", tmp_path)
    monkeypatch.chdir(target)
    return target, runpy.run_path(str(target / "app.py"), run_name="not_main")["model"]


@pytest.mark.parametrize("template,trainer_kwargs", [
    ("moe-textgen", {"num_steps": 10, "batch_size": 16}),
    ("packed-textgen", {"num_epochs": 1, "batch_size": 8}),
])
def test_textgen_template_trains_and_generates(template, trainer_kwargs, tmp_path, monkeypatch):
    _, model = _app(template, tmp_path, monkeypatch)
    _, metrics = model.train(trainer_kwargs=trainer_kwargs)
    assert metrics["train"] > 0 and np.isfinite(metrics["test"])
    out = model.predict(features={"prompt": ["the quick ", "a"], "max_new_tokens": 8})
    assert out.shape == (2, len("the quick ") + 8)


@pytest.mark.parametrize("template,reader_kwargs,trainer_kwargs", [
    ("basic", {}, {"num_epochs": 20}),
    ("jax-digits", {}, {"num_epochs": 2}),
    ("torch-digits", {}, {"n_epochs": 2}),
    ("mnist-cnn", {"n": 256}, {"num_epochs": 1}),
    ("keras-mnist", {"n": 256}, {"epochs": 1}),
])
def test_template_trains_and_predicts(template, reader_kwargs, trainer_kwargs, tmp_path, monkeypatch):
    if template == "keras-mnist":
        pytest.importorskip("keras", reason="keras does not import here")
    target, model = _app(template, tmp_path, monkeypatch)
    _, metrics = model.train(trainer_kwargs=trainer_kwargs, **reader_kwargs)
    assert 0.0 <= metrics["train"] <= 1.0 and 0.0 <= metrics["test"] <= 1.0
    sample = json.loads((target / "data" / "sample_features.json").read_text())
    if "features" in sample:
        out = model.predict(features=sample["features"])
        assert len(out) == len(sample["features"])
    else:
        out = model.predict(**sample["inputs"])
        assert len(out) == sample["inputs"]["n"]
    assert all(0 <= int(label) < 10 for label in out)


def test_serverless_template_answers_events(tmp_path, monkeypatch):
    """``serverless``: the app's FaaS handler answers the template's request body
    with the model's own predictions (sklearn: the CPU tests only)."""
    target = render_template("serverless", "serverless_app", tmp_path)
    monkeypatch.chdir(target)
    namespace = runpy.run_path(str(target / "app.py"), run_name="not_main")
    model, handler = namespace["model"], namespace["handler"]
    _, metrics = model.train(hyperparameters={"C": 1.0, "max_iter": 200})
    assert metrics["test"] > 0.8
    model.save(target / "model.joblib")
    monkeypatch.setenv("UNIONML_MODEL_PATH", str(target / "model.joblib"))
    sample = json.loads((target / "data" / "sample_features.json").read_text())
    response = handler({"body": json.dumps(sample)}, None)
    assert response["statusCode"] == 200
    assert json.loads(response["body"]) == model.predict(features=sample["features"])


def test_bentoml_serving_template_serves_through_the_adapter(tmp_path, monkeypatch):
    """``bentoml-serving``: the app trains, saves into the (stand-in) bento store,
    and the service ``service.py`` builds answers ``/predict``'s request body."""
    import unionml_tpu_torch.services.bentoml_service as bs
    from tests.unit.test_services import _FakeBentoml

    monkeypatch.setattr(bs, "bentoml", _FakeBentoml())
    monkeypatch.setenv("UNIONML_DEVICE", "cpu")
    target = render_template("bentoml-serving", "bento_app", tmp_path)
    py_compile.compile(str(target / "service.py"), doraise=True)
    monkeypatch.chdir(target)
    model = runpy.run_path(str(target / "app.py"), run_name="not_main")["model"]
    model.train(hyperparameters={"C": 1.0, "max_iter": 200})
    svc = bs.BentoMLService(model, device="cpu")
    svc.save_model(name="bento_app")
    rows = json.loads((target / "data" / "sample_features_list.json").read_text())
    handler = svc.configure("bento_app").apis[0]["handler"]
    assert handler(rows) == model.predict(features=rows)
    assert "nvidia.com/gpu" in (target / "README.md").read_text()
