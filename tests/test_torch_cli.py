"""The port's command line beside the JAX package's (``click.testing.CliRunner``).

Twin of ``tests/unit/test_cli_templates.py:62-152``:

- both groups have the same fifteen commands with the same arguments and
  options (names, flags, defaults, multiplicity);
- ``init`` and ``templates`` answer as JAX's; an unknown template is refused
  with the same message;
- local train (with ``--profile-dir``: a ``torch.profiler`` trace and stage
  timings) and predict (``--model-path``) on the port's ``mnist-cnn`` template
  on the CPU, and the bad-JSON message;
- the remote round trip (deploy, train, predict, listings, fetches,
  schedules) over ``tests/torch_backend_app.py`` on an in-process backend,
  whose printed metrics and predictions equal JAX's CLI over its own app;
- ``serve`` hands ``serving_app`` the same keyword arguments as JAX's for
  ``--replicas``, ``--no-telemetry`` and ``--trace-journal`` (plus an app
  module's ``generator`` factory), and ``/generate`` answers through them;
- without ``click`` the module still imports and ``main()`` exits 1 naming
  it; the port's entry modules import without any optional dependency.
"""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from unionml_tpu.cli import app as jax_cli
from unionml_tpu_torch import cli
from unionml_tpu_torch.backend import LocalBackend
from unionml_tpu_torch.templates import render_template

REPO_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """One intra-op thread (the workers share the cores), and no rendered
    ``app`` module cached from another test: each test imports its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    sys.modules.pop("app", None)
    yield
    sys.modules.pop("app", None)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_cli():
    return cli.build_cli()


def _params(command):
    return [(p.name, tuple(p.opts), tuple(p.secondary_opts), p.default, p.multiple, p.required,
             getattr(p, "is_flag", False)) for p in command.params]


def test_the_fifteen_commands_and_their_options_are_jax(port_cli):
    assert sorted(port_cli.commands) == sorted(jax_cli.commands) and len(port_cli.commands) == 15
    for name in jax_cli.commands:
        assert _params(port_cli.commands[name]) == _params(jax_cli.commands[name]), name
    assert port_cli.name == "unionml-tpu-torch"


def test_cli_init_and_templates_cmd(port_cli, tmp_path, monkeypatch):
    runner = CliRunner()
    monkeypatch.chdir(tmp_path)
    result = runner.invoke(port_cli, ["init", "demo_app", "--template", "basic"])
    assert result.exit_code == 0, result.output
    assert result.output == f"Created {tmp_path / 'demo_app'} from template 'basic'\n"
    assert (tmp_path / "demo_app" / "app.py").exists()
    assert "unionml_tpu_torch" in (tmp_path / "demo_app" / "app.py").read_text()

    result = runner.invoke(port_cli, ["templates"])
    assert result.exit_code == 0
    names = [line.split()[0] for line in result.output.splitlines()]
    assert "basic" in names and "serverless" in names and "bentoml-serving" in names
    assert set(names) == set([line.split()[0] for line in runner.invoke(jax_cli, ["templates"]).output.splitlines()])

    for group in (port_cli, jax_cli):
        result = runner.invoke(group, ["init", "demo_app2", "--template", "nonexistent"])
        assert result.exit_code == 2 and "unknown template 'nonexistent'" in result.output
        result = runner.invoke(group, ["init", "demo_app", "--template", "basic"])  # exists already
        assert result.exit_code == 1 and "already exists" in result.output


def test_cli_local_train_and_predict(port_cli, tmp_path, monkeypatch):
    """End-to-end CLI flow on the port's mnist-cnn template, on the CPU."""
    runner = CliRunner()
    monkeypatch.setenv("UNIONML_DEVICE", "cpu")
    render_template("mnist-cnn", "cli_app_t", tmp_path)
    monkeypatch.chdir(tmp_path / "cli_app_t")
    inputs = json.dumps({"n": 64, "trainer_kwargs": {"num_epochs": 1, "batch_size": 32}})
    result = runner.invoke(port_cli, ["train", "app:model", "--local", "--inputs", inputs,
                                      "--profile-dir", str(tmp_path / "trace")])
    assert result.exit_code == 0, result.output
    payload = json.loads(result.output.strip().splitlines()[-1])
    assert set(payload["metrics"]) == {"train", "test"}
    assert set(payload["stage_timings_s"]) == {"cli_app_t_dataset.dataset_task", "cli_app_t.train_task"}
    assert all(t > 0 for t in payload["stage_timings_s"].values())
    assert [p for p in (tmp_path / "trace").iterdir() if p.suffix == ".json"]

    result = runner.invoke(port_cli, ["train", "app:model", "--local", "--inputs", "{bad json"])
    assert result.exit_code != 0
    assert "--inputs must be valid JSON" in result.output

    # the module the CLI imported holds the trained artifact: save it, then predict from the file
    model = sys.modules["app"].model
    model.train(**json.loads(inputs))
    model.save(tmp_path / "cnn_model.pt")
    sys.modules.pop("app")
    result = runner.invoke(port_cli, ["predict", "app:model", "--local", "--model-path",
                                      str(tmp_path / "cnn_model.pt"), "--inputs", json.dumps({"n": 4})])
    assert result.exit_code == 0, result.output
    predictions = json.loads(result.output)
    assert len(predictions) == 4 and all(0 <= p < 10 for p in predictions)
    assert predictions == model.predict(n=4).tolist()


@pytest.fixture()
def remote_apps(tmp_path, monkeypatch):
    """The port's backend app and JAX's, each on an in-process backend of its own."""
    monkeypatch.setenv("UNIONML_TPU_HOME", str(tmp_path))
    monkeypatch.chdir(REPO_ROOT)
    from tests.integration.backend_app import model as jmodel
    from tests.torch_backend_app import model
    from unionml_tpu.backend import LocalBackend as JaxBackend

    model.remote(LocalBackend(root=tmp_path / "backend", in_process=True))
    jmodel.remote(JaxBackend(root=tmp_path / "jax_backend", in_process=True))
    monkeypatch.setattr(model, "_artifact", None)
    monkeypatch.setattr(jmodel, "_artifact", None)
    return model, jmodel


def test_cli_remote_roundtrip(port_cli, remote_apps, tmp_path):
    """CLI deploy -> train -> predict -> list/fetch -> schedules against the local backend."""
    model, _ = remote_apps
    runner = CliRunner()
    app = "tests.torch_backend_app:model"
    jax_app = "tests.integration.backend_app:model"

    def both(*args, port_app=app):
        got = runner.invoke(port_cli, [args[0], port_app, *args[1:]])
        want = runner.invoke(jax_cli, [args[0], jax_app, *args[1:]])
        assert got.exit_code == 0 and want.exit_code == 0, (got.output, want.output)
        return got.output, want.output

    got, want = both("deploy", "--app-version", "cli-v1")
    assert got == want == "Deployed app version cli-v1\n"
    got, want = both("train", "--wait", "--app-version", "cli-v1", "--inputs",
                     json.dumps({"hyperparameters": {"max_iter": 150}, "n": 50}))
    assert got == want and set(json.loads(got)["metrics"]) == {"train", "test"}
    got, want = both("predict", "--wait", "--app-version", "cli-v1", "--inputs", json.dumps({"n": 10}))
    assert got == want and len(json.loads(got)) == 10
    batch_predictions = json.loads(got)
    features = tmp_path / "features.json"
    features.write_text(json.dumps([{"x1": 1.0, "x2": 1.0}, {"x1": -2.0, "x2": -2.0}]))
    got, want = both("predict", "--wait", "--features", str(features))
    assert got == want == "[1.0, 0.0]\n"

    versions = runner.invoke(port_cli, ["list-model-versions", app]).output.split()
    assert versions == model.remote_list_model_versions() and len(versions) == 1
    ids = runner.invoke(port_cli, ["list-prediction-ids", app, "--limit", "5"]).output.split()
    assert len(ids) == 2

    out_file = tmp_path / "fetched.joblib"
    result = runner.invoke(port_cli, ["fetch-model", app, "-o", str(out_file)])
    assert result.exit_code == 0 and result.output == f"Saved model to {out_file}\n"
    assert (model.load(out_file).coef_ == model.resolve_model_artifact(model_version=versions[0]).model_object.coef_).all()
    out_preds = tmp_path / "predictions.json"
    result = runner.invoke(port_cli, ["fetch-predictions", app, "-o", str(out_preds)])
    assert result.exit_code == 0 and result.output == f"Saved predictions to {out_preds}\n"
    assert json.loads(out_preds.read_text()) == batch_predictions  # "latest": the newest batch prediction

    got, want = both("deactivate-schedules", "--app-version", "cli-v1", "-n", "nightly-train")
    assert got == want == "" and model._remote.list_schedules()[0]["active"] is False
    both("activate-schedules", "--app-version", "cli-v1")
    assert model._remote.list_schedules()[0]["active"] is True
    got, want = both("list-scheduled-training-runs", "nightly-train")
    assert got == want == ""
    result = runner.invoke(port_cli, ["list-scheduled-prediction-runs", app, "nightly-train"])
    assert result.exit_code == 1 and "does not exist" in str(result.exception)
    result = runner.invoke(port_cli, ["train", app, "--app-version", "cli-v1"])
    assert result.exit_code == 0 and result.output.startswith("Launched execution backend_model-train-")


def test_fetch_predictions_without_any(port_cli, remote_apps):
    result = CliRunner().invoke(port_cli, ["fetch-predictions", "tests.torch_backend_app:model", "-o", "x.json"])
    assert result.exit_code == 1 and "No predictions found." in result.output


def _captured_serve(monkeypatch, group, package, args):
    """Invoke ``serve`` with ``serving_app``/``run_app`` of ``package`` captured."""
    import importlib

    serving = importlib.import_module(f"{package}.serving")
    calls = {}
    monkeypatch.setattr(serving, "serving_app", lambda model, **kwargs: calls.update(model=model, kwargs=kwargs))
    monkeypatch.setattr(serving, "run_app", lambda app, host, port: calls.update(host=host, port=port))
    result = CliRunner().invoke(group, ["serve", *args])
    return result, calls


@pytest.mark.parametrize("options", [
    [],
    ["--replicas", "2"],
    ["--no-telemetry"],
    ["--trace-journal", "journal.jsonl", "--no-telemetry"],  # a journal implies telemetry
    ["--remote", "--app-version", "v3", "--model-version", "abc", "--host", "0.0.0.0", "--port", "9001"],
], ids=["defaults", "replicas", "no_telemetry", "trace_journal", "remote"])
def test_serve_builds_the_jax_kwargs(port_cli, remote_apps, monkeypatch, tmp_path, options):
    monkeypatch.setenv("UNIONML_MODEL_PATH", "unset")  # --model-path writes it; restored afterwards
    args = ["--model-path", str(Path(__file__))] + options
    got, got_calls = _captured_serve(monkeypatch, port_cli, "unionml_tpu_torch", ["tests.torch_backend_app:model", *args])
    want, want_calls = _captured_serve(monkeypatch, jax_cli, "unionml_tpu", ["tests.integration.backend_app:model", *args])
    assert got.exit_code == want.exit_code == 0, (got.output, want.output)
    assert got_calls["kwargs"] == want_calls["kwargs"]
    assert (got_calls["host"], got_calls["port"]) == (want_calls["host"], want_calls["port"])
    assert got_calls["model"].name == "backend_model"
    model, kwargs = cli.serve_kwargs("tests.torch_backend_app:model")
    assert "generator" not in kwargs and model is got_calls["model"]


def test_serve_rejects_zero_replicas(port_cli, remote_apps):
    for group, app in ((port_cli, "tests.torch_backend_app:model"), (jax_cli, "tests.integration.backend_app:model")):
        result = CliRunner().invoke(group, ["serve", app, "--replicas", "0"])
        assert result.exit_code == 2 and "--replicas must be >= 1" in result.output


def test_serve_kwargs_drive_generate(tmp_path, monkeypatch):
    """``serve`` over an app module with a ``generator`` factory, on the CPU:
    the model loads from ``--model-path`` and ``/generate``'s plain route
    functions answer with the greedy tokens ``generate`` gives."""
    from tests import torch_lm_app
    from unionml_tpu_torch.models import generate
    from unionml_tpu_torch.serving.app import build_generator, load_model_artifact, parse_generate_payload
    from unionml_tpu_torch.serving.telemetry import Telemetry

    monkeypatch.chdir(REPO_ROOT)
    monkeypatch.setenv("UNIONML_MODEL_PATH", "unset")
    model = torch_lm_app.model
    monkeypatch.setattr(model, "_artifact", None)
    model.train()
    model.save(tmp_path / "lm.pt")
    monkeypatch.setattr(model, "_artifact", None)
    served, kwargs = cli.serve_kwargs("tests.torch_lm_app:model", model_path=tmp_path / "lm.pt",
                                      trace_journal=tmp_path / "journal.jsonl", telemetry=False)
    assert served is model and kwargs["generator"] is torch_lm_app.generator
    assert kwargs["generate_telemetry"] is True and kwargs["generate_trace_journal"] == str(tmp_path / "journal.jsonl")
    load_model_artifact(model, remote=kwargs["remote"], app_version=kwargs["app_version"],
                        model_version=kwargs["model_version"])
    gen = build_generator(kwargs["generator"], telemetry=Telemetry(journal_path=kwargs["generate_trace_journal"]),
                          device="cpu")
    prompt = np.random.default_rng(3).integers(1, 500, 7).tolist()
    req = parse_generate_payload({"prompt_ids": prompt, "max_new_tokens": 6}, gen)
    try:
        tokens = asyncio.run(gen.generate(req.prompt_ids, req.max_new_tokens, **req.slo, **req.sampling))
    finally:
        gen.close()
    with torch.no_grad():
        want = generate(model.artifact.model_object.model, torch.tensor([prompt]), 6)[0, len(prompt):].tolist()
    assert tokens == want


def test_main_without_click(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "click", None)  # what a machine without click gives
    import importlib

    reloaded = importlib.reload(cli)
    try:
        with pytest.raises(SystemExit) as excinfo:
            reloaded.main()
        assert excinfo.value.code == 1
        assert "click" in capsys.readouterr().err
        assert reloaded.templates().splitlines()[0].startswith("basic")  # the bodies still run
    finally:
        monkeypatch.delitem(sys.modules, "click")
        importlib.reload(cli)


def test_entry_modules_import_without_optional_dependencies():
    """``cli``, ``backend``, ``remote``, ``services``, ``profiling`` and ``debug``
    import with click, aiohttp, fastapi, bentoml, fsspec and sklearn blocked,
    and load no JAX."""
    code = (
        "import sys\n"
        "for name in ('click', 'aiohttp', 'fastapi', 'bentoml', 'fsspec', 'sklearn', 'pandas'):\n"
        "    sys.modules[name] = None\n"
        "import unionml_tpu_torch.cli, unionml_tpu_torch.backend, unionml_tpu_torch.backend.worker\n"
        "import unionml_tpu_torch.remote, unionml_tpu_torch.services, unionml_tpu_torch.profiling\n"
        "import unionml_tpu_torch.debug, unionml_tpu_torch.schedule\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'unionml_tpu')]\n"
        "try:\n"
        "    unionml_tpu_torch.cli.main()\n"
        "except SystemExit as exc:\n"
        "    sys.exit(10 + exc.code)\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 11, result.stderr
    assert "needs the click package" in result.stderr
