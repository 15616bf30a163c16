"""The port's deploy surface beside the JAX package's: schedules, app versions,
the execution backend, the remote surface of ``Model``.

Twins of ``tests/unit/test_schedule.py`` (the cron engine's answers equal
JAX's), ``tests/unit/test_remote_versioning.py`` (git versions equal JAX's)
and ``tests/integration/test_backend.py`` (deploy -> remote train/predict ->
lineage -> schedules -> failures -> retries) over ``tests/torch_backend_app.py``,
the port's twin of ``tests/integration/backend_app.py``, whose metrics and
predictions equal the JAX app's on the JAX package's own in-process backend.

Every backend test runs in process (``LocalBackend(in_process=True)``) but two,
which start the worker subprocess (``python -m unionml_tpu_torch.backend.worker``):
a remote train without waiting, and a worker that fails. The wire format of a
``TrainState`` (the port's checkpoint format) round-trips bitwise through
``tests/torch_lm_app.py``. Multi-host jobs and ``tpu-pod://`` raise naming M12.
"""

import datetime
import pickle
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import pytest
import torch

from unionml_tpu import schedule as jschedule
from unionml_tpu.remote import get_app_version as jax_app_version
from unionml_tpu_torch import schedule
from unionml_tpu_torch.backend import (
    LocalBackend,
    Scheduler,
    backend_from_config,
    wire_decode_value,
    wire_encode_value,
)
from unionml_tpu_torch.defaults import Resources
from unionml_tpu_torch.exceptions import BackendError, ModelArtifactNotFound, ScheduleError, VersionFetchError
from unionml_tpu_torch.remote import get_app_version

REPO_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------- schedules


def test_schedule_type_coercion_and_validation():
    assert schedule.Schedule(type="trainer", name="s", expression="0 0 * * *").type is schedule.ScheduleType.trainer
    with pytest.raises(ScheduleError, match="not both"):
        schedule.Schedule(type="trainer", name="s", expression="0 0 * * *", fixed_rate=timedelta(hours=1)).validate()
    with pytest.raises(ScheduleError, match="exactly one"):
        schedule.Schedule(type="trainer", name="s").validate()
    for bad in ("* * *", "61 * * * *", "* 25 * * *", "a b c d e", "*/0 * * * *"):
        with pytest.raises(ScheduleError):
            schedule.parse_cron(bad)
        with pytest.raises(jschedule.ScheduleError):
            jschedule.parse_cron(bad)


def test_create_scheduled_job():
    job = schedule.create_scheduled_job("m.train", "nightly", expression="@daily", inputs={"a": 1})
    assert job.type is schedule.ScheduleType.trainer and job.inputs == {"a": 1}
    job2 = schedule.create_scheduled_job("m.predict", "preds", fixed_rate=timedelta(minutes=30), fixed_inputs={"b": 2})
    assert job2.type is schedule.ScheduleType.predictor and job2.inputs == {"b": 2}


@pytest.mark.parametrize(
    "expression,offset,after",
    [
        ("0 0 * * *", None, datetime.datetime(2026, 7, 1, 10, 30)),
        ("@hourly", None, datetime.datetime(2026, 7, 1, 10, 30)),
        ("*/15 * * * *", None, datetime.datetime(2026, 7, 1, 10, 7)),
        ("0 9 * * mon", None, datetime.datetime(2026, 7, 1, 10, 0)),
        ("30 6 1 * *", None, datetime.datetime(2026, 7, 2, 0, 0)),
        ("5/15 * * * *", None, datetime.datetime(2026, 7, 1, 10, 21)),
        ("0 0 1 jan-mar *", "PT6H", datetime.datetime(2026, 12, 30, 0, 0)),
        ("0 12 13 * fri", "P1DT30M", datetime.datetime(2026, 3, 1, 0, 0)),
    ],
)
def test_next_fire_time_matches_jax(expression, offset, after):
    got = schedule.next_fire_time(schedule.Schedule(type="trainer", name="s", expression=expression,
                                                    offset=offset), after)
    assert got == jschedule.next_fire_time(jschedule.Schedule(type="trainer", name="s", expression=expression,
                                                              offset=offset), after)
    assert got > after


def test_next_fire_time_fixed_rate():
    rate = schedule.Schedule(type="predictor", name="s", fixed_rate=timedelta(minutes=10))
    assert schedule.next_fire_time(rate, datetime.datetime(2026, 7, 1, 10, 0)) == datetime.datetime(2026, 7, 1, 10, 10)
    assert schedule.parse_iso_duration("P1W2DT3H4M5S") == jschedule.parse_iso_duration("P1W2DT3H4M5S")


# ---------------------------------------------------------------------- app versions from git


def _git(*args, cwd):
    env = {"PATH": "/usr/bin:/bin", "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}
    subprocess.run(["git", *args], cwd=cwd, check=True, env=env, capture_output=True)


@pytest.fixture()
def git_repo(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _git("init", "-q", cwd=tmp_path)
    (tmp_path / "app.py").write_text("x = 1\n")
    _git("add", "-A", cwd=tmp_path)
    _git("commit", "-q", "-m", "init", cwd=tmp_path)
    return tmp_path


def test_clean_tree_returns_sha(git_repo):
    version = get_app_version()
    sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True).stdout.strip()
    assert version == sha[:12] == jax_app_version()


def test_dirty_tree_requires_opt_in(git_repo):
    (git_repo / "app.py").write_text("x = 2\n")
    with pytest.raises(VersionFetchError, match="uncommitted"):
        get_app_version()
    assert get_app_version(allow_uncommitted=True) == jax_app_version(allow_uncommitted=True)
    assert get_app_version(allow_uncommitted=True).endswith("-dirty")


def test_outside_repo_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(VersionFetchError, match="git"):
        get_app_version()


def test_deploy_patch_version_suffix(git_repo, monkeypatch, tmp_path):
    """Patch deployment appends -patch<uuid> to the sha; an explicit version never calls git."""
    from tests.torch_backend_app import model

    monkeypatch.setattr(model, "_backend", None)
    model.remote(LocalBackend(root=tmp_path / "backend", in_process=True))
    version = model.remote_deploy(patch=True)
    sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True).stdout.strip()
    assert version.startswith(sha[:12]) and "-patch" in version
    monkeypatch.chdir(tmp_path.parent)  # no repository here: a fixed version still deploys
    assert model.remote_deploy(app_version="fixed-1") == "fixed-1"


# ---------------------------------------------------------------------- the backend


@pytest.fixture()
def app_model(tmp_path, monkeypatch):
    """The port's backend app on an in-process backend; the worker subprocess
    of the spawning tests inherits this environment (repo-root imports)."""
    monkeypatch.setenv("PYTHONPATH", str(REPO_ROOT))
    monkeypatch.setenv("UNIONML_TPU_HOME", str(tmp_path))
    monkeypatch.chdir(REPO_ROOT)
    from tests.torch_backend_app import model

    backend = LocalBackend(root=tmp_path / "backend", in_process=True)
    model.remote(backend, gpu=1, gpu_memory="80Gi")
    monkeypatch.setattr(model, "_artifact", None)
    return model, backend


def test_full_remote_lifecycle(app_model, tmp_path):
    model, backend = app_model
    version = model.remote_deploy(app_version="v-test-1")
    assert version == "v-test-1"
    spec = backend.fetch_workflow_spec("backend_model.train", "v-test-1")
    assert spec["app_module"] == "tests.torch_backend_app" and spec["app_variable"] == "model"
    assert spec["resources"] == {"cpu": "1", "mem": "1Gi", "gpu": 1, "gpu_memory": "80Gi", "host_count": 1}

    artifact = model.remote_train(app_version="v-test-1", hyperparameters={"max_iter": 200}, n=60, wait=True)
    assert set(artifact.metrics) == {"train", "test"} and artifact.metrics["test"] > 0.7
    assert model.artifact is artifact
    assert len(model.remote_list_model_versions()) == 1

    predictions = model.remote_predict(app_version="v-test-1", n=20, wait=True)
    features = [{"x1": 1.0, "x2": 1.0}, {"x1": -2.0, "x2": -2.0}]
    from_features = model.remote_predict(app_version="v-test-1", features=features, wait=True)
    assert len(predictions) == 20 and from_features == [1.0, 0.0]
    assert len(model.remote_list_prediction_ids()) == 2

    # the JAX app on the JAX package's in-process backend: the same metrics and predictions
    from tests.integration.backend_app import model as jmodel
    from unionml_tpu.backend import LocalBackend as JaxBackend

    jmodel.remote(JaxBackend(root=tmp_path / "jax_backend", in_process=True))
    jmodel._artifact = None
    jmodel.remote_deploy(app_version="v-test-1")
    want = jmodel.remote_train(app_version="v-test-1", hyperparameters={"max_iter": 200}, n=60, wait=True)
    assert artifact.metrics == want.metrics
    assert predictions == jmodel.remote_predict(app_version="v-test-1", n=20, wait=True)
    assert from_features == jmodel.remote_predict(app_version="v-test-1", features=features, wait=True)

    # resolve by version; the startup load of serving_app(remote=True)
    latest = model.resolve_model_artifact(model_version="latest")
    assert latest.metrics == artifact.metrics
    by_id = model.resolve_model_artifact(model_version=model.remote_list_model_versions()[0])
    assert by_id.hyperparameters == artifact.hyperparameters
    from unionml_tpu_torch.serving.app import load_model_artifact

    model._artifact = None
    load_model_artifact(model, remote=True, app_version="v-test-1")
    assert model.artifact.metrics == artifact.metrics
    with pytest.raises(ModelArtifactNotFound):
        model.resolve_model_artifact(model_version="latest", app_version="no-such-version")


def test_remote_train_no_wait_returns_execution(app_model):
    """One of the two spawning tests: the execution runs in a worker subprocess."""
    model, in_process = app_model
    model.remote(LocalBackend(root=in_process.root))  # the default: a worker process per execution
    model.remote_deploy(app_version="v-test-2")
    execution = model.remote_train(app_version="v-test-2", hyperparameters={"max_iter": 100}, wait=False)
    assert (execution.directory / "pid").exists()
    execution = model.remote_wait(execution, timeout=120)
    assert execution.status == "SUCCEEDED"
    model.remote_load(execution)
    fetched = model.remote_fetch_model(execution)
    assert model.artifact is not None and fetched.metrics == model.artifact.metrics
    assert (model.artifact.model_object.coef_ == fetched.model_object.coef_).all()
    model.remote(in_process)  # the same store, in process: predictions from the worker's model
    pending = model.remote_predict(app_version="v-test-2", n=5, wait=False)
    assert model.remote_fetch_predictions(pending) == model.remote_predict(app_version="v-test-2", n=5, wait=True)


def test_failed_worker_surfaces_error(app_model):
    """The other spawning test: inputs the workflow rejects -> the worker fails and records it."""
    model, _ = app_model
    backend = LocalBackend(root=model._remote.root)
    model.remote(backend)
    model.remote_deploy(app_version="v-fail-1")
    execution = backend.execute(model, "backend_model.train", inputs={"hyperparameters": {}, "bogus_arg": 1},
                                app_version="v-fail-1")
    with pytest.raises(BackendError, match="failed"):
        backend.wait(execution, timeout=120)
    assert "WorkflowError" in execution.error
    assert "Worker failed" in (execution.directory / "worker.log").read_text()


def test_schedules_deploy_activate_and_fire(app_model):
    model, backend = app_model
    model.remote_deploy(app_version="v-sched-1", schedule=True)
    records = {r["name"]: r for r in backend.list_schedules()}
    assert records["nightly-train"]["active"] is True  # activate_on_deploy default

    model.remote_deactivate_schedules(app_version="v-sched-1")
    assert backend.list_schedules()[0]["active"] is False
    model.remote_activate_schedules(app_version="v-sched-1", schedule_names=["nightly-train"])
    assert backend.list_schedules()[0]["active"] is True

    # drive the scheduler loop deterministically: first tick arms, second tick fires
    scheduler = Scheduler(backend)
    assert scheduler.tick(now=datetime.datetime(2026, 7, 1, 10, 0)) == []
    fired = scheduler.tick(now=datetime.datetime(2026, 7, 2, 0, 1))
    assert len(fired) == 1 and backend.wait(fired[0], timeout=60).status == "SUCCEEDED"
    assert [e.id for e in model.remote_list_scheduled_training_runs("nightly-train")] == [fired[0].id]
    with pytest.raises(ValueError, match="does not exist"):
        model.remote_list_scheduled_training_runs("missing-schedule")
    with pytest.raises(ValueError, match="does not exist"):
        model.remote_list_scheduled_prediction_runs("nightly-train")


def test_schedule_registration(app_model):
    model, backend = app_model
    assert model.training_schedule_names == ["nightly-train"] and model.prediction_schedule_names == []
    with pytest.raises(ValueError, match="unique name"):
        model.schedule_training("nightly-train", expression="@daily")
    with pytest.raises(ValueError, match="Expected schedule type"):
        model.add_trainer_schedule(schedule.Schedule(type="predictor", name="x", expression="@daily"))
    model.remote_train(app_version=None, hyperparameters={"max_iter": 100}, n=40, wait=True)
    model.schedule_prediction("hourly-preds", expression="@hourly", n=10)
    try:
        assert model.prediction_schedule_names == ["hourly-preds"]
        sched = model.prediction_schedules[0]
        assert sched.inputs["n"] == 10 and sched.inputs["model_object"] is model.artifact.model_object
        model.remote_deploy(app_version="v-sched-2")
        assert {r["name"] for r in backend.list_schedules()} == {"nightly-train", "hourly-preds"}
    finally:
        model._prediction_schedules.clear()
    # schedules collected from a decorated trainer, as the JAX package's decorators do
    from tests.test_torch_model import sklearn_app

    app = sklearn_app(__import__("unionml_tpu_torch"))
    trainer = app._trainer
    trainer.__unionml_schedules__ = [schedule.Schedule(type="trainer", name="weekly", expression="@weekly")]
    app.trainer(trainer)
    assert app.training_schedule_names == ["weekly"]


def test_job_level_retry_recovers_transient_failure(tmp_path, monkeypatch):
    monkeypatch.setenv("UNIONML_TEST_FLAKY_DIR", str(tmp_path / "flaky"))
    from tests.torch_flaky_app import model

    backend = LocalBackend(root=tmp_path / "backend", retries=2, in_process=True)
    model.remote(backend)
    monkeypatch.setattr(model, "_artifact", None)
    model.remote_deploy(app_version="v-flaky")
    artifact = model.remote_train(app_version="v-flaky", hyperparameters={"max_iter": 100}, wait=True)
    assert artifact.metrics["train"] > 0.5
    execution = backend.list_executions(workflow_name="flaky_model.train", limit=1)[0]
    assert backend._attempts(execution) == 2  # failed once, retried once

    # zero budget: the same transient failure surfaces as FAILED
    import shutil

    shutil.rmtree(tmp_path / "flaky")
    model.remote(LocalBackend(root=tmp_path / "backend2", retries=0, in_process=True))
    model.remote_deploy(app_version="v-flaky2")
    with pytest.raises(BackendError, match="transient failure"):
        model.remote_train(app_version="v-flaky2", hyperparameters={"max_iter": 100}, wait=True)


def test_dead_worker_is_reaped(tmp_path):
    """A worker that exits without a status (killed, crashed) fails its execution."""
    backend = LocalBackend(root=tmp_path / "backend")
    execution_dir = backend._executions_dir / "dead"
    execution_dir.mkdir(parents=True)
    (execution_dir / "meta.json").write_text('{"workflow_name": "m.train"}')
    (execution_dir / "status").write_text("RUNNING")
    process = subprocess.Popen([sys.executable, "-c", "pass"])
    process.wait(timeout=30)
    backend._workers["dead"] = [process]
    execution = backend.get_execution("dead")
    with pytest.raises(BackendError, match="exited without reporting"):
        backend.wait(execution, timeout=5)
    # a client that did not start it finds the pid dead in /proc
    (execution_dir / "status").write_text("RUNNING")
    (execution_dir / "pid").write_text(str(process.pid))
    with pytest.raises(BackendError, match="exited without reporting"):
        LocalBackend(root=tmp_path / "backend").wait(execution, timeout=5)


def test_multi_host_and_pod_targets_raise_naming_m12(app_model, tmp_path, monkeypatch):
    model, backend = app_model
    with pytest.raises(NotImplementedError, match="M12"):
        model.remote(backend, host_count=2)
    with pytest.raises(NotImplementedError, match="M12"):
        model.remote(backend, resources=Resources(gpu=8, host_count=2))
    with pytest.raises(NotImplementedError, match="M12"):
        backend_from_config("tpu-pod://local?store=file:///tmp/store&hosts=2")
    monkeypatch.setattr(model, "_resources", Resources(host_count=2))  # as a config built elsewhere would carry it
    with pytest.raises(NotImplementedError, match="M12"):
        backend.execute(model, "backend_model.train", inputs={})
    with pytest.raises(NotImplementedError, match="M12"):
        LocalBackend(root=tmp_path / "spawning").execute(model, "backend_model.train", inputs={})
    assert not any((tmp_path / "spawning").rglob("meta.json"))  # refused before any execution exists


def test_backend_from_config(tmp_path, monkeypatch):
    monkeypatch.setenv("UNIONML_TPU_HOME", str(tmp_path / "home"))
    for target in (None, "local", "sandbox"):
        assert backend_from_config(target).root == tmp_path / "home" / "backend"
    assert backend_from_config(f"local://{tmp_path / 'elsewhere'}").root == tmp_path / "elsewhere"
    config = tmp_path / "backend.yaml"
    config.write_text(f"backend:\n  root: {tmp_path / 'yaml'}\n  project: p\n  domain: d\n  in_process: true\n")
    backend = backend_from_config(config_file=str(config))
    assert (backend.root, backend.default_project, backend.default_domain, backend.in_process) == (
        tmp_path / "yaml", "p", "d", True)
    with pytest.raises(BackendError, match="Unknown backend target"):
        backend_from_config("s3://bucket")


def test_train_state_crosses_the_wire_bitwise(tmp_path, monkeypatch):
    """A ``TrainState`` travels in the checkpoint format (host tensors by
    parameter name + hyperparameters), never pickled, and comes back bitwise;
    an in-process remote train equals a local one."""
    from tests import torch_lm_app

    model = torch_lm_app.model
    monkeypatch.setattr(model, "_artifact", None)
    backend = LocalBackend(root=tmp_path / "backend", in_process=True)
    model.remote(backend)
    model.remote_deploy(app_version="lm-v1")
    artifact = model.remote_train(app_version="lm-v1", hyperparameters={"learning_rate": 3e-3}, wait=True)
    execution = backend.list_executions(workflow_name="lm_app.train", limit=1)[0]
    with (execution.directory / "outputs.pkl").open("rb") as f:
        raw = pickle.load(f)["model_object"]
    assert set(raw) == {"__unionml_state_dict__", "hyperparameters"}
    assert raw["hyperparameters"] == {"learning_rate": 3e-3, "seed": 0}
    saved, state = raw["__unionml_state_dict__"], artifact.model_object
    assert state.step == saved["step"] == 3
    for group in ("params", "mu", "nu"):
        for name, tensor in zip(state.names, getattr(state, group)):
            assert torch.equal(tensor, saved[group][name]), (group, name)
    local_state, metrics = model.train(hyperparameters={"learning_rate": 3e-3})
    assert metrics == artifact.metrics
    assert all(torch.equal(a, b) for a, b in zip(local_state.params, state.params))
    module = wire_encode_value(local_state.model)  # a module alone: its state dict, never pickled
    assert all(torch.equal(v, module["__unionml_state_dict__"][k]) for k, v in local_state.model.state_dict().items())
    encoded = wire_encode_value(local_state, {"learning_rate": 3e-3})
    decoded = wire_decode_value(encoded, model)
    assert all(torch.equal(a, b) for a, b in zip(decoded.params, local_state.params))
    assert wire_encode_value({"plain": 1}) == {"plain": 1}
