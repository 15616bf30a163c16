"""The port's ``Model`` against the JAX package's, on the same apps and weights.

Two apps are built in both packages from one numpy-seeded description:

- the flagship BERT app's shape (``unionml_tpu/templates/bert-finetune/app.py``)
  on the tiny f32 config: dict features of right-padded token ids from a
  feature loader, logits or labels from the predictor. The JAX app's
  parameters are carried into the port by ``bert_params_from_jax``;
- the jax-digits app's shape: sklearn's digits, ``MLPClassifier``, weights
  carried by ``mlp_params_from_jax``.

Tolerances: float32 logits within 1e-5 (one forward each; the two packages
sum in different orders); labels identical; saved and loaded models
bitwise. ``Model``'s own surface (hyperparameter types, stage interfaces,
artifacts, callbacks, the deploy surface on an in-process backend) is held to
the JAX package's answers exactly.
"""

from datetime import timedelta
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.linear_model import LogisticRegression

import unionml_tpu as J
import unionml_tpu_torch as T
from unionml_tpu.models import bert as jbert
from unionml_tpu.models import training as jtraining
from unionml_tpu_torch.exceptions import ModelArtifactNotFound
from unionml_tpu_torch.models import (
    BertConfig,
    MLPClassifier,
    TrainState,
    create_train_state,
    init_bert,
    mlp_params_from_jax,
)
from unionml_tpu_torch.models.mlp import CNNClassifier
from unionml_tpu_torch.models.convert import cnn_params_from_jax

LOGIT_TOL = 1e-5
SEQ = 16


# ------------------------------------------------------------------ the BERT app in both packages


def bert_reader(n: int = 24, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, SEQ + 1, n)
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(1, 1024, (n, SEQ)).astype(np.int32) * mask
    return {"input_ids": ids, "attention_mask": mask, "labels": rng.integers(0, 2, n).astype(np.int32)}


def tokenize(rows: Any) -> Dict[str, np.ndarray]:
    """Row dicts of token ids, right-padded to the longest (the apps' feature loader)."""
    if isinstance(rows, dict):
        return rows
    width = max(len(r["input_ids"]) for r in rows)
    ids = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r["input_ids"])] = r["input_ids"]
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}


def request_rows(n: int, seed: int, lo: int = 2, hi: int = SEQ) -> list:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(1, 1024, int(rng.integers(lo, hi + 1))).tolist()} for _ in range(n)]


@pytest.fixture(scope="module")
def bert_weights():
    """The JAX tiny f32 BERT's variables (dropout 0) and their numpy tree."""
    cfg = jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl="xla", hidden_dropout=0.0)
    variables = jbert.init_params(cfg, seq_len=SEQ)
    return cfg, variables, jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def jax_bert_app(cfg, variables, logits: bool = True):
    dataset = J.Dataset(name="bert_ds", test_size=0.25, targets=["labels"], device_format="jax")
    module = jbert.BertForSequenceClassification(cfg)

    def init(learning_rate: float = 1e-3) -> jtraining.TrainState:
        return jtraining.create_train_state(module, variables, learning_rate=learning_rate)

    model = J.Model(name="bert_app", init=init, dataset=dataset)
    dataset.reader(bert_reader)

    @dataset.feature_loader
    def feature_loader(rows: Any) -> Dict[str, np.ndarray]:
        return tokenize(rows)

    @model.trainer
    def trainer(state: jtraining.TrainState, features: jax.Array, targets: jax.Array) -> jtraining.TrainState:
        return state

    @model.predictor
    def predictor(state: jtraining.TrainState, features: Dict[str, jax.Array]) -> jax.Array:
        out = state.apply_fn({"params": state.params}, features["input_ids"], features["attention_mask"],
                             deterministic=True)
        return out if logits else jnp.argmax(out, axis=-1)

    @model.evaluator
    def evaluator(state: jtraining.TrainState, features: jax.Array, targets: jax.Array) -> float:
        metrics = jtraining.make_classifier_eval_step(("input_ids", "attention_mask"))(state, {**features, **targets})
        return float(metrics["accuracy"])

    return model


def port_bert_app(params, logits: bool = True, device: str = "cpu"):
    cfg = BertConfig.tiny(dtype=torch.float32, hidden_dropout=0.0)
    dataset = T.Dataset(name="bert_ds", test_size=0.25, targets=["labels"], device_format="torch", device=device)

    def init(learning_rate: float = 1e-3) -> TrainState:
        return create_train_state(init_bert(cfg, params=params, device=device), learning_rate=learning_rate)

    model = T.Model(name="bert_app", init=init, dataset=dataset)
    dataset.reader(bert_reader)

    @dataset.feature_loader
    def feature_loader(rows: Any) -> Dict[str, np.ndarray]:
        return tokenize(rows)

    @model.trainer
    def trainer(state: TrainState, features: torch.Tensor, targets: torch.Tensor) -> TrainState:
        return state

    @model.predictor
    def predictor(state: TrainState, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            out = state.model(features["input_ids"], features["attention_mask"])
        return out if logits else out.argmax(-1)

    @model.evaluator
    def evaluator(state: TrainState, features: torch.Tensor, targets: torch.Tensor) -> float:
        from unionml_tpu_torch.models import make_classifier_eval_step

        metrics = make_classifier_eval_step(("input_ids", "attention_mask"))(state, {**features, **targets})
        return float(metrics["accuracy"])

    return model


@pytest.fixture(scope="module")
def bert_apps(bert_weights):
    """(jax app, port app), both trained (the trainer returns the initial state)."""
    cfg, variables, params = bert_weights
    japp, tapp = jax_bert_app(cfg, variables), port_bert_app(params)
    japp.train()
    tapp.train()
    return japp, tapp


@pytest.mark.parametrize("seed,n_rows", [(0, 1), (1, 3), (2, 8)])
def test_bert_app_predict_logits_match(bert_apps, seed, n_rows):
    japp, tapp = bert_apps
    rows = request_rows(n_rows, seed)
    want = np.asarray(japp.predict(features=rows))
    got = tapp.predict(features=rows)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL)
    assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_bert_app_labels_and_reader_path_match(bert_weights):
    cfg, variables, params = bert_weights
    japp, tapp = jax_bert_app(cfg, variables, logits=False), port_bert_app(params, logits=False)
    japp.train()
    _, metrics = tapp.train()
    assert set(metrics) == {"train", "test"}
    rows = request_rows(12, seed=5)
    assert np.array_equal(tapp.predict(features=rows).numpy(), np.asarray(japp.predict(features=rows)))
    # reader-driven prediction: reader -> parser -> features -> predictor
    assert np.array_equal(tapp.predict(n=10, seed=3).numpy(), np.asarray(japp.predict(n=10, seed=3)))


def test_bert_app_metrics_match(bert_weights):
    cfg, variables, params = bert_weights
    _, jm = jax_bert_app(cfg, variables).train()
    _, tm = port_bert_app(params).train()
    assert jm.keys() == tm.keys()
    for split in jm:
        assert tm[split] == pytest.approx(jm[split], abs=1e-6)  # accuracies: equal labels give equal counts


def test_bert_app_save_load_round_trip(bert_apps, tmp_path, monkeypatch):
    _, tapp = bert_apps
    path = tmp_path / "bert.pt"
    tapp.save(path)
    monkeypatch.setenv("UNIONML_MODEL_PATH", str(path))
    fresh = port_bert_app(bert_apps_params(tapp))
    loaded = fresh.load_from_env()
    before = tapp.artifact.model_object
    assert loaded is not before and loaded.step == before.step
    for a, b in zip(loaded.params + loaded.mu + loaded.nu, before.params + before.mu + before.nu):
        assert torch.equal(a, b)
    rows = request_rows(4, seed=9)
    assert torch.equal(fresh.predict(features=rows), tapp.predict(features=rows))


def bert_apps_params(app):
    """A JAX-layout tree of different (zeroed) weights: a load must overwrite them all."""
    from unionml_tpu_torch.models import bert_random_params

    tree = bert_random_params(BertConfig.tiny(), seed=123)
    return jax.tree_util.tree_map(np.zeros_like, tree)


# ------------------------------------------------------------------ the digits MLP app in both packages


@pytest.fixture(scope="module")
def digits_weights():
    from unionml_tpu.models import MLPClassifier as JMLP

    mlp = JMLP(hidden_sizes=(32,), num_classes=10)
    variables = mlp.init(jax.random.PRNGKey(0), jnp.zeros((1, 64)))
    return mlp, variables


def digits_reader() -> pd.DataFrame:
    from sklearn.datasets import load_digits

    return load_digits(as_frame=True).frame


def jax_digits_app(mlp, variables):
    dataset = J.Dataset(name="digits", test_size=0.2, targets=["target"], device_format="jax")
    model = J.Model(name="digits", init=lambda: jtraining.create_train_state(mlp, variables), dataset=dataset)
    dataset.reader(digits_reader)

    @model.trainer
    def trainer(state: jtraining.TrainState, features: jax.Array, target: jax.Array) -> jtraining.TrainState:
        return state

    @model.predictor
    def predictor(state: jtraining.TrainState, features: jax.Array) -> jax.Array:
        return state.apply_fn({"params": state.params}, features)

    @model.evaluator
    def evaluator(state: jtraining.TrainState, features: jax.Array, target: jax.Array) -> float:
        return 0.0

    return model


def port_digits_app(params, epochs: int = 0):
    from unionml_tpu_torch.models import fit, make_classifier_eval_step

    dataset = T.Dataset(name="digits", test_size=0.2, targets=["target"], device_format="torch", device="cpu")

    def init(learning_rate: float = 1e-3) -> TrainState:
        mlp = MLPClassifier(64, hidden_sizes=(32,), num_classes=10, device="cpu")
        mlp.load_state_dict(mlp_params_from_jax(params))
        return create_train_state(mlp, learning_rate=learning_rate, weight_decay=1e-4)

    model = T.Model(name="digits", init=init, dataset=dataset)
    dataset.reader(digits_reader)

    @model.trainer
    def trainer(state: TrainState, features: torch.Tensor, target: torch.Tensor) -> TrainState:
        if not epochs:
            return state
        data = {"inputs": features.numpy(), "labels": target.numpy().reshape(-1).astype(np.int32)}
        return fit(state, data, batch_size=128, num_epochs=epochs, log_every=10_000).state

    @model.predictor
    def predictor(state: TrainState, features: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return state.model(features)

    @model.evaluator
    def evaluator(state: TrainState, features: torch.Tensor, target: torch.Tensor) -> float:
        labels = target.reshape(-1).to(torch.int32)
        return float(make_classifier_eval_step()(state, {"inputs": features, "labels": labels})["accuracy"])

    return model


def test_digits_app_logits_match(digits_weights):
    mlp, variables = digits_weights
    japp, tapp = jax_digits_app(mlp, variables), port_digits_app(jax.device_get(variables))
    japp.train()
    tapp.train()
    features = digits_reader().drop(columns=["target"]).iloc[:20].to_dict(orient="records")
    want = np.asarray(japp.predict(features=features))
    got = tapp.predict(features=features).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_digits_app_trains_through_fit(digits_weights):
    _, variables = digits_weights
    tapp = port_digits_app(jax.device_get(variables), epochs=15)
    state, metrics = tapp.train()
    assert state.step > 0 and metrics["train"] > 0.9 and metrics["test"] > 0.85


def test_cnn_logits_match():
    from unionml_tpu.models import CNNClassifier as JCNN

    cnn = JCNN(num_classes=10)
    x = np.random.default_rng(0).normal(size=(3, 28, 28)).astype(np.float32)
    variables = cnn.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28)))
    want = np.asarray(cnn.apply(variables, jnp.asarray(x)))
    port = CNNClassifier(device="cpu")
    port.load_state_dict(cnn_params_from_jax(jax.device_get(variables)))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), want, atol=LOGIT_TOL)


# ------------------------------------------------------------------ the Model surface (sklearn app, both packages)


def sklearn_app(pkg, custom_init: bool = False):
    dataset = pkg.Dataset(name="test_dataset", targets=["y"], test_size=0.2, shuffle=True, random_state=99)

    @dataset.reader
    def reader(sample_frac: float = 1.0, random_state: int = 123) -> pd.DataFrame:
        rng = np.random.default_rng(random_state)
        n = int(100 * sample_frac)
        return pd.DataFrame({"x1": rng.normal(size=n), "x2": rng.normal(size=n), "y": rng.integers(0, 2, size=n)})

    if custom_init:
        model = pkg.Model(name="test_model", dataset=dataset)

        @model.init
        def init(hyperparameters: dict) -> LogisticRegression:
            return LogisticRegression(**hyperparameters)
    else:
        model = pkg.Model(name="test_model", init=LogisticRegression, dataset=dataset)

    @model.trainer
    def trainer(model_obj: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> LogisticRegression:
        return model_obj.fit(features, target.squeeze())

    @model.predictor
    def predictor(model_obj: LogisticRegression, features: pd.DataFrame) -> List[float]:
        return [float(x) for x in model_obj.predict(features)]

    @model.evaluator
    def evaluator(model_obj: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> float:
        return float(model_obj.score(features, target.squeeze()))

    return model


@pytest.mark.parametrize("custom_init", [False, True], ids=["default_init", "custom_init"])
def test_sklearn_app_matches(custom_init, tmp_path):
    japp, tapp = sklearn_app(J, custom_init), sklearn_app(T, custom_init)
    assert tapp.model_type is japp.model_type
    jtask, ttask = japp.train_task(), tapp.train_task()
    assert list(ttask.python_interface.inputs) == list(jtask.python_interface.inputs)
    assert list(ttask.python_interface.outputs) == list(jtask.python_interface.outputs)
    hp = {"C": 1.0, "max_iter": 500}
    _, jm = japp.train(hyperparameters=hp)
    _, tm = tapp.train(hyperparameters=hp)
    assert tm == jm
    rows = [{"x1": 0.3, "x2": -1.0}, {"x1": -2.0, "x2": 0.5}]
    assert tapp.predict(features=rows) == japp.predict(features=rows)
    assert tapp.predict(sample_frac=0.1, random_state=4) == japp.predict(sample_frac=0.1, random_state=4)
    path = tmp_path / "m.joblib"
    tapp.save(path)
    fresh = sklearn_app(T, custom_init)
    fresh.load(path)
    assert fresh.predict(features=rows) == tapp.predict(features=rows)


def _fields(cls):
    import dataclasses

    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_hyperparameter_types_match():
    def init_annotated(C: float = 1.0, max_iter: int = 100) -> LogisticRegression:
        return LogisticRegression(C=C, max_iter=max_iter)

    def init_dict(hp: dict) -> LogisticRegression:
        return LogisticRegression(**hp)

    for init, config in ((init_annotated, None), (LogisticRegression, {"C": float}), (init_dict, None)):
        j = J.Model(name="m", init=init, dataset=sklearn_app(J).dataset, hyperparameter_config=config)
        t = T.Model(name="m", init=init, dataset=sklearn_app(T).dataset, hyperparameter_config=config)
        if j.hyperparameter_type is dict:
            assert t.hyperparameter_type is dict
        else:
            assert _fields(t.hyperparameter_type) == _fields(j.hyperparameter_type)


def test_artifacts_and_errors(tmp_path):
    app = sklearn_app(T)
    with pytest.raises(RuntimeError, match="ModelArtifact not found"):
        app.predict(features=[{"x1": 0.0, "x2": 0.0}])
    with pytest.raises(ModelArtifactNotFound):
        app.resolve_model_artifact()
    obj = LogisticRegression()
    assert app.resolve_model_artifact(model_object=obj).model_object is obj
    with pytest.raises(ValueError, match="only one of"):
        app.resolve_model_artifact(model_object=obj, model_file="x")
    # a model version resolves through the backend's lineage, as in the JAX package
    from unionml_tpu.exceptions import BackendError as JaxBackendError
    from unionml_tpu_torch.exceptions import BackendError

    japp = sklearn_app(J)
    japp.remote(f"local://{tmp_path / 'jax'}")
    app.remote(f"local://{tmp_path / 'port'}")
    with pytest.raises(JaxBackendError, match="'v1' not found"):
        japp.resolve_model_artifact(model_version="v1")
    with pytest.raises(BackendError, match="'v1' not found"):
        app.resolve_model_artifact(model_version="v1")
    with pytest.raises(ValueError, match="env var"):
        app.load_from_env("UNIONML_NO_SUCH_VARIABLE")


@pytest.mark.parametrize("method", ["remote", "remote_deploy", "remote_train", "remote_predict",
                                    "schedule_training", "schedule_prediction"])
def test_deploy_surface_raises_naming_m14(method, tmp_path, monkeypatch):
    """The deploy surface (ROADMAP M14) once raised here; each method now works
    against an in-process backend on the port's backend app, with the local
    path's answers. Its one unported part, jobs on several hosts, raises
    naming M12."""
    from tests.torch_backend_app import model
    from unionml_tpu_torch.backend import LocalBackend

    for attr in ("_artifact", "_backend", "_resources"):
        monkeypatch.setattr(model, attr, getattr(model, attr))
    model._artifact = None
    monkeypatch.setattr(model, "_training_schedules", list(model._training_schedules))
    monkeypatch.setattr(model, "_prediction_schedules", [])
    backend = LocalBackend(root=tmp_path / "backend", in_process=True)
    hyperparameters = {"max_iter": 200}
    if method == "remote":
        model.remote(f"local://{tmp_path / 'store'}", gpu=2, gpu_memory="80Gi")
        assert model._remote.root == tmp_path / "store" and model.resources.gpu == 2
        with pytest.raises(NotImplementedError, match="M12"):
            model.remote(backend, host_count=2)
        return
    model.remote(backend)
    if method == "remote_deploy":
        assert model.remote_deploy(app_version="v1") == "v1"
        assert backend.fetch_workflow_spec(model.train_workflow_name, "v1")["app_variable"] == "model"
    elif method == "remote_train":
        artifact = model.remote_train(hyperparameters=hyperparameters, n=60)
        _, metrics = model.train(hyperparameters=hyperparameters, n=60)
        assert artifact.metrics == metrics
    elif method == "remote_predict":
        model.remote_train(hyperparameters=hyperparameters, n=60)
        assert model.remote_predict(n=20) == model.predict(n=20)
    elif method == "schedule_training":
        model.schedule_training("hourly", fixed_rate=timedelta(hours=1), n=30)
        model.remote_deploy(app_version="v2")
        assert {r["name"] for r in backend.list_schedules()} == {"nightly-train", "hourly"}
    else:
        model.remote_train(hyperparameters=hyperparameters, n=60)
        model.schedule_prediction("daily-preds", expression="@daily", n=10)
        assert model.prediction_schedules[0].inputs["model_object"] is model.artifact.model_object


def test_prediction_callbacks():
    calls = []
    app = sklearn_app(T)

    def record(model_obj: LogisticRegression, features: pd.DataFrame, predictions: List[float]):
        calls.append(len(predictions))

    def broken(model_obj: LogisticRegression, features: pd.DataFrame, predictions: List[float]):
        raise RuntimeError("boom")

    @app.predictor(callbacks=[record, broken])
    def predictor(model_obj: LogisticRegression, features: pd.DataFrame) -> List[float]:
        return [float(x) for x in model_obj.predict(features)]

    app.train(hyperparameters={"max_iter": 100})
    preds = app.predict(features=[{"x1": 0.0, "x2": 1.0}] * 10)
    assert calls == [10] and len(preds) == 10  # the broken callback is logged and swallowed
    with pytest.raises(ValueError, match="only be set once"):
        app.predict_callbacks = (record,)


def test_trainer_rejects_donation_and_serve_rejects_other_apps():
    app = sklearn_app(T)
    with pytest.raises(ValueError, match="donate_argnums"):
        @app.trainer(donate_argnums=(0,))
        def trainer(model_obj: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> LogisticRegression:
            return model_obj
    with pytest.raises(TypeError, match="Unsupported app type"):
        app.serve(app=object())
