"""The ranks of ``tests/test_torch_sharded_training.py`` and
``tests/test_torch_mesh_serving.py``: one process per rank of a gloo world
on the CPU, importing no JAX.

Every rank runs each scenario of its world in the same order (the
collectives of one scenario meet those of the same scenario on the other
ranks) and writes what it saw to ``out_dir/rank{r}.pkl``; the parent holds
it against the JAX package and against the port's unmeshed run. The inputs
(weights converted from JAX, data) come from the parent or from numpy seeds.
"""

import asyncio
import contextlib
import faulthandler
import hashlib
import os
import pickle
import signal
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

SIG = ("input_ids", "attention_mask")
#: tests/unit/test_parallel.py:46's bare-weight step, and its data
DP_SEED = 0
#: the side group's timeout of the idle serving scenario, and the idle gap (longer)
IDLE_TIMEOUT_S = 2.0
IDLE_GAP_S = 3.0
#: rows the serving scenarios send (token ids 1..L per row)
SERVE_LENS = ([3, 5, 2], [4, 1, 6, 2, 7], [2])


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A world of ``world`` ranks seen from ``rank``, in this process
    (PyTorch's ``fake`` backend: no collective runs)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=rank, world_size=world, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def gloo_world_of_one(port: int):
    """A real gloo world of one process, in this process."""
    from unionml_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"localhost:{port}", 1, 0, strict=True, device="cpu", timeout_s=60)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ data


def dp_data():
    rng = np.random.default_rng(DP_SEED)
    w = rng.normal(size=(4,)).astype(np.float32)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = rng.normal(size=(16,)).astype(np.float32)
    return w, x, y


def dp_step(w, batch):
    """``test_parallel.py:46``'s step in torch: one gradient step of the mean squared error."""
    x, y = batch
    w = w.detach().requires_grad_()
    loss = torch.mean((x @ w - y) ** 2)
    (grad,) = torch.autograd.grad(loss, w)
    return (w - 0.1 * grad).detach(), loss.detach()


def toy_classification_data(n=256, dim=16, classes=4, seed=0) -> Dict[str, np.ndarray]:
    """``tests/unit/test_models.py:80``'s data."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, dim)) * 3
    labels = rng.integers(0, classes, size=n)
    inputs = centers[labels] + rng.normal(size=(n, dim))
    return {"inputs": inputs.astype(np.float32), "labels": labels.astype(np.int32)}


def bert_batch(rows: int = 8, seq: int = 16, seed: int = 0) -> Dict[str, np.ndarray]:
    """Right-padded token ids (lengths 4..seq) and labels of the tiny BERT."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, seq + 1, rows)
    mask = (np.arange(seq)[None] < lens[:, None]).astype(np.int32)
    return {"input_ids": rng.integers(1, 1024, (rows, seq)).astype(np.int32) * mask, "attention_mask": mask,
            "labels": rng.integers(0, 2, rows).astype(np.int32)}


def lm_corpus(seed: int = 9, n: int = 24):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, int(m)).astype(np.int32) for m in rng.integers(2, 20, n)]


def tokenize(rows: Any) -> Dict[str, np.ndarray]:
    """Request rows ``{"len": L}`` (ids 1..L) or ``{"input_ids": [...]}``, right-padded."""
    if isinstance(rows, dict):
        return rows
    seqs = [list(range(1, int(r["len"]) + 1)) if "len" in r else list(r["input_ids"]) for r in rows]
    ids = np.zeros((len(seqs), max(len(s) for s in seqs)), dtype=np.int32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}


def serve_rows(lens):
    return [{"len": n} for n in lens]


# ------------------------------------------------------------------ models and apps


def bert_config(dropout: float = 0.0):
    from unionml_tpu_torch.models import BertConfig

    return BertConfig.tiny(dtype=torch.float32, hidden_dropout=dropout)


def bert_state(params, dropout: float = 0.0, lr: float = 1e-4):
    from unionml_tpu_torch.models import create_train_state, init_bert

    return create_train_state(init_bert(bert_config(dropout), params=params, device="cpu"), learning_rate=lr)


def bert_specs(state, mesh):
    from unionml_tpu_torch.models import bert
    from unionml_tpu_torch.parallel.mesh import axis_names

    return bert.param_shardings(dict(state.model.named_parameters()), axis_names(mesh))


def gpt_state(params, lr: float = 1e-3):
    from unionml_tpu_torch.models import GPTConfig, create_train_state, init_gpt

    model = init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0), params=params, device="cpu")
    return create_train_state(model, learning_rate=lr)


def whole(state) -> Dict[str, Any]:
    """The whole state as host tensors (a collective on a laid-out state)."""
    from unionml_tpu_torch.checkpoint import extract_state

    return extract_state(state)


def tokenized_app():
    """``tests/test_torch_resident.py``'s mean-embedding app, the port's half."""
    import pandas as pd

    import unionml_tpu_torch as T
    from unionml_tpu_torch.model import ModelArtifact

    emb = np.random.default_rng(0).normal(size=64).astype(np.float32)
    dataset = T.Dataset(name="tok_ds", targets=["y"], device_format="torch", device="cpu")

    @dataset.reader
    def reader(n: int = 8) -> pd.DataFrame:
        return pd.DataFrame({"text_len": np.arange(1, n + 1), "y": np.arange(n) % 2})

    dataset.feature_loader(tokenize)
    model = T.Model(name="tok_model", init=lambda: {"emb": torch.from_numpy(emb)}, dataset=dataset)

    @model.trainer
    def trainer(p: dict, X: torch.Tensor, y: torch.Tensor) -> dict:
        return p

    @model.predictor
    def predictor(p: dict, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        mask = features["attention_mask"].float()
        e = p["emb"][features["input_ids"].clamp(0, 63).long()] * mask
        return e.sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)

    @model.evaluator
    def evaluator(p: dict, X: torch.Tensor, y: torch.Tensor) -> float:
        return 1.0

    model.artifact = ModelArtifact({"emb": torch.from_numpy(emb)})
    return model


def bert_app(params):
    """A tiny-BERT classifier app whose predictor returns f32 logits; its
    artifact is the initial train state."""
    import unionml_tpu_torch as T
    from unionml_tpu_torch.model import ModelArtifact

    dataset = T.Dataset(name="bert_ds", targets=["labels"], device_format="torch", device="cpu")

    @dataset.reader
    def reader(n: int = 8) -> Dict[str, np.ndarray]:
        return bert_batch(n)

    dataset.feature_loader(tokenize)
    model = T.Model(name="bert_app", init=lambda: bert_state(params), dataset=dataset)

    @model.trainer
    def trainer(state, features: torch.Tensor, targets: torch.Tensor):
        return state

    @model.predictor
    def predictor(state, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            return state.model(features["input_ids"], features["attention_mask"])

    @model.evaluator
    def evaluator(state, features: torch.Tensor, targets: torch.Tensor) -> float:
        return 1.0

    model.artifact = ModelArtifact(bert_state(params))
    return model


# ------------------------------------------------------------------ training scenarios


def scenario_dp(rank, ctx):
    """``parallel/dp.py``: the bare-weight step and its eval, and ``batches``
    (16 rows of 50, a ragged 15 wrapped to 16) on ``{"data": world}``."""
    from unionml_tpu_torch.parallel import batches, data_parallel_eval, data_parallel_step, make_mesh

    mesh = make_mesh({"data": ctx.world}, device="cpu")
    w, x, y = dp_data()
    new_w, loss = data_parallel_step(dp_step, mesh, donate_state=False)(torch.from_numpy(w), (x, y))
    evaluated = data_parallel_eval(lambda w_, b: {"loss": torch.mean((b[0] @ w_ - b[1]) ** 2)}, mesh)(
        torch.from_numpy(w), (x, y))
    grid = np.arange(100, dtype=np.float32).reshape(50, 2)
    full = [b.numpy() for b in batches(grid, batch_size=16, mesh=mesh)]
    ragged = [b.numpy() for b in batches(grid, batch_size=15, mesh=mesh, drop_remainder=False)]
    return {"w": new_w.numpy(), "loss": float(loss), "eval_loss": float(evaluated["loss"]), "batches": full,
            "ragged": ragged}


def scenario_mlp_fit(rank, ctx):
    """The digits-like MLP fit on ``{"data": world}``: 3 steps' parameters,
    then ``test_models.py:100``'s 10 epochs and the accuracy."""
    from unionml_tpu_torch.models import MLPClassifier, create_train_state, fit, make_classifier_eval_step
    from unionml_tpu_torch.models.convert import mlp_params_from_jax
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": ctx.world}, device="cpu")
    data = toy_classification_data()

    def state():
        model = MLPClassifier(16, hidden_sizes=(32,), num_classes=4, device="cpu")
        model.load_state_dict(mlp_params_from_jax(ctx.mlp_params))
        return create_train_state(model, learning_rate=1e-2)

    three = fit(state(), data, batch_size=64, num_steps=3, mesh=mesh, log_every=1000).state
    trained = fit(state(), data, batch_size=64, num_epochs=10, mesh=mesh, log_every=1000).state
    metrics = make_classifier_eval_step()(trained, {k: torch.from_numpy(v) for k, v in data.items()})
    return {"three": {n: p.detach().numpy().copy() for n, p in zip(three.names, three.params)},
            "accuracy": float(metrics["accuracy"])}


def _bert_step(ctx, axes, dropout=0.0, grad_accum=1, steps=1):
    from unionml_tpu_torch.models import make_classifier_train_step
    from unionml_tpu_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(axes, device="cpu")
    state = bert_state(ctx.bert_params, dropout)
    step = make_classifier_train_step(mesh=mesh, param_spec=bert_specs(state, mesh), input_signature=SIG,
                                      grad_accum=grad_accum)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(bert_batch(), mesh).items()}
    history = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    return state, history


def scenario_bert_data_tensor(rank, ctx):
    """One tiny-BERT step on ``{"data": 2, "tensor": 2}`` with ``param_shardings``."""
    state, history = _bert_step(ctx, {"data": 2, "tensor": 2})
    full = whole(state)
    return {"metrics": history[0], "params": {n: t.numpy() for n, t in full["params"].items()},
            "local": {n: tuple(p.shape) for n, p in zip(state.names, state.params)},
            "heads": state.model.bert.encoder.layers[0].attention.tp.heads}


def scenario_bert_data_fsdp(rank, ctx):
    """One tiny-BERT step on ``{"data": 2, "fsdp": 2}`` (FSDP2, hybrid over data)."""
    state, history = _bert_step(ctx, {"data": 2, "fsdp": 2})
    full = whole(state)
    return {"metrics": history[0], "params": {n: t.numpy() for n, t in full["params"].items()},
            "local": {n: (tuple(p.shape), tuple(m.shape), tuple(v.shape))
                      for n, p, m, v in zip(state.names, state.params, state.mu, state.nu)},
            "whole_shapes": {n: tuple(t.shape) for n, t in full["params"].items()}}


def scenario_grad_accum(rank, ctx):
    """``grad_accum=2`` against 1 on ``{"data": world}``: this rank's rows split in two."""
    one = _bert_step(ctx, {"data": ctx.world})[1][0]
    two = _bert_step(ctx, {"data": ctx.world}, grad_accum=2)[1][0]
    return {"one": one, "two": two}


def scenario_ragged(rank, ctx):
    """``dict_batches`` of 13 rows in batches of 5 (the tail ragged) on ``{"data": world}``."""
    from unionml_tpu_torch.models import dict_batches
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": ctx.world}, device="cpu")
    data = {"x": np.arange(26, dtype=np.float32).reshape(13, 2), "y": np.arange(13, dtype=np.int32)}
    rng = np.random.default_rng(3)
    return {"batches": [{k: v.numpy() for k, v in b.items()} for b in
                        dict_batches(data, 5, rng=rng, device="cpu", drop_remainder=False, mesh=mesh)]}


def scenario_gpt(rank, ctx):
    """Packed ``fit_lm`` of the tiny GPT on ``{"data": world}`` and on
    ``{"tensor": world}`` with ``param_shardings``: the loss of every step."""
    from unionml_tpu_torch.models import fit_lm, gpt
    from unionml_tpu_torch.parallel import make_mesh

    out = {}
    for axes in ({"data": ctx.world}, {"tensor": ctx.world}):
        mesh = make_mesh(axes, device="cpu")
        state = gpt_state(ctx.gpt_params)
        spec = gpt.param_shardings(dict(state.model.named_parameters()), tuple(axes)) if "tensor" in axes else None
        result = fit_lm(state, lm_corpus(), seq_len=32, batch_size=4, num_steps=3, mesh=mesh, param_spec=spec,
                        log_every=1)
        out["tensor" if "tensor" in axes else "data"] = [h["loss"] for h in result.metrics_history]
        if "tensor" in axes:
            out["heads"] = result.state.model.layers[0].tp.heads
    return out


def scenario_dropout(rank, ctx):
    """Dropout on, one tiny-BERT step on ``{"data": world}`` and on
    ``{"tensor": world}``, with every rank fed the SAME rows: a digest of
    each dropout mask this rank drew."""
    from unionml_tpu_torch.models import bert, make_classifier_train_step
    from unionml_tpu_torch.parallel import make_mesh

    masks = []
    real = bert._dropout

    def recorded(x, rate, generator):
        out = real(x, rate, generator)
        if generator is not None:
            masks.append(hashlib.sha1((out == 0).numpy().tobytes()).hexdigest())
        return out

    bert._dropout = recorded
    out = {}
    try:
        for axes in ({"data": ctx.world}, {"tensor": ctx.world}):
            mesh = make_mesh(axes, device="cpu")
            state = bert_state(ctx.bert_params, dropout=0.1)
            spec = bert_specs(state, mesh) if "tensor" in axes else None
            step = make_classifier_train_step(mesh=mesh, param_spec=spec, input_signature=SIG)
            masks.clear()
            step(state, {k: torch.from_numpy(v) for k, v in bert_batch(4).items()})
            out[next(iter(axes))] = list(masks)
    finally:
        bert._dropout = real
    return out


def scenario_checkpoint(rank, ctx):
    """Under ``{"fsdp": world}``: a fit killed by SIGTERM after its second
    step's checkpoint and resumed, against the same steps uninterrupted
    (bitwise); then a restore into a laid-out target (its layout kept)."""
    from unionml_tpu_torch.checkpoint import Checkpointer
    from unionml_tpu_torch.models import fit, make_classifier_train_step
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"fsdp": ctx.world}, device="cpu")
    data = bert_batch(16, seed=1)
    kwargs = dict(batch_size=8, input_signature=SIG, log_every=100, mesh=mesh)

    def fresh():
        state = bert_state(ctx.bert_params, lr=1e-3)
        return state, bert_specs(state, mesh)

    state, spec = fresh()
    straight = fit(state, data, num_steps=2, param_spec=spec, **kwargs).state
    straight = fit(straight, data, num_steps=2, param_spec=spec, **kwargs).state
    want = whole(straight)

    directory = str(Path(ctx.out_dir) / "ckpt")
    state, spec = fresh()
    inner = make_classifier_train_step(mesh=mesh, param_spec=spec, input_signature=SIG)

    def killed(s, batch):
        if s.step == 2:  # the second step's checkpoint is queued: the SIGTERM flush lands it
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(s, batch)

    try:
        fit(state, data, num_steps=4, step_fn=killed, checkpoint_dir=directory, checkpoint_every=1, **kwargs)
        exit_code = None
    except SystemExit as exc:
        exit_code = exc.code
    dist.barrier()
    probe = Checkpointer(directory)
    latest = probe.latest_step()
    probe.close()
    state, spec = fresh()
    resumed = fit(state, data, num_steps=2, param_spec=spec, checkpoint_dir=directory, checkpoint_every=1,
                  **kwargs)
    got, resumed_step = whole(resumed.state), resumed.state.step
    equal = all(torch.equal(got[g][n], want[g][n]) for g in ("params", "mu", "nu") for n in want["params"])

    # the layout-preserving restore (tests/unit/test_checkpoint.py:59)
    target = resumed.state
    layout = target.layout
    ckpt = Checkpointer(directory)
    restored = ckpt.restore(target, step=2)
    saved = torch.load(Path(directory) / "2" / "state.pt", map_location="cpu", weights_only=True)["state"]
    shards_equal = all(torch.equal(p, layout.shard(i, saved["params"][n]))
                       for i, (n, p) in enumerate(zip(restored.names, restored.params)))
    ckpt.close()
    return {"exit_code": exit_code, "latest": latest, "resumed_steps": resumed.steps,
            "resumed_step": resumed_step, "bitwise": equal, "layout_kept": restored.layout is layout,
            "restored_step": restored.step, "shards_equal": shards_equal}


def scenario_template(rank, ctx):
    """The rendered ``data-parallel`` template trains in this world."""
    import importlib.util
    import sys

    os.environ["UNIONML_DEVICE"] = "cpu"
    spec = importlib.util.spec_from_file_location("dp_template_app", Path(ctx.template_dir) / "app.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["dp_template_app"] = module
    spec.loader.exec_module(module)
    _, metrics = module.model.train(trainer_kwargs={"num_epochs": 5, "batch_size": 1024})
    return {"metrics": metrics}


TRAINING = {
    2: {"dp": scenario_dp, "grad_accum": scenario_grad_accum, "ragged": scenario_ragged, "gpt": scenario_gpt,
        "dropout": scenario_dropout, "checkpoint": scenario_checkpoint, "template": scenario_template},
    4: {"mlp_fit": scenario_mlp_fit, "bert_data_tensor": scenario_bert_data_tensor,
        "bert_data_fsdp": scenario_bert_data_fsdp},
}


# ------------------------------------------------------------------ serving scenarios


def led(rank, predictor, drive):
    """Rank 0 drives ``predictor`` and then releases the followers; the other
    ranks follow until released."""
    if rank == 0:
        try:
            return drive(predictor)
        finally:
            predictor.close()
    return {"followed": predictor.follow()}


def scenario_resident_data(rank, ctx):
    """The mean-embedding predictor on ``{"data": 4}``: buckets the four
    ranks divide (split) and one they do not (whole on every rank)."""
    from unionml_tpu_torch.parallel import make_mesh
    from unionml_tpu_torch.serving import ResidentPredictor

    mesh = make_mesh({"data": 4}, device="cpu")
    out = {}
    for buckets in ((4, 8), (2, 6)):
        predictor = ResidentPredictor(tokenized_app(), buckets=buckets, warmup=False, mesh=mesh, device="cpu")
        out[buckets] = led(rank, predictor, lambda p: [p.predict(features=serve_rows(lens)) for lens in SERVE_LENS])
    return out


def scenario_resident_tensor(rank, ctx):
    """The tiny-BERT logits predictor on ``{"data": 2, "tensor": 2}`` with
    ``param_shardings``; and a tensor spec on the plain predictor."""
    from unionml_tpu_torch.models import bert
    from unionml_tpu_torch.parallel import make_mesh
    from unionml_tpu_torch.parallel.mesh import Spec
    from unionml_tpu_torch.serving import ResidentPredictor

    mesh = make_mesh({"data": 2, "tensor": 2}, device="cpu")
    app = bert_app(ctx.bert_params)
    specs = bert.param_shardings(dict(app.artifact.model_object.model.named_parameters()), ("data", "tensor"))
    predictor = ResidentPredictor(app, buckets=(4, 8), warmup=False, mesh=mesh, param_specs=specs, device="cpu")
    predictor.setup()
    heads = predictor._device_model_object.model.bert.encoder.layers[0].attention.tp.heads
    rows = [[{"input_ids": list(range(1, n + 1))} for n in lens] for lens in ((3, 9, 5), (12, 2, 7, 4, 1))]
    got = led(rank, predictor, lambda p: [p.predict(features=r) for r in rows])
    plain = ResidentPredictor(tokenized_app(), buckets=(4,), warmup=False, mesh=mesh,
                              param_specs={"emb": Spec("tensor")}, device="cpu")
    try:
        plain.setup()
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return {"logits": got, "heads": heads, "refused": refused}


def serve_predict(app, payloads, gap_s=0.0):
    """``/predict`` answers of ``app`` through aiohttp's test client (the
    app's shutdown closes its predictor), ``gap_s`` idle seconds after the
    first request."""
    from aiohttp.test_utils import TestClient, TestServer

    async def main():
        async with TestClient(TestServer(app)) as client:
            out = []
            for i, payload in enumerate(payloads):
                if i == 1:
                    await asyncio.sleep(gap_s)
                resp = await client.post("/predict", json=payload)
                out.append((resp.status, await resp.json()))
            return out

    return asyncio.run(main())


def scenario_serving_app(rank, ctx):
    """``serving_app(mesh=...)``'s ``/predict`` from rank 0 over
    ``{"data": 4}`` (the other ranks follow its predictor)."""
    from unionml_tpu_torch.parallel import make_mesh
    from unionml_tpu_torch.serving import serving_app

    mesh = make_mesh({"data": 4}, device="cpu")
    app = serving_app(tokenized_app(), mesh=mesh, buckets=(4, 8), device="cpu")
    predictor, batcher = app["resident_predictor"], app["request_batcher"]
    multiple = batcher.preferred_multiple
    if rank == 0:
        answers = serve_predict(app, [{"features": serve_rows(lens)} for lens in SERVE_LENS])
        return {"answers": answers, "preferred_multiple": multiple, "released": predictor._lead.stopped}
    return {"followed": predictor.follow(), "preferred_multiple": multiple}


def scenario_idle(rank, ctx):
    """Two ``/predict`` requests ``IDLE_GAP_S`` apart over a predictor whose
    side group times out after ``IDLE_TIMEOUT_S``: the leader's keep-alive
    holds the followers."""
    from unionml_tpu_torch.parallel import distributed, make_mesh
    from unionml_tpu_torch.serving import serving_app

    mesh = make_mesh({"data": 4}, device="cpu")
    saved, distributed._timeout_s = distributed._timeout_s, IDLE_TIMEOUT_S
    try:
        app = serving_app(tokenized_app(), mesh=mesh, buckets=(4, 8), device="cpu")
    finally:
        distributed._timeout_s = saved
    predictor = app["resident_predictor"]
    if rank == 0:
        answers = serve_predict(app, [{"features": serve_rows(lens)} for lens in SERVE_LENS[:2]], IDLE_GAP_S)
        return {"answers": answers, "keepalive_s": predictor._lead.keepalive_s}
    return {"followed": predictor.follow()}


SERVING = {
    4: {"resident_data": scenario_resident_data, "resident_tensor": scenario_resident_tensor,
        "serving_app": scenario_serving_app, "idle": scenario_idle},
}


def rank_main(rank: int, world: int, port: int, scenarios: str, inputs: Dict[str, Any], out_dir: str) -> None:
    torch.set_num_threads(1)
    faulthandler.dump_traceback_later(170, exit=True)  # a hung rank never holds the suite
    from unionml_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"localhost:{port}", world, rank, strict=True, device="cpu", timeout_s=60)
    ctx = SimpleNamespace(world=world, out_dir=out_dir, **inputs)
    table = (TRAINING if scenarios == "training" else SERVING)[world]
    results = {}
    for name, scenario in table.items():
        t0 = time.perf_counter()
        try:
            results[name] = scenario(rank, ctx)
        except BaseException as exc:  # the parent's test of this scenario fails with the traceback
            results[name] = {"error": "".join(traceback.format_exception(exc))}
        results[name]["wall_s"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    dist.destroy_process_group()
