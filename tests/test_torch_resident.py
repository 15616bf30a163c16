"""The port's ``ResidentPredictor`` and ``RequestBatcher`` against the JAX package's.

Both predictors serve the same apps (a tokenized mean-embedding model and the
tiny f32 BERT app, weights carried across) under the same batch and sequence
buckets; on the CPU the port pads exactly as on the card and runs the
predictor eagerly. Padded shapes and padded values must be identical; the
mean-embedding outputs agree within 1e-6 (float32, one sum and a division)
and the BERT logits within 1e-5 (one forward). The batcher is a copy: every
scenario runs against both modules and must give the same results.
"""

import asyncio
import threading
import time
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import unionml_tpu as J
import unionml_tpu_torch as T
from unionml_tpu.model import ModelArtifact as JArtifact
from unionml_tpu.serving import batcher as jbatcher
from unionml_tpu.serving.resident import ResidentPredictor as JResident
from unionml_tpu.serving.resident import _ladder_value as j_ladder
from unionml_tpu_torch.model import ModelArtifact as TArtifact
from unionml_tpu_torch.serving import batcher as tbatcher
from unionml_tpu_torch.serving.resident import ResidentPredictor as TResident
from unionml_tpu_torch.serving.resident import _ladder_value as t_ladder

from unionml_tpu_torch.parallel import make_mesh

from tests.torch_sharded_ranks import fake_world
from tests.test_torch_model import bert_weights, jax_bert_app, port_bert_app, request_rows  # noqa: F401 (fixture)

EMB_TOL, LOGIT_TOL = 1e-6, 1e-5


def _lens_loader(raw: Any) -> Dict[str, np.ndarray]:
    """Each row dict {"len": L} becomes ids 1..L, right-padded to the longest."""
    if isinstance(raw, dict):
        return raw
    lens = [int(r["len"]) for r in raw]
    ids = np.zeros((len(lens), max(lens)), dtype=np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = np.arange(1, n + 1)
        mask[i, :n] = 1
    return {"input_ids": ids, "attention_mask": mask}


def _reader(n: int = 8) -> pd.DataFrame:
    return pd.DataFrame({"text_len": np.arange(1, n + 1), "y": np.arange(n) % 2})


def tokenized_models():
    """The same mean-embedding app in both packages (``test_resident.py``'s)."""
    emb = np.random.default_rng(0).normal(size=64).astype(np.float32)

    jds = J.Dataset(name="tok_ds", targets=["y"], device_format="jax")
    jds.reader(_reader)
    jds.feature_loader(_lens_loader)
    jmodel = J.Model(name="tok_model", init=lambda: {"emb": jnp.asarray(emb)}, dataset=jds)

    @jmodel.trainer
    def jtrainer(p: dict, X: jax.Array, y: jax.Array) -> dict:
        return p

    @jmodel.predictor
    def jpredictor(p: dict, features: Dict[str, jax.Array]) -> jax.Array:
        mask = features["attention_mask"].astype(jnp.float32)
        e = p["emb"][jnp.clip(features["input_ids"], 0, 63)] * mask
        return jnp.sum(e, axis=1) / jnp.maximum(jnp.sum(mask, axis=1), 1.0)

    @jmodel.evaluator
    def jevaluator(p: dict, X: jax.Array, y: jax.Array) -> float:
        return 1.0

    tds = T.Dataset(name="tok_ds", targets=["y"], device_format="torch", device="cpu")
    tds.reader(_reader)
    tds.feature_loader(_lens_loader)
    tmodel = T.Model(name="tok_model", init=lambda: {"emb": torch.from_numpy(emb)}, dataset=tds)

    @tmodel.trainer
    def ttrainer(p: dict, X: torch.Tensor, y: torch.Tensor) -> dict:
        return p

    @tmodel.predictor
    def tpredictor(p: dict, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        mask = features["attention_mask"].float()
        e = p["emb"][features["input_ids"].clamp(0, 63).long()] * mask
        return e.sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)

    @tmodel.evaluator
    def tevaluator(p: dict, X: torch.Tensor, y: torch.Tensor) -> float:
        return 1.0

    jmodel.artifact = JArtifact({"emb": jnp.asarray(emb)})
    tmodel.artifact = TArtifact({"emb": torch.from_numpy(emb)})
    return jmodel, tmodel


def _predictors(buckets, seq_buckets=None, **kwargs):
    jmodel, tmodel = tokenized_models()
    j = JResident(jmodel, buckets=buckets, seq_buckets=seq_buckets, **kwargs)
    t = TResident(tmodel, buckets=buckets, seq_buckets=seq_buckets, device="cpu", **kwargs)
    j.setup()
    t.setup()
    return j, t


@pytest.mark.parametrize("ladder,n", [((1, 2, 4, 8), 3), ((1, 2, 4, 8), 8), ((1, 2, 4, 8), 9), ((128, 256), 37),
                                      ((32, 64, 128), 129), ((1,), 5)])
def test_ladder_value_matches(ladder, n):
    assert t_ladder(ladder, n) == j_ladder(ladder, n)


@pytest.mark.parametrize("buckets,seq_buckets,lens", [
    ((4, 8), None, [3, 5]),
    ((4,), (16, 32), [3, 7]),
    ((4,), (16, 32), [11, 2, 30]),
    ((1, 2, 4, 8), (8, 16), [5]),
    ((2,), (4,), [1, 2, 3, 9, 2]),  # oversize batch and sequence round up to multiples of the largest rung
], ids=["batch", "seq16", "seq32", "single", "oversize"])
def test_padded_shapes_values_and_outputs_match(buckets, seq_buckets, lens):
    j, t = _predictors(buckets, seq_buckets, warmup=False)
    rows = [{"len": n} for n in lens]
    jpad, jn, jb = j._pad_to_buckets(j._model.dataset.get_features(rows))
    tpad, tn, tb = t._pad_to_buckets(t._model.dataset.get_features(rows))
    assert (tn, tb) == (jn, jb)
    assert tpad.keys() == jpad.keys()
    for key in jpad:
        assert tuple(tpad[key].shape) == tuple(jpad[key].shape)
        assert np.array_equal(tpad[key].numpy(), np.asarray(jpad[key]))
    want, got = np.asarray(j.predict(features=rows)), t.predict(features=rows)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (len(lens),)
    np.testing.assert_allclose(got, want, atol=EMB_TOL)


def test_flat_integer_matrix_keeps_its_width():
    j, t = _predictors((4,), (64,), warmup=False)
    flat = np.ones((2, 10), dtype=np.int32)  # a single array, not a dict: never sequence-padded
    (jp, _, _), (tp, _, _) = j._pad_to_buckets(flat), t._pad_to_buckets(flat)
    assert tuple(tp.shape) == tuple(jp.shape) == (4, 10)


def test_rank3_float_leaf_pads_sequence_dim():
    j, t = _predictors((2,), (16,), warmup=False)
    feats = {"embeddings": np.ones((2, 5, 4), np.float32), "dense": np.ones((2, 7), np.float32)}
    (jp, _, _), (tp, _, _) = j._pad_to_buckets(feats), t._pad_to_buckets(feats)
    for key in feats:
        assert tuple(tp[key].shape) == tuple(jp[key].shape)
    assert tuple(tp["embeddings"].shape) == (2, 16, 4) and tuple(tp["dense"].shape) == (2, 7)


def test_warmup_example_resizes_to_smallest_bucket():
    j, t = _predictors((1, 2, 4, 8), (16,), warmup=False, example_features=[{"len": 3}] * 8)
    jex, tex = j._example_processed(1), t._example_processed(1)
    assert {k: tuple(v.shape) for k, v in tex.items()} == {k: tuple(v.shape) for k, v in jex.items()} == {
        "input_ids": (1, 16), "attention_mask": (1, 16)}


def test_device_stats_exclude_first_calls():
    j, t = _predictors((4, 8), warmup=False)
    assert t.device_stats() == j.device_stats() == {"count": 0}
    for _ in range(5):
        j.predict(features=[{"len": 3}])
        t.predict(features=[{"len": 3}])
    t.predict(features=[{"len": 3}] * 5)  # a new shape: its first call is not recorded either
    assert j.device_stats()["count"] == 4 and t.device_stats()["count"] == 4
    assert 0 < t.device_stats()["device_p50_ms"] <= t.device_stats()["device_p99_ms"]


def test_setup_races_run_setup_exactly_once(monkeypatch):
    """Eight first requests race into a cold predictor: exactly one places and
    warms the artifact (the ``_setup_lock`` double-check); all get answers."""
    _, tmodel = tokenized_models()
    resident = TResident(tmodel, buckets=(4,), warmup=True, example_features=[{"len": 2}], device="cpu")
    warms: List[int] = []
    real_warm = TResident._warm

    def counting_warm(self):
        warms.append(threading.get_ident())
        time.sleep(0.05)  # widen the race window
        real_warm(self)

    monkeypatch.setattr(TResident, "_warm", counting_warm)
    barrier, results, errors = threading.Barrier(8), [], []

    def first_request():
        try:
            barrier.wait(timeout=30)
            results.append(resident.predict(features=[{"len": 3}]))
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=first_request) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(warms) == 1 and len(results) == 8
    assert all(np.allclose(r, results[0]) for r in results)


def test_opaque_model_serves_through_model_predict():
    from sklearn.linear_model import LogisticRegression

    from tests.test_torch_model import sklearn_app

    app = sklearn_app(T)
    app.train(hyperparameters={"max_iter": 100})
    resident = TResident(app, buckets=(4,), device="cpu")
    rows = [{"x1": 0.0, "x2": 1.0}, {"x1": 2.0, "x2": -1.0}]
    assert resident.predict(features=rows) == app.predict(features=rows)
    assert not resident.uses_graphs and resident.eager_fallbacks == 0
    assert isinstance(app.artifact.model_object, LogisticRegression)


@pytest.mark.parametrize("n_rows,seed", [(1, 0), (3, 1), (7, 2)])
def test_bert_app_resident_logits_match(bert_weights, n_rows, seed):  # noqa: F811 (fixture)
    cfg, variables, params = bert_weights
    japp, tapp = jax_bert_app(cfg, variables), port_bert_app(params)
    japp.train()
    tapp.train()
    j = JResident(japp, buckets=(1, 2, 4, 8), seq_buckets=(8, 16), warmup=False)
    t = TResident(tapp, buckets=(1, 2, 4, 8), seq_buckets=(8, 16), warmup=False, device="cpu")
    rows = request_rows(n_rows, seed)
    want, got = np.asarray(j.predict(features=rows)), t.predict(features=rows)
    assert got.shape == want.shape == (n_rows, 2)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_resident_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device is valid here")
    _, tmodel = tokenized_models()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TResident(tmodel)
    # the mesh-resident predictor is ported (tests/test_torch_mesh_serving.py): a
    # mesh of one rank predicts as no mesh; param_specs lay parameters out on a mesh
    with pytest.raises(ValueError, match="pass the mesh too"):
        TResident(tmodel, param_specs={"emb": None}, device="cpu")
    rows = [{"len": 3}, {"len": 5}]
    with fake_world(1):
        meshed = TResident(tmodel, buckets=(2, 4), warmup=False, mesh=make_mesh({"data": 1}, device="cpu"),
                           device="cpu")
        got = meshed.predict(features=rows)
    want = TResident(tmodel, buckets=(2, 4), warmup=False, device="cpu").predict(features=rows)
    assert np.array_equal(got, want)


# ------------------------------------------------------------------ RequestBatcher (a copy; both modules)


BATCHERS = pytest.mark.parametrize("mod", [jbatcher, tbatcher], ids=["jax", "port"])


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@BATCHERS
def test_concurrent_requests_share_batches(mod):
    calls = []

    def predict_rows(rows):
        calls.append(len(rows))
        time.sleep(0.01)
        return [r * 10 for r in rows]

    async def scenario():
        batcher = mod.RequestBatcher(predict_rows, max_batch=64, max_wait_ms=20)
        results = await asyncio.gather(*[batcher.submit([i, i + 100]) for i in range(8)])
        batcher.close()
        return results

    assert _run(scenario()) == [[i * 10, (i + 100) * 10] for i in range(8)]
    assert sum(calls) == 16 and len(calls) < 8


@BATCHERS
def test_max_batch_bounds_flush_size(mod):
    calls = []

    async def scenario():
        batcher = mod.RequestBatcher(lambda rows: calls.append(len(rows)) or rows, max_batch=4, max_wait_ms=50)
        results = await asyncio.gather(*[batcher.submit([i, i]) for i in range(6)])
        batcher.close()
        return results

    results = _run(scenario())
    assert [r for pair in results for r in pair] == [i for i in range(6) for _ in range(2)]
    assert max(calls) <= 5


@BATCHERS
@pytest.mark.parametrize("predict,error,match", [
    (lambda rows: rows[:-1], ValueError, "one result per row"),
    (lambda rows: {"a": 1, "b": 2, "c": 3}, ValueError, "mapping"),
    (lambda rows: (_ for _ in ()).throw(RuntimeError("kaput")), RuntimeError, "kaput"),
], ids=["count", "mapping", "exception"])
def test_failures_reach_the_request(mod, predict, error, match):
    async def scenario():
        batcher = mod.RequestBatcher(predict, max_batch=8, max_wait_ms=1)
        with pytest.raises(error, match=match):
            await batcher.submit([1, 2, 3])
        batcher.close()

    _run(scenario())


@BATCHERS
def test_stats_and_numpy_rows(mod):
    async def scenario():
        batcher = mod.RequestBatcher(lambda rows: np.asarray(rows) * 2, max_batch=64, max_wait_ms=5)
        results = await asyncio.gather(*[batcher.submit([1, 2]) for _ in range(4)])
        stats = dict(batcher.stats)
        batcher.close()
        return results, stats

    results, stats = _run(scenario())
    assert [list(map(int, r)) for r in results] == [[2, 4]] * 4
    assert stats["requests"] == 4 and stats["rows"] == 8 and 1 <= stats["batches"] <= 4


@BATCHERS
def test_dataframe_output_splits_by_rows(mod):
    async def scenario():
        batcher = mod.RequestBatcher(
            lambda rows: pd.DataFrame({"prob": [0.5] * len(rows), "label": list(range(len(rows)))}),
            max_batch=8, max_wait_ms=10)
        out = await asyncio.gather(batcher.submit([1]), batcher.submit([2]))
        batcher.close()
        return out

    assert _run(scenario()) == [[{"prob": 0.5, "label": 0}], [{"prob": 0.5, "label": 1}]]


@BATCHERS
def test_close_fails_queued_requests_instead_of_hanging(mod):
    started, release = threading.Event(), threading.Event()

    def slow_predict(rows):
        started.set()
        release.wait(5)
        return rows

    async def scenario():
        batcher = mod.RequestBatcher(slow_predict, max_batch=1, max_wait_ms=1)
        first = asyncio.create_task(batcher.submit([1]))
        await asyncio.get_running_loop().run_in_executor(None, started.wait, 5)
        second = asyncio.create_task(batcher.submit([2]))
        await asyncio.sleep(0.05)
        batcher.close()
        release.set()
        return await asyncio.gather(first, second, return_exceptions=True)

    first, second = _run(scenario())
    assert isinstance(second, Exception) or second == [2]
    assert not isinstance(first, asyncio.CancelledError)


@BATCHERS
def test_adaptive_wait(mod):
    batcher = mod.RequestBatcher(lambda rows: rows, max_batch=8, max_wait_ms=2.0, adaptive=True)
    assert batcher._effective_wait_s() == batcher.max_wait_s
    batcher._ema_gap_s = 0.5
    assert batcher._effective_wait_s() == 0.0
    batcher._ema_gap_s = 0.0005
    assert batcher._effective_wait_s() == batcher.max_wait_s


@BATCHERS
def test_burst_after_idle_still_coalesces(mod):
    calls = []

    async def scenario():
        batcher = mod.RequestBatcher(lambda rows: calls.append(len(rows)) or [r * 2 for r in rows], max_batch=16,
                                     max_wait_ms=2.0, adaptive=True)
        batcher._ema_gap_s = 10.0
        batcher._ensure_worker()
        futures = [asyncio.ensure_future(batcher.submit([i])) for i in range(6)]
        await asyncio.sleep(0)
        results = await asyncio.gather(*futures)
        batcher.close()
        return results

    assert [r[0] for r in asyncio.run(scenario())] == [0, 2, 4, 6, 8, 10]
    assert max(calls) > 1
