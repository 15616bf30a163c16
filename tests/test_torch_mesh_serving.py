"""The meshed predictor (``ResidentPredictor(mesh=...)``, ``serving_app(mesh=...)``)
on a gloo world of 4 ranks against the JAX package's mesh predictor and the
port's unmeshed one.

One spawn for the module: the ranks (``tests/torch_sharded_ranks.py``, which
imports no JAX) run every scenario with rank 0 predicting and the others
following, one intra-op thread each, while this process computes the
references. Tolerances: the mean-embedding predictor's outputs are bitwise
the unmeshed port's and within 1e-5 of JAX's (``tests/test_torch_resident.py``'s
``LOGIT_TOL``); the tiny BERT's logits under a tensor split within 1e-5 of
the unmeshed port's (f32, a row-parallel sum in another order).
"""

import multiprocessing
import pickle
import socket
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests import torch_sharded_ranks as ranks
from tests.test_torch_resident import LOGIT_TOL, tokenized_models
from unionml_tpu.parallel import make_mesh as jax_make_mesh
from unionml_tpu.serving.resident import ResidentPredictor as JResident
from unionml_tpu_torch.models import bert_random_params
from unionml_tpu_torch.serving import ResidentPredictor

WORLD = 4
#: how long the module waits for the world (each rank exits on its own at 170 s)
WAIT_S = 180.0
BERT_ROWS = [[{"input_ids": list(range(1, n + 1))} for n in lens] for lens in ((3, 9, 5), (12, 2, 7, 4, 1))]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    params = bert_random_params(ranks.bert_config(), seed=0)
    out_dir = tmp_path_factory.mktemp("serve4")
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.rank_main, args=(r, WORLD, port, "serving", {"bert_params": params},
                                                       str(out_dir)), daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    # the references, while the world runs
    jmodel, _ = tokenized_models()
    refs = {"port": {}}
    # a request's predictions do not depend on its bucket: one JAX ladder serves both arms
    jax_pred = JResident(jmodel, buckets=(4, 8), warmup=False, mesh=jax_make_mesh({"data": 4}, devices=jax.devices()[:4]))
    refs["jax"] = [np.asarray(jax_pred.predict(features=ranks.serve_rows(lens))) for lens in ranks.SERVE_LENS]
    for buckets in ((4, 8), (2, 6)):
        port_pred = ResidentPredictor(ranks.tokenized_app(), buckets=buckets, warmup=False, device="cpu")
        refs["port"][buckets] = [port_pred.predict(features=ranks.serve_rows(lens)) for lens in ranks.SERVE_LENS]
    bert = ResidentPredictor(ranks.bert_app(params), buckets=(4, 8), warmup=False, device="cpu")
    refs["bert"] = [bert.predict(features=rows) for rows in BERT_ROWS]
    torch.set_num_threads(threads)
    deadline = time.monotonic() + WAIT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
    files = [Path(out_dir, f"rank{r}.pkl") for r in range(WORLD)]
    refs["ranks"] = [pickle.loads(f.read_bytes()) if f.exists() else None for f in files]
    return refs


def _results(world, name):
    got = world["ranks"]
    assert all(r is not None for r in got), "a rank of the world wrote nothing (hung or crashed)"
    for r, res in enumerate(got):
        assert "error" not in res[name], f"rank {r}, {name}:\n{res[name]['error']}"
    return [res[name] for res in got]


@pytest.mark.parametrize("buckets", [(4, 8), (2, 6)], ids=["split", "whole"])
def test_data_mesh_predictions_equal_unmeshed_and_jax(world, buckets):
    """``test_resident.py:242`` on {"data": 4}: buckets the ranks divide are
    split over them and gathered back, the others run whole on every rank;
    either way rank 0's predictions are the unmeshed predictor's, bit for
    bit, and JAX's mesh predictor's."""
    got = _results(world, "resident_data")
    assert all(r[buckets] == {"followed": len(ranks.SERVE_LENS)} for r in got[1:])
    for mine, plain, theirs in zip(got[0][buckets], world["port"][buckets], world["jax"]):
        assert np.array_equal(mine, plain)
        np.testing.assert_allclose(mine, theirs, atol=LOGIT_TOL)


def test_tensor_split_bert_logits_match_unmeshed(world):
    """The tiny BERT on {"data": 2, "tensor": 2} with ``param_shardings``:
    each rank holds two of the four heads, and rank 0's logits are the
    unmeshed predictor's within f32 tolerance."""
    got = _results(world, "resident_tensor")
    assert all(r["heads"] == 2 for r in got)
    for mine, want in zip(got[0]["logits"], world["bert"]):
        np.testing.assert_allclose(mine, want, atol=1e-5)


def test_tensor_spec_on_a_plain_predictor_raises(world):
    """Eager PyTorch cannot split an arbitrary callable: a spec naming
    ``tensor`` for a model object that is not BERT or GPT raises ValueError
    on every rank, saying why (replicated serving works for any predictor)."""
    for r in _results(world, "resident_tensor"):
        assert r["refused"] is not None and "cannot split an arbitrary callable" in r["refused"]


def test_serving_app_predicts_from_rank_zero_with_followers(world):
    """``serving_app(mesh=...)``'s ``/predict`` on rank 0 while the other ranks
    follow its predictor; the coalescing batcher prefers multiples of the
    four batch ranks, and the app's shutdown releases the followers."""
    got = _results(world, "serving_app")
    assert all(r["preferred_multiple"] == 4 for r in got)
    assert got[0]["released"] and all(r["followed"] >= len(ranks.SERVE_LENS) for r in got[1:])
    for (status, body), want in zip(got[0]["answers"], world["port"][(4, 8)]):
        assert status == 200
        np.testing.assert_array_equal(np.asarray(body, dtype=np.float32), want)


def test_idle_gap_longer_than_the_side_groups_timeout(world):
    """Two requests further apart than the side group's timeout: the leader's
    keep-alive holds the followers, and both answers arrive."""
    got = _results(world, "idle")
    assert got[0]["keepalive_s"] == ranks.IDLE_TIMEOUT_S / 4
    assert [status for status, _ in got[0]["answers"]] == [200, 200]
    assert all(r["followed"] == 2 for r in got[1:])
