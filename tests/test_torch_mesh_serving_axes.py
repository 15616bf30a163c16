"""Serving the layouts the meshes train: ``DecodeEngine``/``SpeculativeEngine``
over ``fsdp``, ``sequence`` and ``expert`` axes and over ``ep_mesh`` models,
and ``ResidentPredictor``/``serving_app`` over a ``sequence`` axis, on a gloo
world of 2 ranks against the JAX package on meshes over its first 2 CPU
devices and against the port's unmeshed engines and predictors.

One spawn for the module: the ranks (``tests/torch_serve_ranks.py``, which
imports no JAX) run every scenario with rank 0 leading and the other rank
following, one intra-op thread each, while this process computes JAX's
references (its meshed engines' greedy streams, its ``generate`` on the
sparse model, its meshed predictors' logits and the error of a ladder the
axis does not divide). Tolerances: greedy streams identical (f32); the
predictors' f32 logits within ``LOGIT_TOL`` (1e-5) of JAX's and of the
port's dense predictor.
"""

import dataclasses
import multiprocessing
import pickle
import socket
import time
from pathlib import Path
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unionml_tpu as J
from tests import torch_serve_ranks as ranks
from unionml_tpu.model import ModelArtifact as JArtifact
from unionml_tpu.models import bert as jbert
from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models import training as jtraining
from unionml_tpu.parallel import make_mesh as jax_make_mesh
from unionml_tpu.serving.continuous import DecodeEngine as JaxEngine
from unionml_tpu.serving.resident import ResidentPredictor as JResident
from unionml_tpu_torch.models import bert_random_params, random_params

LOGIT_TOL = 1e-5
#: how long the module waits for the world (each rank exits on its own at 170 s)
WAIT_S = 180.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_mesh(**axes):
    return jax_make_mesh(axes, devices=jax.devices()[:2])


def _jax_drain(engine):
    slots = engine.admit_many(ranks.REQUESTS)
    out = {s: [] for s in slots}
    while engine.num_active or engine.has_pending_prefill:
        for ev in engine.step():
            if ev.emit:
                out[ev.slot].append(ev.token)
    return [out[s] for s in slots]


def _jax_gpt(**overrides):
    return jgpt.GPTLMHeadModel(jgpt.GPTConfig.tiny(**{"dropout": 0.0, "dtype": jnp.float32, "attention_impl": "xla",
                                                      **overrides}))


def _jax_streams(model, variables, mesh):
    return _jax_drain(JaxEngine(model, variables, num_slots=4, max_len=64, prefill_buckets=(8, 16), mesh=mesh))


def _jax_generate(model, variables):
    """JAX's greedy ``generate`` of the requests, one left-padded batch."""
    width = max(len(p) for p, _ in ranks.REQUESTS)
    ids = np.zeros((len(ranks.REQUESTS), width), np.int32)
    mask = np.zeros_like(ids)
    for i, (prompt, _) in enumerate(ranks.REQUESTS):
        ids[i, width - len(prompt):], mask[i, width - len(prompt):] = prompt, 1
    new = max(n for _, n in ranks.REQUESTS)
    tokens = np.asarray(jgpt.generate(model, variables, jnp.asarray(ids), new, prompt_mask=jnp.asarray(mask)))
    return [[int(t) for t in tokens[i, width:width + n]] for i, (_, n) in enumerate(ranks.REQUESTS)]


def _jax_app(name, module, variables):
    """JAX's half of ``torch_serve_ranks.app``: the logits of ``module``."""
    dataset = J.Dataset(name=f"{name}_ds", targets=["labels"], device_format="jax")

    @dataset.reader
    def reader(n: int = 4) -> Dict[str, np.ndarray]:
        return ranks.tokenize(ranks.request_rows(n, 0))

    dataset.feature_loader(ranks.tokenize)
    model = J.Model(name=name, init=lambda: None, dataset=dataset)
    is_bert = isinstance(module, jbert.BertForSequenceClassification)

    @model.trainer
    def trainer(state: jtraining.TrainState, features: jax.Array, targets: jax.Array) -> jtraining.TrainState:
        return state

    @model.predictor
    def predictor(state: jtraining.TrainState, features: Dict[str, jax.Array]) -> jax.Array:
        if is_bert:
            return state.apply_fn({"params": state.params}, features["input_ids"], features["attention_mask"],
                                  deterministic=True)
        return state.apply_fn({"params": state.params}, features["input_ids"])

    @model.evaluator
    def evaluator(state: jtraining.TrainState, features: jax.Array, targets: jax.Array) -> float:
        return 1.0

    model.artifact = JArtifact(jtraining.create_train_state(module, variables))
    return model


def _jax_predictors(gpt_params, bert_params):
    mesh = _jax_mesh(sequence=2)
    bert_cfg = jbert.BertConfig.tiny(dtype=jnp.float32, hidden_dropout=0.0)
    modules = {
        "bert_ring": jbert.BertForSequenceClassification(dataclasses.replace(bert_cfg, attention_impl="ring",
                                                                             sp_mesh=mesh)),
        "bert_ulysses": jbert.BertForSequenceClassification(dataclasses.replace(bert_cfg, attention_impl="ulysses",
                                                                                sp_mesh=mesh)),
        "gpt_ring": _jax_gpt(attention_impl="ring", sp_mesh=mesh),
    }
    out = {}
    for name, module in modules.items():
        variables = bert_params if name.startswith("bert") else gpt_params
        predictor = JResident(_jax_app(name, module, variables), buckets=ranks.BUCKETS, seq_buckets=ranks.SEQ_BUCKETS,
                              warmup=False, mesh=mesh)
        out[name] = [np.asarray(predictor.predict(features=rows)) for rows in ranks.ROW_SETS]
    odd = JResident(_jax_app("odd", modules["bert_ring"], bert_params), buckets=ranks.BUCKETS,
                    seq_buckets=ranks.ODD_LADDER, warmup=False, mesh=mesh)
    try:
        odd.predict(features=ranks.ODD_ROWS)
        out["odd_ladder"] = None
    except ValueError as exc:
        out["odd_ladder"] = f"{type(exc).__name__}: {exc}"
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # seeded numpy weights in JAX's layout feed both packages
    inputs = {"gpt_params": random_params(ranks.gpt_config(), seed=0, std=0.2),
              "sparse_params": random_params(ranks.gpt_config(**ranks.SPARSE), seed=0, std=0.2),
              "bert_params": bert_random_params(ranks.bert_config(), seed=0)}
    out_dir = tmp_path_factory.mktemp("serve_axes")
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.rank_main, args=(r, ranks.WORLD, port, inputs, str(out_dir)), daemon=True)
             for r in range(ranks.WORLD)]
    for p in procs:
        p.start()
    # the references, while the world runs
    gpt, sparse = inputs["gpt_params"], inputs["sparse_params"]
    refs = {
        "fsdp": _jax_streams(_jax_gpt(), gpt, _jax_mesh(fsdp=2)),
        "sequence": _jax_streams(_jax_gpt(attention_impl="ring", sp_mesh=_jax_mesh(sequence=2)), gpt,
                                 _jax_mesh(sequence=2)),
        "expert": _jax_streams(_jax_gpt(num_experts=4, moe_every=2, ep_mesh=_jax_mesh(expert=2)), sparse,
                               _jax_mesh(expert=2)),
        "sparse_generate": _jax_generate(_jax_gpt(num_experts=4, moe_every=2), sparse),
        "predictors": _jax_predictors(gpt, inputs["bert_params"]),
    }
    torch.set_num_threads(threads)
    deadline = time.monotonic() + WAIT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
    files = [Path(out_dir, f"rank{r}.pkl") for r in range(ranks.WORLD)]
    refs["ranks"] = [pickle.loads(f.read_bytes()) if f.exists() else None for f in files]
    return refs


def _results(world, name):
    got = world["ranks"]
    assert all(r is not None for r in got), "a rank of the world wrote nothing (hung or crashed)"
    for r, res in enumerate(got):
        assert "error" not in res[name], f"rank {r}, {name}:\n{res[name]['error']}"
    return [res[name] for res in got]


def _followed(results, arm):
    assert all(r[arm]["followed"] > 0 for r in results[1:]), arm


# ------------------------------------------------------------------ decode over fsdp and sequence


@pytest.mark.parametrize("arm", ["paged", "dense", "int8", "speculative"])
def test_fsdp_streams_match_jax_and_unmeshed(world, arm):
    """``DecodeEngine(mesh={"fsdp": 2})`` paged and ``paged=False`` stream
    JAX's ``DecodeEngine(mesh=make_mesh({"fsdp": 2}))`` tokens and the
    port's unmeshed engine's; int8 weights under the split stream the
    unmeshed int8 engine's; greedy speculation over the split streams
    plain decoding."""
    got = _results(world, "fsdp")
    _followed(got, arm)
    mine = got[0][arm]
    if arm == "int8":
        assert mine == got[0]["unmeshed_int8"]
        return
    assert mine == world["fsdp"] == got[0]["unmeshed"]
    if arm == "speculative":
        assert got[0]["rounds"] > 0


def test_fsdp_ranks_hold_half_of_the_split_leaves(world):
    """Each rank keeps at rest half the bytes of every leaf ``param_shardings``
    splits over ``fsdp`` (its contiguous half of the leaf's storage), also
    as int8 codes, and the blocks share one whole buffer per shape: no rank
    replicates the decoder blocks."""
    for rank, r in enumerate(_results(world, "fsdp")):
        assert r["split"] == 8 and r["pieces"], rank
        assert 2 * r["at_rest_bytes"] == r["whole_bytes"], rank
        assert 4 * r["int8_at_rest"] < r["whole_bytes"], rank
        assert r["shared_buffers"] == 1, rank


@pytest.mark.parametrize("arm", ["paged", "dense"])
def test_sequence_axis_decodes_through_the_dense_fallback(world, arm):
    """The ring config over ``{"sequence": 2}`` (its ``sp_mesh``): every rank
    serves the model as it is, and the streams are JAX's meshed engine's
    and the dense config's unmeshed ones."""
    got = _results(world, "sequence")
    _followed(got, arm)
    assert all(r["same_model"] for r in got)
    assert got[0][arm] == world["sequence"] == got[0]["unmeshed"]


# ------------------------------------------------------------------ decode over an expert axis


@pytest.mark.parametrize("arm", ["ep_mesh", "cut"])
def test_expert_axis_streams_match_jax(world, arm):
    """The sparse GPT over ``{"expert": 2}``, built with ``ep_mesh`` (each
    rank holds two of the four experts) or whole (the serving mesh cuts each
    rank's two): the dropless blocks sum their experts' outputs over the
    axis, and the streams are JAX's meshed engine's, JAX's ``generate`` and
    the port's unmeshed engine's."""
    got = _results(world, "expert")
    _followed(got, arm)
    assert all(r["ep_local"] == r["cut_local"] == 2 and r["cut_share"] for r in got)
    assert got[0][arm] == world["expert"] == world["sparse_generate"] == got[0]["unmeshed"]


def test_trained_expert_state_serves_its_checkpoint_tokens(world):
    """A state trained two steps by ``fit_lm(mesh={"expert": 2})``, served
    through ``Layout.whole_model`` (each rank keeps its experts), streams
    the unmeshed engine's tokens on the gathered checkpoint; training moved
    them off the initial weights' streams."""
    got = _results(world, "expert")
    _followed(got, "trained")
    assert all(r["trained_local"] == 2 for r in got)
    assert got[0]["trained"] == got[0]["checkpoint"] != got[0]["unmeshed"]


# ------------------------------------------------------------------ the predictor over a sequence axis


@pytest.mark.parametrize("name", ["bert_ring", "bert_ulysses", "gpt_ring"])
def test_sequence_predictor_logits_match_jax(world, name):
    """``ResidentPredictor(mesh={"sequence": 2})`` keeps the ring or Ulysses
    model and cuts each request into the ranks' chunks (BERT's ``[CLS]``
    read on every rank, the GPT's per-chunk logits gathered into whole
    rows): rank 0's logits within 1e-5 of JAX's predictor over the same
    ``sp_mesh`` and of the port's dense predictor, at both ladder rungs."""
    got = _results(world, "resident")
    _followed(got, name)
    assert all(r[f"{name}_kept"] == name.split("_")[1] for r in got)
    for mine, dense, theirs in zip(got[0][name], got[0][f"{name}_dense"], world["predictors"][name]):
        assert mine.shape == dense.shape == theirs.shape
        np.testing.assert_allclose(mine, theirs, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(mine, dense, atol=LOGIT_TOL, rtol=0)


def test_a_ladder_the_sequence_axis_does_not_divide_raises_jax_error(world):
    """A rung of 7 over a sequence axis of 2 raises ``ValueError`` on every
    rank, as JAX's ``shard_map`` does: the padded sequence is not evenly
    divisible by the mesh axis. (JAX's predictor then retries the unpadded
    request eagerly, which raises too at the rows' odd length of 5; the
    port raises at once, its ranks' chunks being cut from the padded
    request.)"""
    got = _results(world, "resident")
    phrase = "not evenly divisible by the corresponding mesh axis sizes"
    assert world["predictors"]["odd_ladder"].startswith("ValueError") and phrase in world["predictors"]["odd_ladder"]
    assert got[0]["odd_ladder"].startswith("ValueError") and phrase in got[0]["odd_ladder"]
    assert got[1]["odd_ladder"] == {"followed": 1}


def test_serving_app_predicts_over_the_sequence_axis(world):
    """``serving_app(mesh={"sequence": 2})``'s ``/predict`` answers from rank
    0 with the follower running the ring BERT, the predictor's logits, and
    the app's shutdown releases the follower."""
    got = _results(world, "resident")
    assert got[0]["released"] and got[1]["app"]["followed"] == len(ranks.ROW_SETS)
    for (status, body), theirs in zip(got[0]["app"], world["predictors"]["bert_ring"]):
        assert status == 200
        np.testing.assert_allclose(np.asarray(body, dtype=np.float32), theirs, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("tokens", [4, 37])
def test_in_process_expert_split_matches_jax_dropless(tokens):
    """``chip_smoke.py`` phase 26's seam, ``_in_process_dropless``: four
    shares of two of eight experts, each share's dropless partial over every
    token summed in f32, against JAX's ``moe_apply_topk(capacity_factor=None)``
    (f32, 2e-5) and bitwise against the port's whole dropless layer (a
    token's at most two nonzero partials add exactly)."""
    from unionml_tpu.parallel import ep as jep
    from unionml_tpu_torch.parallel.ep import _in_process_dropless, moe_apply_topk

    rng = np.random.default_rng(tokens)
    w = (rng.normal(size=(8, 16, 12)) * 0.3).astype(np.float32)
    x = rng.normal(size=(tokens, 16)).astype(np.float32)
    logits = rng.normal(size=(tokens, 8)).astype(np.float32)
    want = np.asarray(jep.moe_apply_topk(lambda p, t: t @ p, jnp.asarray(w), jnp.asarray(x),
                                         jax.nn.softmax(jnp.asarray(logits), axis=-1), None, k=2,
                                         capacity_factor=None, normalize_gates=True))
    gates = torch.softmax(torch.from_numpy(logits), dim=-1)
    bmm = lambda p, t: torch.bmm(t, p)  # noqa: E731
    got = _in_process_dropless(bmm, torch.from_numpy(w), torch.from_numpy(x), gates, 4, k=2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    whole = moe_apply_topk(bmm, torch.from_numpy(w), torch.from_numpy(x), gates, k=2, capacity_factor=None)
    assert torch.equal(got, whole)
