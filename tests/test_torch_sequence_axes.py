"""The sequence axis beside ``tensor``, ``fsdp`` and sparse blocks: ring and
Ulysses training of the tiny GPT and BERT over ``{"sequence": 2, "tensor":
2}`` and ``{"fsdp": 2, "sequence": 2}``, the sparse GPT routed over the
sequence chunks of ``{"data": 2, "sequence": 2}`` and ``{"sequence": 2}``,
``ResidentPredictor`` and ``DecodeEngine`` over ``{"sequence": 2, "tensor":
2}`` and the sharded checkpoint there, on gloo worlds of 4 and 2 ranks
against the JAX package on its 8-device CPU mesh.

One spawn per world for the module: the ranks (``tests/torch_sp_axes_ranks.py``,
which imports no JAX) run every scenario with one intra-op thread each,
while this process computes the JAX references (jitted) on the same
composed meshes, the parameters laid out by ``param_shardings``. Seeded
numpy weights in JAX's layout feed both packages. Tolerances (f32), those
of ``tests/test_torch_sequence_parallel.py`` and ``test_torch_expert_parallel.py``:

- logits 2e-4, each rank's loss 1e-5, gradients 5e-4 (dense GPT and BERT);
- ``fit_lm``: each logged loss 1e-5, the parameters after within 1e-4 of
  each leaf's largest magnitude (a 1-D leaf also within 1e-3 of the steps'
  summed learning rate; the key third of the qkv bias, whose true gradient
  is 0, within 2.5 learning rates a step);
- the sparse GPT (capacity 1.0, router losses on): the logged losses 1e-5,
  the first batch's gradients within 1e-4 of each leaf's largest magnitude,
  and the kept choices of every layer exactly those of the unmeshed model
  on the whole batch (JAX's global choice-major order);
- the predictors' logits 1e-5 of JAX's on the same mesh, greedy streams
  identical, the resumed checkpoint bitwise.
"""

import multiprocessing
import pickle
import socket
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding

from tests import torch_sp_axes_ranks as ranks
from tests import torch_sp_ranks as sp_ranks
from tests.test_torch_sequence_parallel import _close_params, _close_trees, _leaves
from unionml_tpu.models import bert as jbert
from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models import moe as jmoe
from unionml_tpu.models import training as jtraining
from unionml_tpu.ops.losses import cross_entropy_with_integer_labels as jax_cross_entropy
from unionml_tpu.parallel import make_mesh as jax_make_mesh
from unionml_tpu_torch.models import (
    BertConfig,
    GPTConfig,
    bert_grads_to_jax,
    bert_random_params,
    gpt_grads_to_jax,
    params_from_jax,
    random_params,
)
from unionml_tpu_torch.parallel.ep import topk_route

WORLDS = (4, 2)
#: how long the module waits for a world (each rank exits on its own at 170 s)
WAIT_S = 180.0
IMPLS = ranks.IMPLS
AXES = [str(axes) for axes in ranks.AXES]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


def _laid_out(params, mesh, shardings):
    """``params`` placed on ``mesh`` by the family's ``param_shardings``."""
    spec = shardings(params, mesh.axis_names)
    return jax.tree_util.tree_map(lambda x, s: jax.device_put(x, JaxNamedSharding(mesh, s)), params, spec)


def _jax_gpt(params, axes, impl, **overrides):
    """JAX's 1-layer tiny GPT at ``impl`` over ``axes``, its parameters laid
    out by ``param_shardings``: logits, loss and gradients of ``lm_loss`` on
    ``gpt_ids``."""
    mesh = _jax_mesh(axes)
    cfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, num_layers=1, attention_impl=impl, sp_mesh=mesh,
                              **overrides)
    model = jgpt.GPTLMHeadModel(cfg)
    ids = jnp.asarray(sp_ranks.gpt_ids())

    def fn(p):
        logits = model.apply({"params": p}, ids)
        return jgpt.lm_loss(logits, ids), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        _laid_out(params["params"], mesh, jgpt.param_shardings))
    return {"logits": np.asarray(logits), "loss": float(loss), "grads": _host(grads)}


def _jax_fit_lm(params, axes, impl):
    """JAX's ``fit_lm(pack=False)`` of the tiny GPT at ``impl`` on ``axes``."""
    mesh = _jax_mesh(axes)
    cfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, num_layers=1, attention_impl=impl, sp_mesh=mesh)
    state = jtraining.create_train_state(jgpt.GPTLMHeadModel(cfg), params, learning_rate=sp_ranks.LR)
    result = jtraining.fit_lm(state, sp_ranks.lm_corpus(), seq_len=sp_ranks.GPT_SEQ, batch_size=sp_ranks.GPT_ROWS,
                              pack=False, num_steps=sp_ranks.FIT_STEPS, mesh=mesh, log_every=1)
    whole = {n: t.numpy() for n, t in params_from_jax(_host(result.state.params)).items()}
    return {"losses": [h["loss"] for h in result.metrics_history], "params": whole}


def _jax_bert(variables, impl):
    """JAX's tiny BERT at ``impl`` over ``{"sequence": 2, "tensor": 2}``
    (``param_shardings``): logits, loss and gradients on ``bert_batch``."""
    mesh = _jax_mesh(ranks.ST)
    cfg = jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl=impl, hidden_dropout=0.0, sp_mesh=mesh)
    model = jbert.BertForSequenceClassification(cfg)
    batch = {k: jnp.asarray(v) for k, v in sp_ranks.bert_batch().items()}

    def fn(p):
        logits = model.apply({"params": p}, batch["input_ids"], batch["attention_mask"], deterministic=True)
        return jax_cross_entropy(logits, batch["labels"]), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        _laid_out(variables["params"], mesh, jbert.param_shardings))
    return {"logits": np.asarray(logits), "loss": float(loss), "grads": _host(grads)}


def _jax_sparse(params):
    """JAX's sparse ring GPT (``moe_aux``) on ``{"data": 2, "sequence": 2}``:
    ``fit_lm(pack=False)``'s losses and parameters, and the unmeshed
    gradients of the first batch's loss plus router losses."""
    mesh = _jax_mesh({"data": 2, "sequence": 2})
    overrides = {k: v for k, v in ranks.SPARSE.items()}
    cfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, attention_impl="ring", sp_mesh=mesh, **overrides)
    state = jtraining.create_train_state(jgpt.GPTLMHeadModel(cfg), params, learning_rate=sp_ranks.LR)
    result = jtraining.fit_lm(state, sp_ranks.lm_corpus(), seq_len=sp_ranks.GPT_SEQ, batch_size=sp_ranks.GPT_ROWS,
                              pack=False, num_steps=sp_ranks.FIT_STEPS, mesh=mesh, log_every=1, moe_aux=True)
    model = jgpt.GPTLMHeadModel(jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, attention_impl="xla",
                                                    **overrides))
    ids = jnp.asarray(sp_ranks.gpt_ids())

    def fn(p):
        logits, sown = model.apply({"params": p}, ids, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
                                   mutable=["intermediates"])
        return jmoe.collect_aux_losses(sown["intermediates"]) + jgpt.lm_loss(logits, ids)

    loss, grads = jax.jit(jax.value_and_grad(fn))(params["params"])
    whole = {n: t.numpy() for n, t in params_from_jax(_host(result.state.params)).items()}
    return {"losses": [h["loss"] for h in result.metrics_history], "params": whole, "loss": float(loss),
            "grads": _host(grads)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gpt_params = random_params(GPTConfig.tiny(num_layers=1), seed=0)
    bert_params = bert_random_params(BertConfig.tiny(), seed=0)
    sparse_params = random_params(GPTConfig.tiny(**ranks.SPARSE), seed=0, std=0.2)
    inputs = {"gpt_params": gpt_params, "bert_params": bert_params, "sparse_params": sparse_params}
    ctx = multiprocessing.get_context("spawn")
    procs, dirs = {}, {}
    for world in WORLDS:
        dirs[world] = tmp_path_factory.mktemp(f"sp_axes{world}")
        port = _free_port()
        procs[world] = [ctx.Process(target=ranks.rank_main, args=(r, world, port, inputs, str(dirs[world])),
                                    daemon=True) for r in range(world)]
        for p in procs[world]:
            p.start()
    # the references, while the worlds run
    out = {"gpt": {}, "fit_lm": {}, "bert": {}}
    for axes in ranks.AXES:
        for impl in IMPLS:
            out["gpt"][str(axes), impl] = _jax_gpt(gpt_params, axes, impl)
            out["fit_lm"][str(axes), impl] = _jax_fit_lm(gpt_params, axes, impl)
    for impl in IMPLS:
        out["bert"][impl] = _jax_bert(bert_params, impl)
    out["two_heads"] = _jax_gpt(gpt_params, ranks.ST, "ulysses", **ranks.TWO_HEADS)
    out["sparse"] = _jax_sparse(sparse_params)
    torch.set_num_threads(threads)
    deadline = time.monotonic() + WAIT_S
    for world in WORLDS:
        for p in procs[world]:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs[world]:
            if p.is_alive():
                p.kill()
        files = [Path(dirs[world], f"rank{r}.pkl") for r in range(world)]
        out[world] = [pickle.loads(f.read_bytes()) if f.exists() else None for f in files]
    return out


def _results(worlds, world, name):
    got = worlds[world]
    assert all(r is not None for r in got), f"a rank of the world of {world} wrote nothing (hung or crashed)"
    for r, res in enumerate(got):
        assert "error" not in res[name], f"rank {r} of {world}, {name}:\n{res[name]['error']}"
    return [res[name] for res in got]


def _assemble(pieces):
    """The whole ``(rows, seq, ...)`` array from each rank's ``(where,
    chunk)``: rows by data×fsdp index, chunks by sequence index (the ranks
    of one tensor group hold the same chunk)."""
    data = {}
    for where, chunk in pieces:
        data.setdefault(where["data"], {})[where["seq"]] = chunk
    return np.concatenate([np.concatenate([data[d][s] for s in sorted(data[d])], axis=1) for d in sorted(data)])


def _close_grads(got, want, msg=""):
    """Within 1e-4 of each leaf's largest magnitude (the expert-parallel tests' bound)."""
    for name, value in want.items():
        err = float(np.abs(got[name] - value).max())
        assert err <= 1e-4 * float(np.abs(value).max()) + 1e-7, (msg, name, err)


# ------------------------------------------------------------------ dense models


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("axes", AXES)
def test_gpt_over_sequence_beside_tensor_or_fsdp_matches_jax(worlds, axes, impl):
    """The 1-layer tiny GPT on ``{"sequence": 2, "tensor": 2}`` (the
    Megatron copy: each chunk at its rank's two heads) and ``{"fsdp": 2,
    "sequence": 2}`` (FSDP2 hybrid over data×sequence), laid out by
    ``param_shardings``: the gathered logits, every rank's loss and the whole
    gradients of the global mean loss against JAX's same mesh and layout."""
    got = [r[axes, impl] for r in _results(worlds, 4, "gpt")]
    want = worlds["gpt"][axes, impl]
    logits = _assemble([(r["where"], r["logits"]) for r in got])
    np.testing.assert_allclose(logits, want["logits"], atol=2e-4, rtol=0)
    for r in got:
        assert abs(r["loss"] - want["loss"]) <= 1e-5
        grads = gpt_grads_to_jax({n: torch.from_numpy(g) for n, g in r["grads"].items()})
        _close_trees(grads, want["grads"], 5e-4)
        assert (r["tensor_split"] > 0) == ("tensor" in axes) and r["fsdp"] == ("fsdp" in axes)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("axes", AXES)
def test_fit_lm_over_sequence_beside_tensor_or_fsdp_matches_jax(worlds, axes, impl):
    """Three ``fit_lm(pack=False, param_spec=param_shardings)`` steps on each
    composed mesh against JAX's ``fit_lm`` on the same mesh: every logged
    loss, and every rank's parameters after, gathered whole."""
    want = worlds["fit_lm"][axes, impl]
    for r in _results(worlds, 4, "gpt"):
        assert len(r[axes, impl]["losses"]) == len(want["losses"]) > 0
        np.testing.assert_allclose(r[axes, impl]["losses"], want["losses"], atol=1e-5, rtol=0)
        _close_params(r[axes, impl]["params"], want["params"])


@pytest.mark.parametrize("impl", IMPLS)
def test_bert_over_sequence_and_tensor_matches_jax(worlds, impl):
    """The tiny BERT on ``{"sequence": 2, "tensor": 2}``, right-padded rows
    (``kv_lens`` summed over the chunks, ``[CLS]`` broadcast from the first):
    every rank's logits, the loss and whole gradients against JAX's on the
    same mesh and layout, and ``make_classifier_train_step``'s loss."""
    want = worlds["bert"][impl]
    for r in _results(worlds, 4, "bert"):
        np.testing.assert_allclose(r[impl]["logits"], want["logits"], atol=2e-4, rtol=0)
        assert abs(r[impl]["loss"] - want["loss"]) <= 1e-5
        assert abs(r[impl]["metrics"]["loss"] - want["loss"]) <= 1e-5
        grads = bert_grads_to_jax({n: torch.from_numpy(g) for n, g in r[impl]["grads"].items()})
        _close_trees(grads, want["grads"], 5e-4)


def test_ulysses_gathers_heads_a_sequence_axis_does_not_divide(worlds):
    """Two heads over ``{"sequence": 2, "tensor": 2}``: each tensor rank holds
    one, which the sequence axis does not divide, where JAX checks (and
    divides) the model's two. The chunk's heads are gathered over
    ``tensor`` before the all-to-all: logits, loss and gradients as JAX's."""
    got = _results(worlds, 4, "two_heads")
    want = worlds["two_heads"]
    assert all(r["heads"] == 1 for r in got)
    np.testing.assert_allclose(_assemble([(r["where"], r["logits"]) for r in got]), want["logits"], atol=2e-4,
                               rtol=0)
    for r in got:
        assert abs(r["loss"] - want["loss"]) <= 1e-5
        _close_trees(gpt_grads_to_jax({n: torch.from_numpy(g) for n, g in r["grads"].items()}), want["grads"], 5e-4)


def test_tensor_ranks_of_a_chunk_draw_the_same_dropout_masks(worlds):
    """Dropout on, one ring GPT step over ``{"sequence": 2, "tensor": 2}``:
    the two tensor ranks of a chunk draw every mask alike (their activations
    at each site are replicated), the two chunks of a row distinct ones."""
    got = _results(worlds, 4, "dropout")
    by_chunk = {}
    for r in got:
        by_chunk.setdefault(r["where"]["seq"], []).append(r["masks"])
    assert sorted(by_chunk) == [0, 1] and all(len(m) == 2 for m in by_chunk.values())
    for masks in by_chunk.values():
        assert len(masks[0]) > 2 and masks[0] == masks[1]
    assert all(a != b for a, b in zip(by_chunk[0][0], by_chunk[1][0]))


# ------------------------------------------------------------------ sparse blocks


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("world", WORLDS)
def test_sparse_gpt_over_sequence_chunks_matches_jax(worlds, world, remat):
    """The 2-layer sparse ring GPT (four experts, top-2, capacity 1.0,
    router losses on) on ``{"data": 2, "sequence": 2}`` and ``{"sequence":
    2}``, with and without ``remat``: JAX routes the flattened ``(B, S)``
    batch, so a rank's tokens are one run per row of that order. Every
    layer drops exactly the choices the unmeshed model drops on the whole
    batch (some are dropped), the first batch's loss and gradients are
    JAX's, and three ``fit_lm`` steps log JAX's losses and end at its
    parameters (JAX's ring on ``{"data": 2, "sequence": 2}``)."""
    got = _results(worlds, world, "sparse")
    want = worlds["sparse"]
    unmeshed = got[0]["unmeshed_keep"]
    assert len(unmeshed) == 2 and not all(keep.all() for keep in unmeshed)
    rows, seq = sp_ranks.GPT_ROWS, sp_ranks.GPT_SEQ
    for layer, whole in enumerate(unmeshed):
        pieces = [(r["where"], r[remat]["keep"][layer].reshape(-1, seq // r["where"]["seq_size"], 2)) for r in got]
        assert np.array_equal(_assemble(pieces), whole.reshape(rows, seq, 2)), layer
    for r in got:
        np.testing.assert_allclose(r[remat]["losses"], want["losses"], atol=1e-5, rtol=0)
        assert abs(r[remat]["loss"] - want["loss"]) <= 1e-5
        _close_grads(dict(_leaves(gpt_grads_to_jax({n: torch.from_numpy(g) for n, g in r[remat]["grads"].items()}))),
                     dict(_leaves(want["grads"])), f"rank {r['where']}")
        _close_params(r[remat]["params"], want["params"])


@pytest.mark.parametrize("axes", [{"data": 2, "sequence": 4}, {"sequence": 4, "data": 2}],
                         ids=["data_first", "sequence_first"])
def test_chunk_routing_keeps_the_global_order(axes):
    """``topk_route`` over a ``TokenGroup`` of 2 row blocks × 4 chunks,
    simulated in one process: the group's gather stacks every rank's table
    in global-rank order, as ``torch.distributed`` numbers a group's ranks,
    which on the sequence-first mesh is not the batch's order
    (``batch_order`` of that mesh, in a fake world of 8, puts it right).
    Each rank's kept choices and capacity are those of the unmeshed routing
    of the whole batch at its rows and chunk, k = 1 and 2."""
    from tests.test_torch_mesh import fake_world
    from unionml_tpu_torch.models._layers import TokenGroup
    from unionml_tpu_torch.parallel.mesh import batch_order, make_mesh

    rows, seq, chunks, blocks, experts = 3, 16, 4, 2, 4
    with fake_world(blocks * chunks):
        mesh = make_mesh(axes, device="cpu")
        order = batch_order(mesh, sequence=True)
        names = list(axes)
        # (block, chunk) of each global rank, in rank order
        by_rank = [(int(c[names.index("data")]), int(c[names.index("sequence")]))
                   for c in (torch.nonzero(mesh.mesh == r)[0].tolist() for r in range(blocks * chunks))]
    assert (order is None) == (names[0] == "data")
    gates = torch.softmax(torch.from_numpy(np.random.default_rng(0).normal(
        size=(blocks * rows, seq, experts)).astype(np.float32)) * 3, dim=-1)
    length = seq // chunks
    tokens = {(b, c): gates[b * rows:(b + 1) * rows, c * length:(c + 1) * length].reshape(-1, experts)
              for b in range(blocks) for c in range(chunks)}

    class Stacked(TokenGroup):
        def gather(self, x):
            return torch.cat([tables[where] for where in by_rank])

    for k in (1, 2):
        whole = topk_route(gates.reshape(-1, experts), k, 1.0)
        assert not whole.keep.all()
        from unionml_tpu_torch.parallel.ep import _stable_topk

        tables = {}
        for (b, c), g in tokens.items():
            hits = (torch.arange(experts)[:, None] == _stable_topk(g, k)[1].t().reshape(-1)[None, :]).to(torch.int32)
            tables[b, c] = hits.reshape(experts, k, rows, length).sum(dim=3, dtype=torch.int32).permute(2, 1, 0)
        for (b, c), g in tokens.items():
            group = Stacked(None, blocks * chunks, b * chunks + c, chunks=chunks, order=order)
            mine = topk_route(g, k, 1.0, group=group, rows=rows)
            want = whole.keep.reshape(blocks * rows, seq, k)[b * rows:(b + 1) * rows, c * length:(c + 1) * length]
            assert mine.capacity == whole.capacity and torch.equal(mine.keep, want.reshape(-1, k)), (k, b, c)


@pytest.mark.parametrize("axes", [str(axes) for axes in ranks.ORDERS])
def test_sparse_gpt_routes_alike_whatever_the_axis_order(worlds, axes):
    """The sparse GPT's first batch on a mesh that lists its batch axes out
    of the batch's order (``{"sequence": 2, "data": 2}``: ring over the
    chunks; ``{"fsdp": 2, "data": 2}``: FSDP2, dense attention): the batch
    ranks' gather is put in batch order (``batch_order`` is not the
    identity), every layer keeps exactly the unmeshed model's choices, and
    the loss and whole gradients are JAX's (the expert-parallel bounds)."""
    got = [r[axes] for r in _results(worlds, 4, "orders")]
    unmeshed = _results(worlds, 4, "sparse")[0]["unmeshed_keep"]
    want = worlds["sparse"]
    assert all(r["order"] is not None for r in got)
    assert all(r["fsdp"] for r in got) == ("fsdp" in axes)
    rows, seq = sp_ranks.GPT_ROWS, sp_ranks.GPT_SEQ
    for layer, whole in enumerate(unmeshed):
        pieces = [(r["where"], r["keep"][layer].reshape(-1, seq // r["where"]["seq_size"], 2)) for r in got]
        assert np.array_equal(_assemble(pieces), whole.reshape(rows, seq, 2)), layer
    for r in got:
        assert abs(r["loss"] - want["loss"]) <= 1e-5
        _close_grads(dict(_leaves(gpt_grads_to_jax({n: torch.from_numpy(g) for n, g in r["grads"].items()}))),
                     dict(_leaves(want["grads"])), f"rank {r['where']}")


def test_resident_predictor_gathers_rows_in_batch_order(worlds):
    """``ResidentPredictor`` over ``{"fsdp": 2, "data": 2}`` (global rank 1
    holds the batch's third row): the tiny GPT's logits of four rows, one a
    rank, come back in the rows' order, within 1e-5 of the unmeshed
    predictor's."""
    got = _results(worlds, 4, "orders")
    assert all(r["prediction"] == {"followed": 1} for r in got[1:])
    np.testing.assert_allclose(np.asarray(got[0]["prediction"]), np.asarray(got[0]["unmeshed"]), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ serving and checkpoints


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("family", ["bert", "gpt"])
def test_resident_predictor_over_sequence_and_tensor_matches_jax(worlds, family, impl):
    """``ResidentPredictor(mesh=, param_specs=param_shardings)`` over
    ``{"sequence": 2, "tensor": 2}``: the tensor-parallel copy keeps its
    ring or Ulysses config (and its ``sp_mesh``) at two heads a rank, each
    request is cut into the ranks' chunks, and the predictions (BERT's
    right-padded batch; a GPT's chunks gathered back) are the logits of
    JAX's model on the same mesh within 1e-5."""
    got = [r[family, impl] for r in _results(worlds, 4, "resident")]
    assert all(r["kept"] == impl and r["heads"] == 2 and r["sp_mesh"] for r in got)
    assert all(r["prediction"] == {"followed": 1} for r in got[1:])
    want = worlds["bert"][impl] if family == "bert" else worlds["gpt"][AXES[0], impl]
    np.testing.assert_allclose(np.asarray(got[0]["prediction"]), want["logits"], atol=1e-5, rtol=0)


def test_decode_engine_over_sequence_and_tensor_streams_as_unmeshed(worlds):
    """``DecodeEngine`` over ``{"sequence": 2, "tensor": 2}`` with the ring
    GPT: its cache paths attend densely at the rank's two heads, and rank
    0's greedy streams are the unmeshed engine's (the followers follow)."""
    got = _results(worlds, 4, "engine")
    assert got[0]["streams"] == got[0]["unmeshed"] and all(len(s) > 0 for s in got[0]["unmeshed"])
    assert all(r["heads"] == 2 for r in got)
    assert all(r["streams"] == {"followed": got[1]["streams"]["followed"]} for r in got[1:])


def test_checkpoint_over_sequence_and_tensor_resumes_bitwise(worlds):
    """The ring GPT's sharded checkpoint on ``{"sequence": 2, "tensor": 2}``:
    two steps saved and resumed for two more equal two and two more
    straight (parameters and moments, gathered, bitwise); a restore into a laid-out
    state keeps its layout and lays out every tensor shard again."""
    for r in _results(worlds, 4, "checkpoint"):
        assert r["first_steps"] == 2 and r["resumed_step"] == 4 and r["bitwise"]
        assert r["layout_kept"] and r["restored_step"] == 2 and r["shards_equal"] and r["split"] > 0
