"""Sequence parallelism (``parallel/ring.py``, ``parallel/ulysses.py``,
``sp_attention``, the ring/ulysses GPT and BERT and their training through
``fit_lm``/``fit``) on gloo worlds of 2 and 4 ranks against the JAX package
on its 8-device CPU mesh, and the in-process ring of N = 4 chunks.

One spawn per world for the module: the ranks (``tests/torch_sp_ranks.py``,
which imports no JAX) run every scenario with one intra-op thread each,
while this process computes the JAX references. Each rank writes its chunk
of every result; the tests reassemble them. Tolerances (f32):
- ``ring_attention``/``ulysses_attention`` (``test_parallel.py:84-149``):
  forward atol 1e-5, gradients atol 1e-4;
- the GPT's gathered logits and gradients against JAX's GPT at
  ``attention_impl="xla"`` (``test_gpt.py:313-350``): 2e-4 and 5e-4; the
  BERT's logits (``test_models.py:170-188``) 2e-4 and its gradients 5e-4;
- three ``fit_lm`` steps against JAX's unmeshed ``fit_lm``: each loss 1e-5,
  the parameters after within 1e-4 of each leaf's largest magnitude (the
  sharded-training tests' allowance; a 1-D leaf also within 1e-3 of the
  steps' summed learning rate; the key part of the fused qkv bias, whose
  true gradient is 0, within 2.5 learning rates a step);
- BERT ``fit`` on ``{"sequence": 2}`` against the port's unmeshed ``fit``:
  the same bounds.
"""

import dataclasses
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

from tests import torch_sharded_ranks
from tests import torch_sp_ranks as ranks
from unionml_tpu.models import bert as jbert
from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models import training as jtraining
from unionml_tpu.ops.losses import cross_entropy_with_integer_labels as jax_cross_entropy
from unionml_tpu.parallel import make_mesh as jax_make_mesh
from unionml_tpu.parallel import ring_attention as jax_ring_attention
from unionml_tpu.parallel import ulysses_attention as jax_ulysses_attention
from unionml_tpu_torch.models import (
    BertConfig,
    GPTConfig,
    GPTLMHeadModel,
    bert_grads_to_jax,
    bert_params_from_jax,
    create_train_state,
    fit,
    gpt_grads_to_jax,
    gpt_generate,
    init_bert,
    init_gpt,
    params_from_jax,
    random_params,
)
from unionml_tpu_torch.parallel import make_mesh, reference_ring_attention, sp_attention, ulysses_attention
from unionml_tpu_torch.parallel.ring import _in_process_ring_attention

WORLDS = (2, 4)
#: how long the module waits for a world (each rank exits on its own at 170 s)
WAIT_S = 180.0
IMPLS = ranks.IMPLS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_ops():
    """JAX's ring/ulysses on ``{"data": 2, "sequence": 4}``: the output and
    the gradients of ``sum(out * g)``, for each impl and causality."""
    mesh = jax_make_mesh({"data": 2, "sequence": 4})
    q, k, v, g = (jnp.asarray(x) for x in ranks.op_inputs())
    lens = jnp.asarray(ranks.OP_LENS, dtype=jnp.int32)
    table = dict(zip(IMPLS, (jax_ring_attention, jax_ulysses_attention)))

    def loss(q_, k_, v_, impl, causal):
        o = table[impl](q_, k_, v_, mesh, kv_lens=lens, causal=causal)
        return jnp.sum(o * g), o

    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True), static_argnums=(3, 4))
    out = {}
    for impl in IMPLS:
        for causal in (False, True):
            grads, o = grad(q, k, v, impl, causal)
            out[impl, causal] = (np.asarray(o), [np.asarray(x) for x in grads])
    return out


def _jax_gpt(params):
    """JAX's 1-layer tiny GPT at ``attention_impl="xla"``: logits, loss and
    gradients of ``lm_loss`` on ``gpt_ids``."""
    model = jgpt.GPTLMHeadModel(jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, num_layers=1,
                                                    attention_impl="xla"))
    ids = jnp.asarray(ranks.gpt_ids())

    def fn(p):
        logits = model.apply({"params": p}, ids)
        return jgpt.lm_loss(logits, ids), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params["params"])
    return {"logits": np.asarray(logits), "loss": float(loss), "grads": _host(grads)}


def _jax_bert(variables):
    """JAX's tiny BERT at ``attention_impl="xla"``: logits, loss and gradients
    of the mean cross-entropy on ``bert_batch``."""
    model = jbert.BertForSequenceClassification(jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl="xla",
                                                                      hidden_dropout=0.0))
    batch = {k: jnp.asarray(v) for k, v in ranks.bert_batch().items()}

    def fn(p):
        logits = model.apply({"params": p}, batch["input_ids"], batch["attention_mask"], deterministic=True)
        return jax_cross_entropy(logits, batch["labels"]), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(variables["params"])
    return {"logits": np.asarray(logits), "loss": float(loss), "grads": _host(grads)}


def _jax_fit_lm(params):
    cfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, num_layers=1, attention_impl="xla")
    state = jtraining.create_train_state(jgpt.GPTLMHeadModel(cfg), params, learning_rate=ranks.LR)
    result = jtraining.fit_lm(state, ranks.lm_corpus(), seq_len=ranks.GPT_SEQ, batch_size=ranks.GPT_ROWS,
                              pack=False, num_steps=ranks.FIT_STEPS, log_every=1)
    whole = {n: t.numpy() for n, t in params_from_jax(_host(result.state.params)).items()}
    return {"losses": [h["loss"] for h in result.metrics_history], "params": whole}


def _jax_eval(gpt_vars, bert_vars):
    """JAX's eval steps on the ``eval`` scenario's batches (unmeshed, ``"xla"`` attention)."""
    gcfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, num_layers=1, attention_impl="xla")
    gpt = jtraining.create_train_state(jgpt.GPTLMHeadModel(gcfg), gpt_vars)
    lm = jtraining.make_lm_eval_step()(gpt, {k: jnp.asarray(v) for k, v in ranks.lm_eval_batch().items()})
    bcfg = jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl="xla", hidden_dropout=0.0)
    bert = jtraining.create_train_state(jbert.BertForSequenceClassification(bcfg), bert_vars)
    classified = jtraining.make_classifier_eval_step(ranks.SIG)(
        bert, {k: jnp.asarray(v) for k, v in ranks.bert_batch().items()})
    return {"lm": {k: float(v) for k, v in lm.items()}, "classifier": {k: float(v) for k, v in classified.items()}}


def _port_bert_fit(bert_params):
    """The port's unmeshed dense ``fit`` of the ``bert_fit`` scenario."""
    state = create_train_state(init_bert(ranks.bert_config(), params=bert_params, device="cpu"),
                               learning_rate=ranks.LR)
    result = fit(state, ranks.bert_fit_data(), batch_size=ranks.BERT_ROWS, num_steps=ranks.FIT_STEPS,
                 input_signature=ranks.SIG, log_every=1)
    return {"history": result.metrics_history,
            "params": {n: p.detach().numpy().copy() for n, p in zip(result.state.names, result.state.params)}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bert_vars = _host(jbert.init_params(jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl="xla",
                                                              hidden_dropout=0.0), seq_len=16))
    # seeded numpy weights in JAX's layout feed both packages
    gpt_vars = random_params(GPTConfig.tiny(num_layers=1), seed=0)
    inputs = {"bert_params": bert_vars, "gpt_params": gpt_vars}
    ctx = multiprocessing.get_context("spawn")
    procs, dirs = {}, {}
    for world in WORLDS:
        dirs[world] = tmp_path_factory.mktemp(f"sp{world}")
        port = _free_port()
        procs[world] = [ctx.Process(target=ranks.rank_main, args=(r, world, port, inputs, str(dirs[world])),
                                    daemon=True) for r in range(world)]
        for p in procs[world]:
            p.start()
    # the references, while the worlds run
    out = {"ops": _jax_ops(), "gpt": _jax_gpt(gpt_vars), "bert": _jax_bert(bert_vars), "fit_lm": _jax_fit_lm(gpt_vars),
           "bert_fit": _port_bert_fit(bert_vars), "eval": _jax_eval(gpt_vars, bert_vars), "gpt_params": gpt_vars, "bert_params": bert_vars}
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


def _assemble(pieces, rows_dim=0, seq_dim=None):
    """The whole array from each rank's ``(where, chunk)``: rows by data
    index, chunks by sequence index (ranks of one data index hold the same rows)."""
    data = {}
    for where, chunk in pieces:
        data.setdefault(where["data"], {})[where["seq"]] = chunk
    rows = []
    for d in sorted(data):
        chunks = [data[d][s] for s in sorted(data[d])]
        rows.append(np.concatenate(chunks, axis=seq_dim) if seq_dim is not None else chunks[0])
    return np.concatenate(rows, axis=rows_dim)


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _close_trees(got, want, atol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=atol, rtol=0, err_msg=str(path))


def _close_params(got, want, steps=ranks.FIT_STEPS):
    """Within 1e-4 of each leaf's largest magnitude; a 1-D leaf (a bias or
    norm, whose value is mostly the Adam steps themselves) within that or
    1e-3 of the steps' summed learning rate; the attention key biases (the
    middle third of GPT's fused qkv bias, BERT's ``key.bias``), whose true
    gradient is 0, within 2.5 learning rates a step (Adam turns their
    rounding noise into steps of up to the learning rate)."""
    for name, value in want.items():
        err = np.abs(np.asarray(got[name]) - value)
        if name.endswith("qkv.bias"):
            third = value.shape[0] // 3
            assert float(err[third:2 * third].max()) <= 2.5 * ranks.LR * steps, name
            err = np.concatenate([err[:third], err[2 * third:]])
        elif name.endswith("attention.key.bias"):
            assert float(err.max()) <= 2.5 * ranks.LR * steps, name
            continue
        limit = 1e-4 * float(np.abs(value).max())
        if value.ndim == 1:
            limit = max(limit, 1e-3 * ranks.LR * steps)
        assert float(err.max()) <= limit, (name, float(err.max()), limit)


# ------------------------------------------------------------------ op level


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_sequence_parallel_attention_matches_jax(worlds, world, impl):
    """``ring_attention``/``ulysses_attention`` over gloo, causal and not, with
    a fully padded row: the reassembled output and q, k, v gradients against
    JAX's on its ``{"data": 2, "sequence": 4}`` mesh. The padded row's output
    and gradients are exactly zero (JAX's ring writes zeros there too; its
    Ulysses, through ``xla_attention``, averages the row's values, where the
    port's plain attention writes zeros as the kernels do: that row is held
    to zero, the others to JAX's)."""
    cases = [c for rank in _results(worlds, world, "ops") for c in rank["cases"] if c["impl"] == impl]
    meshes = {str(c["axes"]) for c in cases}
    assert len(meshes) == (2 if world == 4 else 1)
    for axes in meshes:
        for causal in (False, True):
            mine = [c for c in cases if str(c["axes"]) == axes and c["causal"] == causal]
            want_out, want_grads = worlds["ops"][impl, causal]
            rows = slice(0, None) if impl == "ring" else slice(1, None)
            out = _assemble([(c["where"], c["out"]) for c in mine], seq_dim=2)
            np.testing.assert_allclose(out[rows], want_out[rows], atol=1e-5, rtol=0,
                                       err_msg=f"{axes} causal={causal}")
            assert not out[0].any()
            for i in range(3):
                grad = _assemble([(c["where"], c["grads"][i]) for c in mine], seq_dim=2)
                np.testing.assert_allclose(grad[rows], want_grads[i][rows], atol=1e-4, rtol=0,
                                           err_msg=f"{axes} causal={causal} grad {i}")
                assert not grad[0].any()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_in_process_ring_of_four_chunks_matches_jax(worlds, causal):
    """The kernel arm's schedule, merge and backward over N = 4 chunks in one
    process (on the CPU each block's K1/K2/K3 call runs its plain version),
    and the plain f32 fold, against JAX's ``ring_attention``."""
    q, k, v, g = (torch.from_numpy(x) for x in ranks.op_inputs())
    lens = torch.tensor(ranks.OP_LENS, dtype=torch.int32)
    want_out, want_grads = worlds["ops"]["ring", causal]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    chunks = [list(x.chunk(4, dim=2)) for x in leaves]
    out = torch.cat(_in_process_ring_attention(*chunks, kv_lens=lens, causal=causal), dim=2)
    grads = torch.autograd.grad((out * g).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5, rtol=0)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    plain = torch.cat(reference_ring_attention(*(list(x.chunk(4, dim=2)) for x in (q, k, v)), kv_lens=lens,
                                               causal=causal), dim=2)
    np.testing.assert_allclose(plain.numpy(), want_out, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ models


def test_gpt_over_data_and_sequence_matches_jax(worlds):
    """The 1-layer tiny GPT on ``{"data": 2, "sequence": 2}``: gathered logits
    and the step's gradients (of the global mean loss) against JAX's GPT at
    ``attention_impl="xla"`` (``test_gpt.py:313-350``)."""
    got = _results(worlds, 4, "gpt")
    want = worlds["gpt"]
    for impl in IMPLS:
        logits = _assemble([(r["where"], r[impl]["logits"]) for r in got], seq_dim=1)
        np.testing.assert_allclose(logits, want["logits"], atol=2e-4, rtol=0, err_msg=impl)
        for r in got:
            assert abs(r[impl]["loss"] - want["loss"]) <= 1e-5
            grads = gpt_grads_to_jax({n: torch.from_numpy(g) for n, g in r[impl]["grads"].items()})
            _close_trees(grads, want["grads"], 5e-4)


def test_bert_over_sequence_matches_jax(worlds):
    """The tiny BERT on ``{"sequence": 4}``, right-padded rows (one ends in
    the first chunk): every rank's logits (``test_models.py:170-188``) and the
    step's gradients against JAX's BERT at ``attention_impl="xla"``."""
    want = worlds["bert"]
    for r in _results(worlds, 4, "bert"):
        for impl in IMPLS:
            np.testing.assert_allclose(r[impl]["logits"], want["logits"], atol=2e-4, rtol=0, err_msg=impl)
            assert abs(r[impl]["loss"] - want["loss"]) <= 1e-5
            grads = bert_grads_to_jax({n: torch.from_numpy(g) for n, g in r[impl]["grads"].items()})
            _close_trees(grads, want["grads"], 5e-4)


def test_fit_lm_over_data_and_sequence_matches_jax(worlds):
    """Three ``fit_lm(pack=False)`` steps on ``{"data": 2, "sequence": 2}``
    against JAX's unmeshed ``fit_lm`` on the same rows: every logged loss, and
    the parameters after (each rank's, replicated)."""
    want = worlds["fit_lm"]
    for r in _results(worlds, 4, "fit_lm"):
        for impl in IMPLS:
            assert len(r[impl]["losses"]) == len(want["losses"]) > 0
            np.testing.assert_allclose(r[impl]["losses"], want["losses"], atol=1e-5, rtol=0, err_msg=impl)
            _close_params(r[impl]["params"], want["params"])


def test_bert_fit_over_sequence_matches_the_dense_fit(worlds):
    """BERT ``fit`` on ``{"sequence": 2}`` (``dict_batches`` gives both ranks
    the same rows, the step cuts each its chunk) against the port's unmeshed
    dense ``fit``: the metrics of every logged step and the parameters after."""
    want = worlds["bert_fit"]
    for r in _results(worlds, 2, "bert_fit"):
        for impl in IMPLS:
            for a, b in zip(r[impl]["history"], want["history"]):
                assert a["step"] == b["step"] and abs(a["loss"] - b["loss"]) <= 1e-5, (impl, a, b)
                assert a["accuracy"] == b["accuracy"]
            _close_params(r[impl]["params"], want["params"])


def test_eval_steps_over_sequence_match_jax(worlds):
    """``make_lm_eval_step``/``make_classifier_eval_step`` on ``{"sequence":
    2}``, each rank handed the whole rows: every rank's loss and perplexity
    (right-padded rows, one ending inside the first chunk) and loss and
    accuracy are the whole rows', as JAX's unmeshed eval steps give them."""
    want = worlds["eval"]
    for r in _results(worlds, 2, "eval"):
        for impl in IMPLS:
            for kind in ("lm", "classifier"):
                for key, value in want[kind].items():
                    assert abs(r[impl][kind][key] - value) <= 1e-5 * max(1.0, abs(value)), (impl, kind, key)


def test_chunks_of_one_row_draw_distinct_dropout_masks(worlds):
    got = _results(worlds, 2, "dropout")
    assert len(got[0]["masks"]) == len(got[1]["masks"]) > 2
    assert all(a != b for a, b in zip(got[0]["masks"], got[1]["masks"]))


# ------------------------------------------------------------------ in process


def test_errors_match_jax():
    """JAX's errors: heads the axis does not divide, a ring config without a
    mesh, ``segment_ids`` and ``pad_offsets`` on a sequence-parallel GPT, an
    unknown impl."""
    q = torch.ones((2, 6, 32, 16))
    with torch_sharded_ranks.fake_world(4):
        mesh = make_mesh({"sequence": 4}, device="cpu")
        with pytest.raises(ValueError, match="divisible") as mine:
            ulysses_attention(q, q, q, mesh)
        with pytest.raises(ValueError, match="Unknown sequence-parallel impl"):
            sp_attention(q, q, q, mesh, "zigzag")
    with pytest.raises(ValueError, match="divisible") as theirs:
        jax_ulysses_attention(jnp.ones((2, 6, 32, 16)), jnp.ones((2, 6, 32, 16)), jnp.ones((2, 6, 32, 16)),
                              jax_make_mesh({"data": 2, "sequence": 4}))
    assert str(mine.value) == str(theirs.value)

    params = random_params(GPTConfig.tiny(), seed=0)
    ids = torch.ones((2, 16), dtype=torch.long)
    model = init_gpt(GPTConfig.tiny(attention_impl="ring", dtype=torch.float32), params=params, device="cpu")
    with pytest.raises(ValueError, match="requires a sequence-parallel mesh"):
        model(ids)
    jmodel = jgpt.GPTLMHeadModel(jgpt.GPTConfig.tiny(attention_impl="ring", dtype=jnp.float32))
    for kwargs in ({"segment_ids": np.ones((2, 16), np.int32)}, {"pad_offsets": np.zeros(2, np.int32)}):
        with pytest.raises(ValueError) as theirs:
            jmodel.apply({"params": params["params"]}, jnp.ones((2, 16), jnp.int32),
                         **{k: jnp.asarray(v) for k, v in kwargs.items()})
        with pytest.raises(ValueError) as mine:
            model(ids, **{k: torch.from_numpy(v) for k, v in kwargs.items()})
        assert str(mine.value) == str(theirs.value)


def test_ring_config_generates_through_the_dense_fallback():
    """``test_gpt.py:354-371``: a ring config on a ``{"data": 2, "sequence":
    4}`` mesh generates through its cache paths, which attend densely: the
    tokens of the dense config's ``generate``, and of JAX's."""
    params = random_params(GPTConfig.tiny(), seed=0)
    prompt = np.random.default_rng(1).integers(0, 512, (2, 8))
    dense = init_gpt(GPTConfig.tiny(dropout=0.0, dtype=torch.float32), params=params, device="cpu")
    want = gpt_generate(dense, torch.from_numpy(prompt), 4)
    with torch_sharded_ranks.fake_world(8):
        mesh = make_mesh({"data": 2, "sequence": 4}, device="cpu")
        ring = init_gpt(GPTConfig.tiny(dropout=0.0, dtype=torch.float32, attention_impl="ring", sp_mesh=mesh),
                        params=params, device="cpu")
        got = gpt_generate(ring, torch.from_numpy(prompt), 4)
    assert got.shape == (2, 12) and torch.equal(got, want)
    jmesh = jax_make_mesh({"data": 2, "sequence": 4})
    jcfg = jgpt.GPTConfig.tiny(attention_impl="ring", sp_mesh=jmesh, dropout=0.0, dtype=jnp.float32)
    theirs = jgpt.generate(jgpt.GPTLMHeadModel(jcfg), {"params": params["params"]}, jnp.asarray(prompt), 4)
    assert np.array_equal(np.asarray(theirs), got.numpy())


def test_sequence_with_tensor_or_fsdp_and_serving_raise():
    """Sequence parallelism beside a tensor or fsdp axis no longer raises:
    on ``{"tensor": 2, "sequence": 2}`` and ``{"fsdp": 2, "sequence": 2}``
    the meshed step's first call lays the state out by ``param_shardings``
    (the Megatron copy keeping the ring config and its ``sp_mesh``, or FSDP2
    over the (data×sequence, fsdp) mesh), and serving keeps the model's
    sequence-parallel attention on both (``tests/test_torch_sequence_axes.py``
    trains and serves them against JAX); without a sequence axis, serving
    attends densely and shares the parameters; a mesh that splits rows
    needs a sequence-parallel config."""
    from unionml_tpu_torch.models import bert as tbert
    from unionml_tpu_torch.models import make_classifier_train_step
    from unionml_tpu_torch.models.training import _on_mesh
    from unionml_tpu_torch.parallel.mesh import axis_names
    from unionml_tpu_torch.serving.resident import _serving_attention

    params = bert_params_from_jax(_host(jbert.init_params(jbert.BertConfig.tiny(dtype=jnp.float32), seq_len=16)))
    batch = {k: torch.from_numpy(v) for k, v in ranks.bert_batch().items()}
    with torch_sharded_ranks.fake_world(4):
        for axes in ({"tensor": 2, "sequence": 2}, {"fsdp": 2, "sequence": 2}):
            mesh = make_mesh(axes, device="cpu")
            model = init_bert(ranks.bert_config("ring", mesh), device="cpu")
            model.load_state_dict(params)
            spec = tbert.param_shardings(dict(model.named_parameters()), axis_names(mesh))
            state = _on_mesh(create_train_state(model), mesh, spec)
            layout = state.layout
            assert layout is not None and layout.mesh is mesh and layout.batch_size == (4 if "fsdp" in axes else 2)
            assert state.model.config.attention_impl == "ring" and state.model.config.sp_mesh is mesh
            if "tensor" in axes:
                assert any(layout.tensor_split) and not layout.fsdp and state.model.bert.tp.heads == 2
            else:
                assert layout.fsdp and not any(layout.tensor_split) and state.model is not model
            assert _serving_attention(model, mesh) is model
        dense_model = init_bert(ranks.bert_config(), device="cpu")
        with pytest.raises(ValueError, match="splits every row"):
            make_classifier_train_step(mesh=mesh, input_signature=ranks.SIG)(create_train_state(dense_model), batch)
        served = _serving_attention(model, None)
        assert served.config.attention_impl == "auto" and served.config.sp_mesh is None
        assert all(a is b for a, b in zip(served.parameters(), model.parameters()))
        assert model.config.attention_impl == "ring"
    dense_model.load_state_dict(params)
    with torch.no_grad():
        torch.testing.assert_close(served(*(batch[k] for k in ranks.SIG)),
                                   dense_model(*(batch[k] for k in ranks.SIG)), atol=0, rtol=0)


def test_sequence_sharding_cuts_as_shard_batch_and_shard_sequence():
    """``sequence_sharding``'s ``(batch, heads, seq, head_dim)`` layout: each
    rank's shard is its rows (``shard_batch``) and its chunk of dimension 2,
    the one ``shard_sequence`` cuts from dimension 1 of the ``(rows, seq)``
    arrays, on a mesh with and without a data axis."""
    from unionml_tpu_torch.parallel import sequence_sharding, shard_batch, shard_sequence

    x = torch.arange(4 * 2 * 8 * 3).reshape(4, 2, 8, 3)
    for axes in ({"data": 2, "sequence": 4}, {"sequence": 4}):
        for rank in range(8 if "data" in axes else 4):
            with torch_sharded_ranks.fake_world(8 if "data" in axes else 4, rank):
                mesh = make_mesh(axes, device="cpu")
                got = sequence_sharding(mesh).shard(x)
                want = shard_sequence(shard_batch(x.transpose(1, 2), mesh), mesh).transpose(1, 2)
                assert got.shape == (4 // axes.get("data", 1), 2, 2, 3) and torch.equal(got, want), (axes, rank)


def test_configs_take_the_sequence_parallel_impls():
    """``GPTConfig``/``BertConfig`` build with ring/ulysses and a mesh;
    ``paged_attn_impl`` takes neither, as in JAX; ``GPTLMHeadModel`` builds
    from them."""
    for impl in IMPLS:
        assert GPTConfig(attention_impl=impl, sp_mesh=object()).attention_impl == impl
        assert BertConfig(attention_impl=impl, sp_mesh=object()).attention_impl == impl
        with pytest.raises(ValueError):
            GPTConfig(paged_attn_impl=impl)
        assert isinstance(GPTLMHeadModel(GPTConfig.tiny(attention_impl=impl), device="cpu"), GPTLMHeadModel)
    assert dataclasses.replace(BertConfig.tiny(), attention_impl="ulysses").sp_mesh is None
