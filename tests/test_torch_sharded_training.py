"""Sharded training (``fit``/``fit_lm``/``make_*_train_step``/``dict_batches``
with ``mesh=``/``param_spec=``, ``parallel/dp.py``, the sharded checkpoint,
the ``data-parallel`` template) on gloo worlds of 2 and 4 ranks against the
JAX package on its 8-device CPU mesh.

One spawn per world for the module: the ranks (``tests/torch_sharded_ranks.py``,
which imports no JAX) run every scenario with one intra-op thread each, while
this process computes the JAX references. Dropout is off wherever values are
compared with JAX. Tolerances are those of the port's training tests:
- the data-parallel step (``test_parallel.py:46``) and its loss: 1e-6;
- one step's loss within 1e-6 and ``grad_norm`` within 1e-5 relative;
- parameters after one or three steps within 1e-4 of each leaf's largest
  magnitude; the attention key biases, whose true gradient is 0, hold
  rounding noise that Adam's normalisation turns into a step of up to the
  learning rate either way, so they are held to 2.5 learning rates;
- packed ``fit_lm`` losses per step within 1e-4 (three f32 Adam steps);
- batches, ``grad_accum`` metrics (1e-6, 1e-5 relative) and the resumed
  checkpoint: exact where the port promises exactness.
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

from tests import torch_sharded_ranks as ranks
from unionml_tpu.models import MLPClassifier as JaxMLP
from unionml_tpu.models import bert as jbert
from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models import training as jtraining
from unionml_tpu.parallel import batches as jax_batches
from unionml_tpu.parallel import data_parallel_step as jax_dp_step
from unionml_tpu.parallel import make_mesh as jax_make_mesh
from unionml_tpu.parallel import pad_to_multiple as jax_pad
from unionml_tpu.templates import render_template as jax_render
from unionml_tpu_torch.models import bert as tbert
from unionml_tpu_torch.models import GPTConfig, bert_params_from_jax, bert_random_params, init_bert, random_params
from unionml_tpu_torch.models.convert import mlp_params_from_jax
from unionml_tpu_torch.parallel import mesh as tmesh
from unionml_tpu_torch.parallel import pad_to_multiple
from unionml_tpu_torch.templates import render_template

WORLDS = (2, 4)
#: how long the module waits for a world (each rank exits on its own at 170 s)
WAIT_S = 180.0
LR = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, devices=jax.devices()[:n])


def _jax_bert_step(variables, axes):
    cfg = jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl="xla", hidden_dropout=0.0)
    state = jtraining.create_train_state(jbert.BertForSequenceClassification(cfg), variables, learning_rate=LR)
    step = jtraining.make_classifier_train_step(mesh=_mesh(axes), input_signature=ranks.SIG)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in ranks.bert_batch().items()})
    params = bert_params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(new.params)))
    return {k: float(v) for k, v in metrics.items()}, {n: t.numpy() for n, t in params.items()}


def _jax_fit_lm(params, axes):
    cfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, attention_impl="xla")
    state = jtraining.create_train_state(jgpt.GPTLMHeadModel(cfg), params, learning_rate=1e-3)
    result = jtraining.fit_lm(state, ranks.lm_corpus(), seq_len=32, batch_size=4, num_steps=3, mesh=_mesh(axes),
                              log_every=1)
    return [h["loss"] for h in result.metrics_history]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))  # noqa: E731
    bcfg = jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl="xla", hidden_dropout=0.0)
    bert_vars = host(jbert.init_params(bcfg, seq_len=16))
    # seeded numpy weights in JAX's layout feed both packages (no JAX init to compile)
    gpt_vars = random_params(GPTConfig.tiny(), seed=0)
    jmlp = JaxMLP(hidden_sizes=(32,), num_classes=4)
    mlp_vars = jmlp.init(jax.random.PRNGKey(0), jnp.zeros((1, 16)))
    template_dir = render_template("data-parallel", "dp_app", tmp_path_factory.mktemp("template"))
    inputs = {"bert_params": bert_vars, "gpt_params": gpt_vars, "mlp_params": host(mlp_vars),
              "template_dir": str(template_dir)}
    ctx = multiprocessing.get_context("spawn")
    procs, dirs = {}, {}
    for world in WORLDS:
        dirs[world] = tmp_path_factory.mktemp(f"train{world}")
        port = _free_port()
        procs[world] = [ctx.Process(target=ranks.rank_main, args=(r, world, port, "training", inputs,
                                                                    str(dirs[world])), daemon=True)
                        for r in range(world)]
        for p in procs[world]:
            p.start()
    # the references, while the worlds run
    refs = {}
    w, x, y = ranks.dp_data()

    def step(w_, batch):
        x_, y_ = batch
        loss = jnp.mean((x_ @ w_ - y_) ** 2)
        return w_ - 0.1 * jax.grad(lambda v: jnp.mean((x_ @ v - y_) ** 2))(w_), loss

    w_dp, loss_dp = jax_dp_step(step, jax_make_mesh({"data": 8}), donate_state=False)(
        jnp.asarray(w), (jnp.asarray(x), jnp.asarray(y)))
    grid = np.arange(100, dtype=np.float32).reshape(50, 2)
    two = _mesh({"data": 2})
    refs["dp"] = {"w": np.asarray(w_dp), "loss": float(loss_dp),
                  "batches": [np.asarray(b) for b in jax_batches(grid, batch_size=16, mesh=two)],
                  "ragged": [np.asarray(b) for b in jax_batches(grid, batch_size=15, mesh=two, drop_remainder=False)]}
    data = ranks.toy_classification_data()
    jstate = jtraining.create_train_state(jmlp, mlp_vars, learning_rate=1e-2)
    three = jtraining.fit(jstate, data, batch_size=64, num_steps=3, mesh=_mesh({"data": 4}), log_every=1000).state
    refs["mlp_three"] = {n: t.numpy() for n, t in mlp_params_from_jax(host(three.params)).items()}
    refs["bert"] = _jax_bert_step(bert_vars, {"data": 2, "tensor": 2})
    # JAX's {"tensor": 2} run lays the same arithmetic out otherwise: one reference serves both port meshes
    refs["gpt"] = _jax_fit_lm(gpt_vars, {"data": 2})
    refs["ragged"] = [{k: np.asarray(v) for k, v in b.items()} for b in jtraining.dict_batches(
        {"x": np.arange(26, dtype=np.float32).reshape(13, 2), "y": np.arange(13, dtype=np.int32)}, 5,
        rng=np.random.default_rng(3), mesh=two, drop_remainder=False)]
    jax_app_dir = jax_render("data-parallel", "jax_dp_app", tmp_path_factory.mktemp("jax_template"))
    refs["template"] = _jax_template_accuracy(jax_app_dir)
    torch.set_num_threads(threads)
    deadline = time.monotonic() + WAIT_S
    out = dict(refs)
    for world in WORLDS:
        for p in procs[world]:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs[world]:
            if p.is_alive():
                p.kill()
        files = [Path(dirs[world], f"rank{r}.pkl") for r in range(world)]
        out[world] = [pickle.loads(f.read_bytes()) if f.exists() else None for f in files]
    return out


def _jax_template_accuracy(app_dir):
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location("jax_dp_template_app", Path(app_dir) / "app.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_dp_template_app"] = module
    spec.loader.exec_module(module)
    _, metrics = module.model.train()
    return metrics


def _results(worlds, world, name):
    got = worlds[world]
    assert all(r is not None for r in got), f"a rank of the world of {world} wrote nothing (hung or crashed)"
    for r, res in enumerate(got):
        assert "error" not in res[name], f"rank {r} of {world}, {name}:\n{res[name]['error']}"
    return [res[name] for res in got]


def _close_leaves(got, want, lr=LR):
    for name, value in want.items():
        err = float(np.abs(np.asarray(got[name]) - value).max())
        if name.endswith("attention.key.bias"):
            assert err <= 2.5 * lr, (name, err)
        else:
            assert err <= 1e-4 * float(np.abs(value).max()), (name, err)


# ------------------------------------------------------------------ parallel/dp.py


def test_data_parallel_step_matches_jax(worlds):
    """``test_parallel.py:46``: the rank's step on its rows, averaged over the
    ranks, is the full batch's step (and JAX's) on every rank."""
    for got in _results(worlds, 2, "dp"):
        np.testing.assert_allclose(got["w"], worlds["dp"]["w"], atol=1e-6)
        np.testing.assert_allclose(got["loss"], worlds["dp"]["loss"], atol=1e-6)
        np.testing.assert_allclose(got["eval_loss"], worlds["dp"]["loss"], atol=1e-6)


@pytest.mark.parametrize("kind", ["batches", "ragged"])
def test_batches_give_each_rank_its_jax_rows(worlds, kind):
    """``test_parallel.py:68``: each rank's batches are its rows of JAX's laid-out
    batches, static in shape; a ragged batch wraps real rows first."""
    got = _results(worlds, 2, "dp")
    want = worlds["dp"][kind]
    assert len(got[0][kind]) == len(want) == (3 if kind == "batches" else 4)
    for i, batch in enumerate(want):
        assert np.array_equal(np.concatenate([g[kind][i] for g in got]), batch)
    assert all(b.shape == (8, 2) for b in got[0]["batches"])


def test_pad_to_multiple_matches_jax():
    for shape, multiple in (((5, 3), 8), ((8, 3), 8), ((3,), 2)):
        array = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        (mine, n), (theirs, jn) = pad_to_multiple(array, multiple), jax_pad(array, multiple)
        assert n == jn and np.array_equal(mine, theirs)
        padded, n = pad_to_multiple(torch.from_numpy(array), multiple)
        assert n == jn and np.array_equal(padded.numpy(), theirs)


# ------------------------------------------------------------------ fit and the steps


def test_mlp_fit_data_parallel_matches_jax_and_learns(worlds):
    """``test_models.py:100`` on ``{"data": 4}``: above 0.9 accuracy, and the
    parameters after 3 steps are JAX's mesh fit's."""
    for got in _results(worlds, 4, "mlp_fit"):
        _close_leaves(got["three"], worlds["mlp_three"], lr=1e-2)
        assert got["accuracy"] > 0.9


@pytest.mark.parametrize("name", ["bert_data_tensor", "bert_data_fsdp"])
def test_bert_step_over_two_axes_matches_jax(worlds, name):
    """One tiny-BERT step on {"data": 2, "tensor": 2} and on {"data": 2,
    "fsdp": 2} with ``param_shardings``: loss, ``grad_norm`` and the gathered
    parameters against JAX's step (``test_models.py:113``) and each other."""
    metrics, params = worlds["bert"]
    got = _results(worlds, 4, name)
    other = _results(worlds, 4, "bert_data_fsdp" if name == "bert_data_tensor" else "bert_data_tensor")[0]
    for r in got:
        assert abs(r["metrics"]["loss"] - metrics["loss"]) <= 1e-6
        np.testing.assert_allclose(r["metrics"]["grad_norm"], metrics["grad_norm"], rtol=1e-5)
        _close_leaves(r["params"], params)
        _close_leaves(r["params"], other["params"])
        np.testing.assert_allclose(r["metrics"]["grad_norm"], other["metrics"]["grad_norm"], rtol=1e-5)


def test_tensor_ranks_hold_their_megatron_shards(worlds):
    got = _results(worlds, 4, "bert_data_tensor")
    for r in got:
        assert r["heads"] == 2
        assert r["local"]["bert.encoder.layers.0.attention.query.weight"] == (64, 128)
        assert r["local"]["bert.encoder.layers.0.attention.output.weight"] == (128, 64)
        assert r["local"]["bert.word_embeddings.weight"] == (512, 128)
        assert r["local"]["bert.pooler.weight"] == (128, 128)


def test_fsdp_ranks_hold_their_shard_of_every_leaf(worlds):
    """Each rank's FSDP2 shard: dimension 0 of every parameter, and of ``mu``
    and ``nu``, split over the two fsdp ranks (replicated over data)."""
    got = _results(worlds, 4, "bert_data_fsdp")
    for r in got:
        for name, (p, m, v) in r["local"].items():
            full = r["whole_shapes"][name]
            assert p == m == v == (-(-full[0] // 2),) + full[1:], name


def test_param_shardings_match_jax():
    """``test_models.py:135``: the spec of every leaf is JAX's, flipped to the
    port's ``(out, in)`` weights."""
    variables = bert_random_params(ranks.bert_config(), seed=0)  # the specs read names and shapes only
    model = init_bert(ranks.bert_config(), params=variables, device="cpu")
    markers = {n: np.full(tuple(p.shape), i, dtype=np.float32) for i, (n, p) in enumerate(model.named_parameters())}
    names = list(markers)
    for axes in (("data", "tensor"), ("data", "fsdp", "tensor"), ("tensor",), ("data",)):
        theirs = jbert.param_shardings(variables["params"], axes)
        mine = tbert.param_shardings(dict(model.named_parameters()), axes)
        jax_tree = _jax_tree_of(markers)
        flat_specs = dict(_paths(theirs, is_spec=True))
        for path, marker in _paths(jax_tree):
            name = names[int(marker.reshape(-1)[0])]
            spec = tuple(flat_specs[path])
            transposed = path[-1] == "kernel"
            entries = spec + (None,) * (marker.ndim - len(spec))
            assert tuple(mine[name]) == (tuple(reversed(entries)) if transposed else spec) or \
                (marker.ndim < 2 and tuple(mine[name]) == spec == ()), (name, path)


def _jax_tree_of(named):
    """Port-named arrays in JAX's BERT tree layout."""
    from unionml_tpu_torch.models import bert_grads_to_jax

    return bert_grads_to_jax({n: torch.from_numpy(v) for n, v in named.items()})


def _paths(tree, prefix=(), is_spec=False):
    from jax.sharding import PartitionSpec

    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,), is_spec)
        elif is_spec or not isinstance(value, PartitionSpec):
            yield prefix + (key,), value


def test_vocab_the_tensor_axis_does_not_divide_raises_as_jax():
    """The tiny BERT's 1024 rows on a tensor axis of 3: JAX's ``device_put``
    refuses the layout, and so does the port's ``tensor_parallel``."""
    from jax.sharding import NamedSharding, PartitionSpec

    table = np.zeros((1024, 8), dtype=np.float32)
    with pytest.raises(ValueError, match="divisible by 3") as theirs:
        jax.device_put(table, NamedSharding(_mesh({"tensor": 3}), PartitionSpec("tensor", None)))
    model = init_bert(ranks.bert_config(), seed=0, device="cpu")
    with ranks.fake_world(3, rank=1):
        with pytest.raises(ValueError, match="divisible by 3") as mine:
            tbert.tensor_parallel(model, tmesh.make_mesh({"tensor": 3}, device="cpu"))
    assert "1024" in str(theirs.value) and "1024" in str(mine.value)


def test_gpt_fit_lm_over_data_and_tensor_matches_jax(worlds):
    """Packed ``fit_lm`` of the tiny GPT on {"data": 2} and {"tensor": 2}: the
    loss of every step against JAX's ``fit_lm(mesh=...)``."""
    for r in _results(worlds, 2, "gpt"):
        assert r["heads"] == 2
        for axis in ("data", "tensor"):
            np.testing.assert_allclose(r[axis], worlds["gpt"], atol=1e-4)


def test_grad_accum_splits_each_ranks_rows(worlds):
    """``grad_accum=2`` on {"data": 2}: the same loss and ``grad_norm`` as the
    one-microbatch step (a classifier's rows weigh alike), and as JAX's step."""
    want = worlds["bert"][0]
    for r in _results(worlds, 2, "grad_accum"):
        assert abs(r["two"]["loss"] - r["one"]["loss"]) <= 1e-6 and abs(r["two"]["loss"] - want["loss"]) <= 1e-6
        np.testing.assert_allclose(r["two"]["grad_norm"], r["one"]["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(r["two"]["grad_norm"], want["grad_norm"], rtol=1e-5)


def test_ragged_tail_wraps_real_rows_as_jax(worlds):
    got = _results(worlds, 2, "ragged")
    want = worlds["ragged"]
    assert [len(b["y"]) for b in want] == [6, 6, 4]
    for i, batch in enumerate(want):
        for key in ("x", "y"):
            assert np.array_equal(np.concatenate([g["batches"][i][key] for g in got]), batch[key])


# ------------------------------------------------------------------ dropout


def test_dropout_masks_differ_over_data_and_agree_over_tensor(worlds):
    """Every rank fed the same rows: the two data ranks draw distinct masks, the
    two ranks of one tensor group identical ones (the activation at every
    dropout site is replicated there)."""
    got = _results(worlds, 2, "dropout")
    assert len(got[0]["data"]) == len(got[0]["tensor"]) > 2
    assert all(a != b for a, b in zip(got[0]["data"], got[1]["data"]))
    assert got[0]["tensor"] == got[1]["tensor"]


@pytest.mark.parametrize("axes", [{"data": 1}, {"fsdp": 1}, {"data": 1, "tensor": 1}],
                         ids=["data", "fsdp", "data-tensor"])
def test_world_of_one_mesh_is_bitwise_the_unmeshed_step(axes):
    """Dropout on, three steps: a mesh whose axes each span one rank (a real
    gloo world of one) exchanges nothing and computes bit for bit what the
    unmeshed step does, parameters and moments included."""
    from unionml_tpu_torch.checkpoint import extract_state
    from unionml_tpu_torch.models import BertConfig, create_train_state, make_classifier_train_step

    cfg = BertConfig.tiny(dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in ranks.bert_batch().items()}

    def run(mesh):
        state = create_train_state(init_bert(cfg, seed=0, device="cpu"), learning_rate=1e-3)
        spec = ranks.bert_specs(state, mesh) if mesh is not None else None
        step = make_classifier_train_step(mesh=mesh, param_spec=spec, input_signature=ranks.SIG)
        history = []
        for _ in range(3):
            state, metrics = step(state, batch)
            history.append({k: float(v) for k, v in metrics.items()})
        return history, extract_state(state)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the same CPU kernels (their split over threads) in both runs
    try:
        want_history, want = run(None)
        with ranks.gloo_world_of_one(_free_port()):
            history, got = run(tmesh.make_mesh(axes, device="cpu"))
    finally:
        torch.set_num_threads(threads)
    assert history == want_history
    for group in ("params", "mu", "nu"):
        for name, value in want[group].items():
            assert torch.equal(got[group][name], value), (group, name)


# ------------------------------------------------------------------ checkpoint and template


def test_sharded_checkpoint_resumes_bitwise_and_keeps_layout(worlds):
    """Under {"fsdp": 2}: a fit killed by SIGTERM (the flush lands the second
    step's checkpoint, exit 143) and resumed ends bitwise in the state of the
    same steps uninterrupted; a restore into a laid-out target fills each
    rank's shard and keeps the target's layout (``test_checkpoint.py:59``)."""
    for r in _results(worlds, 2, "checkpoint"):
        assert r["exit_code"] == 143 and r["latest"] == 2
        assert r["resumed_steps"] == r["resumed_step"] == 4
        assert r["bitwise"]
        assert r["layout_kept"] and r["restored_step"] == 2 and r["shards_equal"]


def test_data_parallel_template_trains_to_the_jax_templates_accuracy(worlds):
    """The rendered ``data-parallel`` template in a gloo world of 2 against the
    JAX template on its 8-device mesh: the same data and recipe, each from its
    own seeded weights."""
    want = worlds["template"]
    for r in _results(worlds, 2, "template"):
        got = r["metrics"]
        assert set(got) == set(want)
        for split in want:
            assert abs(got[split] - want[split]) <= 0.05, (split, got, want)
