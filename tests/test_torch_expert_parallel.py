"""Expert parallelism (``parallel/ep.py``'s ``moe_apply``, ``moe_apply_a2a``
and ``moe_apply_topk(mesh=)``, ``MoEMlp`` over a mesh, the sparse GPT
trained through ``fit_lm`` over data×expert, its checkpoint, and sparse
blocks served under a tensor mesh) on gloo worlds of 2 and 4 ranks against
the JAX package on meshes over the first 2 or 4 of its 8 CPU devices.

One spawn per world for the module: the ranks (``tests/torch_ep_ranks.py``,
which imports no JAX) run every scenario with one intra-op thread each,
while this process computes the JAX references (jitted). The world of 2
lays ``{"expert": 2}`` (and ``{"data": 2}``, ``{"data": 1, "expert": 2}``,
``{"tensor": 2}`` for its scenarios), the world of 4 ``{"data": 2,
"expert": 2}``. Tolerances (f32):

- the ops against JAX (``test_parallel.py:256``, ``:359-449``): outputs
  2e-5, gradients 2e-4; ``moe_apply_a2a`` drops exactly the choices JAX
  drops (the per-source survivors are counted, and the global routing's
  kept set is JAX's global cumsum's);
- ``MoEMlp``: a2a against gshard at ample capacity (``test_moe_layer.py:70``)
  and gshard on the mesh against the unmeshed layer on the whole batch
  (capacity 8 and 1): outputs and router losses 2e-5 (the z-loss a mean
  over the rank's rows, averaged over the data ranks), gradients 2e-4;
- ``fit_lm`` (packed, router losses on): each logged loss within 1e-4
  relative of JAX's ``fit_lm`` on the same mesh (the data-mesh case, with
  and without ``remat``, within the sharded-training tests' 1e-5); the
  first batch's gradients within 1e-4 of each leaf's largest magnitude;
  the parameters after within the sharded-training tests' allowance; the
  leaves outside the experts bitwise equal on every rank;
- the checkpoint of ``{"data": 1, "expert": 2}`` restores into the unmeshed
  model bitwise; the tensor-meshed sparse streams equal JAX's greedy tokens.
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
from jax.sharding import Mesh

from tests import torch_ep_ranks as ranks
from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models import moe as jmoe
from unionml_tpu.models import training as jtraining
from unionml_tpu.parallel import ep as jep
from unionml_tpu_torch.models import GPTConfig, gpt_grads_to_jax, params_from_jax, random_params

WORLDS = (2, 4)
#: how long the module waits for a world (each rank exits on its own at 170 s)
WAIT_S = 180.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_mesh(world: int, axes=None) -> Mesh:
    devices = np.array(jax.devices()[:world])
    if axes is not None:
        return Mesh(devices, axes)
    return Mesh(devices, ("expert",)) if world == 2 else Mesh(devices.reshape(2, 2), ("data", "expert"))


def _jfn(w, t):
    return t @ w


def _jax_ops(world: int):
    """JAX's ops on the world's mesh: outputs and gradients of ``sum(out *
    cotangent)``, the dense oracle of the a2a cases, and the global keep."""
    mesh = _jax_mesh(world)
    out = {}
    case = {k: jnp.asarray(v) for k, v in ranks.op_case("moe_apply").items()}

    def moe_apply(w, t):
        o = jep.moe_apply(_jfn, w, t, case["assignment"], mesh)
        return jnp.sum(o * case["cotangent"]), o

    (_, o), grads = jax.jit(jax.value_and_grad(moe_apply, argnums=(0, 1), has_aux=True))(case["w"], case["tokens"])
    out["moe_apply"] = {"out": np.asarray(o), "grad_w": np.asarray(grads[0]), "grad_tokens": np.asarray(grads[1])}

    def sharded(name, fn):
        case = {k: jnp.asarray(v) for k, v in ranks.op_case(name).items()}
        gates = jax.nn.softmax(case["logits"], axis=-1)

        def loss(w, t, g):
            o = fn(w, t, g)
            return jnp.sum(o * case["cotangent"]), o

        (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(case["w"], case["tokens"],
                                                                                          gates)
        return {"out": np.asarray(o), "grads": [np.asarray(g) for g in grads], "case": case, "gates": gates}

    for name, (k, cf, norm) in ranks.A2A.items():
        rec = sharded(name, lambda w, t, g, k=k, cf=cf, norm=norm: jep.moe_apply_a2a(
            _jfn, w, t, g, mesh, k=k, capacity_factor=cf, normalize_gates=norm))
        case = rec.pop("case")
        rec["oracle"] = np.asarray(jep.moe_apply_topk(_jfn, case["w"], case["tokens"], rec.pop("gates"), None, k=k,
                                                      capacity_factor=None, normalize_gates=norm))
        out[f"a2a_{name}"] = rec
    k, cf, norm = ranks.TOPK
    rec = sharded("topk", lambda w, t, g: jep.moe_apply_topk(_jfn, w, t, g, mesh, k=k, capacity_factor=cf,
                                                             normalize_gates=norm))
    # the global choice-major cumsum's kept choices (ep.py:220-241)
    index = np.asarray(jax.lax.top_k(rec.pop("gates"), k)[1])
    rec.pop("case")
    tokens = index.shape[0]
    choice_major = np.eye(ranks.OP_E, dtype=np.int64)[index.T.reshape(-1)]
    position = ((np.cumsum(choice_major, axis=0) - choice_major) * choice_major).sum(-1).reshape(k, tokens).T
    rec["keep"] = position < int(np.ceil(tokens * k / ranks.OP_E * cf))
    out["topk"] = rec
    return out


def _jax_config(**overrides):
    return jgpt.GPTConfig.tiny(dtype=jnp.float32, attention_impl="xla", **dict(ranks.LM, **overrides))


def _jax_fit(params, mesh, **overrides):
    cfg = _jax_config(**overrides)
    model = jgpt.GPTLMHeadModel(cfg)
    state = jtraining.create_train_state(model, params, learning_rate=ranks.LR)
    result = jtraining.fit_lm(state, ranks.lm_corpus(), seq_len=ranks.SEQ, batch_size=ranks.ROWS, pack=True,
                              num_steps=ranks.FIT_STEPS, mesh=mesh, log_every=1, moe_aux=True)
    batch = {k: jnp.asarray(v) for k, v in ranks.first_batch().items()}

    def loss_fn(p):
        logits, sown = model.apply({"params": p}, batch["input_ids"], segment_ids=batch["segment_ids"],
                                   deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
                                   mutable=["intermediates"])
        return jmoe.collect_aux_losses(sown["intermediates"]) + jgpt.lm_loss(
            logits, batch["input_ids"], segment_ids=batch["segment_ids"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params["params"])
    whole = {n: t.numpy() for n, t in params_from_jax(_host(result.state.params)).items()}
    return {"losses": [h["loss"] for h in result.metrics_history], "params": whole, "loss": float(loss),
            "grads": _host(grads)}


def _jax_streams(params):
    """JAX's greedy ``generate`` of the requests in one batch of left-padded
    prompts (each row decodes as it would alone, ``gpt.py:883-886``)."""
    model = jgpt.GPTLMHeadModel(_jax_config(moe_capacity_factor=1.25))
    width = max(len(p) for p, _ in ranks.REQUESTS)
    ids = np.zeros((len(ranks.REQUESTS), width), np.int32)
    mask = np.zeros_like(ids)
    for i, (prompt, _) in enumerate(ranks.REQUESTS):
        ids[i, width - len(prompt):], mask[i, width - len(prompt):] = prompt, 1
    new = max(n for _, n in ranks.REQUESTS)
    tokens = np.asarray(jgpt.generate(model, params, jnp.asarray(ids), new, prompt_mask=jnp.asarray(mask)))
    return [[int(t) for t in tokens[i, width:width + n]] for i, (_, n) in enumerate(ranks.REQUESTS)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    # seeded numpy weights in JAX's layout feed both packages
    gpt_params = random_params(GPTConfig.tiny(**ranks.LM), seed=0, std=0.2)
    ctx = multiprocessing.get_context("spawn")
    procs, dirs = {}, {}
    for world in WORLDS:
        dirs[world] = tmp_path_factory.mktemp(f"ep{world}")
        port = _free_port()
        procs[world] = [ctx.Process(target=ranks.rank_main, args=(r, world, port, {"gpt_params": gpt_params},
                                                                   str(dirs[world])), daemon=True)
                        for r in range(world)]
        for p in procs[world]:
            p.start()
    # the references, while the worlds run
    out = {"ops": {w: _jax_ops(w) for w in WORLDS},
           "fit_a2a": _jax_fit(gpt_params, _jax_mesh(4), moe_dispatch="a2a", ep_mesh=_jax_mesh(4)),
           "fit_data": _jax_fit(gpt_params, _jax_mesh(2, ("data",))),
           "streams": _jax_streams(gpt_params)}
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


def _by_data(results, pick):
    """The whole array from each rank's rows (ranks of one data index hold the same)."""
    parts = {}
    for r in results:
        parts.setdefault(r["where"]["data"], pick(r))
    return np.concatenate([parts[d] for d in sorted(parts)])


def _experts_whole(results, pick):
    """A whole expert stack from each rank's experts, summed over data ranks."""
    parts = {}
    for r in results:
        e = r["where"]["expert"]
        parts[e] = parts.get(e, 0) + pick(r)
    return np.concatenate([parts[e] for e in sorted(parts)])


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=msg)


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("world", WORLDS)
def test_moe_apply_matches_jax(worlds, world):
    """``moe_apply`` over the mesh (``test_parallel.py:256``, ``:276``): the
    output on every rank and the gradients of the experts and the tokens."""
    want = worlds["ops"][world]["moe_apply"]
    got = _results(worlds, world, "ops")
    for r in got:
        _close(r["moe_apply"]["out"], want["out"], 2e-5)
        _close(r["moe_apply"]["grad_tokens"], want["grad_tokens"], 2e-4)
    # each rank's gradient of the whole stack reaches only its experts; the
    # data ranks hold the same tokens, so those of data index 0 make it whole
    _close(sum(r["moe_apply"]["grad_w"] for r in got if r["where"]["data"] == 0), want["grad_w"], 2e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(ranks.A2A))
def test_moe_apply_a2a_matches_jax(worlds, world, case):
    """``moe_apply_a2a`` with no drops (``:359``), k = 1 (``:387``) and
    per-source drops (``:409``): the reassembled output and the gradients of
    the experts, tokens and gates against JAX's, and the dense oracle where
    nothing drops."""
    want = worlds["ops"][world][f"a2a_{case}"]
    got = _results(worlds, world, "ops")
    out = _by_data(got, lambda r: r[f"a2a_{case}"]["out"])
    _close(out, want["out"], 2e-5, case)
    if case != "drops":
        _close(out, want["oracle"], 2e-5, case)
    _close(_experts_whole(got, lambda r: r[f"a2a_{case}"]["grads"][0]), want["grads"][0], 2e-4, case)
    for i in (1, 2):
        _close(_by_data(got, lambda r: r[f"a2a_{case}"]["grads"][i]), want["grads"][i], 2e-4, case)
    if case == "drops":
        # one shard per (data, expert) rank; each keeps its first `capacity` tokens of expert 0
        shards = world
        live = np.abs(out).max(axis=-1) > 0
        per_shard = live.reshape(shards, -1)
        capacity = int(np.ceil(64 // shards / ranks.OP_E))
        assert (per_shard.sum(axis=1) == capacity).all() and per_shard[:, :capacity].all()


@pytest.mark.parametrize("world", WORLDS)
def test_moe_apply_topk_over_the_mesh_routes_globally(worlds, world):
    """``moe_apply_topk(mesh=)`` at capacity 1.0 (drops): JAX's global
    routing's kept choices exactly, the output and the gradients."""
    want = worlds["ops"][world]["topk"]
    got = _results(worlds, world, "ops")
    keep = _by_data(got, lambda r: r["topk_keep"])
    assert np.array_equal(keep, want["keep"]) and not keep.all()
    _close(_by_data(got, lambda r: r["topk"]["out"]), want["out"], 2e-5)
    _close(_experts_whole(got, lambda r: r["topk"]["grads"][0]), want["grads"][0], 2e-4)
    for i in (1, 2):
        _close(_by_data(got, lambda r: r["topk"]["grads"][i]), want["grads"][i], 2e-4)


# ------------------------------------------------------------------ the layer


@pytest.mark.parametrize("world", WORLDS)
def test_moe_mlp_dispatches_agree(worlds, world):
    """``MoEMlp``: a2a equals gshard on the mesh at capacity 8
    (``test_moe_layer.py:70``), and gshard on the mesh equals the unmeshed
    layer on the whole batch at capacity 8 and 1 (``:79``; global routing
    and the global balance loss): outputs, router losses, and the gradients
    of ``sum(out**2)`` by the router, the experts and the rows (each rank's
    share, summed over the data ranks where they are every rank's)."""
    got = _results(worlds, world, "layer")
    for r in got:
        a2a, gshard = r["a2a_8.0"], r["gshard_8.0"]
        _close(a2a["out"], gshard["out"], 2e-5)
        assert a2a["aux"] == pytest.approx(gshard["aux"], abs=2e-5)
        for a, b in zip(a2a["grads"], gshard["grads"]):
            _close(a, b, 2e-4)
    for cf in ("8.0", "1.0"):
        whole = got[0][f"unmeshed_{cf}"]
        _close(_by_data(got, lambda r: r[f"gshard_{cf}"]["out"]), whole["out"], 2e-5, cf)
        first = [r for r in got if r["where"]["expert"] == 0]
        # the balance loss is the global batch's on every rank; the z-loss a
        # mean over the rank's rows (the step's mean over the data ranks is the global one)
        for r in got:
            assert abs(r[f"gshard_{cf}"]["aux"]["load_balancing_loss"] - whole["aux"]["load_balancing_loss"]) <= 2e-5
        z = np.mean([r[f"gshard_{cf}"]["aux"]["router_z_loss"] for r in first])
        assert abs(z - whole["aux"]["router_z_loss"]) <= 2e-5 * max(1.0, abs(z))
        for i in (0, 1):  # the router: each data rank's rows' part
            _close(sum(r[f"gshard_{cf}"]["grads"][i] for r in first), whole["grads"][i], 2e-4, cf)
        for i in (2, 3):
            _close(_experts_whole(got, lambda r: r[f"gshard_{cf}"]["grads"][i]), whole["grads"][i], 2e-4, cf)
        _close(_by_data(got, lambda r: r[f"gshard_{cf}"]["grads"][4]), whole["grads"][4], 2e-4, cf)


# ------------------------------------------------------------------ training


def _close_grads(got, want, msg=""):
    for name, value in want.items():
        err = float(np.abs(got[name] - value).max())
        assert err <= 1e-4 * float(np.abs(value).max()) + 1e-7, (msg, name, err)


def _port_grads(results, arm):
    """The step's whole gradients: leaves outside the experts from rank 0,
    each expert stack from its ranks (of data index 0: reduced already)."""
    grads = dict(results[0][arm]["grads"])
    for name in grads:
        if name.endswith(("moe_mlp.w_in", "moe_mlp.w_out")):
            parts = {r["where"]["expert"]: r[arm]["grads"][name] for r in results if r["where"]["data"] == 0}
            grads[name] = np.concatenate([parts[e] for e in sorted(parts)])
    return grads


def _whole_params(results, arm):
    params = dict(results[0][arm]["params"])
    for name in params:
        if name.endswith(("moe_mlp.w_in", "moe_mlp.w_out")):
            parts = {r["where"]["expert"]: r[arm]["params"][name] for r in results if r["where"]["data"] == 0}
            params[name] = np.concatenate([parts[e] for e in sorted(parts)])
    return params


def _close_params(got, want, steps=ranks.FIT_STEPS):
    """Within 1e-4 of each leaf's largest magnitude; a 1-D leaf within that
    or 1e-3 of the steps' summed learning rate; the key third of the qkv
    bias (true gradient 0) within 2.5 learning rates a step."""
    for name, value in want.items():
        err = np.abs(np.asarray(got[name]) - value)
        if name.endswith("qkv.bias"):
            third = value.shape[0] // 3
            assert float(err[third:2 * third].max()) <= 2.5 * ranks.LR * steps, name
            err = np.concatenate([err[:third], err[2 * third:]])
        limit = 1e-4 * float(np.abs(value).max())
        if value.ndim == 1:
            limit = max(limit, 1e-3 * ranks.LR * steps)
        assert float(err.max()) <= limit, (name, float(err.max()), limit)


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(value)


def _check_fit(results, arm, want, loss_rtol):
    for r in results:
        assert len(r[arm]["losses"]) == len(want["losses"]) == ranks.FIT_STEPS - 1
        np.testing.assert_allclose(r[arm]["losses"], want["losses"], rtol=loss_rtol, atol=0, err_msg=arm)
        assert abs(r[arm]["loss"] - want["loss"]) <= loss_rtol * abs(want["loss"])
    got = dict(_leaves(gpt_grads_to_jax(_port_grads(results, arm))))
    _close_grads(got, dict(_leaves(want["grads"])), arm)
    _close_params(_whole_params(results, arm), want["params"])
    # every rank holds the same leaves outside the experts, bit for bit
    first = results[0][arm]["params"]
    for r in results[1:]:
        for name, value in r[arm]["params"].items():
            if not name.endswith(("moe_mlp.w_in", "moe_mlp.w_out")):
                assert np.array_equal(value, first[name]), (arm, name, r["where"])


@pytest.mark.parametrize("arm", ["a2a", "gshard"])
def test_fit_lm_over_data_and_expert_matches_jax(worlds, arm):
    """``fit_lm(pack=True, moe_aux=True)`` on ``{"data": 2, "expert": 2}``
    at capacity 1.0: ``moe_dispatch="a2a"`` against JAX's a2a ``fit_lm`` on
    its 4-device mesh, ``"gshard"`` with ``ep_mesh`` against JAX's ``fit_lm``
    on ``{"data": 2}`` (XLA routes the global batch as the unmeshed model
    does): the logged losses, the first batch's gradients, the parameters
    after, and the leaves outside the experts bitwise on every rank."""
    want = worlds["fit_a2a" if arm == "a2a" else "fit_data"]
    _check_fit(_results(worlds, 4, "fit"), arm, want, 1e-4)
    # per-source capacity drops otherwise than the global one
    assert abs(worlds["fit_a2a"]["losses"][0] - worlds["fit_data"]["losses"][0]) > 1e-3


@pytest.mark.parametrize("arm", ["gshard", "gshard_remat"])
def test_fit_lm_on_a_data_mesh_routes_globally(worlds, arm):
    """ROADMAP Queue 3: the sparse GPT (gshard, no ``ep_mesh``) on
    ``{"data": 2}`` at a capacity that drops choices against JAX's
    ``fit_lm(mesh={"data": 2})`` at the sharded-training tests' 1e-5, also
    with ``remat`` (each block's recompute in the backward pass routes over
    the group the layout bound to it, as its forward did). Before the
    global routing each rank took its capacity and slots from its own
    tokens and its balance loss from its own means (scaled by its loss
    weight): the logged losses read 4.6664, 5.0198, 4.9713 against JAX's
    4.7779, 4.8355, 5.0963."""
    _check_fit(_results(worlds, 2, "data_mesh"), arm, worlds["fit_data"], 1e-5)


def test_checkpoint_of_split_experts_restores_unmeshed(worlds):
    """Two a2a steps on ``{"data": 1, "expert": 2}`` with step checkpoints:
    each rank held half of every expert stack, the checkpoint holds whole
    leaves, and it restores into the unmeshed model bitwise equal to the
    gathered state."""
    got = _results(worlds, 2, "checkpoint")
    whole, local = got[0]["whole_shapes"], got[0]["local_shapes"]
    assert got[0]["equal"] == {"params": True, "mu": True, "nu": True} and got[0]["step"] == 2
    name = "layers.0.moe_mlp.w_in"
    assert local[name][0] * 2 == whole[name][0] == ranks.OP_E and got[1]["local_shapes"] == local


def test_sparse_gpt_under_a_tensor_mesh_streams_jax_greedy_tokens(worlds):
    """The sparse GPT served by ``DecodeEngine``/``SpeculativeEngine(mesh=
    {"tensor": 2})``: each rank holds half of every expert's hidden width,
    and the greedy streams equal JAX's ``generate``."""
    got = _results(worlds, 2, "tensor")
    assert got[0]["streams"] == worlds["streams"] and got[0]["speculative"] == worlds["streams"]
    assert got[0]["rounds"] > 0 and got[0]["hidden"] == 4 * ranks.LM["hidden_size"] // 2
    assert all(r["streams"]["followed"] > 0 for r in got[1:])


@pytest.mark.parametrize("case", ["dense", "topk"])
def test_in_process_a2a_of_four_blocks_matches_jax(case):
    """``chip_smoke.py`` phase 25's seam, ``_in_process_moe_a2a``: the a2a's
    arithmetic over 4 token blocks in one process (the exchanges moved in
    memory) against JAX's ``moe_apply_a2a`` on ``{"expert": 4}``, and
    against the per-block one-hot plain version (each block routed at its
    own capacity): at ample capacity and at 1.0, where sources drop."""
    from unionml_tpu_torch.parallel.ep import _in_process_moe_a2a, reference_moe_apply_topk

    k, cf, norm = (2, 16.0, True) if case == "dense" else ranks.TOPK
    data = ranks.op_case(case)
    gates = jax.nn.softmax(jnp.asarray(data["logits"]), axis=-1)
    want = np.asarray(jax.jit(lambda w, t, g: jep.moe_apply_a2a(_jfn, w, t, g, _jax_mesh(4, ("expert",)), k=k,
                                                                capacity_factor=cf, normalize_gates=norm))(
        jnp.asarray(data["w"]), jnp.asarray(data["tokens"]), gates))
    w, tokens = torch.from_numpy(data["w"]), torch.from_numpy(data["tokens"])
    tgates = torch.softmax(torch.from_numpy(data["logits"]), dim=-1)
    got = _in_process_moe_a2a(ranks._bmm, w, tokens, tgates, 4, k=k, capacity_factor=cf, normalize_gates=norm)
    _close(got.numpy(), want, 2e-5)
    plain = torch.cat([reference_moe_apply_topk(ranks._bmm, w, t, g, k=k, capacity_factor=cf, normalize_gates=norm)
                       for t, g in zip(tokens.chunk(4), tgates.chunk(4))])
    _close(got.numpy(), plain.numpy(), 2e-5)
    if case == "topk":  # sources drop: the global routing keeps more than the per-source one
        whole = reference_moe_apply_topk(ranks._bmm, w, tokens, tgates, k=k, capacity_factor=cf,
                                         normalize_gates=norm)
        assert float((whole - got).abs().max()) > 1e-3
