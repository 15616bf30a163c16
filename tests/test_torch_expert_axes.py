"""Experts split over an ``expert`` axis beside ``fsdp``, ``tensor`` and
``sequence``: the sparse GPT (``tests/torch_ep_ranks.py``'s: 8 experts,
top-2, capacity 1.0, router losses on) trained through ``fit_lm`` on
``{"expert": 2, "fsdp": 2}``, ``{"expert": 2, "tensor": 2}`` and
``{"expert": 2, "sequence": 2}`` (ring, unpacked rows) under both
dispatches, its checkpoint, and ``DecodeEngine`` over ``{"expert": 2,
"tensor": 2}``, on one gloo world of 4 against the JAX package on the same
composed meshes of its 8 CPU devices.

One spawn for the module: the ranks (``tests/torch_xp_axes_ranks.py``, which
imports no JAX) run every scenario with one intra-op thread each, while this
process computes the JAX references (jitted), the parameters laid out by
``param_shardings``. Seeded numpy weights in JAX's layout feed both
packages. Tolerances, those of ``tests/test_torch_expert_parallel.py``
(f32): each logged loss and the first batch's loss within 1e-4 relative;
the first batch's gradients within 1e-4 of each leaf's largest magnitude;
the parameters after within the sharded-training tests' allowance; the
leaves outside the experts bitwise on every rank of ``expert``; kept
choices exactly (the a2a's per source shard, JAX's ``P((data, expert))``
blocks of the flattened batch; gshard's the global batch's); greedy streams
identical; checkpoints bitwise.
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

from tests import torch_xp_axes_ranks as ranks
from tests.test_torch_expert_parallel import _close_grads, _close_params, _jax_streams, _leaves
from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models import moe as jmoe
from unionml_tpu.models import training as jtraining
from unionml_tpu.parallel import ep as jep
from unionml_tpu.parallel import make_mesh as jax_make_mesh
from unionml_tpu_torch.models import GPTConfig, gpt_grads_to_jax, params_from_jax, random_params

#: how long the module waits for the world (each rank exits on its own at 170 s)
WAIT_S = 180.0
AXES = [str(axes) for axes in ranks.AXES]
EXPERT_LEAVES = ("moe_mlp.w_in", "moe_mlp.w_out")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_config(axes, mesh, dispatch):
    ring = dict(attention_impl="ring", sp_mesh=mesh) if "sequence" in axes else dict(attention_impl="xla")
    return jgpt.GPTConfig.tiny(dtype=jnp.float32, moe_dispatch=dispatch, ep_mesh=mesh, **ring, **ranks.LM)


def _jax_arm(params, axes, dispatch):
    """JAX's ``fit_lm`` of the sparse GPT on ``axes`` (its parameters laid out
    by ``param_shardings``) and the gradients of the first batch's loss plus
    router losses on that mesh."""
    mesh = jax_make_mesh(axes, devices=jax.devices()[:4])
    model = jgpt.GPTLMHeadModel(_jax_config(axes, mesh, dispatch))
    spec = jgpt.param_shardings(params["params"], mesh.axis_names)
    laid = jax.tree_util.tree_map(lambda x, s: jax.device_put(x, JaxNamedSharding(mesh, s)), params["params"], spec)
    pack = ranks.packed(axes)
    batch = {k: jnp.asarray(v) for k, v in ranks.first_batch(pack).items()}

    def loss_fn(p):
        segments = batch.get("segment_ids")
        logits, sown = model.apply({"params": p}, batch["input_ids"], segment_ids=segments, deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["intermediates"])
        return jmoe.collect_aux_losses(sown["intermediates"]) + jgpt.lm_loss(logits, batch["input_ids"],
                                                                            segment_ids=segments)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(laid)
    # fit_lm donates the state: the gradients are taken first
    state = jtraining.create_train_state(model, {"params": laid}, learning_rate=ranks.LR)
    result = jtraining.fit_lm(state, ranks.lm_corpus(), seq_len=ranks.SEQ, batch_size=ranks.ROWS, pack=pack,
                              num_steps=ranks.FIT_STEPS, mesh=mesh, log_every=1, moe_aux=True)
    whole = {n: t.numpy() for n, t in params_from_jax(_host(result.state.params)).items()}
    return {"losses": [h["loss"] for h in result.metrics_history], "params": whole, "loss": float(loss),
            "grads": _host(grads)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    params = random_params(GPTConfig.tiny(**ranks.LM), seed=0, std=0.2)
    out_dir = tmp_path_factory.mktemp("xp_axes")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=ranks.rank_main, args=(r, 4, port, {"params": params}, str(out_dir)), daemon=True)
             for r in range(4)]
    for p in procs:
        p.start()
    # the references, while the world runs
    out = {"jax": {(str(axes), d): _jax_arm(params, axes, d) for axes in ranks.AXES for d in ranks.DISPATCHES},
           "streams": _jax_streams(params)}
    torch.set_num_threads(threads)
    deadline = time.monotonic() + WAIT_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
    files = [Path(out_dir, f"rank{r}.pkl") for r in range(4)]
    out["ranks"] = [pickle.loads(f.read_bytes()) if f.exists() else None for f in files]
    return out


def _results(world, name):
    got = world["ranks"]
    assert all(r is not None for r in got), "a rank of the world of 4 wrote nothing (hung or crashed)"
    for r, res in enumerate(got):
        assert "error" not in res[name], f"rank {r}, {name}:\n{res[name]['error']}"
    return [res[name] for res in got]


def _arms(world, axes, arm):
    return [(r[axes]["where"], r[axes][arm]) for r in _results(world, "fit")]


def _jax_keep(gates, k, capacity_factor):
    """JAX's kept choices of one routing call (``_topk_dispatch_combine``'s
    choice-major cumsum, ``lax.top_k``'s ties) at the gates' own capacity."""
    tokens, experts = gates.shape
    index = np.asarray(jax.lax.top_k(jnp.asarray(gates), k)[1])
    choice_major = np.eye(experts, dtype=np.int64)[index.T.reshape(-1)]
    position = ((np.cumsum(choice_major, axis=0) - choice_major) * choice_major).sum(-1).reshape(k, tokens).T
    return position < max(int(np.ceil(tokens * k / experts * capacity_factor)), 1)


def _assemble(pieces):
    """The whole ``(rows, seq, ...)`` array from each rank's ``(where, (rows
    of its block, its chunk, ...))`` (ranks of one block and chunk hold the same)."""
    data = {}
    for where, piece in pieces:
        data.setdefault(where["rows"], {})[where["seq"]] = piece
    return np.concatenate([np.concatenate([data[b][c] for c in sorted(data[b])], axis=1) for b in sorted(data)])


# ------------------------------------------------------------------ training


@pytest.mark.parametrize("dispatch", ranks.DISPATCHES)
@pytest.mark.parametrize("axes", AXES)
def test_fit_lm_losses_match_jax(world, axes, dispatch):
    """``fit_lm(moe_aux=True)`` with ``ep_mesh`` the step's mesh and
    ``param_spec=param_shardings``: every rank's logged losses and its
    first-batch loss within 1e-4 relative of JAX's ``fit_lm`` on the same
    mesh. The stacks lie as JAX's specs lay them: FSDP2 on the fsdp mesh, a
    rank's hidden columns on the tensor mesh, whole on the sequence mesh."""
    want = world["jax"][axes, dispatch]
    for where, arm in _arms(world, axes, dispatch):
        assert len(arm["losses"]) == len(want["losses"]) > 0
        np.testing.assert_allclose(arm["losses"], want["losses"], rtol=1e-4, atol=0, err_msg=str(where))
        assert abs(arm["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"]), where
        assert arm["fsdp"] == ("fsdp" in axes) and (arm["tensor_split"] > 0) == ("tensor" in axes)
        assert arm["expert_split"] == 4  # both sparse blocks' two stacks
    if dispatch == "a2a":  # per-source capacity drops otherwise than the global one
        assert abs(want["losses"][0] - world["jax"][axes, "gshard"]["losses"][0]) > 1e-3


@pytest.mark.parametrize("dispatch", ranks.DISPATCHES)
@pytest.mark.parametrize("axes", AXES)
def test_first_batch_gradients_match_jax(world, axes, dispatch):
    """The first batch's gradients (LM loss plus router losses), gathered
    whole from every rank's shards, within 1e-4 of each leaf's largest
    magnitude of JAX's on the same mesh."""
    want = dict(_leaves(world["jax"][axes, dispatch]["grads"]))
    for where, arm in _arms(world, axes, dispatch):
        got = dict(_leaves(gpt_grads_to_jax({n: torch.from_numpy(g) for n, g in arm["grads"].items()})))
        _close_grads(got, want, f"{axes} {dispatch} {where}")


@pytest.mark.parametrize("dispatch", ranks.DISPATCHES)
@pytest.mark.parametrize("axes", AXES)
def test_parameters_after_match_jax(world, axes, dispatch):
    """The parameters after ``fit_lm``, gathered whole, within the
    sharded-training allowance of JAX's; every rank of ``expert`` holds the
    same shards of the leaves outside the experts, bit for bit."""
    arms = _arms(world, axes, dispatch)
    for _, arm in arms:
        _close_params(arm["params"], world["jax"][axes, dispatch]["params"], steps=ranks.FIT_STEPS)
    peers = {}
    for where, arm in arms:
        peers.setdefault((where["fsdp"], where["tensor"]), []).append(arm["local"])
    assert all(len(p) >= 2 for p in peers.values())
    for first, *others in peers.values():
        for name, value in first.items():
            if not name.endswith(EXPERT_LEAVES):
                assert all(np.array_equal(value, other[name]) for other in others), (axes, dispatch, name)


@pytest.mark.parametrize("axes", AXES)
def test_a2a_keeps_jax_per_source_choices(world, axes):
    """The a2a's routing on each mesh: rank ``e`` routes JAX's block ``e`` of
    the flattened ``(B, S)`` batch (layer 0's gates, assembled over the
    expert ranks, are the unmeshed model's on the whole batch, in that
    order), and every layer keeps exactly the choices JAX's routing keeps
    at one source shard's capacity, some of them dropped."""
    arms = _arms(world, axes, "a2a")
    unmeshed = _results(world, "unmeshed")[0][ranks.packed(ranks.AXES[AXES.index(axes)])]
    layers = len(arms[0][1]["log"])
    assert layers == 2
    dropped = 0
    for layer in range(layers):
        shards = {}
        for where, arm in arms:
            shards.setdefault(where["expert"], arm["log"][layer])
            assert np.array_equal(shards[where["expert"]]["keep"], arm["log"][layer]["keep"])
        for call in shards.values():
            want = _jax_keep(call["gates"], ranks.LM["moe_k"], ranks.LM["moe_capacity_factor"])
            assert np.array_equal(call["keep"], want), (axes, layer)
            dropped += int((~want).sum())
        if layer == 0:
            gates = np.concatenate([shards[e]["gates"] for e in sorted(shards)])
            np.testing.assert_allclose(gates, unmeshed[0]["gates"], atol=1e-5, rtol=0)
    assert dropped > 0


@pytest.mark.parametrize("axes", AXES)
def test_gshard_keeps_the_global_choices(world, axes):
    """gshard's routing on each mesh: every layer keeps exactly the choices
    the unmeshed model keeps on the whole batch (JAX's global choice-major
    order over the rows' blocks and chunks), some of them dropped."""
    arms = _arms(world, axes, "gshard")
    unmeshed = _results(world, "unmeshed")[0][ranks.packed(ranks.AXES[AXES.index(axes)])]
    rows, seq, k = ranks.ROWS, ranks.SEQ, ranks.LM["moe_k"]
    assert len(unmeshed) == 2 and not all(call["keep"].all() for call in unmeshed)
    for layer, call in enumerate(unmeshed):
        pieces = [(w, arm["log"][layer]["keep"].reshape(rows // w["rows_size"], seq // w["seq_size"], k))
                  for w, arm in arms]
        assert np.array_equal(_assemble(pieces), call["keep"].reshape(rows, seq, k)), (axes, layer)


def test_remat_on_expert_and_sequence_matches_jax(world):
    """``remat=True`` with the a2a on ``{"expert": 2, "sequence": 2}``: each
    block's recompute in the backward pass gathers and routes as its
    forward did; the losses, gradients and parameters after are JAX's."""
    axes, dispatch = ranks.REMAT
    want = world["jax"][axes, dispatch]
    grads = dict(_leaves(want["grads"]))
    for where, arm in [(r[axes]["where"], r[axes]["remat"]) for r in _results(world, "fit")]:
        np.testing.assert_allclose(arm["losses"], want["losses"], rtol=1e-4, atol=0)
        _close_grads(dict(_leaves(gpt_grads_to_jax({n: torch.from_numpy(g) for n, g in arm["grads"].items()}))),
                     grads, f"remat {where}")
        _close_params(arm["params"], want["params"], steps=ranks.FIT_STEPS)


@pytest.mark.parametrize("arm", [f"{a} {d}" for a, d in ranks.CHECKPOINTED])
def test_checkpoint_of_composed_split_restores_bitwise(world, arm):
    """The step checkpoints of a composed split (FSDP2 shards of a rank's
    experts; a rank's experts at its hidden columns) hold whole leaves: they
    restore into the unmeshed model bitwise equal to the gathered state, and
    back onto the same mesh, each shard the saved leaf cut by the layout."""
    axes, dispatch = arm.rsplit(" ", 1)
    got = [r[axes][dispatch]["checkpoint"] for r in _results(world, "fit")]
    assert got[0]["unmeshed"] == {"step": ranks.FIT_STEPS, "equal": {"params": True, "mu": True, "nu": True}}
    name = "layers.0.moe_mlp.w_in"
    whole, local = got[0]["whole_shapes"][name], got[0]["local_shapes"][name]
    assert whole == (8, 32, 128) and local[0] * 2 * (2 if "fsdp" in axes else 1) == whole[0]
    assert local[2] * (2 if "tensor" in axes else 1) == whole[2]
    for r in got:
        assert r["meshed"] == {"step": ranks.FIT_STEPS, "layout_kept": True, "shards_equal": True}


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("layout", ["cut", "held"])
def test_decode_engine_over_expert_and_tensor_streams_jax_greedy_tokens(world, layout):
    """``DecodeEngine(mesh={"expert": 2, "tensor": 2})``: a rank holds 4 of
    the 8 experts at half their hidden width (cut by the serving mesh, or
    held by an ``ep_mesh`` model), the dropless blocks' partials are summed
    over expert×tensor, and rank 0's greedy streams equal JAX's ``generate``
    and the unmeshed engine's."""
    got = _results(world, "engine")
    assert got[0][layout]["streams"] == world["streams"] == got[0]["unmeshed"]
    assert all(r[layout]["shape"] == (4, 32, 64) and r[layout]["partial"] == 4 for r in got)
    assert all(r[layout]["streams"]["followed"] > 0 for r in got[1:])


# ------------------------------------------------------------------ the one-process seam


@pytest.mark.parametrize("pieces", [(2, 2), (4, 1)], ids=["expert2_tensor2", "expert4"])
@pytest.mark.parametrize("mode", ["gshard", "a2a", "dropless"])
def test_in_process_split_matches_jax(mode, pieces):
    """``chip_smoke.py`` phase 28's seam, ``_in_process_split``: the experts
    cut into (expert, tensor) pieces in one process, each piece's f32
    partial summed, against JAX's ``moe_apply_topk`` (capacity 1.0, and
    dropless) and ``moe_apply_a2a`` on ``{"expert": ep}`` (JAX's experts
    whole): outputs 2e-5 and the gradients of the experts, tokens and gates
    2e-4 (``tests/test_torch_expert_parallel.py``'s op bounds)."""
    from unionml_tpu_torch.models.moe import _experts
    from unionml_tpu_torch.parallel.ep import _in_process_split

    ep, tp = pieces
    rng = np.random.default_rng(28)
    w = [(rng.normal(size=shape) * 0.3).astype(np.float32) for shape in ((8, 16, 32), (8, 32, 16))]
    tokens = rng.normal(size=(64, 16)).astype(np.float32)
    logits = rng.normal(size=(64, 8)).astype(np.float32) * 2
    cotangent = rng.normal(size=(64, 16)).astype(np.float32)
    cf = None if mode == "dropless" else 1.0

    def jfn(params, t):
        return jax.nn.gelu(t @ params[0]) @ params[1]

    def jloss(w_in, w_out, t, g):
        if mode == "a2a":
            mesh = jax_make_mesh({"expert": ep}, devices=jax.devices()[:ep])
            out = jep.moe_apply_a2a(jfn, (w_in, w_out), t, g, mesh, k=2, capacity_factor=cf)
        else:
            out = jep.moe_apply_topk(jfn, (w_in, w_out), t, g, None, k=2, capacity_factor=cf)
        return jnp.sum(out * cotangent), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *w, tokens, jax.nn.softmax(jnp.asarray(logits), axis=-1))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (*w, tokens)]
    gates = torch.softmax(torch.from_numpy(logits), dim=-1).detach().requires_grad_()
    got = _in_process_split(_experts, tuple(leaves[:2]), leaves[2], gates, ep, tp, k=2, capacity_factor=cf,
                            dispatch="a2a" if mode == "a2a" else "gshard")
    grads = torch.autograd.grad((got * torch.from_numpy(cotangent)).sum(), (*leaves, gates))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-4 * max(1.0, float(np.abs(jg).max())), rtol=0)


# ------------------------------------------------------------------ repaired on the way


@pytest.mark.parametrize("axes", [{"fsdp": 1}, {"expert": 1, "fsdp": 1}], ids=["fsdp", "expert_fsdp"])
def test_bf16_sparse_gpt_trains_under_fsdp2(axes):
    """ROADMAP Queue 3: a bf16 sparse GPT (its expert stacks bf16 parameters,
    the rest f32, as flax makes them) under FSDP2 raised FSDP2's "uniform
    original parameter dtype" ``AssertionError`` in the port's first meshed
    step, where JAX's ``fit_lm`` trains it on an fsdp mesh. The router and
    the stacks are FSDP2 units of their own now: at a world of one rank the
    meshed ``fit_lm`` (with ``ep_mesh`` on the expert mesh) is bitwise the
    unmeshed one, losses and parameters."""
    from tests.torch_sharded_ranks import gloo_world_of_one
    from unionml_tpu_torch.models import create_train_state, fit_lm, gpt, init_gpt
    from unionml_tpu_torch.parallel import make_mesh
    from unionml_tpu_torch.parallel.mesh import axis_names

    rng = np.random.default_rng(3)
    corpus = [rng.integers(1, 512, int(n)).astype(np.int32) for n in rng.integers(4, 30, 24)]

    def run(mesh):
        config = GPTConfig.tiny(dtype=torch.bfloat16, dropout=0.0, moe_every=2, num_experts=4,
                                ep_mesh=mesh if mesh is not None and "expert" in axes else None)
        model = init_gpt(config, seed=0, device="cpu")
        spec = None if mesh is None else gpt.param_shardings(dict(model.named_parameters()), axis_names(mesh))
        result = fit_lm(create_train_state(model, learning_rate=1e-3), corpus, seq_len=32, batch_size=2,
                        num_steps=3, mesh=mesh, param_spec=spec, log_every=1, moe_aux=True)
        state = result.state
        params = [state.layout.gather(i, p) if state.layout is not None else p for i, p in enumerate(state.params)]
        return [h["loss"] for h in result.metrics_history], params, state

    with gloo_world_of_one(_free_port()):
        losses, params, state = run(make_mesh(axes, device="cpu"))
        assert state.layout.fsdp
        want_losses, want_params, _ = run(None)
    assert losses == want_losses and len(losses) == 2
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))
