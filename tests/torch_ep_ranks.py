"""The ranks of ``tests/test_torch_expert_parallel.py``: one process per rank
of a gloo world on the CPU, importing no JAX.

Every rank runs each scenario of its world in the same order and writes
what it saw to ``out_dir/rank{r}.pkl``: its coordinates on the scenario's
mesh, its share of each result (its rows' outputs, its experts' gradients)
and the values every rank holds alike. The parent reassembles them and
holds them against the JAX package. The inputs are made here from numpy
seeds, or come from the parent (weights in JAX's layout).
"""

import faulthandler
import pickle
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

#: the tiny sparse GPT of ``test_moe_layer.py:126`` (every block sparse, 8
#: experts, top-2), f32 and no dropout, at a capacity factor that drops
#: choices both globally and per source shard
LM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, max_position_embeddings=16, dropout=0.0,
          moe_every=1, num_experts=8, moe_k=2, moe_capacity_factor=1.0)
#: two 16-token rows a step: on {"data": 2, "expert": 2} each a2a block is
#: half a row (8 tokens), as in JAX's own test
SEQ, ROWS, FIT_STEPS, LR = 16, 2, 4, 1e-3
#: the op-level cases (``test_parallel.py:256``, ``:359``, ``:387``, ``:409``)
OP_E = 8
REQUESTS = [([3, 1, 4, 1, 5], 6), ([2, 7], 5), ([1, 8, 2, 8, 1, 8, 2, 8], 4), ([6], 6)]
ENGINE_KW = dict(num_slots=4, max_len=16, prefill_buckets=(8, 16), device="cpu")


# ------------------------------------------------------------------ data


def op_case(name: str) -> Dict[str, np.ndarray]:
    """Weights ``(E, d, d_out)``, tokens, gates and a cotangent of one
    op-level case, f32 numpy (every rank and the parent make the same)."""
    if name == "drops":  # every token wants expert 0: each source keeps its first `capacity`
        logits = np.full((64, OP_E), -1e9, np.float32)
        logits[:, 0] = 0.0
        return {"w": np.ones((OP_E, 4, 4), np.float32), "tokens": np.ones((64, 4), np.float32),
                "logits": logits, "cotangent": np.ones((64, 4), np.float32)}
    seed, d, d_out, t = {"dense": (5, 16, 12, 64), "k1": (6, 8, 8, 32), "topk": (7, 16, 12, 64),
                         "moe_apply": (1, 16, 12, 32)}[name]
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(OP_E, d, d_out)) * 0.3).astype(np.float32),
            "tokens": rng.normal(size=(t, d)).astype(np.float32),
            "logits": rng.normal(size=(t, OP_E)).astype(np.float32),
            "assignment": rng.integers(0, OP_E, size=(t,)).astype(np.int32),
            "cotangent": rng.normal(size=(t, d_out)).astype(np.float32)}


#: (k, capacity_factor, normalize_gates) of each a2a case
A2A = {"dense": (2, 16.0, True), "k1": (1, float(OP_E), False), "drops": (1, 1.0, False)}
TOPK = (2, 1.0, True)


def lm_corpus(seed: int = 3, n: int = 24):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, int(m)).astype(np.int32) for m in rng.integers(3, 20, n)]


def first_batch() -> Dict[str, np.ndarray]:
    """The first two packed rows of ``lm_corpus``: the gradient check's batch."""
    from unionml_tpu_torch.ops.packing import pack_sequences

    packed = pack_sequences(lm_corpus(), SEQ)
    return {k: packed[k][:ROWS] for k in ("input_ids", "segment_ids")}


def gpt_config(**overrides):
    from unionml_tpu_torch.models import GPTConfig

    return GPTConfig.tiny(dtype=torch.float32, **dict(LM, **overrides))


def coords(mesh) -> Dict[str, int]:
    from unionml_tpu_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS, axis_index, axis_size

    return {"data": axis_index(mesh, DATA_AXIS), "data_size": axis_size(mesh, DATA_AXIS),
            "expert": axis_index(mesh, EXPERT_AXIS), "expert_size": axis_size(mesh, EXPERT_AXIS)}


def rows(array: np.ndarray, where: Dict[str, int]) -> np.ndarray:
    """This rank's rows of ``array`` over the data axis."""
    n = array.shape[0] // where["data_size"]
    return np.ascontiguousarray(array[where["data"] * n:(where["data"] + 1) * n])


def mesh_of(world: int, **extra):
    from unionml_tpu_torch.parallel import make_mesh

    axes = {"expert": 2} if world == 2 else {"data": 2, "expert": 2}
    return make_mesh(dict(extra) or axes, device="cpu")


def by_name(names, tensors) -> Dict[str, np.ndarray]:
    return {n: t.detach().numpy().copy() for n, t in zip(names, tensors)}


# ------------------------------------------------------------------ scenarios


def _bmm(w, t):
    return torch.bmm(t, w)


def scenario_ops(rank, ctx):
    """``moe_apply``, ``moe_apply_a2a`` (three cases) and
    ``moe_apply_topk(mesh=)`` on the world's mesh: this rank's outputs and
    the gradients of ``sum(out * cotangent)``."""
    from unionml_tpu_torch.parallel import ep

    mesh = mesh_of(ctx.world)
    where = coords(mesh)
    out = {"where": where}

    case = op_case("moe_apply")  # tokens and assignment alike on every rank, the whole stack
    w = torch.from_numpy(case["w"]).requires_grad_()
    tokens = torch.from_numpy(case["tokens"]).requires_grad_()
    o = ep.moe_apply(_bmm, w, tokens, torch.from_numpy(case["assignment"]), mesh)
    gw, gt = torch.autograd.grad((o * torch.from_numpy(case["cotangent"])).sum(), (w, tokens))
    out["moe_apply"] = {"out": o.detach().numpy(), "grad_w": gw.numpy(), "grad_tokens": gt.numpy()}

    def sharded(name, fn):
        case = op_case(name)
        local = case["w"].shape[0] // where["expert_size"]
        # this rank's experts only: the stack as expert_sharding cuts it
        w = torch.from_numpy(ep.expert_sharding(mesh).shard(case["w"])).requires_grad_()
        assert w.shape[0] == local
        tokens = torch.from_numpy(rows(case["tokens"], where)).requires_grad_()
        gates = torch.softmax(torch.from_numpy(rows(case["logits"], where)), dim=-1).detach().requires_grad_()
        o = fn(w, tokens, gates)
        grads = torch.autograd.grad((o * torch.from_numpy(rows(case["cotangent"], where))).sum(), (w, tokens, gates))
        return {"out": o.detach().numpy(), "grads": [g.numpy() for g in grads]}

    for name, (k, cf, norm) in A2A.items():
        out[f"a2a_{name}"] = sharded(name, lambda w, t, g: ep.moe_apply_a2a(
            _bmm, w, t, g, mesh, k=k, capacity_factor=cf, normalize_gates=norm))
    k, cf, norm = TOPK
    out["topk"] = sharded("topk", lambda w, t, g: ep.moe_apply_topk(
        _bmm, w, t, g, mesh, k=k, capacity_factor=cf, normalize_gates=norm))
    # the routing's kept choices under the global cumsum (the gshard arm's drops)
    case = op_case("topk")
    gates = torch.softmax(torch.from_numpy(rows(case["logits"], where)), dim=-1)
    routing = ep.topk_route(gates, k, cf, norm, ep.batch_ranks(mesh))
    out["topk_keep"] = routing.keep.numpy()
    return out


def _layer_params(seed: int = 3):
    rng = np.random.default_rng(seed)
    return {"router.weight": (rng.normal(size=(8, 16)) * 0.3).astype(np.float32),
            "router.bias": np.zeros(8, np.float32),
            "w_in": (rng.normal(size=(8, 16, 16)) * 0.3).astype(np.float32),
            "w_out": (rng.normal(size=(8, 16, 16)) * 0.3).astype(np.float32)}


def scenario_layer(rank, ctx):
    """``MoEMlp`` (8 experts, hidden 16, top-2) on this rank's rows of a
    ``(4, 16, 16)`` batch, a capacity-bounded forward: ``dispatch="a2a"``
    and ``"gshard"`` with the mesh at capacity 8 (``test_moe_layer.py:70``),
    and gshard with the mesh against the unmeshed layer on the whole batch at
    capacity 8 and 1 (global routing). Outputs, the router losses and the
    gradients (router, this rank's experts, the input) of ``sum(out**2)``."""
    from unionml_tpu_torch.models import MoEMlp
    from unionml_tpu_torch.parallel import ep

    mesh = mesh_of(ctx.world)
    where = coords(mesh)
    x = np.random.default_rng(3).normal(size=(4, 16, 16)).astype(np.float32)
    params = _layer_params()
    out = {"where": where}

    def run(dispatch, cf, meshed):
        layer = MoEMlp(16, 8, 16, k=2, capacity_factor=cf, dispatch=dispatch, mesh=mesh if meshed else None)
        shard = ep.expert_sharding(mesh) if meshed else None
        with torch.no_grad():
            for name, value in params.items():
                held = layer.get_parameter(name)
                held.copy_(torch.from_numpy(shard.shard(value) if shard is not None and name.startswith("w_")
                                            else value))
        inp = torch.from_numpy(rows(x, where) if meshed else x).requires_grad_()
        o, aux = layer(inp, generator=torch.Generator())
        leaves = [layer.router.weight, layer.router.bias, layer.w_in, layer.w_out, inp]
        grads = torch.autograd.grad((o ** 2).sum(), leaves)
        return {"out": o.detach().numpy(), "aux": {k: float(v) for k, v in aux.items()},
                "grads": [g.numpy() for g in grads]}

    for cf in (8.0, 1.0):
        out[f"gshard_{cf}"] = run("gshard", cf, True)
        out[f"unmeshed_{cf}"] = run("gshard", cf, False)
    out["a2a_8.0"] = run("a2a", 8.0, True)
    return out


def _fit(mesh, config, params, checkpoint_dir=None, steps=FIT_STEPS):
    from unionml_tpu_torch.models import create_train_state, fit_lm, init_gpt

    state = create_train_state(init_gpt(config, params=params, device="cpu"), learning_rate=LR)
    return fit_lm(state, lm_corpus(), seq_len=SEQ, batch_size=ROWS, pack=True, num_steps=steps, mesh=mesh,
                  log_every=1, moe_aux=True, checkpoint_dir=checkpoint_dir, checkpoint_every=1)


def _grads(mesh, config, params):
    """The first batch's reduced gradients and loss on the laid-out state."""
    from unionml_tpu_torch.models import create_train_state, init_gpt
    from unionml_tpu_torch.models.training import lm_grads, shard_train_state
    from unionml_tpu_torch.parallel import shard_batch

    state = shard_train_state(create_train_state(init_gpt(config, params=params, device="cpu")), mesh)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch(first_batch(), mesh).items()}
    grads, loss = lm_grads(state, batch, packed=True, moe_aux=True)
    return {"loss": float(loss), "grads": by_name(state.names, grads)}


def _trained(mesh, config, params):
    result = _fit(mesh, config, params)
    return {"losses": [h["loss"] for h in result.metrics_history],
            "params": by_name(result.state.names, result.state.params), **_grads(mesh, config, params)}


def scenario_fit(rank, ctx):
    """``fit_lm(pack=True, moe_aux=True)`` on ``{"data": 2, "expert": 2}``,
    ``moe_dispatch="a2a"`` and ``"gshard"`` with ``ep_mesh``: the logged
    losses, the parameters after (this rank's experts) and the first
    batch's gradients."""
    mesh = mesh_of(ctx.world)
    out = {"where": coords(mesh)}
    for dispatch in ("a2a", "gshard"):
        out[dispatch] = _trained(mesh, gpt_config(moe_dispatch=dispatch, ep_mesh=mesh), ctx.gpt_params)
    return out


def scenario_data_mesh(rank, ctx):
    """The sparse GPT (gshard, no ``ep_mesh``) through ``fit_lm`` on
    ``{"data": 2}``, without and with ``remat``."""
    mesh = mesh_of(ctx.world, data=2)
    return {"where": coords(mesh), "gshard": _trained(mesh, gpt_config(), ctx.gpt_params),
            "gshard_remat": _trained(mesh, gpt_config(remat=True), ctx.gpt_params)}


def scenario_checkpoint(rank, ctx):
    """Two a2a ``fit_lm`` steps on ``{"data": 1, "expert": 2}`` with step
    checkpoints; rank 0 restores the last into the unmeshed model (every
    expert on one rank) and compares it with the gathered state."""
    from unionml_tpu_torch.checkpoint import Checkpointer, extract_state
    from unionml_tpu_torch.models import create_train_state, init_gpt

    mesh = mesh_of(ctx.world, data=1, expert=2)
    directory = Path(ctx.out_dir, "checkpoint")
    result = _fit(mesh, gpt_config(moe_dispatch="a2a", ep_mesh=mesh), ctx.gpt_params, str(directory), steps=2)
    whole = extract_state(result.state)  # a collective: every rank gathers
    local = {n: tuple(p.shape) for n, p in zip(result.state.names, result.state.params)}
    if rank != 0:
        return {"local_shapes": local}
    target = create_train_state(init_gpt(gpt_config(), device="cpu"), learning_rate=LR)
    Checkpointer(directory).restore(target)
    restored = {group: dict(zip(target.names, getattr(target, group))) for group in ("params", "mu", "nu")}
    equal = {group: all(torch.equal(restored[group][n], whole[group][n]) for n in target.names)
             for group in ("params", "mu", "nu")}
    return {"local_shapes": local, "whole_shapes": {n: tuple(t.shape) for n, t in whole["params"].items()},
            "equal": equal, "step": target.step}


def led(rank, engine, drive):
    if rank == 0:
        try:
            return drive(engine)
        finally:
            engine.stop_followers()
    return {"followed": engine.follow()}


def drain(engine, slots):
    out = {s: [] for s in slots}
    while engine.num_active or engine.has_pending_prefill:
        for ev in engine.step(1):
            if ev.emit:
                out[ev.slot].append(ev.token)
    return [out[s] for s in slots]


def scenario_tensor(rank, ctx):
    """The sparse GPT served on ``{"tensor": 2}`` (dropless blocks, each
    expert's hidden width split): ``DecodeEngine`` and a greedy
    ``SpeculativeEngine`` streams."""
    from unionml_tpu_torch.models import init_gpt
    from unionml_tpu_torch.parallel import make_mesh
    from unionml_tpu_torch.serving import DecodeEngine, SpeculativeEngine

    mesh = make_mesh({"tensor": 2}, device="cpu")
    model = init_gpt(gpt_config(moe_capacity_factor=1.25), params=ctx.gpt_params, device="cpu")
    engine = DecodeEngine(model, mesh=mesh, **ENGINE_KW)
    streams = led(rank, engine, lambda e: drain(e, e.admit_many(REQUESTS)))
    draft = init_gpt(gpt_config(num_layers=1), seed=1, device="cpu")
    spec = SpeculativeEngine(model, draft, mesh=mesh, gamma_max=3, **ENGINE_KW)
    requests = [(p, n, {"speculative": True}) for p, n in REQUESTS]
    speculative = led(rank, spec, lambda e: drain(e, e.admit_many(requests)))
    return {"streams": streams, "speculative": speculative, "rounds": spec.spec_round_dispatches,
            "hidden": int(engine._model.layers[0].moe_mlp.w_in.shape[-1])}


SCENARIOS = {
    2: {"ops": scenario_ops, "layer": scenario_layer, "data_mesh": scenario_data_mesh,
        "checkpoint": scenario_checkpoint, "tensor": scenario_tensor},
    4: {"ops": scenario_ops, "layer": scenario_layer, "fit": scenario_fit},
}


def rank_main(rank: int, world: int, port: int, inputs: Dict[str, Any], out_dir: str) -> None:
    torch.set_num_threads(1)
    faulthandler.dump_traceback_later(170, exit=True)  # a hung rank never holds the suite
    from unionml_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"localhost:{port}", world, rank, strict=True, device="cpu", timeout_s=60)
    ctx = SimpleNamespace(world=world, out_dir=out_dir, **inputs)
    results = {}
    for name, scenario in SCENARIOS[world].items():
        t0 = time.perf_counter()
        try:
            results[name] = scenario(rank, ctx)
        except BaseException as exc:  # the parent's test of this scenario fails with the traceback
            results[name] = {"error": "".join(traceback.format_exception(exc))}
        results[name]["wall_s"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    dist.destroy_process_group()
