"""The ranks of ``tests/test_torch_expert_axes.py``: one process per rank of
a gloo world of 4 on the CPU, importing no JAX.

Every rank runs each scenario in the same order and writes what it saw to
``out_dir/rank{r}.pkl``: its coordinates on the scenario's mesh, its local
leaves, the whole leaves gathered from its shards, and the routing of its
sparse blocks (each capacity-bounded call's gates and kept choices), which
the parent holds against the JAX package. The sparse GPT is
``tests/torch_ep_ranks.py``'s (8 experts, top-2, capacity 1.0), its weights
in JAX's layout from the parent. The meshes are ``{"expert": 2, "fsdp":
2}``, ``{"expert": 2, "tensor": 2}`` and ``{"expert": 2, "sequence": 2}``
(ring attention, unpacked rows, as JAX trains sequence parallelism).
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

from tests.torch_ep_ranks import ENGINE_KW, LM, LR, REQUESTS, SEQ, drain, led, lm_corpus

#: the composed meshes, each trained under both dispatches
AXES = ({"expert": 2, "fsdp": 2}, {"expert": 2, "tensor": 2}, {"expert": 2, "sequence": 2})
DISPATCHES = ("gshard", "a2a")
#: four rows a step (two a rank over fsdp), three steps
ROWS, FIT_STEPS = 4, 3
#: the arm that also trains with ``remat``
REMAT = (str(AXES[2]), "a2a")
#: the arms whose steps are checkpointed and restored
CHECKPOINTED = ((str(AXES[0]), "gshard"), (str(AXES[1]), "a2a"))
SERVE = AXES[1]


def packed(axes) -> bool:
    """JAX trains sequence parallelism on unpacked rows only."""
    return "sequence" not in axes


def first_batch(pack: bool) -> Dict[str, np.ndarray]:
    """The gradient check's batch: the first ``ROWS`` packed rows of
    ``lm_corpus``, or ``ROWS`` whole rows of seeded ids."""
    if pack:
        from unionml_tpu_torch.ops.packing import pack_sequences

        rows = pack_sequences(lm_corpus(), SEQ)
        return {k: rows[k][:ROWS] for k in ("input_ids", "segment_ids")}
    return {"input_ids": np.random.default_rng(11).integers(1, LM["vocab_size"], (ROWS, SEQ)).astype(np.int32)}


def gpt_config(axes=None, mesh=None, **overrides):
    from unionml_tpu_torch.models import GPTConfig

    if axes is not None and "sequence" in axes:
        overrides = dict(attention_impl="ring", sp_mesh=mesh, **overrides)
    return GPTConfig.tiny(dtype=torch.float32, **dict(LM, **overrides))


def coords(mesh) -> Dict[str, int]:
    """This rank's block of rows (data×fsdp) and their count, its chunk of
    every row and the chunks' count, its expert and tensor indices."""
    from unionml_tpu_torch.parallel.mesh import (
        EXPERT_AXIS, FSDP_AXIS, SEQUENCE_AXIS, TENSOR_AXIS, axis_index, axis_size, batch_axis_size, batch_index,
    )

    return {"rows": batch_index(mesh), "rows_size": batch_axis_size(mesh), "seq": axis_index(mesh, SEQUENCE_AXIS),
            "seq_size": axis_size(mesh, SEQUENCE_AXIS), "expert": axis_index(mesh, EXPERT_AXIS),
            "fsdp": axis_index(mesh, FSDP_AXIS), "tensor": axis_index(mesh, TENSOR_AXIS)}


def route_log():
    """Wraps ``parallel.ep.topk_route`` to record each capacity-bounded
    call's gates ``(T, E)`` and kept choices ``(T, k)``; returns (the log, a
    restore function)."""
    from unionml_tpu_torch.parallel import ep

    log, real = [], ep.topk_route

    def recorded(gates, k=2, capacity_factor=1.25, normalize_gates=True, group=None, rows=1):
        routing = real(gates, k, capacity_factor, normalize_gates, group, rows)
        if capacity_factor is not None:
            log.append({"gates": gates.detach().numpy().copy(), "keep": routing.keep.numpy().copy()})
        return routing

    ep.topk_route = recorded
    return log, lambda: setattr(ep, "topk_route", real)


def spec_of(model, mesh):
    from unionml_tpu_torch.models import gpt
    from unionml_tpu_torch.parallel.mesh import axis_names

    return gpt.param_shardings(dict(model.named_parameters()), axis_names(mesh))


def laid_out(axes, mesh, params, **overrides):
    """A fresh state of the sparse GPT with ``ep_mesh=mesh``, laid out by
    ``param_shardings`` as the meshed step's first call lays it."""
    from unionml_tpu_torch.models import create_train_state, init_gpt
    from unionml_tpu_torch.models.training import _on_mesh

    model = init_gpt(gpt_config(axes, mesh, ep_mesh=mesh, **overrides), params=params, device="cpu")
    return _on_mesh(create_train_state(model, learning_rate=LR), mesh, spec_of(model, mesh))


def by_name(names, tensors) -> Dict[str, np.ndarray]:
    return {n: t.detach().numpy().copy() for n, t in zip(names, tensors)}


def whole(state, leaves) -> Dict[str, np.ndarray]:
    """Every leaf of a laid-out ``state`` gathered whole (a collective)."""
    return {n: state.layout.gather(i, leaf).detach().numpy().copy()
            for i, (n, leaf) in enumerate(zip(state.names, leaves))}


def rows_of(batch: Dict[str, np.ndarray], mesh) -> Dict[str, torch.Tensor]:
    from unionml_tpu_torch.parallel import shard_batch

    return {k: torch.from_numpy(v) for k, v in shard_batch(batch, mesh).items()}


# ------------------------------------------------------------------ scenarios


def _arm(axes, mesh, dispatch, params, out_dir, remat=False):
    """One arm: the first batch's loss, whole gradients and routing log on a
    laid-out state, then ``fit_lm`` (checkpointed where ``CHECKPOINTED``
    says): the logged losses and the parameters after, local and whole."""
    from unionml_tpu_torch.models import create_train_state, fit_lm, init_gpt
    from unionml_tpu_torch.models.training import lm_grads

    pack = packed(axes)
    state = laid_out(axes, mesh, params, moe_dispatch=dispatch, remat=remat)
    log, restore = route_log()
    try:
        grads, loss = lm_grads(state, rows_of(first_batch(pack), mesh), packed=pack, moe_aux=True)
    finally:
        restore()
    out = {"loss": float(loss), "grads": whole(state, grads), "log": log, "fsdp": state.layout.fsdp,
           "tensor_split": sum(state.layout.tensor_split), "expert_split": sum(state.layout.expert_split)}
    model = init_gpt(gpt_config(axes, mesh, ep_mesh=mesh, moe_dispatch=dispatch, remat=remat), params=params,
                     device="cpu")
    directory = None
    if (str(axes), dispatch) in CHECKPOINTED and not remat:
        directory = str(Path(out_dir, f"ckpt-{dispatch}-{'-'.join(axes)}"))
    result = fit_lm(create_train_state(model, learning_rate=LR), lm_corpus(), seq_len=SEQ, batch_size=ROWS,
                    pack=pack, num_steps=FIT_STEPS, mesh=mesh, param_spec=spec_of(model, mesh), log_every=1,
                    moe_aux=True, checkpoint_dir=directory, checkpoint_every=1)
    out.update(losses=[h["loss"] for h in result.metrics_history], params=whole(result.state, result.state.params),
               local=by_name(result.state.names, result.state.params))
    if directory is not None:
        out["checkpoint"] = _checkpoint(axes, mesh, dispatch, params, directory, result.state)
    return out


def _checkpoint(axes, mesh, dispatch, params, directory, trained):
    """The checkpoint of ``trained`` (the arm's last step): rank 0 restores
    it into the unmeshed model (every expert whole) and compares it with the
    gathered state, bitwise; every rank restores it into a laid-out state on
    the same mesh, whose shards must be the saved leaves' cut by its layout."""
    from unionml_tpu_torch.checkpoint import Checkpointer, extract_state
    from unionml_tpu_torch.models import create_train_state, init_gpt

    gathered = extract_state(trained)  # a collective: every rank gathers
    out = {"local_shapes": {n: tuple(p.shape) for n, p in zip(trained.names, trained.params)},
           "whole_shapes": {n: tuple(t.shape) for n, t in gathered["params"].items()}}
    target = laid_out(axes, mesh, params, moe_dispatch=dispatch)
    ckpt = Checkpointer(directory)
    restored = ckpt.restore(target, step=FIT_STEPS)
    saved = torch.load(Path(directory) / str(FIT_STEPS) / "state.pt", map_location="cpu",
                       weights_only=True)["state"]
    out["meshed"] = {"step": restored.step, "layout_kept": restored.layout is target.layout,
                     "shards_equal": all(torch.equal(p, target.layout.shard(i, saved["params"][n]))
                                         for i, (n, p) in enumerate(zip(restored.names, restored.params)))}
    ckpt.close()
    if dist.get_rank() == 0:
        unmeshed = create_train_state(init_gpt(gpt_config(), device="cpu"), learning_rate=LR)
        Checkpointer(directory).restore(unmeshed)
        got = {g: dict(zip(unmeshed.names, getattr(unmeshed, g))) for g in ("params", "mu", "nu")}
        out["unmeshed"] = {"step": unmeshed.step,
                           "equal": {g: all(torch.equal(got[g][n], gathered[g][n]) for n in unmeshed.names)
                                     for g in ("params", "mu", "nu")}}
    return out


def scenario_fit(rank, ctx):
    """Each composed mesh under both dispatches (``_arm``), and ``REMAT``'s
    arm again with ``remat``."""
    from unionml_tpu_torch.parallel import make_mesh

    out = {}
    for axes in AXES:
        mesh = make_mesh(axes, device="cpu")
        out[str(axes)] = {"where": coords(mesh)}
        for dispatch in DISPATCHES:
            out[str(axes)][dispatch] = _arm(axes, mesh, dispatch, ctx.params, ctx.out_dir)
            if (str(axes), dispatch) == REMAT:
                out[str(axes)]["remat"] = _arm(axes, mesh, dispatch, ctx.params, ctx.out_dir, remat=True)
    return out


def scenario_unmeshed(rank, ctx):
    """Rank 0: the unmeshed sparse GPT's routing log on each first batch
    (the whole batch at once: the global routing's kept choices, and layer
    0's gates in JAX's flattened order)."""
    if rank != 0:
        return {}
    from unionml_tpu_torch.models import init_gpt
    from unionml_tpu_torch.models.training import _lm_loss

    out = {}
    for pack in (True, False):
        batch = {k: torch.from_numpy(v) for k, v in first_batch(pack).items()}
        log, restore = route_log()
        try:
            _lm_loss(init_gpt(gpt_config(), params=ctx.params, device="cpu"), batch, packed=pack, moe_aux=True,
                     deterministic=False, generator=torch.Generator())
        finally:
            restore()
        out[pack] = log
    return out


def scenario_engine(rank, ctx):
    """``DecodeEngine`` over ``{"expert": 2, "tensor": 2}``: the sparse GPT
    cut by the serving mesh (a rank's experts at its hidden columns), and
    the model whose ``ep_mesh`` is that mesh (its share held, its columns
    cut); rank 0's greedy streams and the unmeshed engine's."""
    from unionml_tpu_torch.models import init_gpt
    from unionml_tpu_torch.parallel import make_mesh
    from unionml_tpu_torch.serving import DecodeEngine

    mesh = make_mesh(SERVE, device="cpu")
    out = {}
    for name, overrides in (("cut", {}), ("held", {"ep_mesh": mesh})):
        model = init_gpt(gpt_config(moe_capacity_factor=1.25, **overrides), params=ctx.params, device="cpu")
        engine = DecodeEngine(model, mesh=mesh, **ENGINE_KW)
        layer = engine._model.layers[0].moe_mlp
        out[name] = {"streams": led(rank, engine, lambda e: drain(e, e.admit_many(REQUESTS))),
                     "shape": tuple(layer.w_in.shape), "partial": layer.partial.size}
    if rank == 0:
        plain = init_gpt(gpt_config(moe_capacity_factor=1.25), params=ctx.params, device="cpu")
        out["unmeshed"] = drain(e := DecodeEngine(plain, **ENGINE_KW), e.admit_many(REQUESTS))
    return out


SCENARIOS = {"fit": scenario_fit, "unmeshed": scenario_unmeshed, "engine": scenario_engine}


def rank_main(rank: int, world: int, port: int, inputs: Dict[str, Any], out_dir: str) -> None:
    torch.set_num_threads(1)
    faulthandler.dump_traceback_later(170, exit=True)  # a hung rank never holds the suite
    from unionml_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"localhost:{port}", world, rank, strict=True, device="cpu", timeout_s=60)
    ctx = SimpleNamespace(world=world, out_dir=out_dir, **inputs)
    results = {}
    for name, scenario in SCENARIOS.items():
        t0 = time.perf_counter()
        try:
            results[name] = scenario(rank, ctx)
        except BaseException as exc:  # the parent's test of this scenario fails with the traceback
            results[name] = {"error": "".join(traceback.format_exception(exc))}
        results[name]["wall_s"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    dist.destroy_process_group()


def expert_tensor_layout(model) -> list:
    """What serving lays ``model`` (a sparse GPT) out as over ``SERVE``
    (``{"expert": 2, "tensor": 2}``), seen from rank 0 of a fake world of 4
    (no collective runs): each sparse block's local ``w_in`` and ``w_out``
    shapes and the ranks its partial outputs are summed over."""
    from tests.torch_sharded_ranks import fake_world
    from unionml_tpu_torch.models import gpt
    from unionml_tpu_torch.models.moe import MoEMlp
    from unionml_tpu_torch.parallel import make_mesh

    with fake_world(4):
        mesh = make_mesh(SERVE, device="cpu")
        gpt.check_serving_experts(model, mesh)
        shard, _ = gpt.tensor_parallel(model, mesh)
        return [(tuple(m.w_in.shape), tuple(m.w_out.shape), m.partial.size)
                for m in shard.modules() if isinstance(m, MoEMlp)]
