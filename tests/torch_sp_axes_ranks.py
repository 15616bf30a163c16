"""The ranks of ``tests/test_torch_sequence_axes.py``: one process per rank
of a gloo world on the CPU, importing no JAX.

Every rank runs each scenario of its world in the same order and writes
what it saw to ``out_dir/rank{r}.pkl``: its coordinates on the scenario's
mesh and its part of each result (whole leaves gathered from its shards,
its chunk of logits), which the parent holds against the JAX package. The
inputs are made here from numpy seeds, or come from the parent (weights in
JAX's layout). The world of 4 lays ``{"sequence": 2, "tensor": 2}``,
``{"fsdp": 2, "sequence": 2}`` and ``{"data": 2, "sequence": 2}`` (and
``ORDERS``' meshes, whose axes are listed out of the batch's order); the
world of 2 ``{"sequence": 2}``.
"""

import faulthandler
import hashlib
import pickle
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from tests.torch_serve_ranks import BUCKETS, ENGINE_KW, REQUESTS, app
from tests.torch_sharded_ranks import led as led_predictor
from tests.torch_sp_ranks import (
    FIT_STEPS,
    GPT_ROWS,
    GPT_SEQ,
    IMPLS,
    LR,
    SIG,
    bert_batch,
    bert_config,
    gpt_config,
    gpt_ids,
    grads_by_name,
    lm_corpus,
)
from tests.torch_tp_ranks import drain, led

#: the composed meshes of the dense models' training
AXES = ({"sequence": 2, "tensor": 2}, {"fsdp": 2, "sequence": 2})
ST = AXES[0]
#: the sparse GPT: every block routes over four experts, top-2, at a
#: capacity that drops choices; two layers
SPARSE = dict(moe_every=1, num_experts=4, moe_capacity_factor=1.0, num_layers=2)
#: meshes whose axis order is not the batch's (data, fsdp, sequence): a
#: gather over their batch ranks comes back in another order than the rows
ORDERS = ({"sequence": 2, "data": 2}, {"fsdp": 2, "data": 2})
#: the GPT whose two heads a tensor axis of 2 leaves one per rank, which a
#: sequence axis of 2 does not divide (Ulysses gathers the chunk's heads)
TWO_HEADS = dict(num_heads=2)
#: the predictor's sequence ladder: BERT's rows of 16 and the GPT's of 32, each a rung the sequence axis divides
SERVE_SEQ = (16, 32)


def sparse_config(impl: str = "auto", mesh=None, remat: bool = False):
    from unionml_tpu_torch.models import GPTConfig

    return GPTConfig.tiny(dtype=torch.float32, dropout=0.0, attention_impl=impl, sp_mesh=mesh, remat=remat, **SPARSE)


def _mesh(axes):
    from unionml_tpu_torch.parallel import make_mesh

    return make_mesh(axes, device="cpu")


def coords(mesh) -> Dict[str, int]:
    """This rank's block of rows over data×fsdp and their count, its chunk
    of every row and the chunks' count, its tensor index."""
    from unionml_tpu_torch.parallel.mesh import (
        SEQUENCE_AXIS, TENSOR_AXIS, axis_index, axis_size, batch_axis_size, batch_index,
    )

    return {"data": batch_index(mesh), "data_size": batch_axis_size(mesh), "seq": axis_index(mesh, SEQUENCE_AXIS),
            "seq_size": axis_size(mesh, SEQUENCE_AXIS), "tensor": axis_index(mesh, TENSOR_AXIS)}


def local(array: np.ndarray, where: Dict[str, int], seq_dim: int = None) -> np.ndarray:
    """This rank's rows (dimension 0) and, with ``seq_dim``, its chunk of that dimension."""
    rows = array.shape[0] // where["data_size"]
    out = array[where["data"] * rows:(where["data"] + 1) * rows]
    if seq_dim is not None:
        size = out.shape[seq_dim] // where["seq_size"]
        out = np.take(out, np.arange(where["seq"] * size, (where["seq"] + 1) * size), axis=seq_dim)
    return np.ascontiguousarray(out)


def spec_of(state, mesh):
    """The family's ``param_shardings`` of ``state``'s model on ``mesh``."""
    from unionml_tpu_torch.models.training import _family
    from unionml_tpu_torch.parallel.mesh import axis_names

    return _family(state.model)[1](dict(state.model.named_parameters()), axis_names(mesh))


def whole(state, leaves) -> Dict[str, np.ndarray]:
    """Every leaf of a laid-out ``state`` gathered whole (a collective)."""
    return {n: state.layout.gather(i, leaf).detach().numpy().copy() for i, (n, leaf) in enumerate(zip(state.names, leaves))}


def _laid_out(model, mesh):
    from unionml_tpu_torch.models import create_train_state
    from unionml_tpu_torch.models.training import shard_train_state

    state = create_train_state(model, learning_rate=LR)
    return shard_train_state(state, mesh, spec_of(state, mesh))


# ------------------------------------------------------------------ scenarios


def scenario_gpt(rank, ctx):
    """The 1-layer tiny GPT on each composed mesh, ring and Ulysses, laid
    out by ``param_shardings``: this rank's logits chunk, the whole
    gradients of the global mean loss on ``gpt_ids``, then three
    ``fit_lm(pack=False)`` steps (each logged loss, the whole parameters after)."""
    from unionml_tpu_torch.models import create_train_state, fit_lm, init_gpt
    from unionml_tpu_torch.models.training import lm_grads

    out = {}
    ids = gpt_ids()
    for axes in AXES:
        mesh = _mesh(axes)
        where = coords(mesh)
        for impl in IMPLS:
            state = _laid_out(init_gpt(gpt_config(impl, mesh), params=ctx.gpt_params, device="cpu"), mesh)
            with torch.no_grad():
                logits = state.model(torch.from_numpy(local(ids, where, seq_dim=1)))
            grads, loss = lm_grads(state, {"input_ids": torch.from_numpy(local(ids, where))})
            fresh = create_train_state(init_gpt(gpt_config(impl, mesh), params=ctx.gpt_params, device="cpu"),
                                       learning_rate=LR)
            result = fit_lm(fresh, lm_corpus(), seq_len=GPT_SEQ, batch_size=GPT_ROWS, pack=False,
                            num_steps=FIT_STEPS, mesh=mesh, param_spec=spec_of(fresh, mesh), log_every=1)
            out[str(axes), impl] = {
                "where": where, "logits": logits.numpy(), "loss": float(loss),
                "grads": whole(state, grads), "losses": [h["loss"] for h in result.metrics_history],
                "params": whole(result.state, result.state.params),
                "fsdp": result.state.layout.fsdp, "tensor_split": sum(result.state.layout.tensor_split)}
    return out


def scenario_two_heads(rank, ctx):
    """The 2-head tiny GPT under Ulysses on ``{"sequence": 2, "tensor":
    2}``: one head per tensor rank, which the sequence axis does not divide
    (JAX checks the model's heads); logits chunk, loss, whole gradients."""
    from unionml_tpu_torch.models import GPTConfig, init_gpt
    from unionml_tpu_torch.models.training import lm_grads

    mesh = _mesh(ST)
    where = coords(mesh)
    ids = gpt_ids()
    cfg = GPTConfig.tiny(dtype=torch.float32, dropout=0.0, num_layers=1, attention_impl="ulysses", sp_mesh=mesh,
                         **TWO_HEADS)
    state = _laid_out(init_gpt(cfg, params=ctx.gpt_params, device="cpu"), mesh)
    with torch.no_grad():
        logits = state.model(torch.from_numpy(local(ids, where, seq_dim=1)))
    grads, loss = lm_grads(state, {"input_ids": torch.from_numpy(ids)})
    return {"where": where, "heads": state.model.tp.heads, "logits": logits.numpy(), "loss": float(loss),
            "grads": whole(state, grads)}


def scenario_bert(rank, ctx):
    """The tiny BERT on ``{"sequence": 2, "tensor": 2}``, ring and Ulysses,
    right-padded rows: every rank's logits, the step's loss and whole
    gradients, and one ``make_classifier_train_step`` step's metrics."""
    from unionml_tpu_torch.models import create_train_state, init_bert, make_classifier_train_step
    from unionml_tpu_torch.models.training import classifier_grads

    mesh = _mesh(ST)
    where = coords(mesh)
    batch = bert_batch()
    out = {"where": where}
    for impl in IMPLS:
        state = _laid_out(init_bert(bert_config(impl, mesh), params=ctx.bert_params, device="cpu"), mesh)
        with torch.no_grad():
            logits = state.model(*(torch.from_numpy(local(batch[k], where, seq_dim=1)) for k in SIG))
        tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
        grads, loss, acc = classifier_grads(state, tensors, SIG)
        fresh = create_train_state(init_bert(bert_config(impl, mesh), params=ctx.bert_params, device="cpu"),
                                   learning_rate=LR)
        step = make_classifier_train_step(mesh=mesh, param_spec=spec_of(fresh, mesh), input_signature=SIG)
        _, metrics = step(fresh, tensors)
        out[impl] = {"logits": logits.numpy(), "loss": float(loss), "grads": whole(state, grads),
                     "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


def _route_log():
    """Wraps ``parallel.ep.topk_route`` to record each capacity-bounded
    call's kept choices ``(T, k)``; returns (the log, a restore function)."""
    from unionml_tpu_torch.parallel import ep

    log, real = [], ep.topk_route

    def recorded(gates, k=2, capacity_factor=1.25, normalize_gates=True, group=None, rows=1):
        routing = real(gates, k, capacity_factor, normalize_gates, group, rows)
        if capacity_factor is not None:
            log.append(routing.keep.numpy().copy())
        return routing

    ep.topk_route = recorded

    def restore():
        ep.topk_route = real

    return log, restore


def scenario_sparse(rank, ctx):
    """The 2-layer sparse ring GPT (four experts, top-2, capacity 1.0) on
    ``{"data": 2, "sequence": 2}`` (world of 4) or ``{"sequence": 2}``
    (world of 2), ``moe_aux`` on: the first batch's loss, whole gradients
    and kept choices (each layer's ``(T, k)`` of this rank's chunk), and the
    unmeshed model's kept choices on the whole batch (rank 0); three
    ``fit_lm`` steps (losses, parameters after), with and without ``remat``."""
    from unionml_tpu_torch.models import create_train_state, fit_lm, init_gpt
    from unionml_tpu_torch.models.training import lm_grads, shard_train_state

    axes = {"data": 2, "sequence": 2} if ctx.world == 4 else {"sequence": 2}
    mesh = _mesh(axes)
    where = coords(mesh)
    ids = gpt_ids()
    out = {"where": where}
    for remat in (False, True):
        state = shard_train_state(create_train_state(init_gpt(sparse_config("ring", mesh, remat), device="cpu",
                                                               params=ctx.sparse_params)), mesh)
        log, restore = _route_log()
        try:
            grads, loss = lm_grads(state, {"input_ids": torch.from_numpy(local(ids, where))}, moe_aux=True)
        finally:
            restore()
        fresh = create_train_state(init_gpt(sparse_config("ring", mesh, remat), params=ctx.sparse_params,
                                            device="cpu"), learning_rate=LR)
        result = fit_lm(fresh, lm_corpus(), seq_len=GPT_SEQ, batch_size=GPT_ROWS, pack=False, num_steps=FIT_STEPS,
                        mesh=mesh, log_every=1, moe_aux=True)
        out[remat] = {"loss": float(loss), "grads": grads_by_name(state.names, grads), "keep": log,
                      "losses": [h["loss"] for h in result.metrics_history],
                      "params": grads_by_name(result.state.names, result.state.params)}
    if rank == 0:
        from unionml_tpu_torch.models.training import _lm_loss

        log, restore = _route_log()
        try:
            _lm_loss(init_gpt(sparse_config(), params=ctx.sparse_params, device="cpu"),
                     {"input_ids": torch.from_numpy(ids)}, packed=False, moe_aux=True, deterministic=False,
                     generator=torch.Generator())
        finally:
            restore()
        out["unmeshed_keep"] = log
    return out


def scenario_orders(rank, ctx):
    """Meshes that list their batch axes out of the batch's order
    (``ORDERS``): the sparse GPT's first batch on each (ring over the
    sequence axis, dense attention on fsdp×data), its loss, whole gradients
    and kept choices, and the batch ranks' ``batch_order``; and the 1-layer
    tiny GPT served by ``ResidentPredictor`` over ``{"fsdp": 2, "data": 2}``
    (rank 0's predictions, the unmeshed predictor's beside them)."""
    from unionml_tpu_torch.models import create_train_state, init_gpt
    from unionml_tpu_torch.models.training import lm_grads, shard_train_state
    from unionml_tpu_torch.parallel.mesh import SEQUENCE_AXIS, axis_names, batch_order
    from unionml_tpu_torch.serving import ResidentPredictor

    ids = gpt_ids()
    out = {}
    for axes in ORDERS:
        mesh = _mesh(axes)
        where = coords(mesh)
        impl = "ring" if SEQUENCE_AXIS in axis_names(mesh) else "auto"
        state = create_train_state(init_gpt(sparse_config(impl, mesh if impl == "ring" else None), device="cpu",
                                            params=ctx.sparse_params))
        state = shard_train_state(state, mesh, spec_of(state, mesh))
        log, restore = _route_log()
        try:
            grads, loss = lm_grads(state, {"input_ids": torch.from_numpy(local(ids, where))}, moe_aux=True)
        finally:
            restore()
        out[str(axes)] = {"where": where, "loss": float(loss), "grads": whole(state, grads), "keep": log,
                          "order": batch_order(mesh, sequence=True), "fsdp": state.layout.fsdp}
    mesh = _mesh(ORDERS[1])
    state = create_train_state(init_gpt(gpt_config(), params=ctx.gpt_params, device="cpu"))
    predictor = ResidentPredictor(app("gpt_rows", state), buckets=BUCKETS, warmup=False, mesh=mesh, device="cpu")
    out["prediction"] = led_predictor(rank, predictor, lambda p: p.predict(features={"input_ids": ids}))
    if rank == 0:
        plain = ResidentPredictor(app("gpt_rows", state), buckets=BUCKETS, warmup=False, device="cpu")
        out["unmeshed"] = plain.predict(features={"input_ids": ids})
    return out


def scenario_resident(rank, ctx):
    """``ResidentPredictor`` over ``{"sequence": 2, "tensor": 2}`` with the
    family's ``param_specs``: BERT and GPT, ring and Ulysses, keep their
    sequence-parallel attention at the rank's heads; the predictions of the
    BERT batch (``bert_batch``) and the GPT rows (``gpt_ids``), a GPT's
    chunks gathered back into whole rows."""
    from unionml_tpu_torch.models import create_train_state, init_bert, init_gpt
    from unionml_tpu_torch.serving import ResidentPredictor
    from unionml_tpu_torch.serving.resident import _sequence_config

    mesh = _mesh(ST)
    out = {}
    features = {"bert": {k: v for k, v in bert_batch().items() if k in SIG}, "gpt": {"input_ids": gpt_ids()}}
    for family, build, params in (("bert", lambda c: init_bert(c, params=ctx.bert_params, device="cpu"), bert_config),
                                  ("gpt", lambda c: init_gpt(c, params=ctx.gpt_params, device="cpu"), gpt_config)):
        for impl in IMPLS:
            state = create_train_state(build(params(impl, mesh)))
            predictor = ResidentPredictor(app(f"{family}_{impl}", state), buckets=BUCKETS, seq_buckets=SERVE_SEQ,
                                          warmup=False, mesh=mesh, param_specs=spec_of(state, mesh), device="cpu")
            got = led_predictor(rank, predictor, lambda p: p.predict(features=features[family]))
            served = predictor._device_model_object.model
            tp = next(m.tp for m in served.modules() if getattr(m, "tp", None) is not None)
            cfg = _sequence_config(predictor._device_model_object)
            out[family, impl] = {"prediction": got, "kept": cfg.attention_impl, "heads": tp.heads,
                                 "sp_mesh": cfg.sp_mesh is mesh}
    return out


def scenario_engine(rank, ctx):
    """``DecodeEngine`` over ``{"sequence": 2, "tensor": 2}`` with the ring
    GPT (its ``sp_mesh``): the cache paths attend densely at the rank's
    heads; greedy streams (rank 0) and the unmeshed engine's beside them."""
    from unionml_tpu_torch.models import init_gpt
    from unionml_tpu_torch.serving import DecodeEngine

    mesh = _mesh(ST)
    model = init_gpt(gpt_config("ring", mesh), params=ctx.gpt_params, device="cpu")
    engine = DecodeEngine(model, mesh=mesh, **ENGINE_KW)
    out = {"streams": led(rank, engine, lambda e: drain(e, e.admit_many(REQUESTS))),
           "heads": int(engine._pool["layer_0"]["k"].shape[1])}
    if rank == 0:
        plain = init_gpt(gpt_config(), params=ctx.gpt_params, device="cpu")
        out["unmeshed"] = drain(e := DecodeEngine(plain, **ENGINE_KW), e.admit_many(REQUESTS))
    return out


def scenario_checkpoint(rank, ctx):
    """The ring GPT on ``{"sequence": 2, "tensor": 2}``: two ``fit_lm``
    steps checkpointed every step, resumed for two more, against two and
    two more straight (bitwise, gathered); a restore into a laid-out target
    keeps its layout and lays every shard out again."""
    from unionml_tpu_torch.checkpoint import Checkpointer, extract_state
    from unionml_tpu_torch.models import create_train_state, fit_lm, init_gpt

    mesh = _mesh(ST)

    def fresh():
        state = create_train_state(init_gpt(gpt_config("ring", mesh), params=ctx.gpt_params, device="cpu"),
                                   learning_rate=LR)
        return state, spec_of(state, mesh)

    kwargs = dict(seq_len=GPT_SEQ, batch_size=GPT_ROWS, pack=False, mesh=mesh, log_every=100)
    state, spec = fresh()
    straight = fit_lm(state, lm_corpus(), num_steps=2, param_spec=spec, **kwargs).state
    want = extract_state(fit_lm(straight, lm_corpus(), num_steps=2, **kwargs).state)
    directory = str(Path(ctx.out_dir) / "ckpt")
    state, spec = fresh()
    first = fit_lm(state, lm_corpus(), num_steps=2, param_spec=spec, checkpoint_dir=directory, checkpoint_every=1,
                   **kwargs)
    state, spec = fresh()
    resumed = fit_lm(state, lm_corpus(), num_steps=2, param_spec=spec, checkpoint_dir=directory, checkpoint_every=1,
                     **kwargs)
    got, resumed_step = extract_state(resumed.state), resumed.state.step
    equal = all(torch.equal(got[g][n], want[g][n]) for g in ("params", "mu", "nu") for n in want["params"])
    target = resumed.state
    layout = target.layout
    ckpt = Checkpointer(directory)
    restored = ckpt.restore(target, step=2)
    saved = torch.load(Path(directory) / "2" / "state.pt", map_location="cpu", weights_only=True)["state"]
    shards_equal = all(torch.equal(p, layout.shard(i, saved["params"][n]))
                       for i, (n, p) in enumerate(zip(restored.names, restored.params)))
    ckpt.close()
    return {"first_steps": first.steps, "resumed_step": resumed_step, "bitwise": equal,
            "layout_kept": restored.layout is layout, "restored_step": restored.step, "shards_equal": shards_equal,
            "split": sum(layout.tensor_split)}


def scenario_dropout(rank, ctx):
    """Dropout on, one ring GPT step on ``{"sequence": 2, "tensor": 2}``: a
    digest of each dropout mask this rank drew (the tensor ranks of one
    chunk draw the same masks, the chunks of one row distinct ones)."""
    from unionml_tpu_torch.models import GPTConfig, create_train_state, gpt, init_gpt, make_lm_train_step

    masks = []
    real = gpt._dropout

    def recorded(x, rate, generator):
        out = real(x, rate, generator)
        if generator is not None:
            masks.append(hashlib.sha1((out == 0).numpy().tobytes()).hexdigest())
        return out

    gpt._dropout = recorded
    try:
        mesh = _mesh(ST)
        cfg = GPTConfig.tiny(dtype=torch.float32, dropout=0.1, num_layers=1, attention_impl="ring", sp_mesh=mesh)
        state = create_train_state(init_gpt(cfg, params=ctx.gpt_params, device="cpu"))
        step = make_lm_train_step(mesh=mesh, param_spec=spec_of(state, mesh))
        step(state, {"input_ids": torch.from_numpy(gpt_ids())})
    finally:
        gpt._dropout = real
    return {"where": coords(mesh), "masks": masks}


SCENARIOS = {
    2: {"sparse": scenario_sparse},
    4: {"gpt": scenario_gpt, "two_heads": scenario_two_heads, "bert": scenario_bert, "sparse": scenario_sparse,
        "orders": scenario_orders, "resident": scenario_resident, "engine": scenario_engine,
        "checkpoint": scenario_checkpoint, "dropout": scenario_dropout},
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
