"""The ranks of ``tests/test_torch_sequence_parallel.py``: one process per
rank of a gloo world on the CPU, importing no JAX.

Every rank runs each scenario of its world in the same order and writes
what it saw to ``out_dir/rank{r}.pkl``: its coordinates on the scenario's
mesh and its chunk of each result, which the parent reassembles and holds
against the JAX package. The inputs are made here from numpy seeds, or come
from the parent (weights in JAX's layout).
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

#: the op-level inputs: rows, heads, sequence, head_dim; the rows' valid
#: lengths (a fully padded row, one ending on a chunk boundary of 4 chunks,
#: a whole row, one ending inside a chunk)
OP_SHAPE = (4, 4, 32, 16)
OP_LENS = (0, 8, 32, 19)
IMPLS = ("ring", "ulysses")
#: the tiny GPT of the model-level cases: one layer, no dropout, f32
GPT_SEQ, GPT_ROWS = 32, 4
BERT_SEQ, BERT_ROWS = 16, 4
BERT_LENS = (16, 3, 9, 12)  # right padding: one row ends inside the first of 4 chunks
SIG = ("input_ids", "attention_mask")
LM_LENS = (32, 20, 7, 16)  # right padding of the LM eval: 7 ends inside the first of 2 chunks, 16 on its end
LR = 1e-3
FIT_STEPS = 3


# ------------------------------------------------------------------ data


def op_inputs(seed: int = 0):
    """q, k, v and the cotangent of the op-level cases, f32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=OP_SHAPE).astype(np.float32) for _ in range(4)]


def gpt_ids(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 512, (GPT_ROWS, GPT_SEQ)).astype(np.int32)


def bert_batch(seed: int = 2) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    mask = (np.arange(BERT_SEQ)[None] < np.asarray(BERT_LENS)[:, None]).astype(np.int32)
    return {"input_ids": rng.integers(1, 1024, (BERT_ROWS, BERT_SEQ)).astype(np.int32) * mask,
            "attention_mask": mask, "labels": rng.integers(0, 2, BERT_ROWS).astype(np.int32)}


def lm_eval_batch() -> Dict[str, np.ndarray]:
    """``gpt_ids`` with a right-padding mask of ``LM_LENS``."""
    mask = (np.arange(GPT_SEQ)[None] < np.asarray(LM_LENS)[:, None]).astype(np.int32)
    return {"input_ids": gpt_ids(), "mask": mask}


def lm_corpus(seed: int = 3, n: int = 16):
    """Ragged sequences for ``fit_lm(pack=False)``: one row each, right-padded to ``GPT_SEQ``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, int(m)).astype(np.int32) for m in rng.integers(5, 2 * GPT_SEQ, n)]


def gpt_config(impl: str = "auto", mesh=None):
    from unionml_tpu_torch.models import GPTConfig

    return GPTConfig.tiny(dtype=torch.float32, dropout=0.0, num_layers=1, attention_impl=impl, sp_mesh=mesh)


def bert_config(impl: str = "auto", mesh=None, dropout: float = 0.0):
    from unionml_tpu_torch.models import BertConfig

    return BertConfig.tiny(dtype=torch.float32, hidden_dropout=dropout, attention_impl=impl, sp_mesh=mesh)


def coords(mesh) -> Dict[str, int]:
    """This rank's data index and count, and its sequence chunk and count."""
    from unionml_tpu_torch.parallel.mesh import DATA_AXIS, SEQUENCE_AXIS, axis_index, axis_size

    return {"data": axis_index(mesh, DATA_AXIS), "data_size": axis_size(mesh, DATA_AXIS),
            "seq": axis_index(mesh, SEQUENCE_AXIS), "seq_size": axis_size(mesh, SEQUENCE_AXIS)}


def local(array: np.ndarray, where: Dict[str, int], seq_dim: int = None) -> np.ndarray:
    """This rank's rows (dimension 0) and, with ``seq_dim``, its chunk of that dimension."""
    rows = array.shape[0] // where["data_size"]
    out = array[where["data"] * rows:(where["data"] + 1) * rows]
    if seq_dim is not None:
        size = out.shape[seq_dim] // where["seq_size"]
        out = np.take(out, np.arange(where["seq"] * size, (where["seq"] + 1) * size), axis=seq_dim)
    return np.ascontiguousarray(out)


def grads_by_name(names, grads) -> Dict[str, np.ndarray]:
    return {n: g.detach().numpy().copy() for n, g in zip(names, grads)}


# ------------------------------------------------------------------ scenarios


def _ops(meshes):
    """``ring_attention``/``ulysses_attention``, causal and not, with
    ``kv_lens``: this rank's output chunk and the gradients of ``sum(out *
    g)`` with respect to its q, k, v chunks."""
    from unionml_tpu_torch.parallel import make_mesh, ring_attention, ulysses_attention

    q, k, v, g = op_inputs()
    out = []
    for axes in meshes:
        mesh = make_mesh(axes, device="cpu")
        where = coords(mesh)
        lens = torch.from_numpy(local(np.asarray(OP_LENS, dtype=np.int32), where))
        qs, ks, vs, gs = (torch.from_numpy(local(x, where, seq_dim=2)) for x in (q, k, v, g))
        for impl, fn in zip(IMPLS, (ring_attention, ulysses_attention)):
            for causal in (False, True):
                leaves = [x.clone().requires_grad_() for x in (qs, ks, vs)]
                o = fn(*leaves, mesh, kv_lens=lens, causal=causal)
                grads = torch.autograd.grad((o * gs).sum(), leaves)
                out.append({"axes": axes, "impl": impl, "causal": causal, "where": where,
                            "out": o.detach().numpy(), "grads": [x.numpy() for x in grads]})
    return out


def scenario_ops(rank, ctx):
    meshes = ({"sequence": 4}, {"data": 2, "sequence": 2}) if ctx.world == 4 else ({"sequence": 2},)
    return {"cases": _ops(meshes)}


def scenario_gpt(rank, ctx):
    """The tiny GPT on ``{"data": 2, "sequence": 2}``: this rank's logits
    chunk, and the step's reduced gradients of the global mean loss."""
    from unionml_tpu_torch.models import create_train_state, init_gpt
    from unionml_tpu_torch.models.training import lm_grads, shard_train_state
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": 2, "sequence": 2}, device="cpu")
    where = coords(mesh)
    ids = gpt_ids()
    out = {"where": where}
    for impl in IMPLS:
        state = create_train_state(init_gpt(gpt_config(impl, mesh), params=ctx.gpt_params, device="cpu"))
        with torch.no_grad():
            logits = state.model(torch.from_numpy(local(ids, where, seq_dim=1)))
        state = shard_train_state(state, mesh)
        grads, loss = lm_grads(state, {"input_ids": torch.from_numpy(local(ids, where))})
        out[impl] = {"logits": logits.numpy(), "loss": float(loss), "grads": grads_by_name(state.names, grads)}
    return out


def scenario_bert(rank, ctx):
    """The tiny BERT on ``{"sequence": 4}`` with right padding: the logits
    (every rank's are the whole rows'), and the step's reduced gradients."""
    from unionml_tpu_torch.models import create_train_state, init_bert
    from unionml_tpu_torch.models.training import classifier_grads, shard_train_state
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sequence": 4}, device="cpu")
    where = coords(mesh)
    batch = bert_batch()
    out = {}
    for impl in IMPLS:
        state = create_train_state(init_bert(bert_config(impl, mesh), params=ctx.bert_params, device="cpu"))
        with torch.no_grad():
            logits = state.model(*(torch.from_numpy(local(batch[k], where, seq_dim=1)) for k in SIG))
        state = shard_train_state(state, mesh)
        grads, loss, acc = classifier_grads(state, {k: torch.from_numpy(v) for k, v in batch.items()}, SIG)
        out[impl] = {"logits": logits.numpy(), "loss": float(loss), "grads": grads_by_name(state.names, grads)}
    return out


def scenario_fit_lm(rank, ctx):
    """``fit_lm(pack=False)``, three steps on ``{"data": 2, "sequence": 2}``:
    each step's loss and the parameters after."""
    from unionml_tpu_torch.models import create_train_state, fit_lm, init_gpt
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"data": 2, "sequence": 2}, device="cpu")
    out = {}
    for impl in IMPLS:
        state = create_train_state(init_gpt(gpt_config(impl, mesh), params=ctx.gpt_params, device="cpu"),
                                   learning_rate=LR)
        result = fit_lm(state, lm_corpus(), seq_len=GPT_SEQ, batch_size=GPT_ROWS, pack=False, num_steps=FIT_STEPS,
                        mesh=mesh, log_every=1)
        out[impl] = {"losses": [h["loss"] for h in result.metrics_history],
                     "params": grads_by_name(result.state.names, result.state.params)}
    return out


def scenario_bert_fit(rank, ctx):
    """BERT ``fit``, three steps on ``{"sequence": 2}`` (every rank the same
    rows, its chunk of each): each step's metrics and the parameters after."""
    from unionml_tpu_torch.models import create_train_state, fit, init_bert
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sequence": 2}, device="cpu")
    out = {}
    for impl in IMPLS:
        state = create_train_state(init_bert(bert_config(impl, mesh), params=ctx.bert_params, device="cpu"),
                                   learning_rate=LR)
        result = fit(state, bert_fit_data(), batch_size=BERT_ROWS, num_steps=FIT_STEPS, mesh=mesh,
                     input_signature=SIG, log_every=1)
        out[impl] = {"history": result.metrics_history,
                     "params": grads_by_name(result.state.names, result.state.params)}
    return out


def bert_fit_data() -> Dict[str, np.ndarray]:
    """Three batches of ``bert_batch``'s shape."""
    parts = [bert_batch(seed) for seed in (4, 5, 6)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def scenario_eval(rank, ctx):
    """The eval steps on ``{"sequence": 2}``, every rank given the whole
    rows (the step cuts its chunk): the LM eval of the tiny GPT on
    right-padded rows and the classifier eval of the tiny BERT."""
    from unionml_tpu_torch.models import (
        create_train_state,
        init_bert,
        init_gpt,
        make_classifier_eval_step,
        make_lm_eval_step,
    )
    from unionml_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sequence": 2}, device="cpu")
    lm = {k: torch.from_numpy(v) for k, v in lm_eval_batch().items()}
    classified = {k: torch.from_numpy(v) for k, v in bert_batch().items()}
    out = {}
    for impl in IMPLS:
        gpt = create_train_state(init_gpt(gpt_config(impl, mesh), params=ctx.gpt_params, device="cpu"))
        bert = create_train_state(init_bert(bert_config(impl, mesh), params=ctx.bert_params, device="cpu"))
        out[impl] = {"lm": {k: float(v) for k, v in make_lm_eval_step()(gpt, lm).items()},
                     "classifier": {k: float(v) for k, v in make_classifier_eval_step(SIG)(bert, classified).items()}}
    return out


def scenario_dropout(rank, ctx):
    """Dropout on, one BERT ring step on ``{"sequence": 2}``: a digest of
    each dropout mask this rank drew (the two chunks of a row must differ)."""
    from unionml_tpu_torch.models import bert, create_train_state, init_bert, make_classifier_train_step
    from unionml_tpu_torch.parallel import make_mesh

    masks = []
    real = bert._dropout

    def recorded(x, rate, generator):
        out = real(x, rate, generator)
        if generator is not None:
            masks.append(hashlib.sha1((out == 0).numpy().tobytes()).hexdigest())
        return out

    bert._dropout = recorded
    try:
        mesh = make_mesh({"sequence": 2}, device="cpu")
        state = create_train_state(init_bert(bert_config("ring", mesh, dropout=0.1), params=ctx.bert_params,
                                             device="cpu"))
        step = make_classifier_train_step(mesh=mesh, input_signature=SIG)
        step(state, {k: torch.from_numpy(v) for k, v in bert_batch().items()})
    finally:
        bert._dropout = real
    return {"masks": masks}


SCENARIOS = {
    2: {"ops": scenario_ops, "bert_fit": scenario_bert_fit, "dropout": scenario_dropout, "eval": scenario_eval},
    4: {"ops": scenario_ops, "gpt": scenario_gpt, "bert": scenario_bert, "fit_lm": scenario_fit_lm},
}


def rank_main(rank: int, world: int, port: int, inputs: Dict[str, Any], out_dir: str) -> None:
    torch.set_num_threads(1)
    faulthandler.dump_traceback_later(170, exit=True)  # a hung rank never holds the suite
    from unionml_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"localhost:{port}", world, rank, strict=True, device="cpu", timeout_s=60)
    ctx = SimpleNamespace(world=world, **inputs)
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
