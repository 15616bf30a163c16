"""The ranks of ``tests/test_torch_mesh_serving_axes.py``: one process per
rank of a gloo world of 2 on the CPU, importing no JAX.

Every rank builds the same tiny f32 models from the weights the parent made
in JAX's layout and runs each scenario below in the same order: rank 0
drives a meshed engine or predictor, the other rank follows. Each rank
writes what it saw to ``out_dir/rank{r}.pkl``; the parent holds it against
JAX's meshed engines and predictors and against the port's unmeshed ones.

- ``fsdp``: ``DecodeEngine`` over ``{"fsdp": 2}`` (paged, ``paged=False``,
  int8 weights) and ``SpeculativeEngine`` over it, the bytes each rank
  keeps at rest;
- ``sequence``: the ring config's engines over ``{"sequence": 2}``;
- ``expert``: the sparse GPT with ``ep_mesh={"expert": 2}`` and the whole
  sparse GPT cut by the serving mesh, both over ``{"expert": 2}``, and a
  state trained two steps by ``fit_lm(mesh={"expert": 2})`` served through
  ``Layout.whole_model`` beside the unmeshed engine on its gathered
  checkpoint;
- ``resident``: ``ResidentPredictor`` over ``{"sequence": 2}`` for BERT ring
  and Ulysses and the GPT ring LM, a ladder the axis does not divide, and
  ``serving_app(mesh=)``'s ``/predict``.
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

from tests.torch_sharded_ranks import led as led_predictor
from tests.torch_sharded_ranks import serve_predict
from tests.torch_tp_ranks import drain, led

WORLD = 2
#: the requests of the JAX package's own check on its 8-device CPU mesh
#: (prompts 1..5 and 7, 8, 9, six tokens each), and one that takes the
#: second prefill bucket
REQUESTS = [([1, 2, 3, 4, 5], 6), ([7, 8, 9], 6), ([11, 3, 8, 5, 2, 9, 4, 7, 1, 6, 10, 12], 5)]
ENGINE_KW = dict(num_slots=4, max_len=64, prefill_buckets=(8, 16), device="cpu")
#: the sparse GPT: every second block routes over four experts, top-2
SPARSE = dict(moe_every=2, num_experts=4)
#: the corpus, rows and steps of the served state's training
SEQ, ROWS, FIT_STEPS = 16, 2, 2
#: the predictor's buckets, a ladder the sequence axis divides and one it does not
BUCKETS, SEQ_BUCKETS, ODD_LADDER = (4,), (8, 16), (7,)


def gpt_config(**overrides):
    from unionml_tpu_torch.models import GPTConfig

    return GPTConfig.tiny(dtype=torch.float32, dropout=0.0, **overrides)


def bert_config(**overrides):
    from unionml_tpu_torch.models import BertConfig

    return BertConfig.tiny(dtype=torch.float32, hidden_dropout=0.0, **overrides)


def lm_corpus(seed: int = 5, n: int = 16):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, int(m)).astype(np.int32) for m in rng.integers(3, 20, n)]


def request_rows(n: int, seed: int, hi: int = 16):
    """``n`` rows of 2..``hi`` token ids in 1..511 (inside both tiny vocabularies)."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(1, 512, int(rng.integers(2, hi + 1))).tolist()} for _ in range(n)]


#: the predictor's requests: a batch of 3 (ladder rung 16) and a batch of 2 short rows (rung 8)
ROW_SETS = [request_rows(3, 0), request_rows(2, 1, hi=7)]
#: rows of an odd longest length that ODD_LADDER pads to 7
ODD_ROWS = [{"input_ids": [5, 9, 2, 7, 3]}, {"input_ids": [4, 4]}]


def tokenize(rows: Any) -> Dict[str, np.ndarray]:
    """Row dicts of token ids, right-padded to the longest."""
    if isinstance(rows, dict):
        return rows
    width = max(len(r["input_ids"]) for r in rows)
    ids = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r["input_ids"])] = r["input_ids"]
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}


def app(name: str, state):
    """An app whose predictor returns the f32 logits of ``state``'s model
    (BERT: ``(rows, labels)``; GPT: ``(rows, seq, vocab)``); its artifact is
    ``state``."""
    import unionml_tpu_torch as T
    from unionml_tpu_torch.model import ModelArtifact
    from unionml_tpu_torch.models import BertForSequenceClassification

    dataset = T.Dataset(name=f"{name}_ds", targets=["labels"], device_format="torch", device="cpu")

    @dataset.reader
    def reader(n: int = 4) -> Dict[str, np.ndarray]:
        return tokenize(request_rows(n, 0))

    dataset.feature_loader(tokenize)
    model = T.Model(name=name, init=lambda: state, dataset=dataset)

    @model.trainer
    def trainer(s, features: torch.Tensor, targets: torch.Tensor):
        return s

    @model.predictor
    def predictor(s, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            if isinstance(s.model, BertForSequenceClassification):
                return s.model(features["input_ids"], features["attention_mask"])
            return s.model(features["input_ids"])

    @model.evaluator
    def evaluator(s, features: torch.Tensor, targets: torch.Tensor) -> float:
        return 1.0

    model.artifact = ModelArtifact(state)
    return model


def _bytes(leaf) -> int:
    from unionml_tpu_torch.ops.quant import QuantizedArray

    if isinstance(leaf, QuantizedArray):
        return _bytes(leaf.q) + _bytes(leaf.scale)
    return leaf.numel() * leaf.element_size()


def _mesh(**axes):
    from unionml_tpu_torch.parallel import make_mesh

    return make_mesh(axes, device="cpu")


def streams(rank, engine):
    return led(rank, engine, lambda e: drain(e, e.admit_many(REQUESTS)))


# ------------------------------------------------------------------ scenarios


def scenario_fsdp(rank, ctx):
    """The dense GPT over ``{"fsdp": 2}``: streams of the paged, dense and
    int8-weight engines and of greedy speculation; each rank's at-rest
    bytes of the fsdp-split leaves and its piece of each; the whole buffers
    the blocks share."""
    from unionml_tpu_torch.models import gpt, init_gpt
    from unionml_tpu_torch.models._sharding import names_axis
    from unionml_tpu_torch.serving import DecodeEngine, SpeculativeEngine

    mesh = _mesh(fsdp=2)
    model = init_gpt(gpt_config(), params=ctx.gpt_params, device="cpu")
    out = {}
    engine = DecodeEngine(model, mesh=mesh, **ENGINE_KW)
    specs = gpt.param_shardings(dict(model.named_parameters()), ("fsdp",))
    split = [n for n, s in specs.items() if names_axis(s, "fsdp")]
    whole = dict(model.named_parameters())
    out["at_rest_bytes"] = sum(_bytes(engine._variables[n]) for n in split)
    out["whole_bytes"] = sum(_bytes(whole[n]) for n in split)
    out["pieces"] = all(torch.equal(engine._variables[n], whole[n].detach().reshape(-1).chunk(2)[rank])
                        for n in split)
    out["split"] = len(split)
    out["shared_buffers"] = len({p.data_ptr() for n, p in engine._model.named_parameters() if n.endswith("qkv.weight")})
    out["paged"] = streams(rank, engine)
    out["dense"] = streams(rank, DecodeEngine(model, mesh=mesh, paged=False, **ENGINE_KW))
    int8 = DecodeEngine(model, mesh=mesh, quantize="int8", **ENGINE_KW)
    out["int8_at_rest"] = sum(_bytes(int8._variables[n]) for n in split)
    out["int8"] = streams(rank, int8)
    draft = init_gpt(gpt_config(num_layers=1), seed=1, device="cpu")
    spec = SpeculativeEngine(model, draft, mesh=mesh, gamma_max=3, **ENGINE_KW)
    requests = [(p, n, {"speculative": True}) for p, n in REQUESTS]
    out["speculative"] = led(rank, spec, lambda e: drain(e, e.admit_many(requests)))
    out["rounds"] = spec.spec_round_dispatches
    if rank == 0:  # the unmeshed engines, on the same weights
        out["unmeshed"] = drain(e := DecodeEngine(model, **ENGINE_KW), e.admit_many(REQUESTS))
        out["unmeshed_int8"] = drain(e := DecodeEngine(model, quantize="int8", **ENGINE_KW), e.admit_many(REQUESTS))
    return out


def scenario_sequence(rank, ctx):
    """The ring config over ``{"sequence": 2}`` (its ``sp_mesh``): the
    engines decode through the dense fallback, every rank alike."""
    from unionml_tpu_torch.models import init_gpt
    from unionml_tpu_torch.serving import DecodeEngine

    mesh = _mesh(sequence=2)
    model = init_gpt(gpt_config(attention_impl="ring", sp_mesh=mesh), params=ctx.gpt_params, device="cpu")
    engine = DecodeEngine(model, mesh=mesh, **ENGINE_KW)
    out = {"same_model": engine._model is model, "paged": streams(rank, engine),
           "dense": streams(rank, DecodeEngine(model, mesh=mesh, paged=False, **ENGINE_KW))}
    if rank == 0:
        plain = init_gpt(gpt_config(), params=ctx.gpt_params, device="cpu")
        out["unmeshed"] = drain(e := DecodeEngine(plain, **ENGINE_KW), e.admit_many(REQUESTS))
    return out


def scenario_expert(rank, ctx):
    """The sparse GPT over ``{"expert": 2}``: with ``ep_mesh`` (each rank
    built with its two experts) and whole (the serving mesh cuts them), and
    a state trained two steps by ``fit_lm`` on that mesh served through
    ``Layout.whole_model`` beside the unmeshed engine on its gathered
    checkpoint."""
    from unionml_tpu_torch.checkpoint import extract_state
    from unionml_tpu_torch.models import create_train_state, fit_lm, init_gpt
    from unionml_tpu_torch.serving import DecodeEngine

    mesh = _mesh(expert=2)
    out = {}
    split = init_gpt(gpt_config(ep_mesh=mesh, **SPARSE), params=ctx.sparse_params, device="cpu")
    engine = DecodeEngine(split, mesh=mesh, **ENGINE_KW)
    out["ep_local"] = int(engine._model.layers[1].moe_mlp.w_in.shape[0])
    out["ep_mesh"] = streams(rank, engine)
    whole = init_gpt(gpt_config(**SPARSE), params=ctx.sparse_params, device="cpu")
    cut = DecodeEngine(whole, mesh=mesh, **ENGINE_KW)
    w_in = cut._model.layers[1].moe_mlp.w_in
    out["cut_local"] = int(w_in.shape[0])
    out["cut_share"] = bool(torch.equal(w_in, whole.layers[1].moe_mlp.w_in[2 * rank:2 * rank + 2]))
    out["cut"] = streams(rank, cut)
    state = create_train_state(init_gpt(gpt_config(ep_mesh=mesh, **SPARSE), params=ctx.sparse_params, device="cpu"),
                               learning_rate=1e-3)
    result = fit_lm(state, lm_corpus(), seq_len=SEQ, batch_size=ROWS, pack=True, num_steps=FIT_STEPS, mesh=mesh)
    trained = result.state.layout.whole_model(result.state.params)
    served = DecodeEngine(trained, mesh=mesh, **ENGINE_KW)
    out["trained_local"] = int(served._model.layers[1].moe_mlp.w_in.shape[0])
    out["trained"] = streams(rank, served)
    gathered = extract_state(result.state)  # a collective: every rank gathers
    if rank == 0:
        out["unmeshed"] = drain(e := DecodeEngine(whole, **ENGINE_KW), e.admit_many(REQUESTS))
        plain = init_gpt(gpt_config(**SPARSE), device="cpu")
        with torch.no_grad():
            for name, param in plain.named_parameters():
                param.copy_(gathered["params"][name])
        out["checkpoint"] = drain(e := DecodeEngine(plain, **ENGINE_KW), e.admit_many(REQUESTS))
    return out


def scenario_resident(rank, ctx):
    """``ResidentPredictor`` over ``{"sequence": 2}``: BERT ring and Ulysses
    and the GPT ring LM keep their sequence-parallel attention and each
    rank takes its chunk; the dense predictor beside each (rank 0); a ladder
    the axis does not divide; ``serving_app(mesh=)``'s ``/predict``."""
    from unionml_tpu_torch.models import create_train_state, init_bert, init_gpt
    from unionml_tpu_torch.serving import ResidentPredictor, serving_app

    mesh = _mesh(sequence=2)
    models = {
        "bert_ring": lambda sp: init_bert(bert_config(**sp), params=ctx.bert_params, device="cpu"),
        "bert_ulysses": lambda sp: init_bert(bert_config(**sp), params=ctx.bert_params, device="cpu"),
        "gpt_ring": lambda sp: init_gpt(gpt_config(**sp), params=ctx.gpt_params, device="cpu"),
    }
    out = {}
    for name, build in models.items():
        impl = name.split("_")[1]
        served = app(name, create_train_state(build(dict(attention_impl=impl, sp_mesh=mesh))))
        predictor = ResidentPredictor(served, buckets=BUCKETS, seq_buckets=SEQ_BUCKETS, warmup=False, mesh=mesh,
                                      device="cpu")
        out[name] = led_predictor(rank, predictor, lambda p: [p.predict(features=rows) for rows in ROW_SETS])
        out[f"{name}_kept"] = predictor._device_model_object.model.config.attention_impl
        if rank == 0:
            dense = ResidentPredictor(app(name, create_train_state(build({}))), buckets=BUCKETS,
                                      seq_buckets=SEQ_BUCKETS, warmup=False, device="cpu")
            out[f"{name}_dense"] = [dense.predict(features=rows) for rows in ROW_SETS]
    odd = ResidentPredictor(app("odd", create_train_state(models["bert_ring"](dict(attention_impl="ring",
                                                                                   sp_mesh=mesh)))),
                            buckets=BUCKETS, seq_buckets=ODD_LADDER, warmup=False, mesh=mesh, device="cpu")

    def refused(p):
        try:
            p.predict(features=ODD_ROWS)
        except ValueError as exc:
            return f"{type(exc).__name__}: {exc}"
        return None

    out["odd_ladder"] = led_predictor(rank, odd, refused)
    ring = app("app", create_train_state(models["bert_ring"](dict(attention_impl="ring", sp_mesh=mesh))))
    web = serving_app(ring, mesh=mesh, buckets=BUCKETS, seq_buckets=SEQ_BUCKETS, device="cpu")
    predictor = web["resident_predictor"]
    if rank == 0:
        out["app"] = serve_predict(web, [{"features": rows} for rows in ROW_SETS])
        out["released"] = predictor._lead.stopped
    else:
        out["app"] = {"followed": predictor.follow()}
    return out


SCENARIOS = {"fsdp": scenario_fsdp, "sequence": scenario_sequence, "expert": scenario_expert,
             "resident": scenario_resident}


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
