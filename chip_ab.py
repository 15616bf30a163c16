"""A/B of two trees of the port on one GPU: attention kernels, training and serving steps, in turns.

    python3 chip_ab.py OTHER_TREE [--serving | --seeds N | --serve-seeds N] [--one-turn] [--out PATH]

``OTHER_TREE`` holds another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists, such as ``build/``). The script runs four turns in the
order other, this, this, other; each turn is a process of its own with that
tree first on ``sys.path``, so it builds and measures that tree's own
kernels with that tree's own ``chip_smoke.py`` helpers:

- K1, K2 and K3 device ms per call by kernel name (torch.profiler) at the BERT
  fine-tune shape (bf16 B64 H12 S128 D64 with ``chip_smoke``'s kv_lens) and
  the packed LM shape (bf16 B8 H12 S1024 D64 causal, the first training
  batch's segment ids); each whole backward call; and at the LM shape one
  forward + backward through autograd (K1's skip map reused by K2/K3 where
  the tree does so);
- device ms per train step (the kernels' device time summed over a profile of
  5 steps), wall ms per step and the device's idle share, for BERT-base
  fine-tuning (bf16, B64 S128) and packed GPT-2-small LM training (B8 S1024)
  on a device-resident batch;
- the serving measurements below.

With ``--serving`` each turn takes only the serving measurements: K4 (paged
attention, bf16 queries over an int8 pool) through ``chip_smoke.time_k4``
(device ms by the profiler, its bound, plain and gather + SDPA ms) at the
chunk (B1 H12 S256, bases 256 and 768), the decode step's short bases (B8,
``chip_smoke``'s mid-generation rows) and a long context (B8, bases
1000-1022), all at width 65; then on GPT-2 small (bf16, seeded random
weights, ``chip_smoke``'s engine: int8 pool, 8 slots, max_len 1024, chunk
256) the decode step's device ms, wall ms and idle share
(``chip_smoke.profile_decode``) and the time to first token of the
400-token prompt on an idle engine (two prefill chunks, median of 5 after
one warm-up).

With ``--serve-seeds N`` each turn runs ``chip_smoke``'s 10 serving requests
over weight and prompt seeds 0..N-1 on five paths (``SWEEP_PATHS``: the
kernels bf16, K1 alone with K4's plain version, K4 alone with K1's plain
version, plain bf16, plain f32), each an unpipelined engine stepped with the
requests admitted in arrival order, and records the f32 logits that picked
every greedy token. Per pair of paths (``SWEEP_PAIRS``: (a) plain bf16 against
plain f32, (b) the kernels against plain f32, (b1) and (b4) one kernel against
plain f32, (c) the kernels against plain bf16) it counts the greedy streams
that split beyond the 1e-2 gate (a split where the compared-to path's top-2
logit gap is at least 1e-2) and each stream's largest logit error over the
tokens both paths chose in the same context: whether a kernel adds error
beyond bf16 noise, and which one.

With ``--one-turn`` only one turn runs, on this tree (for a sweep of one
tree's code).

With ``--seeds N`` each turn instead holds its tree's bf16 K2/K3 to the plain
backward (``chip_smoke``'s tolerance) over input seeds 0..N-1 at the BERT
and packed LM shapes, runs BERT-base's first three train steps against the
plain path over weight seeds 0..N/2-1 (``chip_smoke``'s 1e-2 loss and 2 %
grad_norm gates), and times K2/K3 at both shapes: the sweep that decides a
rounding choice between two versions of a kernel.

It prints the card's name and power limit and one JSON line per turn, and
writes them all to ``--out`` when given. Without a CUDA device it exits 2.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

STEPS = 5


def _kernels(fn) -> dict:
    """Device ms per call of the attention kernels ``fn`` launches, and of all its kernels."""
    import chip_smoke as cs

    by_name = cs.kernel_ms_by_name(fn)
    out = {name: sum(ms for n, ms in by_name.items() if f"{name}_" in n)
           for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out["call"] = sum(by_name.values())
    return out


def _step(step, state, batch) -> dict:
    import chip_smoke as cs

    step(state, batch)
    step(state, batch)
    prof = cs.step_profile(lambda: step(state, batch), STEPS, top=12)
    return {key: prof[key] for key in ("wall_ms_per_step", "device_ms_per_step", "device_idle_share",
                                       "top_kernels_ms_per_step")}


def worker(label: str) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    import unionml_tpu_torch
    from unionml_tpu_torch._device import set_precision_flags
    from unionml_tpu_torch.models import (
        BertConfig, GPTConfig, bert_random_params, dict_batches, make_classifier_train_step, make_lm_train_step,
        random_params,
    )
    from unionml_tpu_torch.ops.attention import flash_attention, flash_attention_backward

    set_precision_flags()
    device = torch.device("cuda")
    result = {"tree": label, "package": unionml_tpu_torch.__file__}

    bert = BertConfig.base()
    data = cs.bert_data(bert, rows=4 * cs.BERT_BATCH)
    lens = data["attention_mask"][:cs.BERT_BATCH].sum(-1).tolist()
    q, k, v, d_out, kv_lens = cs.bwd_inputs(cs.BERT_BATCH, 12, cs.BERT_SEQ, 64, torch.bfloat16, device, lens)
    d_out = d_out.contiguous()
    out, lse = flash_attention(q, k, v, kv_lens=kv_lens, return_lse=True)
    result["bert_forward"] = _kernels(lambda: flash_attention(q, k, v, kv_lens=kv_lens, return_lse=True))
    result["bert_backward"] = _kernels(lambda: flash_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens))

    packed = cs.lm_packed()
    ids = torch.from_numpy(packed["segment_ids"][:cs.LM_BATCH]).to(device)
    q, k, v, d_out, _ = cs.bwd_inputs(cs.LM_BATCH, 12, cs.LM_SEQ, 64, torch.bfloat16, device, None, seed=7)
    d_out = d_out.contiguous()
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True, segment_ids=ids)
    result["lm_forward"] = _kernels(lambda: flash_attention(q, k, v, causal=True, return_lse=True, segment_ids=ids))
    result["lm_backward"] = _kernels(
        lambda: flash_attention_backward(q, k, v, out, lse, d_out, causal=True, segment_ids=ids))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    result["lm_autograd"] = _kernels(
        lambda: torch.autograd.grad(flash_attention(*leaves, causal=True, segment_ids=ids), leaves, d_out))
    del q, k, v, d_out, out, lse, leaves

    state = cs.bert_state(bert, bert_random_params(bert, seed=0), device)
    batch = next(iter(dict_batches(data, cs.BERT_BATCH, rng=np.random.default_rng(1), device=device)))
    result["bert_step"] = _step(make_classifier_train_step(input_signature=cs.BERT_SIG), state, batch)
    del state
    torch.cuda.empty_cache()

    gpt = GPTConfig()
    state = cs.lm_state(gpt, random_params(gpt, seed=0), device)
    lm_data = {key: packed[key] for key in ("input_ids", "segment_ids")}
    batch = next(iter(dict_batches(lm_data, cs.LM_BATCH, rng=np.random.default_rng(1), device=device)))
    result["lm_step"] = _step(make_lm_train_step(packed=True), state, batch)
    return result


K4_SHAPES = {  # (S, bases) at width 65
    "chunk base 256": (256, [256]),
    "chunk base 768": (256, [768]),
    "decode short bases": (1, None),
    "decode long context": (1, [1000, 1003, 1007, 1008, 1011, 1015, 1016, 1022]),
}


def serving(label: str) -> dict:
    import dataclasses
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    import unionml_tpu_torch
    from unionml_tpu_torch._device import set_precision_flags
    from unionml_tpu_torch.models import GPTConfig, random_params

    set_precision_flags()
    device = torch.device("cuda")
    result = {"tree": label, "package": unionml_tpu_torch.__file__, "k4": {}}
    short = [n + cs.MAX_NEW // 2 for n, _ in cs.REQUESTS[:8]]
    for name, (S, bases) in K4_SHAPES.items():
        r = cs.time_k4(device, S, bases or short, None)
        result["k4"][name] = {key: r[key] for key in ("shape", "ms", "bound_ms", "plain_ms", "library_ms",
                                                      "kernel_by_name_ms")}
    config = dataclasses.replace(GPTConfig(), dtype=torch.bfloat16)
    engine = cs.build_engine(config, random_params(config, seed=0), device, impl="auto")
    prompt_list = cs.prompts(config.vocab_size)
    cs.serve(engine, [prompt_list[0]], device)  # warm-up
    result["decode_step"] = cs.profile_decode(engine, prompt_list)
    long = next(p for p in prompt_list if len(p) > cs.PREFILL_CHUNK)
    ttft = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = engine.add_request(long, cs.MAX_NEW)
        while not any(ev.slot == slot and ev.emit for ev in engine.step()):
            pass
        ttft.append((time.perf_counter() - t0) * 1e3)
        engine.abort_all()
    result["ttft_400_ms"] = {"median": float(np.median(ttft[1:])), "runs": ttft[1:]}
    return result


#: the sweep's paths: (attention_impl, paged_attn_impl, dtype); K1 and K4 swapped for their plain versions one at a time
SWEEP_PATHS = {
    "kernel_bf16": ("auto", "auto", "bfloat16"),
    "k1_only_bf16": ("auto", "reference", "bfloat16"),
    "k4_only_bf16": ("reference", "auto", "bfloat16"),
    "plain_bf16": ("reference", "reference", "bfloat16"),
    "plain_f32": ("reference", "reference", "float32"),
}
#: (path, compared-to path) pairs the sweep counts
SWEEP_PAIRS = {
    "a_plain_bf16_vs_plain_f32": ("plain_bf16", "plain_f32"),
    "b_kernel_bf16_vs_plain_f32": ("kernel_bf16", "plain_f32"),
    "b1_k1_only_vs_plain_f32": ("k1_only_bf16", "plain_f32"),
    "b4_k4_only_vs_plain_f32": ("k4_only_bf16", "plain_f32"),
    "c_kernel_bf16_vs_plain_bf16": ("kernel_bf16", "plain_bf16"),
}


def logged_serve(engine, prompt_list, requests, max_new):
    """Serve ``requests`` on ``engine`` step by step, unpipelined, admitting in
    arrival order as slots free (a chunked prefill runs all its chunks at
    admission); returns each request's stream and, for the
    greedy ones, the f32 logits (host) that picked each of its tokens."""
    import numpy as np

    engine.pipeline = False
    pending = list(range(len(prompt_list)))
    streams = {i: [] for i in pending}
    logits = {i: [] for i in pending}
    slot_of = {}
    while pending or slot_of:
        take, pending = pending[:len(engine.free_slots)], pending[len(engine.free_slots):]
        if take:
            slots = engine.admit_many([(prompt_list[i], max_new, requests[i][1] or {}) for i in take])
            slot_of.update(zip(slots, take))
            while engine._partials:  # finish a chunked prefill before the next decode step
                engine._advance_partials()
        active = [int(s) for s in np.flatnonzero(engine._active)]
        before = dict(zip(active, engine._last_logits[active].float().cpu())) if active else {}
        for ev in engine.step():
            i = slot_of[ev.slot]
            if ev.emit:
                streams[i].append(ev.token)
                if requests[i][1] is None:
                    logits[i].append(before[ev.slot])
            if ev.finished:
                del slot_of[ev.slot]
    return [streams[i] for i in range(len(prompt_list))], [logits[i] for i in range(len(prompt_list))]


def compare_logged(got, want, requests, gate) -> dict:
    """Per greedy stream of ``got`` against ``want`` (each a ``logged_serve``
    result): where it splits, ``want``'s top-2 logit gap there, and the largest
    logit error over the tokens both streams chose in the same context."""
    import torch

    streams, errs, splits = [], [], []
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        if requests[i][1] is not None:
            continue
        split = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        same_context = len(a) if split is None else split + 1
        err = max(float((x - y).abs().max()) for x, y in zip(got[1][i][:same_context], want[1][i][:same_context]))
        errs.append(err)
        if split is not None:
            top = torch.topk(want[1][i][split], 2).values
            splits.append({"request": i, "split": split, "gap": float(top[0] - top[1]), "logit_err": err})
    return {"splits": splits, "beyond_gate": sum(s["gap"] >= gate for s in splits), "streams": len(errs),
            "max_logit_err_per_stream": errs}


def serve_sweep(label: str, n_seeds: int, config=None, device=None) -> dict:
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    import unionml_tpu_torch
    from unionml_tpu_torch._device import set_precision_flags
    from unionml_tpu_torch.models import GPTConfig, init_gpt, random_params
    from unionml_tpu_torch.serving.continuous import DecodeEngine

    set_precision_flags()
    device = device or torch.device("cuda")
    base = config or GPTConfig()
    result = {"tree": label, "package": unionml_tpu_torch.__file__, "seeds": []}
    for seed in range(n_seeds):
        params = random_params(base, seed=seed)
        prompt_list = cs.prompts(base.vocab_size, seed=seed)
        runs = {}
        for key, (attn, paged, dtype) in SWEEP_PATHS.items():
            cfg = dataclasses.replace(base, dtype=getattr(torch, dtype), attention_impl=attn, paged_attn_impl=paged)
            engine = DecodeEngine(init_gpt(cfg, params=params, device=device), num_slots=8,
                                  max_len=min(1024, cfg.max_position_embeddings), kv_quantize="int8",
                                  prefill_chunk=cs.PREFILL_CHUNK, seed=0, device=device)
            runs[key] = logged_serve(engine, prompt_list, cs.REQUESTS, cs.MAX_NEW)
            del engine
        row = {"seed": seed}
        for pair, (a, b) in SWEEP_PAIRS.items():
            row[pair] = compare_logged(runs[a], runs[b], cs.REQUESTS, cs.GAP_LIMIT_BF16)
        result["seeds"].append(row)
        del runs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    result["streams_beyond_gate"] = {
        pair: sum(row[pair]["beyond_gate"] for row in result["seeds"]) for pair in SWEEP_PAIRS}
    result["streams"] = sum(row["b_kernel_bf16_vs_plain_f32"]["streams"] for row in result["seeds"])
    result["max_logit_err_quantiles"] = {
        pair: [float(q) for q in np.quantile(
            [e for row in result["seeds"] for e in row[pair]["max_logit_err_per_stream"]], [0.5, 0.9, 1.0])]
        for pair in SWEEP_PAIRS}
    return result


def _excess(got, want, tol) -> dict:
    """``chip_smoke.check_close``'s rule without raising: the worst margin
    past atol + rtol |want| (positive = beyond) and the elements beyond."""
    err = (got.float() - want.float()).abs()
    excess = err - (tol + tol * want.float().abs())
    return {"max_abs_err": float(err.max()), "excess": float(excess.max()), "n_beyond": int((excess > 0).sum())}


def seed_sweep(label: str, n_seeds: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    import unionml_tpu_torch
    from unionml_tpu_torch._device import set_precision_flags
    from unionml_tpu_torch.models import BertConfig, bert_random_params, dict_batches
    from unionml_tpu_torch.ops.attention import (
        flash_attention, flash_attention_backward, reference_attention_backward,
    )

    set_precision_flags()
    device = torch.device("cuda")
    tol = cs.BWD_TOL[torch.bfloat16]
    result = {"tree": label, "package": unionml_tpu_torch.__file__, "checks": [], "first_steps": []}
    for seed in range(n_seeds):
        lens = cs.ragged_lens(cs.BERT_BATCH, cs.BERT_SEQ, np.random.default_rng(seed))
        q, k, v, d_out, kv_lens = cs.bwd_inputs(cs.BERT_BATCH, 12, cs.BERT_SEQ, 64, torch.bfloat16, device, lens,
                                                seed=seed)
        ids = torch.from_numpy(cs.lm_packed(seed)["segment_ids"][:cs.LM_BATCH]).to(device)
        cases = {"bert": (q, k, v, d_out, dict(kv_lens=kv_lens))}
        q, k, v, d_out, _ = cs.bwd_inputs(cs.LM_BATCH, 12, cs.LM_SEQ, 64, torch.bfloat16, device, None, seed=seed)
        cases["lm"] = (q, k, v, d_out, dict(causal=True, segment_ids=ids))
        for shape, (q, k, v, d_out, kw) in cases.items():
            out, lse = flash_attention(q, k, v, return_lse=True, **kw)
            got = flash_attention_backward(q, k, v, out, lse, d_out, **kw)
            want = reference_attention_backward(q, k, v, out, lse, d_out, **kw)
            for grad, a, b in zip(("dq", "dk", "dv"), got, want):
                result["checks"].append({"seed": seed, "shape": shape, "grad": grad, **_excess(a, b, tol)})
            if seed == 0:
                result[f"{shape}_kernels"] = _kernels(lambda: flash_attention_backward(q, k, v, out, lse, d_out, **kw))
            del out, lse, got, want
    config = BertConfig.base()
    for seed in range(max(1, n_seeds // 2)):
        params = bert_random_params(config, seed=seed)
        data = cs.bert_data(config, rows=4 * cs.BERT_BATCH, seed=seed)
        batches = list(dict_batches(data, cs.BERT_BATCH, rng=np.random.default_rng(1), device=device))[:3]
        kernel = cs.first_steps(config, params, device, "auto", batches)
        plain = cs.first_steps(config, params, device, "reference", batches)
        for i, (a, b) in enumerate(zip(kernel, plain)):
            result["first_steps"].append({
                "seed": seed, "step": i, "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                "grad_norm_rel": abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])})
        torch.cuda.empty_cache()
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other tree (e.g. the parent commit unpacked under build/)")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--seeds", type=int, help="run the seed sweep (see above) instead of the timings")
    mode.add_argument("--serving", action="store_true", help="time K4 and the serving step only (see above)")
    mode.add_argument("--serve-seeds", type=int, help="run the serving seed sweep (see above)")
    parser.add_argument("--one-turn", action="store_true", help="run one turn, on this tree only")
    parser.add_argument("--out", type=Path, help="write every turn's measurements to this JSON file")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:  # one turn: args.other is this turn's tree
        if args.seeds:
            turn = seed_sweep(args.worker, args.seeds)
        elif args.serve_seeds:
            turn = serve_sweep(args.worker, args.serve_seeds)
        else:
            turn = serving(args.worker) if args.serving else {**worker(args.worker), **serving(args.worker)}
        print(json.dumps(turn, default=str))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    here = Path(__file__).resolve().parent
    turns = []
    order = (("this", here),) if args.one_turn else (
        ("other", args.other), ("this", here), ("this", here), ("other", args.other))
    for label, tree in order:
        tree = tree.resolve()
        argv = ["chip_ab.py", str(tree), "--worker", label]
        argv += ["--seeds", str(args.seeds)] if args.seeds else []
        argv += ["--serve-seeds", str(args.serve_seeds)] if args.serve_seeds else []
        argv += ["--serving"] if args.serving else []
        code = ("import sys; sys.path[0] = {!r}; sys.argv = {!r}; "
                "import runpy; runpy.run_path({!r}, run_name='__main__')").format(
                    str(tree), argv, str(here / "chip_ab.py"))
        env = {**os.environ, "PYTHONPATH": str(tree)}
        proc = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append(turn)
        print(json.dumps(turn))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
