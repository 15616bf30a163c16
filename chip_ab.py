"""A/B of two trees of the port on one GPU: attention kernels and training steps, in turns.

    python3 chip_ab.py OTHER_TREE [--seeds N] [--out PATH]

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
  on a device-resident batch.

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
    parser.add_argument("--seeds", type=int, help="run the seed sweep (see above) instead of the timings")
    parser.add_argument("--out", type=Path, help="write every turn's measurements to this JSON file")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:  # one turn: args.other is this turn's tree
        print(json.dumps(seed_sweep(args.worker, args.seeds) if args.seeds else worker(args.worker)))
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
    for label, tree in (("other", args.other), ("this", here), ("this", here), ("other", args.other)):
        tree = tree.resolve()
        argv = ["chip_ab.py", str(tree), "--worker", label] + (["--seeds", str(args.seeds)] if args.seeds else [])
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
