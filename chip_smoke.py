"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve, train, time.

    python3 chip_smoke.py [--details PATH]

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build every kernel in ``unionml_tpu_torch/csrc/`` (one ``nvcc`` each, in
   parallel) and print the build seconds and each kernel's ptxas registers
   and spills;
2. K1 (flash forward) against its plain PyTorch version at the engine's
   prefill shapes, causal and with ``kv_lens``, bf16 and f32; in bf16 also
   at the tensor-core body's tile edges (Sq, Sk of 1, 63-65, 127-129, Sq !=
   Sk, kv_len 0 and 1, D 128) and in packed mode (the training rows, phase
   7's shapes, segment boundaries on and inside 64-row tiles); every lse
   against ``torch.logsumexp`` of the plain masked scores (1e-4 on rows that
   see a key, -1e30 on rows that see none);
3. K4 (paged attention) against its plain version, both bodies (the
   split-key decode body for S <= 8, the query-tile bodies above): bf16
   queries over int8 and bf16 pools, f32 over int8 and f32 pools; S = 1, 2,
   5, 15-17, 63-65, 127-129, 144, 256 at D 64 with block sizes 8, 16, 32 and
   at D 128 with 16; bases at block edges, across a 16-column split and a
   64-key tile; one mapped block of scale 0; the serving shapes (B8 S1 and
   B1 S256 at width 65, ragged bases, scratch tail columns); the long-context
   decode (B8, bases 1000-1022, widths 65 and 129); a retired row at the
   sentinel position (finite, and the other rows bitwise unchanged); and the
   decode body's bitwise invariance: one row's output equal alone, in a
   batch of 8 and under a 129-column table mapping the same blocks;
4. K2/K3 (flash backward: dQ, and dK/dV) against their plain version, bf16
   (the tensor-core bodies) and f32 (the CUDA-core bodies): BERT shapes (B 8
   and 64, H 12, S 128, D 64, ragged ``kv_lens`` including 1 and 128),
   ragged S 100 and 77, causal S 256, D 128 at S 77, and in bf16 the
   tensor-core bodies' tile edges (K1's edge cases: Sq, Sk of 1, 63-65,
   127-129, Sq != Sk, kv_len 0 and 1, D 128);
   keys past ``kv_len`` must get exact zeros; and ``torch.autograd.grad``
   through ``flash_attention`` against the same through
   ``reference_attention`` (on f32 copies of bf16 inputs);
5. serving end to end: GPT-2 small at full width with seeded random
   weights, bf16, an int8 paged pool with 8 slots and max_len 1024, serving
   10 concurrent requests through ``ContinuousBatcher`` (prompts 7..400
   tokens across several buckets, one chunked prefill, one top-k/top-p
   sampled request). The kernels' launch counts must move, and the greedy
   streams must agree with the same engine on the plain PyTorch path
   (``impl="reference"``): a split only counts as agreement where the plain
   path's top-2 logit gap at the split is below 1e-2. An f32 run of the same
   comparison must give identical streams. In one bf16 decode step and one
   chunked-prefill chunk the profiler's kernel names must show K4's decode
   body (with its merge kernel) and its tensor-core query tile, and no other
   K4 body;
6. training end to end: BERT-base at full width (vocab 30522, d 768, 12
   layers, 12 heads) with seeded random weights, bf16, seq 128, batch 64,
   ``bench.py``'s recipe (lr 2e-5, warmup 10, total 1000), right-padded
   inputs with lengths 16..128, 20 steps through ``fit`` and one
   ``make_classifier_eval_step`` call. K1, K2 and K3 must each launch 12
   times per step; every loss must be finite; the first 3 steps on the plain
   path (``attention_impl="reference"``, same weights and dropout) must give
   losses within 1e-2 relative and ``grad_norm`` within 2 %; in f32 at batch
   8, one step's gradients must agree, kernel vs plain, within 1e-4 of each
   leaf's largest magnitude;
7. the segment-id (packed) mode of K1, K2 and K3 against their plain
   versions, bf16 and f32: B8 H12 S1024 D64 causal with ids from
   ``pack_sequences`` over the seeded corpus, S 77 (three segments and a
   padding tail), S 128 (ids that recur non-contiguously, interior zeros),
   Sq 96 / Sk 160 and Sq 160 / Sk 96 from one id array, non-causal S 128,
   D 128 at S 77; padding queries must write zeros and padding keys get exact
   zero dK/dV; and whole autograd through ``flash_attention(segment_ids=...)``
   against plain autograd (on f32 copies of bf16 inputs);
8. packed forward equals per-sequence forward: one packed row of GPT-2-small
   width in f32, each segment's logits against the same sequence run alone,
   within 1e-4;
9. packed LM training end to end: GPT-2 small at full width (f32 parameters,
   bf16 compute, dropout 0.1), 512 seeded sequences (``bench_packing.py``'s
   length model at seq_len 1024), ``create_train_state(lr 3e-4, warmup 10,
   total 1000)`` then ``fit_lm(pack=True, seq_len=1024, batch_size=8,
   num_steps=20, log_every=5)`` and one ``make_lm_eval_step(packed=True)``
   call. K1, K2 and K3 must each launch 12 times per step; every loss must
   be finite; the first 3 steps on the plain path (``attention_impl=
   "reference"``, same weights and dropout) must give losses within 1e-2
   relative and ``grad_norm`` within 2 %; in f32 at batch 2, one step's
   gradients must agree, kernel vs plain, within 1e-4 of each leaf's largest
   magnitude;
10. timings on the card: each kernel at a main-path shape (and one more)
   beside its bound, its plain version and one PyTorch library call, as device
   time from torch.profiler with the CUDA-event time per call beside it;
   engine tokens/s, time to first token, and one decode step's wall time
   against its kernels' device time; each train step's wall time, device
   time, idle share, examples/s, tokens/s and achieved TFLOP/s; for the LM
   step also real (nonzero-id) tokens/s and the packing efficiency; K1 at the
   packed shape beside K1 causal without ids, K1's achieved TFLOP/s, share
   of its bound and the kernel's own ms beside the whole call's; K2's and
   K3's achieved TFLOP/s and share of their bound, beside SDPA's backward
   alone and SDPA forward + backward, and the torch ops around them (delta).
   In one bf16 BERT and one LM step the profiler's kernel names must show
   the tensor-core bodies of K1, K2 and K3 and none of their CUDA-core (f32)
   bodies.

11. the BERT app end to end through the port's ``Dataset`` and ``Model``
   (``build_bert_app``: the flagship template's shape at BERT-base width,
   bf16 compute on f32 parameters, S 128): ``Model.train`` trains 20 steps
   at B64 with ``fit(checkpoint_dir=..., checkpoint_every=10)`` (K2/K3 must
   launch 12 times per step); the latest checkpoint (step 20) must restore
   bitwise and ``fit`` resume from it; ``Model.save``, then a fresh
   ``Model.load`` through ``UNIONML_MODEL_PATH``, bitwise; a
   ``ResidentPredictor`` (batch buckets 1..64, sequence buckets 32/64/128,
   ``example_features``) answers 32 requests of 1-8 rows of 5-128 tokens,
   half through ``RequestBatcher``, half directly, by CUDA-graph replay: the
   labels must equal the plain path's (``attention_impl="reference"``, eager)
   wherever its top-2 logit gap is >= 1e-2, an f32 app's logits must agree
   with the plain f32 logits within 1e-4, the bf16 logits of every request
   replayed must agree with the same padded inputs run eagerly through the
   same kernels within one bf16 rounding step (the graph holds the tensor-core
   K1 body to the launches it recorded), no request may fall back to eager,
   and a bf16 replay's profile must show ``flash_fwd_wgmma_kernel``. Prints
   each graph's capture ms, p50/p90 ms per request (replay against eager) at
   buckets (1, 32) and (64, 128), rows/s at (64, 128), a replay's device ms
   against its wall ms, and ``fit`` ms per step with checkpoints against
   without.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``. ``--details PATH`` also writes every
measurement as JSON. Without a CUDA device the script exits 2 and prints no
result.
"""

import argparse
import asyncio
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # atol (and rtol for bf16); see check_close
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # the same for K2/K3 and whole autograd
GAP_LIMIT_BF16 = 1e-2

# the served requests: (prompt_len, sampling); max_new_tokens 32 each
REQUESTS = [(7, None), (13, None), (30, None), (60, None), (100, None), (150, None),
            (200, None), (400, None), (20, dict(temperature=0.8, top_k=50, top_p=0.9)), (90, None)]
MAX_NEW = 32
PREFILL_CHUNK = 256  # only the 400-token prompt prefills in chunks


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tols=TOL, scaled: bool = False) -> float:
    """Max abs error; raises past the tolerance of ``got``'s dtype (f32: atol
    2e-5; bf16: atol 2e-2 + rtol 2e-2, a few bf16 ulps, since the plain version
    rounds the softmax weights to bf16 before the value product). K2/K3
    (``BWD_TOL``): f32 atol 1e-4, gradients summing up to 256 terms of
    size ~1; bf16 the same as K1. ``scaled``: the bf16 atol is taken
    relative to the largest magnitude of ``want`` where that exceeds 1 (see
    ``check_k2_k3``)."""
    tol = tols[got.dtype]
    err = (got.float() - want.float()).abs()
    atol = tol
    if scaled and got.dtype == torch.bfloat16:
        atol = tol * max(1.0, float(want.float().abs().max()))
    limit = atol + (tol * want.float().abs() if got.dtype == torch.bfloat16 else 0.0)
    bad = (err > limit) | ~torch.isfinite(got.float())
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{name}: max |err| {max_err:.3e} beyond tolerance atol {atol:.3e} (rtol {tol})")
    return max_err


def ptxas_report(log: str):
    """(kernel, "registers ...; spills ...") per compiled entry function of a
    ``-Xptxas=-v`` log."""
    kernel, spills = None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            name = re.search(r"(?:^|\D)\d+?((?:flash|paged)_[a-z0-9_]*?_kernel)I", mangled)
            types = re.findall(r"uml\d(F32|BF16)|(I8)E", mangled)
            dims = re.search(r"Li(\d+)E", mangled)
            quant = re.search(r"ILb([01])E", mangled)  # the bf16 query tile's int8 / bf16 pool
            params = [a or b for a, b in types] + (["int8 pool" if quant.group(1) == "1" else "bf16 pool"]
                                                   if quant else []) + [f"D{dims.group(1) if dims else '?'}"]
            kernel = "{}<{}>".format(name.group(1) if name else mangled, ", ".join(params))
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line and kernel is not None:
            yield kernel, f"{line.split(':', 1)[1].strip()}; {spills}"


def cuda_ms(fn, iters: int = 20) -> float:
    """Per-call time between CUDA events around ``iters`` back-to-back calls:
    the device time, or the host's launch cost where that is longer."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _kernel_us(prof) -> dict:
    """Device microseconds per kernel name from a CUDA-only profile."""
    out = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us:
            out[event.key] = out.get(event.key, 0.0) + float(us)
    return out


def kernel_ms_by_name(fn, iters: int = 20) -> dict:
    """Per-call device ms of each kernel ``fn`` launches, by kernel name: the
    CUDA kernels' own durations (torch.profiler / CUPTI, which also sees
    kernels launched through ctypes) over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a window in which the profiler recorded no device event at all is taken again, once
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = _kernel_us(prof)
        if by_name:
            break
    return {name: us / 1e3 / iters for name, us in by_name.items()}




def step_profile(fn, steps: int, top: int) -> dict:
    """Where a step's time goes: host wall time per step (``steps`` steps,
    synchronized) against the device time of its kernels (a CUDA profile of
    as many steps), and the ``top`` kernels by device time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = kernel_ms_by_name(fn, steps)
    dev_ms = sum(by_name.values())
    return {
        "wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms,
        "device_idle_share": 1.0 - dev_ms / wall_ms if wall_ms else None,
        "top_kernels_ms_per_step": [(name[:80], ms) for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
    }


def timed(fn) -> dict:
    """Device ms (profiler) where available, else the CUDA-event ms; both
    kept, with the names of the kernels that ran."""
    wall = cuda_ms(fn)
    by_name = kernel_ms_by_name(fn)
    dev = sum(by_name.values())
    return {"ms": dev if dev > 0 else wall, "event_ms": wall, "by_name_ms": by_name,
            "method": "profiler device time" if dev > 0 else "cuda events", "kernels": sorted(n[:60] for n in by_name)}


def own_kernel_ms(by_name: dict, name: str) -> float:
    """Device ms of the kernels whose names carry ``name`` (a wrapper's own
    kernel, without the torch ops around it)."""
    return sum(ms for n, ms in by_name.items() if name in n)


# ------------------------------------------------------------------ K1


def k1_inputs(B, H, S, D, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((B, H, S, D), generator=g).to(device=device, dtype=dtype) for _ in range(3))
    return q, k, v


def check_k1_lse(name, lse, q, k, mask, causal) -> float:
    """K1's lse against torch.logsumexp of the plain masked f32 scores (the
    same inputs): within 1e-4 on rows that see a key, exactly -1e30 on rows
    that see none (K2/K3 select on it)."""
    from unionml_tpu_torch.ops.attention import _masked_logits

    logits, valid = _masked_logits(q, k, mask, causal, q.shape[-1] ** -0.5)
    live = valid.expand(logits.shape).any(dim=-1)
    err = float((lse - torch.logsumexp(logits, dim=-1))[live].abs().max()) if bool(live.any()) else 0.0
    if err > 1e-4:
        raise AssertionError(f"{name}: lse max |err| {err:.3e} on rows that see a key (limit 1e-4)")
    if not bool((lse[~live] == -1e30).all()):
        raise AssertionError(f"{name}: rows that see no key must get lse -1e30")
    return err


# bf16 cases at the tensor-core body's tile edges (128-row query tiles of two
# 64-row warpgroups, 64-key tiles): B, H, Sq, Sk, D, causal, kv_lens
K1_EDGE_CASES = [
    (2, 12, 63, 63, 64, True, None), (2, 12, 64, 64, 64, True, None), (2, 12, 65, 65, 64, True, None),
    (2, 12, 127, 127, 64, False, [127, 64]), (2, 12, 128, 128, 64, True, None), (2, 12, 129, 129, 64, False, [1, 0]),
    (2, 12, 1, 1, 64, True, None), (2, 12, 1, 129, 64, False, [129, 65]), (2, 12, 65, 129, 64, True, None),
    (2, 12, 129, 65, 64, True, None), (2, 4, 129, 129, 128, True, None), (2, 4, 127, 65, 128, False, [0, 1]),
    (2, 4, 200, 300, 128, True, [300, 129]),
]
# packed ids whose boundaries fall on 64-row tile edges and inside tiles
K1_EDGE_IDS = [[(1, 64), (2, 64), (3, 70), (0, 58)], [(1, 30), (2, 100), (3, 126)]]


def check_k1(device) -> dict:
    from unionml_tpu_torch.ops.attention import (
        _combined_mask, _kv_lens_to_mask, flash_attention, reference_attention,
    )

    worst, worst_lse = 0.0, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        cases = [(B, 12, S, S, 64, True, None) for B in (1, 4) for S in (16, 100, 256, 512)]
        cases += [(4, 12, S, S, 64, False, [S, S // 2, 1, 0]) for S in (100, 512)]
        cases += [(2, 4, 77, 77, 128, True, None), (2, 4, 77, 77, 128, False, [77, 30])]
        if dtype == torch.bfloat16:
            cases += K1_EDGE_CASES
        for B, H, Sq, S, D, causal, lens in cases:
            q, k, v = k1_inputs(B, H, max(Sq, S), D, dtype, device, seed=S + B)
            q, k, v = q[:, :, :Sq].contiguous(), k[:, :, :S].contiguous(), v[:, :, :S].contiguous()
            kv_lens = torch.tensor(lens, device=device) if lens is not None else None
            out, lse = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, return_lse=True)
            mask = _kv_lens_to_mask(kv_lens, S) if kv_lens is not None else None
            want = reference_attention(q, k, v, mask=mask, causal=causal)
            name = f"K1 {dtype} B{B} H{H} Sq{Sq} Sk{S} D{D} causal={causal} kv_lens={lens}"
            worst = max(worst, check_close(name, out, want))
            worst_lse = max(worst_lse, check_k1_lse(name, lse, q, k, mask, causal))
    # bf16 packed: the training rows and the other packed shapes of phase 7, and the tile-edge ids
    packed = [(name, B, H, Sq, Sk, D, causal, ids) for name, B, H, Sq, Sk, D, causal, ids in packed_cases()]
    packed += [(f"tile-edge ids D{D} causal={c}", 2, 4, 256, 256, D, c, id_rows(K1_EDGE_IDS))
               for D in (64, 128) for c in (True, False)]
    for name, B, H, Sq, Sk, D, causal, ids in packed:
        ids = ids.to(device)
        g = torch.Generator(device="cpu").manual_seed(Sq + Sk + D)
        q = torch.randn((B, H, Sq, D), generator=g).to(device=device, dtype=torch.bfloat16)
        k, v = (torch.randn((B, H, Sk, D), generator=g).to(device=device, dtype=torch.bfloat16) for _ in range(2))
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True, segment_ids=ids)
        label = f"K1 bf16 packed {name} B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal={causal}"
        worst = max(worst, check_close(label, out, reference_attention(q, k, v, causal=causal, segment_ids=ids)))
        worst_lse = max(worst_lse, check_k1_lse(label, lse, q, k, _combined_mask(None, None, ids, Sq, Sk), causal))
    return {"max_abs_err": worst, "lse_max_abs_err": worst_lse}


# ------------------------------------------------------------------ K4


def k4_inputs(B, S, dtype, quantized, device, seed=0, H=12, D=64, bs=16, max_len=1024, bases=None, width=None,
              empty_block=False):
    """A filled pool (blocks for every row plus one scratch block), tables
    mapping exactly the blocks each row's last query needs, scratch tails;
    ``empty_block``: one mapped int8 block has scale 0."""
    rng = np.random.default_rng(seed)
    width = width or -(-max_len // bs) + 1
    if bases is None:
        bases = rng.integers(0, max_len - S, B)
    bases = np.asarray(bases, dtype=np.int64)
    need = (bases + S - 1) // bs + 1
    num_blocks = int(need.sum()) + 1
    scratch = num_blocks - 1
    perm = rng.permutation(num_blocks - 1)
    table = np.full((B, width), scratch, dtype=np.int32)
    start = 0
    for b in range(B):
        table[b, : need[b]] = perm[start : start + need[b]]
        start += need[b]
    shape = (num_blocks, H, bs, D)
    if quantized:
        k = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy(rng.uniform(0.005, 0.05, (num_blocks, H, 1, 1)).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.005, 0.05, (num_blocks, H, 1, 1)).astype(np.float32))
        if empty_block:
            ks[int(perm[0])] = vs[int(perm[0])] = 0.0
        pool = [t.to(device) for t in (k, v, ks, vs)]
    else:
        k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device=device, dtype=dtype)
        v = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device=device, dtype=dtype)
        pool = [k, v, None, None]
    q = torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32)).to(device=device, dtype=dtype)
    # int32 bases, as the engine passes them
    return q, pool, torch.from_numpy(table).to(device), torch.from_numpy(bases.astype(np.int32)).to(device)


K4_S = [1, 2, 5, 15, 16, 17, 63, 64, 65, 127, 128, 129, 144, 256]
K4_LONG_BASES = [1000, 1003, 1007, 1008, 1011, 1015, 1016, 1022]  # the long-context decode rows


def k4_bases(S: int, bs: int) -> list:
    """Decode rows at block edges (pos % bs of 0 and bs - 1) and across a
    16-column split; chunks at base 0 and at a base whose queries cross a
    split and a 64-key tile boundary."""
    split = 16 * bs
    if S <= 8:
        return [0, bs - 1, bs, 3 * bs - 1, split - 1, split, 2 * split - S // 2]
    return [0, max(bs - 1, split - S // 2 - 3)]


def check_k4(device) -> dict:
    from unionml_tpu_torch.ops.paged_attention import paged_attention, reference_paged_attention

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for quantized in (True, False):
            cases = [(k4_bases(S, bs), S, D, bs, 4, None)
                     for S in K4_S for D, bs in ((64, 8), (64, 16), (64, 32), (128, 16))]
            cases += [(None, 1, 64, 16, 12, None), (None, 256, 64, 16, 12, None)]  # the serving shapes
            cases += [(K4_LONG_BASES, 1, 64, 16, 12, w) for w in (65, 129)]
            for i, (bases, S, D, bs, H, width) in enumerate(cases):
                B = len(bases) if bases is not None else (8 if S == 1 else 1)
                q, (k, v, ks, vs), table, base = k4_inputs(
                    B, S, dtype, quantized, device, seed=i, H=H, D=D, bs=bs, bases=bases, width=width,
                    empty_block=True)
                got = paged_attention(q, k, v, table, base, ks, vs)
                want = reference_paged_attention(q, k, v, table, base, ks, vs)
                name = f"K4 {dtype} int8={quantized} B{B} H{H} S{S} D{D} bs{bs} width {table.shape[1]} bases {bases}"
                worst = max(worst, check_close(name, got, want))
            worst = max(worst, k4_decode_rows(device, dtype, quantized))
    return {"max_abs_err": worst}


def k4_decode_rows(device, dtype, quantized) -> float:
    """The decode body's row independence: one row's output is bitwise the
    same alone, in a batch of 8 and under a 129-column table mapping the same
    blocks; a retired row at the sentinel position stays finite and leaves
    the other rows bitwise unchanged (and within tolerance of the plain
    version)."""
    from unionml_tpu_torch.ops.paged_attention import paged_attention, reference_paged_attention

    bases = [5, 1000, 250, 16, 1022, 511, 64, 777]
    q, (k, v, ks, vs), table, base = k4_inputs(8, 1, dtype, quantized, device, seed=3, bases=bases)
    batch = paged_attention(q, k, v, table, base, ks, vs)
    wide = torch.cat([table, table[:, -1:].expand(-1, 64)], dim=1).contiguous()
    if not torch.equal(paged_attention(q, k, v, wide, base, ks, vs), batch):
        raise AssertionError(f"K4 {dtype} int8={quantized}: decode rows differ under a 129-column table")
    for r in range(len(bases)):
        alone = paged_attention(q[r:r + 1].contiguous(), k, v, table[r:r + 1].contiguous(), base[r:r + 1], ks, vs)
        if not torch.equal(alone[0], batch[r]):
            raise AssertionError(f"K4 {dtype} int8={quantized}: decode row {r} alone differs from the batch")
    table[1] = table[1, -1]  # row 1 retired: every column on the scratch block, at the sentinel position
    base[1] = (table.shape[1] - 1) * k.shape[2]
    got = paged_attention(q, k, v, table, base, ks, vs)
    live = [0, *range(2, len(bases))]
    if not bool(torch.isfinite(got[1].float()).all()) or not torch.equal(got[live], batch[live]):
        raise AssertionError(f"K4 {dtype} int8={quantized}: a retired row disturbed the others")
    return check_close(f"K4 {dtype} int8={quantized} with a retired row", got[live],
                       reference_paged_attention(q, k, v, table, base, ks, vs)[live])


# --------------------------------------------------------------- K2/K3


def ragged_lens(B: int, S: int, rng) -> list:
    """Right-padding lengths in 1..S with both S and 1 present."""
    lens = rng.integers(1, S + 1, B)
    lens[0], lens[-1] = S, 1
    return [int(n) for n in lens]


def bwd_inputs(B, H, S, D, dtype, device, lens, seed=0):
    """q, k, v and d_out (non-contiguous, as the head transpose leaves it)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((B, H, S, D), generator=g).to(device=device, dtype=dtype) for _ in range(3))
    d_out = torch.randn((B, S, H, D), generator=g).to(device=device, dtype=dtype).transpose(1, 2)
    kv_lens = torch.tensor(lens, device=device) if lens is not None else None
    return q, k, v, d_out, kv_lens


def check_k2_k3(device) -> dict:
    """K2/K3 against their plain version on the same out/lse/d_out, then
    whole autograd against autograd of the plain forward. In bf16 the plain
    forward runs on f32 copies of the same bf16 inputs, so the check measures
    the kernel path's whole error: K2/K3 keep f32 to the end and round once,
    but take delta = rowsum(dO * O) from K1's bf16 output, as the JAX kernels
    do. Where a short row's 128 queries all attend its one key, dK there is
    ~0 and sums 128 such delta roundings (measured up to 0.045, with
    gradients of magnitude 10-40 elsewhere); so the bf16 atol 2e-2 is taken
    relative to the gradient's largest magnitude (``scaled``)."""
    from unionml_tpu_torch.ops.attention import (
        _kv_lens_to_mask, flash_attention, flash_attention_backward, reference_attention,
        reference_attention_backward,
    )

    rng = np.random.default_rng(0)
    cases = [(8, 12, 128, 64, False, ragged_lens(8, 128, rng)), (64, 12, 128, 64, False, ragged_lens(64, 128, rng)),
             (4, 12, 100, 64, False, [100, 57, 1, 99]), (4, 12, 77, 64, False, [77, 1, 40, 76]),
             (2, 12, 256, 64, True, None), (2, 4, 77, 128, False, [77, 30]), (2, 4, 77, 128, True, None)]
    worst = {"kernels": 0.0, "autograd": 0.0}
    for B, H, Sq, S, D, causal, lens in K1_EDGE_CASES:  # the bf16 bodies' tile edges, kernels vs plain
        q, k, v, d_out, kv_lens = bwd_inputs(B, H, max(Sq, S), D, torch.bfloat16, device, lens, seed=Sq * 5 + S)
        q, d_out = q[:, :, :Sq].contiguous(), d_out[:, :, :Sq]
        k, v = k[:, :, :S].contiguous(), v[:, :, :S].contiguous()
        name = f"bf16 tile edge B{B} H{H} Sq{Sq} Sk{S} D{D} causal={causal} kv_lens={lens}"
        out, lse = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, return_lse=True)
        got = flash_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens, causal=causal)
        want = reference_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens, causal=causal)
        for label, a, b in zip(("dq", "dk", "dv"), got, want):
            worst["kernels"] = max(worst["kernels"], check_close(f"K2/K3 {name} {label}", a, b, BWD_TOL))
        for row, n in enumerate(lens or []):
            if bool(got[1][row, :, n:].any()) or bool(got[2][row, :, n:].any()) or (n == 0 and bool(got[0][row].any())):
                raise AssertionError(f"K2/K3 {name}: keys past kv_len {n} of row {row} (and dQ of a row that sees "
                                     "no key) must get zeros")
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, S, D, causal, lens in cases:
            q, k, v, d_out, kv_lens = bwd_inputs(B, H, S, D, dtype, device, lens, seed=B + S)
            name = f"{dtype} B{B} H{H} S{S} D{D} causal={causal} kv_lens={'ragged' if lens else None}"
            out, lse = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, return_lse=True)
            got = flash_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens, causal=causal)
            want = reference_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens, causal=causal)
            for label, a, b in zip(("dq", "dk", "dv"), got, want):
                worst["kernels"] = max(worst["kernels"], check_close(f"K2/K3 {name} {label}", a, b, BWD_TOL))
            for row, n in enumerate(lens or []):
                if bool(got[1][row, :, n:].any()) or bool(got[2][row, :, n:].any()):
                    raise AssertionError(f"K3 {name}: keys past kv_len {n} of row {row} must get zeros")
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            grads = torch.autograd.grad(flash_attention(*leaves, kv_lens=kv_lens, causal=causal), leaves, d_out)
            mask = _kv_lens_to_mask(kv_lens, S) if kv_lens is not None else None
            f32_leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
            plain = torch.autograd.grad(reference_attention(*f32_leaves, mask=mask, causal=causal), f32_leaves,
                                        d_out.float())
            for label, a, b in zip(("dq", "dk", "dv"), grads, plain):
                err = check_close(f"autograd {name} {label}", a, b, BWD_TOL, scaled=True)
                worst["autograd"] = max(worst["autograd"], err)
    return worst


# ------------------------------------------------- packed (segment ids)

LM_SEQ, LM_BATCH, LM_STEPS, LM_SEQS = 1024, 8, 20, 512


def lm_corpus(n_seqs: int, seq_len: int, seed: int = 0) -> list:
    """Seeded token sequences, the length model of ``bench_packing.py:25-32``:
    lognormal lengths with median seq_len / 4 and sigma 0.8, clipped to
    [1, 2 * seq_len]."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(mean=np.log(seq_len / 4), sigma=0.8, size=n_seqs).astype(np.int64),
                      1, 2 * seq_len)
    return [rng.integers(1, 50_000, size=int(n)).astype(np.int32) for n in lengths]


def lm_packed(seed: int = 0) -> dict:
    from unionml_tpu_torch.ops.packing import pack_sequences

    return pack_sequences(lm_corpus(LM_SEQS, LM_SEQ, seed), LM_SEQ)


def id_rows(rows) -> torch.Tensor:
    """An int32 id array from (id, run length) runs per row."""
    return torch.tensor([sum(([seg] * n for seg, n in row), []) for row in rows], dtype=torch.int32)


def packed_cases():
    """(name, B, H, Sq, Sk, D, causal, ids) of the packed-mode checks."""
    train_ids = torch.from_numpy(lm_packed()["segment_ids"][:LM_BATCH])
    three = [[(1, 20), (2, 33), (3, 14), (0, 10)], [(1, 77)], [(2, 40), (0, 37)], [(4, 77)]]
    mixed = [[(1, 30), (0, 6), (2, 40), (1, 20), (3, 32)], [(0, 5), (4, 60), (0, 3), (4, 50), (5, 10)]]
    cross = [[(1, 50), (2, 70), (0, 40)], [(1, 100), (2, 60)]]
    return [
        ("train rows", LM_BATCH, 12, LM_SEQ, LM_SEQ, 64, True, train_ids),
        ("three segments, padding tail", 4, 12, 77, 77, 64, True, id_rows(three)),
        ("non-contiguous ids, interior zeros", 2, 12, 128, 128, 64, True, id_rows(mixed)),
        ("cross-length Sq96 Sk160", 2, 12, 96, 160, 64, True, id_rows(cross)),
        ("cross-length Sq160 Sk96", 2, 12, 160, 96, 64, True, id_rows(cross)),
        ("non-causal", 2, 12, 128, 128, 64, False, id_rows(mixed)),
        ("D128", 4, 4, 77, 77, 128, True, id_rows(three)),
    ]


def check_packed(device) -> dict:
    """K1, K2 and K3 in segment-id mode against their plain versions (same
    out/lse for the backward), then whole autograd against plain autograd on
    f32 copies (bf16 atol relative to the gradient's largest magnitude, as in
    ``check_k2_k3``)."""
    from unionml_tpu_torch.ops.attention import (
        flash_attention, flash_attention_backward, reference_attention, reference_attention_backward,
    )

    worst = {"k1": 0.0, "k2k3": 0.0, "autograd": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, H, Sq, Sk, D, causal, ids in packed_cases():
            ids = ids.to(device)
            g = torch.Generator(device="cpu").manual_seed(Sq * 3 + Sk)
            q = torch.randn((B, H, Sq, D), generator=g).to(device=device, dtype=dtype)
            k, v = (torch.randn((B, H, Sk, D), generator=g).to(device=device, dtype=dtype) for _ in range(2))
            d_out = torch.randn((B, Sq, H, D), generator=g).to(device=device, dtype=dtype).transpose(1, 2)
            label = f"{dtype} {name} B{B} H{H} Sq{Sq} Sk{Sk} D{D} causal={causal}"
            out, lse = flash_attention(q, k, v, causal=causal, return_lse=True, segment_ids=ids)
            want = reference_attention(q, k, v, causal=causal, segment_ids=ids)
            worst["k1"] = max(worst["k1"], check_close(f"K1 packed {label}", out, want))
            if bool(out.transpose(1, 2)[ids[:, :Sq] == 0].any()):
                raise AssertionError(f"K1 packed {label}: padding queries must write zeros")
            got = flash_attention_backward(q, k, v, out, lse, d_out, causal=causal, segment_ids=ids)
            plain = reference_attention_backward(q, k, v, out, lse, d_out, causal=causal, segment_ids=ids)
            for grad, a, b in zip(("dq", "dk", "dv"), got, plain):
                worst["k2k3"] = max(worst["k2k3"], check_close(f"K2/K3 packed {label} {grad}", a, b, BWD_TOL))
            pad_keys = ids[:, :Sk] == 0
            if bool(got[1].transpose(1, 2)[pad_keys].any()) or bool(got[2].transpose(1, 2)[pad_keys].any()):
                raise AssertionError(f"K3 packed {label}: padding keys must get exact zeros")
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            grads = torch.autograd.grad(flash_attention(*leaves, causal=causal, segment_ids=ids), leaves, d_out)
            f32_leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
            plain = torch.autograd.grad(reference_attention(*f32_leaves, causal=causal, segment_ids=ids),
                                        f32_leaves, d_out.float())
            for grad, a, b in zip(("dq", "dk", "dv"), grads, plain):
                err = check_close(f"autograd packed {label} {grad}", a, b, BWD_TOL, scaled=True)
                worst["autograd"] = max(worst["autograd"], err)
            del out, lse, got, grads, plain, leaves, f32_leaves
    torch.cuda.empty_cache()
    return worst


def packed_equals_per_sequence(device) -> dict:
    """One packed row of GPT-2-small width in f32: each segment's logits
    against the same sequence run alone, within 1e-4 (the JAX invariant of
    ``tests/unit/test_packing.py::test_gpt_packed_forward_equals_per_sequence``)."""
    from unionml_tpu_torch.models import GPTConfig, init_gpt

    model = init_gpt(GPTConfig(dtype=torch.float32), seed=1, device=device).requires_grad_(False)
    packed = lm_packed()
    ids, segs = (torch.from_numpy(packed[k][:1]).to(device) for k in ("input_ids", "segment_ids"))
    logits = model(ids, segment_ids=segs)
    worst = 0.0
    for seg in range(1, int(segs.max()) + 1):
        where = torch.nonzero(segs[0] == seg)[:, 0]
        alone = model(ids[:, where])
        err = float((logits[:, where] - alone).abs().max())
        if err > 1e-4:
            raise AssertionError(f"packed segment {seg} ({where.numel()} tokens): logits differ by {err:.3e} from "
                                 "the sequence run alone")
        worst = max(worst, err)
    result = {"segments": int(segs.max()), "lengths": [int((segs == s).sum()) for s in range(1, int(segs.max()) + 1)],
              "max_abs_err": worst}
    del model, logits
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------- end to end


def prompts(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n, _ in REQUESTS]


def build_engine(config, params, device, *, impl: str):
    from unionml_tpu_torch.models import init_gpt
    from unionml_tpu_torch.serving.continuous import DecodeEngine

    config = dataclasses.replace(config, attention_impl=impl, paged_attn_impl=impl)
    model = init_gpt(config, params=params, device=device)
    return DecodeEngine(
        model, num_slots=8, max_len=1024, kv_quantize="int8", prefill_chunk=PREFILL_CHUNK,
        seed=0, device=device,
    )


async def _serve(batcher, prompt_list):
    """Stream every request concurrently; returns (streams, ttft_s, wall_s)."""
    t0 = time.perf_counter()
    ttft = [None] * len(prompt_list)

    async def one(i, prompt):
        sampling = REQUESTS[i][1] or {}
        out = []
        async for token in batcher.stream(prompt, MAX_NEW, **sampling):
            if not out:
                ttft[i] = time.perf_counter() - t0
            out.append(token)
        return out

    streams = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompt_list)))
    return list(streams), ttft, time.perf_counter() - t0


def serve(engine, prompt_list, device):
    from unionml_tpu_torch.serving.continuous import ContinuousBatcher

    batcher = ContinuousBatcher(engine, device=device)
    try:
        return asyncio.run(_serve(batcher, prompt_list))
    finally:
        batcher.close()


def top2_gap_at(engine, prompt, split: int) -> float:
    """The plain engine's top-2 logit gap where it picks token ``split`` of
    ``prompt``'s greedy stream (replayed alone: rows are independent)."""
    slot = engine.add_request(prompt, MAX_NEW)
    while slot in engine._partials:  # finish a chunked prefill without decoding
        engine._advance_partials()
    emitted = 0
    while emitted < split:
        emitted += sum(1 for ev in engine.step() if ev.slot == slot and ev.emit)
    top = torch.topk(engine._last_logits[slot], 2).values
    engine.cancel(slot)
    return float(top[0] - top[1])


def stream_splits(kernel_streams, plain_streams, plain_engine, prompt_list) -> list:
    """Where each greedy stream leaves the plain path's, with the plain
    path's top-2 logit gap there."""
    splits = []
    for i, (a, b) in enumerate(zip(kernel_streams, plain_streams)):
        if REQUESTS[i][1] is not None or a == b:
            continue
        split = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        splits.append({"request": i, "split": split,
                       "plain_top2_gap": top2_gap_at(plain_engine, prompt_list[i], split)})
    return splits


def compare_streams(kernel_streams, plain_streams, plain_engine, prompt_list, exact: bool):
    """Greedy streams must agree; where they split, the plain path's top-2
    gap there must be below the bf16 limit (``exact``: no split allowed)."""
    splits = stream_splits(kernel_streams, plain_streams, plain_engine, prompt_list)
    for s in splits:
        i, split, gap = s["request"], s["split"], s["plain_top2_gap"]
        print(f"stream {i} splits at token {split}: plain top-2 gap {gap:.3e}")
        if exact or gap >= GAP_LIMIT_BF16:
            raise AssertionError(f"stream {i} disagrees with the plain path at token {split} (gap {gap:.3e})")
    return splits


def profile_decode(engine, prompt_list, steps: int = 8) -> dict:
    """``step_profile`` of a decode step with all 8 slots decoding and no
    prefill in the window."""
    short = [p for p in prompt_list if len(p) <= PREFILL_CHUNK][: engine.num_slots]
    engine.admit_many([(p, MAX_NEW) for p in short])
    engine.step()
    result = step_profile(engine.step, steps, top=8)
    engine.abort_all()
    return {"slots": len(short), **result}


def check_k4_kernel_names(engine, prompt_list) -> dict:
    """K4's kernels by the profiler's names in one bf16 decode step (7 slots)
    and in the second chunk of the 400-token prompt's chunked prefill (base
    256): the decode body and its merge kernel, then the tensor-core query
    tile, and no other K4 body (``launch_plan`` names them)."""
    from unionml_tpu_torch.ops.paged_attention import launch_plan

    short = [p for p in prompt_list if len(p) <= PREFILL_CHUNK][: engine.num_slots - 1]
    engine.admit_many([(p, MAX_NEW) for p in short])
    engine.step()
    names = {"decode step": [n for n in kernel_ms_by_name(engine.step, 1) if "paged_" in n]}
    engine.add_request(next(p for p in prompt_list if len(p) > PREFILL_CHUNK), MAX_NEW)
    names["prefill chunk"] = [n for n in kernel_ms_by_name(engine._advance_partials, 1) if "paged_" in n]
    engine.abort_all()
    bodies = ("paged_decode_kernel", "paged_merge_kernel", "paged_tile_wgmma_kernel", "paged_tile_f32_kernel",
              "paged_attention_kernel")
    for label, S in (("decode step", 1), ("prefill chunk", PREFILL_CHUNK)):
        want = launch_plan(1, 12, S, 64, torch.bfloat16, torch.int8, 65, 16).kernels
        found = " ".join(names[label])
        if not all(k in found for k in want) or any(k in found for k in bodies if k not in want):
            raise AssertionError(f"bf16 {label}: K4 kernels by profiler name {names[label]}; expected {want} only")
    return names


def end_to_end(device, config=None) -> dict:
    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.models import GPTConfig, random_params

    config = config or GPTConfig()  # GPT-2 small: vocab 50257, d 768, 12 layers, 12 heads
    params = random_params(config, seed=0)
    prompt_list = prompts(config.vocab_size)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(config, dtype=dtype)
        engine = build_engine(cfg, params, device, impl="auto")
        serve(engine, [prompt_list[0]], device)  # warm-up: cuBLAS handles, allocator
        kernels.reset_launches()
        streams, ttft, wall = serve(engine, prompt_list, device)
        launches = dict(kernels.launches)
        for name in ("flash_fwd", "paged_attention"):
            if device.type == "cuda" and launches[name] == 0:
                raise AssertionError(f"{dtype}: the main path never launched {name}")
        for i, s in enumerate(streams):
            if len(s) != MAX_NEW or min(s) < 0 or max(s) >= config.vocab_size:
                raise AssertionError(f"request {i}: bad stream {s}")
        plain_engine = build_engine(cfg, params, device, impl="reference")
        plain_streams, _, _ = serve(plain_engine, prompt_list, device)
        splits = compare_streams(streams, plain_streams, plain_engine, prompt_list,
                                 exact=dtype == torch.float32)
        tokens = sum(len(s) for s in streams)
        step_profile = profile_decode(engine, prompt_list) if device.type == "cuda" else None
        k4_names = (check_k4_kernel_names(engine, prompt_list)
                    if device.type == "cuda" and dtype == torch.bfloat16 else None)
        result[str(dtype)] = {
            "launches": launches, "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_s": ttft, "splits": splits, "decode_step": step_profile, "k4_kernel_names": k4_names,
            "greedy_equal": sum(
                streams[i] == plain_streams[i] for i in range(len(streams)) if REQUESTS[i][1] is None),
        }
        del engine, plain_engine
    return result


# ------------------------------------------------------------- training

BERT_SIG = ("input_ids", "attention_mask")
BERT_SEQ, BERT_BATCH, BERT_STEPS = 128, 64, 20


def bert_data(config, rows: int, seed: int = 0) -> dict:
    """Seeded token ids, right padding with lengths 16..128 (both ends
    present), pad id 0, seeded labels."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, BERT_SEQ + 1, rows)
    lens[0], lens[1] = BERT_SEQ, 16
    mask = (np.arange(BERT_SEQ)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(1, config.vocab_size, (rows, BERT_SEQ)).astype(np.int32) * mask
    labels = rng.integers(0, config.num_labels, rows).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def bert_state(config, params, device, impl: str = "auto"):
    """A fresh train state with ``bench.py``'s recipe (lr 2e-5, warmup 10,
    total 1000) from the same weights and dropout seed."""
    from unionml_tpu_torch.models import create_train_state, init_bert

    model = init_bert(dataclasses.replace(config, attention_impl=impl), params=params, device=device)
    return create_train_state(model, learning_rate=2e-5, warmup_steps=10, total_steps=1000, seed=0)


def first_steps(config, params, device, impl: str, batches) -> list:
    from unionml_tpu_torch.models import make_classifier_train_step

    state, step = bert_state(config, params, device, impl), make_classifier_train_step(input_signature=BERT_SIG)
    history = []
    for batch in batches:
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    return history


def compare_first_steps(kernel: list, plain: list) -> list:
    """Loss within 1e-2 relative and grad_norm within 2 % at every step."""
    for i, (a, b) in enumerate(zip(kernel, plain)):
        if abs(a["loss"] - b["loss"]) > 1e-2 * abs(b["loss"]):
            raise AssertionError(f"train step {i}: loss {a['loss']} (kernels) vs {b['loss']} (plain)")
        if abs(a["grad_norm"] - b["grad_norm"]) > 0.02 * abs(b["grad_norm"]):
            raise AssertionError(f"train step {i}: grad_norm {a['grad_norm']} (kernels) vs {b['grad_norm']} (plain)")
    return [{"step": i, "kernels": a, "plain": b} for i, (a, b) in enumerate(zip(kernel, plain))]


def f32_grads_agree(config, params, device, batch) -> dict:
    """One f32 step's gradients, kernel path vs plain path (same weights,
    same dropout masks): each leaf within 1e-4 of its largest magnitude. The
    attention key biases' true gradient is 0 (softmax is shift-invariant per
    row), so both hold rounding noise there, held to 1e-4 of the largest
    gradient of the model instead."""
    from unionml_tpu_torch.models.training import classifier_grads

    cfg = dataclasses.replace(config, dtype=torch.float32)
    runs = {}
    for impl in ("auto", "reference"):
        state = bert_state(cfg, params, device, impl)
        grads, loss, _ = classifier_grads(state, batch, BERT_SIG)
        runs[impl] = (state.names, grads, float(loss))
        del state
    names, kernel, _ = runs["auto"]
    plain = runs["reference"][1]
    top = max(float(g.abs().max()) for g in plain)
    worst = 0.0
    for name, a, b in zip(names, kernel, plain):
        scale = top if name.endswith("attention.key.bias") else float(b.abs().max())
        err = float((a - b).abs().max())
        if err > 1e-4 * scale:
            raise AssertionError(f"f32 gradient {name}: max |err| {err:.3e} beyond 1e-4 x {scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
    return {"worst_relative_err": worst, "loss": {k: v[2] for k, v in runs.items()}}


def profile_train(state, batch, steps: int = 3) -> dict:
    """``step_profile`` of a train step (the step updates ``state`` in place),
    and one step's host operators."""
    from torch.profiler import ProfilerActivity, profile
    from unionml_tpu_torch.models import make_classifier_train_step

    step = make_classifier_train_step(input_signature=BERT_SIG)
    step(state, batch)
    result = step_profile(lambda: step(state, batch), steps, top=10)
    # where the host's time goes: one step's operators by self CPU time (the
    # CPU profiler's own cost inflates these; they rank, they do not time)
    with profile(activities=[ProfilerActivity.CPU]) as host:
        step(state, batch)
        torch.cuda.synchronize()
    events = host.key_averages()
    host_ops = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events), key=lambda t: -t[1])
    return {
        **result,
        "host_ops_per_step": sum(count for _, _, count in host_ops),
        "top_host_ops_self_ms": [(name[:60], ms, count) for name, ms, count in host_ops[:10]],
    }


def train_bert(device) -> dict:
    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.models import (
        BertConfig, bert_flops_per_token, bert_random_params, dict_batches, fit, make_classifier_eval_step,
        make_classifier_train_step,
    )

    config = BertConfig.base()  # vocab 30522, d 768, 12 layers, 12 heads, 512 positions; bf16
    params = bert_random_params(config, seed=0)
    data = bert_data(config, rows=4 * BERT_BATCH)
    state = bert_state(config, params, device)
    kernels.reset_launches()
    result = fit(state, data, batch_size=BERT_BATCH, num_steps=BERT_STEPS, log_every=5,
                 input_signature=BERT_SIG, seed=0)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if device.type == "cuda" and launches[name] != config.num_layers * BERT_STEPS:
            raise AssertionError(f"training launched {name} {launches[name]} times, expected "
                                 f"{config.num_layers} per step over {BERT_STEPS} steps")
    history = result.metrics_history
    if result.steps != BERT_STEPS or not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"training: {result.steps} steps, history {history}")
    batches = list(dict_batches(data, BERT_BATCH, rng=np.random.default_rng(1), device=device))
    evaluation = {k: float(v) for k, v in make_classifier_eval_step(BERT_SIG)(state, batches[0]).items()}
    if not all(np.isfinite(v) for v in evaluation.values()):
        raise AssertionError(f"eval step: {evaluation}")
    step_profile = profile_train(state, batches[0])
    bert_step = make_classifier_train_step(input_signature=BERT_SIG)
    tc_names = check_tc_kernel_names(lambda: bert_step(state, batches[0]), "BERT bf16 train step")
    del state
    torch.cuda.empty_cache()

    agreement = compare_first_steps(first_steps(config, params, device, "auto", batches[:3]),
                                     first_steps(config, params, device, "reference", batches[:3]))
    small = {k: v[:8] for k, v in batches[1].items()}
    grads = f32_grads_agree(config, params, device, small)
    torch.cuda.empty_cache()

    tokens_per_s = result.examples_per_s * BERT_SEQ
    tflops = tokens_per_s * bert_flops_per_token(config) / 1e12
    return {
        "launches": launches, "steps": result.steps, "history": history, "eval": evaluation,
        "step_ms": 1e3 / result.steps_per_s, "examples_per_s": result.examples_per_s,
        "tokens_per_s": tokens_per_s, "achieved_tflops": tflops, "share_of_bf16_peak": tflops * 1e12 / BF16_FLOPS,
        "step_profile": step_profile, "first_steps_vs_plain": agreement, "f32_grads_vs_plain": grads,
        "lens": data["attention_mask"][:BERT_BATCH].sum(-1).tolist(), "kernel_names": tc_names,
    }


def lm_state(config, params, device, impl: str = "auto"):
    """A fresh LM train state (lr 3e-4, warmup 10, total 1000) from the same
    weights and dropout seed."""
    from unionml_tpu_torch.models import create_train_state, init_gpt

    model = init_gpt(dataclasses.replace(config, attention_impl=impl), params=params, device=device)
    return create_train_state(model, learning_rate=3e-4, warmup_steps=10, total_steps=1000, seed=0)


def lm_first_steps(config, params, device, impl: str, batches) -> list:
    from unionml_tpu_torch.models import make_lm_train_step

    state, step = lm_state(config, params, device, impl), make_lm_train_step(packed=True)
    history = []
    for batch in batches:
        state, metrics = step(state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    del state
    torch.cuda.empty_cache()
    return history


def lm_f32_grads_agree(config, params, device, batch) -> dict:
    """One f32 LM step's gradients, kernel path vs plain path (same weights,
    same dropout masks): each leaf within 1e-4 of its largest magnitude."""
    from unionml_tpu_torch.models.training import lm_grads

    cfg = dataclasses.replace(config, dtype=torch.float32)
    runs = {}
    for impl in ("auto", "reference"):
        state = lm_state(cfg, params, device, impl)
        grads, loss = lm_grads(state, batch, packed=True)
        runs[impl] = (state.names, grads, float(loss))
        del state
    names, kernel, _ = runs["auto"]
    plain = runs["reference"][1]
    worst = 0.0
    for name, a, b in zip(names, kernel, plain):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if err > 1e-4 * scale:
            raise AssertionError(f"f32 LM gradient {name}: max |err| {err:.3e} beyond 1e-4 x {scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
    del runs, kernel, plain
    torch.cuda.empty_cache()
    return {"worst_relative_err": worst}


def lm_flops_per_step(config, segment_ids: np.ndarray) -> dict:
    """The count behind the LM step's achieved TFLOP/s: 6 x the matmul
    parameters (QKV, attention out, MLP up and down per layer, and the tied
    head's vocab x d) x the row slots (padding is computed too), plus the
    attention: per layer, head and visible (q, k) pair, 4*D (K1) + 6*D (K2) +
    8*D (K3) flops; visible pairs are s(s+1)/2 per segment of length s."""
    d, layers = config.hidden_size, config.num_layers
    matmul_params = layers * 12 * d * d + config.vocab_size * d
    slots = segment_ids.size
    pairs = visible_pairs(segment_ids)
    attention = layers * config.num_heads * 18 * config.head_dim * pairs
    return {"matmul": 6.0 * matmul_params * slots, "attention": float(attention), "pairs_per_head": pairs}


def train_gpt(device) -> dict:
    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.models import GPTConfig, dict_batches, fit_lm, make_lm_eval_step, make_lm_train_step, \
        random_params
    from unionml_tpu_torch.ops.packing import packing_efficiency

    config = GPTConfig()  # GPT-2 small: vocab 50257, d 768, 12 layers, 12 heads, 1024 positions; bf16, dropout 0.1
    params = random_params(config, seed=0)
    corpus = lm_corpus(LM_SEQS, LM_SEQ)
    packed = lm_packed()
    state = lm_state(config, params, device)
    kernels.reset_launches()
    result = fit_lm(state, corpus, seq_len=LM_SEQ, batch_size=LM_BATCH, pack=True, num_steps=LM_STEPS,
                    log_every=5, seed=0)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != config.num_layers * LM_STEPS:
            raise AssertionError(f"LM training launched {name} {launches[name]} times, expected "
                                 f"{config.num_layers} per step over {LM_STEPS} steps")
    history = result.metrics_history
    if result.steps != LM_STEPS or not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"LM training: {result.steps} steps, history {history}")
    data = {k: packed[k] for k in ("input_ids", "segment_ids")}
    batches = list(dict_batches(data, LM_BATCH, rng=np.random.default_rng(1), device=device))
    evaluation = {k: float(v) for k, v in make_lm_eval_step(packed=True)(state, batches[0]).items()}
    if not all(np.isfinite(v) for v in evaluation.values()):
        raise AssertionError(f"LM eval step: {evaluation}")
    step = make_lm_train_step(packed=True)
    step(state, batches[0])
    profile = step_profile(lambda: step(state, batches[0]), 3, top=10)
    tc_names = check_tc_kernel_names(lambda: step(state, batches[0]), "LM bf16 train step")
    del state
    torch.cuda.empty_cache()

    agreement = compare_first_steps(lm_first_steps(config, params, device, "auto", batches[:3]),
                                    lm_first_steps(config, params, device, "reference", batches[:3]))
    grads = lm_f32_grads_agree(config, params, device, {k: v[:2] for k, v in batches[1].items()})

    efficiency = packing_efficiency(packed["segment_ids"])
    slots_per_s = result.examples_per_s * LM_SEQ
    flops = lm_flops_per_step(config, packed["segment_ids"][:LM_BATCH])
    step_s = 1.0 / result.steps_per_s
    tflops = (flops["matmul"] + flops["attention"]) / step_s / 1e12
    return {
        "launches": launches, "steps": result.steps, "history": history, "eval": evaluation,
        "rows": int(packed["input_ids"].shape[0]), "truncated": packed["truncated"],
        "packing_efficiency": efficiency, "step_ms": step_s * 1e3, "rows_per_s": result.examples_per_s,
        "slot_tokens_per_s": slots_per_s, "real_tokens_per_s": slots_per_s * efficiency,
        "flops_per_step": flops, "achieved_tflops": tflops, "share_of_bf16_peak": tflops * 1e12 / BF16_FLOPS,
        "step_profile": profile, "first_steps_vs_plain": agreement, "f32_grads_vs_plain": grads,
        "kernel_names": tc_names,
    }


# ------------------------------------------------------------ BERT app

APP_BUCKETS, APP_SEQ_BUCKETS = (1, 2, 4, 8, 16, 32, 64), (32, 64, 128)
APP_ROWS, APP_STEPS, APP_CKPT_EVERY, APP_REQUESTS = 320, 20, 10, 32
APP_F32_REQUESTS = 8
APP_DIR = Path(__file__).resolve().parent / "build" / "bert_app"


def build_bert_app(config, params, device, logits: bool = False):
    """The flagship BERT app (``unionml_tpu/templates/bert-finetune/app.py``)
    through the port's ``Dataset`` and ``Model``: a seeded reader (right
    padding, lengths 16..128), a feature loader that right-pads request rows
    of token ids, ``fit`` with step checkpoints, argmax labels (or, with
    ``logits``, the float32 logits) from the predictor, accuracy from the
    evaluator. The app's ``init`` rebuilds the model from ``params``."""
    from typing import Any, Dict

    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch.models import TrainState, create_train_state, fit, init_bert, make_classifier_eval_step

    dataset = Dataset(name="bert_app_dataset", test_size=0.2, targets=["labels"], device_format="torch",
                      device=device)

    def init(learning_rate: float = 2e-5, warmup_steps: int = 10) -> TrainState:
        return create_train_state(init_bert(config, params=params, device=device), learning_rate=learning_rate,
                                  warmup_steps=warmup_steps, total_steps=1000, seed=0)

    model = Model(name="bert_app", init=init, dataset=dataset)

    @dataset.reader
    def reader(n: int = APP_ROWS, seed: int = 0) -> Dict[str, np.ndarray]:
        return bert_data(config, n, seed)

    @dataset.feature_loader
    def feature_loader(rows: Any) -> Dict[str, np.ndarray]:
        if isinstance(rows, dict):
            return rows
        width = max(len(r["input_ids"]) for r in rows)
        ids = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r["input_ids"])] = r["input_ids"]
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}

    @model.trainer
    def trainer(state: TrainState, features: torch.Tensor, targets: torch.Tensor, *, num_steps: int = APP_STEPS,
                batch_size: int = BERT_BATCH, checkpoint_dir: str = "", checkpoint_every: int = 100) -> TrainState:
        data = {k: v.cpu().numpy() for k, v in {**features, **targets}.items()}
        return fit(state, data, batch_size=batch_size, num_steps=num_steps, input_signature=BERT_SIG,
                   checkpoint_dir=checkpoint_dir or None, checkpoint_every=checkpoint_every, log_every=5).state

    @model.predictor
    def predictor(state: TrainState, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            out = state.model(features["input_ids"], features["attention_mask"])
        return out if logits else out.argmax(-1)

    @model.evaluator
    def evaluator(state: TrainState, features: torch.Tensor, targets: torch.Tensor) -> float:
        metrics = make_classifier_eval_step(BERT_SIG)(state, {**features, **targets})
        return float(metrics["accuracy"])

    return dataset, model


def app_requests(vocab: int, seed: int = 0) -> list:
    """32 requests of 1-8 rows each, every row 5-128 seeded token ids."""
    rng = np.random.default_rng(seed)
    return [[{"input_ids": rng.integers(1, vocab, int(rng.integers(5, BERT_SEQ + 1))).tolist()}
             for _ in range(int(rng.integers(1, 9)))] for _ in range(APP_REQUESTS)]


def plain_logits(model, rows) -> torch.Tensor:
    """f32 logits of ``rows`` alone (unpadded batch) through ``model``."""
    width = max(len(r["input_ids"]) for r in rows)
    ids = torch.zeros((len(rows), width), dtype=torch.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r["input_ids"])] = torch.tensor(r["input_ids"])
    ids = ids.to(model.device)
    with torch.no_grad():
        return model(ids, (ids != 0).to(torch.int32)).float().cpu()


def states_equal(a, b) -> bool:
    """Bitwise equality of two TrainStates' parameters, moments and step."""
    return a.step == b.step and all(
        torch.equal(x, y) for group in ("params", "mu", "nu") for x, y in zip(getattr(a, group), getattr(b, group)))


def serve_requests(predictor, requests) -> list:
    """Half the requests through ``RequestBatcher`` (submitted together, so
    they coalesce), half straight to ``ResidentPredictor.predict``: the two
    calls the ``/predict`` handler makes."""
    from unionml_tpu_torch.serving import RequestBatcher

    half = len(requests) // 2

    async def coalesced():
        batcher = RequestBatcher(lambda rows: predictor.predict(features=rows), max_batch=BERT_BATCH)
        try:
            return await asyncio.gather(*(batcher.submit(rows) for rows in requests[:half])), dict(batcher.stats)
        finally:
            batcher.close()

    batched, stats = asyncio.run(coalesced())
    direct = [predictor.predict(features=rows) for rows in requests[half:]]
    return [np.asarray(p) for p in list(batched) + direct], stats


def percentiles(fn, reps: int) -> dict:
    """p50 / p90 host ms of ``fn`` (which ends in a host fetch) over ``reps`` calls, after two warm calls."""
    fn(), fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {"p50_ms": times[len(times) // 2], "p90_ms": times[min(int(len(times) * 0.9), len(times) - 1)]}


def replay_vs_eager(predictor, model, rows, reps: int = 50) -> dict:
    """Per-request ms of one bucket, resident replay against the same
    request eager: the feature pipeline (host to device), the predictor and
    the fetch of the labels, without graphs."""
    state = model.artifact.model_object
    predict_fn = model._predictor.fn

    def eager():
        return predict_fn(state, model.dataset.get_features(rows)).cpu().numpy()

    return {"replay": percentiles(lambda: predictor.predict(features=rows), reps),
            "eager": percentiles(eager, reps)}


def fit_ms(app_model, data, checkpoint_dir) -> dict:
    """``fit`` ms per step (its timed window) and the whole call's ms, with
    step checkpoints every APP_CKPT_EVERY steps or without."""
    from unionml_tpu_torch.models import fit

    state = app_model._init_model_object({})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fit(state, data, batch_size=BERT_BATCH, num_steps=APP_STEPS, input_signature=BERT_SIG,
                 checkpoint_dir=checkpoint_dir, checkpoint_every=APP_CKPT_EVERY, log_every=APP_STEPS)
    torch.cuda.synchronize()
    return {"step_ms": 1e3 / result.steps_per_s, "call_ms": (time.perf_counter() - t0) * 1e3}


def checkpoint_ms(state, directory) -> dict:
    """One ``Checkpointer.save`` of ``state`` alone: the snapshot to host
    memory (before ``save`` returns) and the background write (until
    ``flush`` returns), with the bytes saved."""
    from unionml_tpu_torch.checkpoint import Checkpointer

    ckpt = Checkpointer(directory)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(1, state)
    t1 = time.perf_counter()
    ckpt.flush()
    t2 = time.perf_counter()
    ckpt.close()
    tensors = state.params + state.mu + state.nu
    return {"snapshot_ms": (t1 - t0) * 1e3, "write_ms": (t2 - t1) * 1e3,
            "bytes": sum(t.numel() * t.element_size() for t in tensors)}


def bf16_replay_vs_eager(config, params, device, saved, requests) -> dict:
    """The bf16 resident logits of every request against the same padded
    inputs run eagerly through the same kernels (no graph): one bf16 rounding
    step of the eager value at most (2^-7 relative; a graph replays the
    launches it recorded, so the two are expected to agree bit for bit)."""
    from unionml_tpu_torch.serving import ResidentPredictor
    from unionml_tpu_torch.serving.resident import to_host

    _, model = build_bert_app(config, params, device, logits=True)
    state = model.load(saved)
    predictor = ResidentPredictor(model, buckets=APP_BUCKETS, seq_buckets=APP_SEQ_BUCKETS, warmup=False,
                                  device=device)
    worst = 0.0
    rows_total = rows_bitwise = 0
    for rows in requests:
        replayed = predictor.predict(features=rows)
        padded, n, _ = predictor._pad_to_buckets(model.dataset.get_features(rows))
        eager = to_host(predictor._eager(state, padded))[:n]
        diff = np.abs(replayed - eager)
        if not np.all(diff <= 2.0 ** -7 * np.abs(eager)):
            raise AssertionError(f"bf16 replay vs eager on the same inputs: max |diff| {float(diff.max()):.3e} "
                                 "beyond one bf16 rounding step")
        worst = max(worst, float(diff.max()))
        rows_total += n
        rows_bitwise += int(np.all(diff == 0, axis=-1).sum())
    if predictor.eager_fallbacks:
        raise AssertionError(f"bf16 logits predictor fell back to eager {predictor.eager_fallbacks} times")
    del predictor, model, state
    return {"max_abs_diff": worst, "rows": rows_total, "rows_bitwise": rows_bitwise}


def bert_app(device) -> dict:
    """The BERT app end to end (see the module docstring, phase 11)."""
    import os
    import shutil

    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.checkpoint import Checkpointer
    from unionml_tpu_torch.models import BertConfig, BertForSequenceClassification, bert_random_params, fit
    from unionml_tpu_torch.serving import ResidentPredictor

    config = BertConfig.base(num_labels=2)  # bf16 compute on f32 parameters
    params = bert_random_params(config, seed=0)
    shutil.rmtree(APP_DIR, ignore_errors=True)
    APP_DIR.mkdir(parents=True)
    ckpt_dir = APP_DIR / "checkpoints"

    _, model = build_bert_app(config, params, device)
    kernels.reset_launches()
    trained, metrics = model.train(trainer_kwargs={"checkpoint_dir": str(ckpt_dir),
                                                   "checkpoint_every": APP_CKPT_EVERY})
    torch.cuda.synchronize()
    train_launches = dict(kernels.launches)
    per_run = config.num_layers * APP_STEPS
    # the evaluator (jit="auto") adds forwards: its capture fails at float(), so it runs eagerly
    if device.type == "cuda" and (train_launches["flash_bwd_dq"] != per_run
                                  or train_launches["flash_bwd_dkv"] != per_run
                                  or train_launches["flash_fwd"] < per_run):
        raise AssertionError(f"Model.train launched {train_launches}; expected K2/K3 {per_run} times, K1 at least")
    probe = Checkpointer(ckpt_dir)
    latest = probe.latest_step()
    restored = probe.restore(model._init_model_object({}))
    probe.close()
    if latest != APP_STEPS or not states_equal(restored, trained):
        raise AssertionError(f"checkpoint: latest step {latest}, restored state bitwise equal to the trained one: "
                             f"{states_equal(restored, trained)}")
    data = bert_data(config, APP_ROWS, 0)
    resumed = fit(model._init_model_object({}), data, batch_size=BERT_BATCH, num_steps=2, input_signature=BERT_SIG,
                  checkpoint_dir=str(ckpt_dir), checkpoint_every=APP_CKPT_EVERY, log_every=100)
    if resumed.steps != APP_STEPS + 2 or resumed.state.step != APP_STEPS + 2:
        raise AssertionError(f"resume: fit ended at step {resumed.steps} (state {resumed.state.step}), "
                             f"expected {APP_STEPS + 2}")
    del resumed, restored

    saved = APP_DIR / "bert_app.pt"
    model.save(saved)
    os.environ["UNIONML_MODEL_PATH"] = str(saved)
    _, served = build_bert_app(config, params, device)
    loaded = served.load_from_env()
    if not states_equal(loaded, trained):
        raise AssertionError("Model.load: the loaded state differs from the saved one")

    requests = app_requests(config.vocab_size)
    predictor = ResidentPredictor(served, buckets=APP_BUCKETS, seq_buckets=APP_SEQ_BUCKETS,
                                  example_features=requests[0][:1], device=device)
    kernels.reset_launches()
    predictor.setup()
    answers, coalescing = serve_requests(predictor, requests)
    serve_launches = dict(kernels.launches)  # K1 launches into each captured graph; replays bypass the wrapper
    if device.type == "cuda" and not serve_launches["flash_fwd"]:
        raise AssertionError(f"serving launched {serve_launches}; K1 never ran")

    plain = BertForSequenceClassification(dataclasses.replace(config, attention_impl="reference"), device=device)
    plain.load_state_dict(loaded.model.state_dict())
    compared = split = 0
    gaps = []
    for rows, labels in zip(requests, answers):
        logits = plain_logits(plain, rows)
        top2 = torch.topk(logits, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        want = logits.argmax(-1).numpy()
        if labels.shape != want.shape:
            raise AssertionError(f"resident labels {labels.shape} for {len(rows)} rows")
        for g, a, b in zip(gap, labels, want):
            if g >= GAP_LIMIT_BF16:
                compared += 1
                if a != b:
                    raise AssertionError(f"resident label {a} vs plain {b} at top-2 gap {g:.3e}")
            elif a != b:
                split += 1
                gaps.append(float(g))
    if predictor.eager_fallbacks:
        raise AssertionError(f"resident predictor fell back to eager {predictor.eager_fallbacks} times")
    names = [n for n in kernel_ms_by_name(lambda: predictor.predict(features=requests[1]), 1) if "flash_" in n]
    if not any("flash_fwd_wgmma_kernel" in n for n in names):
        raise AssertionError(f"resident bf16 replay: kernels by profiler name {names}; no flash_fwd_wgmma_kernel")

    replay_vs_eager_bf16 = bf16_replay_vs_eager(config, params, device, saved, requests)

    # the same weights in f32: resident logits against plain logits
    cfg32 = dataclasses.replace(config, dtype=torch.float32)
    _, model32 = build_bert_app(cfg32, params, device, logits=True)
    model32.load(saved)
    predictor32 = ResidentPredictor(model32, buckets=APP_BUCKETS, seq_buckets=APP_SEQ_BUCKETS, warmup=False,
                                    device=device)
    plain32 = BertForSequenceClassification(dataclasses.replace(cfg32, attention_impl="reference"), device=device)
    plain32.load_state_dict(loaded.model.state_dict())
    f32_err = max(float(np.abs(predictor32.predict(features=rows) - plain_logits(plain32, rows).numpy()).max())
                  for rows in requests[:APP_F32_REQUESTS])
    if not f32_err <= 1e-4 or predictor32.eager_fallbacks:
        raise AssertionError(f"f32 resident logits vs plain: max |err| {f32_err:.3e} (limit 1e-4), "
                             f"eager fallbacks {predictor32.eager_fallbacks}")
    del model32, predictor32, plain32, plain
    torch.cuda.empty_cache()

    # timings: replay against eager at two buckets, a replay's device time, fit with and without checkpoints
    rng = np.random.default_rng(1)
    small = [{"input_ids": rng.integers(1, config.vocab_size, 32).tolist()}]
    large = [{"input_ids": rng.integers(1, config.vocab_size, BERT_SEQ).tolist()} for _ in range(BERT_BATCH)]
    latency = {"1x32": replay_vs_eager(predictor, served, small), "64x128": replay_vs_eager(predictor, served, large)}
    replay_profile = step_profile(lambda: predictor.predict(features=large), steps=10, top=5)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    fit_off = fit_ms(model, data, None)
    fit_on = fit_ms(model, data, str(ckpt_dir))
    one_save = checkpoint_ms(loaded, APP_DIR / "one_save")
    shutil.rmtree(APP_DIR, ignore_errors=True)
    return {
        "metrics": metrics, "latest_step": latest, "launches": {"train": train_launches, "serve": serve_launches},
        "graphs": predictor.graph_stats(), "coalescing": coalescing, "compared_rows": compared,
        "rows": int(sum(len(r) for r in requests)), "split_below_gate": split, "split_gaps": gaps,
        "eager_fallbacks": predictor.eager_fallbacks, "f32_max_abs_err": f32_err, "kernel_names": names,
        "bf16_replay_vs_eager": replay_vs_eager_bf16,
        "label_counts": np.bincount(np.concatenate(answers), minlength=config.num_labels).tolist(),
        "latency": latency, "rows_per_s_64x128": BERT_BATCH / latency["64x128"]["replay"]["p50_ms"] * 1e3,
        "replay_profile": replay_profile, "fit_ms": {"checkpoints_off": fit_off, "checkpoints_on": fit_on},
        "one_save": one_save,
    }


# -------------------------------------------------------------- timings


def _times(kernel, plain, library) -> dict:
    """ms / plain_ms / library_ms, each by the same method (see ``timed``)."""
    k, p, lib = timed(kernel), timed(plain), timed(library)
    return {"ms": k["ms"], "plain_ms": p["ms"], "library_ms": lib["ms"], "method": k["method"],
            "kernel_by_name_ms": k["by_name_ms"],
            "event_ms": {"kernel": k["event_ms"], "plain": p["event_ms"], "library": lib["event_ms"]},
            "library_kernels": lib["kernels"]}


def _bound(byts: float, flops: float):
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_k1(device, B, S, launches, H=12, D=64, inputs=None) -> dict:
    """K1 on bf16 causal inputs (seeded, or ``inputs``): kernel, plain
    version, SDPA, and the bound (q, k, v read once, o written once; 4*D
    flops per visible (q, k) pair)."""
    from unionml_tpu_torch.ops.attention import flash_attention, reference_attention

    q, k, v = inputs if inputs is not None else k1_inputs(B, H, S, D, torch.bfloat16, device)
    err = check_close("K1 timing inputs", flash_attention(q, k, v, causal=True),
                      reference_attention(q, k, v, causal=True))
    flops = 4 * B * H * D * S * (S + 1) / 2
    bound, by = _bound(4 * q.numel() * q.element_size(), flops)
    return k1_rates({
        "name": "flash_fwd", "route": "cuda", "source": "unionml_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "unionml_tpu/ops/attention.py:83", "launches": launches, "max_abs_err": err,
        "bound_ms": bound, "bound_by": by, "shape": f"bf16 B{B} H{H} S{S} D{D} causal", "flops": flops,
        **_times(
            lambda: flash_attention(q, k, v, causal=True),
            lambda: reference_attention(q, k, v, causal=True),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True),
        ),
    })


def k1_rates(record: dict) -> dict:
    """A K1 record with its achieved TFLOP/s (visible pairs' flops over its
    ms) and the share of its bound it reaches (bound_ms / ms)."""
    record["tflops"] = record["flops"] / record["ms"] / 1e9
    record["bound_share"] = record["bound_ms"] / record["ms"]
    # the kernel alone: ms counts every kernel of the call (the skip map's
    # torch ops in packed mode too)
    record["kernel_only_ms"] = own_kernel_ms(record["kernel_by_name_ms"], "flash_fwd")
    return record


def bwd_records(launches, shape, errs, D, visible, numel, size, backward, plain, sdpa, leaves, d_out, out) -> list:
    """The K2 and K3 records of one backward call: each kernel's own device
    ms from one profile of ``backward`` by kernel name, with its bound (K2:
    6*D flops per visible pair over q, k, v, dO read and dQ written; K3: 8*D
    over q, k, v, dO read and dK, dV written), achieved TFLOP/s and share of
    the bound. plain = the whole ``reference_attention_backward``; library =
    SDPA's backward alone (the device time of ``torch.autograd.grad`` through
    ``sdpa(leaves)``, same mask), with SDPA forward + backward beside it; the
    torch ops around the kernels (delta = rowsum(dO * O), and the skip maps
    in a packed call on its own) are timed too."""
    by_name = kernel_ms_by_name(backward)
    whole = timed(backward)
    plain_t = timed(plain)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(*leaves), leaves, d_out)

    fwd_bwd = timed(sdpa_fwd_bwd)
    o = sdpa(*leaves)
    bwd_only = timed(lambda: torch.autograd.grad(o, leaves, d_out, retain_graph=True))
    delta = timed(lambda: torch.sum(d_out.float() * out.float(), dim=-1))
    records = []
    for name, per_pair, byts, err in (
        ("flash_bwd_dq", 6 * D, 5 * numel * size, errs[0]),
        ("flash_bwd_dkv", 8 * D, 6 * numel * size, max(errs[1:])),
    ):
        flops = per_pair * visible
        bound, by = _bound(byts, flops)
        ms, method = sum(t for n, t in by_name.items() if name in n), "profiler device time, by kernel name"
        if ms <= 0:  # the profiler saw no device time: the whole call's CUDA-event time, an upper bound
            ms, method = whole["event_ms"], "cuda events, whole backward call"
        records.append({
            "name": name, "route": "cuda", "source": "unionml_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "unionml_tpu/ops/attention.py:" + ("353" if name == "flash_bwd_dq" else "421"),
            "launches": launches[name], "max_abs_err": err, "bound_ms": bound, "bound_by": by, "shape": shape,
            "ms": ms, "plain_ms": plain_t["ms"], "library_ms": bwd_only["ms"],
            "library_fwd_bwd_ms": fwd_bwd["ms"], "flops": flops, "tflops": flops / ms / 1e9,
            "bound_share": bound / ms, "kernel_only_ms": ms, "method": method,
            "library_kernels": bwd_only["kernels"],
            "event_ms": {"whole backward": whole["event_ms"], "plain": plain_t["event_ms"],
                         "library backward": bwd_only["event_ms"], "library fwd+bwd": fwd_bwd["event_ms"]},
            "backward_kernels_ms": by_name, "whole_backward_ms": whole["ms"], "delta_ms": delta["ms"],
        })
    return records


def time_k4(device, S, bases, launches, H=12, D=64, bs=16) -> dict:
    """K4 on a bf16 query over an int8 pool: kernel, plain version, a
    gather-dequantize-then-SDPA yardstick, and the bound (the codes and scales
    of the columns each row's last query can see, their table entries, q, o
    and the bases; 4*D flops per visible (query, key) pair)."""
    from unionml_tpu_torch.ops.paged_attention import (
        fused_hbm_bytes, paged_attention, reference_paged_attention,
    )
    from unionml_tpu_torch.ops.quant import dequantize_blockwise

    B = len(bases)
    q, (kp, vp, ks, vs), table, base = k4_inputs(B, S, torch.bfloat16, True, device, bases=bases)
    err = check_close("K4 timing inputs", paged_attention(q, kp, vp, table, base, ks, vs),
                      reference_paged_attention(q, kp, vp, table, base, ks, vs))
    cols = [(b + S - 1) // bs + 1 for b in bases]
    byts = sum(fused_hbm_bytes(c, bs, H, D, True) + c * 4 for c in cols) + 2 * q.numel() * 2 + B * 4
    flops = sum(4 * H * D * sum(b + s + 1 for s in range(S)) for b in bases)
    bound, by = _bound(byts, flops)

    def gather_sdpa():
        t = table.long()
        kd = dequantize_blockwise(kp[t], ks[t], torch.bfloat16).transpose(1, 2).reshape(B, H, -1, D)
        vd = dequantize_blockwise(vp[t], vs[t], torch.bfloat16).transpose(1, 2).reshape(B, H, -1, D)
        q_pos = base[:, None] + torch.arange(S, device=device)[None, :]
        mask = torch.arange(kd.shape[2], device=device)[None, None, :] <= q_pos[:, :, None]
        return torch.nn.functional.scaled_dot_product_attention(q, kd, vd, attn_mask=mask[:, None])

    return {
        "name": "paged_attention", "route": "cuda", "source": "unionml_tpu_torch/csrc/paged_attention.cu",
        "replaces": "unionml_tpu/ops/paged_attention.py:92", "launches": launches, "max_abs_err": err,
        "bound_ms": bound, "bound_by": by,
        "shape": f"bf16 int8-pool B{B} H{H} S{S} D{D} bs{bs} width {table.shape[1]} bases {list(bases)}",
        **_times(
            lambda: paged_attention(q, kp, vp, table, base, ks, vs),
            lambda: reference_paged_attention(q, kp, vp, table, base, ks, vs),
            gather_sdpa,
        ),
    }


def time_bert_kernels(device, lens, launches, H=12, D=64) -> list:
    """K1, K2 and K3 at the BERT fine-tune shape (bf16, B = len(lens), H 12,
    S 128, D 64, non-causal, the training data's kv_lens). Bounds count the
    visible (query, key) pairs of these lengths: K1 4*D flops per pair over
    q, k, v, o and lse; K2 6*D over q, k, v and 2 dO; K3 8*D over 2 q, k, v
    and 2 dO (the JAX kernels' cost estimates). K2 and K3 are timed from one
    profile of ``flash_attention_backward`` by kernel name; their plain time
    is the whole ``reference_attention_backward`` and their library time is
    SDPA forward + backward with the same key-padding mask."""
    from unionml_tpu_torch.ops.attention import (
        _kv_lens_to_mask, flash_attention, flash_attention_backward, reference_attention,
        reference_attention_backward,
    )

    B, S = len(lens), BERT_SEQ
    q, k, v, d_out, kv_lens = bwd_inputs(B, H, S, D, torch.bfloat16, device, lens)
    d_out = d_out.contiguous()
    mask = _kv_lens_to_mask(kv_lens, S)
    visible = H * S * sum(lens)
    numel, size = q.numel(), q.element_size()
    shape = f"bf16 B{B} H{H} S{S} D{D} kv_lens {min(lens)}..{max(lens)} (mean {np.mean(lens):.1f})"

    out, lse = flash_attention(q, k, v, kv_lens=kv_lens, return_lse=True)
    k1_err = check_close("K1 BERT timing inputs", out, reference_attention(q, k, v, mask=mask))
    bound, by = _bound(4 * numel * size + lse.numel() * 4, 4 * D * visible)
    k1 = k1_rates({
        "name": "flash_fwd", "route": "cuda", "source": "unionml_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "unionml_tpu/ops/attention.py:83", "launches": launches["flash_fwd"], "max_abs_err": k1_err,
        "bound_ms": bound, "bound_by": by, "shape": shape, "flops": 4 * D * visible,
        **_times(
            lambda: flash_attention(q, k, v, kv_lens=kv_lens, return_lse=True),
            lambda: reference_attention(q, k, v, mask=mask),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        ),
    })

    got = flash_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens)
    want = reference_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens)
    errs = [check_close(f"K2/K3 BERT timing inputs d{n}", a, b, BWD_TOL) for n, a, b in zip("qkv", got, want)]
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    records = bwd_records(
        launches, shape, errs, D, visible, numel, size,
        lambda: flash_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens),
        lambda: reference_attention_backward(q, k, v, out, lse, d_out, kv_lens=kv_lens),
        lambda *x: torch.nn.functional.scaled_dot_product_attention(*x, attn_mask=mask), leaves, d_out, out,
    )
    return [k1, *records]


def time_packed_kernels(device, launches, H=12, D=64) -> list:
    """K1, K2 and K3 in segment-id mode at the LM training shape (bf16, B8,
    H12, S1024, D64, causal, the first training batch's ids), and K1 causal
    without ids on the same inputs. Bounds count the visible (q, k) pairs
    (s(s+1)/2 per segment) with the flops and bytes of ``time_bert_kernels``;
    the library yardsticks are SDPA forward, and SDPA's backward
    (``bwd_records``), with the dense block-diagonal causal mask (padding
    rows see no key and read NaN there: timing only)."""
    from unionml_tpu_torch.ops.attention import (
        _segment_mask, flash_attention, flash_attention_backward, reference_attention, reference_attention_backward,
    )

    ids = torch.from_numpy(lm_packed()["segment_ids"][:LM_BATCH]).to(device)
    B, S = ids.shape
    q, k, v, d_out, _ = bwd_inputs(B, H, S, D, torch.bfloat16, device, None, seed=7)
    d_out = d_out.contiguous()
    mask = _segment_mask(ids, S, S) & torch.ones((S, S), dtype=torch.bool, device=device).tril()
    pairs = visible_pairs(ids.cpu().numpy())
    visible = H * pairs
    numel, size = q.numel(), q.element_size()
    shape = f"bf16 B{B} H{H} S{S} D{D} causal, packed ids ({int((ids > 0).sum())} real tokens, {pairs} pairs per head)"

    out, lse = flash_attention(q, k, v, causal=True, return_lse=True, segment_ids=ids)
    k1_err = check_close("K1 packed timing inputs", out, reference_attention(q, k, v, causal=True, segment_ids=ids))
    bound, by = _bound(4 * numel * size + lse.numel() * 4, 4 * D * visible)
    k1 = k1_rates({
        "name": "flash_fwd", "route": "cuda", "source": "unionml_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "unionml_tpu/ops/attention.py:83", "launches": launches["flash_fwd"], "max_abs_err": k1_err,
        "bound_ms": bound, "bound_by": by, "shape": shape, "flops": 4 * D * visible,
        **_times(
            lambda: flash_attention(q, k, v, causal=True, return_lse=True, segment_ids=ids),
            lambda: reference_attention(q, k, v, causal=True, segment_ids=ids),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        ),
    })
    causal_only = time_k1(device, B, S, None, H=H, D=D, inputs=(q, k, v))
    causal_only["shape"] += ", no ids (the same inputs without the skip map)"

    got = flash_attention_backward(q, k, v, out, lse, d_out, causal=True, segment_ids=ids)
    want = reference_attention_backward(q, k, v, out, lse, d_out, causal=True, segment_ids=ids)
    errs = [check_close(f"K2/K3 packed timing inputs d{n}", a, b, BWD_TOL) for n, a, b in zip("qkv", got, want)]
    del got, want

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    records = [k1, *bwd_records(
        launches, shape, errs, D, visible, numel, size,
        lambda: flash_attention_backward(q, k, v, out, lse, d_out, causal=True, segment_ids=ids),
        lambda: reference_attention_backward(q, k, v, out, lse, d_out, causal=True, segment_ids=ids),
        lambda *x: torch.nn.functional.scaled_dot_product_attention(*x, attn_mask=mask), leaves, d_out, out,
    )]
    return records, causal_only


def check_tc_kernel_names(fn, label: str) -> list:
    """The K1, K2 and K3 kernels one call of ``fn`` (a bf16 train step)
    launches, by the profiler's names: each kernel's tensor-core body must be
    there and its CUDA-core body (f32 only) must not."""
    names = [n for n in kernel_ms_by_name(fn, 1) if "flash_" in n]
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if not any(f"{kernel}_wgmma_kernel" in n for n in names) or any(f"{kernel}_kernel" in n for n in names):
            raise AssertionError(f"{label}: kernels by profiler name {names}; expected {kernel}_wgmma_kernel "
                                 f"and no {kernel}_kernel")
    return names


def visible_pairs(segment_ids: np.ndarray) -> int:
    """Visible (q, k) pairs per head under causal packing: s(s+1)/2 per segment."""
    return sum(int((row == s).sum()) * (int((row == s).sum()) + 1) // 2
               for row in segment_ids for s in range(1, int(row.max()) + 1))


def time_kernels(device, e2e: dict):
    """(main-path records for the kernels line, records at further shapes)."""
    launches = e2e[str(torch.bfloat16)]["launches"]
    decode_bases = [n + MAX_NEW // 2 for n, _ in REQUESTS[:8]]  # the 8 first rows, mid-generation
    main = [
        # the largest bucket prefill of the main path: 150 and 200 tokens in the 256 bucket
        time_k1(device, 2, 256, launches["flash_fwd"]),
        # the decode step: 8 slots, one query each
        time_k4(device, 1, decode_bases, launches["paged_attention"]),
    ]
    extra = [
        time_k1(device, 4, 512, launches["flash_fwd"]),
        # the second chunk of the 400-token prompt's chunked prefill, and the
        # last chunk of a 1024-token prompt
        time_k4(device, PREFILL_CHUNK, [PREFILL_CHUNK], launches["paged_attention"]),
        time_k4(device, PREFILL_CHUNK, [1024 - PREFILL_CHUNK], launches["paged_attention"]),
        # decode at a long context: 8 rows near the end of max_len 1024
        time_k4(device, 1, K4_LONG_BASES, launches["paged_attention"]),
    ]
    return main, extra


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--details", type=Path, help="write every measurement to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from unionml_tpu_torch._device import set_precision_flags
    from unionml_tpu_torch.kernels import _build

    set_precision_flags()
    device = torch.device("cuda")
    name_limit = card()
    details = {"card": name_limit, "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    times = _build.build_all()
    print(f"build: {times['total']:.1f}s in all; per source (0.0 = already built): "
          f"{ {k: round(v, 1) for k, v in times.items() if k != 'total'} }")
    for name, log in _build.build_log.items():
        for kernel, report in ptxas_report(log):
            print(f"ptxas {name}: {kernel}: {report}")
    details["build_s"] = times["total"]

    details["k1"] = check_k1(device)
    print(f"K1 vs plain: ok, max |err| {details['k1']['max_abs_err']:.3e} "
          "(tolerance f32 atol 2e-5; bf16 atol 2e-2 + rtol 2e-2, tile-edge and packed bf16 cases included); lse vs "
          f"logsumexp of the plain masked scores: ok, max |err| {details['k1']['lse_max_abs_err']:.3e} on rows that "
          "see a key (limit 1e-4), -1e30 on rows that see none")
    details["k4"] = check_k4(device)
    print(f"K4 vs plain: ok, max |err| {details['k4']['max_abs_err']:.3e} "
          "(tolerance f32 atol 2e-5; bf16 atol 2e-2 + rtol 2e-2)")

    details["k2k3"] = check_k2_k3(device)
    print(f"K2/K3 vs plain: ok, max |err| {details['k2k3']['kernels']:.3e}; whole autograd vs plain autograd: "
          f"ok, max |err| {details['k2k3']['autograd']:.3e} (tolerance f32 atol 1e-4; bf16 atol 2e-2 + rtol 2e-2, "
          "the autograd atol times the gradient's largest magnitude; bf16 autograd against f32 plain autograd)")

    details["packed"] = check_packed(device)
    print(f"K1/K2/K3 packed (segment ids) vs plain: ok, max |err| K1 {details['packed']['k1']:.3e}, K2/K3 "
          f"{details['packed']['k2k3']:.3e}, whole autograd {details['packed']['autograd']:.3e} (tolerance as for "
          "K1 and K2/K3 above; padding queries zero, padding keys exact-zero dK/dV)")

    details["e2e"] = end_to_end(device)
    for dtype, r in details["e2e"].items():
        print(f"[{name_limit}] engine {dtype}: {r['tokens']} tokens in {r['wall_s']:.3f}s = "
              f"{r['tokens_per_s']:.1f} tok/s, TTFT min/median/max "
              f"{min(r['ttft_s']) * 1e3:.1f}/{np.median(r['ttft_s']) * 1e3:.1f}/{max(r['ttft_s']) * 1e3:.1f} ms, "
              f"launches {r['launches']}, greedy streams equal to plain {r['greedy_equal']}/9, "
              f"splits {r['splits']}")
        step = r["decode_step"]
        print(f"[{name_limit}] engine {dtype} decode step ({step['slots']} slots): "
              f"{step['wall_ms_per_step']:.2f} ms wall, {step['device_ms_per_step']:.2f} ms device kernels, "
              f"device idle share {step['device_idle_share']:.3f}; top kernels {step['top_kernels_ms_per_step']}")

    torch.cuda.empty_cache()
    details["train"] = train = train_bert(device)
    prof = train["step_profile"]
    print(f"[{name_limit}] BERT-base fine-tune bf16 B{BERT_BATCH} S{BERT_SEQ}: {train['steps']} steps through fit, "
          f"launches {train['launches']} ({ {k: v / train['steps'] for k, v in train['launches'].items()} } per step), "
          f"loss by step {[(h['step'], round(h['loss'], 4)) for h in train['history']]}, "
          f"eval {train['eval']}")
    print(f"[{name_limit}] train step: {train['step_ms']:.2f} ms wall in fit, {train['examples_per_s']:.1f} examples/s, "
          f"{train['tokens_per_s']:.0f} tokens/s, {train['achieved_tflops']:.2f} TFLOP/s achieved "
          f"({train['share_of_bf16_peak']:.4f} of 989 bf16); profiled: {prof['wall_ms_per_step']:.2f} ms wall, "
          f"{prof['device_ms_per_step']:.2f} ms device kernels, device idle share {prof['device_idle_share']:.3f}; "
          f"top kernels {prof['top_kernels_ms_per_step']}; host: {prof['host_ops_per_step']} operator calls "
          f"per step, top by self CPU ms (profiled) {prof['top_host_ops_self_ms']}")
    print(f"first 3 steps, kernels vs plain path: {train['first_steps_vs_plain']}")
    print(f"f32 B8 gradients, kernels vs plain path: ok, worst error {train['f32_grads_vs_plain']['worst_relative_err']:.3e} "
          "of each leaf's largest magnitude (limit 1e-4)")

    details["packed_vs_alone"] = alone = packed_equals_per_sequence(device)
    print(f"GPT-2-small f32 packed row ({alone['segments']} segments of {alone['lengths']} tokens) vs each "
          f"sequence alone: ok, max |err| {alone['max_abs_err']:.3e} (limit 1e-4)")

    details["train_lm"] = lm = train_gpt(device)
    prof = lm["step_profile"]
    print(f"[{name_limit}] GPT-2-small packed LM training bf16 B{LM_BATCH} S{LM_SEQ} ({LM_SEQS} sequences in "
          f"{lm['rows']} rows, packing efficiency {lm['packing_efficiency']:.4f}, {lm['truncated']} truncated): "
          f"{lm['steps']} steps through fit_lm, launches {lm['launches']} "
          f"({ {k: v / lm['steps'] for k, v in lm['launches'].items()} } per step), "
          f"loss by step {[(h['step'], round(h['loss'], 4)) for h in lm['history']]}, eval {lm['eval']}")
    print(f"[{name_limit}] LM train step: {lm['step_ms']:.2f} ms wall in fit, {lm['rows_per_s']:.2f} rows/s, "
          f"{lm['slot_tokens_per_s']:.0f} token slots/s, {lm['real_tokens_per_s']:.0f} real tokens/s, "
          f"{lm['achieved_tflops']:.2f} TFLOP/s achieved ({lm['share_of_bf16_peak']:.4f} of 989; count "
          f"{lm['flops_per_step']}); profiled: {prof['wall_ms_per_step']:.2f} ms wall, "
          f"{prof['device_ms_per_step']:.2f} ms device kernels, device idle share {prof['device_idle_share']:.3f}; "
          f"top kernels {prof['top_kernels_ms_per_step']}")
    print(f"LM first 3 steps, kernels vs plain path: {lm['first_steps_vs_plain']}")
    print(f"LM f32 B2 gradients, kernels vs plain path: ok, worst error "
          f"{lm['f32_grads_vs_plain']['worst_relative_err']:.3e} of each leaf's largest magnitude (limit 1e-4)")

    bert = time_bert_kernels(device, train["lens"], train["launches"])
    serving, extra = time_kernels(device, details["e2e"])
    packed_rows, causal_only = time_packed_kernels(device, lm["launches"])
    records, extra = bert + serving[1:] + packed_rows, serving[:1] + extra + [causal_only]
    for r in records + extra:
        rates = (f", {r['tflops']:.2f} TFLOP/s, {r['bound_share']:.4f} of its bound; the kernel alone "
                 f"{r['kernel_only_ms']:.4f} ms" if "tflops" in r else "")
        print(f"[{name_limit}] {r['name']} {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}{rates}), plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
              f"[{r['method']}; per-call CUDA-event ms {r['event_ms']}; library kernels {r.get('library_kernels')}]")
    print(f"K1/K2/K3 kernels by profiler name in one bf16 train step (tensor-core bodies only): BERT "
          f"{train['kernel_names']}, LM {lm['kernel_names']}")
    print(f"K4 kernels by profiler name in the bf16 engine (decode body + merge, tensor-core query tile): "
          f"{details['e2e'][str(torch.bfloat16)]['k4_kernel_names']}")
    details["kernels"], details["extra_timings"] = records, extra

    torch.cuda.empty_cache()
    details["bert_app"] = app = bert_app(device)
    print(f"[{name_limit}] BERT app (BERT-base bf16 S{BERT_SEQ}, the port's Dataset/Model): Model.train "
          f"{APP_STEPS} steps at B{BERT_BATCH} with checkpoints every {APP_CKPT_EVERY} (launches "
          f"{app['launches']['train']}), metrics {app['metrics']}; latest checkpoint step {app['latest_step']} "
          f"restored bitwise, fit resumed from it; Model.save, Model.load via UNIONML_MODEL_PATH bitwise")
    print(f"[{name_limit}] BERT app serving: {APP_REQUESTS} requests ({app['rows']} rows), half through "
          f"RequestBatcher {app['coalescing']}: labels equal to the plain path on all {app['compared_rows']} rows "
          f"whose plain top-2 gap is >= {GAP_LIMIT_BF16} ({app['split_below_gate']} splits below it, gaps "
          f"{app['split_gaps']}); f32 logits vs plain: max |err| {app['f32_max_abs_err']:.3e} (limit 1e-4); eager "
          f"fallbacks {app['eager_fallbacks']}; K1 by profiler name in a replay: {app['kernel_names']}")
    same = app["bf16_replay_vs_eager"]
    print(f"BERT app bf16 logits, resident replay vs the same padded inputs eager through the same kernels: max "
          f"|diff| {same['max_abs_diff']:.3e} (limit one bf16 step, 2^-7 relative), {same['rows_bitwise']} of "
          f"{same['rows']} rows bitwise; served labels by class {app['label_counts']}")
    for graph in app["graphs"]:
        print(f"[{name_limit}] resident graph {graph['shapes']}: captured in {graph['capture_ms']:.1f} ms "
              f"(two eager warm-up runs and the recording), {graph['replays']} replays")
    for bucket, lat in app["latency"].items():
        print(f"[{name_limit}] resident request {bucket}: replay p50 {lat['replay']['p50_ms']:.3f} ms, p90 "
              f"{lat['replay']['p90_ms']:.3f} ms; eager p50 {lat['eager']['p50_ms']:.3f} ms, p90 "
              f"{lat['eager']['p90_ms']:.3f} ms")
    rp = app["replay_profile"]
    print(f"[{name_limit}] resident 64x128: {app['rows_per_s_64x128']:.1f} rows/s at replay p50; one request "
          f"{rp['wall_ms_per_step']:.3f} ms wall, {rp['device_ms_per_step']:.3f} ms device kernels, idle share "
          f"{rp['device_idle_share']:.3f}; top kernels {rp['top_kernels_ms_per_step']}")
    fo, fn = app["fit_ms"]["checkpoints_off"], app["fit_ms"]["checkpoints_on"]
    print(f"[{name_limit}] fit B{BERT_BATCH} {APP_STEPS} steps: {fo['step_ms']:.2f} ms per step without "
          f"checkpoints, {fn['step_ms']:.2f} with a checkpoint every {APP_CKPT_EVERY} steps; whole call "
          f"{fo['call_ms']:.0f} vs {fn['call_ms']:.0f} ms (the latter with the final flush)")
    save = app["one_save"]
    print(f"[{name_limit}] one Checkpointer.save of the BERT-base TrainState ({save['bytes'] / 1e9:.2f} GB): "
          f"snapshot to host {save['snapshot_ms']:.0f} ms, background write {save['write_ms']:.0f} ms")
    details["total_s"] = time.perf_counter() - t0
    if args.details is not None:
        args.details.parent.mkdir(parents=True, exist_ok=True)
        args.details.write_text(json.dumps(details, indent=1, default=str))

    print(name_limit)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
