"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve, time.

    python3 chip_smoke.py [--details PATH]

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build every kernel in ``unionml_tpu_torch/csrc/`` (one ``nvcc`` each, in
   parallel) and print the build seconds and the ptxas register report;
2. K1 (flash forward) against its plain PyTorch version at the engine's
   prefill shapes, causal and with ``kv_lens``, bf16 and f32;
3. K4 (paged attention) against its plain version: int8 and bf16 pools, S=1
   with B=8, S=32 and S=256 (the chunk) with B=1, table width 65 (max_len
   1024, block 16), ragged bases and scratch tail columns;
4. the slice end to end: GPT-2 small at full width with seeded random
   weights, bf16, an int8 paged pool with 8 slots and max_len 1024, serving
   10 concurrent requests through ``ContinuousBatcher`` (prompts 7..400
   tokens across several buckets, one chunked prefill, one top-k/top-p
   sampled request). The kernels' launch counts must move, and the greedy
   streams must agree with the same engine on the plain PyTorch path
   (``impl="reference"``): a split only counts as agreement where the plain
   path's top-2 logit gap at the split is below 1e-2. An f32 run of the same
   comparison must give identical streams;
5. timings on the card: each kernel at a main-path shape (and one more)
   beside its bound, its plain version and one PyTorch library call, as device
   time from torch.profiler with the CUDA-event time per call beside it;
   engine tokens/s, time to first token, and one decode step's wall time
   against its kernels' device time.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``. ``--details PATH`` also writes every
measurement as JSON. Without a CUDA device the script exits 2 and prints no
result.
"""

import argparse
import asyncio
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # atol (and rtol for bf16); see check_close
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


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error; raises past the dtype's tolerance (f32: atol 2e-5;
    bf16: atol 2e-2 + rtol 2e-2, a few bf16 ulps, since the plain version
    rounds the softmax weights to bf16 before the value product)."""
    tol = TOL[got.dtype]
    err = (got.float() - want.float()).abs()
    limit = tol + (tol * want.float().abs() if got.dtype == torch.bfloat16 else 0.0)
    bad = (err > limit) | ~torch.isfinite(got.float())
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{name}: max |err| {max_err:.3e} beyond tolerance {tol}")
    return max_err


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


def device_ms(fn, iters: int = 20) -> float:
    """Per-call device time: the CUDA kernels' own durations (torch.profiler /
    CUPTI, which also sees kernels launched through ctypes) summed over
    ``iters`` calls. None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_kernel_us(prof).values())
    return total / 1e3 / iters if total > 0 else None


def timed(fn) -> dict:
    """Device ms (profiler) where available, else the CUDA-event ms; both kept."""
    wall = cuda_ms(fn)
    dev = device_ms(fn)
    return {"ms": dev if dev is not None else wall, "event_ms": wall,
            "method": "profiler device time" if dev is not None else "cuda events"}


# ------------------------------------------------------------------ K1


def k1_inputs(B, H, S, D, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((B, H, S, D), generator=g).to(device=device, dtype=dtype) for _ in range(3))
    return q, k, v


def check_k1(device) -> dict:
    from unionml_tpu_torch.ops.attention import (
        _kv_lens_to_mask, _masked_logits, flash_attention, reference_attention,
    )

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        cases = [(B, 12, S, 64, True, None) for B in (1, 4) for S in (16, 100, 256, 512)]
        cases += [(4, 12, S, 64, False, [S, S // 2, 1, 0]) for S in (100, 512)]
        cases += [(2, 4, 77, 128, True, None), (2, 4, 77, 128, False, [77, 30])]
        for B, H, S, D, causal, lens in cases:
            q, k, v = k1_inputs(B, H, S, D, dtype, device, seed=S + B)
            kv_lens = torch.tensor(lens, device=device) if lens is not None else None
            out, lse = flash_attention(q, k, v, kv_lens=kv_lens, causal=causal, return_lse=True)
            mask = _kv_lens_to_mask(kv_lens, S) if kv_lens is not None else None
            want = reference_attention(q, k, v, mask=mask, causal=causal)
            name = f"K1 {dtype} B{B} H{H} S{S} D{D} causal={causal} kv_lens={lens}"
            worst = max(worst, check_close(name, out, want))
            if dtype == torch.float32:
                logits, valid = _masked_logits(q, k, mask, causal, D ** -0.5)
                live = valid.expand(logits.shape).any(dim=-1)  # rows that see a key
                lse_err = float((lse - torch.logsumexp(logits, dim=-1))[live].abs().max())
                if lse_err > 1e-4:
                    raise AssertionError(f"{name}: lse max |err| {lse_err:.3e}")
    return {"max_abs_err": worst}


# ------------------------------------------------------------------ K4


def k4_inputs(B, S, dtype, quantized, device, seed=0, H=12, D=64, bs=16, max_len=1024, bases=None):
    """A filled pool (blocks for every row plus one scratch block), tables
    mapping exactly the blocks each row's last query needs, scratch tails."""
    rng = np.random.default_rng(seed)
    width = -(-max_len // bs) + 1
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
        pool = [t.to(device) for t in (k, v, ks, vs)]
    else:
        k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device=device, dtype=dtype)
        v = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device=device, dtype=dtype)
        pool = [k, v, None, None]
    q = torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32)).to(device=device, dtype=dtype)
    return q, pool, torch.from_numpy(table).to(device), torch.from_numpy(bases).to(device)


def check_k4(device) -> dict:
    from unionml_tpu_torch.ops.paged_attention import paged_attention, reference_paged_attention

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for quantized in (True, False):
            for B, S, D in ((8, 1, 64), (1, 32, 64), (1, 256, 64), (3, 4, 128)):
                q, (k, v, ks, vs), table, base = k4_inputs(
                    B, S, dtype, quantized, device, seed=B * 10 + S, D=D
                )
                got = paged_attention(q, k, v, table, base, ks, vs)
                want = reference_paged_attention(q, k, v, table, base, ks, vs)
                name = f"K4 {dtype} int8={quantized} B{B} S{S} D{D}"
                worst = max(worst, check_close(name, got, want))
    return {"max_abs_err": worst}


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


def compare_streams(kernel_streams, plain_streams, plain_engine, prompt_list, exact: bool):
    """Greedy streams must agree; where they split, the plain path's top-2
    gap there must be below the bf16 limit (``exact``: no split allowed)."""
    splits = []
    for i, (a, b) in enumerate(zip(kernel_streams, plain_streams)):
        if REQUESTS[i][1] is not None or a == b:
            continue
        split = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        gap = top2_gap_at(plain_engine, prompt_list[i], split)
        splits.append({"request": i, "split": split, "plain_top2_gap": gap})
        print(f"stream {i} splits at token {split}: plain top-2 gap {gap:.3e}")
        if exact or gap >= GAP_LIMIT_BF16:
            raise AssertionError(f"stream {i} disagrees with the plain path at token {split} (gap {gap:.3e})")
    return splits


def profile_decode(engine, prompt_list, steps: int = 8) -> dict:
    """Where a decode step's time goes: host wall time per step (synchronized)
    against the device time of its kernels (CUDA profile of as many steps),
    with all 8 slots decoding and no prefill in the window."""
    from torch.profiler import ProfilerActivity, profile

    short = [p for p in prompt_list if len(p) <= PREFILL_CHUNK][: engine.num_slots]
    engine.admit_many([(p, MAX_NEW) for p in short])
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    engine.abort_all()
    kernel_us = _kernel_us(prof)
    device_ms = sum(kernel_us.values()) / 1e3 / steps
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:8]
    return {
        "slots": len(short), "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
        "top_kernels_ms_per_step": [(name[:80], us / 1e3 / steps) for name, us in top],
    }


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
        result[str(dtype)] = {
            "launches": launches, "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_s": ttft, "splits": splits, "decode_step": step_profile, "greedy_equal": sum(
                streams[i] == plain_streams[i] for i in range(len(streams)) if REQUESTS[i][1] is None),
        }
        del engine, plain_engine
    return result


# -------------------------------------------------------------- timings


def _times(kernel, plain, library) -> dict:
    """ms / plain_ms / library_ms, each by the same method (see ``timed``)."""
    k, p, lib = timed(kernel), timed(plain), timed(library)
    return {"ms": k["ms"], "plain_ms": p["ms"], "library_ms": lib["ms"], "method": k["method"],
            "event_ms": {"kernel": k["event_ms"], "plain": p["event_ms"], "library": lib["event_ms"]}}


def _bound(byts: float, flops: float):
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_k1(device, B, S, launches, H=12, D=64) -> dict:
    """K1 on bf16 causal inputs: kernel, plain version, SDPA, and the bound
    (q, k, v read once, o written once; 4*D flops per visible (q, k) pair)."""
    from unionml_tpu_torch.ops.attention import flash_attention, reference_attention

    q, k, v = k1_inputs(B, H, S, D, torch.bfloat16, device)
    err = check_close("K1 timing inputs", flash_attention(q, k, v, causal=True),
                      reference_attention(q, k, v, causal=True))
    bound, by = _bound(4 * q.numel() * q.element_size(), 4 * B * H * D * S * (S + 1) / 2)
    return {
        "name": "flash_fwd", "route": "cuda", "source": "unionml_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "unionml_tpu/ops/attention.py:83", "launches": launches, "max_abs_err": err,
        "bound_ms": bound, "bound_by": by, "shape": f"bf16 B{B} H{H} S{S} D{D} causal",
        **_times(
            lambda: flash_attention(q, k, v, causal=True),
            lambda: reference_attention(q, k, v, causal=True),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True),
        ),
    }


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
        # the second chunk of the 400-token prompt's chunked prefill
        time_k4(device, PREFILL_CHUNK, [PREFILL_CHUNK], launches["paged_attention"]),
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    details["build_s"] = times["total"]

    details["k1"] = check_k1(device)
    print(f"K1 vs plain: ok, max |err| {details['k1']['max_abs_err']:.3e} "
          "(tolerance f32 atol 2e-5; bf16 atol 2e-2 + rtol 2e-2)")
    details["k4"] = check_k4(device)
    print(f"K4 vs plain: ok, max |err| {details['k4']['max_abs_err']:.3e} "
          "(tolerance f32 atol 2e-5; bf16 atol 2e-2 + rtol 2e-2)")

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

    records, extra = time_kernels(device, details["e2e"])
    for r in records + extra:
        print(f"[{name_limit}] {r['name']} {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}), plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
              f"[{r['method']}; per-call CUDA-event ms {r['event_ms']}]")
    details["kernels"], details["extra_timings"] = records, extra
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
