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

12. speculative decoding end to end (``unionml_tpu_torch/serving/speculative.py``):
   GPT-2 small at full width as the target (seeded random weights, bf16,
   int8 paged pool, 8 slots, max_len 1024, block 16, ``gamma_max`` 4), 9
   greedy requests (prompts 7..256 tokens across the buckets, and one of 400
   that prefills in chunks and so decodes vanilla) through
   ``ContinuousBatcher`` with ``{"speculative": True}``, two drafts: the
   target itself (accepted tokens per target step must exceed 2.5) and a
   2-layer GPT-2-small draft of its own seeded weights (gamma must fall to 0).
   Streams must equal the vanilla engine's (same kernels) except where the
   vanilla top-2 gap at the split is below 1e-2; in f32 (self-draft) below
   1e-5, each split printed with its gap. Two sampled requests (temperature
   0.8, seeds) must be bitwise equal with speculation on and off (gamma 0);
   vanilla streams pipelined must equal unpipelined, bf16 and f32, on one
   fixed schedule. Every round must replay its CUDA graph; in one steady
   round the profiler must show K4's decode body and merge and no other K4
   body, the draft prefill ``flash_fwd_wgmma_kernel``, and 5 steady rounds
   and 5 steady decode bursts no ``Memcpy HtoD``. One round run eagerly holds
   every layer's verify chunk to its plain version (K4's tolerance); on a live
   pool, a verify of 8 rows x 5 tokens must score bitwise what decoding the
   tokens one at a time scores (each position's products at the decode
   step's 8 rows), and its commit must leave every layer's codes and scales
   bitwise where the 5 decode appends leave them. Prints tokens/s and
   tokens per round against vanilla, a round's and a vanilla decode step's
   (pipelined and not) wall and device ms and idle share, and K4 at the
   verify shape beside its bound with the local gather + append ms, and the
   verify's device ms and largest logit difference with its products
   batched over the chunk instead (the cost and the reason of exactness).

13. prefix cache, preemption and recovery (``serving/prefix_cache.py``, the
   engine's ``preempt``/``rebuild``, ``serving/supervisor.py``): GPT-2 small,
   int8 pool (bf16) and full-precision pool (f32), 8 slots, max_len 1024,
   block 16, ``prefill_chunk`` 256, ``prefill_batch`` 1. (1) 24 requests share
   a 384-token system prompt (24 blocks) with user suffixes of 8..60 tokens
   and 32 new tokens each: the first, alone, misses; the other 23 (queued at
   once) must hit 24 blocks. Cache on (512 blocks) against off on the same
   requests: f32 streams identical; bf16 streams identical in a second run at
   chunks of 64 and buckets from 64 (``PC_EXACT_KW``, where a hit's suffix
   prefill is the miss's last chunk row for row), while at the served
   configuration a hit computes its suffix at other row counts than the miss
   and bf16 products round by row count, so those splits are printed with
   the off path's top-2 gap and not gated (the exact-path run stands in for
   them); prints hits, prefill tokens computed,
   TTFT p50/p90 hit against miss, tokens/s, one hit's and one miss's prefill
   wall and device ms, K4's kernels and launches in a hit prefill; every
   layer's K4 call in a hit prefill against its plain version (K4's
   tolerance), and K4 timed at the hit's shapes (S 16/32/64 at base 384 over
   the spliced row) in three rounds, each beside the SM clock sampled while
   it ran. (2) 8 follow-ups resend turn 1, its completion and 16
   new tokens (``prefix_cache_generated``): they must hit the generated
   blocks; f32 streams identical, bf16 streams split only where the off
   path's top-2 gap is below 1e-2 (decode-written against prefill-written
   KV). (3) 2 slots preempted after 8 tokens and
   re-admitted with their transcripts: each resume prefills at most one
   block, the joined streams against an uninterrupted run as in (2), no
   block leaks. (4) 6 greedy streams in steady decode, 2 sampled ones
   (temperature 0.8) arrive, and a dispatch fails under an
   ``EngineSupervisor``: every request completes, greedy streams against the
   fault-free run as in (2), the sampled ones bitwise, the supervisor ends
   ``ok``; prints the rebuild and recapture ms. At f32 (full-precision pool)
   the fault comes once the sampled streams have delivered 8 tokens: their
   resume re-prefills prompt and tokens, and the generator is back at the
   lost burst's state. At bf16 it is the dispatch after their first burst
   (the resume re-prefills their prompts only: re-prefilled int8 blocks
   round otherwise than blocks appended token by token, so a sampled stream
   resumed mid-way is held bitwise only at f32);
   then a NaN fault on one slot: it is quarantined and its 7 siblings'
   streams are bitwise those of the run without it (bf16 only). (5)
   self-draft speculation over the cache: streams equal a vanilla engine's
   with the same cache history under the 1e-2 gate (bf16 only). (6) no
   ``Memcpy HtoD`` in 5 steady bursts with the cache on.

14. SLO scheduling (``bench_serving.py::bench_slo_mix`` at this width, phase
   13's engine with an ``EngineSupervisor``, lookahead 8): (1) 48 batch
   requests (6-token prompts, 48 new tokens) flood the queue, 8 interactive
   ones (8 new tokens, ``deadline_ms`` 30000) arrive 50 ms later, 10 ms
   apart; the scheduler (preemption on) against FIFO on freshly warmed
   engines: every request completes with no shed or deadline miss, the
   scheduler arm preempts at least once and resumes as often, no block stays
   pinned or owned, interactive p95 TTFT is below FIFO's, streams equal
   across the arms under the bf16 rule, and identical at f32 without int8
   (24 batch requests there); prints TTFT p50/p95/p99 and ITL p50/p95 by
   class, preemptions, resumes, sheds, misses, queue-wait EMAs and K1/K4
   launches per arm. (2) The ``/generate`` contract through the route's
   plain functions (``parse_generate_payload``, ``error_for``): 8 batch
   hogs of 400 tokens, queue bound 2: 429 ``queue_full`` with
   ``retry_after_ms`` in [750, 1250] (also at a stream's first ``anext``),
   displacement, 504 queued and running, 503 infeasible, 400 for invalid
   payloads, streamed tokens equal to the whole answer. (3) Speculation by
   class: 4 interactive requests run speculative rounds, 4 batch ones none,
   both equal to vanilla under the gate. (4) No ``Memcpy HtoD`` in 5 steady
   bursts with the scheduler in place.

15. serving telemetry (``serving/telemetry.py``, ``metrics.py``, ``slo.py``
   and the hooks of the serving modules): GPT-2 small bf16, phase 13's int8
   pool engine. (1) One fixed engine-level schedule (``admit_many`` and
   ``step``: a 392..444-token prompt alone, then 7 that hit its system prompt
   and 4 bucket misses) on two freshly warmed engines, telemetry off then on:
   greedy streams bitwise identical, K1 and K4 launch counts equal,
   ``decode_fetch_ms`` observed once per burst fetched, and with telemetry on
   no ``Memcpy HtoD`` in 5 steady replayed bursts. (2) Wall ms per replayed
   burst (8 slots), off and on, in the order off, on, on, off (printed, not
   gated). (3) Traces through ``ContinuousBatcher`` with the SLO scheduler
   and an ``EngineSupervisor``: 8 batch requests sharing a 128-token system
   prompt (7 hits), an interactive request that preempts one of them, and a
   NaN fault (``FaultPlan``) that quarantines another. Every trace opens with
   ``admission`` and ends with one ``end``; a completed one has
   ``queue_wait``, then its prefill or hit, then ``decode``; the preempted one
   has ``preempted`` and a resumed ``queue_wait``; the quarantined one ends
   ``error`` with ``nan_logits``; ``assert_balanced`` holds; tokens out,
   prefix hit tokens, preemptions, resumes and quarantines equal the engine's
   and scheduler's own counts; the ``/metrics`` body from
   ``app.metrics_answer`` carries the headline families. K1's and K4's
   launches in (1) ride the kernels line as ``launches_telemetry``.

16. the engine fleet (``serving/fleet.py``) and the fleet simulator
   (``sim/``): two replicas of phase 13's engine (GPT-2 small bf16, int8
   pool, 8 slots each) sharing the one card, each on its own CUDA stream and
   worker thread, supervised, lookahead 8, behind the prefix-affinity router.
   Traffic is ``bench_serving.py::bench_fleet``'s mix at this width: 4 groups
   x 8 requests sharing a 384-token prefix, 6..24-token suffixes, groups
   interleaved, one in four ``interactive``, 32 new tokens, greedy. (1) A cold
   pass per router arm on fresh replicas: affinity's prefix hit rate must
   beat random's. Then, for affinity and for one replica alone (graphs
   captured first), every prompt is primed on every replica and a warm pass
   prints tokens/s and TTFT p50/p95 by class; one more warm pass runs in one
   CUDA profile for the device idle share (device events as a union in time
   across the two streams) and the share of device time that overlapped.
   Each replica's replayed burst wall is printed with the other replica idle
   and with it decoding on its own thread. The two warm passes' streams are
   printed side by side with their splits' top-2 gaps (report: a prefix
   block's int8 codes depend on the row count of the chunk that first
   prefilled it). (2) Parity: at the exact-path configuration (phase 13's
   chunks of 64), a 2-replica fleet's bf16 streams agree with one supervised
   batcher's under the bf16 rule up to each stream's first preemption, and
   at f32 with an f32 pool they are identical (16 requests each). (3) At
   f32, replica 0 fails once and recovers in place (its graphs recaptured
   while replica 1 replays), and in another run replica 1 dies
   (``FaultPlan``, every rebuild failing): every request completes with
   identical streams, ``rerouted_tickets`` >= 1 with no failed re-route, no
   block stays pinned, no capture fails, and the K1/K4 counts equal the sum
   of the per-thread tallies, two worker threads launching K4. (4) 4
   sessions of 3 turns (a 24..48-token opening, then the transcript plus
   6..24 tokens): every turn of a session on one replica, each later turn
   prefilling at most its message plus one block; session 3's replica dies
   in its second turn, the turn completes on the adopter (its transcript a
   bucket prefill, K1) and the session's third turn sticks there. (5) The
   affinity fleet's journal through ``replay_journal`` and
   ``fit_cost_model``, and a 2-replica ``FleetSimulator`` on the same mix
   with the fitted costs: its TTFT by class and seconds beside the measured
   warm pass (printed, not gated). The fleet path's K1/K4 launches ride the
   kernels line as ``launches_fleet``.

17. the sparse (mixture-of-experts) GPT (``models/moe.py``, ``parallel/ep.py``):
   GPT-2 small widths with every second block sparse (8 experts, top-2,
   capacity factor 1.25; expert weights bf16), seeded random weights. (a)
   ``MoEMlp`` bf16 and f32 against its plain version (the one-hot einsum
   formulation, f32 on the card) on the same gates: capacity mode at one
   training step's 8192 tokens with a router biased toward expert 0, so
   choices really drop (the drop count printed, the dropped sets equal
   exactly), and dropless at a chunk's 256 and a decode step's 8 tokens;
   the index dispatch's forward ms beside the one-hot's. (b) A moe-textgen
   shaped app (``build_moe_app``) through ``Model.train``: ``fit_lm(moe_aux=
   True, pack=True)`` for 10 steps at B8 S1024 (K2/K3 once per layer and
   step, K1 at least that); the first 3 steps against the plain path
   (losses within 1e-2 relative, ``grad_norm`` within 2 %); the router
   losses, a step's wall against device ms and idle share; ``Model.predict``
   (ragged prompts through ``generate``, dropless) equal to ``generate``
   called directly. (c) What ``model.serve(generator=...)`` builds for
   ``/generate`` (``build_generator``: lookahead 8, supervised, a self-draft
   ``SpeculativeEngine`` with 8 slots and the prefix cache) through the
   route's plain handler (``parse_generate_payload``, ``stream``): 8
   requests sharing a 128-token prompt (the first alone, then 7 at once that
   hit it; the last ``interactive``, so it speculates; then a warm pass of
   the same requests for the timings), 32 new tokens each,
   bf16 over the int8 pool (streams against the plain path's engine under
   the 1e-2 gap rule) and f32 over an f32 pool (identical); tokens/s, TTFT
   p50/p95 and launches. A 1-step decode burst (8 slots) of the sparse model
   and of the dense GPT-2 small, wall against device ms, beside the floor of
   reading every expert weight once. The sparse path's K1-K4 launches ride
   the kernels line as ``launches_moe``.

18. the DecodeEngine's last two modes at GPT-2-small width with phase 5's
   seeded weights and 10 requests (32 new tokens, 8 slots, max_len 1024,
   chunks of 256, one prompt per prefill dispatch). (a) Weight-only int8
   (``quantize="int8"``: the engine's own copy of the model, every decoder
   kernel int8 with per-output f32 scales, dequantized per layer just before
   its product) through ``ContinuousBatcher``, bf16 over the int8 pool and f32
   over an f32 pool: streams against the same engine on the plain path (f32
   identical; bf16 under the 1e-2 gap rule, a split at a larger gap passing
   only inside bf16 rounding, see ``di_gate``); ``quantized_bytes`` exactly
   (243 287 040 stored, 497 759 232 at f32); the caller's model unchanged
   (dtypes, an f64 checksum, layer types); a self-draft
   ``SpeculativeEngine(quantize="int8")`` against the vanilla int8 engine
   under the 1e-2 gap rule. Prints, ungated, the greedy agreement with
   full-precision weights, the largest first-step logit gap between the two,
   and a 1-step 8-slot bf16 burst's wall and device ms with full-precision
   and int8 weights (in turns: full, int8, int8, full), with its top kernels
   and the memory of its first graph's private pool. (b) The dense engine
   (``paged=False``) at bf16 and f32: streams against its plain path and
   against the paged engine over a pool of the compute dtype (f32: identical
   or split where the plain path's top-2 gap is below 1e-5; bf16 as in (a));
   K1 must launch and K4 never; no ``Memcpy HtoD`` in 5 steady bursts; its
   burst against the paged one (dense, paged, paged, dense) and tokens/s and
   TTFT against the paged engine's. At f32 the prefix cache: 9 requests on a
   384-token system prompt (8 hits), streams on against off under the f32
   rule, prefill tokens, restores and saves printed; 2 preemptions and resumes
   whose streams must be identical to the same requests uninterrupted, each
   resume prefilling at most one block. The K1 launches of (b) and the K1/K4
   launches of (a), at bf16, ride the kernels line as ``launches_dense_int8``.

Decode bursts, speculative rounds and resident requests replay CUDA graphs. A
graph's recording launches nothing and counts nothing; each replay adds the
launches its graph recorded. A count is thus the launches that ran: eager
calls (the captures' two warm-up runs among them) and replays.

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
import threading
import time
import types
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


# A profile taken in a process that has run a while lacks the records of its
# first launches, the more the older the process (torch 2.11, CUPTI, on the
# H100), however long the session waits before launching; now and then a
# session records nothing at all. Every CUDA profile here therefore opens
# with PROFILE_PAD launches of a kernel nothing else runs (``i0e``), whose
# records are left out of every reading, and is taken again, up to
# PROFILE_TAKES times in all, while it kept none of them. PROFILE_LOST keeps
# the seconds since the script started, the pad records lost and the records
# kept of every session.
PROFILE_PAD, PAD_KERNEL, PROFILE_TAKES = 256, "i0e", 4
PROFILE_LOST: list = []
_STARTED = time.perf_counter()


def cuda_profile(body):
    """Run ``body(first)`` in a CUDA-only ``torch.profiler`` session that
    opens with the pad (``first`` is False on a retake); returns the profile
    and the last call's result. The pad is counted from the profiler's raw
    device events (:func:`device_events`), which builds no event tree, so a
    session of a few hundred thousand kernels is checked in seconds."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.ones(1, device="cuda")
    for take in range(PROFILE_TAKES):
        if take:
            time.sleep(0.2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.special.i0e(pad)
            out = body(take == 0)
            torch.cuda.synchronize()
        names = [name for name, _, _ in device_events(prof)]
        kept = sum(PAD_KERNEL in name for name in names)
        PROFILE_LOST.append((time.perf_counter() - _STARTED, PROFILE_PAD - kept, len(names)))
        if kept:
            return prof, out
    raise AssertionError(f"{PROFILE_TAKES} profiles in a row kept none of their {PROFILE_PAD} pad records")


def device_events(prof) -> list:
    """``(name, start ns, end ns)`` of every device event of a profile, from
    the profiler's raw results."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def _kernel_us(prof) -> dict:
    """Device microseconds per kernel name from a CUDA-only profile (the
    pad left out)."""
    out = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us and PAD_KERNEL not in event.key:
            out[event.key] = out.get(event.key, 0.0) + float(us)
    return out


def kernel_ms_by_name(fn, iters: int = 20, counts: dict = None) -> dict:
    """Per-call device ms of each kernel ``fn`` launches, by kernel name: the
    CUDA kernels' own durations (torch.profiler / CUPTI, which also sees
    kernels launched through ctypes) over ``iters`` calls. ``counts``, when
    given, receives the launches of each name the profile recorded."""
    fn()
    torch.cuda.synchronize()

    def calls(first):
        for _ in range(iters):
            fn()

    prof, _ = cuda_profile(calls)
    by_name = _kernel_us(prof)
    if counts is not None:
        counts.update({e.key: e.count for e in prof.key_averages() if e.key in by_name})
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
    kept, with the names of the kernels that ran and how many launches of
    each the profile recorded (20 calls' worth)."""
    wall = cuda_ms(fn)
    counts = {}
    by_name = kernel_ms_by_name(fn, counts=counts)
    dev = sum(by_name.values())
    return {"ms": dev if dev > 0 else wall, "event_ms": wall, "by_name_ms": by_name, "recorded_launches": counts,
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


def top2_gap_at(engine, prompt, split: int, budget: int = MAX_NEW) -> float:
    """The plain engine's top-2 logit gap where it picks token ``split`` of
    ``prompt``'s greedy stream of ``budget`` tokens (replayed alone,
    unpipelined, so the device state is the host's: rows are independent)."""
    top = torch.topk(logits_at(engine, prompt, split, budget), 2).values
    return float(top[0] - top[1])


def logits_at(engine, prompt, split: int, budget: int = MAX_NEW) -> torch.Tensor:
    """The logits ``engine`` picks token ``split`` of ``prompt``'s greedy
    stream from (see ``top2_gap_at``)."""
    pipeline, engine.pipeline = engine.pipeline, False
    slot = engine.add_request(prompt, budget)
    while slot in engine._partials:  # finish a chunked prefill without decoding
        engine._advance_partials()
    emitted = 0
    while emitted < split:
        emitted += sum(1 for ev in engine.step() if ev.slot == slot and ev.emit)
    logits = engine._last_logits[slot].clone()
    engine.cancel(slot)
    engine.pipeline = pipeline
    return logits


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


def lm_first_steps(config, params, device, impl: str, batches, moe_aux: bool = False) -> list:
    from unionml_tpu_torch.models import make_lm_train_step

    state, step = lm_state(config, params, device, impl), make_lm_train_step(packed=True, moe_aux=moe_aux)
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
    serve_launches = dict(kernels.launches)  # the captures' warm-ups and every replay
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


# ---------------------------------------------------------- speculation

SPEC_LENS = [7, 13, 30, 60, 100, 150, 200, 256, 400]  # the 400-token prompt prefills in chunks: not armed
SPEC_GAMMA_MAX = 4
GAP_LIMIT_F32 = 1e-5
K4_BODIES = ("paged_decode_kernel", "paged_merge_kernel", "paged_tile_wgmma_kernel", "paged_tile_f32_kernel")


def spec_prompts(vocab: int, seed: int = 0) -> list:
    rng = np.random.default_rng(100 + seed)
    return [rng.integers(0, vocab, n).tolist() for n in SPEC_LENS]


# phase 12's engines prefill one prompt per dispatch: a bucket prefill's
# products round by their row count, so a prompt prefilled beside whichever
# requests the batcher's worker happened to find queued could score
# differently from run to run; decode rows do not interact
SPEC_ENGINE_KW = dict(num_slots=8, max_len=1024, kv_quantize="int8", prefill_chunk=PREFILL_CHUNK, prefill_batch=1,
                      seed=0)


def vanilla_engine(model, device, **kw):
    from unionml_tpu_torch.serving.continuous import DecodeEngine

    return DecodeEngine(model, device=device, **SPEC_ENGINE_KW, **kw)


def spec_engine(model, draft, device):
    from unionml_tpu_torch.serving.speculative import SpeculativeEngine

    return SpeculativeEngine(model, draft, gamma_max=SPEC_GAMMA_MAX, device=device, **SPEC_ENGINE_KW)


def batch_serve(engine, prompt_list, sampling, device):
    """Every prompt through ``ContinuousBatcher`` at once with ``sampling``;
    returns (streams, wall s)."""
    from unionml_tpu_torch.serving.continuous import ContinuousBatcher

    async def run(batcher):
        t0 = time.perf_counter()
        streams = await asyncio.gather(*(batcher.generate(p, MAX_NEW, **sampling) for p in prompt_list))
        return list(streams), time.perf_counter() - t0

    batcher = ContinuousBatcher(engine, device=device)
    try:
        return asyncio.run(run(batcher))
    finally:
        batcher.close()


def drive(engine, requests) -> list:
    """Admit ``(prompt, budget, sampling)`` requests in order as slots free
    and step the engine dry, with no thread: one fixed schedule."""
    streams, owner, pending = [[] for _ in requests], {}, list(range(len(requests)))

    def pump(events):
        for ev in events:
            if ev.emit:
                streams[owner[ev.slot]].append(ev.token)

    while pending or engine.num_active or engine.has_pending_prefill or engine.has_pending_events:
        take, pending = pending[:len(engine.free_slots)], pending[len(engine.free_slots):]
        if take:
            slots = engine.admit_many([requests[i] for i in take])
            pump(engine.take_pending_events())
            owner.update(zip(slots, take))
        pump(engine.step())
    return streams


def gated_splits(label, got, want, plain_engine, prompt_list, limit, budget=MAX_NEW) -> list:
    """Where each greedy stream of ``got`` leaves ``want``, with the plain
    engine's top-2 gap there; raises where that gap is at least ``limit``."""
    splits = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        split = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        gap = top2_gap_at(plain_engine, prompt_list[i], split, budget)
        print(f"{label}: stream {i} splits at token {split}: vanilla top-2 gap {gap:.3e}")
        if gap >= limit:
            raise AssertionError(f"{label}: stream {i} disagrees with vanilla at token {split} (gap {gap:.3e})")
        splits.append({"request": i, "split": split, "vanilla_top2_gap": gap})
    return splits


def graph_replays(engine) -> dict:
    return {str(key): graph.replays for key, graph in engine._step_fns.items()}


def count_htod(fn, calls: int) -> int:
    """``Memcpy HtoD`` records in a CUDA profile of ``calls`` calls of ``fn``."""
    def run(first):
        for _ in range(calls):
            fn()

    prof, _ = cuda_profile(run)
    return sum(e.count for e in prof.key_averages() if "Memcpy HtoD" in e.key)


def steady(engine, prompt_list, sampling, budget=400):
    """Fill every slot with a bucket-prefilled request of ``budget`` tokens and
    step until its graphs are captured and the chunk-free steady state runs."""
    short = [p for p in prompt_list if len(p) <= PREFILL_CHUNK][: engine.num_slots]
    short += short[: engine.num_slots - len(short)]
    engine.admit_many([(p, budget, sampling) for p in short])
    for _ in range(3):
        engine.step()


def verify_vs_plain(engine) -> dict:
    """One round run eagerly through the normal step, every layer's verify
    chunk recorded: each layer's contexts (K4 on the card) against the plain
    version on the same inputs (phase 3's K4 tolerance), the pool untouched by
    both."""
    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.models import gpt as tgpt

    real, calls, launched = tgpt._paged_verify_chunk, [], []

    def record(cache, table, position, q, k, v, out_dtype, impl="auto"):
        before = {n: x.clone() for n, x in cache.items()}
        count = kernels.launches["paged_attention"]
        out = real(cache, table, position, q, k, v, out_dtype, impl=impl)
        launched.append(kernels.launches["paged_attention"] - count)
        calls.append((before, table.clone(), position.clone(), q, k, v, out_dtype, out))
        return out

    run_program = engine._run_program
    tgpt._paged_verify_chunk = record
    engine._run_program = lambda key, fn, generators=(): fn()
    try:
        engine.step()
    finally:
        tgpt._paged_verify_chunk, engine._run_program = real, run_program
    worst = 0.0
    for layer, (cache, table, position, q, k, v, out_dtype, out) in enumerate(calls):
        probe = {n: x.clone() for n, x in cache.items()}
        want = real(probe, table, position, q, k, v, out_dtype, impl="reference")
        worst = max(worst, check_close(f"verify chunk, layer {layer}", out, want))
        if not all(torch.equal(probe[n], cache[n]) for n in cache):
            raise AssertionError(f"verify chunk, layer {layer}: the plain verify wrote the pool")
    return {"layers": len(calls), "max_abs_err": worst, "bases": calls[0][2].tolist(),
            "verify_launches_per_round": sum(launched)}


def time_k4_verify(device, bases, launches, H=12, D=64, bs=16, width=65) -> dict:
    """K4 at the verify shape: B = len(bases), S 1, over a local copy of each
    row's ``width`` blocks (int8, bf16 queries) and an identity table, as
    ``_paged_verify_chunk`` calls it once per chunk position and layer; and the
    device ms of the local gather + one append per leaf, the torch ops around
    it per layer. ``launches``: the verify's K4 launches in one round."""
    from unionml_tpu_torch.models.gpt import _paged_append_quantized
    from unionml_tpu_torch.ops.paged_attention import fused_hbm_bytes, paged_attention, reference_paged_attention
    from unionml_tpu_torch.ops.quant import dequantize_blockwise

    B = len(bases)
    q, (kp, vp, ks, vs), table, base = k4_inputs(B, 1, torch.bfloat16, True, device, bases=bases, width=width)
    t = table.long()
    local = [x[t].reshape((B * width,) + tuple(x.shape[1:])).contiguous() for x in (kp, vp, ks, vs)]
    ident = (torch.arange(B, device=device)[:, None] * width + torch.arange(width, device=device)).to(torch.int32)
    err = check_close("K4 at the verify shape", paged_attention(q, *local[:2], ident, base, *local[2:]),
                      reference_paged_attention(q, *local[:2], ident, base, *local[2:]))
    cols = [b // bs + 1 for b in bases]
    byts = sum(fused_hbm_bytes(c, bs, H, D, True) + c * 4 for c in cols) + 2 * q.numel() * 2 + B * 4
    bound, by = _bound(byts, sum(4 * H * D * (b + 1) for b in bases))

    def gather_sdpa():
        kd = dequantize_blockwise(local[0][ident.long()], local[2][ident.long()], torch.bfloat16)
        vd = dequantize_blockwise(local[1][ident.long()], local[3][ident.long()], torch.bfloat16)
        kd, vd = (x.transpose(1, 2).reshape(B, H, -1, D) for x in (kd, vd))
        mask = torch.arange(kd.shape[2], device=device)[None, None, :] <= base[:, None, None]
        return torch.nn.functional.scaled_dot_product_attention(q, kd, vd, attn_mask=mask[:, None])

    vals = torch.randn(B, H, D, device=device, dtype=torch.bfloat16)
    blk, off = (base.long() // bs), (base.long() % bs)
    dst = torch.arange(B, device=device) * width + blk

    def gather_append():
        kc, vc, kss, vss = (x[t].reshape((B * width,) + tuple(x.shape[1:])) for x in (kp, vp, ks, vs))
        _paged_append_quantized(kc, kss, dst, off, vals)
        _paged_append_quantized(vc, vss, dst, off, vals)

    return {
        "name": "paged_attention", "route": "cuda", "source": "unionml_tpu_torch/csrc/paged_attention.cu",
        "replaces": "unionml_tpu/ops/paged_attention.py:92", "launches": launches, "max_abs_err": err,
        "bound_ms": bound, "bound_by": by,
        "shape": f"verify: bf16 int8 local pool B{B} H{H} S1 D{D} bs{bs} width {width} (identity table), "
                 f"bases {list(bases)}; the verify's launches in one round",
        "gather_append_ms_per_layer": sum(kernel_ms_by_name(gather_append).values()),
        **_times(lambda: paged_attention(q, *local[:2], ident, base, *local[2:]),
                 lambda: reference_paged_attention(q, *local[:2], ident, base, *local[2:]), gather_sdpa),
    }


def speculation(device) -> dict:
    """Speculative decoding end to end (phase 12, see the module docstring)."""
    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.models import GPTConfig, init_gpt, random_params

    config = GPTConfig()
    params = random_params(config, seed=0)
    draft_config = dataclasses.replace(config, num_layers=2)
    draft_params = random_params(draft_config, seed=1)
    prompt_list = spec_prompts(config.vocab_size)
    greedy = [(p, MAX_NEW, {}) for p in prompt_list]
    spec = {"speculative": True}
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        r = out[str(dtype)] = {}
        model = init_gpt(dataclasses.replace(config, dtype=dtype), params=params, device=device)
        vanilla = vanilla_engine(model, device)
        batch_serve(vanilla, prompt_list[:1], {}, device)  # warm-up: the burst graphs, cuBLAS
        van_streams, van_wall = batch_serve(vanilla, prompt_list, {}, device)
        r["vanilla_tokens_per_s"] = sum(map(len, van_streams)) / van_wall
        # dispatch-ahead: the same fixed schedule pipelined and not
        unpiped = vanilla_engine(model, device, pipeline=False)
        if drive(vanilla, greedy) != drive(unpiped, greedy):
            raise AssertionError(f"{dtype}: pipelined vanilla streams differ from unpipelined ones")
        drafts = {"self": model}
        if dtype == torch.bfloat16:
            drafts["2-layer"] = init_gpt(dataclasses.replace(draft_config, dtype=dtype), params=draft_params,
                                         device=device)
        for label, draft in drafts.items():
            engine = spec_engine(model, draft, device)
            batch_serve(engine, prompt_list[:1], spec, device)  # warm-up: the round graph
            before = engine.speculation_stats()
            kernels.reset_launches()
            streams, wall = batch_serve(engine, prompt_list, spec, device)
            launches = dict(kernels.launches)
            stats = engine.speculation_stats()
            ran = (stats["rounds"] - before["rounds"], stats["accepted"] - before["accepted"])
            limit = GAP_LIMIT_BF16 if dtype == torch.bfloat16 else GAP_LIMIT_F32
            splits = gated_splits(f"{dtype} {label}-draft", streams, van_streams, vanilla, prompt_list, limit)
            for name in ("flash_fwd", "paged_attention"):
                if launches[name] == 0:
                    raise AssertionError(f"{dtype} {label}-draft: the speculative path never launched {name}")
            rounds = [k for k in engine._step_fns if k[0] == "round"]
            if not rounds or engine.spec_round_dispatches != sum(engine._step_fns[k].replays for k in rounds):
                raise AssertionError(f"{dtype} {label}-draft: a round ran outside its CUDA graph "
                                     f"({graph_replays(engine)}, {engine.spec_round_dispatches} dispatches)")
            rec = r[label] = {"tokens_per_s": sum(map(len, streams)) / wall, "launches": launches,
                              "stats": stats, "splits": splits, "graph_replays": graph_replays(engine),
                              "tokens_per_round": sum(map(len, streams)) / max(1, ran[0])}
            if label == "self" and stats["accepted_per_target_step"] <= 2.5:
                raise AssertionError(f"{dtype} self-draft: accepted per target step {stats}")
            if label == "2-layer" and stats["fallback_rounds"] == 0:
                raise AssertionError(f"{dtype} 2-layer draft: gamma never fell to 0: {stats}")
            if label == "self" and dtype == torch.bfloat16:
                sampled = [(prompt_list[i], MAX_NEW, {"speculative": True, "temperature": 0.8, "seed": i})
                           for i in (1, 3)]
                on, off = drive(engine, sampled), drive(engine, [(p, n, dict(s, gamma=0)) for p, n, s in sampled])
                if on != off:
                    raise AssertionError("sampled streams differ between speculation on and off")
                rec["sampled_on_equals_off"] = True
                rec["verify_vs_plain"] = verify_vs_plain_phase(engine, prompt_list, device)
            del engine
            torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            r["timings"] = spec_timings(model, vanilla, unpiped, prompt_list, device,
                                        r["self"]["verify_vs_plain"]["verify_launches_per_round"])
        del model, vanilla, unpiped, drafts
        torch.cuda.empty_cache()
    return out


def verify_vs_plain_phase(engine, prompt_list, device) -> dict:
    """The round's graph checks and ``verify_vs_plain`` in a steady state of
    8 speculative slots."""
    steady(engine, prompt_list, {"speculative": True})
    names = [n for n in kernel_ms_by_name(engine.step, 1) if "paged_" in n]
    found = " ".join(names)
    if not all(k in found for k in K4_BODIES[:2]) or any(k in found for k in K4_BODIES[2:]):
        raise AssertionError(f"one round: K4 kernels by profiler name {names}; expected the decode body and merge")
    htod = count_htod(engine.step, 5)
    if htod:
        raise AssertionError(f"5 steady-state rounds made {htod} host-to-device copies")
    result = {"k4_kernel_names": names, "memcpy_htod_5_rounds": htod, **verify_vs_plain(engine)}
    ids = torch.tensor([prompt_list[5] + [0] * (256 - len(prompt_list[5]))], device=device)
    k1 = [n for n in kernel_ms_by_name(lambda: engine._prefill(ids, torch.tensor([len(prompt_list[5])],
                                                                                  device=device),
                                                               engine._draft_model), 1) if "flash_fwd" in n]
    if not any("flash_fwd_wgmma_kernel" in n for n in k1):
        raise AssertionError(f"the draft prefill's kernels {k1}: no flash_fwd_wgmma_kernel")
    result["draft_prefill_k1"] = k1
    engine.abort_all()
    return result


def verify_products(model, engine, device) -> dict:
    """The verify's logits for 8 rows x 5 chunk tokens on a live pool against
    the same tokens fed one at a time through decode: bitwise with each
    position's products at the decode step's row count (what the engine
    runs), and the commit of all 5 tokens leaves every layer's codes and
    scales bitwise where the 5 decode appends leave them; with the products
    batched over the chunk (40 rows), the largest logit difference. Device ms
    of one verify forward each way."""
    from unionml_tpu_torch.models import _layers
    from unionml_tpu_torch.models import gpt as tgpt

    def copy():
        return {"table": engine._tables, **{n: {k: x.clone() for k, x in layer.items()}
                                             for n, layer in engine._pool.items()}}

    chunk = torch.randint(0, model.config.vocab_size, (engine.num_slots, SPEC_GAMMA_MAX + 1), device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
    lens, cache, fed = engine._lens.clone(), copy(), copy()

    def verify():  # leaves ``cache`` as it found it
        with torch.no_grad():
            return model(chunk, cache=cache, position=lens)

    with torch.no_grad():
        seq = torch.stack([model(chunk[:, j:j + 1], cache=fed, position=lens + j)[0][:, 0]
                           for j in range(chunk.shape[1])], dim=1)
    exact, verified = verify()
    if not torch.equal(exact, seq):
        raise AssertionError(f"verify logits differ from decode's by {float((exact - seq).abs().max()):.3e}")
    counts = torch.full_like(lens, chunk.shape[1])
    for name in engine._pool:
        layer = {k: x for k, x in cache[name].items()}
        tgpt.paged_commit_chunk(layer, engine._tables, lens, counts, verified[name]["ck"], verified[name]["cv"])
        if not all(torch.equal(layer[k], fed[name][k]) for k in layer):
            raise AssertionError(f"{name}: the commit of the verified chunk differs from the decode appends")
    cache = copy()
    out = {"per_position_ms": sum(kernel_ms_by_name(verify, 5).values())}
    by_position, tgpt._dense_by_position = tgpt._dense_by_position, _layers._dense
    try:
        out["batched_max_logit_diff"] = float((verify()[0] - seq).abs().max())
        out["batched_ms"] = sum(kernel_ms_by_name(verify, 5).values())
    finally:
        tgpt._dense_by_position = by_position
    return out


def spec_timings(model, vanilla, unpiped, prompt_list, device, verify_launches) -> dict:
    """A round's wall vs device ms (self-draft, 8 speculative slots) and its
    K4 launches (one replay), a vanilla decode step's with ``pipeline`` on and
    off, zero host-to-device copies over 5 steady bursts, and K4 at the verify
    shape."""
    from unionml_tpu_torch import kernels

    out = {}
    for label, engine in (("pipelined", vanilla), ("unpipelined", unpiped)):
        steady(engine, prompt_list, {})
        out[f"decode_step_{label}"] = step_profile(engine.step, 5, top=6)
        if label == "pipelined":
            out["memcpy_htod_5_bursts"] = htod = count_htod(engine.step, 5)
            if htod:
                raise AssertionError(f"5 steady-state decode bursts made {htod} host-to-device copies")
            out["verify_products"] = verify_products(model, engine, device)
        engine.abort_all()
    engine = spec_engine(model, model, device)
    steady(engine, prompt_list, {"speculative": True})
    out["round"] = step_profile(engine.step, 5, top=6)
    kernels.reset_launches()
    engine.step()
    out["round_launches"] = dict(kernels.launches)
    bases = [int(b) for b in engine._lens.tolist()]
    engine.abort_all()
    out["k4_verify"] = time_k4_verify(device, bases, verify_launches)
    return out


# ------------------------------------------- prefix cache, preemption, recovery


PC_SYSTEM, PC_REQUESTS, PC_BLOCKS, PC_FOLLOWUPS, PC_NEW = 384, 24, 512, 8, 16
RECOVERY_SAMPLED_TOKENS = 8  # a full-precision pool's sampled streams delivered before the fault
K4_HIT_ROUNDS = 3
# prefill_batch 1 as in phase 12: a prompt's prefill products then never
# depend on what else the batcher found queued
PC_ENGINE_KW = dict(num_slots=8, max_len=1024, prefill_chunk=PREFILL_CHUNK, prefill_batch=1, seed=0)


def pc_prompts(vocab: int, n: int = PC_REQUESTS, seed: int = 0) -> list:
    """``n`` prompts sharing one 384-token system prompt (24 blocks of 16),
    each with its own user suffix of 8..60 tokens."""
    rng = np.random.default_rng(300 + seed)
    system = rng.integers(0, vocab, PC_SYSTEM).tolist()
    return [system + rng.integers(0, vocab, int(rng.integers(8, 61))).tolist() for _ in range(n)]


def pc_engine(model, device, blocks, quant, **kw):
    from unionml_tpu_torch.serving.continuous import DecodeEngine

    return DecodeEngine(model, device=device, kv_quantize=quant, prefix_cache_blocks=blocks,
                        **dict(PC_ENGINE_KW, **kw))


def leaked(engine) -> tuple:
    """(pinned blocks, slot-owned blocks, largest node refcount): zero once
    every request retired and every checkpoint was released (a dense
    engine's index owns no slot blocks)."""
    cache = engine._allocator if engine._allocator is not None else engine.prefix_cache
    worst, stack = 0, list(cache._root.children.values())
    while stack:
        node = stack.pop()
        worst = max(worst, node.refcount)
        stack.extend(node.children.values())
    return cache.pinned_blocks, cache.slot_blocks, worst


def stream_after(engine, first, rest, device, sampling=None):
    """``first`` alone through ``ContinuousBatcher`` (it fills the cache),
    then every prompt of ``rest`` at once; (streams, TTFT s of each, wall s
    of ``rest``)."""
    from unionml_tpu_torch.serving.continuous import ContinuousBatcher

    async def one(batcher, prompt, t0):
        out, ttft = [], None
        async for token in batcher.stream(prompt, MAX_NEW, **(sampling or {})):
            ttft = time.perf_counter() - t0 if ttft is None else ttft
            out.append(token)
        return out, ttft

    async def run(batcher):
        t0 = time.perf_counter()
        head = [await one(batcher, p, t0) for p in first]
        t0 = time.perf_counter()
        tail = await asyncio.gather(*(one(batcher, p, t0) for p in rest))
        wall = time.perf_counter() - t0
        return [s for s, _ in head + list(tail)], [t for _, t in head + list(tail)], wall

    batcher = ContinuousBatcher(engine, device=device)
    try:
        return asyncio.run(run(batcher))
    finally:
        batcher.close()


def pc_compare(label, got, want, plain_engine, prompt_list, mode: str) -> list:
    """Greedy streams against ``want``. ``identical``: no split at all (f32,
    and bf16 where the two paths run the same products on the same inputs);
    ``bf16``: splits only where the plain engine's top-2 gap is below 1e-2
    (the bf16 rule of PERF.md section 2); ``report``: a bf16 hit against a
    miss at the served configuration, whose suffix products run at other row
    counts (a 16..64-row bucket against a 256-row chunk) and round otherwise
    (PR 8: plain bf16 leaves f32 beyond the 1e-2 gate in 9 % of streams), so
    each split is printed with the plain engine's gap and none fails the run:
    the exact-path run holds that path instead."""
    if mode == "identical":
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if bad:
            raise AssertionError(f"{label}: streams {bad} differ (identical required)")
        return []
    limits = {"bf16": GAP_LIMIT_BF16, "report": float("inf")}
    return gated_splits(label, got, want, plain_engine, prompt_list, limits[mode])


def admission_ms(engine, prompts) -> dict:
    """An admission until the slot decodes (a hit's suffix prefill, or a
    miss's chunked prefill), cancelled after: the synchronized wall ms of the
    first prompt's, and the device ms (profiler), K4's kernel names and
    launches of the second's (another prompt: the first's own blocks are
    indexed by then; the third stands in if that profile is taken again)."""
    from unionml_tpu_torch import kernels

    def admit(prompt):
        slot = engine.add_request(prompt, MAX_NEW)
        while slot in engine._partials:
            engine._advance_partials()
        return slot

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.cancel(admit(prompts[0]))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    slots = []

    def profiled(first):
        if slots:
            engine.cancel(slots[-1])
        before = kernels.launches["paged_attention"]
        slots.append(admit(prompts[1 if first else 2]))
        return kernels.launches["paged_attention"] - before

    prof, launches = cuda_profile(profiled)
    engine.cancel(slots[-1])
    by_name = {n: us / 1e3 for n, us in _kernel_us(prof).items()}
    return {"wall_ms": wall, "device_ms": sum(by_name.values()), "k4_launches": launches,
            "k4_kernels": sorted(n[:60] for n in by_name if "paged_" in n)}


def hit_vs_plain(engine, prompt) -> dict:
    """A hit admission with every layer's K4 call recorded: each against its
    plain version on the same inputs (phase 3's tolerance). Returns the worst
    error, the calls' query lengths and bases, and the slot (left admitted)."""
    from unionml_tpu_torch.models import gpt as tgpt
    from unionml_tpu_torch.ops.paged_attention import reference_paged_attention

    real, calls = tgpt.paged_attention, []

    def record(q, k, v, table, base, k_scale=None, v_scale=None, **kw):
        out = real(q, k, v, table, base, k_scale=k_scale, v_scale=v_scale, **kw)
        calls.append((q, k, v, table.clone(), base.clone(), k_scale, v_scale, out))
        return out

    tgpt.paged_attention = record
    try:
        slot = engine.add_request(prompt, MAX_NEW)
    finally:
        tgpt.paged_attention = real
    if slot in engine._partials or len(calls) != engine._config.num_layers:
        raise AssertionError(f"a hit admission ran {len(calls)} K4 calls (a chunked prefill instead?)")
    worst = 0.0
    for layer, (q, k, v, table, base, ks, vs, out) in enumerate(calls):
        want = reference_paged_attention(q, k, v, table, base, ks, vs)
        worst = max(worst, check_close(f"K4 hit prefill, layer {layer}", out, want))
    return {"max_abs_err": worst, "S": int(calls[0][0].shape[2]), "base": int(calls[0][4][0]), "slot": slot}


def time_k4_hit(engine, slot, S, launches) -> dict:
    """K4 at a hit's shape: B1 H12, ``S`` suffix queries at base 384 through
    ``slot``'s real table row (24 spliced blocks, then its own) over layer 0
    of the engine's int8 pool; bound, plain version and gather + SDPA."""
    from unionml_tpu_torch.ops.paged_attention import fused_hbm_bytes, paged_attention, reference_paged_attention
    from unionml_tpu_torch.ops.quant import dequantize_blockwise

    H, D = engine._config.num_heads, engine._config.head_dim
    layer = engine._pool["layer_0"]
    kp, vp, ks, vs = layer["k"], layer["v"], layer["k_scale"], layer["v_scale"]
    bs, base = engine.block_size, PC_SYSTEM
    table = engine._tables[slot: slot + 1]
    q = torch.randn((1, H, S, D), device=table.device, dtype=torch.bfloat16,
                    generator=torch.Generator(device=table.device).manual_seed(S))
    pos = torch.tensor([base], dtype=torch.int32, device=table.device)
    err = check_close(f"K4 hit shape S{S}", paged_attention(q, kp, vp, table, pos, ks, vs),
                      reference_paged_attention(q, kp, vp, table, pos, ks, vs))
    cols = (base + S - 1) // bs + 1
    byts = fused_hbm_bytes(cols, bs, H, D, True) + cols * 4 + 2 * q.numel() * 2 + 4
    bound, by = _bound(byts, 4 * H * D * sum(base + s + 1 for s in range(S)))

    def gather_sdpa():
        t = table[:, :cols].long()
        kd = dequantize_blockwise(kp[t], ks[t], torch.bfloat16).transpose(1, 2).reshape(1, H, -1, D)
        vd = dequantize_blockwise(vp[t], vs[t], torch.bfloat16).transpose(1, 2).reshape(1, H, -1, D)
        q_pos = base + torch.arange(S, device=q.device)
        mask = torch.arange(kd.shape[2], device=q.device)[None, :] <= q_pos[:, None]
        return torch.nn.functional.scaled_dot_product_attention(q, kd, vd, attn_mask=mask[None, None])

    def kernel():
        return paged_attention(q, kp, vp, table, pos, ks, vs)

    rec = {
        "name": "paged_attention", "route": "cuda", "source": "unionml_tpu_torch/csrc/paged_attention.cu",
        "replaces": "unionml_tpu/ops/paged_attention.py:92", "launches": launches, "max_abs_err": err,
        "bound_ms": bound, "bound_by": by,
        "shape": f"hit prefill: bf16 int8-pool B1 H{H} S{S} D{D} bs{bs} base {base} over a spliced table row",
        **_times(kernel, lambda: reference_paged_attention(q, kp, vp, table, pos, ks, vs), gather_sdpa),
    }
    # the reading of a ~10 us kernel has differed by 1.7x between processes
    # (PERF.md section 6, PR 9): the first reading (above) is kept apart, and
    # the median of three rounds, each after >= 0.2 s of the same launches
    # with the SM clock read meanwhile, is the figure
    rec["first_ms"], rounds = rec["ms"], []
    for _ in range(K4_HIT_ROUNDS):
        clock = sm_clock_during(kernel)
        t = timed(kernel)
        rounds.append({"ms": t["ms"], "sm_clock_mhz": clock, "recorded_launches": sum(t["recorded_launches"].values())})
    rec["rounds"] = rounds
    rec["ms"] = float(np.median([r["ms"] for r in rounds]))
    # two cross-checks of the reading: the same launches back to back in one
    # CUDA graph (CUDA events, no profiler, no host gap), and the profiler's
    # reading over fresh copies of the layer's leaves and the table row
    rec["graph_ms"] = graph_replay_ms(kernel)
    fresh = [t.clone() for t in (kp, vp, ks, vs, table)]
    rec["fresh_copy_ms"] = timed(lambda: paged_attention(q, fresh[0], fresh[1], fresh[4], pos, fresh[2],
                                                         fresh[3]))["ms"]
    return rec


def graph_replay_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Per-launch ms of ``fn`` captured ``launches`` times back to back in one
    CUDA graph, timed by CUDA events over ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * launches)


def sm_clock_during(fn, seconds: float = 0.2, limit_s: float = 10.0):
    """The SM clock in MHz (``nvidia-smi``) sampled while ``fn`` is launched
    back to back for at least ``seconds`` and until the query returns; None
    where the query fails."""
    probe = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                             stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s and (time.perf_counter() - t0 < seconds or probe.poll() is None):
        fn()
    torch.cuda.synchronize()
    try:
        out, _ = probe.communicate(timeout=limit_s)
        return float(out.strip().splitlines()[0])
    except (subprocess.TimeoutExpired, ValueError, IndexError):
        probe.kill()
        probe.wait()
        return None


# chunks of 64 and no bucket below 64: a hit's suffix prefill is then, row for
# row, the last chunk of the same prompt's miss, and its prefix blocks the
# miss's own (the system prompt is 6 whole chunks), so bf16 streams must agree
# exactly with the cache on and off
PC_EXACT_KW = dict(prefill_chunk=64, prefill_buckets=(64, 128, 256, 512))


def pc_shared_prompt(model, dtype, prompt_list, device, exact_paths=False) -> dict:
    """Part 1: the shared system prompt, cache on against off; at the
    serving configuration, or (``exact_paths``) at ``PC_EXACT_KW``."""
    from unionml_tpu_torch import kernels

    quant = "int8" if dtype == torch.bfloat16 else None
    mode = "identical" if exact_paths or dtype == torch.float32 else "report"
    kw = PC_EXACT_KW if exact_paths else {}
    on, off = pc_engine(model, device, PC_BLOCKS, quant, **kw), pc_engine(model, device, 0, quant, **kw)
    for engine in (on, off):  # warm-up: graphs, cuBLAS handles (tokens of no prompt of the run)
        stream_after(engine, [], [[7] * 20], device)
    kernels.reset_launches()
    before = on.prefill_tokens_computed, off.prefill_tokens_computed
    on_streams, on_ttft, on_wall = stream_after(on, prompt_list[:1], prompt_list[1:], device)
    launches = dict(kernels.launches)
    off_streams, off_ttft, off_wall = stream_after(off, prompt_list[:1], prompt_list[1:], device)
    prefill = {"on": on.prefill_tokens_computed - before[0], "off": off.prefill_tokens_computed - before[1]}
    label = f"{dtype} prefix cache on vs off{' (exact paths)' if exact_paths else ''}"
    splits = pc_compare(label, on_streams, off_streams, off, prompt_list, mode)
    stats = on.prefix_cache.stats()
    if stats["hits"] != PC_REQUESTS - 1 or stats["hit_tokens"] < (PC_REQUESTS - 1) * PC_SYSTEM:
        raise AssertionError(f"{dtype}: expected {PC_REQUESTS - 1} hits of {PC_SYSTEM}+ tokens: {stats}")
    if (device.type == "cuda" and launches["paged_attention"] == 0) or leaked(on) != (0, 0, 0):
        raise AssertionError(f"{dtype}: K4 launches {launches}, leaks {leaked(on)}")
    tokens = sum(map(len, on_streams[1:]))
    rec = {
        "stats": stats, "splits": splits, "launches": launches,
        "prefill_tokens": prefill,
        "ttft_ms": {"hit": [t * 1e3 for t in on_ttft[1:]], "miss": [t * 1e3 for t in off_ttft[1:]],
                    "first_miss": on_ttft[0] * 1e3},
        "tokens_per_s": {"on": tokens / on_wall, "off": sum(map(len, off_streams[1:])) / off_wall},
        "streams": on_streams,
    }
    if dtype == torch.bfloat16 and not exact_paths:
        fresh = pc_prompts(model.config.vocab_size, n=7, seed=1)
        fresh = [prompt_list[0][:PC_SYSTEM] + p[PC_SYSTEM:] for p in fresh]  # new suffixes, the same system prompt
        rec["hit_admission"] = admission_ms(on, fresh[0:2] + fresh[5:6])
        rec["miss_admission"] = admission_ms(off, fresh[2:4] + fresh[6:7])
        check = hit_vs_plain(on, fresh[4])
        rec["hit_vs_plain"] = {k: v for k, v in check.items() if k != "slot"}
        hit_launches = launches["paged_attention"]
        rec["k4_hit"] = [time_k4_hit(on, check["slot"], S, hit_launches) for S in (16, 32, 64)]
        on.cancel(check["slot"])
    return rec, on, off


def pc_multi_turn(model, dtype, prompt_list, device) -> dict:
    """Part 2: follow-ups resend turn 1 and its completion plus 16 new tokens,
    hitting the generated blocks (``prefix_cache_generated``)."""
    quant = "int8" if dtype == torch.bfloat16 else None
    on = pc_engine(model, device, PC_BLOCKS, quant, prefix_cache_generated=True)
    off = pc_engine(model, device, 0, quant)
    turn1 = prompt_list[:PC_FOLLOWUPS]
    completions, _, _ = stream_after(on, turn1[:1], turn1[1:], device)
    rng = np.random.default_rng(7)
    follow = [p + c + rng.integers(0, model.config.vocab_size, PC_NEW).tolist() for p, c in zip(turn1, completions)]
    before = on.prefix_cache.stats()
    got, _, _ = stream_after(on, [], follow, device)
    want, _, _ = stream_after(off, [], follow, device)
    splits = pc_compare(f"{dtype} multi-turn on vs off", got, want, off, follow,
                        "identical" if dtype == torch.float32 else "bf16")
    stats = on.prefix_cache.stats()
    hit_tokens = stats["hit_tokens"] - before["hit_tokens"]
    need = sum(((len(p) + MAX_NEW) // 16) * 16 for p in turn1)
    if stats["hits"] - before["hits"] != PC_FOLLOWUPS or hit_tokens < need - 16 * PC_FOLLOWUPS:
        raise AssertionError(f"{dtype} multi-turn: {stats['hits'] - before['hits']} hits of {hit_tokens} tokens "
                             f"(the turns' full blocks: {need})")
    if leaked(on) != (0, 0, 0):
        raise AssertionError(f"{dtype} multi-turn: leaks {leaked(on)}")
    return {"hits": stats["hits"] - before["hits"], "hit_tokens": hit_tokens, "turn_blocks_tokens": need,
            "splits": splits, "adopted_blocks": stats["adopted_blocks"]}


def pc_preempt(engine, prompt_list, mode) -> dict:
    """Part 3: preempt 2 running slots after 8 tokens and re-admit their
    transcripts; the joined streams against the same requests uninterrupted."""
    requests = [(p, MAX_NEW) for p in prompt_list[1:9]]
    want = drive(engine, requests)
    streams, owner = [[] for _ in requests], {}

    def pump(events):
        for ev in events:
            if ev.emit:
                streams[owner[ev.slot]].append(ev.token)

    slots = engine.admit_many(requests)
    owner.update(zip(slots, range(len(requests))))
    victims = (2, 5)
    while min(len(streams[v]) for v in victims) < 8:
        pump(engine.step())
    resumed = []
    for v in victims:
        state = engine.preempt(slots[v])
        if state is None:
            raise AssertionError(f"request {v}: preempt declined")
        pump(engine.take_pending_events())
        resumed.append((v, state))
    before = engine.prefill_tokens_computed
    paid = []
    for v, state in resumed:
        n0 = engine.prefill_tokens_computed
        (slot,) = engine.admit_many([(state.tokens, MAX_NEW - len(streams[v]))])
        pump(engine.take_pending_events())
        owner[slot] = v
        engine.release_preempted(state)
        paid.append(engine.prefill_tokens_computed - n0)
        if paid[-1] > engine.block_size:
            raise AssertionError(f"request {v}: the resume prefilled {paid[-1]} tokens of {len(state.tokens)}")
    while engine.num_active or engine.has_pending_prefill or engine.has_pending_events:
        pump(engine.step())
    splits = pc_compare(f"{engine._config.dtype} preempt/resume vs uninterrupted", streams, want, engine,
                        [p for p, _ in requests], mode)
    if leaked(engine) != (0, 0, 0):
        raise AssertionError(f"preempt/resume: leaks {leaked(engine)}")
    return {"resume_prefill_tokens": paid, "transcripts": [len(s.tokens) for _, s in resumed],
            "pinned_blocks": [len(s.path) for _, s in resumed], "splits": splits,
            "all_prefill_tokens": engine.prefill_tokens_computed - before}


class _Sink:
    cancelled = False
    engine = None

    def __init__(self, hook=None):
        self.tokens, self.error, self.hook = [], None, hook
        self.before_fault = 0  # tokens delivered before the engine's first failure

    def emit(self, token):
        self.tokens.append(token)
        self.before_fault += self.engine.failure_count == 0
        if self.hook is not None:
            self.hook(len(self.tokens))

    def finish(self):
        pass

    def fail(self, exc):
        self.error = exc


def recovery_run(model, device, greedy, sampled, quant, faults=None):
    """6 greedy streams decode; when the first has 8 tokens, 2 sampled
    requests (temperature 0.8) arrive for the 2 free slots. The batcher's
    worker loop runs on this thread, so the schedule is fixed. Returns
    (results, engine, supervisor, the dispatch count when the sampled arrived,
    the tokens each sampled stream delivered before the first failure)."""
    from unionml_tpu_torch.serving import ContinuousBatcher, EngineSupervisor, FaultPlan

    plan = FaultPlan(**(faults or {}))
    engine = pc_engine(model, device, PC_BLOCKS, quant, faults=plan)
    sup = EngineSupervisor(watchdog_interval_s=0, backoff_s=0.005)
    batcher = ContinuousBatcher(engine, supervisor=sup, device=device)
    arrived = []

    def arrive(n):
        if n == 8 and not arrived:
            arrived.append(plan._dispatches)
            for sink in sinks[len(greedy):]:
                batcher.scheduler.submit(batcher.scheduler.make_ticket(
                    np.asarray(sink.prompt, dtype=np.int32), MAX_NEW, {"temperature": 0.8}, sink))

    sinks = [_Sink(arrive if i == 0 else None) for i in range(len(greedy))] + [_Sink() for _ in sampled]
    for sink, prompt in zip(sinks, greedy + sampled):
        sink.prompt, sink.engine = prompt, engine
    for sink in sinks[: len(greedy)]:
        batcher.scheduler.submit(batcher.scheduler.make_ticket(np.asarray(sink.prompt, dtype=np.int32), MAX_NEW, {},
                                                               sink))
    batcher._closed = True
    batcher._run()
    sup.close()
    results = [s.error if s.error is not None else s.tokens for s in sinks]
    return results, engine, sup, arrived[0], [s.before_fault for s in sinks[len(greedy):]]


def pc_recovery(model, device, vocab, quant, mode, nan: bool) -> dict:
    """Part 4: a dispatch fault in steady decode under a supervisor, then
    (``nan``) a NaN fault on one slot."""
    from unionml_tpu_torch.serving import EngineFailure

    greedy = spec_prompts(vocab)[:6]
    sampled = spec_prompts(vocab, seed=1)[:2]
    clean, clean_engine, _, arrived, _ = recovery_run(model, device, greedy, sampled, quant)
    # dispatch arrived + 1 is the sampled requests' first burst, and each
    # later one delivers one more token of theirs: the fault at arrived + 2 + k
    # loses burst arrived + 1 + k in flight after k tokens were delivered. With
    # a full-precision pool k = 8: their resume re-prefills prompt and tokens
    # and the generator goes back to the lost burst's state. With an int8
    # pool k = 0, since re-prefilled int8 blocks round otherwise than appended
    # ones and a sampled token at a near tie could then move
    delivered = 0 if quant else RECOVERY_SAMPLED_TOKENS
    fault = arrived + 2 + delivered
    got, engine, sup, _, before = recovery_run(model, device, greedy, sampled, quant,
                                               faults=dict(step_dispatch_failures=(fault,)))
    if any(not isinstance(r, list) or len(r) != MAX_NEW for r in got):
        raise AssertionError(f"recovery: a request did not complete: {[type(r).__name__ for r in got]}")
    if before != [delivered] * len(sampled):
        raise AssertionError(f"recovery: the sampled streams delivered {before} tokens before the fault, "
                             f"expected {delivered} each")
    splits = pc_compare(f"{model.config.dtype} recovery greedy vs fault-free", got[:6], clean[:6], clean_engine,
                        greedy, mode)
    if got[6:] != clean[6:]:
        raise AssertionError("recovery: sampled streams differ from the fault-free run")
    if sup.state != "ok" or engine.failure_count != 1 or leaked(engine) != (0, 0, 0):
        raise AssertionError(f"recovery: {sup.stats()}, failures {engine.failure_count}, leaks {leaked(engine)}")
    recapture_ms = sum(g.capture_ms for g in engine._step_fns.values())
    out = {"fault_dispatch": fault, "sampled_tokens_before_fault": before, "splits": splits,
           "supervisor": sup.stats(),
           "robustness": engine.robustness_stats(), "rebuild_ms": engine.last_rebuild_ms,
           "recapture_ms": recapture_ms, "graphs_recaptured": len(engine._step_fns)}
    del engine
    if not nan:
        return out
    nan_slot = 3
    got, engine, _, _, _ = recovery_run(model, device, greedy, sampled, quant,
                                        faults=dict(nan_logits=((arrived + 2, nan_slot),)))
    if not (isinstance(got[nan_slot], EngineFailure) and got[nan_slot].reason == "nan_logits"):
        raise AssertionError(f"NaN fault: request {nan_slot} ended {got[nan_slot]!r}")
    siblings = [i for i in range(len(got)) if i != nan_slot]
    if [got[i] for i in siblings] != [clean[i] for i in siblings]:
        raise AssertionError("NaN fault: a sibling's stream differs from the run without it")
    out["nan"] = {"slot": nan_slot, "quarantined": engine.quarantined_requests, "siblings_bitwise": len(siblings)}
    return out


def pc_speculation(model, prompt_list, device) -> dict:
    """Part 5: self-draft speculation with the cache on over part 1's shared
    prompt; streams against a vanilla engine's with the same cache history,
    under the gate."""
    from unionml_tpu_torch.serving.speculative import SpeculativeEngine

    engine = SpeculativeEngine(model, model, gamma_max=SPEC_GAMMA_MAX, device=device, kv_quantize="int8",
                               prefix_cache_blocks=PC_BLOCKS, **PC_ENGINE_KW)
    vanilla = pc_engine(model, device, PC_BLOCKS, "int8")
    rest = prompt_list[1:9]
    for eng in (engine, vanilla):  # the system prompt's blocks (a chunked miss: decodes vanilla)
        drive(eng, [(prompt_list[0], MAX_NEW, {})])
    want = drive(vanilla, [(p, MAX_NEW, {}) for p in rest])
    got = drive(engine, [(p, MAX_NEW, {"speculative": True}) for p in rest])
    splits = gated_splits("speculation over the cache vs vanilla", got, want, vanilla, rest, GAP_LIMIT_BF16)
    stats = engine.speculation_stats()
    if engine.prefix_cache.stats()["hits"] < len(rest) or stats["accepted"] == 0 or leaked(engine) != (0, 0, 0):
        raise AssertionError(f"speculation over the cache: {engine.prefix_cache.stats()}, {stats}, {leaked(engine)}")
    return {"splits": splits, "stats": stats, "hits": engine.prefix_cache.stats()["hits"],
            "draft_prefills": engine.draft_prefill_dispatches}


def prefix_cache_phase(device, config=None) -> dict:
    """Prefix cache, preemption and recovery (phase 13, see the module docstring)."""
    from unionml_tpu_torch.models import GPTConfig, init_gpt, random_params

    config = config or GPTConfig()  # GPT-2 small
    params = random_params(config, seed=0)
    prompt_list = pc_prompts(config.vocab_size)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        quant, mode = ("int8", "bf16") if bf16 else (None, "identical")
        model = init_gpt(dataclasses.replace(config, dtype=dtype), params=params, device=device)
        r = out[str(dtype)] = {}
        r["shared"], on, off = pc_shared_prompt(model, dtype, prompt_list, device)
        del off
        if bf16:
            r["shared_exact"], exact_on, exact_off = pc_shared_prompt(model, dtype, prompt_list, device,
                                                                      exact_paths=True)
            del exact_on, exact_off
        torch.cuda.empty_cache()
        r["multi_turn"] = pc_multi_turn(model, dtype, prompt_list, device)
        torch.cuda.empty_cache()
        r["preempt"] = pc_preempt(on, prompt_list, mode)
        if bf16:
            # zero host-to-device copies in steady decode with the cache on
            on.admit_many([(p, 400) for p in prompt_list[1:9]])
            for _ in range(3):
                on.step()
            r["memcpy_htod_5_bursts"] = htod = count_htod(on.step, 5)
            if htod:
                raise AssertionError(f"5 steady bursts with the cache on made {htod} host-to-device copies")
            on.abort_all()
        del on
        torch.cuda.empty_cache()
        if bf16:
            r["speculation"] = pc_speculation(model, prompt_list, device)
            torch.cuda.empty_cache()
        r["recovery"] = pc_recovery(model, device, config.vocab_size, quant, mode, nan=bf16)
        del model
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- phase 14: SLO scheduling

# bench_serving.py::bench_slo_mix at this width: its 24 batch requests over 4
# slots become 48 over 8 (6x the slots), with its prompts, budgets, deadline
# and arrival times
SLO_BATCH, SLO_INTER, SLO_BATCH_NEW, SLO_INTER_NEW = 48, 8, 48, 8
SLO_F32_BATCH = 24  # the f32 pair's flood, cut to 24 for time (PERF.md section 4)
SLO_DEADLINE_MS = 30_000.0
SLO_LOOKAHEAD = 8  # contended bursts run min(8, 4) = 4 steps
HOG_NEW = 400


def slo_prompts(vocab: int, n_batch: int = SLO_BATCH, seed: int = 0):
    rng = np.random.default_rng(400 + seed)
    return ([rng.integers(1, vocab, 6).tolist() for _ in range(n_batch)],
            [rng.integers(1, vocab, 6).tolist() for _ in range(SLO_INTER)])


def slo_warm(engine):
    """Capture every decode burst the mix can replay (lookahead 8 cut to 4,
    2 and 1 by the slots' headroom, and 4 under contention) and take the
    preempt-to-prefix-cache ladder once, so TTFT measures scheduling, not
    graph captures (``bench_serving.py:1066-1090`` warms its programs)."""
    rng = np.random.default_rng(7)
    for budget in (8, 4, 2, 1):  # a burst's graph does not depend on how many slots are active
        engine.admit_many([(rng.integers(1, engine._config.vocab_size, 6).tolist(), budget)])
        while engine.num_active or engine.has_pending_events:
            engine.step(SLO_LOOKAHEAD)
    (slot,) = engine.admit_many([(rng.integers(1, engine._config.vocab_size, 6).tolist(), SLO_BATCH_NEW)])
    for _ in range(3):
        engine.step(4)
    state = engine.preempt(slot)
    engine.take_pending_events()
    engine.admit_many([(state.tokens, SLO_BATCH_NEW - (len(state.tokens) - 6))])
    engine.release_preempted(state)
    while engine.num_active or engine.has_pending_events:
        engine.step(4)


def slo_pct(xs, qs=(0.5, 0.95, 0.99)) -> dict:
    """``bench_slo_mix``'s percentiles: the sorted sample at index len * q."""
    xs = sorted(xs)
    return {f"p{round(q * 100)}_ms": xs[min(int(len(xs) * q), len(xs) - 1)] for q in qs} if xs else None


def slo_arm(model, device, quant, fifo: bool, batch_prompts, inter_prompts) -> dict:
    """One arm of the SLO mix: the batch flood queued first, the interactive
    requests 50 ms later, 10 ms apart, every request streamed through a
    supervised ``ContinuousBatcher``; the scheduler (preemption on) or FIFO."""
    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.serving import ContinuousBatcher, EngineSupervisor, SchedulerConfig, SchedulingError

    engine = pc_engine(model, device, PC_BLOCKS, quant)
    slo_warm(engine)
    sup = EngineSupervisor()
    batcher = ContinuousBatcher(engine, lookahead=SLO_LOOKAHEAD, supervisor=sup, device=device,
                                scheduler=SchedulerConfig(fifo=fifo, preempt=not fifo, max_queue=4096))
    preempted = {}  # prompt -> tokens it had delivered when it was first preempted
    requeue = batcher.scheduler.requeue

    def noting_requeue(ticket, *, preemption=True):
        if preemption:  # the ticket's prompt is the transcript by now
            preempted.setdefault(tuple(int(t) for t in ticket.prompt[:6]), len(ticket.prompt) - 6)
        requeue(ticket, preemption=preemption)

    batcher.scheduler.requeue = noting_requeue
    ttft, itl = {"interactive": [], "batch": []}, {"interactive": [], "batch": []}
    streams = {"interactive": [None] * len(inter_prompts), "batch": [None] * len(batch_prompts)}
    outcomes = {"completed": 0, "shed": 0, "deadline_missed": 0}

    async def one(cls, i, prompt, n, deadline_ms):
        loop = asyncio.get_running_loop()
        t0, last, out = loop.time(), None, []
        try:
            async for token in batcher.stream(prompt, n, priority=cls, deadline_ms=deadline_ms):
                now = loop.time()
                if last is None:
                    ttft[cls].append((now - t0) * 1e3)
                else:
                    itl[cls].append((now - last) * 1e3)
                last = now
                out.append(token)
            outcomes["completed"] += 1
            streams[cls][i] = out
        except SchedulingError as exc:
            outcomes["deadline_missed" if exc.reason == "deadline_exceeded" else "shed"] += 1

    async def drive():
        t0 = time.perf_counter()
        tasks = [asyncio.ensure_future(one("batch", i, p, SLO_BATCH_NEW, None)) for i, p in enumerate(batch_prompts)]
        await asyncio.sleep(0.05)  # the flood owns the queue first
        for i, p in enumerate(inter_prompts):
            tasks.append(asyncio.ensure_future(one("interactive", i, p, SLO_INTER_NEW, SLO_DEADLINE_MS)))
            await asyncio.sleep(0.01)
        await asyncio.gather(*tasks)
        return time.perf_counter() - t0

    kernels.reset_launches()
    total_s = asyncio.run(drive())
    launches = dict(kernels.launches)
    stats = batcher.scheduler.stats()
    batcher.close()
    label = f"SLO mix {model.config.dtype} {'FIFO' if fifo else 'scheduler'}"
    if outcomes != {"completed": len(batch_prompts) + len(inter_prompts), "shed": 0, "deadline_missed": 0}:
        raise AssertionError(f"{label}: outcomes {outcomes}")
    sheds = stats["shed_queue_full"] + stats["shed_deadline_infeasible"]
    misses = stats["deadline_misses_queued"] + stats["deadline_misses_running"]
    if sheds or misses or leaked(engine) != (0, 0, 0):
        raise AssertionError(f"{label}: sheds {sheds}, deadline misses {misses}, leaks {leaked(engine)}")
    if not fifo and not (stats["preemptions"] >= 1 and stats["resumes"] == stats["preemptions"]):
        raise AssertionError(f"{label}: preemptions {stats['preemptions']}, resumes {stats['resumes']}")
    if device.type == "cuda" and (launches["flash_fwd"] == 0 or launches["paged_attention"] == 0):
        raise AssertionError(f"{label}: launches {launches}")
    return {"engine": engine, "streams": streams, "total_s": total_s, "launches": launches, "preempted": preempted,
            "ttft": {c: slo_pct(v) for c, v in ttft.items()}, "itl": {c: slo_pct(v, (0.5, 0.95)) for c, v in itl.items()},
            "preemptions": stats["preemptions"], "resumes": stats["resumes"], "sheds": sheds,
            "deadline_misses": misses, "queue_wait_ema_ms": stats["queue_wait_ema_ms"],
            "queue_wait_ema_ms_by_class": stats["per_class"], "preempted_requests": engine.preempted_requests,
            "pinned_blocks": engine.prefix_cache.pinned_blocks}


def slo_mix(model, device, quant, n_batch: int) -> dict:
    """Part 1: the scheduler arm against the FIFO arm on freshly warmed
    engines. Without ``quant`` (f32 pool) every stream is identical across
    the arms. With the int8 pool every stream that was never preempted is
    identical, and a preempted one up to its preemption; after its resume
    (the transcript's tail re-prefilled and re-quantized) its splits are
    printed with the FIFO engine's top-2 gap there, not gated: the f32 pair
    holds the same schedule identical (PERF.md section 6, PR 10)."""
    batch_prompts, inter_prompts = slo_prompts(model.config.vocab_size, n_batch)
    sched = slo_arm(model, device, quant, False, batch_prompts, inter_prompts)
    fifo = slo_arm(model, device, quant, True, batch_prompts, inter_prompts)
    label = f"SLO mix {model.config.dtype}"
    splits = {}
    for cls, prompt_list, budget in (("batch", batch_prompts, SLO_BATCH_NEW), ("interactive", inter_prompts,
                                                                                 SLO_INTER_NEW)):
        got, want = sched["streams"][cls], fifo["streams"][cls]
        if quant:
            splits[cls] = gated_splits(f"{label} {cls} scheduler vs FIFO", got, want, fifo["engine"], prompt_list,
                                       float("inf"), budget)
            for sp in splits[cls]:
                sp["preempted_after"] = sched["preempted"].get(tuple(prompt_list[sp["request"]]))
                if sp["preempted_after"] is None or sp["split"] < sp["preempted_after"]:
                    raise AssertionError(f"{label} {cls}: stream {sp['request']} splits from FIFO's at token "
                                         f"{sp['split']} before any preemption of it")
        elif got != want:
            raise AssertionError(f"{label} {cls}: streams differ between the arms")
    s95, f95 = sched["ttft"]["interactive"]["p95_ms"], fifo["ttft"]["interactive"]["p95_ms"]
    if not s95 < f95:
        raise AssertionError(f"{label}: interactive p95 TTFT {s95:.1f} ms under the scheduler, {f95:.1f} under FIFO")
    sched["preempted"] = len(sched["preempted"])
    for arm in (sched, fifo):
        del arm["engine"], arm["streams"]
    fifo.pop("preempted")
    return {"scheduler": sched, "fifo": fifo, "splits": splits, "n_batch": n_batch,
            "interactive_p95_ttft_fifo_over_scheduler": f95 / s95}


def slo_contract(model, device) -> dict:
    """Part 2: the route's status contract through its plain functions
    (``parse_generate_payload``, ``error_for``), with the batcher's own worker:
    8 batch hogs of 400 new tokens hold every slot of a bound-2 queue."""
    import random

    from unionml_tpu_torch.serving import ContinuousBatcher, EngineSupervisor, SchedulerConfig
    from unionml_tpu_torch.serving.app import PayloadError, error_for, parse_generate_payload

    engine = pc_engine(model, device, PC_BLOCKS, "int8")
    batcher = ContinuousBatcher(engine, lookahead=SLO_LOOKAHEAD, supervisor=EngineSupervisor(), device=device,
                                scheduler=SchedulerConfig(max_queue=2))
    sched, rng, vocab = batcher.scheduler, random.Random(0), model.config.vocab_size
    prompt = np.random.default_rng(9).integers(1, vocab, 6).tolist()
    out = {}

    def envelope(exc):
        status, body, headers = error_for(exc, request_id="chip", rng=rng)
        return {"status": status, **body["error"], "retry_after_header": headers.get("Retry-After")}

    async def until(predicate):
        for _ in range(4000):
            if predicate():
                return
            await asyncio.sleep(0.005)
        raise AssertionError("phase 14 contract: a state was never reached")

    def pin_wait_ema(value):
        """Pin the observed queue waits the infeasibility shed reads."""
        with sched._lock:
            sched.queue_wait_ema_ms = value
            sched.queue_wait_ema_ms_by_class = {k: value for k in sched.queue_wait_ema_ms_by_class}

    async def outcome(coro):
        try:
            return await coro
        except Exception as exc:  # mapped as the route maps it
            return envelope(exc)

    async def drive():
        hogs = []
        for _ in range(engine.num_slots):  # one at a time: the queue holds 2
            hogs.append(asyncio.ensure_future(batcher.generate(prompt, HOG_NEW, priority="batch")))
            await until(lambda: sched.depth == 0 and engine.num_active == len(hogs))
        # queued behind the hogs (same class: no preemption) past its deadline;
        # with no queue wait observed yet, so that it is not shed at submit
        pin_wait_ema(None)
        out["queued_deadline"] = await outcome(batcher.generate(prompt, 8, priority="batch", deadline_ms=20))
        fillers = [asyncio.ensure_future(outcome(batcher.generate(prompt, 8, priority="batch"))) for _ in range(2)]
        await until(lambda: sched.depth == 2)
        out["queue_full"] = await outcome(batcher.generate(prompt, 8, priority="batch"))
        stream = batcher.stream(prompt, 8, priority="batch")
        out["queue_full_stream"] = await outcome(stream.__anext__())
        # an interactive submit displaces the worst queued batch ticket, then preempts a hog
        inter = asyncio.ensure_future(outcome(batcher.generate(prompt, 8, priority="interactive")))
        out["interactive"] = await inter
        out["fillers"] = await asyncio.gather(*fillers)
        # admitted at once (it preempts a hog), then cancelled mid-decode at its deadline
        out["running_deadline"] = await outcome(batcher.generate(prompt, HOG_NEW, priority="interactive",
                                                                deadline_ms=500))
        pin_wait_ema(60_000.0)  # observed queueing of a minute: the deadline is infeasible at submit
        out["infeasible"] = await outcome(batcher.generate(prompt, 8, deadline_ms=1000))
        pin_wait_ema(None)
        out["hogs"] = await asyncio.gather(*(outcome(h) for h in hogs))
        # one request streamed, then the same request whole
        out["streamed"] = [t async for t in batcher.stream(prompt, 16, priority="interactive")]
        out["whole"] = await batcher.generate(prompt, 16, priority="interactive")

    t0 = time.perf_counter()
    asyncio.run(drive())
    stats = sched.stats()
    batcher.close()
    fail = []
    if out["queued_deadline"]["status"] != 504 or out["queued_deadline"]["reason"] != "deadline_exceeded":
        fail.append("queued deadline")
    qf = out["queue_full"]
    if qf["status"] != 429 or qf["reason"] != "queue_full" or not 750 <= qf["retry_after_ms"] <= 1250:
        fail.append("queue full")
    if out["queue_full_stream"]["status"] != 429:
        fail.append("a stream's shed at its first anext")
    if not isinstance(out["interactive"], list) or len(out["interactive"]) != 8:
        fail.append("interactive")
    if sorted(isinstance(f, list) for f in out["fillers"]) != [False, True] or not any(
            isinstance(f, dict) and f["status"] == 429 for f in out["fillers"]):
        fail.append("displacement")
    if out["running_deadline"]["status"] != 504 or stats["deadline_misses_running"] != 1:
        fail.append("running deadline")
    if out["infeasible"]["status"] != 503 or out["infeasible"]["reason"] != "deadline_infeasible":
        fail.append("infeasible deadline")
    if any(not isinstance(h, list) or len(h) != HOG_NEW for h in out["hogs"]):
        fail.append("hogs")
    if out["streamed"] != out["whole"] or leaked(engine) != (0, 0, 0):
        fail.append(f"stream vs whole / leaks {leaked(engine)}")
    bad = []
    for payload in ({}, {"prompt_ids": [1, 2], "max_new_tokens": 0}, {"prompt_ids": []},
                    {"prompt_ids": [1] * 1024}, {"prompt_ids": [1, 2], "priority": "urgent"},
                    {"prompt_ids": [1, 2], "deadline_ms": -5}, {"prompt_ids": [1, 2], "top_p": 0},
                    {"prompts": [[1, 2]], "stream": True}):
        try:
            parse_generate_payload(payload, batcher)
            bad.append("accepted")
        except PayloadError as exc:
            bad.append(envelope(exc)["status"] if exc.reason == "invalid_request" else exc.reason)
    if bad != [400] * len(bad):
        fail.append(f"invalid payloads {bad}")
    if fail:
        raise AssertionError(f"phase 14 contract: {fail}; {out}")
    return {"queue_full": qf, "queued_deadline": out["queued_deadline"]["status"],
            "running_deadline": out["running_deadline"]["status"], "infeasible": out["infeasible"]["status"],
            "displaced": [f["status"] for f in out["fillers"] if isinstance(f, dict)], "invalid": bad,
            "scheduler": {k: v for k, v in stats.items() if k != "pool"}, "s": time.perf_counter() - t0}


def slo_speculation(model, device) -> dict:
    """Part 3: the self-draft speculative engine behind the batcher with the
    default ``speculative_classes``: 4 interactive requests alone run
    speculative rounds, 4 batch requests alone run none; both groups' streams
    equal the vanilla engine's under the bf16 rule."""
    from unionml_tpu_torch.serving import ContinuousBatcher

    engine = spec_engine(model, model, device)
    vanilla = vanilla_engine(model, device)
    prompt_list = spec_prompts(model.config.vocab_size)[:8]
    batcher = ContinuousBatcher(engine, device=device)
    rounds, splits = [], {}

    async def group(cls, prompts_):
        return await asyncio.gather(*(batcher.generate(p, MAX_NEW, priority=cls) for p in prompts_))

    try:
        for cls, prompts_ in (("interactive", prompt_list[:4]), ("batch", prompt_list[4:])):
            before = engine.speculation_stats()["rounds"]
            got = asyncio.run(group(cls, prompts_))
            rounds.append(engine.speculation_stats()["rounds"] - before)
            want = drive(vanilla, [(p, MAX_NEW, {}) for p in prompts_])
            splits[cls] = gated_splits(f"speculation by class ({cls}) vs vanilla", got, want, vanilla, prompts_,
                                       GAP_LIMIT_BF16)
    finally:
        batcher.close()
    if not (rounds[0] > 0 and rounds[1] == 0):
        raise AssertionError(f"speculation by class: rounds interactive {rounds[0]}, batch {rounds[1]}")
    return {"rounds": {"interactive": rounds[0], "batch": rounds[1]}, "splits": splits,
            "stats": engine.speculation_stats()}


def slo_htod(model, device) -> int:
    """Part 4: ``Memcpy HtoD`` over 5 steady bursts of the batcher's loop
    with the scheduler in place (its admission, deadline and preemption
    checks run each time)."""
    from unionml_tpu_torch.serving import ContinuousBatcher

    engine = pc_engine(model, device, PC_BLOCKS, "int8")
    batcher = ContinuousBatcher(engine, lookahead=SLO_LOOKAHEAD, device=device)
    rng = np.random.default_rng(11)
    for _ in range(engine.num_slots):
        sink = _Sink()
        sink.engine = engine
        batcher.scheduler.submit(batcher.scheduler.make_ticket(
            rng.integers(1, engine._config.vocab_size, 6), HOG_NEW, {}, sink, priority="batch", deadline_ms=600_000))

    def turn():
        batcher._admit()
        batcher._dispatch(engine.step(SLO_LOOKAHEAD))

    for _ in range(3):
        turn()
    htod = count_htod(turn, 5)
    engine.abort_all()
    if htod:
        raise AssertionError(f"5 steady bursts with the scheduler in place made {htod} host-to-device copies")
    return htod


def slo_phase(device, config=None) -> dict:
    """SLO scheduling (phase 14, see the module docstring)."""
    from unionml_tpu_torch.models import GPTConfig, init_gpt, random_params

    t0 = time.perf_counter()
    config = config or GPTConfig()  # GPT-2 small
    params = random_params(config, seed=0)
    out, parts = {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(*args)
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t

    model = init_gpt(dataclasses.replace(config, dtype=torch.bfloat16), params=params, device=device)
    part("mix_bf16", slo_mix, model, device, "int8", SLO_BATCH)
    part("contract", slo_contract, model, device)
    part("speculation", slo_speculation, model, device)
    part("memcpy_htod_5_bursts", slo_htod, model, device)
    del model
    model = init_gpt(dataclasses.replace(config, dtype=torch.float32), params=params, device=device)
    part("mix_f32", slo_mix, model, device, None, SLO_F32_BATCH)
    del model
    torch.cuda.empty_cache()
    out["parts_s"], out["s"] = parts, time.perf_counter() - t0
    return out


# ------------------------------------------------------------ telemetry

TEL_SYSTEM, TEL_BATCH, TEL_BATCH_NEW, TEL_INTER_NEW = 128, 8, 64, 8
TEL_NAN = (30, 1)  # (dispatch, slot): a batch request decoding, not the preemption's victim (slot 7)
TEL_BURSTS = 60  # replayed bursts per wall timing


def tel_shorts(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(n)).tolist() for n in rng.integers(20, 200, 8)]


def tel_arm(model, device, telemetry, schedule) -> dict:
    """Part 1's arm: a freshly warmed engine (its decode graph captured on 8
    short requests, then aborted) runs the fixed ``schedule`` through
    ``drive`` (a miss alone, then hits and bucket misses); streams, K1/K4
    launches and the bursts dispatched (each one fetched by the end)."""
    from unionml_tpu_torch import kernels

    engine = pc_engine(model, device, PC_BLOCKS, "int8", telemetry=telemetry)
    steady(engine, tel_shorts(model.config.vocab_size, 1), {})
    engine.abort_all()
    dispatches, fetched = engine.step_dispatches, (telemetry.decode_fetch_ms._snapshot()["count"]
                                                   if telemetry is not None else 0)
    kernels.reset_launches()
    streams = [s for part in schedule for s in drive(engine, [(p, MAX_NEW, {}) for p in part])]
    launches = {k: kernels.launches[k] for k in ("flash_fwd", "paged_attention")}
    return {"engine": engine, "streams": streams, "launches": launches,
            "bursts": engine.step_dispatches - dispatches,
            "fetch_observed": (telemetry.decode_fetch_ms._snapshot()["count"] - fetched
                               if telemetry is not None else None)}


def tel_burst_ms(engine, bursts: int = TEL_BURSTS) -> float:
    """Wall ms per replayed decode burst (pipelined ``step``), synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(bursts):
        engine.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / bursts


def tel_traces(model, device) -> dict:
    """Part 3: traces through ``ContinuousBatcher`` with the SLO scheduler and
    a supervisor. 8 batch requests sharing a 128-token system prompt fill the
    8 slots at once (the first misses, the 7 others hit its blocks in the
    same admission); when the first has 8 tokens an interactive request
    arrives and preempts one; a NaN fault quarantines another. The worker
    loop runs on this thread, so the schedule is fixed."""
    from unionml_tpu_torch.serving import ContinuousBatcher, EngineSupervisor, FaultPlan, SchedulerConfig, Telemetry
    from unionml_tpu_torch.serving.app import metrics_answer

    vocab = model.config.vocab_size
    rng = np.random.default_rng(1500)
    system = rng.integers(1, vocab, TEL_SYSTEM).tolist()
    batch = [system + rng.integers(1, vocab, int(n)).tolist() for n in rng.integers(8, 41, TEL_BATCH)]
    inter = rng.integers(1, vocab, 6).tolist()
    tel = Telemetry()
    engine = pc_engine(model, device, PC_BLOCKS, "int8", faults=FaultPlan(nan_logits=(TEL_NAN,)))
    sup = EngineSupervisor(watchdog_interval_s=0)
    batcher = ContinuousBatcher(engine, scheduler=SchedulerConfig(aging_s=0), supervisor=sup, telemetry=tel,
                                device=device)
    batcher._worker = types.SimpleNamespace(is_alive=lambda: True)  # no thread: this one runs the loop

    def submit(prompt, budget, sink, priority):
        batcher._closed = False
        try:
            batcher._submit(prompt, budget, sink, {}, priority=priority)
        finally:
            batcher._closed = True

    def arrive(n):
        if n == 8:
            submit(inter, TEL_INTER_NEW, sinks[-1], "interactive")

    sinks = [_Sink(arrive if i == 0 else None) for i in range(TEL_BATCH)] + [_Sink()]
    for sink in sinks:
        sink.engine = engine
    for prompt, sink in zip(batch, sinks):
        submit(prompt, TEL_BATCH_NEW, sink, "batch")
    batcher._run()
    sup.close()
    tel.assert_balanced()
    traces = tel.recent(1000)
    if len(traces) != len(sinks):
        raise AssertionError(f"{len(traces)} traces completed for {len(sinks)} requests")
    preempted, quarantined = [], []
    for tr in traces:
        kinds = [sp["kind"] for sp in tr["spans"]]
        if kinds[0] != "admission" or kinds[-1] != "end" or kinds.count("end") != 1:
            raise AssertionError(f"trace {tr['request_id']}: spans {kinds}")
        if tr["status"] == "ok":
            first = min(kinds.index(k) for k in ("prefill", "prefix_hit", "prefill_chunk") if k in kinds)
            if not kinds.index("queue_wait") < first < kinds.index("decode"):
                raise AssertionError(f"trace {tr['request_id']}: out of order {kinds}")
        if "preempted" in kinds:
            resumed = [sp for sp in tr["spans"][kinds.index("preempted"):] if sp["kind"] == "queue_wait"]
            if tr["status"] != "ok" or not resumed or not resumed[0]["attrs"]["resume"]:
                raise AssertionError(f"preempted trace {tr['request_id']}: status {tr['status']}, spans {kinds}")
            preempted.append(tr)
        if tr["status"] == "error":
            if tr.get("reason") != "nan_logits" or "quarantine" not in kinds:
                raise AssertionError(f"failed trace {tr['request_id']}: {tr.get('reason')}, spans {kinds}")
            quarantined.append(tr)
    if len(preempted) != 1 or len(quarantined) != 1:
        raise AssertionError(f"{len(preempted)} preempted and {len(quarantined)} quarantined traces (1 each expected)")
    sched, cache = batcher.scheduler.stats(), engine.prefix_cache.stats()
    counters = {
        "tokens_out": (tel.tokens_out_total.value(), sum(len(sk.tokens) for sk in sinks)),
        "prefix_hit_tokens": (tel.prefix_hit_tokens_total.value(), cache["hit_tokens"]),
        "preemptions": (tel.preemptions_total.value(), sched["preemptions"]),
        "resumes": (tel.resumes_total.value(), sched["resumes"]),
        "quarantines": (tel.quarantines_total.value(), engine.quarantined_requests),
    }
    for name, (mirror, own) in counters.items():
        if mirror != own:
            raise AssertionError(f"telemetry {name} {mirror} != the engine's own {own}")
    if cache["hits"] < TEL_BATCH - 1 or sched["preemptions"] != 1:
        raise AssertionError(f"hits {cache['hits']}, preemptions {sched['preemptions']}")
    status, text, headers = metrics_answer(tel)
    families = ["unionml_requests_total", "unionml_ttft_ms", "unionml_decode_fetch_ms_bucket",
                "unionml_slo_attainment", 'unionml_kv_pool_bytes{kv_dtype="int8"}']
    missing = [f for f in families if f not in text]
    if status != 200 or missing:
        raise AssertionError(f"/metrics answered {status}, missing {missing}")
    if leaked(engine) != (0, 0, 0):
        raise AssertionError(f"blocks left pinned or owned: {leaked(engine)}")
    return {"traces": len(traces), "statuses": sorted(tr["status"] for tr in traces),
            "preempted_spans": [sp["kind"] for sp in preempted[0]["spans"]],
            "quarantined_spans": [sp["kind"] for sp in quarantined[0]["spans"]],
            "counters": {k: v[0] for k, v in counters.items()}, "hits": cache["hits"],
            "metrics_bytes": len(text), "content_type": headers["Content-Type"]}


def telemetry_phase(device, config=None) -> dict:
    """Telemetry (phase 15, see the module docstring)."""
    from unionml_tpu_torch.models import GPTConfig, init_gpt, random_params
    from unionml_tpu_torch.serving import Telemetry

    t0 = time.perf_counter()
    config = config or GPTConfig()  # GPT-2 small
    model = init_gpt(dataclasses.replace(config, dtype=torch.bfloat16), params=random_params(config, seed=0),
                     device=device)
    shared = pc_prompts(config.vocab_size, n=8, seed=15)
    schedule = [shared[:1], shared[1:] + tel_shorts(config.vocab_size, 2)[:4]]
    tel = Telemetry()
    off, on = tel_arm(model, device, None, schedule), tel_arm(model, device, tel, schedule)
    if on["streams"] != off["streams"]:
        bad = [i for i, (a, b) in enumerate(zip(on["streams"], off["streams"])) if a != b]
        raise AssertionError(f"telemetry on changed greedy streams {bad}")
    if on["launches"] != off["launches"] or (device.type == "cuda" and 0 in on["launches"].values()):
        raise AssertionError(f"K1/K4 launches with telemetry on {on['launches']}, off {off['launches']}")
    if on["fetch_observed"] < on["bursts"]:
        raise AssertionError(f"decode_fetch_ms observed {on['fetch_observed']} of {on['bursts']} bursts")
    shorts = tel_shorts(config.vocab_size, 3)
    for arm in (off, on):
        steady(arm["engine"], shorts, {})
    htod = count_htod(on["engine"].step, 5)
    if htod:
        raise AssertionError(f"5 steady bursts with telemetry on made {htod} host-to-device copies")
    walls = {}
    for label in ("off", "on", "on", "off"):
        walls.setdefault(label, []).append(tel_burst_ms((off if label == "off" else on)["engine"]))
    for arm in (off, on):
        arm["engine"].abort_all()
    out = {"streams_identical": len(on["streams"]), "launches": on["launches"], "bursts": on["bursts"],
           "fetch_observed": on["fetch_observed"], "memcpy_htod_5_bursts": htod, "burst_wall_ms": walls}
    del off, on
    torch.cuda.empty_cache()
    out["traces"] = tel_traces(model, device)
    out["s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------ phase 16: the fleet

# bench_serving.py::bench_fleet's mix at this width: 4 groups x 8 requests,
# each group sharing phase 13's 384-token system prompt, a unique 6..24-token
# suffix each, groups interleaved, one request in four interactive
FLEET_GROUPS, FLEET_PER_GROUP, FLEET_NEW, FLEET_LOOKAHEAD = 4, 8, 32, 8
# the exact-path and f32 arms' requests per group, cut for time (PERF.md section 4)
FLEET_EXACT_PER_GROUP = FLEET_F32_PER_GROUP = 4
FLEET_SESSIONS, FLEET_TURNS, FLEET_TURN_NEW = 4, 3, 16
FLEET_JOURNAL = Path(__file__).resolve().parent / "build" / "fleet" / "journal.jsonl"
FLEET_KERNELS = ("flash_fwd", "paged_attention")


def fleet_mix(vocab: int, per_group: int = FLEET_PER_GROUP, seed: int = 0) -> list:
    """``(prompt, class)`` pairs in arrival order (the groups interleaved)."""
    rng = np.random.default_rng(1600 + seed)
    prefixes = [rng.integers(1, vocab, PC_SYSTEM).tolist() for _ in range(FLEET_GROUPS)]
    return [(prefix + rng.integers(1, vocab, int(rng.integers(6, 25))).tolist(),
             "interactive" if j % 4 == 0 else "batch") for j in range(per_group) for prefix in prefixes]


def fleet_engine(model, device, quant, warm: bool = True, **kw):
    """Phase 13's engine; ``warm`` captures every decode burst graph a pass
    can replay first (lookahead 8, cut to 4, 2 and 1 by the slots' headroom
    or under contention), so a pass times serving, not captures."""
    engine = pc_engine(model, device, PC_BLOCKS, quant, **kw)
    if warm:
        rng = np.random.default_rng(7)
        for budget in (8, 4, 2, 1):
            engine.admit_many([(rng.integers(1, engine._config.vocab_size, 6).tolist(), budget)])
            while engine.num_active or engine.has_pending_events:
                engine.step(FLEET_LOOKAHEAD)
    return engine


def build_fleet(engines, policy: str, telemetry=None, supervisors=None):
    from unionml_tpu_torch.serving import EngineFleet, EngineSupervisor, FleetConfig

    # patient watchdogs: a first capture must not read as a stall
    sups = supervisors or [EngineSupervisor(stall_timeout_s=120.0) for _ in engines]
    return EngineFleet(engines, config=FleetConfig(policy=policy, seed=0), lookahead=FLEET_LOOKAHEAD,
                       supervisors=sups, telemetry=telemetry)


def counted(tally: dict, fn, *args):
    """``fn(*args)`` with the K1/K4 launch counts set to 0 just before and
    read just after, added to ``tally``; returns (result, this call's counts)."""
    from unionml_tpu_torch import kernels

    kernels.reset_launches()
    result = fn(*args)
    counts = {k: kernels.launches[k] for k in FLEET_KERNELS}
    for k, n in counts.items():
        tally[k] = tally.get(k, 0) + n
    return result, counts


def fleet_pass(gen, mix, tag: str, new_tokens: int = FLEET_NEW) -> dict:
    """Every request of ``mix`` streamed through ``gen`` (a fleet or a
    batcher) at once, routed in arrival order: wall s, tokens/s, TTFT p50/p95
    by class, and the streams."""
    ttft = {"interactive": [], "batch": []}
    streams = [None] * len(mix)

    async def one(i, prompt, cls):
        loop = asyncio.get_running_loop()
        t0, out = loop.time(), []
        async for token in gen.stream(prompt, new_tokens, priority=cls, request_id=f"{tag}-{i}"):
            if not out:
                ttft[cls].append((loop.time() - t0) * 1e3)
            out.append(token)
        streams[i] = out

    async def run():
        t0 = time.perf_counter()
        await asyncio.gather(*(one(i, p, c) for i, (p, c) in enumerate(mix)))
        return time.perf_counter() - t0

    wall = asyncio.run(run())
    if any(s is None or len(s) != new_tokens for s in streams):
        raise AssertionError(f"{tag}: a request did not complete its {new_tokens} tokens")
    return {"wall_s": wall, "tokens_per_s": len(mix) * new_tokens / wall, "streams": streams,
            "ttft_ms": {c: slo_pct(v, (0.5, 0.95)) for c, v in ttft.items()}}


def prime(fleet, mix):
    """Every prompt of ``mix`` once on every replica, straight through its
    batcher (one new token): each replica's radix index then holds every
    prompt's full blocks, so a later pass hits the same blocks wherever it is
    routed and its streams can be held to one replica's."""
    async def run():
        await asyncio.gather(*(rep.batcher.generate(p, 1, request_id=f"prime-{rep.index}-{i}")
                               for rep in fleet.replicas for i, (p, _) in enumerate(mix)))

    asyncio.run(run())


def note_preemptions(schedulers, mix, tag: str, preempted: dict) -> None:
    """Record, for each request of a pass tagged ``tag`` that one of
    ``schedulers`` preempts, the fewest tokens it had delivered at a
    preemption (its ticket's prompt is the transcript by then)."""
    for sched in schedulers:
        requeue = sched.requeue

        def noting(ticket, *, preemption=True, _requeue=requeue):
            rid = str(ticket.request_id)
            if preemption and rid.startswith(tag):
                i = int(rid.rsplit("-", 1)[1])
                delivered = len(ticket.prompt) - len(mix[i][0])
                preempted[i] = min(preempted.get(i, delivered), delivered)
            _requeue(ticket, preemption=preemption)

        sched.requeue = noting


def busy_union(prof) -> dict:
    """Device ms of a CUDA profile's events (the pad left out): their sum,
    and their union in time, where events of two streams that overlap count
    once."""
    spans = sorted((start, end) for name, start, end in device_events(prof) if PAD_KERNEL not in name)
    union, last = 0, None
    for start, end in spans:
        if last is None or start > last:
            union += end - start
            last = end
        elif end > last:
            union += end - last
            last = end
    return {"sum_ms": sum(end - start for start, end in spans) / 1e6, "union_ms": union / 1e6, "events": len(spans)}


def burst_wall_ms(engine, bursts: int = TEL_BURSTS) -> float:
    """Wall ms per replayed decode burst (pipelined ``step``) on the engine's
    own stream, synchronized on that stream only."""
    with torch.cuda.stream(engine.stream):
        engine.stream.synchronize()
        t = time.perf_counter()
        for _ in range(bursts):
            engine.step()
        engine.stream.synchronize()
    return (time.perf_counter() - t) * 1e3 / bursts


def fleet_coupling(engines, vocab: int) -> dict:
    """Each replica's burst wall with the other replica idle, then with the
    other decoding on its own thread and stream (two workers, one GIL, one
    card): 8 slots each, filled by bucket-prefilled requests."""
    shorts = tel_shorts(vocab, 16)
    for engine in engines:
        steady(engine, shorts, {})
    out = {}
    for i, (a, b) in enumerate((engines, engines[::-1])):
        idle = burst_wall_ms(a)
        stop = threading.Event()

        def spin():
            with b._on_stream():
                while not stop.is_set():
                    b.step()

        worker = threading.Thread(target=spin)
        worker.start()
        try:
            busy = burst_wall_ms(a)
        finally:
            stop.set()
            worker.join(timeout=60)
        if worker.is_alive():
            raise AssertionError("the busy replica's thread did not stop")
        out[f"replica_{i}"] = {"other_idle_ms": idle, "other_busy_ms": busy}
    for engine in engines:
        engine.abort_all()
    return out


def fleet_routing(model, device, mix, tally) -> dict:
    """Parts 1 and 2 (bf16): the cold pass of each router arm on fresh warmed
    replicas, then, for affinity and for one replica alone, a warm pass after
    priming, its device idle share in one CUDA profile, the per-replica burst
    coupling, and the two warm passes' streams side by side. Every arm is
    traced (the affinity fleet's journal feeds part 5)."""
    from unionml_tpu_torch.serving import EngineFleet, EngineSupervisor, Telemetry

    FLEET_JOURNAL.parent.mkdir(parents=True, exist_ok=True)
    FLEET_JOURNAL.unlink(missing_ok=True)
    out = {}
    for arm in ("random", "affinity", "single"):
        steps, t = {}, time.perf_counter()

        def lap(name):
            nonlocal t
            steps[name] = time.perf_counter() - t
            t = time.perf_counter()

        tel = Telemetry(journal_path=str(FLEET_JOURNAL) if arm == "affinity" else None)
        # the random arm is read for its hit rate only: its graphs are captured in the pass
        engines = [fleet_engine(model, device, "int8", warm=arm != "random")
                   for _ in range(1 if arm == "single" else 2)]
        if arm == "single":
            fleet = EngineFleet(engines, lookahead=FLEET_LOOKAHEAD, telemetry=tel,
                                supervisors=[EngineSupervisor(stall_timeout_s=120.0)])
        else:
            fleet = build_fleet(engines, arm, telemetry=tel)
        lap("warm_up")
        try:
            cold, launches = counted(tally, fleet_pass, fleet, mix, f"{arm}-cold")
            rec = {"cold_hit_rate": fleet.router.stats()["prefix_hit_rate"], "cold_router": fleet.router.stats(),
                   "cold_wall_s": cold["wall_s"], "cold_launches": launches}
            lap("cold")
            if arm != "random":
                prime(fleet, mix)
                lap("prime")
                rec["preempted"] = {}
                note_preemptions([r.batcher.scheduler for r in fleet.replicas], mix, f"{arm}-warm", rec["preempted"])
                warm, rec["warm_launches"] = counted(tally, fleet_pass, fleet, mix, f"{arm}-warm")
                rec["warm"] = {k: warm[k] for k in ("wall_s", "tokens_per_s", "ttft_ms")}
                rec["streams"] = warm["streams"]
                lap("warm")

                def profiled(first):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    fleet_pass(fleet, mix, f"{arm}-profiled")
                    torch.cuda.synchronize()
                    return (time.perf_counter() - start) * 1e3

                sessions = len(PROFILE_LOST)
                prof, wall_ms = cuda_profile(profiled)
                busy = busy_union(prof)
                if not busy["events"]:
                    raise AssertionError(f"fleet {arm}: the profile recorded no device event")
                rec["profiled"] = {"wall_ms": wall_ms, **busy, "profile_sessions": len(PROFILE_LOST) - sessions,
                                   "idle_share": 1.0 - busy["union_ms"] / wall_ms,
                                   "idle_share_by_sum": 1.0 - busy["sum_ms"] / wall_ms,
                                   "overlap_share": 1.0 - busy["union_ms"] / busy["sum_ms"]}
                del prof
                lap("profiled")
            rec["per_replica"] = [{"state": r["state"], "scheduler_admitted": r["scheduler"]["admitted"],
                                   "prefix_cache_hits": r["prefix_cache"]["hits"]}
                                  for r in fleet.stats()["fleet"]["per_replica"]]
        finally:
            fleet.close()
        rec["capture_failures"] = [e.capture_failures for e in engines]
        rec["failures"] = [e.failure_count for e in engines]
        if any(rec["capture_failures"]) or any(rec["failures"]) or any(leaked(e) != (0, 0, 0) for e in engines):
            raise AssertionError(f"fleet {arm}: capture failures {rec['capture_failures']}, engine failures "
                                 f"{rec['failures']}, leaks {[leaked(e) for e in engines]}")
        if arm == "affinity":
            rec["coupling"] = fleet_coupling(engines, model.config.vocab_size)
            lap("coupling")
        if arm == "single":
            rec["engine"] = engines[0]
            out["pool_blocks"] = engines[0].pool_blocks - 1
        rec["steps_s"] = steps
        out[arm] = rec
        del engines, fleet
        torch.cuda.empty_cache()
    aff, rnd = out["affinity"]["cold_hit_rate"], out["random"]["cold_hit_rate"]
    if not (aff is not None and rnd is not None and aff > rnd):
        raise AssertionError(f"cold prefix hit rate: affinity {aff} is not above random {rnd}")
    # printed, not gated: a prefix block's int8 codes come from whichever
    # request prefilled it first, in a 256-token chunk whose row count is that
    # request's length, so the two arms' cached blocks can round otherwise
    # (phase 13's part 1, PERF.md section 6); fleet_bf16_exact holds the
    # same comparison where the prefills' row counts match
    single = out["single"].pop("engine")
    out["bf16_splits"] = gated_splits("fleet bf16 served configuration, 2 replicas vs 1 (warm; report)",
                                      out["affinity"].pop("streams"), out["single"].pop("streams"), single,
                                      [p for p, _ in mix], float("inf"), FLEET_NEW)
    del single
    return out


def fleet_bf16_exact(model, device, mix, tally) -> dict:
    """Part 2 at bf16 with the int8 pool on the exact-path configuration
    (phase 13's: chunks of 64, buckets from 64, so a prefix block's codes do
    not depend on which request prefilled it): a 2-replica fleet's cold pass
    against one supervised batcher's, under the bf16 rule up to each
    stream's first preemption in either arm (a resume re-prefills and
    re-quantizes the transcript's tail, PERF.md section 6)."""
    from unionml_tpu_torch.serving import ContinuousBatcher, EngineSupervisor

    fleet = build_fleet([pc_engine(model, device, PC_BLOCKS, "int8", **PC_EXACT_KW) for _ in range(2)], "affinity")
    single = ContinuousBatcher(pc_engine(model, device, PC_BLOCKS, "int8", **PC_EXACT_KW), lookahead=FLEET_LOOKAHEAD,
                               supervisor=EngineSupervisor(stall_timeout_s=120.0), device=device)
    preempted = {}
    note_preemptions([r.batcher.scheduler for r in fleet.replicas] + [single.scheduler], mix, "exact-", preempted)
    try:
        got = counted(tally, fleet_pass, fleet, mix, "exact-fleet")[0]["streams"]
        want = counted(tally, fleet_pass, single, mix, "exact-single")[0]["streams"]
    finally:
        fleet.close()
        single.close()
    splits = gated_splits("fleet bf16 exact path, 2 replicas vs 1", got, want, single.engine, [p for p, _ in mix],
                          float("inf"), FLEET_NEW)
    for sp in splits:
        sp["preempted_after"] = preempted.get(sp["request"])
        if sp["vanilla_top2_gap"] >= GAP_LIMIT_BF16 and (sp["preempted_after"] is None
                                                         or sp["split"] < sp["preempted_after"]):
            raise AssertionError(f"fleet bf16 exact path: stream {sp['request']} splits from one batcher's at token "
                                 f"{sp['split']} (gap {sp['vanilla_top2_gap']:.3e}) before any preemption of it")
    left = [leaked(e) for e in [r.engine for r in fleet.replicas] + [single.engine]]
    if any(x != (0, 0, 0) for x in left):
        raise AssertionError(f"fleet bf16 exact path: blocks left {left}")
    return {"splits": splits, "preempted": preempted, "identical": sum(a == b for a, b in zip(got, want))}


def fleet_sessions(model, device, vocab: int, tally) -> dict:
    """Part 4: 4 sessions of 3 turns, one turn at a time, each opening with a
    24..48-token message (a bucket prefill) and each later turn the
    transcript plus a 6..24-token message. Sessions 0-2 are placed on replica
    0 and session 3 on replica 1 before their first turn; replica 1 dies
    (``FaultPlan``, its rebuilds failing too) in session 3's second turn."""
    from unionml_tpu_torch.serving import EngineSupervisor, FaultPlan, Telemetry

    engines = [fleet_engine(model, device, "int8", warm=False, prefix_cache_generated=True) for _ in range(2)]
    sups = [EngineSupervisor(stall_timeout_s=120.0),
            EngineSupervisor(stall_timeout_s=120.0, max_rebuild_attempts=2, backoff_s=0.005)]
    tel = Telemetry()
    fleet = build_fleet(engines, "affinity", telemetry=tel, supervisors=sups)
    rng = np.random.default_rng(1700)
    sessions = [f"s{i}" for i in range(FLEET_SESSIONS)]
    victim = sessions[-1]
    transcripts = {sid: rng.integers(1, vocab, int(rng.integers(24, 49))).tolist() for sid in sessions}
    for sid in sessions:  # placement: a route with one candidate sticks the session there
        fleet.router.route(transcripts[sid], [(1 if sid == victim else 0, 1.0, 0.0)], session_id=sid)
    block, turns, bad = engines[0].block_size, [], []
    try:
        for turn in range(FLEET_TURNS):
            for sid in sessions:
                message = rng.integers(1, vocab, int(rng.integers(6, 25))).tolist() if turn else []
                prompt = transcripts[sid] + message
                if sid == victim and turn == 1:
                    engines[1]._faults = FaultPlan(step_dispatch_failures=(1,), rebuild_failures=99)
                before = [e.prefill_tokens_computed for e in engines]
                rid = f"{sid}-turn{turn}"
                out, launches = counted(tally, lambda: asyncio.run(fleet.generate(
                    prompt, FLEET_TURN_NEW, session_id=sid, request_id=rid)))
                spans = tel.get_trace(rid)["spans"]
                routed = next(sp["attrs"]["replica"] for sp in spans if sp["kind"] == "route")
                adopted = [sp["attrs"]["to_replica"] for sp in spans if sp["kind"] == "failover_adopt"]
                cost = sum(e.prefill_tokens_computed - b for e, b in zip(engines, before))
                turns.append({"session": sid, "turn": turn, "replica": routed, "adopted_by": adopted,
                              "prefill_tokens": cost, "message": len(message), "launches": launches})
                transcripts[sid] = prompt + out
                if turn and not adopted and cost > len(message) + block:
                    bad.append(f"{rid} prefilled {cost} tokens for a {len(message)}-token message")
        restuck = fleet.router.session_replica(victim)
        health = fleet.healthz()
        fstats = {k: v for k, v in fleet.stats()["fleet"].items() if k not in ("router", "per_replica")}
    finally:
        fleet.close()
    for sid in sessions:
        mine = [t for t in turns if t["session"] == sid]
        homes = {t["replica"] for t in mine}
        if sid != victim and len(homes) != 1:
            bad.append(f"{sid} moved between replicas {sorted(homes)}")
    died = [t for t in turns if t["adopted_by"]]
    after = [t for t in turns if t["session"] == victim and t["turn"] == FLEET_TURNS - 1]
    if len(died) != 1 or died[0]["session"] != victim or died[0]["adopted_by"] != [0]:
        bad.append(f"the failover turn(s): {died}")
    if not after or after[0]["replica"] != 0 or restuck != 0:
        bad.append(f"{victim} did not re-stick to its adopter: turn {after}, session replica {restuck}")
    if fstats["rerouted_tickets"] != 1 or fstats["reroute_failed"] or health["state"] != "degraded":
        bad.append(f"fleet {fstats}, health {health['state']}")
    k1 = sum(t["launches"]["flash_fwd"] for t in turns)
    if device.type == "cuda" and (k1 == 0 or any(t["launches"]["paged_attention"] == 0 for t in turns)):
        bad.append(f"launches by turn {[t['launches'] for t in turns]}")
    if any(leaked(e) != (0, 0, 0) for e in engines) or any(e.capture_failures for e in engines):
        bad.append(f"leaks {[leaked(e) for e in engines]}, capture failures {[e.capture_failures for e in engines]}")
    if bad:
        raise AssertionError(f"fleet sessions: {bad}")
    del engines, fleet
    torch.cuda.empty_cache()
    return {"turns": [{k: v for k, v in t.items() if k != "launches"} for t in turns], "victim": victim,
            "restuck_to": restuck, "fleet": fstats, "k1_launches": k1}


def fleet_f32(model, device, mix, tally) -> dict:
    """Parts 2 and 3 at f32 with an f32 pool (the exact path): one supervised
    batcher, then 2-replica fleets without a fault, with a fault replica 0
    recovers from in place (it recaptures its graphs while replica 1 keeps
    replaying), and with replica 1 dying (every rebuild failing): streams
    identical throughout, the dead replica's tickets re-routed."""
    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.serving import ContinuousBatcher, EngineSupervisor, FaultPlan

    def engines_with(*plans):
        return [fleet_engine(model, device, None, warm=False, faults=plan) for plan in plans]

    single = ContinuousBatcher(fleet_engine(model, device, None, warm=False), lookahead=FLEET_LOOKAHEAD,
                               supervisor=EngineSupervisor(stall_timeout_s=120.0), device=device)
    try:
        want = counted(tally, fleet_pass, single, mix, "f32-single")[0]["streams"]
    finally:
        single.close()
    del single
    out = {}
    runs = {
        "clean": (engines_with(None, None), None),
        "recapture": (engines_with(FaultPlan(step_dispatch_failures=(2,)), None), None),
        "death": (engines_with(None, FaultPlan(step_dispatch_failures=(3,), rebuild_failures=99)),
                  [EngineSupervisor(stall_timeout_s=120.0),
                   EngineSupervisor(stall_timeout_s=120.0, max_rebuild_attempts=2, backoff_s=0.005)]),
    }
    for name, (engines, sups) in runs.items():
        fleet = build_fleet(engines, "affinity", supervisors=sups)
        try:
            got, launches = counted(tally, fleet_pass, fleet, mix, f"f32-{name}")
            tallies = kernels.tallies()
            fstats = {k: v for k, v in fleet.stats()["fleet"].items() if k not in ("router", "per_replica")}
            states = [rep.supervisor.state for rep in fleet.replicas]
        finally:
            fleet.close()
        rec = {"fleet": fstats, "states": states, "launches": launches,
               "failures": [e.failure_count for e in engines], "rebuilds": [e.rebuilds for e in engines],
               "capture_failures": [e.capture_failures for e in engines],
               "graph_captures": [e.graph_captures for e in engines],
               "graphs_dropped": [e.graphs_dropped for e in engines],
               "threads_launching_k4": sum(1 for t in tallies.values() if t["paged_attention"])}
        summed = {k: sum(t[k] for t in tallies.values()) for k in FLEET_KERNELS}
        bad = [i for i, (a, b) in enumerate(zip(got["streams"], want)) if a != b]
        if bad:
            raise AssertionError(f"f32 fleet {name}: streams {bad} differ from one supervised batcher's")
        if any(rec["capture_failures"]) or any(leaked(e) != (0, 0, 0) for e in engines):
            raise AssertionError(f"f32 fleet {name}: {rec}, leaks {[leaked(e) for e in engines]}")
        if summed != launches or (device.type == "cuda" and (launches["paged_attention"] == 0
                                                             or rec["threads_launching_k4"] < 2)):
            raise AssertionError(f"f32 fleet {name}: launches {launches}, per-thread sums {summed}, "
                                 f"{rec['threads_launching_k4']} threads launched K4")
        expect = {"clean": ([0, 0], ["ok", "ok"], 0), "recapture": ([1, 0], ["ok", "ok"], 0),
                  "death": ([0, 1], ["ok", "failed"], None)}[name]
        if rec["failures"] != expect[0] or states != expect[1]:
            raise AssertionError(f"f32 fleet {name}: engine failures {rec['failures']}, states {states}")
        if name == "recapture" and (rec["rebuilds"][0] < 1 or (device.type == "cuda" and rec["graphs_dropped"][0] < 1)):
            raise AssertionError(f"f32 fleet recapture: rebuilds {rec['rebuilds']}")
        if name == "death" and (fstats["rerouted_tickets"] < 1 or fstats["reroute_failed"]):
            raise AssertionError(f"f32 fleet death: {fstats}")
        out[name] = rec
        del engines, fleet
        torch.cuda.empty_cache()
    out["requests"] = len(mix)
    return out


def fleet_sim(mix, measured: dict, pool_blocks: int) -> dict:
    """Part 5: the affinity fleet's journal (cold, priming and warm passes)
    through the port's ``replay_journal`` and ``fit_cost_model`` (priming
    requests left out of the fit), then a 2-replica ``FleetSimulator`` with
    the fitted costs on the same mix, all arriving at once: its TTFT by class
    and its seconds beside the measured warm pass (printed, not gated)."""
    from unionml_tpu_torch.serving import FleetConfig
    from unionml_tpu_torch.sim import FleetSimulator, SimConfig, SimRequest, fit_cost_model, load_journal, \
        replay_journal

    records = load_journal(str(FLEET_JOURNAL))
    replay = replay_journal(records)
    cost = fit_cost_model([r for r in records if not r.request_id.startswith("prime-")])
    requests = [SimRequest(arrival_s=0.0, session_id=f"r{i}", prompt=tuple(p), budget=FLEET_NEW, cls=cls,
                           deadline_ms=None) for i, (p, cls) in enumerate(mix)]
    sim = FleetSimulator(SimConfig(num_replicas=2, num_slots=PC_ENGINE_KW["num_slots"], num_blocks=pool_blocks,
                                   block_size=16, max_len=PC_ENGINE_KW["max_len"], cost=cost,
                                   fleet=FleetConfig(policy="affinity", seed=0)), requests)
    ttft = {"interactive": [], "batch": []}
    record = sim.slo.record

    def noting(cls, status, ttft_ms, **kw):
        if ttft_ms is not None:
            ttft[cls].append(ttft_ms)
        return record(cls, status, ttft_ms, **kw)

    sim.slo.record = noting
    report = sim.run()
    if report["completed"] != len(mix) or replay["records"] != len(records):
        raise AssertionError(f"simulator: {report['completed']} of {len(mix)} completed; replay {replay['records']}")
    return {"fitted": dataclasses.asdict(cost), "records": len(records), "replay": {
        k: replay[k] for k in ("status", "by_class", "shed", "preemptions", "resumes", "failover_adoptions",
                               "block_demand_violations")},
        "simulated": {"ttft_ms": {c: slo_pct(v, (0.5, 0.95)) for c, v in ttft.items()},
                      "duration_s": report["duration_s"], "router": report["router"]["prefix_hit_rate"]},
        "measured": {"ttft_ms": measured["ttft_ms"], "wall_s": measured["wall_s"]}}


def fleet_phase(device, config=None) -> dict:
    """The engine fleet (phase 16, see the module docstring)."""
    from unionml_tpu_torch.models import GPTConfig, init_gpt, random_params

    t0 = time.perf_counter()
    config = config or GPTConfig()  # GPT-2 small
    params = random_params(config, seed=0)
    out, parts, tally = {}, {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(*args)
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t

    mix = fleet_mix(config.vocab_size)
    model = init_gpt(dataclasses.replace(config, dtype=torch.bfloat16), params=params, device=device)
    part("routing", fleet_routing, model, device, mix, tally)
    part("bf16_exact", fleet_bf16_exact, model, device, fleet_mix(config.vocab_size, FLEET_EXACT_PER_GROUP), tally)
    part("sessions", fleet_sessions, model, device, config.vocab_size, tally)
    del model
    model = init_gpt(dataclasses.replace(config, dtype=torch.float32), params=params, device=device)
    part("f32", fleet_f32, model, device, fleet_mix(config.vocab_size, FLEET_F32_PER_GROUP), tally)
    del model
    part("sim", fleet_sim, mix, out["routing"]["affinity"]["warm"], out["routing"]["pool_blocks"])
    if device.type == "cuda" and not all(tally.get(k) for k in FLEET_KERNELS):
        raise AssertionError(f"the fleet path launched {tally}")
    out["launches"], out["parts_s"], out["s"] = tally, parts, time.perf_counter() - t0
    return out


# ---------------------------------------------------- phase 17: the sparse GPT

MOE_SEQ, MOE_SEQS, MOE_STEPS = LM_SEQ, 384, 10  # B8 x 1024 rows packed from 384 ragged sequences
MOE_TOKENS = 8192  # the layer check's capacity shape: one training step's tokens
MOE_SYSTEM, MOE_REQUESTS, MOE_NEW, MOE_LOOKAHEAD, MOE_BLOCKS = 128, 8, 32, 8, 256
MOE_ENGINE_KW = dict(num_slots=8, max_len=1024, prefill_chunk=PREFILL_CHUNK, prefill_batch=1, seed=0)
MOE_BURSTS = 20  # profiled 1-step bursts per burst reading


def moe_config():
    """GPT-2 small widths with the JAX package's MoE defaults: every second
    block sparse (6 of 12), 8 experts, top-2, capacity factor 1.25."""
    from unionml_tpu_torch.models import GPTConfig

    return GPTConfig(moe_every=2)


def moe_layer_parity(config, device) -> dict:
    """(a) ``MoEMlp`` on the card against its plain version: the one-hot
    formulation in f32 on the card, on the same gates (routed once in the
    layer's dtype, then upcast: the same choices, ties and drops). A router
    biased toward expert 0 makes capacity mode (the training shape, 8192
    tokens) really drop choices; the dropped sets must be equal exactly.
    Dropless at a prefill chunk's and a decode step's token counts."""
    from unionml_tpu_torch.models.moe import MoEMlp, _experts
    from unionml_tpu_torch.parallel.ep import moe_apply_topk, reference_moe_apply_topk, reference_topk_dispatch_combine, \
        topk_route

    d, experts, k, cf = config.hidden_size, config.num_experts, config.moe_k, config.moe_capacity_factor
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        torch.manual_seed(0)
        layer = MoEMlp(d, experts, 4 * d, k=k, capacity_factor=cf, dtype=dtype, device=device)
        with torch.no_grad():
            layer.router.weight.normal_(0.0, 0.05)
            layer.router.bias.copy_(torch.linspace(0.6, -0.6, experts, device=device))  # imbalanced
        rec = {}
        for mode, tokens in (("capacity", MOE_TOKENS), ("dropless", PREFILL_CHUNK), ("dropless", 8)):
            x = torch.randn(tokens, d, generator=torch.Generator(device=device).manual_seed(tokens), device=device)
            x = x.to(dtype)
            with torch.no_grad():
                gates, _ = layer.route(x)
                cap = cf if mode == "capacity" else None
                params = (layer.w_in, layer.w_out)
                got = moe_apply_topk(_experts, params, x, gates, k=k, capacity_factor=cap)
                want = reference_moe_apply_topk(_experts, tuple(p.float() for p in params), x.float(), gates.float(),
                                                k=k, capacity_factor=cap)
            label = f"MoEMlp {str(dtype)[6:]} {mode} T{tokens}"
            err = check_close(label, got, want)
            entry = {"max_abs_err": err}
            if mode == "capacity":
                routing = topk_route(gates, k, cf)
                kept = torch.zeros(tokens, experts, dtype=torch.bool, device=device)
                kept[torch.arange(tokens, device=device)[:, None].expand(-1, k)[routing.keep],
                     routing.index[routing.keep]] = True
                order = torch.sort(gates.float(), dim=-1, descending=True, stable=True).indices[:, :k]
                dispatch, _ = reference_topk_dispatch_combine(order, routing.gates.float(), experts, routing.capacity,
                                                              torch.float32)
                if not torch.equal(kept, dispatch.sum(-1) > 0):
                    raise AssertionError(f"{label}: the index dispatch's dropped set differs from the plain version's")
                dropped = int((~routing.keep).sum())
                if dropped == 0:
                    raise AssertionError(f"{label}: the imbalanced router dropped nothing")
                entry.update(dropped=dropped, choices=tokens * k, capacity=routing.capacity,
                             dropped_first_choices=int((~routing.keep[:, 0]).sum()))
                if dtype == torch.bfloat16:
                    def index():
                        with torch.no_grad():
                            moe_apply_topk(_experts, params, x, gates, k=k, capacity_factor=cf)

                    def one_hot():
                        with torch.no_grad():
                            reference_moe_apply_topk(_experts, params, x, gates, k=k, capacity_factor=cf)

                    entry["forward_ms"] = {"index": cuda_ms(index, 5), "one_hot": cuda_ms(one_hot, 5)}
            rec[f"{mode}_T{tokens}"] = entry
        out[str(dtype)] = rec
        del layer
        torch.cuda.empty_cache()
    return out


def moe_corpus(seqs: int = MOE_SEQS) -> dict:
    """``lm_corpus`` as a reader's arrays: right-padded ids and lengths."""
    corpus = lm_corpus(seqs, MOE_SEQ, seed=7)
    ids = np.zeros((len(corpus), max(len(s) for s in corpus)), np.int32)
    for i, s in enumerate(corpus):
        ids[i, : len(s)] = s
    return {"input_ids": ids, "length": np.array([len(s) for s in corpus], np.int32)}


def build_moe_app(config, params, device, record: dict):
    """The moe-textgen app (``unionml_tpu/templates/moe-textgen/app.py``)
    through the port's ``Dataset`` and ``Model``: a seeded reader of ragged
    sequences, a trainer that packs them through ``fit_lm(moe_aux=True,
    pack=True)`` (capacity-bounded experts, router losses in the objective),
    a predictor that runs ``generate`` (dropless) over left-padded ragged
    prompts, and the packed LM eval loss from the evaluator. The trainer's
    ``FitResult`` lands in ``record["fit"]``."""
    from typing import Any, Dict

    from unionml_tpu_torch import Dataset, Model
    from unionml_tpu_torch.models import TrainState, create_train_state, fit_lm, generate, init_gpt, make_lm_eval_step
    from unionml_tpu_torch.ops.packing import pack_sequences

    dataset = Dataset(name="moe_app_dataset", test_size=0.1)

    def sequences(features):
        return [row[:n] for row, n in zip(np.asarray(features["input_ids"]), np.asarray(features["length"]))]

    def init(learning_rate: float = 3e-4) -> TrainState:
        return create_train_state(init_gpt(config, params=params, device=device), learning_rate=learning_rate,
                                  warmup_steps=10, total_steps=1000, seed=0)

    model = Model(name="moe_app", init=init, dataset=dataset)

    @dataset.reader
    def reader(n: int = MOE_SEQS) -> Dict[str, np.ndarray]:
        return moe_corpus(n)

    @dataset.feature_loader
    def feature_loader(features: Any) -> Dict[str, Any]:
        return features

    @model.trainer
    def trainer(state: TrainState, features: Dict[str, np.ndarray], targets: Any, *, num_steps: int = MOE_STEPS,
                batch_size: int = LM_BATCH) -> TrainState:
        record["fit"] = fit_lm(state, sequences(features), seq_len=MOE_SEQ, batch_size=batch_size, pack=True,
                               num_steps=num_steps, log_every=1, seed=0, moe_aux=True)
        return record["fit"].state

    @model.predictor(jit=False)
    def predictor(state: TrainState, features: Dict[str, Any]) -> torch.Tensor:
        prompts = [np.asarray(p, np.int64) for p in features["prompt_ids"]]
        max_new = int(features.get("max_new_tokens", MOE_NEW))
        width = max(len(p) for p in prompts)
        ids, mask = np.zeros((len(prompts), width), np.int64), np.zeros((len(prompts), width), np.int64)
        for row, p in enumerate(prompts):
            ids[row, width - len(p):], mask[row, width - len(p):] = p, 1
        ragged = any(len(p) != width for p in prompts)
        return generate(state.model, torch.from_numpy(ids), max_new, max_len=width + max_new,
                        prompt_mask=torch.from_numpy(mask) if ragged else None)

    @model.evaluator
    def evaluator(state: TrainState, features: Dict[str, np.ndarray], targets: Any) -> float:
        packed = pack_sequences(sequences(features), MOE_SEQ)
        batch = {k: torch.from_numpy(packed[k][:LM_BATCH]).to(device) for k in ("input_ids", "segment_ids")}
        return float(make_lm_eval_step(packed=True)(state, batch)["loss"])

    return dataset, model


def moe_train(config, params, device) -> dict:
    """(b) ``Model.train`` of the sparse app: K1, K2 and K3 once per layer and
    step; finite losses; the first 3 steps against the plain path
    (``attention_impl="reference"``, same weights and dropout); the aux
    losses, a step's wall against device ms, and ``Model.predict``."""
    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.models import collect_aux_losses, dict_batches, generate, make_lm_train_step
    from unionml_tpu_torch.ops.packing import pack_sequences

    record = {}
    _, app = build_moe_app(config, params, device, record)
    kernels.reset_launches()
    state, metrics = app.train()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    fit = record["fit"]
    history = fit.metrics_history
    if device.type == "cuda":
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            per_run = config.num_layers * MOE_STEPS
            if launches[name] < per_run or (name != "flash_fwd" and launches[name] != per_run):
                raise AssertionError(f"MoE Model.train launched {name} {launches[name]} times; expected "
                                     f"{config.num_layers} per step over {MOE_STEPS} steps (K1 more: the evaluator)")
    if fit.steps != MOE_STEPS or not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"MoE training: {fit.steps} steps, history {history}")
    corpus = moe_corpus()
    packed = pack_sequences([row[:n] for row, n in zip(corpus["input_ids"], corpus["length"])], MOE_SEQ)
    batches = list(dict_batches({k: packed[k] for k in ("input_ids", "segment_ids")}, LM_BATCH,
                                rng=np.random.default_rng(1), device=device))
    with torch.no_grad():
        logits, aux = state.model(batches[0]["input_ids"], segment_ids=batches[0]["segment_ids"], deterministic=False,
                                  generator=torch.Generator(device=device).manual_seed(0), return_aux=True)
    aux_total = float(collect_aux_losses(aux))
    by_layer = [{k: round(float(v), 5) for k, v in a.items()} for a in aux]
    del logits
    step = make_lm_train_step(packed=True, moe_aux=True)
    step(state, batches[0])
    profile = step_profile(lambda: step(state, batches[0]), 3, top=8)

    # Model.predict: two ragged prompts through generate (dropless), the same
    # tokens as generate called directly
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, config.vocab_size, n).tolist() for n in (9, 23)]
    predicted = app.predict(features={"prompt_ids": prompts, "max_new_tokens": 16})
    width = 23
    ids = torch.zeros((2, width), dtype=torch.long)
    mask = torch.zeros((2, width), dtype=torch.long)
    for row, p in enumerate(prompts):
        ids[row, width - len(p):], mask[row, width - len(p):] = torch.tensor(p), 1
    direct = generate(state.model, ids, 16, max_len=width + 16, prompt_mask=mask)
    if predicted.shape != (2, width + 16) or not torch.equal(predicted.cpu(), direct.cpu()) or bool(
            (predicted < 0).any() or (predicted >= config.vocab_size).any()):
        raise AssertionError(f"Model.predict of the sparse app: {predicted.shape}, equal to generate "
                             f"{torch.equal(predicted.cpu(), direct.cpu())}")
    del state, app
    torch.cuda.empty_cache()
    agreement = compare_first_steps(lm_first_steps(config, params, device, "auto", batches[:3], moe_aux=True),
                                    lm_first_steps(config, params, device, "reference", batches[:3], moe_aux=True))
    return {"launches": launches, "steps": fit.steps, "history": history, "metrics": metrics,
            "step_ms": 1e3 / fit.steps_per_s, "aux": aux_total, "aux_by_layer": by_layer, "step_profile": profile,
            "first_steps_vs_plain": agreement, "predicted": predicted[:, width:].tolist()}


def moe_payloads(vocab: int) -> list:
    """``/generate`` payloads: a 128-token system prompt shared by all, user
    suffixes of 8..40 tokens; the last is ``interactive`` (a speculative
    class), the rest ``standard``; streamed."""
    rng = np.random.default_rng(500)
    system = rng.integers(0, vocab, MOE_SYSTEM).tolist()
    payloads = [{"prompt_ids": system + rng.integers(0, vocab, int(rng.integers(8, 41))).tolist(),
                 "max_new_tokens": MOE_NEW, "priority": "standard", "stream": True} for _ in range(MOE_REQUESTS)]
    payloads[-1]["priority"] = "interactive"
    return payloads


def moe_serve_arm(model, device, quant, payloads) -> dict:
    """What ``model.serve(generator=...)`` builds for ``/generate``
    (``build_generator``: a ``ContinuousBatcher`` with lookahead 8 and an
    ``EngineSupervisor`` over a self-draft ``SpeculativeEngine``, 8 slots,
    prefix cache on), driven through the route's plain handler
    (``parse_generate_payload``, then the generator's ``stream``): the first
    request alone (it fills the cache), then the other 7 at once. A second,
    warm pass of the same requests (every one a hit now) gives tokens/s and
    TTFT; the first pass's streams are the ones compared."""
    from unionml_tpu_torch import kernels
    from unionml_tpu_torch.serving.app import build_generator, parse_generate_payload
    from unionml_tpu_torch.serving.speculative import SpeculativeEngine

    engine = SpeculativeEngine(model, model, gamma_max=SPEC_GAMMA_MAX, kv_quantize=quant,
                               prefix_cache_blocks=MOE_BLOCKS, device=device, **MOE_ENGINE_KW)
    gen = build_generator(engine, lookahead=MOE_LOOKAHEAD, device=device)

    async def one(payload, t0):
        req = parse_generate_payload(payload, gen)
        out, ttft = [], None
        async for token in gen.stream(req.prompt_ids, req.max_new_tokens, **req.slo, **req.sampling):
            ttft = time.perf_counter() - t0 if ttft is None else ttft
            out.append(token)
        return out, ttft

    async def run():
        t0 = time.perf_counter()
        head = [await one(payloads[0], t0)]
        t0 = time.perf_counter()
        tail = await asyncio.gather(*(one(p, t0) for p in payloads[1:]))
        return head + list(tail), time.perf_counter() - t0

    kernels.reset_launches()
    try:
        results, cold_wall = asyncio.run(run())
        warm, wall = asyncio.run(run())
    finally:
        gen.close()
    torch.cuda.synchronize()
    streams, ttft = [s for s, _ in results], [t * 1e3 for _, t in warm]
    rest = sum(len(s) for s, _ in warm[1:])
    return {"engine": engine, "streams": streams, "ttft_ms": ttft, "cold_ttft_ms": [t * 1e3 for _, t in results],
            "cold_tokens_per_s": sum(len(s) for s in streams[1:]) / cold_wall, "wall_s": wall,
            "tokens_per_s": rest / wall, "launches": dict(kernels.launches),
            "hits": engine.prefix_cache.stats()["hits"], "speculation": engine.speculation_stats(),
            "graph_replays": sum(graph_replays(engine).values())}


def moe_burst(model, device, prompt_list) -> dict:
    """A 1-step decode burst replayed with 8 slots decoding (int8 pool,
    vanilla engine): wall ms against the device ms of its kernels."""
    engine = vanilla_engine(model, device)
    steady(engine, prompt_list, {})
    result = step_profile(engine.step, MOE_BURSTS, top=8)
    engine.abort_all()
    return result


def moe_routes(model, ids) -> dict:
    """Each sparse layer's sorted top-k experts per token, and its gates, in
    a deterministic (dropless) full forward of ``ids``."""
    from unionml_tpu_torch.parallel.ep import topk_route

    routes, hooks = {}, []

    def recorder(i):
        def record(module, args):
            gates, _ = module.route(args[0].reshape(-1, args[0].shape[-1]))
            routes[i] = (torch.sort(topk_route(gates, module.k, None).index, -1).values, gates)
        return record

    for i, layer in enumerate(model.layers):
        if layer.use_moe:
            hooks.append(layer.moe_mlp.register_forward_pre_hook(recorder(i)))
    try:
        with torch.no_grad():
            model(torch.tensor([ids], device=model.device))
    finally:
        for hook in hooks:
            hook.remove()
    return routes


def first_flip(kernel_model, plain_model, ids):
    """The first (layer, token) whose expert choice differs between the
    kernel and the plain path over ``ids``, with the plain path's margin
    between its k-th and (k+1)-th gate there (bf16); None when every choice
    agrees."""
    got, want = moe_routes(kernel_model, ids), moe_routes(plain_model, ids)
    k = kernel_model.config.moe_k
    for i in sorted(got):
        differ = (got[i][0] != want[i][0]).any(-1)
        if bool(differ.any()):
            t = int(differ.nonzero()[0, 0])
            top = torch.sort(want[i][1][t].float(), descending=True).values
            return {"layer": i, "token": t, "gate": float(top[k - 1]), "plain_margin": float(top[k - 1] - top[k])}
    return None


def moe_bf16_splits(kernel_model, plain_model, got, want, plain_engine, prompt_list) -> list:
    """bf16 streams of the kernel path against the plain path's. A sparse
    model's gates are rounded to bf16 before top-k (JAX's order), so two
    experts tied to the last bit swap on a last-bit difference in the
    block's input, and the token then runs another expert: its hidden state
    moves by O(1) and the streams can split at any gap. A split is accepted
    where the plain path's top-2 gap is below 1e-2 (the bf16 rule), or
    where a full forward of the common prefix routes some token otherwise
    on the two paths and the first such choice is a near-tie (the plain
    path's k-th and (k+1)-th gates within 2^-6 of each other, relative: two
    bf16 steps). Any other split fails."""
    splits = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        split = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        gap = top2_gap_at(plain_engine, prompt_list[i], split, MOE_NEW)
        flip = first_flip(kernel_model, plain_model, prompt_list[i] + b[:split]) if gap >= GAP_LIMIT_BF16 else None
        near_tie = flip is not None and flip["plain_margin"] <= flip["gate"] * 2 ** -6
        print(f"sparse bf16 stream {i} splits at token {split}: plain top-2 gap {gap:.3e}; first routing "
              f"difference {flip}")
        if gap >= GAP_LIMIT_BF16 and not near_tie:
            raise AssertionError(f"sparse bf16 stream {i} disagrees with the plain path at token {split} (gap "
                                 f"{gap:.3e}) with no near-tied expert choice to explain it ({flip})")
        splits.append({"request": i, "split": split, "plain_top2_gap": gap, "first_flip": flip})
    return splits


def moe_serving(config, params, device) -> dict:
    """(c) Serving the sparse model: bf16 (int8 pool) and f32 (f32 pool)
    against the plain path's engine (``impl="reference"``) on the same
    schedule; a decode burst beside the dense GPT-2-small's."""
    from unionml_tpu_torch.models import init_gpt, random_params

    payloads = moe_payloads(config.vocab_size)
    prompt_list = [p["prompt_ids"] for p in payloads]
    out = {}
    for dtype, quant in ((torch.bfloat16, "int8"), (torch.float32, None)):
        arms, models = {}, {}
        for impl in ("auto", "reference"):
            cfg = dataclasses.replace(config, dtype=dtype, attention_impl=impl, paged_attn_impl=impl)
            models[impl] = init_gpt(cfg, params=params, device=device)
            arms[impl] = moe_serve_arm(models[impl], device, quant, payloads)
        kernel, plain = arms["auto"], arms["reference"]
        label = f"MoE serving {str(dtype)[6:]}"
        if dtype == torch.bfloat16:
            splits = moe_bf16_splits(models["auto"], models["reference"], kernel["streams"], plain["streams"],
                                     plain["engine"], prompt_list)
        else:
            splits = pc_compare(label, kernel["streams"], plain["streams"], plain["engine"], prompt_list,
                                "identical")
        if device.type == "cuda" and not all(kernel["launches"].get(k) for k in ("flash_fwd", "paged_attention")):
            raise AssertionError(f"{label}: launches {kernel['launches']}")
        if kernel["hits"] < 2 * MOE_REQUESTS - 1 or kernel["speculation"]["rounds"] == 0:
            raise AssertionError(f"{label}: prefix hits {kernel['hits']}, speculation {kernel['speculation']}")
        if any(len(s) != MOE_NEW for s in kernel["streams"]):
            raise AssertionError(f"{label}: stream lengths {[len(s) for s in kernel['streams']]}")
        rec = {k: v for k, v in kernel.items() if k != "engine"}
        rec["splits"] = splits
        rec["ttft_p50_p95_ms"] = [float(np.percentile(kernel["ttft_ms"][1:], q)) for q in (50, 95)]
        out[str(dtype)] = rec
        del arms, models, kernel, plain
        torch.cuda.empty_cache()
    sparse = init_gpt(config, params=params, device=device)
    out["burst_moe"] = moe_burst(sparse, device, prompt_list)
    expert_bytes = sum(layer.moe_mlp.w_in.numel() + layer.moe_mlp.w_out.numel()
                       for layer in sparse.layers if layer.use_moe) * config.dtype.itemsize
    del sparse
    dense_cfg = dataclasses.replace(config, moe_every=0)  # the dense model of the same widths
    dense = init_gpt(dense_cfg, params=random_params(dense_cfg, seed=0), device=device)
    out["burst_dense"] = moe_burst(dense, device, prompt_list)
    del dense
    out["expert_bytes"] = expert_bytes
    out["expert_floor_ms"] = expert_bytes / HBM_BYTES_PER_S * 1e3
    return out


def moe_phase(device, config=None) -> dict:
    """The sparse GPT (phase 17, see the module docstring)."""
    from unionml_tpu_torch.models import random_params

    t0 = time.perf_counter()
    config = config or moe_config()
    params = random_params(config, seed=0)
    out, parts = {}, {}
    for name, fn, args in (("layer", moe_layer_parity, (config, device)), ("train", moe_train, (config, params, device)),
                           ("serving", moe_serving, (config, params, device))):
        t = time.perf_counter()
        out[name] = fn(*args)
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t
    launches = {}
    for part in (out["train"]["launches"], out["serving"][str(torch.bfloat16)]["launches"]):
        for name, count in part.items():
            launches[name] = launches.get(name, 0) + count
    out["launches"], out["parts_s"], out["s"] = launches, parts, time.perf_counter() - t0
    return out


# ---------------------------------- phase 18: int8 weights and the dense engine

#: GPT-2 small's parameter bytes as stored with every decoder kernel int8 (its
#: per-output f32 scales included), and at f32 (``quantized_bytes``)
QW_BYTES = (243_287_040, 497_759_232)
DI_KW = dict(num_slots=8, max_len=1024, prefill_chunk=PREFILL_CHUNK, prefill_batch=1, seed=0)
DI_BURSTS = 20  # profiled 1-step bursts per burst reading
DI_PREFIX = 9  # requests on the 384-token system prompt: the first misses, 8 hit


def di_model(config, params, device, impl: str = "auto"):
    from unionml_tpu_torch.models import init_gpt

    return init_gpt(dataclasses.replace(config, attention_impl=impl, paged_attn_impl=impl), params=params,
                    device=device)


def di_engine(model, device, **kw):
    """Phase 5's engine shape, one prompt per prefill dispatch (phase 12's
    reason: a bucket prefill's products round by their row count), in the
    mode ``kw`` names."""
    from unionml_tpu_torch.serving.continuous import DecodeEngine

    return DecodeEngine(model, device=device, **dict(DI_KW, **kw))


def checksum(model) -> tuple:
    """(parameter dtypes, f64 sum of every parameter, layer types)."""
    with torch.no_grad():
        return (sorted({str(p.dtype) for p in model.parameters()}),
                float(sum(p.double().sum() for p in model.parameters())),
                sorted({type(m).__name__ for m in model.modules()}))


def di_serve(engine, prompt_list, device, tally: dict = None, profile: bool = False) -> dict:
    """Phase 5's 10 requests through ``ContinuousBatcher`` after a warm-up
    request; the measured pass's launches are added to ``tally``. With
    ``profile``, a second (warm) pass in a CUDA profile gives tokens/s and
    TTFT with every graph captured, and the device's busy time against the
    pass's wall (its idle share)."""
    from unionml_tpu_torch import kernels

    serve(engine, [prompt_list[0]], device)
    kernels.reset_launches()
    streams, ttft, wall = serve(engine, prompt_list, device)
    launches = dict(kernels.launches)
    for name, count in launches.items():
        if tally is not None:
            tally[name] = tally.get(name, 0) + count
    for i, s in enumerate(streams):
        if len(s) != MAX_NEW or min(s) < 0 or max(s) >= engine._config.vocab_size:
            raise AssertionError(f"request {i}: bad stream {s}")
    rec = {"streams": streams, "ttft_ms": [t * 1e3 for t in ttft], "wall_s": wall, "launches": launches,
           "tokens_per_s": sum(map(len, streams)) / wall}
    if profile:
        prof, (warm, warm_ttft, warm_wall) = cuda_profile(lambda first: serve(engine, prompt_list, device))
        busy = busy_union(prof)["union_ms"]
        rec["warm"] = {"tokens_per_s": sum(map(len, warm)) / warm_wall, "ttft_ms": [t * 1e3 for t in warm_ttft],
                       "wall_ms": warm_wall * 1e3, "device_busy_ms": busy,
                       "device_idle_share": 1.0 - busy / (warm_wall * 1e3)}
    return rec


def di_gate(label, got, want, engines, prompt_list, dtype, exact: bool = False, reference=None) -> list:
    """Greedy streams ``got`` of ``engines[0]`` against ``want`` of
    ``engines[1]`` (the sampled request left out); ``engines[2]``, the plain
    path, gives each split's top-2 gap. ``exact``: identical. f32: splits
    only where that gap is below 1e-5 (phase 12's rule). bf16: below 1e-2
    (PERF.md section 2), or, at a larger gap, where the choice lies inside
    bf16 rounding: at the split (each engine on the common prefix) the plain
    path's logits sit at least half the gap from those of ``reference()``,
    the plain path at f32, and the two compared engines' no farther than
    twice the plain path's."""
    splits, ref = [], None
    for i, (_, sampling) in enumerate(REQUESTS):
        a, b = got[i], want[i]
        if sampling is not None or a == b:
            continue
        if exact:
            raise AssertionError(f"{label}: stream {i} differs (identical required)")
        split = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        rec = {"request": i, "split": split, "plain_top2_gap": top2_gap_at(engines[2], prompt_list[i], split)}
        limit = GAP_LIMIT_BF16 if dtype == torch.bfloat16 else GAP_LIMIT_F32
        if rec["plain_top2_gap"] >= limit:
            if dtype != torch.bfloat16:
                raise AssertionError(f"{label}: stream {i} splits at token {split}, gap {rec['plain_top2_gap']:.3e}")
            ref = reference() if ref is None else ref
            exact_logits = logits_at(ref, prompt_list[i], split)
            noise, got_err, want_err = (float((logits_at(e, prompt_list[i], split) - exact_logits).abs().max())
                                        for e in (engines[2], engines[0], engines[1]))
            rec.update(plain_bf16_vs_f32=noise, got_vs_f32=got_err, want_vs_f32=want_err)
            if rec["plain_top2_gap"] > 2 * noise or max(got_err, want_err) > 2 * noise:
                raise AssertionError(f"{label}: stream {i} splits at token {split} outside bf16 rounding: {rec}")
        print(f"{label}: {rec}")
        splits.append(rec)
    return splits


def graph_pools() -> dict:
    """Bytes of device memory by CUDA-graph private pool (the caching
    allocator's snapshot; the default pool left out)."""
    pools = {}
    for segment in torch.cuda.memory_snapshot():
        pool = tuple(segment.get("segment_pool_id", (0, 0)))
        if pool != (0, 0):
            pools[pool] = pools.get(pool, 0) + segment["total_size"]
    return pools


def di_burst(engine, prompt_list) -> dict:
    """A 1-step decode burst replayed with 8 slots decoding: wall against
    device ms and top kernels (``step_profile``), and the device memory of
    the private pool the engine's first burst graph was recorded into."""
    short = [p for p in prompt_list if len(p) <= PREFILL_CHUNK][: engine.num_slots]
    short += short[: engine.num_slots - len(short)]
    engine.admit_many([(p, 400) for p in short])
    before = graph_pools()
    engine.step()  # the capture
    graph_mb = sum(size for pool, size in graph_pools().items() if pool not in before) / 2**20
    for _ in range(2):
        engine.step()
    result = step_profile(engine.step, DI_BURSTS, top=8)
    engine.abort_all()
    return {"graph_pool_mb": graph_mb, **result}


def logit_gap(full_model, int8_model, prompt_list) -> float:
    """The largest |logit| difference, full-precision against int8 weights,
    at each prompt's first decode step (its last prompt position)."""
    worst = 0.0
    with torch.no_grad():
        for prompt in prompt_list:
            ids = torch.tensor([prompt], device=full_model.device)
            worst = max(worst, float((full_model(ids)[0, -1] - int8_model(ids)[0, -1]).abs().max()))
    return worst


def greedy_equal(a, b) -> int:
    return sum(a[i] == b[i] for i, (_, sampling) in enumerate(REQUESTS) if sampling is None)


def int8_weights(config, params, device, prompt_list, tally: dict) -> dict:
    """Part (a): weight-only int8, bf16 over the int8 pool and f32 over an
    f32 pool (see the module docstring, phase 18)."""
    from unionml_tpu_torch.models._layers import QuantizedLinear
    from unionml_tpu_torch.ops import quantized_bytes
    from unionml_tpu_torch.serving.speculative import SpeculativeEngine

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(config, dtype=dtype)
        quant = "int8" if dtype == torch.bfloat16 else None
        model = di_model(cfg, params, device)
        before = checksum(model)
        engine = di_engine(model, device, quantize="int8", kv_quantize=quant)
        stored = quantized_bytes(engine._variables)
        if stored != QW_BYTES or not isinstance(engine._model.layers[0].qkv, QuantizedLinear):
            raise AssertionError(f"{dtype} int8 weights: quantized_bytes {stored}, expected {QW_BYTES}")
        got = di_serve(engine, prompt_list, device, tally if dtype == torch.bfloat16 else None,
                       profile=dtype == torch.bfloat16)
        k1, k4 = got["launches"]["flash_fwd"], got["launches"]["paged_attention"]
        if device.type == "cuda" and dtype == torch.bfloat16 and (k1 == 0 or k4 == 0):
            raise AssertionError(f"int8 weights: K1 and K4 must launch, {got['launches']}")
        plain = di_engine(di_model(cfg, params, device, "reference"), device, quantize="int8", kv_quantize=quant)
        want = di_serve(plain, prompt_list, device)
        f32 = dataclasses.replace(config, dtype=torch.float32)
        reference = lambda: di_engine(di_model(f32, params, device, "reference"), device, quantize="int8")  # noqa: E731
        splits = di_gate(f"{dtype} int8 weights vs plain", got["streams"], want["streams"], (engine, plain, plain),
                         prompt_list, dtype, exact=dtype == torch.float32, reference=reference)
        del plain
        full = di_serve(di_engine(model, device, kv_quantize=quant), prompt_list, device,
                        profile=dtype == torch.bfloat16)
        rec = out[str(dtype)] = {
            "quantized_bytes": stored, "splits": splits, "launches": got["launches"],
            "tokens_per_s": got["tokens_per_s"], "full_tokens_per_s": full["tokens_per_s"],
            "warm": {"int8": got.get("warm"), "full": full.get("warm")},
            "greedy_equal_to_full_weights": greedy_equal(got["streams"], full["streams"]),
            "first_step_logit_gap": logit_gap(model, engine._model, prompt_list),
        }
        del engine
        torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            sp = spec_prompts(config.vocab_size)
            vanilla = vanilla_engine(model, device, quantize="int8")
            spec = SpeculativeEngine(model, model, gamma_max=SPEC_GAMMA_MAX, quantize="int8", device=device,
                                     **SPEC_ENGINE_KW)
            batch_serve(vanilla, sp[:1], {}, device)
            van, _ = batch_serve(vanilla, sp, {}, device)
            batch_serve(spec, sp[:1], {"speculative": True}, device)
            spec_streams, _ = batch_serve(spec, sp, {"speculative": True}, device)
            rec["spec_splits"] = gated_splits("bf16 int8 self-draft vs vanilla int8", spec_streams, van, vanilla, sp,
                                              GAP_LIMIT_BF16)
            rec["speculation"] = spec.speculation_stats()
            del spec, vanilla
            torch.cuda.empty_cache()
            # one call, both arms in turns: full precision, int8, int8, full precision
            rec["burst"] = [(q or "none", di_burst(vanilla_engine(model, device, quantize=q), prompt_list))
                            for q in (None, "int8", "int8", None)]
        if checksum(model) != before:
            raise AssertionError(f"{dtype}: the caller's model changed: {before} -> {checksum(model)}")
        del model
        torch.cuda.empty_cache()
    return out


def dense_engine(config, params, device, prompt_list, tally: dict) -> dict:
    """Part (b): the dense engine (``paged=False``), bf16 and f32 (see the
    module docstring, phase 18)."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(config, dtype=dtype)
        model = di_model(cfg, params, device)
        engine = di_engine(model, device, paged=False)
        got = di_serve(engine, prompt_list, device, tally if dtype == torch.bfloat16 else None,
                       profile=dtype == torch.bfloat16)
        if (device.type == "cuda" and got["launches"]["flash_fwd"] == 0) or got["launches"]["paged_attention"]:
            raise AssertionError(f"{dtype} dense: K1 must launch and K4 never, {got['launches']}")
        plain = di_engine(di_model(cfg, params, device, "reference"), device, paged=False)
        want = di_serve(plain, prompt_list, device)
        paged = di_engine(model, device)  # a pool of the compute dtype
        pgot = di_serve(paged, prompt_list, device, profile=dtype == torch.bfloat16)
        f32 = dataclasses.replace(config, dtype=torch.float32)
        reference = lambda: di_engine(di_model(f32, params, device, "reference"), device, paged=False)  # noqa: E731
        rec = out[str(dtype)] = {
            "vs_plain": di_gate(f"{dtype} dense vs plain", got["streams"], want["streams"], (engine, plain, plain),
                                prompt_list, dtype, reference=reference),
            "vs_paged": di_gate(f"{dtype} dense vs paged", got["streams"], pgot["streams"], (engine, paged, plain),
                                prompt_list, dtype, reference=reference),
            "launches": got["launches"], "tokens_per_s": {"dense": got["tokens_per_s"], "paged": pgot["tokens_per_s"]},
            "ttft_ms": {"dense": got["ttft_ms"], "paged": pgot["ttft_ms"]},
            "warm": {"dense": got.get("warm"), "paged": pgot.get("warm")},
        }
        if dtype == torch.bfloat16:
            steady(engine, prompt_list, {})
            rec["memcpy_htod_5_bursts"] = count_htod(engine.step, 5)
            if rec["memcpy_htod_5_bursts"]:
                raise AssertionError(f"dense: {rec['memcpy_htod_5_bursts']} Memcpy HtoD in 5 steady bursts")
        del engine, plain, paged
        torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            # fresh engines, so each arm's first reading measures its capture
            fresh = {"dense": di_engine(model, device, paged=False), "paged": di_engine(model, device)}
            rec["burst"] = [(label, di_burst(fresh[label], prompt_list))
                            for label in ("dense", "paged", "paged", "dense")]
            del fresh
        else:
            rec["prefix"] = dense_prefix(model, device)
        del model
        torch.cuda.empty_cache()
    return out


def dense_prefix(model, device) -> dict:
    """The dense engine's prefix pool at f32: 9 requests on a 384-token
    system prompt with the cache on and off, then 2 preemptions and resumes
    against the same requests uninterrupted (``pc_preempt``)."""
    vocab = model.config.vocab_size
    prompt_list = pc_prompts(vocab, n=DI_PREFIX)
    on = di_engine(model, device, paged=False, prefix_cache_blocks=PC_BLOCKS)
    off = di_engine(model, device, paged=False)
    for engine in (on, off):  # warm-up: graphs, cuBLAS handles
        stream_after(engine, [], [[7] * 20], device)
    before = {e: (e.prefill_tokens_computed, e.prefix_restore_dispatches, e.prefix_save_dispatches)
              for e in (on, off)}
    got, _, _ = stream_after(on, prompt_list[:1], prompt_list[1:], device)
    want, _, _ = stream_after(off, prompt_list[:1], prompt_list[1:], device)
    counts = {name: [e.prefill_tokens_computed - before[e][0], e.prefix_restore_dispatches - before[e][1],
                     e.prefix_save_dispatches - before[e][2]] for name, e in (("on", on), ("off", off))}
    splits = gated_splits("f32 dense prefix cache on vs off", got, want, off, prompt_list, GAP_LIMIT_F32)
    stats = on.prefix_cache.stats()
    if stats["hits"] != DI_PREFIX - 1 or leaked(on) != (0, 0, 0):
        raise AssertionError(f"f32 dense prefix cache: {stats}, leaks {leaked(on)}")
    del off
    preempt = pc_preempt(on, prompt_list, "identical")
    return {"prefill_restore_save": counts, "stats": stats, "splits": splits, "preempt": preempt}


def dense_int8_phase(device, config=None) -> dict:
    """Weight-only int8 and the dense engine (phase 18, see the module docstring)."""
    from unionml_tpu_torch.models import GPTConfig, random_params

    t0 = time.perf_counter()
    config = config or GPTConfig()
    params = random_params(config, seed=0)  # phase 5's weights
    prompt_list = prompts(config.vocab_size)
    launches, out, parts = {}, {}, {}
    for name, fn in (("int8", int8_weights), ("dense", dense_engine)):
        t = time.perf_counter()
        out[name] = fn(config, params, device, prompt_list, launches)
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t
    out["launches"], out["parts_s"], out["s"] = launches, parts, time.perf_counter() - t0
    return out


def report_warm(warm: dict, label: str, name_limit: str) -> None:
    for arm, w in warm.items():
        if w is not None:
            print(f"[{name_limit}] {label}, warm pass, {arm}: {w['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                  f"{np.median(w['ttft_ms']):.1f} ms, {w['wall_ms']:.1f} ms wall on {w['device_busy_ms']:.1f} ms of "
                  f"device time (idle share {w['device_idle_share']:.3f})")


def report_dense_int8(di: dict, name_limit: str) -> None:
    """Print phase 18's results (``dense_int8_phase``'s record)."""
    for dtype, r in di["int8"].items():
        pool = "int8 pool" if "bfloat16" in dtype else "f32 pool"
        print(f"[{name_limit}] int8 weights {dtype[6:]} ({pool}): quantized_bytes {r['quantized_bytes']} (stored, "
              f"full); streams vs plain ok, splits {r['splits']}; launches {r['launches']}; {r['tokens_per_s']:.1f} "
              f"tokens/s against {r['full_tokens_per_s']:.1f} with full-precision weights; greedy streams equal to "
              f"full-precision weights {r['greedy_equal_to_full_weights']}/9; first-step logit gap "
              f"{r['first_step_logit_gap']:.4f}; the caller's model unchanged")
        report_warm(r["warm"], f"int8 weights {dtype[6:]}", name_limit)
        if "burst" in r:
            s = r["speculation"]
            print(f"[{name_limit}] int8 self-draft speculation vs vanilla int8: ok, splits {r['spec_splits']}; "
                  f"accepted per target step {s['accepted_per_target_step']}")
            for q, b in r["burst"]:
                print(f"[{name_limit}] bf16 1-step 8-slot burst, weights {q}: {b['wall_ms_per_step']:.3f} ms wall, "
                      f"{b['device_ms_per_step']:.3f} ms device, idle {b['device_idle_share']:.3f}, first graph's pool "
                      f"{b['graph_pool_mb']:.1f} MiB; top {b['top_kernels_ms_per_step']}")
    for dtype, r in di["dense"].items():
        tps, ttft = r["tokens_per_s"], r["ttft_ms"]
        print(f"[{name_limit}] dense engine {dtype[6:]}: vs plain ok (splits {r['vs_plain']}), vs paged ok (splits "
              f"{r['vs_paged']}); launches {r['launches']}; tokens/s dense {tps['dense']:.1f} paged "
              f"{tps['paged']:.1f}; TTFT p50 dense {np.median(ttft['dense']):.1f} paged "
              f"{np.median(ttft['paged']):.1f} ms")
        report_warm(r["warm"], f"dense engine {dtype[6:]}", name_limit)
        if "burst" in r:
            print(f"dense bf16: Memcpy HtoD in 5 steady bursts {r['memcpy_htod_5_bursts']}")
            for label, b in r["burst"]:
                print(f"[{name_limit}] bf16 1-step 8-slot burst, {label}: {b['wall_ms_per_step']:.3f} ms wall, "
                      f"{b['device_ms_per_step']:.3f} ms device, idle {b['device_idle_share']:.3f}, first graph's pool "
                      f"{b['graph_pool_mb']:.1f} MiB; top {b['top_kernels_ms_per_step']}")
        if "prefix" in r:
            p = r["prefix"]
            print(f"dense f32 prefix cache ({DI_PREFIX} requests on a {PC_SYSTEM}-token prompt): [prefill tokens, "
                  f"restores, saves] {p['prefill_restore_save']}, hits {p['stats']['hits']}, splits {p['splits']}; "
                  f"preempt/resume identical, resume prefill tokens {p['preempt']['resume_prefill_tokens']}")
    print(f"phase 18 launches {di['launches']}; phase 18 took {di['s']:.1f} s "
          f"({ {k: round(v, 1) for k, v in di['parts_s'].items()} })")


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


def report_moe(moe: dict, name_limit: str) -> None:
    """Print phase 17's results (``moe_phase``'s record)."""
    for dtype, rec in moe["layer"].items():
        for shape, r in rec.items():
            drops = (f", {r['dropped']} of {r['choices']} choices dropped at capacity {r['capacity']} "
                     f"({r['dropped_first_choices']} first choices), dropped set equal to the plain version's"
                     if "dropped" in r else "")
            fwd = (f"; forward {r['forward_ms']['index']:.3f} ms by index against {r['forward_ms']['one_hot']:.3f} "
                   "ms by one-hot einsums" if "forward_ms" in r else "")
            print(f"[{name_limit}] MoEMlp {dtype[6:]} {shape} vs the one-hot plain version (f32): max |err| "
                  f"{r['max_abs_err']:.3e}{drops}{fwd}")
    tr = moe["train"]
    prof = tr["step_profile"]
    print(f"[{name_limit}] sparse GPT-2-small (6 of 12 blocks MoE, 8 experts, top-2, capacity 1.25) through "
          f"Model.train: {tr['steps']} steps of fit_lm(moe_aux=True, pack=True) at B{LM_BATCH} S{MOE_SEQ}, launches "
          f"{tr['launches']}, loss by step {[(h['step'], round(h['loss'], 4)) for h in tr['history']]}, metrics "
          f"{tr['metrics']}; router losses {tr['aux']:.5f} weighted (per layer {tr['aux_by_layer']})")
    print(f"[{name_limit}] sparse LM train step: {tr['step_ms']:.2f} ms wall in fit; profiled "
          f"{prof['wall_ms_per_step']:.2f} ms wall, {prof['device_ms_per_step']:.2f} ms device kernels, device idle "
          f"share {prof['device_idle_share']:.3f}; top kernels {prof['top_kernels_ms_per_step']}")
    print(f"sparse LM first 3 steps, kernels vs plain path: {tr['first_steps_vs_plain']}; Model.predict (generate, "
          f"dropless) equal to generate called directly: {tr['predicted']}")
    sv = moe["serving"]
    for dtype in (str(torch.bfloat16), str(torch.float32)):
        r = sv[dtype]
        print(f"[{name_limit}] sparse /generate {dtype[6:]} ({'int8' if 'bfloat16' in dtype else 'f32'} pool, "
              f"{MOE_REQUESTS} requests sharing a {MOE_SYSTEM}-token prompt, {MOE_NEW} new tokens, lookahead "
              f"{MOE_LOOKAHEAD}, self-draft speculation for the interactive one): warm pass {r['tokens_per_s']:.1f} "
              f"tokens/s, TTFT p50/p95 {r['ttft_p50_p95_ms'][0]:.1f}/{r['ttft_p50_p95_ms'][1]:.1f} ms (the 7 after the "
              f"first; cold pass {r['cold_tokens_per_s']:.1f} tokens/s), "
              f"hits {r['hits']}, speculation rounds {r['speculation']['rounds']} accepted {r['speculation']['accepted']}"
              f", graph replays {r['graph_replays']}, launches {r['launches']}; streams vs plain: "
              f"{'identical' if 'float32' in dtype else 'splits ' + str(r['splits'])}")
    for label in ("burst_moe", "burst_dense"):
        b = sv[label]
        print(f"[{name_limit}] {'sparse' if label == 'burst_moe' else 'dense'} GPT-2-small decode burst (1 step, 8 "
              f"slots, int8 pool): {b['wall_ms_per_step']:.3f} ms wall, {b['device_ms_per_step']:.3f} ms device "
              f"kernels, idle share {b['device_idle_share']:.3f}; top kernels {b['top_kernels_ms_per_step']}")
    print(f"[{name_limit}] expert weights {sv['expert_bytes'] / 1e6:.1f} MB bf16: a dropless step reads them all, "
          f"floor {sv['expert_floor_ms']:.4f} ms at 3.35 TB/s; phase 17 took {moe['s']:.1f} s "
          f"({ {k: round(v, 1) for k, v in moe['parts_s'].items()} }), launches {moe['launches']}")


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
    torch.cuda.empty_cache()
    details["speculation"] = spec = speculation(device)
    for dtype, r in spec.items():
        for label in ("self", "2-layer"):
            if label not in r:
                continue
            rec = r[label]
            print(f"[{name_limit}] speculation {dtype} {label}-draft (gamma_max {SPEC_GAMMA_MAX}): "
                  f"{rec['tokens_per_s']:.1f} tok/s against vanilla {r['vanilla_tokens_per_s']:.1f}, "
                  f"{rec['tokens_per_round']:.2f} tokens per round, stats {rec['stats']}, launches {rec['launches']}, "
                  f"graph replays {rec['graph_replays']}, splits from vanilla {rec['splits']} "
                  f"(gate {GAP_LIMIT_BF16 if dtype == str(torch.bfloat16) else GAP_LIMIT_F32})")
        print(f"speculation {dtype}: pipelined vanilla streams equal unpipelined ones")
    bf = spec[str(torch.bfloat16)]
    check = bf["self"]["verify_vs_plain"]
    print(f"speculation: sampled streams (temperature 0.8, seeds 1 and 3) equal with speculation on and off; "
          f"verify chunk vs plain in one eager round: {check['layers']} layers, max |err| {check['max_abs_err']:.3e} "
          "(K4 tolerance); one round's K4 kernels "
          f"{check['k4_kernel_names']}; Memcpy HtoD over 5 steady rounds {check['memcpy_htod_5_rounds']}; the draft "
          f"prefill's K1 {check['draft_prefill_k1']}")
    tm = bf["timings"]
    for label in ("round", "decode_step_pipelined", "decode_step_unpipelined"):
        st = tm[label]
        print(f"[{name_limit}] bf16 {label.replace('_', ' ')} (8 slots): {st['wall_ms_per_step']:.3f} ms wall, "
              f"{st['device_ms_per_step']:.3f} ms device kernels, idle share {st['device_idle_share']:.3f}; "
              f"top kernels {st['top_kernels_ms_per_step']}")
    print(f"Memcpy HtoD over 5 steady decode bursts: {tm['memcpy_htod_5_bursts']}")
    vp = tm["verify_products"]
    print(f"[{name_limit}] verify of 8 rows x {SPEC_GAMMA_MAX + 1} tokens: logits bitwise equal to decoding the tokens "
          f"one at a time with each position's products at the decode step's 8 rows ({vp['per_position_ms']:.3f} ms "
          f"device per verify forward), the commit's codes and scales bitwise those of the decode appends; "
          f"batched over the chunk (40 rows) the logits would differ by up to "
          f"{vp['batched_max_logit_diff']:.3e} ({vp['batched_ms']:.3f} ms)")
    kv = tm["k4_verify"]
    print(f"[{name_limit}] {kv['name']} {kv['shape']}: {kv['ms']:.4f} ms per call (bound {kv['bound_ms']:.5f} ms by "
          f"{kv['bound_by']}), plain {kv['plain_ms']:.4f} ms, gather + SDPA {kv['library_ms']:.4f} ms, "
          f"{kv['launches']} launches per round (counted in an eager round; the whole replayed round launched "
          f"{tm['round_launches']}); the local gather of the rows' blocks + one append per leaf "
          f"{kv['gather_append_ms_per_layer']:.4f} ms device per layer [{kv['method']}]")
    details["extra_timings"].append(kv)

    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    details["prefix_cache"] = pc = prefix_cache_phase(device)
    for dtype, r in pc.items():
        for key in ("shared", "shared_exact"):
            if key not in r:
                continue
            sh = r[key]
            how = ("exact paths (chunks of 64, buckets from 64): identical required" if key == "shared_exact" else
                   "identical required" if dtype == str(torch.float32) else "splits reported with the off path's gap")
            print(f"[{name_limit}] prefix cache {dtype} ({how}): {PC_REQUESTS} requests sharing a {PC_SYSTEM}-token "
                  f"system prompt: hits {sh['stats']['hits']}, hit tokens {sh['stats']['hit_tokens']}, prefill tokens "
                  f"computed {sh['prefill_tokens']['on']} on vs {sh['prefill_tokens']['off']} off; tokens/s "
                  f"{sh['tokens_per_s']['on']:.1f} on vs {sh['tokens_per_s']['off']:.1f} off; TTFT p50/p90 hit "
                  f"{np.percentile(sh['ttft_ms']['hit'], 50):.1f}/{np.percentile(sh['ttft_ms']['hit'], 90):.1f} ms, "
                  f"miss {np.percentile(sh['ttft_ms']['miss'], 50):.1f}/{np.percentile(sh['ttft_ms']['miss'], 90):.1f} "
                  f"ms (23 queued at once after the first, a miss alone: {sh['ttft_ms']['first_miss']:.1f} ms); "
                  f"streams on vs off: splits {sh['splits']}; K4 launches {sh['launches']['paged_attention']}")
        mt = r["multi_turn"]
        print(f"[{name_limit}] prefix cache {dtype} multi-turn: {mt['hits']} follow-ups hit {mt['hit_tokens']} tokens "
              f"(turns' full blocks {mt['turn_blocks_tokens']}); on vs off splits {mt['splits']}")
        pr = r["preempt"]
        print(f"preempt/resume {dtype}: 2 slots preempted after 8 tokens, transcripts {pr['transcripts']} tokens with "
              f"{pr['pinned_blocks']} pinned blocks, the resumes prefilled {pr['resume_prefill_tokens']} tokens; "
              f"joined streams vs uninterrupted splits {pr['splits']}; no block leaked")
        rc = r["recovery"]
        print(f"[{name_limit}] recovery {dtype}: dispatch {rc['fault_dispatch']} failed in steady decode of 8 streams "
              f"(the sampled had delivered {rc['sampled_tokens_before_fault']} tokens); "
              f"rebuild {rc['rebuild_ms']:.2f} ms + recapture of {rc['graphs_recaptured']} graphs "
              f"{rc['recapture_ms']:.1f} ms; greedy splits vs fault-free {rc['splits']}; the 2 sampled streams bitwise "
              f"equal; supervisor {rc['supervisor']}; robustness {rc['robustness']}")
    bf = pc[str(torch.bfloat16)]
    sh = bf["shared"]
    for label in ("hit_admission", "miss_admission"):
        a = sh[label]
        print(f"[{name_limit}] one {label.replace('_', ' ')} (bf16, until the slot decodes): {a['wall_ms']:.3f} ms "
              f"wall, {a['device_ms']:.3f} ms device kernels; K4 {a['k4_launches']} launches, kernels {a['k4_kernels']}")
    hv = sh["hit_vs_plain"]
    print(f"K4 hit prefill vs plain (S {hv['S']} at base {hv['base']}, every layer): ok, max |err| "
          f"{hv['max_abs_err']:.3e} (K4 tolerance)")
    for r in sh["k4_hit"]:
        rounds = ", ".join(f"{x['ms']:.4f} ms at {x['sm_clock_mhz']} MHz from {x['recorded_launches']} recorded "
                           f"launches of 20" for x in r["rounds"])
        print(f"[{name_limit}] {r['name']} {r['shape']}: {r['ms']:.4f} ms, the median of {len(r['rounds'])} rounds "
              f"after a load of the same launches ({rounds}; the first reading, before any load: "
              f"{r['first_ms']:.4f} ms; 20 launches in one CUDA graph: {r['graph_ms']:.4f} ms each; over fresh "
              f"copies of the leaves: {r['fresh_copy_ms']:.4f} ms) (bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}), plain {r['plain_ms']:.4f} ms, gather + SDPA {r['library_ms']:.4f} ms "
              f"[{r['method']}; kernels {sorted(r['kernel_by_name_ms'])}]")
        details["extra_timings"].append(r)
    sp = bf["speculation"]
    print(f"[{name_limit}] speculation over the cache (self-draft, bf16): {sp['hits']} hits, {sp['draft_prefills']} "
          f"draft prefills, accepted per target step {sp['stats']['accepted_per_target_step']}, splits from vanilla "
          f"{sp['splits']}")
    nan = bf["recovery"]["nan"]
    print(f"NaN fault on slot {nan['slot']}: quarantined ({nan['quarantined']}), {nan['siblings_bitwise']} sibling "
          f"streams bitwise equal to the run without it; Memcpy HtoD over 5 steady bursts with the cache on: "
          f"{bf['memcpy_htod_5_bursts']}; phase 13 took {time.perf_counter() - t13:.1f} s")

    torch.cuda.empty_cache()
    details["slo"] = slo = slo_phase(device)
    for key in ("mix_bf16", "mix_f32"):
        mix = slo[key]
        for arm in ("scheduler", "fifo"):
            r = mix[arm]
            print(f"[{name_limit}] SLO mix {key[4:]} {arm} ({mix['n_batch']} batch x {SLO_BATCH_NEW} tokens, "
                  f"{SLO_INTER} interactive x {SLO_INTER_NEW}, lookahead {SLO_LOOKAHEAD}): TTFT interactive "
                  f"{r['ttft']['interactive']}, batch {r['ttft']['batch']}; ITL interactive {r['itl']['interactive']}, "
                  f"batch {r['itl']['batch']}; preemptions {r['preemptions']}, resumes {r['resumes']}, sheds "
                  f"{r['sheds']}, deadline misses {r['deadline_misses']}, queue-wait EMA {r['queue_wait_ema_ms']} ms "
                  f"by class {r['queue_wait_ema_ms_by_class']}; launches K1 {r['launches']['flash_fwd']}, K4 "
                  f"{r['launches']['paged_attention']}; {r['total_s']:.3f} s")
        print(f"[{name_limit}] SLO mix {key[4:]}: interactive p95 TTFT FIFO / scheduler "
              f"{mix['interactive_p95_ttft_fifo_over_scheduler']:.2f}; streams across the arms: "
              f"{'splits ' + str(mix['splits']) if key == 'mix_bf16' else 'identical'}")
    ct = slo["contract"]
    print(f"[{name_limit}] SLO contract (plain route functions, 8 hogs of {HOG_NEW} tokens, queue bound 2): queue full -> "
          f"{ct['queue_full']['status']} {ct['queue_full']['reason']} retry_after_ms "
          f"{ct['queue_full']['retry_after_ms']}; displaced -> {ct['displaced']}; deadline queued -> "
          f"{ct['queued_deadline']}, running -> {ct['running_deadline']}; infeasible -> {ct['infeasible']}; "
          f"invalid payloads -> {ct['invalid']}; streamed == whole; scheduler {ct['scheduler']}")
    sp = slo["speculation"]
    print(f"[{name_limit}] SLO speculation by class (self-draft, bf16): rounds {sp['rounds']}, splits from vanilla {sp['splits']}; "
          f"Memcpy HtoD over 5 steady bursts with the scheduler: {slo['memcpy_htod_5_bursts']}; "
          f"phase 14 took {slo['s']:.1f} s ({ {k: round(v, 1) for k, v in slo['parts_s'].items()} })")
    torch.cuda.empty_cache()
    details["telemetry"] = tm = telemetry_phase(device)
    print(f"telemetry on vs off (one fixed engine schedule, {tm['streams_identical']} greedy streams): identical; "
          f"K1/K4 launches equal {tm['launches']}; decode_fetch_ms observed {tm['fetch_observed']} of "
          f"{tm['bursts']} bursts; Memcpy HtoD over 5 steady bursts with telemetry on: {tm['memcpy_htod_5_bursts']}")
    print(f"[{name_limit}] replayed decode burst (8 slots, pipelined), wall ms per burst over {TEL_BURSTS} bursts "
          f"in the order off, on, on, off: off {[round(x, 4) for x in tm['burst_wall_ms']['off']]}, on "
          f"{[round(x, 4) for x in tm['burst_wall_ms']['on']]}")
    tt = tm["traces"]
    print(f"telemetry traces through the batcher: {tt['traces']} traces {tt['statuses']}, {tt['hits']} prefix hits; "
          f"preempted {tt['preempted_spans']}; quarantined {tt['quarantined_spans']}; counters equal to the "
          f"engine's own {tt['counters']}; /metrics {tt['metrics_bytes']} bytes ({tt['content_type']}); "
          f"phase 15 took {tm['s']:.1f} s")
    torch.cuda.empty_cache()
    details["fleet"] = fl = fleet_phase(device)
    ro = fl["routing"]
    print(f"[{name_limit}] fleet routing A/B ({FLEET_GROUPS} groups x {FLEET_PER_GROUP} requests sharing a "
          f"{PC_SYSTEM}-token prefix, {FLEET_NEW} new tokens, 2 replicas on one card, cold pass): prefix hit rate "
          f"affinity {ro['affinity']['cold_hit_rate']} > random {ro['random']['cold_hit_rate']}; one replica alone "
          f"{ro['single']['cold_hit_rate']}")
    for arm in ("affinity", "single"):
        w, pf = ro[arm]["warm"], ro[arm]["profiled"]
        print(f"[{name_limit}] fleet warm pass, {'2 replicas (affinity)' if arm == 'affinity' else '1 replica'}: "
              f"{w['tokens_per_s']:.1f} tokens/s ({w['wall_s']:.3f} s), TTFT interactive {w['ttft_ms']['interactive']}, "
              f"batch {w['ttft_ms']['batch']}; profiled pass {pf['wall_ms']:.1f} ms wall, {pf['events']} device events "
              f"{pf['sum_ms']:.1f} ms summed, {pf['union_ms']:.1f} ms as a union in time: device idle share "
              f"{pf['idle_share']:.4f} (by the sum {pf['idle_share_by_sum']:.4f}), overlap share "
              f"{pf['overlap_share']:.4f}")
    for rep, c in ro["affinity"]["coupling"].items():
        print(f"[{name_limit}] fleet {rep}: replayed burst (8 slots) {c['other_idle_ms']:.4f} ms wall with the other "
              f"replica idle, {c['other_busy_ms']:.4f} ms with it decoding on its own thread and stream")
    ex = fl["bf16_exact"]
    print(f"fleet bf16 parity at the exact-path configuration (chunks of 64), 2 replicas vs one supervised batcher: "
          f"{ex['identical']} of {FLEET_GROUPS * FLEET_EXACT_PER_GROUP} "
          f"streams identical, splits {ex['splits']} (gate {GAP_LIMIT_BF16} before a stream's first preemption; "
          f"preempted, request: tokens delivered {ex['preempted']}); at the served configuration (warm, report): "
          f"splits {ro['bf16_splits']}, preempted 2 replicas {ro['affinity']['preempted']}, 1 replica "
          f"{ro['single']['preempted']}")
    f32 = fl["f32"]
    for name in ("clean", "recapture", "death"):
        r = f32[name]
        print(f"fleet f32 {name} ({f32['requests']} requests): streams identical to one supervised batcher's; "
              f"fleet {r['fleet']}, states {r['states']}, engine failures {r['failures']}, rebuilds {r['rebuilds']}, "
              f"graphs captured {r['graph_captures']}, dropped {r['graphs_dropped']}, capture failures "
              f"{r['capture_failures']}; launches {r['launches']} (the per-thread tallies' sum, "
              f"{r['threads_launching_k4']} threads launched K4); no block left pinned")
    se = fl["sessions"]
    print(f"fleet sessions ({FLEET_SESSIONS} x {FLEET_TURNS} turns): (session, turn, replica, adopted by, prefill "
          f"tokens, message tokens) {[(t['session'], t['turn'], t['replica'], t['adopted_by'], t['prefill_tokens'], t['message']) for t in se['turns']]}; "
          f"{se['victim']} re-stuck to replica {se['restuck_to']}; fleet {se['fleet']}; K1 launches {se['k1_launches']}")
    sm = fl["sim"]
    print(f"[{name_limit}] fleet simulator fitted from the phase's journal ({sm['records']} records, replay "
          f"{sm['replay']}): {sm['fitted']}; simulated TTFT {sm['simulated']['ttft_ms']}, "
          f"{sm['simulated']['duration_s']} s, hit rate {sm['simulated']['router']}; measured TTFT "
          f"{sm['measured']['ttft_ms']}, {sm['measured']['wall_s']:.3f} s")
    print(f"fleet path launches {fl['launches']}; phase 16 took {fl['s']:.1f} s "
          f"({ {k: round(v, 1) for k, v in fl['parts_s'].items()} })")
    torch.cuda.empty_cache()
    details["moe"] = moe = moe_phase(device)
    report_moe(moe, name_limit)
    torch.cuda.empty_cache()
    details["dense_int8"] = di = dense_int8_phase(device)
    report_dense_int8(di, name_limit)
    for r in records:
        if r["name"] in tm["launches"]:
            r["launches_telemetry"] = tm["launches"][r["name"]]
        if r["name"] in fl["launches"]:
            r["launches_fleet"] = fl["launches"][r["name"]]
        if r["name"] in moe["launches"]:
            r["launches_moe"] = moe["launches"][r["name"]]
        if r["name"] in di["launches"]:
            r["launches_dense_int8"] = di["launches"][r["name"]]
    details["total_s"] = time.perf_counter() - t0
    lost = [n for _, n, _ in PROFILE_LOST if n < PROFILE_PAD]
    worst_age, worst = max(((a, n) for a, n, _ in PROFILE_LOST if n < PROFILE_PAD), key=lambda x: x[1],
                           default=(0.0, 0))
    clean_until = min((a for a, n, _ in PROFILE_LOST if 0 < n < PROFILE_PAD), default=None)
    retaken = [(round(a, 1), records) for a, n, records in PROFILE_LOST if n == PROFILE_PAD]
    details["profile_lost"] = PROFILE_LOST
    print(f"profiler: {len(PROFILE_LOST)} padded sessions; the first launches' records lost: none in sessions "
          f"before {clean_until if clean_until is None else round(clean_until, 1)} s into the run, up to "
          f"{worst} (at {worst_age:.1f} s), {sum(lost)} in all, each absorbed by the {PROFILE_PAD}-launch pad; "
          f"{len(retaken)} sessions kept no pad record and were taken again (s into the run, records kept: "
          f"{retaken})")
    if args.details is not None:
        args.details.parent.mkdir(parents=True, exist_ok=True)
        args.details.write_text(json.dumps(details, indent=1, default=str))

    print(name_limit)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    line = [{k: r[k] for k in keys} for r in records]
    for entry, r in zip(line, records):
        if "launches_telemetry" in r:  # phase 15's K1/K4 launches, beside the main path's
            entry["launches_telemetry"] = r["launches_telemetry"]
        if "launches_fleet" in r:  # phase 16's K1/K4 launches on the fleet path
            entry["launches_fleet"] = r["launches_fleet"]
        if "launches_moe" in r:  # phase 17's K1-K4 launches on the sparse path (train + serve)
            entry["launches_moe"] = r["launches_moe"]
        if "launches_dense_int8" in r:  # phase 18's K1/K4 launches (int8 weights, the dense engine)
            entry["launches_dense_int8"] = r["launches_dense_int8"]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
