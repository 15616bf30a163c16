"""The ranks of ``tests/test_torch_tensor_parallel.py``: one process per rank
of a gloo world on the CPU, importing no JAX.

Every rank builds the same tiny GPTs (4 heads, and 2 for an axis that does
not divide them) from the weights the parent converted from the JAX
package, lays a ``{"tensor": world}`` mesh over the world and
runs each scenario below in the same order: rank 0 drives a meshed engine,
the others :meth:`~unionml_tpu_torch.serving.continuous.DecodeEngine.follow`.
Each rank writes what it saw to ``out_dir/rank{r}.pkl``; the parent holds
it against JAX and against the port's unmeshed engine.
"""

import asyncio
import faulthandler
import pickle
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import torch

#: tests/unit/test_continuous_sharded.py:25
REQUESTS = [([3, 1, 4, 1, 5], 6), ([2, 7], 5), ([1, 8, 2, 8, 1, 8, 2, 8], 4), ([6], 6)]
ENGINE_KW = dict(num_slots=4, max_len=64, prefill_buckets=(8, 16), device="cpu")
SOLO_KW = dict(num_slots=1, max_len=64, prefill_buckets=(8,), device="cpu")
PROMPT = [3, 1, 4, 1, 5]
#: tests/unit/test_prefix_cache.py:258's schedule and engine
SHARED = list(range(1, 11))
PREFIX_REQUESTS = [(SHARED + [20, 21], 6), (SHARED + [30], 5), ([40, 41, 42], 4), (SHARED + [20, 21], 6)]
PREFIX_KW = dict(num_slots=4, max_len=64, prefill_buckets=(4, 8, 16, 32), prefix_cache_blocks=32, block_size=4,
                 device="cpu")
#: a deadline no scenario should come near; a divergence ends well inside it
ENDS_WITHIN_S = 30.0
#: the side group's timeout for the idle scenario, and the idle gap between
#: its two requests (longer than the timeout)
IDLE_TIMEOUT_S = 5.0
IDLE_GAP_S = 7.0


def drain(engine, slots, lookahead=1):
    out = {s: [] for s in slots}
    while engine.num_active or engine.has_pending_prefill:
        for ev in engine.step(lookahead):
            if ev.emit:
                out[ev.slot].append(ev.token)
    return [out[s] for s in slots]


def run_schedule(engine, requests, stagger=2):
    """tests/unit/test_prefix_cache.py:43: one admission at a time with
    ``stagger`` steps between, then drain."""
    out, req_of_slot = {}, {}

    def pump(events):
        for ev in events:
            if ev.emit:
                out[req_of_slot[ev.slot]].append(ev.token)

    for i, (prompt, budget) in enumerate(requests):
        (slot,) = engine.admit_many([(prompt, budget)])
        req_of_slot[slot], out[i] = i, []
        for _ in range(stagger):
            pump(engine.step())
    while engine.num_active or engine.has_pending_prefill:
        pump(engine.step())
    return [out[i] for i in range(len(requests))]


def led(rank, engine, drive):
    """Rank 0 drives ``engine`` and then releases the followers; the other
    ranks follow until released."""
    if rank == 0:
        try:
            return drive(engine)
        finally:
            engine.stop_followers()
    return {"followed": engine.follow()}


def heads(engine):
    leaf = engine._pool["layer_0"]["k"] if engine.paged else engine._cache["layer_0"]["k"]
    return int(leaf.shape[1])


def scenario_greedy(rank, mesh, ctx):
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.model, mesh=mesh, **ENGINE_KW)
    return {"streams": led(rank, engine, lambda e: drain(e, e.admit_many(REQUESTS))), "heads": heads(engine)}


def scenario_lookahead(rank, mesh, ctx):
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.model, mesh=mesh, **ENGINE_KW)
    # twice: released followers follow the same engine again
    return {"streams": led(rank, engine, lambda e: drain(e, e.admit_many(REQUESTS), lookahead=4)),
            "again": led(rank, engine, lambda e: drain(e, e.admit_many(REQUESTS), lookahead=4))}


def scenario_sampled(rank, mesh, ctx):
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.model, mesh=mesh, temperature=0.8, seed=7, **SOLO_KW)
    return {"streams": led(rank, engine, lambda e: e.generate(PROMPT, 8))}


def scenario_int8_weights(rank, mesh, ctx):
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.model, mesh=mesh, quantize="int8", **SOLO_KW)
    return {"streams": led(rank, engine, lambda e: e.generate(PROMPT, 8))}


def scenario_int8_pool(rank, mesh, ctx):
    """Each rank's int8 pool against the head slice of an unmeshed engine's
    pool that ran the same calls on this rank."""
    from unionml_tpu_torch.serving import DecodeEngine

    meshed = DecodeEngine(ctx.model, mesh=mesh, kv_quantize="int8", **ENGINE_KW)
    streams = led(rank, meshed, lambda e: drain(e, e.admit_many(REQUESTS)))
    whole = DecodeEngine(ctx.model, kv_quantize="int8", **ENGINE_KW)
    drain(whole, whole.admit_many(REQUESTS))
    h = heads(meshed)
    equal, gap = {}, {}
    for name, layer in meshed._pool.items():
        for key, leaf in layer.items():
            mine = whole._pool[name][key][:, rank * h:(rank + 1) * h]
            equal[f"{name}.{key}"] = torch.equal(leaf, mine)
            # codes in steps of one; scales relative to the layer's largest
            gap[f"{name}.{key}"] = float((leaf.float() - mine.float()).abs().max() /
                                         (1.0 if leaf.dtype == torch.int8 else mine.abs().max().clamp_min(1e-30)))
    return {"streams": streams, "equal": equal, "gap": gap, "heads": h,
            "tables": torch.equal(meshed._tables, whole._tables)}


def scenario_prefix_cache(rank, mesh, ctx):
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.model, mesh=mesh, **PREFIX_KW)
    streams = led(rank, engine, lambda e: run_schedule(e, PREFIX_REQUESTS))
    return {"streams": streams, "stats": engine.prefix_cache.stats(), "prefill": engine.prefill_tokens_computed}


def scenario_dense(rank, mesh, ctx):
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.model, mesh=mesh, paged=False, prefix_cache_blocks=16, block_size=4, **ENGINE_KW)
    streams = led(rank, engine, lambda e: run_schedule(e, PREFIX_REQUESTS[:2] + REQUESTS))
    return {"streams": streams, "heads": heads(engine), "hits": engine.prefix_cache.stats()["hits"]}


def scenario_speculative(rank, mesh, ctx):
    from unionml_tpu_torch.serving import SpeculativeEngine

    engine = SpeculativeEngine(ctx.model, ctx.draft, mesh=mesh, gamma_max=3, **ENGINE_KW)
    requests = [(p, n, {"speculative": True}) for p, n in REQUESTS]
    streams = led(rank, engine, lambda e: drain(e, e.admit_many(requests)))
    return {"streams": streams, "rounds": engine.spec_round_dispatches, "draft_heads": int(
        engine._draft_pool["layer_0"]["k"].shape[1])}


def serve_generate(engine, requests, gap_s=0.0):
    """``/generate`` served from rank 0's ContinuousBatcher over ``engine``
    through aiohttp's test client, ``gap_s`` idle seconds after the first
    request; the (status, tokens or error reason) answers. The app's
    shutdown closes the batcher."""
    from aiohttp.test_utils import TestClient, TestServer

    from unionml_tpu_torch.serving import ContinuousBatcher, serving_app

    app = serving_app(SimpleNamespace(artifact=object(), name="tp-gpt"), resident=False, device="cpu",
                      generator=lambda: ContinuousBatcher(engine, device="cpu"), generate_supervisor=False)

    async def main():
        async with TestClient(TestServer(app)) as client:
            out = []
            for i, (prompt, n) in enumerate(requests):
                if i == 1:
                    await asyncio.sleep(gap_s)
                resp = await client.post("/generate", json={"prompt_ids": prompt, "max_new_tokens": n})
                body = await resp.json()
                out.append((resp.status, body["tokens"] if resp.status == 200 else body["error"]["reason"]))
            return out

    return asyncio.run(main())


def scenario_generate_app(rank, mesh, ctx):
    """``/generate`` served from rank 0's ContinuousBatcher over the meshed
    engine."""
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.model, mesh=mesh, **ENGINE_KW)
    return {"answers": led(rank, engine, lambda e: serve_generate(e, REQUESTS))}


def scenario_generate_idle(rank, mesh, ctx):
    """Two ``/generate`` requests ``IDLE_GAP_S`` apart over an engine whose
    side group times out after ``IDLE_TIMEOUT_S``: the idle batcher keeps
    the followers alive, and the app's shutdown (the batcher's close)
    releases them."""
    from unionml_tpu_torch.parallel import distributed
    from unionml_tpu_torch.serving import DecodeEngine

    saved, distributed._timeout_s = distributed._timeout_s, IDLE_TIMEOUT_S
    try:
        engine = DecodeEngine(ctx.model, mesh=mesh, **ENGINE_KW)
    finally:
        distributed._timeout_s = saved

    def drive(e):
        answers = serve_generate(e, REQUESTS[:2], IDLE_GAP_S)
        return {"answers": answers, "released": e._lead.stopped, "keepalive_s": e.keepalive_s}

    got = led(rank, engine, drive)
    return got if rank == 0 else {"answers": got}


def scenario_replicated_heads(rank, mesh, ctx):
    """A tiny GPT of 2 heads on a tensor axis that does not divide them: q, k,
    v and the cache stay whole on every rank."""
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.two, mesh=mesh, kv_quantize="int8", **ENGINE_KW)
    streams = led(rank, engine, lambda e: drain(e, e.admit_many(REQUESTS)))
    whole = DecodeEngine(ctx.two, kv_quantize="int8", **ENGINE_KW)
    return {"streams": streams, "whole": drain(whole, whole.admit_many(REQUESTS)), "heads": heads(engine)}


def break_rank_1(engine, rank):
    """Rank 1's engine raises in host work after a step's collectives."""
    if rank == 1:
        def broken(slot, token):
            raise RuntimeError("rank 1's host state is lost")

        engine._apply_token = broken


def scenario_diverged_batcher(rank, mesh, ctx):
    """Rank 1 raises inside a step behind rank 0's ``/generate``: the request
    fails with ``mesh_diverged``, the worker lives on and fails the next one
    at once, and every follower ends with MeshDivergence."""
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.model, mesh=mesh, **SOLO_KW)
    break_rank_1(engine, rank)
    t0 = time.perf_counter()
    try:
        answers, raised = led(rank, engine, lambda e: serve_generate(e, [(PROMPT, 8), (PROMPT, 2)])), None
    except Exception as exc:
        answers, raised = None, type(exc).__name__
    return {"answers": answers, "raised": raised, "s": time.perf_counter() - t0}


def scenario_raising_rank(rank, mesh, ctx):
    """Rank 1's engine raises in host work after a step's collectives, where
    rank 0's does not: every rank ends with MeshDivergence, promptly."""
    from unionml_tpu_torch.serving import DecodeEngine

    engine = DecodeEngine(ctx.model, mesh=mesh, **SOLO_KW)
    break_rank_1(engine, rank)

    def drive(e):
        # step by step: rank 1 raises inside one step, after its collectives
        e.add_request(PROMPT, 8)
        for _ in range(6):
            e.step()

    t0 = time.perf_counter()
    try:
        led(rank, engine, drive)
        raised = None
    except Exception as exc:
        raised = type(exc).__name__
    return {"raised": raised, "s": time.perf_counter() - t0, "then": _refused(engine, rank)}


def _refused(engine, rank):
    """What a later call meets on a diverged engine."""
    try:
        engine.follow() if rank else engine.generate(PROMPT, 2)
    except Exception as exc:
        return type(exc).__name__
    return None


SCENARIOS = {
    "greedy": scenario_greedy,
    "lookahead": scenario_lookahead,
    "sampled": scenario_sampled,
    "int8_weights": scenario_int8_weights,
    "int8_pool": scenario_int8_pool,
    "prefix_cache": scenario_prefix_cache,
    "dense": scenario_dense,
    "speculative": scenario_speculative,
    "generate_app": scenario_generate_app,
    "generate_idle": scenario_generate_idle,
    "replicated_heads": scenario_replicated_heads,
    "diverged_batcher": scenario_diverged_batcher,
    "raising_rank": scenario_raising_rank,  # last: it leaves its engine diverged
}


def rank_main(rank: int, world: int, port: int, params, params_two, out_dir: str) -> None:
    torch.set_num_threads(1)
    faulthandler.dump_traceback_later(170, exit=True)  # a hung rank never holds the suite
    from unionml_tpu_torch.models import GPTConfig, init_gpt
    from unionml_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(f"localhost:{port}", world, rank, strict=True, device="cpu", timeout_s=60)
    mesh = make_mesh({"tensor": world}, device="cpu")
    ctx = SimpleNamespace(
        model=init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0), params=params, device="cpu"),
        draft=init_gpt(GPTConfig.tiny(num_layers=1, dtype=torch.float32, dropout=0.0), seed=1, device="cpu"),
        two=init_gpt(GPTConfig.tiny(num_heads=2, dtype=torch.float32, dropout=0.0), params=params_two, device="cpu"))
    results = {}
    for name, scenario in SCENARIOS.items():
        t0 = time.perf_counter()
        try:
            results[name] = scenario(rank, mesh, ctx)
        except Exception as exc:  # the parent's test of this scenario fails with the traceback
            results[name] = {"error": "".join(traceback.format_exception(exc))}
        results[name]["wall_s"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    torch.distributed.destroy_process_group()
