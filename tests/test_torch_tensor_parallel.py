"""Tensor-parallel generation (``DecodeEngine(mesh=...)``) on gloo worlds of 2
and 4 ranks against the JAX package.

One spawn per world for the module: the ranks (``tests/torch_tp_ranks.py``,
which imports no JAX) run every scenario with rank 0 leading and the others
following, while this process computes the references: JAX's single-device
``generate`` and JAX's ``DecodeEngine(mesh=make_mesh({"tensor": 4}))`` on
``tests/unit/test_continuous_sharded.py:25``'s requests, JAX's meshed
engine with int8 weights, with the prefix cache, dense, and over a 2-head
model the axis does not divide, and the port's unmeshed engine beside each
(alone for sampled streams, which draw from Philox where JAX draws from
threefry). The worlds run one intra-op thread per rank.
"""

import multiprocessing
import pickle
import socket
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_tp_ranks as ranks
from unionml_tpu.models import gpt as jgpt
from unionml_tpu.parallel import make_mesh as jax_make_mesh
from unionml_tpu.serving.continuous import DecodeEngine as JaxEngine
from unionml_tpu_torch.models import GPTConfig, init_gpt
from unionml_tpu_torch.serving import DecodeEngine, SpeculativeEngine

WORLDS = (2, 4)
#: how long the module waits for a world (each rank exits on its own at 170 s)
WAIT_S = 180.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_drain(engine, requests):
    slots = engine.admit_many(requests)
    out = {s: [] for s in slots}
    while engine.num_active or engine.has_pending_prefill:
        for ev in engine.step():
            if ev.emit:
                out[ev.slot].append(ev.token)
    return [out[s] for s in slots]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, attention_impl="xla")
    jmodel = jgpt.GPTLMHeadModel(jcfg)
    variables = jgpt.init_params(jcfg, seq_len=16)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    jcfg_two = jgpt.GPTConfig.tiny(num_heads=2, dropout=0.0, dtype=jnp.float32, attention_impl="xla")
    jmodel_two = jgpt.GPTLMHeadModel(jcfg_two)
    variables_two = jgpt.init_params(jcfg_two, jax.random.PRNGKey(3), seq_len=16)
    params_two = jax.tree_util.tree_map(np.asarray, jax.device_get(variables_two))
    ctx = multiprocessing.get_context("spawn")
    procs, dirs = {}, {}
    for world in WORLDS:
        dirs[world] = tmp_path_factory.mktemp(f"world{world}")
        port = _free_port()
        procs[world] = [ctx.Process(target=ranks.rank_main, args=(r, world, port, params, params_two, str(dirs[world])),
                                    daemon=True) for r in range(world)]
        for p in procs[world]:
            p.start()
    # the references, while the worlds run
    refs = {"expected": []}
    for prompt, n in ranks.REQUESTS:
        out = jgpt.generate(jmodel, variables, jnp.asarray(np.asarray(prompt, dtype=np.int32)[None]), n)
        refs["expected"].append([int(t) for t in np.asarray(out)[0, len(prompt):]])
    mesh4 = jax_make_mesh({"tensor": 4}, devices=jax.devices()[:4])
    jax_kw = dict(num_slots=4, max_len=64, prefill_buckets=(8, 16), mesh=mesh4)
    refs["jax_meshed"] = _jax_drain(JaxEngine(jmodel, variables, **jax_kw), ranks.REQUESTS)
    refs["jax_int8_weights"] = JaxEngine(jmodel, variables, num_slots=1, max_len=64, prefill_buckets=(8,),
                                         quantize="int8", mesh=mesh4).generate(ranks.PROMPT, 8)
    jax_prefix = JaxEngine(jmodel, variables, num_slots=4, max_len=64, prefill_buckets=(4, 8, 16, 32),
                           prefix_cache_blocks=32, prefix_block_size=4, mesh=mesh4)
    refs["jax_prefix_cache"] = (ranks.run_schedule(jax_prefix, ranks.PREFIX_REQUESTS), jax_prefix.prefix_cache.stats(),
                                jax_prefix.prefill_tokens_computed)
    jax_dense = JaxEngine(jmodel, variables, paged=False, prefix_cache_blocks=16, prefix_block_size=4, **jax_kw)
    refs["jax_dense"] = ranks.run_schedule(jax_dense, ranks.PREFIX_REQUESTS[:2] + ranks.REQUESTS)
    refs["jax_two_heads"] = _jax_drain(JaxEngine(jmodel_two, variables_two, kv_quantize="int8", **jax_kw),
                                       ranks.REQUESTS)
    model = init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0), params=params, device="cpu")
    draft = init_gpt(GPTConfig.tiny(num_layers=1, dtype=torch.float32, dropout=0.0), seed=1, device="cpu")
    refs["sampled"] = DecodeEngine(model, temperature=0.8, seed=7, **ranks.SOLO_KW).generate(ranks.PROMPT, 8)
    refs["int8_weights"] = DecodeEngine(model, quantize="int8", **ranks.SOLO_KW).generate(ranks.PROMPT, 8)
    whole = DecodeEngine(model, **ranks.PREFIX_KW)
    refs["prefix_cache"] = (ranks.run_schedule(whole, ranks.PREFIX_REQUESTS), whole.prefix_cache.stats(),
                            whole.prefill_tokens_computed)
    refs["prefix_solo"] = [ranks.run_schedule(DecodeEngine(model, **ranks.ENGINE_KW), [req])[0]
                           for req in ranks.PREFIX_REQUESTS]
    dense = DecodeEngine(model, paged=False, prefix_cache_blocks=16, block_size=4, **ranks.ENGINE_KW)
    refs["dense"] = ranks.run_schedule(dense, ranks.PREFIX_REQUESTS[:2] + ranks.REQUESTS)
    spec = SpeculativeEngine(model, draft, gamma_max=3, **ranks.ENGINE_KW)
    refs["spec_rounds"] = (ranks.drain(spec, spec.admit_many([(p, n, {"speculative": True})
                                                              for p, n in ranks.REQUESTS])),
                           spec.spec_round_dispatches)
    torch.set_num_threads(threads)
    deadline = time.monotonic() + WAIT_S
    out = dict(refs)
    for world in WORLDS:
        for p in procs[world]:
            p.join(max(1.0, deadline - time.monotonic()))
        alive = [p.pid for p in procs[world] if p.is_alive()]
        for p in procs[world]:
            if p.is_alive():
                p.kill()
        files = [Path(dirs[world], f"rank{r}.pkl") for r in range(world)]
        out[world] = [pickle.loads(f.read_bytes()) if f.exists() else None for f in files]
        out[f"{world}_failure"] = None if not alive and all(f.exists() for f in files) else (
            f"world {world}: ranks {alive} still running after {WAIT_S} s, exit codes "
            f"{[p.exitcode for p in procs[world]]}")
    return out


def result(worlds, world, name, rank=0):
    assert worlds[f"{world}_failure"] is None, worlds[f"{world}_failure"]
    got = worlds[world][rank][name]
    assert "error" not in got, got["error"]
    return got


@pytest.mark.parametrize("world", WORLDS)
def test_followers_replay_every_scenario(worlds, world):
    """Every follower replayed rank 0's calls without an error of its own."""
    for rank in range(1, world):
        for name in ranks.SCENARIOS:
            got = result(worlds, world, name, rank)
            if name not in ("raising_rank", "diverged_batcher"):
                followed = got.get("streams", got.get("answers"))
                assert followed["followed"] > 0, (rank, name)


@pytest.mark.parametrize("world", WORLDS)
def test_greedy_streams_equal_jax_single_device_and_meshed(worlds, world):
    got = result(worlds, world, "greedy")
    assert got["streams"] == worlds["expected"] == worlds["jax_meshed"]
    # each rank's pool holds its own heads of the tiny GPT's 4
    assert all(result(worlds, world, "greedy", r)["heads"] == 4 // world for r in range(world))


@pytest.mark.parametrize("world", WORLDS)
def test_lookahead_bursts_equal_jax(worlds, world):
    got = result(worlds, world, "lookahead")
    assert got["streams"] == got["again"] == worlds["expected"]


@pytest.mark.parametrize("world", WORLDS)
def test_sampled_stream_equals_the_unmeshed_engine(worlds, world):
    """The same seed draws the same stream: every rank samples from the same
    all-gathered logits with the same generator."""
    assert result(worlds, world, "sampled")["streams"] == worlds["sampled"]


@pytest.mark.parametrize("world", WORLDS)
def test_int8_weights_compose_with_the_mesh(worlds, world):
    """JAX's test_mesh_composes_with_quantize: quantize first, then shard;
    the stream equals JAX's meshed int8 engine's and the port's unmeshed."""
    got = result(worlds, world, "int8_weights")["streams"]
    assert got == worlds["int8_weights"] == worlds["jax_int8_weights"]


@pytest.mark.parametrize("world", WORLDS)
def test_int8_pool_is_the_unmeshed_pools_head_slice(worlds, world):
    """Per-(block, head) scales: each rank's int8 codes and scales are its
    heads of the unmeshed engine's pool, tables equal. Layer 0's K/V follow
    only the exact embedding sum, so its codes and scales are bit for bit
    the unmeshed ones; a later layer's input has been through the
    row-parallel all-reduce, whose sum of per-rank partial products rounds
    otherwise than one product over the whole width (as in JAX's meshed
    engine), so its scales may move in the last bits and a code by one
    step. Given the same K/V the quantization itself is head-local and
    bitwise (test_head_sharded_quantization_is_the_whole_pools_slice)."""
    for rank in range(world):
        got = result(worlds, world, "int8_pool", rank)
        assert got["heads"] == 4 // world and got["tables"]
        assert all(v for k, v in got["equal"].items() if k.startswith("layer_0.")), got["equal"]
        assert all(v <= (1.0 if k.endswith(("k", "v")) else 1e-6) for k, v in got["gap"].items()), got["gap"]
    assert result(worlds, world, "int8_pool")["streams"] == worlds["expected"]


@pytest.mark.parametrize("heads", [1, 2])
def test_head_sharded_quantization_is_the_whole_pools_slice(heads):
    """The int8 pool's writes (bucket insert, decode append, chunk prefill)
    on a rank's head slice of a pool, fed that slice of the same K/V, give
    bit for bit the slice of the whole pool's result."""
    from unionml_tpu_torch.models.gpt import _paged_append_quantized, _paged_chunk_quantized
    from unionml_tpu_torch.ops.quant import quantize_blockwise

    gen = torch.Generator().manual_seed(heads)
    blocks, bs, hd, rows = 6, 4, 16, 3
    whole_q = torch.randint(-127, 128, (blocks, 4, bs, hd), generator=gen).to(torch.int8)
    whole_s = torch.rand((blocks, 4, 1, 1), generator=gen)
    mine = slice(heads, 2 * heads) if heads * 2 <= 4 else slice(0, heads)
    part_q, part_s = whole_q[:, mine].clone(), whole_s[:, mine].clone()
    vals = torch.randn((rows, 4, hd), generator=gen)
    dst, off = torch.tensor([0, 2, 5]), torch.tensor([0, 3, 1])
    _paged_append_quantized(whole_q, whole_s, dst, off, vals)
    _paged_append_quantized(part_q, part_s, dst, off, vals[:, mine])
    chunk = torch.randn((4, 7, hd), generator=gen)
    table = torch.tensor([1, 3, 4, 5])
    _paged_chunk_quantized(whole_q, whole_s, table, 2, chunk)
    _paged_chunk_quantized(part_q, part_s, table, 2, chunk[mine])
    assert torch.equal(part_q, whole_q[:, mine]) and torch.equal(part_s, whole_s[:, mine])
    src = torch.randn((rows, 2, 4, bs, hd), generator=gen)
    codes, scale = quantize_blockwise(src, reduce_axes=(3, 4))
    p_codes, p_scale = quantize_blockwise(src[:, :, mine], reduce_axes=(3, 4))
    assert torch.equal(p_codes, codes[:, :, mine]) and torch.equal(p_scale, scale[:, :, mine])


@pytest.mark.parametrize("world", WORLDS)
def test_prefix_cache_hits_splice_alike_on_every_rank(worlds, world):
    """JAX's test_mesh_sharded_prefix_cache_parity: the meshed cache-on engine
    equals the cache-off single-device streams, with the unmeshed engine's hits
    and prefill counts on every rank."""
    want, stats, prefill = worlds["prefix_cache"]
    assert want == worlds["prefix_solo"]
    assert (want, stats, prefill) == worlds["jax_prefix_cache"]
    for rank in range(world):
        got = result(worlds, world, "prefix_cache", rank)
        assert got["stats"] == stats and got["prefill"] == prefill
    assert result(worlds, world, "prefix_cache")["streams"] == want
    assert stats["hits"] == 2


@pytest.mark.parametrize("world", WORLDS)
def test_dense_engine_is_head_sharded(worlds, world):
    got = result(worlds, world, "dense")
    assert got["streams"] == worlds["dense"] == worlds["jax_dense"] and got["hits"] >= 1
    assert all(result(worlds, world, "dense", r)["heads"] == 4 // world for r in range(world))


@pytest.mark.parametrize("world", WORLDS)
def test_speculative_greedy_equals_plain_decoding(worlds, world):
    """A replicated draft over a tensor-parallel target: greedy speculation
    equals plain decoding (and JAX), with rounds run."""
    got = result(worlds, world, "speculative")
    want, rounds = worlds["spec_rounds"]
    assert got["streams"] == want == worlds["expected"]
    assert got["rounds"] == rounds > 0 and got["draft_heads"] == 4


@pytest.mark.parametrize("world", WORLDS)
def test_generate_route_served_from_rank_0(worlds, world):
    got = result(worlds, world, "generate_app")["answers"]
    assert [status for status, _ in got] == [200] * len(ranks.REQUESTS)
    assert [tokens for _, tokens in got] == worlds["expected"]


@pytest.mark.parametrize("world", WORLDS)
def test_followers_outlive_an_idle_gap_longer_than_the_timeout(worlds, world):
    """The idle batcher keeps the followers alive across a gap longer than
    the side group's timeout, and closing it releases them."""
    got = result(worlds, world, "generate_idle")
    assert ranks.IDLE_GAP_S > ranks.IDLE_TIMEOUT_S == 4 * got["keepalive_s"]
    assert got["answers"] == [(200, tokens) for tokens in worlds["expected"][:2]]
    assert got["released"]
    for rank in range(1, world):
        assert result(worlds, world, "generate_idle", rank)["answers"]["followed"] >= 4


@pytest.mark.parametrize("world", WORLDS)
def test_heads_the_axis_does_not_divide_stay_whole(worlds, world):
    got = result(worlds, world, "replicated_heads")
    assert got["streams"] == got["whole"] == worlds["jax_two_heads"]
    assert got["heads"] == (2 // world if world <= 2 else 2)


@pytest.mark.parametrize("world", WORLDS)
def test_a_divergence_behind_the_batcher_fails_its_requests(worlds, world):
    """Rank 1 raises inside a step of a /generate request: rank 0's batcher
    fails it and the next request with mesh_diverged (its worker survives
    the refusal), and every follower ends with MeshDivergence in bound."""
    got = result(worlds, world, "diverged_batcher")
    assert got["raised"] is None and got["answers"] == [(500, "mesh_diverged")] * 2
    for rank in range(1, world):
        follower = result(worlds, world, "diverged_batcher", rank)
        assert follower["raised"] == "MeshDivergence" and follower["s"] < ranks.ENDS_WITHIN_S


@pytest.mark.parametrize("world", WORLDS)
def test_a_raising_rank_ends_every_rank(worlds, world):
    """Rank 1 raises where rank 0 does not: every rank ends with
    MeshDivergence within the bound, and a later call is refused."""
    for rank in range(world):
        got = result(worlds, world, "raising_rank", rank)
        assert got["raised"] == "MeshDivergence", (rank, got)
        assert got["s"] < ranks.ENDS_WITHIN_S and got["then"] == "MeshDivergence"
