"""Port parity: the paged ``DecodeEngine`` and the asyncio ``ContinuousBatcher``.

The port's engine and the JAX ``DecodeEngine`` run the same tiny f32 GPT
(weights carried across with ``params_from_jax``) over the same request
schedules: more requests than slots (slot and block reuse), prompts across
several prefill buckets, chunked prefill (``prefill_chunk``), and an EOS
token; each with an int8 pool and a full-precision f32 pool on the f32
config, and with a bf16 pool on the bf16 config. Greedy streams must be
IDENTICAL token for token. The batcher must answer concurrent
requests with the streams the engine gives each request alone. Sampling: the
top-k / top-p support sets of the port equal the JAX package's
``apply_top_k`` / ``apply_top_p`` on the same logits, and every sampled token
lies in that set.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu.ops import sampling as jsampling
from unionml_tpu.serving.continuous import DecodeEngine as JaxEngine
from unionml_tpu_torch.models import GPTConfig, init_gpt
from unionml_tpu_torch.ops import sampling as tsampling
from unionml_tpu_torch.serving.continuous import ContinuousBatcher, DecodeEngine
from unionml_tpu_torch.serving.faults import EngineFailure
from unionml_tpu_torch.serving.scheduler import QueueFullError, SchedulerConfig, SLOScheduler

BUCKETS = (16, 32, 64)
# (prompt length, max_new_tokens): six requests through two slots
SCHEDULE = [(5, 9), (20, 7), (40, 12), (3, 5), (33, 6), (17, 10)]


def _pair(jax_dtype, torch_dtype):
    jcfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jax_dtype, attention_impl="xla")
    jmodel = jgpt.GPTLMHeadModel(jcfg)
    variables = jgpt.init_params(jcfg, seq_len=16)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tmodel = init_gpt(GPTConfig.tiny(dtype=torch_dtype), params=params, device="cpu")
    return jmodel, variables, tmodel


@pytest.fixture(scope="module")
def models():
    return _pair(jnp.float32, torch.float32)


@pytest.fixture(scope="module")
def models_bf16():
    """bf16 compute: the JAX model keeps f32 params and casts, the port keeps
    bf16 params; the full-precision pool is then bf16."""
    return _pair(jnp.bfloat16, torch.bfloat16)


def _requests(seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, n).tolist(), m) for n, m in SCHEDULE]


def _drive(engine, requests):
    """Admit in arrival order as slots free; collect each request's emitted tokens."""
    out, pending, owner = {}, list(enumerate(requests)), {}
    while pending or owner:
        take, pending = pending[: len(engine.free_slots)], pending[len(engine.free_slots):]
        if take:
            for slot, (i, _) in zip(engine.admit_many([req for _, req in take]), take):
                owner[slot], out[i] = i, []
        for event in engine.step():
            i = owner.get(event.slot)
            if i is None:
                continue
            if event.emit:
                out[i].append(event.token)
            if event.finished:
                del owner[event.slot]
    return [out[i] for i in range(len(requests))]


@pytest.mark.parametrize("pool", ["int8", "f32", "bf16"], ids=["int8-pool", "f32-pool", "bf16-pool"])
@pytest.mark.parametrize("scenario", ["buckets", "chunked", "eos"])
def test_engine_greedy_streams_match_jax(request, pool, scenario):
    jmodel, variables, tmodel = request.getfixturevalue("models_bf16" if pool == "bf16" else "models")
    kv_quantize = "int8" if pool == "int8" else None
    kw = dict(num_slots=2, max_len=96, kv_quantize=kv_quantize, prefill_buckets=BUCKETS)
    if scenario == "chunked":
        kw["prefill_chunk"] = 16  # the 17-, 20-, 33- and 40-token prompts prefill through the table
    requests = _requests()
    if scenario == "eos":
        first = _drive(JaxEngine(jmodel, variables, **kw), requests)
        kw["eos_token_id"] = first[2][4]  # a token request 2 decodes mid-stream
    want = _drive(JaxEngine(jmodel, variables, **kw), requests)
    got = _drive(DecodeEngine(tmodel, device="cpu", **kw), requests)
    assert got == want
    if scenario == "eos":
        assert len(got[2]) < SCHEDULE[2][1]


def test_batcher_answers_concurrent_requests(models):
    *_, tmodel = models
    requests = _requests(seed=5)
    kw = dict(num_slots=2, max_len=96, kv_quantize="int8", prefill_buckets=BUCKETS, device="cpu")
    solo = [DecodeEngine(tmodel, **kw).generate(p, m) for p, m in requests]
    batcher = ContinuousBatcher(DecodeEngine(tmodel, **kw), device="cpu")

    async def serve():
        async def streamed(p, m):
            return [t async for t in batcher.stream(p, m)]

        futures = [batcher.generate(p, m) if i % 2 else streamed(p, m) for i, (p, m) in enumerate(requests)]
        return await asyncio.wait_for(asyncio.gather(*futures), timeout=120)

    try:
        got = asyncio.run(serve())
    finally:
        batcher.close(timeout_s=30)
    assert got == solo


def test_batcher_rejects_bad_requests_and_closes_cleanly(models):
    *_, tmodel = models
    engine = DecodeEngine(tmodel, num_slots=1, max_len=64, prefill_buckets=(16,), device="cpu")
    batcher = ContinuousBatcher(engine, device="cpu")

    async def go():
        with pytest.raises(ValueError):
            await batcher.generate([], 4)
        with pytest.raises(ValueError):
            await batcher.generate([1] * 40, 4)  # beyond the largest bucket
        with pytest.raises(ValueError):
            await batcher.generate([1, 2], 4, top_p=0.0)
        return await batcher.generate([1, 2, 3], 3)

    try:
        assert len(asyncio.run(go())) == 3
    finally:
        batcher.close(timeout_s=30)

    async def after_close():
        await batcher.generate([1, 2, 3], 3)

    with pytest.raises(EngineFailure) as info:
        asyncio.run(after_close())
    assert info.value.reason == "batcher_closed"


def test_fifo_queue_bound_is_structured():
    """The bounded arrival-order queue, now ``SchedulerConfig(fifo=True)``:
    the JAX scheduler's default bound, a structured shed at the bound that
    no class displaces, and arrival order whatever the class."""
    assert SLOScheduler(SchedulerConfig(fifo=True)).config.max_queue == 256  # the JAX scheduler's default bound
    small = SLOScheduler(SchedulerConfig(fifo=True, max_queue=2))
    for priority in ("batch", "standard"):
        small.submit(small.make_ticket(np.zeros(1, np.int32), 1, {}, None, priority=priority))
    with pytest.raises(QueueFullError) as info:
        small.submit(small.make_ticket(np.zeros(1, np.int32), 1, {}, None, priority="interactive"))
    assert info.value.reason == "queue_full" and small.depth == 2
    assert [t.priority for t in small.pop(2)] == [2, 1] and small.depth == 0


def test_pool_exhaustion_and_nan_quarantine(models):
    *_, tmodel = models
    engine = DecodeEngine(tmodel, num_slots=2, max_len=64, prefill_buckets=(16,), pool_blocks=4,
                          kv_quantize="int8", device="cpu")
    engine.add_request([1] * 10, 20)  # 30 tokens: 2 of the 3 usable blocks
    with pytest.raises(EngineFailure) as info:
        engine.add_request([2] * 10, 20)
    assert info.value.reason == "pool_exhausted" and engine.free_slots == [1]
    assert engine.available_blocks() == 1  # the failed admission returned nothing it held
    engine.cancel(0)
    slots = engine.admit_many([([3] * 5, 6), ([4] * 5, 6)])
    engine._last_logits[slots[0]] = float("nan")
    events = engine.step() + engine.step()  # pipelined: a burst's events arrive one step later
    assert [e.error for e in events if e.slot == slots[0]] == ["nan_logits"]
    assert any(e.slot == slots[1] and e.emit for e in events)
    assert engine.quarantined_requests == 1 and slots[0] in engine.free_slots


@pytest.mark.parametrize("top_k,top_p", [(1, 1.0), (7, 1.0), (0, 0.5), (12, 0.8), (0, 1.0)])
def test_top_k_top_p_support_matches_jax(top_k, top_p):
    rng = np.random.default_rng(top_k * 10 + int(top_p * 10))
    logits = rng.normal(size=(3, 64)).astype(np.float32) * 3.0
    logits[1, :4] = logits[1].max()  # ties at the top
    ks = np.full((3,), top_k, np.int32)
    ps = np.full((3,), top_p, np.float32)
    want = np.asarray(jsampling.apply_top_p(jsampling.apply_top_k(jnp.asarray(logits), jnp.asarray(ks)),
                                            jnp.asarray(ps)))
    got = tsampling.apply_top_p(tsampling.apply_top_k(torch.from_numpy(logits), torch.from_numpy(ks)),
                                torch.from_numpy(ps)).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    generator = torch.Generator().manual_seed(0)
    temps = torch.full((3,), 1.0)
    for _ in range(20):
        tokens = tsampling.sample_logits(torch.from_numpy(logits), generator, temps,
                                         torch.from_numpy(ks), torch.from_numpy(ps))
        assert np.all(np.isfinite(want[np.arange(3), tokens.numpy()]))
    greedy = tsampling.sample_logits(torch.from_numpy(logits), generator, torch.zeros(3))
    assert np.array_equal(greedy.numpy(), np.argmax(logits, axis=-1))


@pytest.mark.parametrize("bad", [dict(temperature=-1.0), dict(top_k=1.5), dict(top_k=True), dict(top_p=0.0),
                                 dict(top_p=1.5)])
def test_validate_sampling_rejects_like_jax(bad):
    args = {**dict(temperature=None, top_k=0, top_p=1.0), **bad}
    with pytest.raises(ValueError):
        jsampling.validate_sampling(**args)
    with pytest.raises(ValueError):
        tsampling.validate_sampling(**args)
