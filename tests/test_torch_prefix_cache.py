"""Port parity: the radix prefix cache and preemption in the paged ``DecodeEngine``.

Ports ``tests/unit/test_prefix_cache.py`` (without the mesh and HTTP cases,
ROADMAP M12 and slice 7) and ``tests/unit/test_paged_kv.py:167-253`` on the
tiny GPT, its JAX weights carried across:

- the radix index: the port's ``PrefixCache`` and JAX's return the same
  paths, block ids and stats over seeded random sequences of ``match`` /
  ``probe`` / ``extend`` / ``adopt`` / ``release`` / ``pin`` / ``unpin`` /
  ``alloc_blocks`` / ``free_blocks`` / ``clear`` with evictions;
- engine schedules, int8 and f32 pools: hit / miss / partial block, the whole
  prompt cached, evict then re-admit, a chunked prefill resumed at the match,
  generated-token capture for a follow-up turn, same-call dedupe, cancel and
  reset releasing their references, a cancel racing a burst in flight,
  preempt and resume, and teardowns that must leak no block: greedy streams,
  ``prefill_tokens_computed`` and ``prefix_cache.stats()`` equal the JAX
  engine's, and the leak counters read zero;
- port against port: fixed-seed sampled streams with the cache on equal those
  with it off (JAX samples with threefry, the port with Philox);
- the speculative engine over the cache: greedy speculative streams with the
  cache on equal vanilla streams with it off, the draft re-prefilling the
  spliced prompt.

K4's hit prefill on the card (the query tile at a block-aligned base over
spliced int8 blocks) is ``test_torch_kernels.py::test_paged_kernel_at_a_hit_prefill``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu.serving.continuous import DecodeEngine as JaxEngine
from unionml_tpu.serving.faults import FaultPlan as JaxFaultPlan
from unionml_tpu.serving.prefix_cache import PrefixCache as JaxPrefixCache
from unionml_tpu_torch.models import GPTConfig, init_gpt
from unionml_tpu_torch.serving import DecodeEngine, FaultPlan, PrefixCache, SpeculativeEngine

BS = 4  # block size: small enough for partial-block matches


class Pair:
    """The tiny GPT in both packages on the same weights (kernels and
    embeddings scaled to std ~0.3, so greedy streams vary token to token)."""

    def __init__(self):
        jcfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, attention_impl="xla")
        variables = jgpt.init_params(jcfg, seq_len=16)
        self.variables = jax.tree_util.tree_map_with_path(
            lambda path, x: x * 2.5 if getattr(path[-1], "key", "") in ("kernel", "embedding") else x, variables)
        params = jax.tree_util.tree_map(np.asarray, jax.device_get(self.variables))
        self.jmodel = jgpt.GPTLMHeadModel(jcfg)
        self.tmodel = init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0), params=params, device="cpu")

    def engine(self, kind, *, blocks=32, pool="int8", faults=None, **kw):
        """An engine of ``kind`` ("jax" or "torch") with the prefix cache of
        ``blocks`` blocks (0: off); ``faults`` are FaultPlan keywords."""
        kw = dict(dict(num_slots=4, max_len=64, prefill_buckets=(4, 8, 16, 32)), **kw)
        quant = "int8" if pool == "int8" else None
        if kind == "jax":
            plan = JaxFaultPlan(**faults) if faults is not None else None
            return JaxEngine(self.jmodel, self.variables, prefix_cache_blocks=blocks, prefix_block_size=BS,
                             kv_quantize=quant, faults=plan, **kw)
        plan = FaultPlan(**faults) if faults is not None else None
        return DecodeEngine(self.tmodel, prefix_cache_blocks=blocks, block_size=BS, kv_quantize=quant,
                            faults=plan, device="cpu", **kw)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tiny models: under the suite's
    parallel workers torch's default (a thread per core in every worker)
    oversubscribes the cores, and each small op waits on its threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gpt():
    return Pair()


def leaks(engine):
    """``(pinned blocks, slot-owned blocks, largest node refcount)``: all zero
    once every request retired (a dense engine's index has no slot blocks)."""
    cache = engine._allocator if engine._allocator is not None else engine.prefix_cache
    worst, stack = 0, list(cache._root.children.values())
    while stack:
        node = stack.pop()
        worst = max(worst, node.refcount)
        stack.extend(node.children.values())
    return cache.pinned_blocks, cache.slot_blocks, worst


def counters(engine):
    stats = engine.prefix_cache.stats() if engine.prefix_cache is not None else None
    return {"prefill_tokens": engine.prefill_tokens_computed, "stats": stats, "leaks": leaks(engine)}


def run_schedule(engine, requests, stagger=2):
    """Admit ``requests`` one at a time with ``stagger`` steps between
    admissions, then drain; each request's emitted tokens, in order."""
    out, req_of_slot = {}, {}

    def pump(events):
        for ev in events:
            if ev.emit:
                out[req_of_slot[ev.slot]].append(ev.token)

    for i, (prompt, budget, *sampling) in enumerate(requests):
        (slot,) = engine.admit_many([(prompt, budget, *sampling)])
        pump(engine.take_pending_events())
        req_of_slot[slot], out[i] = i, []
        for _ in range(stagger):
            pump(engine.step())
    while engine.num_active or engine.has_pending_prefill or engine.has_pending_events:
        pump(engine.step())
    return [out[i] for i in range(len(requests))]


def drain(engine):
    while engine.num_active or engine.has_pending_prefill or engine.has_pending_events:
        engine.step()


# ------------------------------------------------------------ the radix index


def _random_ops(cache, seed, steps=300):
    """A seeded random sequence of index operations; returns every result as
    plain data (block ids, depths, stats)."""
    rng = np.random.default_rng(seed)
    vocab, block = 3, cache.block_size  # a tiny vocab makes shared prefixes common
    held, pinned, owned, log = [], [], [], []

    def tokens():
        return rng.integers(0, vocab, int(rng.integers(1, 6 * block))).tolist()

    for _ in range(steps):
        op = rng.choice(["match", "probe", "extend", "adopt", "release", "pin", "unpin", "alloc", "free", "avail",
                         "clear"], p=[.18, .06, .14, .12, .14, .06, .05, .1, .08, .05, .02])
        if op == "match":
            toks = tokens()
            path = cache.match(toks, len(toks) // block)
            held.append(path)
            log.append((op, [n.block_id for n in path]))
        elif op == "probe":
            toks = tokens()
            log.append((op, cache.probe(toks, len(toks) // block)))
        elif op == "extend":
            # from a held path (its tokens, then more) or from the root
            base = held.pop(int(rng.integers(len(held)))) if held and rng.random() < 0.5 else []
            toks = [t for node in base for t in node.key] + tokens()
            full, new = cache.extend(base, toks, len(toks) // block)
            held.append(full)
            log.append((op, [n.block_id for n in full], [n.block_id for n in new]))
        elif op == "adopt":
            toks = tokens()
            n = len(toks) // block
            ids = cache.alloc_blocks(n)
            if ids is None:
                log.append((op, None))
                continue
            block_map = dict(enumerate(ids))
            full, adopted = cache.adopt([], toks, n, block_map)
            cache.free_blocks(list(block_map.values()))
            held.append(full)
            log.append((op, [n.block_id for n in full], adopted))
        elif op == "release" and held:
            cache.release(held.pop(int(rng.integers(len(held)))))
        elif op == "pin" and held:
            path = held.pop(int(rng.integers(len(held))))
            cache.pin(path)
            cache.release(path)
            pinned.append(path)
        elif op == "unpin" and pinned:
            cache.unpin(pinned.pop(int(rng.integers(len(pinned)))))
        elif op == "alloc":
            ids = cache.alloc_blocks(int(rng.integers(1, 4)))
            if ids is not None:
                owned.append(ids)
            log.append((op, ids))
        elif op == "free" and owned:
            cache.free_blocks(owned.pop(int(rng.integers(len(owned)))))
        elif op == "avail":
            log.append((op, cache.available_blocks()))
        elif op == "clear" and not owned:
            cache.clear()
            held, pinned = [], []
        log.append(("stats", cache.stats()))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radix_index_matches_jax_over_random_operations(seed):
    """JAX's ``prefix_cache.py:101-400`` and the port's copy: the same block
    ids, depths, evictions and counters after every operation."""
    assert _random_ops(PrefixCache(12, 2), seed) == _random_ops(JaxPrefixCache(12, 2), seed)


def test_radix_index_validates_and_evicts_leaves_first():
    """``test_prefix_cache.py:74-109`` on the port's index."""
    with pytest.raises(ValueError, match="num_blocks"):
        PrefixCache(0, 4)
    with pytest.raises(ValueError, match="block_size"):
        PrefixCache(4, 0)
    cache = PrefixCache(num_blocks=3, block_size=2)
    toks_a = [1, 2, 3, 4, 5, 6]
    path_a, new_a = cache.extend([], toks_a, 3)
    assert len(path_a) == len(new_a) == 3 and cache.cached_blocks == 3
    assert cache.extend([], [7, 8, 9, 10], 2) == ([], [])  # every block referenced
    cache.release(path_a)
    path_b, new_b = cache.extend([], [7, 8, 9, 10], 2)
    assert len(new_b) == 2 and cache.evicted_blocks == 2
    assert len(cache.match(toks_a, 3)) == 1  # the interior root of chain a survived


# ------------------------------------------------------------ engine schedules

SHARED = list(range(1, 11))  # 10 tokens: 2 full blocks and a partial one


def sched_hit_miss_partial(make):
    requests = [(SHARED + [20, 21], 6), (SHARED + [30], 5), ([40, 41, 42], 4), (SHARED + [20, 21], 6)]
    on, off = make(), make(blocks=0)
    streams = run_schedule(on, requests)
    assert streams == run_schedule(off, requests)
    return {"streams": streams, **counters(on), "off_prefill_tokens": off.prefill_tokens_computed}


def sched_whole_prompt_cached(make):
    prompt = list(range(1, 9))  # exactly 2 blocks: the match stops a block short
    engine = make()
    return {"streams": [engine.generate(prompt, 5), engine.generate(prompt, 5)], **counters(engine)}


def sched_evict_then_readmit(make):
    a, b, c = list(range(1, 11)), list(range(50, 60)), list(range(80, 90))
    engine = make(blocks=3, pool_blocks=7)
    streams = [engine.generate(p, 4) for p in (a, b, a, c, a, b)]
    assert engine.prefix_cache.stats()["evicted_blocks"] > 0
    return {"streams": streams, **counters(engine)}


def sched_chunked_resume_at_match(make):
    first = list(range(1, 15))  # 14 tokens: indexes 3 blocks
    follow = first[:12] + [40, 41, 42, 43, 44, 45, 46, 47]  # hits 12, chunks the other 8
    requests = [(first, 5), ([3, 1, 4, 1, 5], 8), (follow, 5)]
    kw = dict(num_slots=3, prefill_buckets=(8, 16, 32), prefill_chunk=4)
    on, off = make(**kw), make(blocks=0, **kw)
    streams = run_schedule(on, requests)
    assert streams == run_schedule(off, requests)
    return {"streams": streams, **counters(on)}


def sched_generated_capture_multi_turn(make):
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    engine = make(prefix_cache_generated=True)
    completion = engine.generate(prompt, 8)
    before = engine.prefill_tokens_computed
    turn2 = prompt + completion + [7, 7, 7]
    streams = [completion, engine.generate(turn2, 5)]
    assert engine.prefill_tokens_computed - before == len(turn2) - 16  # the whole first turn reused
    return {"streams": streams, **counters(engine)}


def sched_same_call_dedupe(make):
    shared = list(range(1, 13))  # 3 full blocks
    requests = [(shared + [20 + i], 4) for i in range(4)]
    engine = make()
    slots = engine.admit_many(requests)
    out = {s: [] for s in slots}
    while engine.num_active or engine.has_pending_events:
        for ev in engine.step():
            if ev.emit:
                out[ev.slot].append(ev.token)
    assert engine.prefill_tokens_computed == 13 + 3  # one full prefill, then 1-token suffixes
    return {"streams": [out[s] for s in slots], **counters(engine)}


def sched_cancel_and_reset_release(make):
    engine = make(num_slots=1, prefill_buckets=(8, 16, 32), prefill_chunk=4)
    seed = list(range(1, 15))
    streams = [engine.generate(seed, 4)]
    (slot,) = engine.admit_many([(seed[:12] + [40] * 8, 5)])  # a chunked prefill resumed at the hit
    assert engine.has_pending_prefill
    engine.cancel(slot)
    assert not engine._slot_path and engine.free_slots == [slot]
    streams += [engine.generate(list(range(100 + 10 * i, 110 + 10 * i)), 3) for i in range(4)]
    engine.reset()
    assert engine.prefix_cache.cached_blocks == 0
    streams.append(engine.generate(seed, 4))
    return {"streams": streams, **counters(engine)}


def sched_cancel_racing_pipelined_step(make):
    engine = make(num_slots=2)
    seed = list(range(1, 13)) + [30, 31]
    streams = {"seed": engine.generate(seed, 3), "keep": [], "readmit": []}
    (keeper,) = engine.admit_many([([70, 71, 72], 8)])
    (victim,) = engine.admit_many([(seed[:12] + [40, 41], 20)])  # a hit: holds references
    for _ in range(2):
        for ev in engine.step():
            if ev.emit and ev.slot == keeper:
                streams["keep"].append(ev.token)
    assert engine._inflight is not None and engine._slot_path.get(victim)
    engine.cancel(victim)
    for ev in engine.take_pending_events():
        if ev.emit and ev.slot == keeper:
            streams["keep"].append(ev.token)
    assert victim not in engine._slot_path and leaks(engine)[2] == 0
    before = engine.prefill_tokens_computed
    (slot2,) = engine.admit_many([(seed[:12] + [50], 4)])
    assert slot2 == victim
    while engine.num_active or engine.has_pending_events:
        for ev in engine.step():
            if ev.emit:
                streams["keep" if ev.slot == keeper else "readmit"].append(ev.token)
    assert engine.prefill_tokens_computed - before == 1  # 12 of 13 reused
    return {"streams": streams, **counters(engine)}


def sched_preempt_resume(make):
    """``test_paged_kv.py:167-193``: the resume splices the checkpoint's
    blocks back and prefills only the suffix."""
    kw = dict(prefill_buckets=(4, 8, 16), prefill_chunk=4, blocks=24)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    full = make(**kw).generate(prompt, 12)
    engine = make(**kw)
    slot = engine.add_request(prompt, 12)
    got = []
    for _ in range(4):
        got.extend(ev.token for ev in engine.step() if ev.emit and ev.slot == slot)
    state = engine.preempt(slot)
    assert state is not None and engine.prefix_cache.pinned_blocks == len(state.path) > 0
    got.extend(ev.token for ev in engine.take_pending_events() if ev.emit and ev.slot == slot)
    restores, before = engine.prefix_restore_dispatches, engine.prefill_tokens_computed
    slot2 = engine.add_request(state.tokens, 12 - len(got))
    engine.release_preempted(state)
    while engine._active[slot2] or slot2 in engine._partials:
        got.extend(ev.token for ev in engine.step() if ev.emit and ev.slot == slot2)
    assert got == full and engine.prefix_restore_dispatches > restores
    resume_tokens = engine.prefill_tokens_computed - before
    assert resume_tokens == len(state.tokens) - len(state.path) * BS  # only the suffix
    drain(engine)
    return {"streams": [got], "resume_tokens": resume_tokens, **counters(engine)}


def sched_teardowns_leak_no_blocks(make):
    """``test_paged_kv.py:226-253``: cancel mid-chunked-prefill, abort_all with
    a burst in flight, reset."""
    engine = make(num_slots=3, prefill_buckets=(4, 8, 16), prefill_chunk=4, blocks=24)
    (slot,) = engine.admit_many([(list(range(1, 15)), 6)])
    assert engine.has_pending_prefill
    engine.cancel(slot)
    after_cancel = leaks(engine)
    engine.admit_many([([3, 1, 4], 20, {}), ([2, 7], 20, {})])
    engine.step()
    engine.step()
    engine.abort_all()
    after_abort = leaks(engine)
    stats = engine._allocator.stats()
    assert stats["free_blocks"] + stats["cached_blocks"] == engine._allocator.num_blocks
    engine.reset()
    out = engine.generate([5, 6, 7], 4)
    return {"streams": [out], "after": [after_cancel, after_abort], **counters(engine)}


SCHEDULES = {f.__name__[len("sched_"):]: f for f in (
    sched_hit_miss_partial, sched_whole_prompt_cached, sched_evict_then_readmit, sched_chunked_resume_at_match,
    sched_generated_capture_multi_turn, sched_same_call_dedupe, sched_cancel_and_reset_release,
    sched_cancel_racing_pipelined_step, sched_preempt_resume, sched_teardowns_leak_no_blocks)}


@pytest.mark.parametrize("pool", ["int8", "f32"])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax_engine(gpt, name, pool):
    """Greedy streams, prefill-token counters and the index's stats equal the
    JAX engine's on each schedule of ``test_prefix_cache.py`` and
    ``test_paged_kv.py:167-253``; no block or reference leaks."""
    schedule = SCHEDULES[name]
    got = schedule(lambda **kw: gpt.engine("torch", pool=pool, **kw))
    want = schedule(lambda **kw: gpt.engine("jax", pool=pool, **kw))
    assert got == want
    assert got["leaks"] == (0, 0, 0)


def test_hit_counters_show_only_suffixes_computed(gpt):
    """``test_prefix_cache.py:112-132``'s counter checks on the port alone."""
    result = sched_hit_miss_partial(lambda **kw: gpt.engine("torch", **kw))
    assert result["stats"]["hits"] == 2 and result["stats"]["hit_tokens"] == 8 + 8
    assert result["prefill_tokens"] == 12 + 3 + 3 + 4 < result["off_prefill_tokens"]


@pytest.mark.parametrize("pool", ["int8", "f32"])
def test_sampled_streams_equal_with_the_cache_on_and_off(gpt, pool):
    """``test_prefix_cache.py:148-160``, port against port: the same admission
    schedule and seed give the same sampled streams with the cache on and off."""
    requests = [(SHARED + [20], 6, {}), (SHARED + [30, 31], 6, {}), (list(range(1, 9)), 5, {})]

    def run(blocks):
        return run_schedule(gpt.engine("torch", blocks=blocks, pool=pool, temperature=0.8, seed=7), requests)

    assert run(16) == run(0)


def test_preempt_declines_without_cache_or_a_running_slot(gpt):
    engine = gpt.engine("torch", blocks=0)
    slot = engine.add_request([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="prefix cache"):
        engine.preempt(slot)
    engine = gpt.engine("torch")
    assert engine.preempt(0) is None  # nothing running there
    assert engine.prefix_cache.pinned_blocks == 0


def test_enable_prefix_cache_relays_the_pool_only_while_idle(gpt):
    """A post-construction ``enable_prefix_cache`` with another block size
    re-lays the pool (dropping graphs) only with nothing admitted."""
    engine = gpt.engine("torch", blocks=0)
    slot = engine.add_request([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="re-layout"):
        engine.enable_prefix_cache(16, block_size=8)
    engine.cancel(slot)
    engine.enable_prefix_cache(16, block_size=8)
    assert engine.block_size == 8 and engine.prefix_cache.block_size == 8
    assert engine.generate(list(range(1, 20)), 4) == gpt.engine("torch", blocks=0).generate(list(range(1, 20)), 4)
    with pytest.raises(RuntimeError, match="already"):
        engine.enable_prefix_cache(16)


# ------------------------------------------------------------ speculation over the cache


@pytest.mark.parametrize("pool", ["int8", "f32"])
def test_speculative_engine_over_the_prefix_cache(gpt, pool):
    """Self-draft speculation with the cache on: a hit admits through the
    spliced row and the draft re-prefills the whole prompt through it; the
    greedy streams equal the vanilla engine's with the cache off."""
    requests = [(SHARED + [20, 21], 8, {}), (SHARED + [30], 7, {}), (SHARED + [20, 21, 22], 6, {})]
    quant = "int8" if pool == "int8" else None
    kw = dict(num_slots=4, max_len=64, prefill_buckets=(4, 8, 16, 32), block_size=BS, kv_quantize=quant,
              device="cpu")
    spec = SpeculativeEngine(gpt.tmodel, gpt.tmodel, prefix_cache_blocks=32, **kw)
    got = run_schedule(spec, [(p, b, dict(s, speculative=True)) for p, b, s in requests])
    want = run_schedule(DecodeEngine(gpt.tmodel, **kw), requests)
    assert got == want
    assert spec.prefix_cache.stats()["hits"] == 2 and spec.draft_prefill_dispatches == 3
    assert spec.speculation_stats()["accepted"] > 0 and leaks(spec) == (0, 0, 0)
