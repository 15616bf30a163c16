"""Port parity: the engine fleet (``EngineFleet``, ``Router``) against the JAX package's.

Counterpart of ``tests/unit/test_fleet.py``, case by case, on the tiny GPT with
JAX's weights carried across (``tests/test_torch_prefix_cache.py``'s pair).
The port's replicas run on ``device="cpu"``, JAX's with ``mesh=None``:

- host only, exact: block keys and prefix digests equal JAX's; the router's
  decisions and ``stats()`` equal JAX's for the same candidates over seeded
  random operation sequences (every policy, sessions, TTL, failures, warm-up)
  and over ``test_fleet.py``'s router cases; ``split_devices`` groups and
  raises as ``split_mesh`` does;
- greedy streams of a 2-replica fleet equal the JAX fleet's and a solo
  engine's; port against port, a 1-replica fleet equals a bare supervised
  batcher and each replica of a 2-replica fleet equals a solo engine on its
  routed sub-stream, sampled, bit for bit (Philox is not threefry, so sampled
  streams are not held to JAX's);
- failover: a replica whose rebuild budget runs out hands its tickets to the
  survivor, with JAX's ``rerouted_tickets``, zero pinned blocks on every
  engine and JAX's streams; a session whose replica died re-sticks to the
  adopter and its next turn prefills what JAX's does;
- sheds happen before any replica queue is touched, with JAX's statuses;
  ``/healthz`` and ``/stats`` → ``generation.fleet`` bodies (the route's
  plain functions) equal JAX's key for key; ``/generate`` with ``session_id``
  over HTTP against the JAX app;
- the kernel launch counts stay exact when two threads launch at once, in
  and out of a graph's recording window.
"""

import asyncio
import random
import threading
import types

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tests.test_torch_prefix_cache import Pair, leaks
from unionml_tpu.serving import build_aiohttp_app as j_build_app
from unionml_tpu.serving.fleet import EngineFleet as JaxFleet
from unionml_tpu.serving.fleet import FleetConfig as JaxFleetConfig
from unionml_tpu.serving.fleet import Router as JaxRouter
from unionml_tpu.serving.prefix_cache import block_key as j_block_key
from unionml_tpu.serving.prefix_cache import prefix_digests as j_prefix_digests
from unionml_tpu.serving.scheduler import SLOScheduler as JaxScheduler
from unionml_tpu.serving.supervisor import EngineSupervisor as JaxSupervisor
from unionml_tpu_torch import kernels
from unionml_tpu_torch.serving import (
    ContinuousBatcher,
    DeadlineInfeasibleError,
    DecodeEngine,
    EngineFailure,
    EngineFleet,
    EngineSupervisor,
    FleetConfig,
    PrefixCache,
    QueueFullError,
    Router,
    SchedulerConfig,
    SLOScheduler,
    split_devices,
)
from unionml_tpu_torch.serving import build_aiohttp_app as t_build_app
from unionml_tpu_torch.serving.app import error_for, generation_stats, healthz_body
from unionml_tpu_torch.serving.prefix_cache import block_key, prefix_digests

PROMPT_A, BUDGET_A = [3, 1, 4, 1, 5], 12
PROMPT_B, BUDGET_B = [2, 7, 1], 10
PROMPTS = [PROMPT_A, PROMPT_B, [9, 9, 1, 2], [4, 4, 4]]
FLEET_KW = dict(num_slots=2, prefill_buckets=(8, 16, 32), blocks=64, pool="f32")
DEATH = dict(step_dispatch_failures=(4,), rebuild_failures=99)


@pytest.fixture(scope="module")
def gpt():
    return Pair()


def engine(gpt, kind="torch", **kw):
    return gpt.engine(kind, **dict(FLEET_KW, **kw))


def supervisor(cls=EngineSupervisor, **kw):
    kw.setdefault("watchdog_interval_s", 0)  # tests call check() themselves
    kw.setdefault("backoff_s", 0.005)
    kw.setdefault("backoff_max_s", 0.02)
    return cls(**kw)


def fleet(gpt, kind, n=2, config=None, faults=(), sups=None, **kw):
    """A fleet of ``n`` engines of ``kind``; ``faults[i]`` plans replica i's faults."""
    faults = list(faults) + [None] * (n - len(faults))
    engines = [engine(gpt, kind, faults=faults[i], **kw) for i in range(n)]
    if kind == "jax":
        return JaxFleet(engines, config=JaxFleetConfig(**(config or {})),
                        supervisors=sups or [supervisor(JaxSupervisor) for _ in engines])
    return EngineFleet(engines, config=FleetConfig(**(config or {})), supervisors=sups or [supervisor() for _ in engines])


def no_leaks(fl):
    """Zero pins and references on every replica's radix index."""
    for rep in fl.replicas:
        eng = rep.engine
        if hasattr(eng, "_allocator"):
            assert leaks(eng) == (0, 0, 0)
            continue
        assert eng.prefix_cache.pinned_blocks == 0
        stack = list(eng.prefix_cache._root.children.values())
        while stack:
            node = stack.pop()
            assert node.refcount == 0
            stack.extend(node.children.values())


def solo(gpt, prompt, budget, **kw):
    return engine(gpt, pipeline=False, **kw).generate(prompt, budget)


class Sink:
    cancelled = False

    def __init__(self):
        self.tokens, self.done, self.error = [], False, None

    def emit(self, token):
        self.tokens.append(token)

    def finish(self):
        self.done = True

    def fail(self, exc):
        self.error = exc


# ------------------------------------------------------ shared prefix hashing


def test_block_keys_and_digests_match_jax():
    """The router digests over the radix tree's own block keys, in both
    packages alike (``test_fleet.py:118-143``)."""
    tokens = np.asarray(list(range(1, 20)), dtype=np.int32)
    cache = PrefixCache(num_blocks=8, block_size=4)
    for i in range(len(tokens) // 4):
        assert block_key(tokens, i, 4) == cache._key_at(tokens, i) == j_block_key(tokens, i, 4)
    rng = np.random.default_rng(0)
    cases = [([1, 2, 3, 4, 5, 6, 7, 8, 9], 4, None), ([1, 2, 3, 4, 5, 6, 7, 8, 50, 51, 52, 53], 4, None),
             ([1, 2, 3, 99, 5, 6, 7, 8, 9], 4, None), ([1, 2, 3], 4, None), ([1, 2, 3, 4, 5, 6, 7, 8], 4, 1)]
    cases += [(rng.integers(0, 50257, int(n)).tolist(), int(bs), None)
              for n, bs in zip(rng.integers(0, 200, 8), rng.choice([1, 4, 16], 8))]
    for prompt, bs, cap in cases:
        assert prefix_digests(prompt, bs, max_blocks=cap) == j_prefix_digests(prompt, bs, max_blocks=cap)
    digests = prefix_digests([1, 2, 3, 4, 5, 6, 7, 8, 9], 4)
    assert len(digests) == 2 and prefix_digests([1, 2, 3, 4, 5, 6, 7, 8, 50, 51, 52, 53], 4)[:2] == digests


# -------------------------------------------------------------- router units


def random_router_ops(seed, n_replicas=3, steps=120):
    """A seeded operation script over a fleet of ``n_replicas``: routes (with
    shared-prefix prompts, random candidate subsets, weights, loads and
    sessions), replica rebuilds and failures, session lookups, hot digests
    and warm-ups, and clock advances past and short of the session TTL."""
    rng = random.Random(seed)
    prefixes = [[rng.randrange(1, 40) for _ in range(8)] for _ in range(4)]
    ops = []
    for _ in range(steps):
        r = rng.random()
        if r < 0.6:
            prompt = rng.choice(prefixes)[: rng.choice([0, 4, 8])] + [rng.randrange(1, 40)
                                                                       for _ in range(rng.randrange(0, 9))]
            cands = sorted(rng.sample(range(n_replicas), rng.randrange(1, n_replicas + 1)))
            cands = [(i, rng.choice([1.0, 0.5]), rng.choice([0.0, 0.25, 1.0, 2.5])) for i in cands]
            ops.append(("route", prompt, cands, rng.choice([None, None, "s0", "s1", "s2", "s3"])))
        elif r < 0.68:
            ops.append(("rebuilding", rng.randrange(n_replicas)))
        elif r < 0.73:
            ops.append(("failed", rng.randrange(n_replicas)))
        elif r < 0.8:
            ops.append(("session", rng.choice(["s0", "s1", "s2", "s3"])))
        elif r < 0.87:
            ops.append(("warm", rng.randrange(n_replicas), rng.choice([0, 1, 3, 16])))
        else:
            ops.append(("tick", rng.choice([0.5, 4.0, 11.0])))
    return ops


def run_router_ops(router, ops, clock):
    out = []
    for op in ops:
        if op[0] == "route":
            out.append(router.route(op[1], op[2], session_id=op[3]))
        elif op[0] == "rebuilding":
            router.on_replica_rebuilding(op[1])
        elif op[0] == "failed":
            router.on_replica_failed(op[1])
        elif op[0] == "session":
            out.append(router.session_replica(op[1]))
        elif op[0] == "warm":
            hot = router.hot_digests(op[2])
            router.warm_replica(op[1], hot)
            out.append(hot)
        else:
            clock[0] += op[1]
        out.append(router.stats())
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["affinity", "random", "round_robin"])
def test_router_matches_jax_over_random_operations(policy, seed):
    """Decisions, matched blocks, sessions, hot digests and ``stats()`` equal
    JAX's after every operation, under one fake clock."""
    kw = dict(policy=policy, seed=seed, session_ttl_s=10.0, max_sessions=3, affinity_index_blocks=6)
    ops = random_router_ops(seed)
    results = []
    for router_cls, config_cls in ((Router, FleetConfig), (JaxRouter, JaxFleetConfig)):
        clock = [0.0]
        router = router_cls(3, block_size=4, config=config_cls(**kw), time_fn=lambda: clock[0])
        results.append(run_router_ops(router, ops, clock))
    assert results[0] == results[1]
    routes = [r for r in results[0] if isinstance(r, tuple)]
    assert {d["decision"] for _, d in routes} >= {{"affinity": "affinity", "random": "random",
                                                    "round_robin": "round_robin"}[policy], "sticky"}


CANDS2 = [(0, 1.0, 0.0), (1, 1.0, 0.0)]


def test_router_affinity_beats_random_on_prefix_heavy_mix():
    """``test_fleet.py:152-179``; both arms' stats equal JAX's."""
    groups = [[g * 10 + k for k in range(8)] for g in range(3)]
    prompts = [prefix + [100 * (g + 1) + j] * 4 for j in range(6) for g, prefix in enumerate(groups)]

    def run(router_cls, config_cls, policy):
        router = router_cls(2, block_size=4, config=config_cls(policy=policy, seed=0))
        assigned = [0, 0]
        for prompt in prompts:
            chosen, _ = router.route(prompt, [(i, 1.0, 0.5 * assigned[i]) for i in range(2)])
            assigned[chosen] += 1
        return router.stats()

    for policy in ("affinity", "random"):
        assert run(Router, FleetConfig, policy) == run(JaxRouter, JaxFleetConfig, policy)
    affinity, rnd = run(Router, FleetConfig, "affinity"), run(Router, FleetConfig, "random")
    assert affinity["prefix_hit_rate"] > rnd["prefix_hit_rate"]
    assert affinity["affinity_routes"] == rnd["random_routes"] == len(prompts)
    assert affinity["lookup_blocks"] == rnd["lookup_blocks"] > 0


def test_router_load_breaks_ties_and_downranks_busy_replicas():
    for router in (Router(2, block_size=4), JaxRouter(2, block_size=4)):
        chosen, how = router.route([1, 2, 3, 4], [(0, 1.0, 3.0), (1, 1.0, 0.0)])
        assert chosen == 1 and how["decision"] == "affinity"
        chosen, how = router.route([1, 2, 3, 4], [(0, 1.0, 0.2), (1, 1.0, 0.0)])
        assert chosen == 1 and how["matched_blocks"] == 1


def test_router_session_sticks_then_ttl_expires():
    outs = []
    for router_cls, config_cls in ((Router, FleetConfig), (JaxRouter, JaxFleetConfig)):
        clock = {"t": 0.0}
        router = router_cls(2, block_size=4, config=config_cls(session_ttl_s=10.0, max_sessions=2),
                            time_fn=lambda: clock["t"])
        chosen, _ = router.route([1, 2, 3, 4], CANDS2, session_id="s1")
        assert router.session_replica("s1") == chosen
        clock["t"] = 5.0
        again, how = router.route([9, 9, 9, 9], [(0, 1.0, 9.0), (1, 1.0, 9.0)], session_id="s1")
        assert again == chosen and how["decision"] == "sticky"
        clock["t"] = 20.1
        router.route([2, 2, 2, 2], CANDS2, session_id="other")
        assert router.session_replica("s1") is None and router.stats()["sessions_evicted"] == 1
        router.route([3, 3, 3, 3], CANDS2, session_id="s2")
        router.route([4, 4, 4, 4], CANDS2, session_id="s3")
        assert router.session_replica("other") is None and router.stats()["sessions_active"] == 2
        outs.append(router.stats())
    assert outs[0] == outs[1]


def test_router_dead_session_falls_back_to_affinity_winner_and_resticks():
    outs = []
    for router in (Router(3, block_size=4), JaxRouter(3, block_size=4)):
        prompt = [5, 5, 5, 5, 6, 6, 6, 6]
        assert router.route(prompt, [(0, 1.0, 0.0)], session_id="s")[0] == 0
        assert router.route(prompt, [(2, 1.0, 0.0)])[0] == 2
        router.on_replica_rebuilding(0)
        assert router.session_replica("s") == 0
        chosen, how = router.route(prompt, [(1, 1.0, 0.0), (2, 1.0, 0.0)], session_id="s")
        assert chosen == 2 and how == {"decision": "affinity", "matched_blocks": 2, "digest_blocks": 2}
        assert router.stats()["dead_session_fallbacks"] == 1 and router.session_replica("s") == 2
        router.route([7, 7, 7, 7], [(1, 1.0, 0.0)], session_id="on1")
        router.on_replica_failed(1)
        assert router.session_replica("on1") is None and router.session_replica("s") == 2
        assert router.stats()["indexed_blocks"][1] == 0
        outs.append(router.stats())
    assert outs[0] == outs[1]


def test_fleet_config_and_router_reject_what_jax_rejects():
    for kw in (dict(policy="nearest"), dict(max_queue=0)):
        messages = []
        for cls in (FleetConfig, JaxFleetConfig):
            with pytest.raises(ValueError) as err:
                cls(**kw)
            messages.append(str(err.value))
        assert messages[0] == messages[1]
    for cls in (Router, JaxRouter):
        with pytest.raises(ValueError, match="num_replicas must be >= 1"):
            cls(0, block_size=4)
        with pytest.raises(ValueError, match="at least one healthy candidate"):
            cls(1, block_size=4).route([1, 2], [])


# ------------------------------------------------------- per-class queue EMAs


def test_scheduler_per_class_ema_isolates_infeasible_estimate():
    """``test_fleet.py:272-302``: the per-class signal the router reads, in
    the port's scheduler; its stats equal JAX's under the same clock."""
    stats = []
    for sched in (SLOScheduler(), JaxScheduler()):
        fast = sched.make_ticket([1], 4, {}, Sink(), priority="interactive", now=0.0)
        sched.submit(fast, now=0.0)
        assert sched.pop(1, now=0.01) == [fast]
        slow = sched.make_ticket([1], 4, {}, Sink(), priority="batch", now=1.0)
        sched.submit(slow, now=1.0)
        assert sched.pop(1, now=11.0) == [slow]
        signal = sched.load_signal()
        assert signal["per_class"]["interactive"] == pytest.approx(10.0)
        assert signal["per_class"]["batch"] == pytest.approx(10_000.0)
        assert signal["queue_wait_ema_ms"] > 500
        ok = sched.make_ticket([1], 4, {}, Sink(), priority="interactive", deadline_ms=500, now=20.0)
        sched.submit(ok, now=20.0)
        assert sched.remove(ok)
        doomed = sched.make_ticket([1], 4, {}, Sink(), priority="batch", deadline_ms=500, now=20.0)
        with pytest.raises(Exception) as shed:
            sched.submit(doomed, now=20.0)
        assert type(shed.value).__name__ == DeadlineInfeasibleError.__name__
        stats.append(sched.stats())
    assert stats[0] == stats[1]
    assert stats[0]["per_class"]["standard"] is None and stats[0]["shed_deadline_infeasible"] == 1


def test_supervisor_subscription_swallows_subscriber_errors():
    sup = supervisor()
    seen = []
    sup.subscribe(lambda old, new: (_ for _ in ()).throw(RuntimeError("boom")))
    sup.subscribe(lambda old, new: seen.append((old, new)))
    sup._notify("ok", "degraded")
    assert seen == [("ok", "degraded")]
    sup._notify("degraded", "degraded")
    assert seen == [("ok", "degraded")]


def test_split_devices_groups_and_errors():
    """``split_mesh``'s contiguous equal groups and errors over a device list."""
    devices = [torch.device("cuda", i) for i in range(8)]
    assert split_devices(devices, 2) == [devices[:4], devices[4:]]
    assert split_devices(devices, 8) == [[d] for d in devices]
    assert split_devices(devices, 1) == [devices]
    with pytest.raises(ValueError, match="cannot split 8 devices into 3 equal groups"):
        split_devices(devices, 3)
    with pytest.raises(ValueError, match="n must be >= 1, got 0"):
        split_devices(devices, 0)


# ----------------------------------------------------------- serving parity


@pytest.mark.parametrize("policy", ["round_robin", "affinity"])
def test_fleet_greedy_streams_equal_jax_fleet_and_a_solo_engine(gpt, policy):
    """``test_fleet.py:339-371``: a 2-replica fleet's greedy streams equal the
    JAX fleet's and one engine's; under round-robin both replicas served and
    the routers' stats are equal."""
    out, stats = {}, {}
    for kind in ("torch", "jax"):
        fl = fleet(gpt, kind, config=dict(policy=policy, seed=0))

        async def main():
            return [await fl.generate(p, 6, session_id=f"s{i}") for i, p in enumerate(PROMPTS)]

        try:
            out[kind] = asyncio.run(main())
        finally:
            fl.close()
        stats[kind] = fl.stats()["fleet"]
        if policy == "round_robin":
            assert all(rep.engine.prefill_dispatches > 0 for rep in fl.replicas)
        assert stats[kind]["requests_routed"] == 4 and fl.stats()["num_slots"] == 4
        no_leaks(fl)
    assert out["torch"] == out["jax"] == [solo(gpt, p, 6) for p in PROMPTS]
    if policy == "round_robin":
        # affinity's load term reads the queue-wait EMA, a wall-clock figure
        assert stats["torch"]["router"] == stats["jax"]["router"]


def test_single_replica_fleet_sampled_parity(gpt):
    """``test_fleet.py:374-410``: a 1-replica fleet's fixed-seed sampled
    streams are the bare supervised batcher's, bit for bit."""
    def run(gen):
        async def main():
            return await asyncio.gather(gen.generate(PROMPT_A, BUDGET_A, temperature=0.8),
                                        gen.generate(PROMPT_B, BUDGET_B, temperature=0.8))

        try:
            return asyncio.run(main())
        finally:
            gen.close()

    bare = ContinuousBatcher(engine(gpt, temperature=0.8, seed=7), supervisor=supervisor(), device="cpu")
    one = EngineFleet([engine(gpt, temperature=0.8, seed=7)], supervisors=[supervisor()])
    assert run(one) == run(bare)


def test_fleet_sampled_parity_per_replica_substream(gpt):
    """``test_fleet.py:413-463``: each replica reproduces a solo engine serving
    its routed sub-stream, sampled, bit for bit."""
    fl = EngineFleet([engine(gpt, temperature=0.8, seed=7) for _ in range(2)],
                     config=FleetConfig(policy="round_robin"), supervisors=[supervisor(), supervisor()])
    routed, real = [], fl._route

    def spy(prompt_ids, session_id=None):
        rep = real(prompt_ids, session_id)
        routed.append(rep.index)
        return rep

    fl._route = spy

    async def serve():
        return [await fl.generate(p, 6, temperature=0.8) for p in PROMPTS]

    try:
        results = asyncio.run(serve())
    finally:
        fl.close()
    assert sorted(set(routed)) == [0, 1]
    for index in (0, 1):
        batcher = ContinuousBatcher(engine(gpt, temperature=0.8, seed=7), device="cpu")

        async def alone():
            return [await batcher.generate(p, 6, temperature=0.8) for p, r in zip(PROMPTS, routed) if r == index]

        try:
            reference = asyncio.run(alone())
        finally:
            batcher.close()
        assert [results[i] for i, r in enumerate(routed) if r == index] == reference
    no_leaks(fl)


# ------------------------------------------------------------------ shedding


def test_fleet_sheds_before_touching_replica_queues_with_jax_statuses(gpt):
    """``test_fleet.py:469-502``: the fleet bound sheds 429 with the fleet's
    Retry-After before any replica scheduler sees the request; no healthy
    replica is a retryable 503; a closed fleet is ``batcher_closed``."""
    seen = {}
    for kind in ("torch", "jax"):
        fl = fleet(gpt, kind, config=dict(max_queue=1, retry_after_s=2.5))
        errors = []
        try:
            rep0 = fl.replicas[0]
            rep0.batcher.scheduler.submit(rep0.batcher.scheduler.make_ticket(
                np.asarray(PROMPT_A, dtype=np.int32), 4, {}, Sink()))
            with pytest.raises(Exception) as shed:
                asyncio.run(fl.generate(PROMPT_B, 4))
            errors.append(shed.value)
            assert rep0.batcher.scheduler.submitted == 1
            assert fl.replicas[1].batcher.scheduler.submitted == 0
            rep0.batcher.scheduler.drain()
            for rep in fl.replicas:
                with rep.supervisor._lock:
                    rep.supervisor._state = "failed"
            with pytest.raises(Exception) as unavailable:
                asyncio.run(fl.generate(PROMPT_B, 4))
            errors.append(unavailable.value)
            for rep in fl.replicas:
                with rep.supervisor._lock:
                    rep.supervisor._state = "ok"
            counters = {k: v for k, v in fl.stats()["fleet"].items() if k not in ("router", "per_replica")}
        finally:
            fl.close()
        with pytest.raises(Exception) as closed:
            asyncio.run(fl.generate(PROMPT_B, 4))
        errors.append(closed.value)
        seen[kind] = ([(type(e).__name__, e.reason, getattr(e, "retry_after_s", None), getattr(e, "retryable", None),
                        str(e)) for e in errors], counters)
        if kind == "torch":
            port_errors = errors
    full, down, gone = port_errors
    assert isinstance(full, QueueFullError) and full.retry_after_s == 2.5
    assert isinstance(down, EngineFailure) and down.reason == "fleet_unavailable" and down.retryable
    assert gone.reason == "batcher_closed"
    assert seen["torch"] == seen["jax"]
    status, body, headers = error_for(full, rng=random.Random(0))
    assert status == 429 and body["error"]["reason"] == "queue_full" and "Retry-After" in headers


# ------------------------------------------------------------------ failover


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_replica_death_reroutes_salvageable_tickets_like_jax(gpt, pool):
    """``test_fleet.py:508-545``: replica 0's rebuild budget runs out
    mid-decode with both sessions pinned to it; both tickets re-route to
    replica 1 and complete with JAX's streams (and, at f32, the fault-free
    ones); no block stays pinned on either engine."""
    out, fleet_stats = {}, {}
    for kind in ("torch", "jax"):
        sup_cls = EngineSupervisor if kind == "torch" else JaxSupervisor
        sups = [supervisor(sup_cls, max_rebuild_attempts=2), supervisor(sup_cls)]
        fl = fleet(gpt, kind, faults=[DEATH], sups=sups, pool=pool)
        fl.router._sessions["a"] = (0, fl.router._time())
        fl.router._sessions["b"] = (0, fl.router._time())

        async def main():
            return await asyncio.gather(fl.generate(PROMPT_A, BUDGET_A, session_id="a"),
                                        fl.generate(PROMPT_B, BUDGET_B, session_id="b"))

        try:
            out[kind] = asyncio.run(main())
        finally:
            fl.close()
        assert sups[0].state == "failed" and sups[1].state == "ok"
        fleet_stats[kind] = {k: v for k, v in fl.stats()["fleet"].items() if k not in ("router", "per_replica")}
        assert fleet_stats[kind]["rerouted_tickets"] == 2 and fleet_stats[kind]["reroute_failed"] == 0
        health = fl.healthz()
        assert health["state"] == "degraded" and health["serving_replicas"] == 1
        assert [r["state"] for r in health["replicas"]] == ["failed", "ok"]
        assert fl.router.session_replica("a") is None
        no_leaks(fl)
    assert out["torch"] == out["jax"]
    assert fleet_stats["torch"] == fleet_stats["jax"]
    if pool == "f32":
        assert out["torch"] == [solo(gpt, PROMPT_A, BUDGET_A), solo(gpt, PROMPT_B, BUDGET_B)]


def test_session_chaos_next_turn_pays_only_suffix_prefill(gpt):
    """``test_fleet.py:548-583``: the session's replica dies mid-turn; the
    turn completes on the adopter, the session re-sticks there, and its next
    turn prefills the suffix only: the same tokens and counts as JAX's."""
    seen = {}
    for kind in ("torch", "jax"):
        sup_cls = EngineSupervisor if kind == "torch" else JaxSupervisor
        fl = fleet(gpt, kind, faults=[DEATH], sups=[supervisor(sup_cls, max_rebuild_attempts=2), supervisor(sup_cls)],
                   prefix_cache_generated=True)
        prompt1 = [3, 1, 4, 1, 5, 9, 2, 6]
        fl.router._sessions["s"] = (0, fl.router._time())
        try:
            out1 = asyncio.run(fl.generate(prompt1, 8, session_id="s"))
            prompt2 = prompt1 + out1 + [7, 7, 7, 7]
            before = fl.replicas[1].engine.prefill_tokens_computed
            out2 = asyncio.run(fl.generate(prompt2, 6, session_id="s"))
            assert fl.router.session_replica("s") == 1
            cost = fl.replicas[1].engine.prefill_tokens_computed - before
        finally:
            fl.close()
        assert cost <= 8, f"turn 2 re-prefilled {cost} tokens"
        no_leaks(fl)
        seen[kind] = (out1, out2, cost, fl.router.stats())
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == solo(gpt, [3, 1, 4, 1, 5, 9, 2, 6], 8)


def test_orphans_no_replica_takes_fail_with_the_unavailable_error(gpt):
    """A 1-replica fleet whose engine dies has no survivor: every ticket
    fails with the supervisor's structured ``engine_failed`` error, and the
    fleet counts each as a failed re-route."""
    sup = supervisor(max_rebuild_attempts=2)
    fl = EngineFleet([engine(gpt, faults=DEATH)], supervisors=[sup])

    async def main():
        return await asyncio.gather(fl.generate(PROMPT_A, BUDGET_A), fl.generate(PROMPT_B, BUDGET_B),
                                    return_exceptions=True)

    try:
        results = asyncio.run(main())
    finally:
        fl.close()
    assert [(type(r).__name__, r.reason, r.retryable) for r in results] == [("EngineFailure", "engine_failed",
                                                                             False)] * 2
    stats = fl.stats()["fleet"]
    assert stats["rerouted_tickets"] == 0 and stats["reroute_failed"] == 2
    assert sup.stats()["failed_requests"] == 2
    no_leaks(fl)


# -------------------------------------------------------------- HTTP surface


def keys_of(tree):
    """The key structure of a JSON-like tree (lists by their first entry)."""
    if isinstance(tree, dict):
        return {k: keys_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [keys_of(tree[0])] if tree else []
    return None


def test_fleet_healthz_and_stats_bodies_match_jax(gpt):
    """The fleet-shaped ``/healthz`` and ``/stats`` → ``generation`` bodies
    (``healthz_body``, ``generation_stats``) equal JAX's ``healthz()`` and
    ``stats()`` key for key, and in every count, after the same requests."""
    bodies = {}
    model = types.SimpleNamespace(name="fleet", artifact=object())
    for kind in ("torch", "jax"):
        fl = fleet(gpt, kind, config=dict(seed=0))

        async def main():
            return [await fl.generate(p, 4, session_id="chat") for p in PROMPTS[:2]]

        try:
            asyncio.run(main())
            if kind == "torch":
                status, health = healthz_body(fl, model)
                assert status == 200
                stats = generation_stats(fl)
            else:
                health, stats = fl.healthz(), fl.stats()
        finally:
            fl.close()
        bodies[kind] = (health, stats)
    (t_health, t_stats), (j_health, j_stats) = bodies["torch"], bodies["jax"]
    assert t_health == j_health
    assert keys_of(t_stats) == keys_of(j_stats)
    t_fleet, j_fleet = t_stats.pop("fleet"), j_stats.pop("fleet")
    assert t_stats == j_stats
    assert t_fleet["router"] == j_fleet["router"] and t_fleet["router"]["sticky_routes"] == 1
    assert {k: v for k, v in t_fleet.items() if k not in ("router", "per_replica")} == {
        k: v for k, v in j_fleet.items() if k not in ("router", "per_replica")}
    for t_rep, j_rep in zip(t_fleet["per_replica"], j_fleet["per_replica"]):
        assert t_rep["prefix_cache"] == j_rep["prefix_cache"]
        for key in ("replica", "state", "active", "num_slots"):
            assert t_rep[key] == j_rep[key]
        for key in ("submitted", "admitted", "preemptions", "resumes"):
            assert t_rep["scheduler"][key] == j_rep["scheduler"][key]


def fleet_app(gpt, kind, **kw):
    stub = types.SimpleNamespace(name="fleet-app", artifact=object())
    if kind == "jax":
        return j_build_app(stub, resident=False, coalesce=False, generate_drain_s=2.0,
                           generator=lambda replica: engine(gpt, "jax"), generate_replicas=2,
                           generate_fleet_config=JaxFleetConfig(seed=0), **kw)
    return t_build_app(stub, resident=False, coalesce=False, generate_drain_s=2.0, device="cpu",
                       generator=lambda replica: engine(gpt), generate_replicas=2,
                       generate_fleet_config=FleetConfig(seed=0), **kw)


def test_fleet_sessions_healthz_and_stats_over_http_match_jax(gpt):
    """``test_fleet.py:603-641``: ``serving_app(generate_replicas=2)`` serves
    ``/generate`` with ``session_id`` (the second turn sticks), rejects a
    non-string session id with 400, and answers ``/healthz`` and ``/stats``
    per replica, as the JAX app does."""
    answers = {}
    for kind in ("torch", "jax"):
        app = fleet_app(gpt, kind)

        async def main():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                seen = [(r.status, await r.json()) for r in [await client.get("/healthz")]]
                payload = {"prompt_ids": PROMPT_A, "max_new_tokens": 6, "session_id": "chat"}
                for _ in range(2):
                    resp = await client.post("/generate", json=payload)
                    seen.append((resp.status, (await resp.json())["tokens"]))
                resp = await client.post("/generate", json={**payload, "session_id": 123})
                body = await resp.json()
                seen.append((resp.status, body["error"]["reason"], body["error"]["detail"]))
                stats = await (await client.get("/stats")).json()
                block = stats["generation"]["fleet"]
                seen.append((block["replicas"], block["requests_routed"], block["router"],
                             [(e["replica"], e["state"], sorted(e["scheduler"])) for e in block["per_replica"]],
                             sorted(stats["generation"]["slo"])))
                return seen
            finally:
                await client.close()

        answers[kind] = asyncio.run(main())
        no_leaks(app["continuous_batcher"])
    assert answers["torch"] == answers["jax"]
    health = answers["torch"][0][1]
    assert health["state"] == "ok" and health["fleet"] is True and health["serving_replicas"] == 2
    assert answers["torch"][1][1] == answers["torch"][2][1] == solo(gpt, PROMPT_A, 6)
    assert answers["torch"][3][0] == 400 and answers["torch"][4][2]["sticky_routes"] >= 1


def test_fleet_shed_retry_after_jitter_is_seedable(gpt):
    """``test_fleet.py:644-693``: a prebuilt fleet behind the app; the 429's
    Retry-After jitter draws from the app's seeded generator."""
    expected = 2.0 * (0.75 + 0.5 * random.Random(42).random())
    for _ in range(2):
        fl = EngineFleet([engine(gpt) for _ in range(2)], config=FleetConfig(max_queue=1, retry_after_s=2.0),
                         supervisors=[supervisor(), supervisor()])
        rep0 = fl.replicas[0]
        rep0.batcher.scheduler.submit(rep0.batcher.scheduler.make_ticket(
            np.asarray(PROMPT_A, dtype=np.int32), 4, {}, Sink()))
        stub = types.SimpleNamespace(name="fleet-app", artifact=object())
        app = t_build_app(stub, resident=False, coalesce=False, generate_drain_s=2.0, device="cpu", generator=fl,
                          retry_jitter_rng=random.Random(42))

        async def first_shed():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                resp = await client.post("/generate", json={"prompt_ids": PROMPT_B, "max_new_tokens": 4})
                body = await resp.json()
                return resp.status, body["error"]["reason"], body["error"]["retry_after_ms"], resp.headers["Retry-After"]
            finally:
                fl.replicas[0].batcher.scheduler.drain()
                await client.close()

        status, reason, retry_ms, header = asyncio.run(first_shed())
        assert (status, reason) == (429, "queue_full")
        assert retry_ms == int(expected * 1000) and header == str(max(1, round(expected)))


def test_fleet_app_rejections_match_jax(gpt, monkeypatch):
    """JAX ``app.py:262-310``'s rejections, raised by ``build_generator``:
    a shared supervisor, a shared scheduler instance, a factory that returns
    no engine; and an engine on another device than the app's. Each replica
    is built with ``replica=i``; nothing falls back to the CPU."""
    from unionml_tpu_torch.serving.app import build_generator

    factory = lambda replica: engine(gpt)  # noqa: E731
    with pytest.raises(ValueError, match="generate_supervisor must be left None"):
        build_generator(factory, replicas=2, supervisor=supervisor(), device="cpu")
    with pytest.raises(ValueError, match="needs a SchedulerConfig"):
        build_generator(factory, replicas=2, scheduler=SLOScheduler(), device="cpu")
    with pytest.raises(TypeError, match="must return a DecodeEngine per replica"):
        build_generator(lambda: object(), replicas=2, device="cpu")
    if not torch.cuda.is_available():  # a replica asked for the card raises without one
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_generator(lambda replica: DecodeEngine(gpt.tmodel, max_len=64), replicas=2, device="cpu")
    from unionml_tpu_torch import _device

    with monkeypatch.context() as patch:  # the app on the card, the factory's engines on the CPU
        patch.setattr(_device, "resolve_device", lambda device: torch.device("cuda"))
        with pytest.raises(ValueError, match="the app's device is cuda"):
            build_generator(factory, replicas=2, device="cuda")
    calls = []
    built = build_generator(lambda replica: calls.append(replica) or engine(gpt), replicas=3, device="cpu",
                            scheduler=SchedulerConfig(max_queue=5), prefix_cache_blocks=16)
    try:
        assert calls == [0, 1, 2] and built.num_replicas == 3
        assert all(rep.batcher.scheduler.config.max_queue == 5 for rep in built.replicas)
        assert len({id(rep.batcher.scheduler) for rep in built.replicas}) == 3
    finally:
        built.close()
    with pytest.raises(TypeError, match="pass a SchedulerConfig"):
        EngineFleet([engine(gpt)], scheduler=SLOScheduler())
    with pytest.raises(ValueError, match="2 engines need 2 supervisors, got 1"):
        EngineFleet([engine(gpt), engine(gpt)], supervisors=[supervisor()])
    with pytest.raises(ValueError, match="share one prefix block size"):
        EngineFleet([engine(gpt), DecodeEngine(gpt.tmodel, max_len=64, block_size=8, device="cpu")])


# ------------------------------------------------------------ launch counts


def test_launch_counts_exact_across_threads_and_capture_windows():
    """Two threads count launches at once, each opening and closing
    recording windows (a graph's capture) meanwhile: every launch made
    outside a window is counted once, on its own thread; what a window took
    back is exactly its thread's launches inside it; nothing is lost or
    charged to the other thread."""
    import sys

    kernels.reset_launches()
    start = threading.Barrier(2)
    rounds, results = 400, {}

    def worker(name, other_name):
        start.wait()
        taken = 0
        for i in range(rounds):
            kernels.note_launch(name)  # eager: counted
            if i % 4 == 0:
                with kernels.recording() as recorded:
                    kernels.note_launch(name, 3)  # recorded: taken back
                    kernels.note_launch(other_name)  # this thread's launch of another kernel, taken back too
                taken += recorded.get(name, 0)
                assert recorded == {name: 3, other_name: 1}
        results[name] = (threading.get_ident(), taken)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=("flash_fwd", "flash_bwd_dq")),
                   threading.Thread(target=worker, args=("paged_attention", "flash_bwd_dkv"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert dict(kernels.launches) == {"flash_fwd": rounds, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                      "paged_attention": rounds}
    tallies = kernels.tallies()
    for name, (ident, taken) in results.items():
        assert tallies[ident][name] == rounds and taken == 3 * rounds // 4
    assert {name: sum(t[name] for t in tallies.values()) for name in kernels.launches} == dict(kernels.launches)
    kernels.reset_launches()
    assert dict(kernels.launches) == dict.fromkeys(kernels.launches, 0)
