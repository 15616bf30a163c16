"""Port parity: the fleet simulator (``unionml_tpu_torch.sim``) against the JAX package's.

Counterpart of ``tests/unit/test_sim.py``. The simulator is host code driving
the port's own ``Router``, ``SLOScheduler``, ``SLOTracker`` and
``block_demand``, so the port is held to JAX's exactly:

- the journal loader reads v1, v2 and rejects future versions as JAX's does,
  and a journal the port's ``Telemetry`` wrote loads into equal records in
  both packages;
- replay, the synthetic workloads, the autoscaler's decisions and the whole
  simulator report equal JAX's on the same seeded traces (failover drills,
  autoscaling and the router's warm-up included);
- ``fit_cost_model`` agrees with JAX's within 1e-9 on planted records and on
  a journal of the port's live fleet;
- golden replay: a 2-replica port fleet on the CPU serves a contended mix
  (queue-full sheds, a displacement, a preemption and its resume) with the
  journal on, and the journal alone reproduces its live counters.
"""

import asyncio
import dataclasses
import json
import threading
import time

import pytest
import torch

from unionml_tpu import sim as jsim
from unionml_tpu.serving.fleet import Router as JaxRouter
from unionml_tpu_torch.models import GPTConfig, init_gpt
from unionml_tpu_torch.serving import DecodeEngine, EngineFleet, EngineSupervisor, Router, SchedulerConfig, Telemetry
from unionml_tpu_torch.serving.telemetry import JOURNAL_SCHEMA_VERSION
from unionml_tpu_torch.sim import (
    Autoscaler,
    AutoscalerConfig,
    CostModel,
    FleetSimulator,
    ReplicaDeath,
    SimConfig,
    SyntheticConfig,
    fit_cost_model,
    generate_requests,
    load_journal,
    parse_journal_record,
    replay_journal,
)


def v1_record(**over):
    rec = {"request_id": "r1", "created_unix": 1.0, "class": "standard", "status": "ok", "tokens_in": 8,
           "tokens_out": 4, "decode_bursts": 1, "ttft_ms": 12.5, "spans": []}
    rec.update(over)
    return rec


def fields(record):
    return dataclasses.asdict(record)


# ---------------------------------------------------------------- journal I/O


def test_journal_loader_v1_compat_v2_fields_and_future_rejection(tmp_path):
    """``test_sim.py:70-98``, with both loaders reading the same file."""
    rec = parse_journal_record(v1_record())
    assert rec.version == 1 and rec.session_id is None and rec.block_demand is None
    for parse in (parse_journal_record, jsim.parse_journal_record):
        with pytest.raises(ValueError, match="unsupported journal schema v99"):
            parse(v1_record(v=99))
        with pytest.raises(ValueError, match="missing required field"):
            parse({"v": 2})
    v2 = v1_record(v=2, request_id="r2", session_id="sess-1", spans=[
        {"kind": "admission", "attrs": {"block_demand": 5, "available_blocks": 40, "deadline_ms": 250.0}},
        {"kind": "queue_wait", "dur_ms": 3.25, "attrs": {"resume": False}}])
    path = tmp_path / "journal.jsonl"
    path.write_text(json.dumps(v1_record()) + "\n\n" + json.dumps(v2) + "\n")
    records = load_journal(str(path))
    assert [r.version for r in records] == [1, 2]
    assert records[1].session_id == "sess-1" and records[1].block_demand == 5
    assert records[1].available_blocks == 40 and records[1].deadline_ms == 250.0 and records[1].queue_wait_ms == 3.25
    assert [fields(r) for r in records] == [fields(r) for r in jsim.load_journal(str(path))]
    path.write_text("{not json\n")
    with pytest.raises(ValueError, match=r"journal\.jsonl:1"):
        load_journal(str(path))


def test_replay_discriminates_queued_vs_running_deadline_misses():
    queued = v1_record(v=2, status="shed", reason="deadline_exceeded", ttft_ms=None,
                       spans=[{"kind": "admission", "attrs": {}}])
    running = v1_record(v=2, request_id="r2", status="shed", reason="deadline_exceeded",
                        spans=[{"kind": "admission", "attrs": {}}, {"kind": "admitted", "attrs": {"slot": 0}}])
    report = replay_journal([parse_journal_record(r) for r in (queued, running)])
    assert report["deadline_misses_queued"] == report["deadline_misses_running"] == 1
    assert report["shed"] == {"deadline_exceeded": 2}
    assert report["slo_totals"]["standard"] == {"good": 0, "total": 2}
    assert report == jsim.replay_journal([jsim.parse_journal_record(r) for r in (queued, running)])


# ----------------------------------------------------------------- cost model


def planted_records(parse):
    base, slope, itl = 4.0, 0.25, 6.0
    return [parse(v1_record(v=2, request_id=f"r{i}", tokens_in=n, itl_ms=itl, ttft_ms=round(i + base + slope * n, 3),
                            spans=[{"kind": "queue_wait", "dur_ms": float(i), "attrs": {}}]))
            for i, n in enumerate([8] * 10 + [64] * 10)]


def assert_models_agree(port, jax_model):
    a, b = dataclasses.asdict(port), dataclasses.asdict(jax_model)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            assert a[key].keys() == b[key].keys()
            for cls in a[key]:
                assert abs(a[key][cls] - b[key][cls]) <= 1e-9, (key, cls)
        else:
            assert abs(a[key] - b[key]) <= 1e-9, key


def test_fit_cost_model_recovers_planted_affine_fit():
    """``test_sim.py:123-141``; the fit agrees with JAX's within 1e-9."""
    fitted = fit_cost_model(planted_records(parse_journal_record), default=CostModel(dispatch_ms=0.0))
    assert fitted.prefill_ms_per_token == pytest.approx(0.25, abs=1e-6)
    assert fitted.prefill_base_ms == pytest.approx(4.0, abs=1e-6)
    assert fitted.itl_ms == pytest.approx(6.0) and fitted.itl_ms_by_class == {"standard": 6.0}
    assert fit_cost_model(planted_records(parse_journal_record)[:3]) == CostModel()
    assert_models_agree(fitted, jsim.fit_cost_model(planted_records(jsim.parse_journal_record),
                                                    default=jsim.CostModel(dispatch_ms=0.0)))
    assert dataclasses.asdict(CostModel()) == dataclasses.asdict(jsim.CostModel())  # JAX's placeholders
    model = CostModel(spec_alpha=0.7, itl_ms_by_class={"batch": 11.0})
    jmodel = jsim.CostModel(spec_alpha=0.7, itl_ms_by_class={"batch": 11.0})
    for args in ((12, 40, "batch", True), (300, 1, "standard", False), (0, 0, "interactive", True)):
        assert model.service_ms(*args) == jmodel.service_ms(*args)


# ----------------------------------------------------------------- autoscaler


def test_autoscaler_scale_up_cooldown_and_shed_waiver_like_jax():
    """``test_sim.py:147-155`` on both autoscalers."""
    outs = []
    for scaler in (Autoscaler(AutoscalerConfig(min_replicas=1, max_replicas=3)),
                   jsim.Autoscaler(jsim.AutoscalerConfig(min_replicas=1, max_replicas=3))):
        pressured = {"depth": 0, "queue_wait_ema_ms": None, "pool": {"pressure": 0.95}}
        outs.append([scaler.decide(0.0, [pressured]), scaler.decide(5.0, [pressured]),
                     scaler.decide(6.0, [pressured], shed_rate_per_s=2.0),
                     scaler.decide(40.0, [pressured] * 3), scaler.stats()])
    assert outs[0] == outs[1] == [1, 0, 1, 0, {"ups": 2, "downs": 0, "holds": 2}]


def test_autoscaler_ignores_frozen_idle_emas_and_scales_down_like_jax():
    """``test_sim.py:158-173`` on both autoscalers."""
    outs = []
    for cls, config in ((Autoscaler, AutoscalerConfig), (jsim.Autoscaler, jsim.AutoscalerConfig)):
        scaler = cls(config(min_replicas=1, max_replicas=4, cooldown_s=0.0, calm_ticks=2))
        idle = {"depth": 0, "queue_wait_ema_ms": 2400.0, "pool": None}
        busy = {"depth": 3, "queue_wait_ema_ms": 2400.0, "pool": None}
        outs.append([scaler.decide(0.0, [busy, idle]), scaler.decide(5.0, [idle] * 3),
                     scaler.decide(10.0, [idle] * 3), scaler.decide(15.0, [idle] * 2),
                     scaler.decide(20.0, [idle] * 2), scaler.decide(25.0, [idle]), scaler.decide(30.0, [idle])])
    assert outs[0] == outs[1] == [1, 0, -1, 0, -1, 0, 0]


# ------------------------------------------------------------------ simulator


def workload(pkg, seed=3, users=250):
    return pkg.generate_requests(pkg.SyntheticConfig(
        users=users, duration_s=60.0, seed=seed, mean_turns=1.3, burst_every_s=30.0, prompt_len_median=10.0,
        budget_median=8.0, hot_prefix_blocks=2))


def test_synthetic_workload_is_deterministic_and_shaped_like_jax():
    import unionml_tpu_torch.sim as tsim

    reqs = workload(tsim)
    assert reqs == workload(tsim)
    assert [dataclasses.asdict(r) for r in reqs] == [dataclasses.asdict(r) for r in workload(jsim)]
    assert all(a.arrival_s <= b.arrival_s for a, b in zip(reqs, reqs[1:]))
    assert {r.cls for r in reqs} == {"interactive", "standard", "batch"}
    assert all(r.deadline_ms == 2000.0 for r in reqs if r.cls == "interactive")
    assert isinstance(generate_requests(SyntheticConfig(users=5, duration_s=5.0)), list)


SIM_CASES = {
    "autoscaled": (3, dict(num_replicas=2, max_replicas=4), dict(min_replicas=1, max_replicas=4), ()),
    "failover": (9, dict(num_replicas=3, max_replicas=3), None, ((20.0, 0),)),
    "static_affinity": (5, dict(num_replicas=2), None, ()),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_report_equals_jax_on_a_seeded_trace(case):
    """The whole report (sheds, scheduler totals, the router's stats, replica
    seconds, SLO attainment) equals JAX's dict exactly; the ledger balances
    and the pools drain clean."""
    import unionml_tpu_torch.sim as tsim

    seed, shape, scaler, deaths = SIM_CASES[case]
    reports = []
    for pkg in (tsim, jsim):
        config = pkg.SimConfig(**shape, autoscaler=pkg.AutoscalerConfig(**scaler) if scaler else None,
                               deaths=tuple(pkg.ReplicaDeath(at_s=t, replica=r) for t, r in deaths))
        sim = pkg.FleetSimulator(config, workload(pkg, seed=seed))
        reports.append(sim.run())
        assert all(rep.pinned_blocks == 0 and rep.live_blocks == 0 for rep in sim.replicas)
    port, reference = reports
    assert port == reference
    assert port["completed"] + sum(port["shed"].values()) == port["requests"]
    assert port == FleetSimulator(SimConfig(**shape, autoscaler=AutoscalerConfig(**scaler) if scaler else None,
                                            deaths=tuple(ReplicaDeath(at_s=t, replica=r) for t, r in deaths)),
                                  workload(tsim, seed=seed)).run()
    if deaths:
        assert port["dead_replicas"] == [0] and port["failover_adoptions"] >= 1


def test_router_hot_digests_warm_a_scaled_up_replica():
    """``test_sim.py:235-248`` on both routers."""
    outs = []
    for router in (Router(2, block_size=4), JaxRouter(2, block_size=4)):
        prompt = list(range(16))
        chosen, decision = router.route(prompt, [(0, 1.0, 0.0), (1, 1.0, 0.0)])
        assert decision["digest_blocks"] == 4
        hot = router.hot_digests(8)
        assert hot and len(hot) == len(set(hot))
        router.warm_replica(1 - chosen, hot)
        _, warmed = router.route(prompt, [(1 - chosen, 1.0, 0.0)])
        assert warmed["matched_blocks"] == 4 and router.hot_digests(0) == []
        outs.append((hot, router.stats()))
    assert outs[0] == outs[1]


# -------------------------------------------------------------- golden replay


@pytest.fixture(scope="module")
def model():
    return init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0), device="cpu")


def gated(engine, gate):
    """Hold the engine's decode while ``gate`` is clear (``step`` waits 10 ms
    and returns no events, so the worker keeps admitting and preempting)."""
    real = engine.step

    def step(lookahead=1):
        if not gate.is_set():
            gate.wait(0.01)
            return []
        return real(lookahead)

    engine.step = step
    return engine


def until(predicate, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError("state never reached")
        time.sleep(0.005)


def test_golden_replay_matches_live_fleet_counters(model, tmp_path):
    """``test_sim.py:271-345`` on the port: every session is pinned to replica
    0 (one slot), so the batch head runs, the flood overflows the bound-3
    queue, and the late interactive request displaces a queued batch one and
    preempts the head. The journal alone then reproduces the live counters:
    sheds by reason, preemptions, resumes, deadline misses, adoptions and the
    SLO ledger; it loads into equal records in the JAX package, and the port's
    ``fit_cost_model`` agrees with JAX's on it within 1e-9."""
    path = tmp_path / "journal.jsonl"
    tel = Telemetry(journal_path=str(path))
    gate = threading.Event()
    engines = [gated(DecodeEngine(model, num_slots=1, max_len=64, prefill_buckets=(8, 16), prefix_cache_blocks=64,
                                  block_size=4, device="cpu"), gate) for _ in range(2)]
    fleet = EngineFleet(engines, supervisors=[EngineSupervisor(watchdog_interval_s=0) for _ in engines],
                        telemetry=tel, scheduler=SchedulerConfig(max_queue=3, aging_s=120.0))
    for sid in ("s0", "s1", "s2"):
        fleet.router._sessions[sid] = (0, fleet.router._time())
    rep0 = fleet.replicas[0]

    async def drive():
        head = asyncio.ensure_future(fleet.generate([3, 1, 4, 1, 5], 32, session_id="s0", priority="batch",
                                                    request_id="req-head"))
        await asyncio.to_thread(until, lambda: engines[0].num_active == 1)
        flood = [asyncio.ensure_future(fleet.generate([2, 7, 1], 8, session_id="s1", priority="batch",
                                                      request_id=f"req-b{i}")) for i in range(5)]
        await asyncio.sleep(0)
        vip = asyncio.ensure_future(fleet.generate([6, 2], 6, session_id="s2", priority="interactive",
                                                   request_id="req-vip"))
        await asyncio.to_thread(until, lambda: rep0.batcher.scheduler.preemptions >= 1)
        gate.set()
        return await asyncio.gather(head, *flood, vip, return_exceptions=True)

    try:
        results = asyncio.run(drive())
        live_sched = [r.batcher.scheduler.stats() for r in fleet.replicas]
        live_slo = tel.slo.totals()
        live_ok, live_shed = int(tel.requests_total.value("ok")), int(tel.requests_total.value("shed"))
    finally:
        gate.set()
        fleet.close()
    assert any(isinstance(r, Exception) for r in results) and any(isinstance(r, list) for r in results)
    records = load_journal(str(path))
    replay = replay_journal(records)
    assert all(r.version == JOURNAL_SCHEMA_VERSION for r in records) and replay["records"] == len(results)
    assert replay["shed"].get("queue_full", 0) >= 1 and replay["preemptions"] >= 1 and replay["resumes"] >= 1
    assert replay["status"].get("ok", 0) == live_ok and sum(replay["shed"].values()) == live_shed
    assert replay["shed"].get("queue_full", 0) + replay["shed"].get("displaced", 0) == sum(
        s["shed_queue_full"] for s in live_sched)
    for key in ("preemptions", "resumes", "deadline_misses_queued", "deadline_misses_running"):
        assert replay[key] == sum(s[key] for s in live_sched), key
    assert replay["failover_adoptions"] == 0 and replay["slo_totals"] == live_slo
    assert replay["block_demand_violations"] == 0
    admitted = [r for r in records if r.first_span("admitted")]
    assert admitted and all(r.block_demand is not None for r in admitted)
    assert {r.session_id for r in records} <= {"s0", "s1", "s2"}
    # the port's journal is the JAX package's format: equal records, replay and fit
    jrecords = jsim.load_journal(str(path))
    assert [fields(r) for r in records] == [fields(r) for r in jrecords]
    assert replay == jsim.replay_journal(jrecords)
    default = CostModel(dispatch_ms=0.0)
    assert_models_agree(fit_cost_model(records * 4, default=default),
                        jsim.fit_cost_model(jrecords * 4, default=jsim.CostModel(dispatch_ms=0.0)))
