"""Port parity: serving telemetry (metrics registry, SLO tracker, traces,
journal, engine and batcher hooks, routes) against the JAX package's.

The host modules run the cases of ``tests/unit/test_telemetry.py:91-280``
and ``tests/unit/test_slo.py`` and seeded random operation sequences on
both packages under one fake clock (the modules' ``time`` patched), so
``render()``, snapshots, SLO reports, traces and journal lines must be
equal byte for byte. The engine and batcher schedules are fixed (the worker
loop runs on the test thread, as in ``test_torch_slo_batcher.py``) over the
same tiny GPT: span kinds with their attrs less durations, and every counter,
must equal JAX's. No test compares a measured duration.
"""

import asyncio
import json
import random
import types

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import unionml_tpu.serving.metrics as j_metrics
import unionml_tpu.serving.slo as j_slo
import unionml_tpu.serving.telemetry as j_tel
import unionml_tpu_torch.serving.metrics as t_metrics
import unionml_tpu_torch.serving.slo as t_slo
import unionml_tpu_torch.serving.telemetry as t_tel
from tests.test_torch_prefix_cache import Pair, leaks
from tests.test_torch_slo_batcher import (
    HOG,
    HOG_BUDGET,
    INTER,
    INTER_BUDGET,
    Sink,
    _Worker,
    batcher_for,
    run,
    submit,
)
from unionml_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from unionml_tpu.serving.speculative import SpeculativeEngine as JaxSpeculativeEngine
from unionml_tpu.serving.supervisor import EngineSupervisor as JaxSupervisor
from unionml_tpu_torch.serving import ContinuousBatcher, DecodeEngine, EngineSupervisor, SpeculativeEngine
from unionml_tpu_torch.serving.app import metrics_answer, trace_answer, traces_recent_answer

PACKAGES = {"torch": (t_metrics, t_slo, t_tel), "jax": (j_metrics, j_slo, j_tel)}
#: histograms of measured times: only their counts are comparable
TIMED = ("unionml_ttft_ms", "unionml_itl_ms", "unionml_queue_wait_ms", "unionml_decode_fetch_ms")
#: set from measured TTFTs (a JAX compile can miss an objective) or named per package
NOT_COMPARED = ("unionml_slo_attainment", "unionml_slo_burn_rate", "unionml_paged_attn_impl")


@pytest.fixture(scope="module")
def gpt():
    return Pair()


@pytest.fixture
def clock(monkeypatch):
    """One fake clock behind ``time`` in both packages' slo and telemetry."""
    fake = types.SimpleNamespace(t=1000.0)
    stub = types.SimpleNamespace(perf_counter=lambda: fake.t, monotonic=lambda: fake.t, time=lambda: fake.t)
    for mod in (t_slo, t_tel, j_slo, j_tel):
        monkeypatch.setattr(mod, "time", stub)
    return fake


def both(fn, *args):
    """``fn(*modules, *args)`` for each package; the port's result, asserted equal to JAX's."""
    port, jax = (fn(*PACKAGES[kind], *args) for kind in ("torch", "jax"))
    assert port == jax
    return port


def raised(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


# ------------------------------------------------------------------ metrics


def registry_case(metrics, slo, tel, case):
    reg = metrics.MetricsRegistry()
    if case == "buckets":
        return [metrics.log_buckets(0.25, 2.0, 17), metrics.log_buckets(1.0, 2.0, 12)] + [
            raised(lambda b=b: metrics.log_buckets(*b)) for b in [(0.0, 2.0, 4), (1.0, 1.0, 4), (1.0, 2.0, 0)]]
    if case == "boundaries":
        h = reg.histogram("t_ms", "test", (1.0, 2.0, 4.0))
        for v in [0.5, 1.0, 1.5, 2.0, 4.0, 100.0]:
            h.observe(v)
        return [reg.render(), h._snapshot(), raised(lambda: reg.histogram("dup", "t", (1.0, 1.0))),
                raised(lambda: reg.histogram("none", "t", ()))]
    if case == "golden":
        reg.counter("app_requests_total", "Requests by outcome", ("outcome",)).inc(2.0, "ok")
        reg.counter("app_requests_total", "Requests by outcome", ("outcome",)).inc(1.0, "error")
        reg.gauge("app_active", "In-flight requests").set(3)
        h = reg.histogram("app_wait_ms", "Queue wait", (1.0, 10.0), ("cls",))
        h.observe(0.5, "interactive")
        h.observe(25.0, "interactive")
        return reg.render()
    if case == "families":
        a = reg.counter("x_total", "x", ("k",))
        return [reg.counter("x_total", "x", ("k",)) is a, raised(lambda: reg.gauge("x_total", "x", ("k",))),
                raised(lambda: reg.counter("x_total", "x", ("other",))), raised(lambda: a.inc(1.0))]
    rng = random.Random(case)  # a seed: random operations over every kind
    labels = ["ok", "error", 'quo"te', "back\\slash", "new\nline", "é"]
    fams = [reg.counter("c_total", "counter", ("outcome",)), reg.counter("plain_total", "counter"),
            reg.gauge("g", "gauge", ("cls", "window")), reg.gauge("g_plain", "gauge"),
            reg.histogram("h_ms", "hist", metrics.log_buckets(0.25, 2.0, 17), ("cls",)),
            reg.histogram("h_plain", "hist", (1.0, 2.5, 1e3))]
    for _ in range(200):
        fam = rng.choice(fams)
        lab = [rng.choice(labels) for _ in fam.label_names]
        value = rng.choice([1.0, 0.1, 1e-7, 3.0, 2.5e9, rng.random() * 100, float(rng.randint(0, 9))])
        if isinstance(fam, metrics.Histogram):
            fam.observe(value, *lab)
        elif isinstance(fam, metrics.Gauge):
            getattr(fam, rng.choice(["set", "inc", "dec"]))(value, *lab)
        else:
            fam.inc(value, *lab)
    return reg.render(), reg.snapshot()


@pytest.mark.parametrize("case", ["buckets", "boundaries", "golden", "families", 0, 1, 2, 3])
def test_registry_matches_jax(case):
    """``log_buckets``, bucket boundaries (``le`` is <=, the implicit
    ``+Inf``), the golden exposition, idempotent families with type and
    label checks, and 200 seeded random operations: the same text and
    snapshot, the same errors."""
    out = both(registry_case, case)
    if case == "golden":
        assert out.startswith("# HELP app_active In-flight requests\n# TYPE app_active gauge\napp_active 3\n")


# ---------------------------------------------------------------------- slo


def slo_case(metrics, slo, tel, case):
    if case == "validation":
        return [raised(lambda: slo.SLOObjective(ttft_ms=100.0, target=1.0)),
                raised(lambda: slo.SLOObjective(ttft_ms=0.0, target=0.9)),
                raised(lambda: slo.SLOConfig(windows=())),
                raised(lambda: slo.SLOConfig(objectives={"interactive": slo.SLOObjective(250.0, 0.99)})),
                slo.SLOConfig().windows, slo.SLOTracker().report(now=0.0), slo.SLOTracker().totals()]
    rng = random.Random(case)
    config = slo.SLOConfig(
        objectives={"interactive": slo.SLOObjective(ttft_ms=100.0, target=0.9),
                    "standard": slo.SLOObjective(ttft_ms=rng.choice([500.0, 100.0]), target=0.5),
                    "batch": slo.SLOObjective(ttft_ms=None, target=0.5)},
        windows=(("10s", 10.0), ("60s", 60.0)), alert_burn=rng.choice([1.0, 2.0, 14.4]))
    tracker, now, out = slo.SLOTracker(config), 0.0, []
    for i in range(300):
        now += rng.choice([0.0, 0.1, 1.0, 7.5])
        ttft = rng.choice([None, 50.0, 100.0, 100.001, 499.0, 600.0, rng.random() * 700])
        out.append(tracker.record(rng.choice(["interactive", "standard", "batch", "mystery"]),
                                  rng.choice(["ok", "ok", "ok", "error", "shed", "cancelled"]), ttft, now=now))
        if i % 37 == 0:
            out.append(tracker.report(now=now + rng.choice([0.0, 12.0, 70.0])))
    return out, tracker.totals(), tracker.report(now=now)


@pytest.mark.parametrize("case", ["validation", 0, 1, 2, 3])
def test_slo_tracker_matches_jax(case):
    """``test_slo.py``'s validation and empty report, then 300 seeded random
    records (every class, status and boundary TTFT) with reports at window
    edges: equal signals, totals and reports."""
    both(slo_case, case)


# ------------------------------------------------------------------- traces


def trace_case(metrics, slo, tel, case, path, fake):
    fake.t = 1000.0  # each package's run starts at the same time
    t = tel.Telemetry(journal_path=str(path / f"{tel.__name__}.jsonl"), journal_size=3, max_spans=5)
    if case == "lifecycle":  # test_telemetry.py:173-272
        rid = t.new_trace("r0", cls="interactive")
        t.span(rid, "admission", prompt_tokens=5)
        t.note_tokens_in(rid, 5)
        t.decode_tokens(rid, 1, at=fake.t + 0.010, block_ms=0.8)
        t.decode_tokens(rid, 3, at=fake.t + 0.040, block_ms=0.9)
        fake.t += 0.05
        t.end_trace(rid, "ok")
        t.span("nope", "admission")
        t.decode_tokens("nope", 1)
        t.end_trace("nope")
        capped = t.new_trace("capped")
        for i in range(7):
            t.span(capped, "prefill_chunk", i=i)
        t.end_trace(capped, "ok")
        assert t.new_trace("abc", cls="interactive") == t.new_trace("abc") == "abc"
        t.end_trace("abc", "ok")
        for name in ("r1", "r2", "r3"):
            t.new_trace(name, session_id="s" if name == "r1" else None)
            t.span(name, "admission", block_demand=4, available_blocks=64)
            t.end_trace(name, "shed" if name == "r2" else "ok", reason="queue_full" if name == "r2" else None)
    else:
        rng = random.Random(case)
        ids = [f"r{i}" for i in range(6)]
        for _ in range(250):
            fake.t += rng.choice([0.0, 0.001, 0.02, 0.3])
            rid, op = rng.choice(ids + [None]), rng.random()
            if op < 0.15:
                t.new_trace(rid, cls=rng.choice(["standard", "interactive", "batch"]),
                            session_id=rng.choice([None, "sess"]), tag=rng.randint(0, 3))
            elif op < 0.45:
                t.span(rid, rng.choice(["admission", "queue_wait", "prefill", "block_alloc"]),
                       dur_ms=rng.choice([None, 1.5]), tokens=rng.randint(1, 9))
            elif op < 0.6:
                t.note_tokens_in(rid, rng.randint(1, 30))
            elif op < 0.8:
                t.decode_tokens(rid, rng.randint(1, 4), at=fake.t, block_ms=rng.choice([None, 0.7, 40.0]))
            elif op < 0.85:
                t.set_class(rid, rng.choice(["interactive", "batch"]))
            else:
                t.end_trace(rid, rng.choice(["ok", "error", "shed", "cancelled"]),
                            reason=rng.choice([None, "nan_logits"]))
    t.assert_balanced(allow_active=True)
    stats = dict(t.stats(), journal_path=None)
    lines = (path / f"{tel.__name__}.jsonl").read_text().splitlines()
    return [t.get_trace(r) for r in ("r0", "r1", "r2", "r3", "abc", "capped")], t.recent(), stats, lines, \
        t.metrics.render(), t.slo.report()


@pytest.mark.parametrize("case", ["lifecycle", 0, 1, 2])
def test_traces_and_journal_match_jax(case, tmp_path, clock):
    """The trace lifecycle with TTFT/ITL from decode stamps, unknown ids as
    no-ops, the span cap, the idempotent join, the ring bound, the JSONL v2
    journal (session id, pool arithmetic), and 250 seeded random operations:
    equal traces, ring, stats, journal lines, ``/metrics`` text and SLO
    report."""
    traces, recent, stats, lines, text, _ = both(trace_case, case, tmp_path, clock)
    assert all(json.loads(line)["v"] == j_tel.JOURNAL_SCHEMA_VERSION == 2 for line in lines)
    if case == "lifecycle":
        assert [r["request_id"] for r in recent] == ["r1", "r2", "r3"] and stats["completed_traces"] == 6
        assert traces[4] is None and traces[5] is None and len(lines) == 6  # evicted from the ring of 3
        life, capped = json.loads(lines[0]), json.loads(lines[1])
        assert [s["kind"] for s in life["spans"]] == ["admission", "decode", "end"] and life["itl_ms"] == 10.0
        assert capped["attrs"]["spans_dropped"] == 2 and stats["spans_dropped"] == 2


# ------------------------------------------------------- engine and batcher


def metric_values(t):
    """Every family's snapshot, timed histograms as counts only."""
    snap = t.metrics.snapshot()
    out = {}
    for name, value in snap.items():
        if name in NOT_COMPARED:
            continue
        if name in TIMED:
            value = {k: v["count"] for k, v in value.items()} if "count" not in value else value["count"]
        out[name] = value
    return out


def shape(t):
    """Completed traces in ring order: class, status, reason, token counts
    and (kind, attrs) of each span; no durations, stamps or ids."""
    return [(tr["class"], tr["status"], tr.get("reason"), tr["tokens_in"], tr["tokens_out"], tr["decode_bursts"],
             [(s["kind"], s.get("attrs")) for s in tr["spans"]]) for tr in t.recent(1000)]


def traced_batcher(gpt, kind, *, faults=None, sup=False, spec=False, **kw):
    """``batcher_for`` with telemetry (and a supervisor, a fault plan, or a
    self-drafting speculative engine) attached."""
    tel = (t_tel if kind == "torch" else j_tel).Telemetry()
    if spec:
        kw_e = dict(num_slots=2, max_len=64, prefill_buckets=(8, 16, 32))
        engine = (SpeculativeEngine(gpt.tmodel, gpt.tmodel, gamma_max=2, block_size=4, device="cpu", **kw_e)
                  if kind == "torch" else
                  JaxSpeculativeEngine(gpt.jmodel, gpt.variables, gpt.jmodel, gpt.variables, gamma_max=2,
                                       prefix_block_size=4, **kw_e))
        batcher = ContinuousBatcher(engine, device="cpu") if kind == "torch" else JaxBatcher(engine)
        batcher._worker = _Worker()
    else:
        batcher = batcher_for(gpt, kind, faults=faults, **kw)
    if sup:
        batcher.supervisor = (EngineSupervisor if kind == "torch" else JaxSupervisor)(
            watchdog_interval_s=0, backoff_s=0.001, backoff_max_s=0.002)
        batcher.supervisor.attach(batcher.engine)
    batcher.attach_telemetry(tel)
    return batcher, tel


SCHEDULES = ["plain", "prefix_hit", "preempt_resume", "quarantine", "recovery", "speculative"]


def schedule(gpt, kind, name):
    """One fixed schedule through a traced batcher: streams, trace shapes,
    counters, and the engine's own stats to hold the counters against."""
    kw = dict(spec=name == "speculative", sup=name == "recovery", num_slots=1 if name == "preempt_resume" else 2,
              faults={"quarantine": dict(nan_logits=((5, 0),)), "recovery": dict(step_dispatch_failures=(4,))}.get(
                  name), pool="int8")
    batcher, t = traced_batcher(gpt, kind, **kw)
    sinks = [Sink(i) for i in range(3)]
    if name == "preempt_resume":
        sinks[1] = Sink(1, lambda n: n == 5 and submit(batcher, INTER, INTER_BUDGET, sinks[2], priority="interactive"))
        submit(batcher, HOG, HOG_BUDGET, sinks[1], priority="batch")
    elif name == "speculative":
        submit(batcher, INTER, 10, sinks[0], priority="interactive")
        submit(batcher, HOG, 10, sinks[1], priority="interactive")
    else:
        system = [5, 3, 8, 1, 9, 2, 6, 4]  # two full blocks of 4
        submit(batcher, system + [7], 8, sinks[0])
        if name == "prefix_hit":
            run(batcher)
            batcher._worker = _Worker()
        submit(batcher, system + [2, 2] if name == "prefix_hit" else [2, 7, 1], 6, sinks[1])
    run(batcher)
    t.assert_balanced()
    engine = batcher.engine
    own = dict(tokens=sum(len(s.tokens) for s in sinks), sched=batcher.scheduler.stats(), leaks=leaks(engine),
               cache=engine.prefix_cache.stats() if engine.prefix_cache is not None else None,
               spec=(engine.spec_proposed, engine.spec_accepted) if name == "speculative" else None)
    own["sched"].pop("queue_wait_ema_ms"), own["sched"].pop("per_class")
    return [s.result() for s in sinks], shape(t), metric_values(t), own


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_traces_and_counters_match_jax(gpt, name):
    """A plain request, a prefix hit, a preemption and its resume, a NaN
    quarantine, a supervised recovery (its ``salvaged`` span) and a
    speculative request's acceptance counters: port == JAX in streams, span
    kinds and attrs, and every counter; the counters equal the engine's own
    statistics, and each trace opens with ``admission`` and ends with ``end``."""
    streams, traces, counters, own = port = schedule(gpt, "torch", name)
    assert port == schedule(gpt, "jax", name)
    assert counters["unionml_tokens_out_total"] == own["tokens"] > 0
    for cls, status, reason, _, _, _, spans in traces:
        kinds = [k for k, _ in spans]
        assert kinds[0] == "admission" and kinds[-1] == "end" and spans[-1][1]["status"] == status
        assert status != "ok" or kinds.index("queue_wait") < kinds.index("admitted") < kinds.index("decode")
    kinds = [k for tr in traces for k, _ in tr[-1]]
    if own["cache"] is not None:
        assert counters["unionml_prefix_hit_tokens_total"] == own["cache"]["hit_tokens"]
    if name == "prefix_hit":
        assert own["cache"]["hit_tokens"] == 8 and "prefix_hit" in kinds
    if name == "preempt_resume":
        assert counters["unionml_preemptions_total"] == counters["unionml_resumes_total"] == 1
        assert own["sched"]["preemptions"] == own["sched"]["resumes"] == 1 and "preempted" in kinds
    if name == "quarantine":
        assert counters["unionml_quarantines_total"] == 1 and ("error", "nan_logits") in [t[1:3] for t in traces]
    if name == "recovery":
        assert "salvaged" in kinds and counters["unionml_rebuilds_total"] >= 1
    if name == "speculative":
        assert (counters["unionml_spec_proposed_total"], counters["unionml_spec_accepted_total"]) == own["spec"]
        assert own["spec"][0] > 0 and "speculation" in kinds and "draft_prefill" in kinds


def test_telemetry_adds_no_host_reads_of_a_tensor(gpt, monkeypatch):
    """The CPU counterpart of JAX's transfer-guard test: over the same
    steady steps, telemetry on calls ``Tensor.item``/``.cpu``/``.tolist``/
    ``.to`` no more often than telemetry off, and its hooks did fire."""
    calls = {"n": 0}
    for name in ("item", "cpu", "tolist", "to"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _real=real, **k: (
            calls.__setitem__("n", calls["n"] + 1), _real(self, *a, **k))[1])

    def steady(tel):
        engine = DecodeEngine(gpt.tmodel, num_slots=2, max_len=64, prefill_buckets=(8,), telemetry=tel,
                              device="cpu")
        engine.admit_many([([3, 1, 4, 1, 5], 30), ([2, 7], 30)])
        engine.step(), engine.step()
        calls["n"] = 0
        for lookahead in (1, 1, 1, 4):
            engine.step(lookahead)
        return calls["n"]

    tel = t_tel.Telemetry()
    assert steady(tel) <= steady(None)
    assert tel.decode_fetch_ms._snapshot()["count"] >= 4 and tel.tokens_out_total.value() > 0


def test_routes_match_jax(gpt):
    """``/metrics``, ``/trace/{id}`` and ``/traces/recent`` through their
    plain functions against JAX's routes (200, 404 ``not_enabled``, 404
    ``trace_not_found``, 400 on a bad ``n``), and one aiohttp run of
    ``/generate`` → ``/trace/{request_id}`` → ``/stats`` on the port."""
    from unionml_tpu.serving import build_aiohttp_app as j_build_app
    from unionml_tpu_torch.serving import build_aiohttp_app as t_build_app

    stub = types.SimpleNamespace(name="obs-app", artifact=object())

    async def jax_answers(app):
        async with TestClient(TestServer(app)) as client:
            out = []
            for path in ("/metrics", "/trace/deadbeef00000000", "/traces/recent?n=x", "/traces/recent?n=2"):
                resp = await client.get(path)
                text = await resp.text()
                out.append((resp.status, text if path == "/metrics" and resp.status == 200 else json.loads(text)))
            return out

    def port_answers(tel):
        return [metrics_answer(tel), trace_answer(tel, "deadbeef00000000"), traces_recent_answer(tel, "x"),
                traces_recent_answer(tel, "2")]

    jax_off = asyncio.run(jax_answers(j_build_app(stub, resident=False, coalesce=False, generate_telemetry=False,
                                                  generator=lambda: gpt.engine("jax", num_slots=1))))
    assert [(s, b) for s, b, _ in port_answers(None)] == jax_off and jax_off[0][0] == 404
    jax_on = asyncio.run(jax_answers(j_build_app(stub, resident=False, coalesce=False,
                                                 generator=lambda: gpt.engine("jax", num_slots=1))))
    on = port_answers(t_tel.Telemetry())
    assert [(s, b) for s, b, _ in on[1:]] == jax_on[1:] and [s for s, _, _ in on] == [200, 404, 400, 200]
    assert on[0][2]["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8" and on[0][1] == jax_on[0][1]

    app = t_build_app(stub, resident=False, coalesce=False, device="cpu",
                      generator=lambda: gpt.engine("torch", num_slots=1))

    async def port_http():
        async with TestClient(TestServer(app)) as client:
            body = await (await client.post("/generate", json={"prompt_ids": [3, 1, 4], "max_new_tokens": 6})).json()
            trace = await (await client.get(f"/trace/{body['request_id']}")).json()
            text = await (await client.get("/metrics")).text()
            stats = await (await client.get("/stats")).json()
            return body, trace, text, stats

    body, trace, text, stats = asyncio.run(port_http())
    assert trace["request_id"] == body["request_id"] and trace["status"] == "ok" and len(body["tokens"]) == 6
    assert [s["kind"] for s in trace["spans"]][::len(trace["spans"]) - 1] == ["admission", "end"]
    assert 'unionml_requests_total{outcome="ok"} 1' in text and "unionml_ttft_ms_bucket" in text
    assert stats["telemetry"]["metrics"]["unionml_tokens_out_total"] == 6.0
    assert stats["generation"]["slo"]["per_class"]["standard"]["total"] == 1
    assert stats["telemetry"]["completed_traces"] == 1
