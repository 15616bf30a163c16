"""The port's graftlint (``unionml_tpu_torch.analysis``) against the JAX package's.

- **Parity**: every framework-neutral case of ``tests/unit/test_graftlint.py``
  and ``tests/unit/test_cfg.py`` (lock discipline, lock order, async,
  swallowed exceptions, resources, races, suppressions, the clean fixture,
  the CFG snippets, baselines and SARIF) is written to ``tmp_path`` and
  linted by both linters: the findings must be identical. The corpus is
  imported, not copied.
- **Torch twins** of the JAX host-sync and retrace repros fire at the lines
  JAX's fire on its own repro; a clean twin has no finding.
- The lock-key ordering fixture (a module-level lock and a class lock in one
  cycle), the port tree linted clean, mutation twins on the port's live
  sources, the CLI.
- **Dynamic agreement**: the syncing operators a few ``DecodeEngine.step``
  calls run (``_graphs._HostSyncCheck``'s set) lie off the linter's hot set
  or at a reasoned suppression, and a seeded ``.item()`` is caught.

One intra-op thread; the fixtures are strings, so ``tests/`` holds no real
``hot-path`` root.
"""

import ast
import json
import pathlib
import tempfile
import textwrap
import time
import traceback

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.unit import test_cfg as cfg_corpus
from tests.unit import test_graftlint as corpus
from unionml_tpu.analysis import baseline_payload as jax_baseline_payload
from unionml_tpu.analysis import run_lint as jax_run_lint
from unionml_tpu.analysis.cfg import build_cfg as jax_build_cfg
from unionml_tpu_torch import _graphs
from unionml_tpu_torch.analysis import baseline_payload, load_baseline, run_lint
from unionml_tpu_torch.analysis.__main__ import main as lint_main
from unionml_tpu_torch.analysis.cfg import build_cfg
from unionml_tpu_torch.analysis.core import Project
from unionml_tpu_torch.analysis.rules_host_sync import runtime_site
from unionml_tpu_torch.models import GPTConfig, init_gpt
from unionml_tpu_torch.serving.continuous import DecodeEngine

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "unionml_tpu_torch"
SCHEMA = REPO / "tests" / "unit" / "sarif_2_1_0_schema.json"


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ parity

def _swallowed_suppressed(reason: str = " -- fixture: best-effort probe", rule: str = "swallowed-exception") -> str:
    return corpus.SWALLOWED_REPRO.replace(
        "    except Exception:\n        pass",
        f"    except Exception:  # graftlint: disable={rule}{reason}\n        pass",
    )


def _cfg_snippets():
    """The source of every ``_cfg(...)`` call in ``tests/unit/test_cfg.py``."""
    tree = ast.parse(pathlib.Path(cfg_corpus.__file__).read_text())
    out = []
    for test in tree.body:
        if not isinstance(test, ast.FunctionDef) or not test.name.startswith("test_"):
            continue
        calls = [n for n in ast.walk(test) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "_cfg"]
        for i, call in enumerate(calls):
            out.append((f"cfg-{test.name}-{i}", textwrap.dedent(call.args[0].value)))
    return out


#: (case, source, kind): ``lint`` compares findings and suppressions,
#: ``cfg`` also every function's CFG, ``baseline`` the baseline payloads,
#: ``sarif`` the SARIF results
PARITY_CASES = [
    ("locks", corpus.LOCKS_REPRO, "lint"),
    ("swallowed", corpus.SWALLOWED_REPRO, "lint"),
    ("swallowed-clean", corpus.SWALLOWED_CLEAN, "lint"),
    ("swallowed-clean-v3", corpus.SWALLOWED_CLEAN_V3, "lint"),
    ("lock-order", corpus.LOCK_ORDER_REPRO, "lint"),
    ("async", corpus.ASYNC_REPRO, "lint"),
    ("resources", corpus.RESOURCE_REPRO, "lint"),
    ("resources-clean", corpus.RESOURCE_CLEAN, "lint"),
    ("races", corpus.RACES_REPRO, "lint"),
    ("lock-leaf", corpus.LOCK_LEAF_REPRO, "lint"),
    ("callback", corpus.CALLBACK_REPRO, "lint"),
    ("races-clean", corpus.RACES_CLEAN, "lint"),
    ("clean", corpus.CLEAN, "lint"),
    ("suppression-with-reason", _swallowed_suppressed(), "lint"),
    ("suppression-without-reason", _swallowed_suppressed(reason=""), "lint"),
    ("suppression-unknown-rule", _swallowed_suppressed(rule="not-a-rule"), "lint"),
    ("parse-error", "def oops(:\n", "lint"),
    ("baseline-resources", corpus.RESOURCE_REPRO, "baseline"),
    ("baseline-races", corpus.RACES_REPRO, "baseline"),
    ("sarif-races", corpus.RACES_REPRO, "sarif"),
    ("sarif-lock-order", corpus.LOCK_ORDER_REPRO, "sarif"),
] + [(name, source, "cfg") for name, source in _cfg_snippets()]


def _rows(findings):
    """(rule, path, line, col, message); an unknown-rule message ends in each
    linter's own catalog ('(known: ...)'), which is cut."""
    return [(f.rule, f.path, f.line, f.col, f.message.split(" (known: ")[0]) for f in findings]


def _cfg_shape(cfg):
    return [(b.id, b.kind, b.line, [(e.dst, e.kind, e.explicit) for e in b.edges])
            for b in sorted(cfg.blocks.values(), key=lambda b: b.id)]


def _sarif_results(doc):
    return [{k: r[k] for k in ("ruleId", "level", "message", "locations", "partialFingerprints")}
            for r in doc["runs"][0]["results"]]


@pytest.mark.parametrize("case, source, kind", PARITY_CASES, ids=[c[0] for c in PARITY_CASES])
def test_parity_with_the_jax_linter(tmp_path, case, source, kind):
    f = tmp_path / f"{case.replace('-', '_')}.py"
    f.write_text(source)
    mine, theirs = run_lint([str(f)]), jax_run_lint([str(f)])
    assert _rows(mine.findings) == _rows(theirs.findings)
    assert _rows(mine.suppressed) == _rows(theirs.suppressed)
    assert [s.reason for s in mine.suppressed] == [s.reason for s in theirs.suppressed]
    if kind == "cfg":
        for fn in ast.parse(source).body:
            assert _cfg_shape(build_cfg(fn)) == _cfg_shape(jax_build_cfg(fn))
    elif kind == "baseline":
        assert baseline_payload(mine.findings) == jax_baseline_payload(theirs.findings)
        baseline = tmp_path / "baseline.json"
        baseline.write_text(json.dumps(baseline_payload(mine.findings)))
        again = run_lint([str(f)], baseline=load_baseline(str(baseline)))
        assert again.ok and len(again.baselined) == len(mine.findings)
    elif kind == "sarif":
        jsonschema = pytest.importorskip("jsonschema")
        jsonschema.validate(mine.sarif(), json.loads(SCHEMA.read_text()))
        assert _sarif_results(mine.sarif()) == _sarif_results(theirs.sarif())


# ------------------------------------------------------------- torch twins

#: HOST_SYNC_REPRO's torch twin, line for line: a compiled body that copies
#: to the host twice (line 8), a synchronize a hot root reaches through a
#: helper (line 11), a device value fetched on the hot path (line 14)
HOST_SYNC_TWIN = '''
import torch
import torch.nn.functional as F
import numpy as np

@torch.compile
def traced(x):
    return x.cpu() + x.sum().item()

def fetch_helper(x):
    return torch.cuda.synchronize()

def steady(x):  # graftlint: hot-path
    return fetch_helper(x.cuda().tolist())
'''

#: RETRACE_REPRO's twin: a capture key from a runtime size and a compiled
#: callable called on the spot (line 10), a compile inside a loop (line 14)
RECAPTURE_TWIN = '''
import torch

def capture(key, fn):
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        fn()
    return key

def sites(x):
    return capture(x.shape, lambda: x * 2), torch.compile(sites)(x)

def churn(xs):
    for x in xs:
        h = torch.compile(lambda v: v + 1)
    return h
'''

#: what the engine does, linted clean: numpy mirrors, a pinned fetch buffer
#: read with .numpy(), shape arithmetic, a captured body of device ops
CLEAN_TWIN = '''
import numpy as np
import torch

def capture(fn):
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        return fn()

class Engine:
    def __init__(self, n):
        self._active = np.zeros(n, dtype=bool)
        self._temp = np.ones(n, dtype=np.float32)
        self._lens = torch.zeros(n, dtype=torch.int32, device="cuda")

    def _burst(self, steps):
        for _ in range(steps):
            self._lens.copy_(torch.where(self._lens > 0, self._lens + 1, self._lens))
        return self._lens.clone()

    def step(self, steps):  # graftlint: hot-path
        sampling = bool((self._temp[self._active] > 0).any())
        out = capture(lambda: self._burst(steps))
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        rows = int(out.shape[0]) + len(self._active)
        return host.numpy(), sampling, rows
'''


def _lines(source, tmp_path, name, linter):
    f = tmp_path / f"{name}.py"
    f.write_text(source)
    return sorted(x.line for x in linter([str(f)]).findings)


def test_host_sync_twin_fires_where_jax_fires(tmp_path):
    want = _lines(corpus.HOST_SYNC_REPRO, tmp_path, "jax_hs", jax_run_lint)
    f = tmp_path / "hs.py"
    f.write_text(HOST_SYNC_TWIN)
    result = run_lint([str(f)])
    assert {x.rule for x in result.findings} == {"host-sync"}
    assert sorted(x.line for x in result.findings) == want == [8, 8, 11, 14]
    by_line = {x.line: x for x in result.findings}
    assert "captured: traced" in by_line[8].message
    assert "hot: steady -> fetch_helper" in by_line[11].message
    assert ".tolist()" in by_line[14].message and "hot: steady" in by_line[14].message


def test_recapture_twin_fires_where_jax_retrace_fires(tmp_path):
    want = sorted(set(_lines(corpus.RETRACE_REPRO, tmp_path, "jax_rt", jax_run_lint)))
    f = tmp_path / "rt.py"
    f.write_text(RECAPTURE_TWIN)
    result = run_lint([str(f)])
    assert {x.rule for x in result.findings} == {"recapture"}
    assert sorted({x.line for x in result.findings}) == want == [10, 14]
    messages = "\n".join(x.message for x in result.findings)
    assert "runtime size" in messages and "on the spot" in messages and "inside a loop" in messages


def test_clean_twin_is_finding_free(tmp_path):
    f = tmp_path / "engine.py"
    f.write_text(CLEAN_TWIN)
    result = run_lint([str(f)])
    assert result.ok, [x.format() for x in result.findings]
    project = Project([str(f)])
    assert {fn.qualname for fn in project.graph.trace_roots()} == {"Engine._burst"}
    assert {key[1]: names for key, names in project.graph.wrappers.items()} == {"capture": {"fn"}}


#: the sharding rule's seeds: a spec axis no mesh declares (line 10), a
#: sharding cut off another mesh than the function's own (line 11); the
#: JAX twin spells the specs JAX's way
SHARDING_TWIN = """\
from unionml_tpu_torch.parallel.mesh import NamedSharding, Spec, make_mesh

TENSOR_AXIS = "tensor"


def layout(params, mesh, other):
    tp_mesh = make_mesh({"data": 2, "tensor": 2})
    ok = NamedSharding(tp_mesh, Spec("data", TENSOR_AXIS))
    fused = Spec(TENSOR_AXIS, None, parts=3)
    typo = Spec("tensr", None)
    foreign = NamedSharding(other, Spec())
    return ok, fused, typo, foreign, NamedSharding(mesh, Spec(None, "data"))
"""


def test_sharding_rule_catches_a_seeded_axis_and_a_foreign_mesh(tmp_path):
    f = tmp_path / "layout.py"
    f.write_text(SHARDING_TWIN)
    result = run_lint([str(f)])
    assert [(x.rule, x.line) for x in sorted(result.findings, key=lambda x: x.line)] == \
        [("sharding", 10), ("sharding", 11)]
    by_line = {x.line: x.message for x in result.findings}
    assert "'tensr'" in by_line[10] and "known axes: data, tensor" in by_line[10]
    assert "'other'" in by_line[11] and "mesh, tp_mesh" in by_line[11]
    jax_twin = tmp_path / "jax_layout.py"
    jax_twin.write_text(SHARDING_TWIN.replace("Spec(", "P(").replace(", parts=3", ""))
    assert sorted(x.line for x in jax_run_lint([str(jax_twin)]).findings) == [10, 11]
    f.write_text(SHARDING_TWIN.replace('"tensr"', "TENSOR_AXIS").replace("NamedSharding(other,", "NamedSharding(mesh,"))
    assert run_lint([str(f)]).ok


#: a host value stored into a device tensor: a blocking host-to-device copy
#: (the card's sync debug mode reports the engine's slot updates as syncs)
HOST_STORE = '''
import numpy as np
import torch

class Engine:
    def __init__(self, n):
        self._temp_dev = torch.ones(n, device="cuda")
        self._temp = np.ones(n, dtype=np.float32)

    def step(self, slot, temp):  # graftlint: hot-path
        self._temp[slot] = temp
        self._temp_dev[slot] = temp
        self._temp_dev[slot] += self._temp_dev[0]
'''


def test_host_store_into_a_device_tensor_is_a_hot_path_sync(tmp_path):
    f = tmp_path / "store.py"
    f.write_text(HOST_STORE)
    result = run_lint([str(f)])
    assert [(x.rule, x.line) for x in result.findings] == [("host-sync", 12)]
    assert "host-to-device copy" in result.findings[0].message


LOCK_KEYS = '''
import threading

_REGISTRY_LOCK = threading.Lock()

class Cache:
    def __init__(self):
        self._lock = threading.Lock()

    def register(self):
        with _REGISTRY_LOCK:
            with self._lock:
                return 1

    def evict(self):
        with self._lock:
            with _REGISTRY_LOCK:
                return 2
'''


def test_module_and_class_locks_share_one_lock_graph(tmp_path):
    """A module-level lock's key has no class (None), which does not compare
    with a class name: the JAX linter's cycle search sorts the keys and
    raises TypeError on this graph. The port orders keys totally."""
    f = tmp_path / "locks.py"
    f.write_text(LOCK_KEYS)
    result = run_lint([str(f)], ["lock-order"])
    assert [(x.rule, x.line, x.symbol) for x in result.findings] == [
        ("lock-order", 12, "Cache.register"), ("lock-order", 17, "Cache.evict")]
    assert "locks._REGISTRY_LOCK" in result.findings[0].message


# ------------------------------------------------------------ the port tree

def test_port_tree_is_finding_free_without_a_baseline():
    t0 = time.perf_counter()
    result = run_lint([str(PORT)])
    wall = time.perf_counter() - t0
    print(f"port graftlint: {result.files} files, {len(result.suppressed)} suppressed, wall {wall:.2f}s")
    assert result.files >= 79
    assert result.ok, "\n".join(x.format() for x in result.findings)
    assert all(s.reason for s in result.suppressed)
    where = {(pathlib.Path(s.path).name, s.rule) for s in result.suppressed}
    assert ("continuous.py", "host-sync") in where  # the designed fetch
    assert wall < 30.0


def _mutated(label, old, new, rules):
    src = (PORT / "serving" / "continuous.py").read_text()
    mutated = src.replace(old, new, 1)
    assert mutated != src, f"{label}: the site moved; update this mutation"
    with tempfile.TemporaryDirectory() as d:
        f = pathlib.Path(d) / "continuous.py"
        f.write_text(mutated)
        return run_lint([str(f)], rules)


@pytest.mark.parametrize(
    "label, old, new, rules, symbol, witness",
    [
        (
            "item-in-_replay_burst",
            "            tokens, masks, bads = burst.tokens.numpy(), burst.masks.numpy(), burst.bads.numpy()\n",
            "            tokens, masks, bads = burst.tokens.numpy(), burst.masks.numpy(), burst.bads.numpy()\n"
            "            self._active_dev.sum().item()\n",
            ["host-sync"],
            "DecodeEngine._replay_burst",
            "hot: DecodeEngine.step -> DecodeEngine._replay_burst",
        ),
        (
            "unpin-in-release_preempted",
            "            self.prefix_cache.unpin(state.path)\n",
            "            pass\n",
            ["resource-leak", "double-release", "unbalanced-transfer"],
            "DecodeEngine.release_preempted",
            "ContinuousBatcher._maybe_preempt",
        ),
        (
            "lock-in-adopt_ticket",
            '        with self._lock:\n'
            '            if self._closed:\n'
            '                raise EngineFailure("batcher is closed", reason="batcher_closed")\n'
            '            self.scheduler.requeue(ticket, preemption=False)\n',
            '        if True:\n'
            '            if self._closed:\n'
            '                raise EngineFailure("batcher is closed", reason="batcher_closed")\n'
            '            self.scheduler.requeue(ticket, preemption=False)\n',
            ["data-race"],
            "ContinuousBatcher.adopt_ticket",
            "thread:continuous-batcher",
        ),
    ],
    ids=["item-in-_replay_burst", "unpin-in-release_preempted", "lock-in-adopt_ticket"],
)
def test_mutated_port_serving_source_is_caught(label, old, new, rules, symbol, witness):
    """One broken invariant in the port's live engine source: exactly one
    finding, naming the broken function and its witness."""
    result = _mutated(label, old, new, rules)
    assert len(result.findings) == 1, [x.format() for x in result.findings]
    (finding,) = result.findings
    assert finding.symbol == symbol
    assert witness in finding.message


# ------------------------------------------------------ dynamic agreement

class _SyncRecorder(TorchDispatchMode):
    """Every operator ``_graphs._HostSyncCheck`` refuses (a host sync or a
    copy between host and device), with the Python stack it ran under."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        crosses = False
        if name == "_to_copy" and kwargs.get("device") is not None:
            crosses = len(_graphs._device_types(args[:1]) | {torch.device(kwargs["device"]).type}) > 1
        elif name == "copy_":
            crosses = len(_graphs._device_types(args[:2])) > 1
        if name in _graphs._SYNCING_OPS or crosses:
            self.hits.append((name, traceback.extract_stack()))
        return func(*args, **kwargs)


def _drive(engine, recorder):
    with recorder:
        engine.admit_many([([1, 2, 3], 8), (list(range(1, 20)), 6)])
        engine.add_request([9, 9, 9], 5, temperature=0.7, top_k=4, top_p=0.9)
        for _ in range(6):
            engine.step(2)


def test_dynamic_syncs_agree_with_the_static_hot_set(monkeypatch):
    """The engine's steps (and admissions, prefix cache and chunked prefill
    on) under a recorder: every syncing operator's innermost port frame is
    off the hot path, or at a reasoned suppression. A seeded ``.item()`` in
    ``_dispatch_step`` is on it, unsuppressed, in the static hot set."""
    project = Project([str(PORT)])
    model = init_gpt(GPTConfig.tiny(dtype=torch.float32), device="cpu")
    kw = dict(max_len=64, kv_quantize="int8", num_slots=4, prefill_chunk=8, prefix_cache_blocks=8, device="cpu")
    recorder = _SyncRecorder()
    _drive(DecodeEngine(model, **kw), recorder)
    sites = [runtime_site(project, stack) for _, stack in recorder.hits]
    bad = [s for s in sites if s is not None and s["dynamic_hot"] and not s["suppression"]]
    assert not bad, bad

    original = DecodeEngine._dispatch_step

    def seeded(self, lookahead):
        self._active_dev.sum().item()
        return original(self, lookahead)

    monkeypatch.setattr(DecodeEngine, "_dispatch_step", seeded)
    control = _SyncRecorder()
    _drive(DecodeEngine(model, **kw), control)
    caught = [runtime_site(project, stack) for name, stack in control.hits if name == "_local_scalar_dense"]
    assert caught and all(s["dynamic_hot"] and s["static_hot"] and not s["suppression"] for s in caught)
    assert {s["function"] for s in caught} == {"DecodeEngine.step"}


# --------------------------------------------------------------------- CLI

def test_cli_exit_codes_sarif_and_budget(tmp_path, capsys):
    bad = tmp_path / "hs.py"
    bad.write_text(HOST_SYNC_TWIN)
    ok = tmp_path / "ok.py"
    ok.write_text(CLEAN_TWIN)
    out = tmp_path / "report.sarif"
    assert lint_main([str(bad), "--sarif", str(out)]) == 1
    jsonschema = pytest.importorskip("jsonschema")
    doc = json.loads(out.read_text())
    jsonschema.validate(doc, json.loads(SCHEMA.read_text()))
    assert {r["ruleId"] for r in doc["runs"][0]["results"]} == {"host-sync"}
    assert "recapture" in {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert lint_main([str(ok)]) == 0
    assert lint_main([str(bad), "--no-fail-on-findings"]) == 0
    assert lint_main([str(bad), "--rules", "nope"]) == 2
    assert lint_main([str(bad), "--only", "nope"]) == 2
    assert lint_main([str(bad), "--only", "recapture"]) == 0
    assert lint_main([str(ok), "--budget", "0.000001"]) == 1
    assert lint_main([str(ok), "--budget", "600"]) == 0
    report = tmp_path / "report.json"
    assert lint_main([str(bad), "--json", str(report), "--timings"]) == 1
    assert json.loads(report.read_text())["counts"]["findings"] == 4
    assert lint_main(["--list-rules"]) == 0
    listing = capsys.readouterr().out
    assert "recapture" in listing and "retrace" not in listing and "use-after-donate" not in listing
