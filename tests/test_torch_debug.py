"""The port's debug and profiling helpers beside the JAX package's.

Twins of ``tests/unit/test_debug.py`` and ``tests/unit/test_profiling.py``:
the same functions go through ``unionml_tpu.debug`` (``jax.jit``) and
``unionml_tpu_torch.debug`` (``torch.jit.trace`` on CPU tensors; a CUDA graph
on the card, which ``chip_smoke.py`` phase 20 runs), with equal answers: the
NaN guard raises ``FloatingPointError`` at ``x / 0 * 0`` and is off again
afterwards, ``assert_pure`` accepts a pure function and rejects one that bumps
a Python counter, ``RetraceMonitor`` counts 1, 1, 2 over shapes (4,), (4,),
(8,); stage timings after a local train name the same stages in both
packages; memory statistics on the CPU are one entry of ``None`` values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu import debug as jdebug
from unionml_tpu import profiling as jprofiling
from unionml_tpu_torch import debug, profiling

from tests.test_torch_model import sklearn_app

import unionml_tpu as J
import unionml_tpu_torch as T


def test_debug_nans_raises_at_source():
    with jdebug.debug_nans():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: x / 0.0 * 0.0)(jnp.float32(1.0))
    before = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    with debug.debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="nan"):
            (lambda x: x / 0.0 * 0.0)(torch.tensor(1.0))
        assert torch.equal(torch.arange(3.0) + 1, torch.tensor([1.0, 2.0, 3.0]))  # finite ops pass
    # restored afterwards: the same op runs silently
    assert torch.isnan((lambda x: x / 0.0 * 0.0)(torch.tensor(1.0)))
    assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == before
    with debug.debug_nans(enabled=False):
        assert torch.isnan(torch.tensor(0.0) / 0.0)


def test_debug_nans_catches_a_nan_gradient():
    """A backward that makes a NaN raises: at its operator (the dispatch check,
    where autograd runs on the calling thread, as on the CPU) or in anomaly
    mode (where autograd runs on a device thread of its own)."""
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with debug.debug_nans():
        y = torch.sqrt(x)  # finite forward; d sqrt at 0 is inf, times 0 from the mask is nan
        with pytest.raises((FloatingPointError, RuntimeError), match="nan"):
            (y * torch.tensor([0.0, 1.0])).sum().backward()


def _counter():
    state = {"calls": 0}

    def impure(x):
        state["calls"] += 1
        return x + state["calls"]  # python-side counter frozen when the compiled form records

    return impure


def test_assert_pure_accepts_pure_and_rejects_stateful():
    jdebug.assert_pure(lambda x: x * 2 + 1, jnp.arange(4.0))
    debug.assert_pure(lambda x: x * 2 + 1, torch.arange(4.0))
    debug.assert_pure(lambda x: {"double": x * 2, "parts": (x + 1, x - 1)}, torch.arange(4.0), atol=0)
    with pytest.raises(AssertionError):
        jdebug.assert_pure(_counter(), jnp.arange(4.0))
    with pytest.raises(AssertionError):
        debug.assert_pure(_counter(), torch.arange(4.0))


def test_retrace_monitor_counts_signatures():
    counts = {}
    for name, pkg, ones in (("jax", jdebug, jnp.ones), ("torch", debug, torch.ones)):
        monitor = pkg.RetraceMonitor(lambda x: x * 2, name="double")
        seen = []
        for shape in ((4,), (4,), (8,)):
            out = monitor(ones(shape))
            seen.append(monitor.traces)
            assert np.array_equal(np.asarray(out), np.full(shape, 2.0, np.float32))
        counts[name] = seen
    assert counts["torch"] == counts["jax"] == [1, 1, 2]
    monitor = debug.RetraceMonitor(lambda x: x * 2)
    monitor(torch.ones(4))
    monitor(torch.ones(4, dtype=torch.float64))  # a new dtype is a new signature
    assert monitor.traces == 2 and monitor.name == "<lambda>"


def test_check_tracer_leaks_context():
    with jdebug.check_tracer_leaks():
        jax.jit(lambda x: x + 1)(1.0)  # clean function passes
    assert not jax.config.jax_check_tracer_leaks
    # no torch meaning: neither compiled form of the port hands out traced values
    assert not hasattr(debug, "check_tracer_leaks")
    assert "check_tracer_leaks`` is not ported" in debug.__doc__


def test_xprof_trace_writes_files(tmp_path):
    with profiling.xprof_trace(str(tmp_path / "trace")):
        with profiling.annotate("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [p for p in (tmp_path / "trace").rglob("*") if p.is_file()]
    assert files, "profiler trace must produce output files"
    assert "matmul" in files[0].read_text()


def test_workflow_timings_after_train():
    timings = {}
    for pkg, prof in ((J, jprofiling), (T, profiling)):
        model = sklearn_app(pkg)
        model.train(hyperparameters={"C": 1.0, "max_iter": 200})
        timings[pkg.__name__] = prof.workflow_timings(model.train_workflow())
    assert set(timings["unionml_tpu_torch"]) == set(timings["unionml_tpu"]) == {
        "test_dataset.dataset_task", "test_model.train_task"}
    assert all(t is not None and t >= 0 for t in timings["unionml_tpu_torch"].values())


def test_device_memory_stats_shape():
    stats = profiling.device_memory_stats()
    want = jprofiling.device_memory_stats()
    assert stats and {"device", "bytes_in_use", "bytes_limit", "peak_bytes_in_use"} == set(stats[0]) == set(want[0])
    # no CUDA device here: one CPU entry without statistics, JAX's answer for its CPU devices
    assert stats == [{"device": "cpu", "bytes_in_use": None, "bytes_limit": None, "peak_bytes_in_use": None}]
    assert want[0]["bytes_limit"] is None
