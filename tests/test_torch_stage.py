"""The port's stage runtime, type guards, workflow and tracker against the JAX package's.

Same signatures, same inputs, both packages: the guards must raise the same
exception type with the same message (or both pass); ``TracedFunction``'s
policy (eager for opaque objects, a per-signature blacklist of failed
captures bounded at 128 keys, ``jit=True`` raising ``StageError``, runtime
errors propagating) must follow the JAX package's trace-failure policy step
for step. There is no CUDA graph on the CPU, so the port's capture is
monkeypatched to fail where the JAX function fails to trace. Exact
comparisons throughout (no tolerance: no arithmetic is compared).
"""

import inspect
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import unionml_tpu.stage as jstage
import unionml_tpu.type_guards as jguards
import unionml_tpu.workflow as jworkflow
import unionml_tpu_torch.stage as tstage
import unionml_tpu_torch.type_guards as tguards
import unionml_tpu_torch.workflow as tworkflow
from unionml_tpu.exceptions import StageError as JStageError
from unionml_tpu.exceptions import WorkflowError as JWorkflowError
from unionml_tpu_torch import _graphs
from unionml_tpu_torch.exceptions import StageError as TStageError
from unionml_tpu_torch.exceptions import WorkflowError as TWorkflowError
from unionml_tpu_torch.tracker import TrackedInstance, load_tracked_instance


class FakeModel:
    ...


# ------------------------------------------------------------------ type guards


def _splitter_ok(data: pd.DataFrame, test_size: float, shuffle: bool, random_state: int) -> Tuple[pd.DataFrame, pd.DataFrame]:
    ...


def _splitter_single(data: pd.DataFrame, test_size: float, shuffle: bool, random_state: int) -> pd.DataFrame:
    ...


def _splitter_mismatch(data: pd.DataFrame, test_size: float, shuffle: bool, random_state: int) -> Tuple[str, str]:
    ...


def _splitter_missing(data: pd.DataFrame, test_size: float, shuffle: bool) -> Tuple[pd.DataFrame, pd.DataFrame]:
    ...


def _splitter_wrong_type(data: pd.DataFrame, test_size: int, shuffle: bool, random_state: int) -> Tuple[pd.DataFrame, pd.DataFrame]:
    ...


def _parser_ok(data: pd.DataFrame, features: Optional[List[str]], targets: List[str]) -> Tuple[pd.DataFrame, pd.DataFrame]:
    ...


def _parser_bad(data: pd.DataFrame, features: List[str], targets: List[str]) -> Tuple[pd.DataFrame, pd.DataFrame]:
    ...


def _trainer_ok(model: FakeModel, features: pd.DataFrame, target: pd.DataFrame, *, epochs: int = 5) -> FakeModel:
    ...


def _trainer_wrong_model(model: int, features: pd.DataFrame, target: pd.DataFrame) -> int:
    ...


def _trainer_arity(model: FakeModel, features: pd.DataFrame) -> FakeModel:
    ...


def _trainer_arrays(model: FakeModel, features: np.ndarray, target: np.ndarray) -> FakeModel:
    ...


def _evaluator_ok(model: FakeModel, features: pd.DataFrame, target: pd.DataFrame) -> float:
    ...


def _evaluator_arity(model: FakeModel, features: pd.DataFrame) -> float:
    ...


def _predictor_ok(model: FakeModel, features: pd.DataFrame) -> List[float]:
    ...


def _predictor_union(model: FakeModel, features: Union[pd.DataFrame, np.ndarray]) -> List[float]:
    ...


def _predictor_two(model: FakeModel, a: pd.DataFrame, b: pd.DataFrame) -> List[float]:
    ...


def _predictor_no_return(model: FakeModel, features: pd.DataFrame):
    ...


def _predictor_dict(model: FakeModel, features: Dict[str, np.ndarray]) -> List[float]:
    ...


def _callback_ok(model: FakeModel, features: pd.DataFrame, predictions: List[float]):
    ...


def _callback_returns(model: FakeModel, features: pd.DataFrame, predictions: List[float]) -> int:
    ...


def _callback_arity(model: FakeModel, features: pd.DataFrame):
    ...


def _callback_wrong_prediction(model: FakeModel, features: pd.DataFrame, predictions: int):
    ...


def _loader_ok(raw: Any) -> pd.DataFrame:
    ...


def _loader_two(a: Any, b: Any) -> pd.DataFrame:
    ...


def _transformer_bad(features: int) -> int:
    ...


def _reader_no_return():
    ...


def _loader_int(data: int) -> pd.DataFrame:
    ...


# (guard name, positional arguments); the port's array family stands in for
# the JAX package's in the two array cases (see ``ARRAY_FAMILY``)
GUARD_CASES = {
    "reader_ok": ("guard_reader", (_loader_ok,)),
    "reader_no_return": ("guard_reader", (_reader_no_return,)),
    "loader_ok": ("guard_loader", (_loader_ok, pd.DataFrame)),
    "loader_int": ("guard_loader", (_loader_int, pd.DataFrame)),
    "splitter_ok": ("guard_splitter", (_splitter_ok, pd.DataFrame, "reader")),
    "splitter_single": ("guard_splitter", (_splitter_single, pd.DataFrame, "reader")),
    "splitter_mismatch": ("guard_splitter", (_splitter_mismatch, pd.DataFrame, "reader")),
    "splitter_missing": ("guard_splitter", (_splitter_missing, pd.DataFrame, "reader")),
    "splitter_wrong_type": ("guard_splitter", (_splitter_wrong_type, pd.DataFrame, "reader")),
    "parser_ok": ("guard_parser", (_parser_ok, pd.DataFrame, "reader")),
    "parser_bad": ("guard_parser", (_parser_bad, pd.DataFrame, "reader")),
    "trainer_ok": ("guard_trainer", (_trainer_ok, FakeModel, (pd.DataFrame, pd.DataFrame))),
    "trainer_wrong_model": ("guard_trainer", (_trainer_wrong_model, FakeModel, (pd.DataFrame, pd.DataFrame))),
    "trainer_arity": ("guard_trainer", (_trainer_arity, FakeModel, (pd.DataFrame, pd.DataFrame))),
    "trainer_arrays": ("guard_trainer", (_trainer_arrays, FakeModel, "ARRAY_PAIR")),
    "evaluator_ok": ("guard_evaluator", (_evaluator_ok, FakeModel, (pd.DataFrame, pd.DataFrame))),
    "evaluator_arity": ("guard_evaluator", (_evaluator_arity, FakeModel, (pd.DataFrame, pd.DataFrame))),
    "predictor_ok": ("guard_predictor", (_predictor_ok, FakeModel, pd.DataFrame)),
    "predictor_union": ("guard_predictor", (_predictor_union, FakeModel, pd.DataFrame)),
    "predictor_two": ("guard_predictor", (_predictor_two, FakeModel, pd.DataFrame)),
    "predictor_no_return": ("guard_predictor", (_predictor_no_return, FakeModel, pd.DataFrame)),
    "predictor_dict_arrays": ("guard_predictor", (_predictor_dict, FakeModel, "ARRAY_DICT")),
    "predictor_wrong_model": ("guard_predictor", (_predictor_ok, int, pd.DataFrame)),
    "callback_ok": ("guard_prediction_callback", (_callback_ok, _predictor_ok, FakeModel, pd.DataFrame)),
    "callback_returns": ("guard_prediction_callback", (_callback_returns, _predictor_ok, FakeModel, pd.DataFrame)),
    "callback_arity": ("guard_prediction_callback", (_callback_arity, _predictor_ok, FakeModel, pd.DataFrame)),
    "callback_wrong_prediction": (
        "guard_prediction_callback", (_callback_wrong_prediction, _predictor_ok, FakeModel, pd.DataFrame)),
    "feature_loader_ok": ("guard_feature_loader", (_loader_ok, Any)),
    "feature_loader_two": ("guard_feature_loader", (_loader_two, Any)),
    "feature_transformer_ok": ("guard_feature_transformer", (_loader_ok, Any)),
    "feature_transformer_bad": ("guard_feature_transformer", (_transformer_bad, pd.DataFrame)),
}


def _array_args(args, tensor_type):
    pair = (tensor_type, tensor_type)
    return tuple(pair if a == "ARRAY_PAIR" else Dict[str, tensor_type] if a == "ARRAY_DICT" else a for a in args)


def _outcome(guards, name, args):
    try:
        getattr(guards, name)(*args)
    except Exception as exc:  # the outcome under comparison
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_type_guards_match_the_jax_package(case):
    import jax

    name, args = GUARD_CASES[case]
    jax_out = _outcome(jguards, name, _array_args(args, jax.Array))
    port_out = _outcome(tguards, name, _array_args(args, torch.Tensor))
    assert port_out == jax_out


def test_array_family():
    assert tguards.types_compatible(torch.Tensor, np.ndarray) and tguards.types_compatible(np.ndarray, torch.Tensor)
    assert tguards.types_compatible(Dict[str, np.ndarray], Dict[str, torch.Tensor])
    assert not tguards.types_compatible(torch.Tensor, pd.DataFrame)


# ------------------------------------------------------------------ TracedFunction policy


class Opaque:
    def fit(self):
        return self


@pytest.mark.parametrize("tree", [
    (np.ones(3), 1.0, 2, None), {"a": np.ones(3)}, ("str-leaf",), (Opaque(),), {"m": [np.int32(3), True]},
], ids=["arrays-scalars", "dict", "string", "opaque", "numpy-scalar"])
def test_tensor_compatibility_matches_jax_compatibility(tree):
    def to_jax(leaf):
        return jnp.asarray(leaf) if isinstance(leaf, np.ndarray) else leaf

    def to_torch(leaf):
        return torch.from_numpy(leaf) if isinstance(leaf, np.ndarray) else leaf

    from torch.utils import _pytree

    assert tstage.is_tensor_compatible(_pytree.tree_map(to_torch, tree)) == jstage.is_jax_compatible(
        _pytree.tree_map(to_jax, tree))


@pytest.fixture
def failing_capture(monkeypatch):
    """No graph on the CPU: every CPU call counts as capturable, and every
    capture runs the function once (the eager warm-up) and then fails."""
    attempts = []

    def capture(fn, args, kwargs):
        attempts.append(_graphs.signature((args, kwargs)))
        fn(*args, **kwargs)
        raise _graphs.CaptureError("capture failed (monkeypatched)")

    monkeypatch.setattr(_graphs, "capturable", lambda tree: True)
    monkeypatch.setattr(_graphs, "capture", capture)
    return attempts


def _untraceable(x, *, tag: str = ""):
    """Fails to trace in JAX (a host conversion), as a host sync fails a capture."""
    return x * 2 if float(x[0]) > 0 else -x


def test_auto_falls_back_per_signature_like_jax(failing_capture):
    jt, tt = jstage.TracedFunction(_untraceable, jit="auto"), tstage.TracedFunction(_untraceable, jit="auto")
    for shape in (3, 3, 4, 3):
        out_j, out_t = jt(jnp.ones(shape)), tt(torch.ones(shape))
        np.testing.assert_array_equal(np.asarray(out_j), out_t.numpy())
        assert len(tt._cache.failed) == len(jt._trace_failed_keys)
    assert len(tt._cache.failed) == 2  # shapes 3 and 4; the repeat of 3 ran eagerly without a capture
    assert len(failing_capture) == 2
    assert tt.uses_jit and jt.uses_jit  # other signatures stay capturable


def test_blacklist_bound_matches_jax(failing_capture):
    jt, tt = jstage.TracedFunction(_untraceable, jit="auto"), tstage.TracedFunction(_untraceable, jit="auto")
    sizes_j, sizes_t = [], []
    for i in range(tstage._TRACE_FAILED_KEYS_MAX + 2):
        jt(jnp.ones(3), tag=f"id{i}")
        tt(torch.ones(3), tag=f"id{i}")
        sizes_j.append(len(jt._trace_failed_keys))
        sizes_t.append(len(tt._cache.failed))
    assert tstage._TRACE_FAILED_KEYS_MAX == jstage._TRACE_FAILED_KEYS_MAX == 128
    assert sizes_t == sizes_j and max(sizes_t) == 128 and sizes_t[-2:] == [1, 2]


def test_jit_true_raises_stage_error(failing_capture):
    with pytest.raises(JStageError):
        jstage.TracedFunction(_untraceable, jit=True)(jnp.ones(3))
    with pytest.raises(TStageError):
        tstage.TracedFunction(_untraceable, jit=True)(torch.ones(3))


def test_runtime_errors_propagate(failing_capture):
    def broken(x):
        raise ValueError("user bug")

    with pytest.raises(ValueError, match="user bug"):
        jstage.TracedFunction(broken, jit="auto")(jnp.ones(3))
    with pytest.raises(ValueError, match="user bug"):
        tstage.TracedFunction(broken, jit="auto")(torch.ones(3))


def test_opaque_objects_run_eagerly_for_good():
    def fn(model, x):
        return model.fit()

    for traced, x in ((jstage.TracedFunction(fn, jit="auto"), jnp.ones(3)),
                      (tstage.TracedFunction(fn, jit="auto"), torch.ones(3))):
        model = Opaque()
        assert traced(model, x) is model
        assert not traced.uses_jit


def test_cpu_tensors_run_eagerly_without_blacklisting():
    calls = []

    def fn(x, *, mode: str = "double"):
        calls.append(1)
        return x * 2 if mode == "double" else x

    traced = tstage.TracedFunction(fn, jit="auto")
    np.testing.assert_array_equal(traced(torch.ones(3), mode="double").numpy(), 2 * np.ones(3))
    np.testing.assert_array_equal(traced(torch.ones(3), mode="same").numpy(), np.ones(3))
    assert len(calls) == 2 and traced.uses_jit and not traced._cache.failed and not traced._cache.graphs


def test_static_names_and_trace_keys_follow_jax():
    jt, tt = jstage.TracedFunction(lambda x, **k: x), tstage.TracedFunction(lambda x, **k: x)
    kwargs = {"mode": "a", "flag": None, "opaque": Opaque()}
    assert tt._auto_static_names(kwargs) == jt._auto_static_names(kwargs) == ("flag", "mode", "opaque")
    key_a = tt._trace_key(("mode",), (torch.ones(3),), {"mode": "a"})
    assert key_a == tt._trace_key(("mode",), (torch.zeros(3),), {"mode": "a"})
    assert key_a != tt._trace_key(("mode",), (torch.ones(4),), {"mode": "a"})
    assert key_a != tt._trace_key(("mode",), (torch.ones(3),), {"mode": "b"})


# ------------------------------------------------------------------ stages


class Owner:
    name = "owner"


@pytest.mark.parametrize("pkg", [jstage, tstage], ids=["jax", "port"])
def test_stage_factory_interface(pkg):
    @pkg.stage(unionml_obj=Owner())
    def my_stage(a: int, b: int = 2) -> int:
        return a + b

    assert my_stage.name == "owner.my_stage"
    assert list(my_stage.python_interface.inputs) == ["a", "b"]
    assert all(p.kind == inspect.Parameter.KEYWORD_ONLY for p in my_stage.inputs.values())
    assert my_stage(a=1) == 3
    with pytest.raises(Exception, match="unknown arguments"):
        my_stage(a=1, c=5)


def test_stage_namedtuple_outputs_match():
    Out = NamedTuple("Out", x=int, y=int)
    outs = []
    for pkg in (jstage, tstage):
        @pkg.stage(unionml_obj=Owner(), return_annotation=Out)
        def pair(a: int) -> Out:
            return Out(a, a + 1)

        outs.append(list(pair.python_interface.outputs))
    assert outs[0] == outs[1] == ["x", "y"]


def test_stage_result_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("UNIONML_TPU_TORCH_HOME", str(tmp_path))
    counter = {"n": 0}

    @tstage.stage(unionml_obj=Owner(), cache=True, cache_version="v1")
    def costly(a: int) -> int:
        counter["n"] += 1
        return a * 10

    assert costly(a=3) == 30 and costly(a=3) == 30
    assert counter["n"] == 1, "second call must be served from the content-hash cache"
    assert costly(a=4) == 40 and counter["n"] == 2
    assert any(tmp_path.rglob("*.pkl"))


def test_scalarize():
    assert tstage._scalarize(torch.tensor(2.5)) == jstage._scalarize(jnp.asarray(2.5)) == 2.5
    assert tstage._scalarize(np.float32(1.0)) == 1.0


# ------------------------------------------------------------------ workflow and tracker


def _diamond(stage_pkg, workflow_pkg):
    def double(x: int) -> int:
        return x * 2

    def add(a: int, b: int) -> int:
        return a + b

    double, add = (stage_pkg.stage(f, unionml_obj=Owner()) for f in (double, add))
    wf = workflow_pkg.Workflow("wf")
    wf.add_workflow_input("x", int)
    wf.add_workflow_input("y", int, default=10)
    n1 = wf.add_entity(double, x=wf.inputs["x"])
    n2 = wf.add_entity(add, a=n1.outputs["o0"], b=wf.inputs["y"])
    wf.add_workflow_output("result", n2.outputs["o0"])
    wf.add_workflow_output("doubled", n1.outputs["o0"])
    return wf


@pytest.mark.parametrize("inputs", [{"x": 3}, {"x": 3, "y": 1}, {"x": -2}])
def test_workflow_execution_matches(inputs):
    assert _diamond(tstage, tworkflow)(**inputs) == _diamond(jstage, jworkflow)(**inputs)


@pytest.mark.parametrize("bad", ["missing", "unknown", "duplicate", "no-such-input"])
def test_workflow_errors_match(bad):
    messages = []
    for stage_pkg, wf_pkg, error in ((jstage, jworkflow, JWorkflowError), (tstage, tworkflow, TWorkflowError)):
        wf = _diamond(stage_pkg, wf_pkg)
        with pytest.raises(error) as info:
            if bad == "missing":
                wf()
            elif bad == "unknown":
                wf(x=1, z=2)
            elif bad == "duplicate":
                wf.add_workflow_input("x", int)
            else:
                wf.add_entity(wf.nodes[0].stage, nope=1)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


class Tracked(TrackedInstance):
    def __init__(self, name: str):
        super().__init__()
        self.name = name


MODULE_LEVEL_INSTANCE = Tracked("module-level")


def test_tracker():
    assert MODULE_LEVEL_INSTANCE.instantiated_in == __name__
    assert MODULE_LEVEL_INSTANCE.find_lhs() == "MODULE_LEVEL_INSTANCE"
    assert load_tracked_instance(__name__, "MODULE_LEVEL_INSTANCE") is MODULE_LEVEL_INSTANCE
