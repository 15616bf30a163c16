"""CUDA-graph capture (``unionml_tpu_torch._graphs``) and the resident predictor's graphs.

The ``cuda`` tests need a CUDA device and ``nvcc`` (the BERT forward runs
K1); they skip elsewhere. Run them on the GPU machine with

    python -m pytest tests/test_torch_graphs.py -m cuda -q

The file imports nothing of JAX. Tolerance of replay against eager: float32
atol 1e-5 (the same kernels on the same inputs; cuBLAS may pick another
algorithm inside a graph, which moves the last bits).
"""

import gc
import threading
import weakref
from typing import Any, Dict

import numpy as np
import pytest
import torch
from torch.utils import _pytree

from unionml_tpu_torch import Dataset, Model, ModelArtifact, _graphs
from unionml_tpu_torch.models import BertConfig, TrainState, create_train_state, init_bert
from unionml_tpu_torch.serving import ResidentPredictor

SEQ_BUCKETS = (16, 32)
REPLAY_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the BERT forward runs the K1 kernel, which has no CPU mode)")
    return torch.device("cuda")


def tiny_config(**overrides) -> BertConfig:
    # head_dim 64: the width K1 takes
    return BertConfig.tiny(dtype=torch.float32, hidden_size=256, num_heads=4, **overrides)


def build_app(device, config=None, sync_in_predictor: bool = False):
    """A tiny BERT app: dict features of right-padded token ids, logits out."""
    config = config or tiny_config()
    dataset = Dataset(name="graphs_ds", targets=["labels"], device_format="torch", device=device)

    def init(seed: int = 0) -> TrainState:
        return create_train_state(init_bert(config, seed=seed, device=device))

    model = Model(name="graphs_app", init=init, dataset=dataset)

    @dataset.reader
    def reader(n: int = 8) -> Dict[str, np.ndarray]:
        ids = np.ones((n, 8), np.int32)
        return {"input_ids": ids, "attention_mask": ids, "labels": np.zeros(n, np.int32)}

    @dataset.feature_loader
    def feature_loader(rows: Any) -> Dict[str, np.ndarray]:
        width = max(len(r["input_ids"]) for r in rows)
        ids = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r["input_ids"])] = r["input_ids"]
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}

    @model.trainer
    def trainer(state: TrainState, features: torch.Tensor, targets: torch.Tensor) -> TrainState:
        return state

    @model.predictor
    def predictor(state: TrainState, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits = state.model(features["input_ids"], features["attention_mask"])
        if sync_in_predictor:
            logits = logits + float(logits.sum()) * 0.0  # a host sync: capture must fail
        return logits

    @model.evaluator
    def evaluator(state: TrainState, features: torch.Tensor, targets: torch.Tensor) -> float:
        return 0.0

    model.artifact = ModelArtifact(init())
    return model


def request_rows(n_rows: int, seed: int, lo: int = 3, hi: int = 16, vocab: int = 1024) -> list:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(1, vocab, int(rng.integers(lo, hi + 1))).tolist()} for _ in range(n_rows)]


def eager_logits(model, rows) -> np.ndarray:
    """The rows alone, unpadded, through the eager model."""
    features = model.dataset.get_features(rows)
    with torch.no_grad():
        out = model.artifact.model_object.model(features["input_ids"], features["attention_mask"])
    return out.float().cpu().numpy()


# ------------------------------------------------------------------ CPU: signatures and the capture rule


def test_signature_keys_shapes_residents_and_values():
    module = torch.nn.Linear(2, 2)
    a = _graphs.signature(((module, {"x": torch.zeros(2, 3)}), {"k": 3}))
    assert a == _graphs.signature(((module, {"x": torch.ones(2, 3)}), {"k": 3}))  # values of tensors do not count
    assert a != _graphs.signature(((module, {"x": torch.zeros(2, 4)}), {"k": 3}))  # shapes do
    assert a != _graphs.signature(((module, {"x": torch.zeros(2, 3)}), {"k": 4}))  # baked scalars do
    assert a != _graphs.signature(((torch.nn.Linear(2, 2), {"x": torch.zeros(2, 3)}), {"k": 3}))  # identity


def test_capturable_needs_cuda_tensors_and_no_host_arrays():
    assert not _graphs.capturable({"x": torch.zeros(2)})  # CPU tensors: the caller asked for the CPU
    assert not _graphs.capturable({"x": np.zeros(2)})
    assert not _graphs.capturable((1, "a", None))
    state = create_train_state(init_bert(BertConfig.tiny(dtype=torch.float32), device="cpu"))
    assert _graphs.is_resident(state) and _graphs.is_resident(state.model)
    assert not _graphs.is_resident({"w": torch.zeros(1)})
    with pytest.raises(_graphs.CaptureError):
        _graphs.capture(lambda x: x, (torch.zeros(2),), {})


def _residents(tree) -> list:
    return [leaf for leaf in _pytree.tree_leaves(tree) if _graphs.is_resident(leaf)]


class _OwnerCheckingGraph:
    """Stands for a CUDA graph on the CPU: runs the function eagerly, and fails
    when it is replayed for other resident objects than it was captured for
    (a graph reads its objects' tensors at their addresses)."""

    def __init__(self, fn, args, kwargs):
        self._fn = fn
        self._owners = [weakref.ref(leaf) for leaf in _residents((args, kwargs))]

    def __call__(self, tree):
        owners = [ref() for ref in self._owners]
        given = _residents(tree)
        assert len(owners) == len(given) and all(a is b for a, b in zip(owners, given)), \
            "a graph was replayed for another object than the one it was captured for"
        args, kwargs = tree
        return self._fn(*args, **kwargs)


@pytest.fixture
def owner_checking_capture(monkeypatch):
    """Every CPU call counts as capturable; each capture is recorded."""
    captures = []

    def capture(fn, args, kwargs):
        captures.append(_OwnerCheckingGraph(fn, args, kwargs))
        return captures[-1]

    monkeypatch.setattr(_graphs, "capturable", lambda tree: True)
    monkeypatch.setattr(_graphs, "capture", capture)
    return captures


def test_graph_cache_drops_the_graphs_of_a_freed_object(owner_checking_capture):
    """A key names a resident object by its id. Once the object is freed, its
    key holds no graph, so an object that takes over the id captures its own."""
    cache = _graphs.GraphCache()
    x = torch.zeros(2)
    first = torch.nn.Linear(2, 2)
    key = _graphs.signature(((first, x), {}))
    graph = cache.lookup(key, lambda m, t: t, (first, x), {})
    assert cache.lookup(key, lambda m, t: t, (first, x), {}) is graph
    del first
    gc.collect()
    second = torch.nn.Linear(2, 2)
    # the freed object's key, as a new object that took over its id would make it
    again = cache.lookup(key, lambda m, t: t, (second, x), {})
    assert again is not graph and len(owner_checking_capture) == 2
    again(((second, x), {}))
    assert list(cache.graphs.values()) == [again]


def test_retrained_states_never_replay_a_freed_state_graph(owner_checking_capture):
    """train, predict, train, train, predict (a sweep): every predict replays
    a graph captured for the state it is given, never one of a freed state
    whose id a new state took; graphs of freed states are dropped."""
    model = build_app("cpu")
    rows = request_rows(2, seed=0, lo=8, hi=8)
    live = []
    for n_train in (1, 2):
        for _ in range(n_train):
            model.train()
        live.append(weakref.ref(model.artifact.model_object))
        np.testing.assert_allclose(model.predict(features=rows).detach().numpy(), eager_logits(model, rows), atol=1e-6)
        gc.collect()
    assert live[0]() is None  # the first state was freed
    # the evaluator's graphs are captured too; the predictor captured once per predicting state
    predictor_graphs = [g for g in owner_checking_capture if g._fn is model._predictor.fn]
    assert len(predictor_graphs) == 2
    model.predict(features=rows)  # a lookup drops the freed state's key
    assert model._predictor._cache.captured() == predictor_graphs[-1:]


def test_resident_on_cpu_pads_and_runs_eagerly():
    """device="cpu": the same padding and slicing as on the card, the predictor eager, no graphs."""
    model = build_app("cpu")
    resident = ResidentPredictor(model, buckets=(2, 4), seq_buckets=SEQ_BUCKETS, warmup=False, device="cpu")
    rows = request_rows(3, seed=0)
    out = resident.predict(features=rows)
    assert isinstance(out, np.ndarray) and out.shape == (3, 2)
    np.testing.assert_allclose(out, eager_logits(model, rows), atol=1e-5)
    assert not resident.uses_graphs and resident.graph_stats() == [] and resident.eager_fallbacks == 0


# ------------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_graph_replay_matches_eager(cuda):
    """A captured BERT forward replayed on new inputs of its shape equals the
    eager forward on those inputs (f32, atol 1e-5), and the resident
    predictor's replays equal the eager model on every request's own rows."""
    model = build_app(cuda)
    state = model.artifact.model_object
    fn = model._predictor.fn
    first = model.dataset.get_features(request_rows(4, seed=0, lo=16, hi=16))
    with torch.no_grad():
        graph = _graphs.capture(fn, (state, first), {})
    for seed in range(3):
        features = model.dataset.get_features(request_rows(4, seed=seed, lo=16, hi=16))
        features["attention_mask"][:, 10:] = 0  # right padding inside the captured width
        replayed = graph(((state, features), {}))
        with torch.no_grad():
            eager = fn(state, features)
        torch.testing.assert_close(replayed, eager, atol=REPLAY_TOL, rtol=0)
    assert graph.replays == 3

    resident = ResidentPredictor(model, buckets=(1, 2, 4, 8), seq_buckets=SEQ_BUCKETS, warmup=False)
    for seed in range(6):
        rows = request_rows(1 + seed, seed=seed)
        np.testing.assert_allclose(resident.predict(features=rows), eager_logits(model, rows), atol=REPLAY_TOL)
    assert resident.uses_graphs and resident.eager_fallbacks == 0
    shapes = sorted(tuple(g["shapes"][0]) for g in resident.graph_stats())
    assert all(b in (1, 2, 4, 8) and s in SEQ_BUCKETS for b, s in shapes)


@pytest.mark.cuda
def test_concurrent_replays_in_one_bucket(cuda):
    """Eight threads replaying one bucket's graph at once: each gets its own
    rows' logits (the static buffers are shared, so replays serialize)."""
    model = build_app(cuda)
    resident = ResidentPredictor(model, buckets=(4,), seq_buckets=(16,), warmup=False)
    requests = [request_rows(4, seed=100 + i) for i in range(8)]
    want = [eager_logits(model, rows) for rows in requests]
    resident.predict(features=requests[0])  # capture once
    results: Dict[int, list] = {i: [] for i in range(len(requests))}
    errors = []

    def worker(i):
        try:
            for _ in range(10):
                results[i].append(resident.predict(features=requests[i]))
        except Exception as exc:  # surfaced below with the thread's index
            errors.append((i, exc))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i, outs in results.items():
        assert len(outs) == 10
        for out in outs:
            np.testing.assert_allclose(out, want[i], atol=REPLAY_TOL)
    (graph,) = resident.graph_stats()
    assert graph["replays"] == 1 + 8 * 10 and resident.eager_fallbacks == 0


@pytest.mark.cuda
def test_capture_failure_is_abandoned_cleanly(cuda):
    """A predictor that syncs the host cannot be captured: the shape is
    served eagerly (counted as a fallback) with the right result, and the
    next capture of a well-behaved function still works."""
    model = build_app(cuda, sync_in_predictor=True)
    resident = ResidentPredictor(model, buckets=(2,), seq_buckets=(16,), warmup=False)
    rows = request_rows(2, seed=1)
    np.testing.assert_allclose(resident.predict(features=rows), eager_logits(model, rows), atol=REPLAY_TOL)
    np.testing.assert_allclose(resident.predict(features=rows), eager_logits(model, rows), atol=REPLAY_TOL)
    assert resident.eager_fallbacks == 2 and resident.graph_stats() == []

    good = build_app(cuda)
    ok = ResidentPredictor(good, buckets=(2,), seq_buckets=(16,), warmup=False)
    np.testing.assert_allclose(ok.predict(features=rows), eager_logits(good, rows), atol=REPLAY_TOL)
    assert ok.eager_fallbacks == 0 and len(ok.graph_stats()) == 1
