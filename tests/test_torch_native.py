"""Port parity: the native packer and the native batch prefetcher.

The port compiles its own copies of ``pack.cpp`` and ``prefetch.cpp`` with
g++ (``unionml_tpu_torch/native``); the JAX package's library is only run
here as the reference. Checks:

- ``pack_sequences(impl="native")`` and ``impl="auto"`` (2048 or more
  sequences) are byte-identical to the port's Python loop and to JAX's
  ``pack_sequences(impl="native")`` on seeded corpora (empties, overlong
  sequences, ``max_segments_per_row``), with equal ``truncated``; a short
  token buffer is refused before C++ reads it;
- the prefetcher cases of ``tests/unit/test_native.py``: batches equal the
  Python gather for the same permutation, slot reuse over many batches and
  epochs, mismatched rows rejected, the true tail with
  ``drop_remainder=False``, worker-side conversions (the bf16 slot's bits
  equal to ``ml_dtypes``' round-to-nearest-even output, viewed as uint16,
  and to JAX's loader's), ``copy=False`` slots, deferred release with
  lookahead, the Python fallback, the stale-library self-heal and the
  degrade to Python when the rebuild stays stale;
- ``fit(prefetch=True)`` and ``fit_lm(prefetch=True)`` on the CPU: losses
  identical to ``prefetch=False``'s, the batches and their order those of
  JAX's ``fit(prefetch=True)``, and an MLP's logged losses within 1e-6
  relative of JAX's on the same weights and data (f32, summation order).
"""

import ctypes
import subprocess
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import unionml_tpu_torch.native as native
from unionml_tpu.models import MLPClassifier as JaxMLP
from unionml_tpu.models import training as jtraining
from unionml_tpu.native import PrefetchLoader as JaxLoader
from unionml_tpu.native import pack_sequences_native as jax_pack_native
from unionml_tpu.ops import packing as jpacking
from unionml_tpu_torch.models import (
    GPTConfig,
    MLPClassifier,
    create_train_state,
    fit,
    fit_lm,
    init_gpt,
    mlp_params_from_jax,
    random_params,
)
from unionml_tpu_torch.native import PrefetchLoader, native_available, pack_sequences_native
from unionml_tpu_torch.ops import packing as tpacking


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tiny models gain nothing from more, and the
    suite's workers share the cores (threads spinning at each op's barrier
    while descheduled slowed such files many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _toolchain():
    if not native_available():
        pytest.fail("g++ builds the port's native library on this machine; it did not build")


def _corpus(seed, n, seq_len):
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(seq_len / 4), 0.8, n).astype(np.int64), 0, 2 * seq_len)
    return [rng.integers(1, 50_000, int(m)).astype(np.int32) for m in lengths]


def _same(got, want):
    assert got["truncated"] == want["truncated"]
    for key in ("input_ids", "segment_ids", "positions"):
        assert got[key].dtype == want[key].dtype and got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("seed,n,seq_len,max_segments", [
    (0, 40, 32, 0), (1, 300, 64, 0), (2, 300, 64, 3), (3, 2048, 128, 0), (4, 2100, 64, 2),
])
def test_native_packer_is_byte_identical(seed, n, seq_len, max_segments):
    corpus = _corpus(seed, n, seq_len)
    corpus[3] = np.zeros((0,), np.int32)  # empties are dropped by every path
    corpus[5] = np.arange(1, seq_len + 8, dtype=np.int32)  # overlong: cut to seq_len
    python = tpacking.pack_sequences(corpus, seq_len, max_segments_per_row=max_segments, impl="python")
    assert python["truncated"] > 0  # overlong sequences are cut to seq_len
    native_out = tpacking.pack_sequences(corpus, seq_len, max_segments_per_row=max_segments, impl="native")
    jax_native = jpacking.pack_sequences(corpus, seq_len, max_segments_per_row=max_segments, impl="native")
    _same(native_out, python)
    _same(native_out, jax_native)
    auto = tpacking.pack_sequences(corpus, seq_len, max_segments_per_row=max_segments)
    _same(auto, python)


def test_auto_routes_large_corpora_to_the_native_packer(monkeypatch):
    calls = []
    original = native.pack_sequences_native
    monkeypatch.setattr(native, "pack_sequences_native", lambda *a: calls.append(len(a[1])) or original(*a))
    rng = np.random.default_rng(5)
    large = [rng.integers(1, 500, int(n)) for n in rng.integers(1, 40, tpacking.NATIVE_PACK_THRESHOLD)]
    tpacking.pack_sequences(large[1:], 32)
    assert calls == []  # below the threshold "auto" is the Python loop
    tpacking.pack_sequences(large + [np.zeros(0, np.int64)], 32)  # an empty sequence does not count
    assert calls == [tpacking.NATIVE_PACK_THRESHOLD]
    assert tpacking.NATIVE_PACK_THRESHOLD == jpacking.NATIVE_PACK_THRESHOLD


def test_pack_rejects_short_token_buffer():
    flat = np.arange(5, dtype=np.int32)  # 5 tokens on the buffer...
    lengths = np.array([4, 6], dtype=np.int64)  # ...but lengths claim 10
    assert pack_sequences_native(flat, lengths, 8, 0, 0) is None
    assert jax_pack_native(flat, lengths, 8, 0, 0) is None  # the reference's wrapper refuses it too
    ok = pack_sequences_native(np.arange(10, dtype=np.int32), np.array([4, 6], dtype=np.int64), 8, 0, 0)
    assert ok is not None and ok["input_ids"].shape[0] >= 1


def _data(n=512, dim=16):
    rng = np.random.default_rng(0)
    return {
        "x": rng.normal(size=(n, dim)).astype(np.float32),
        "y": rng.integers(0, 4, size=(n,)).astype(np.int32),
    }


def test_prefetch_matches_python_gather():
    data = _data()
    loader = PrefetchLoader(data, batch_size=64, n_slots=3, n_threads=4)
    assert loader.uses_native
    perm = np.random.default_rng(7).permutation(512)
    seen = 0
    for b, batch in enumerate(loader.epoch(rng=np.random.default_rng(7))):
        idx = perm[b * 64:(b + 1) * 64]
        assert isinstance(batch["x"], torch.Tensor)
        np.testing.assert_array_equal(batch["x"].numpy(), data["x"][idx])
        np.testing.assert_array_equal(batch["y"].numpy(), data["y"][idx])
        seen += 1
    assert seen == 8
    loader.close()


def test_prefetch_slot_reuse_many_batches():
    """More batches than slots exercises the per-slot ordering constraint."""
    loader = PrefetchLoader(_data(n=2048), batch_size=64, n_slots=2, n_threads=4)
    for _ in range(2):  # two epochs reuse the same prefetcher
        assert sum(1 for _ in loader.epoch(rng=np.random.default_rng(1))) == 32
    loader.close()


def test_prefetch_mismatched_rows_rejected():
    with pytest.raises(ValueError, match="leading dimension"):
        PrefetchLoader({"a": np.ones((4, 2)), "b": np.ones((5, 2))}, batch_size=2)


def test_prefetch_drop_remainder_false_yields_true_tail():
    data = _data(n=100)
    loader = PrefetchLoader(data, batch_size=64, n_slots=2, n_threads=2, drop_remainder=False)
    perm = np.random.default_rng(5).permutation(100)
    batches = [{k: v.clone() for k, v in b.items()} for b in loader.epoch(rng=np.random.default_rng(5))]
    assert [len(b["x"]) for b in batches] == [64, 36]
    np.testing.assert_array_equal(batches[1]["x"].numpy(), data["x"][perm[64:]])
    loader.close()


def _bits(tensor: torch.Tensor) -> np.ndarray:
    return tensor.view(torch.int16).numpy().view(np.uint16)


def test_prefetch_worker_side_dtype_conversion():
    rng = np.random.default_rng(7)
    data = {
        "f64": rng.normal(size=(40, 3)),
        "i64": rng.integers(-1000, 1000, size=(40,)).astype(np.int64),
        "f32": np.concatenate([rng.normal(size=(39, 4)), [[np.inf, -np.inf, 1e-40, 3.0e38]]]).astype(np.float32),
    }
    convert = {"f64": "float32", "i64": "int32", "f32": "bfloat16"}
    loader = PrefetchLoader(data, batch_size=8, n_slots=2, n_threads=2, convert=convert)
    reference = JaxLoader(data, batch_size=8, n_slots=2, n_threads=2, convert=convert)
    perm = np.random.default_rng(9).permutation(40)
    got_all = list(loader.epoch(rng=np.random.default_rng(9)))
    want_all = list(reference.epoch(rng=np.random.default_rng(9)))
    first = got_all[0]
    assert (first["f64"].dtype, first["i64"].dtype, first["f32"].dtype) == (torch.float32, torch.int32,
                                                                           torch.bfloat16)
    np.testing.assert_array_equal(first["f64"].numpy(), data["f64"][perm[:8]].astype(np.float32))
    np.testing.assert_array_equal(first["i64"].numpy(), data["i64"][perm[:8]].astype(np.int32))
    for b, (got, want) in enumerate(zip(got_all, want_all)):
        rows = data["f32"][perm[b * 8:(b + 1) * 8]]
        # round-to-nearest-even bits: ml_dtypes', JAX's loader's, and a torch cast of the same rows
        np.testing.assert_array_equal(_bits(got["f32"]), rows.astype(ml_dtypes.bfloat16).view(np.uint16))
        np.testing.assert_array_equal(_bits(got["f32"]), want["f32"].view(np.uint16))
        np.testing.assert_array_equal(_bits(got["f32"]), _bits(torch.from_numpy(rows).to(torch.bfloat16)))
    loader.close()
    reference.close()


def test_prefetch_copy_false_yields_python_owned_slots():
    loader = PrefetchLoader(_data(n=64), batch_size=16, n_slots=2, n_threads=1)
    seen = [batch["x"].data_ptr() for batch in loader.epoch(rng=np.random.default_rng(0), copy=False)]
    assert len(set(seen)) <= 2 and len(seen) == 4  # the two slots recycle
    assert not loader._slots[0][0].is_pinned()  # pinned only for a CUDA consumer
    loader.close()


def test_prefetch_rejects_unknown_conversion_and_accepts_noop():
    data = _data(n=16)
    with pytest.raises(ValueError, match="Unsupported native conversion"):
        PrefetchLoader(data, batch_size=8, convert={"x": "float16"})
    with pytest.raises(ValueError, match="unknown arrays"):
        PrefetchLoader(data, batch_size=8, convert={"nope": "float32"})
    loader = PrefetchLoader(data, batch_size=8, convert={k: str(v.dtype) for k, v in data.items()})
    first = next(iter(loader.epoch()))
    assert first["x"].dtype == torch.float32 and first["y"].dtype == torch.int32
    loader.close()


def test_prefetch_deferred_release_lookahead():
    """A held (unreleased) batch stays intact while the consumer pulls ahead:
    the copy-overlap contract fit(prefetch=True) relies on."""
    data = _data()
    loader = PrefetchLoader(data, batch_size=64, n_slots=4, n_threads=2)
    perm = np.random.default_rng(11).permutation(512)
    gen = loader.epoch(rng=np.random.default_rng(11), copy=False, defer_release=True)
    held = [next(gen) for _ in range(3)]  # hold 3 of 4 slots unreleased while pulling ahead
    for b, (views, _) in enumerate(held):
        np.testing.assert_array_equal(views["x"].numpy(), data["x"][perm[b * 64:(b + 1) * 64]])
    for _, release in held:
        release()
        release()  # idempotent
    seen = 3
    for views, release in gen:
        np.testing.assert_array_equal(views["x"].numpy(), data["x"][perm[seen * 64:(seen + 1) * 64]])
        release()
        seen += 1
    assert seen == 8
    loader.close()


def test_prefetch_python_fallback(monkeypatch):
    """Without the library the loader gathers in Python, with the same
    batches and the (views, release) contract."""
    data = {k: v[:40] for k, v in _data().items()}
    native_batches = list(PrefetchLoader(data, batch_size=16, drop_remainder=False).epoch(
        rng=np.random.default_rng(3)))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)
    loader = PrefetchLoader(data, batch_size=16, n_slots=2, n_threads=1, drop_remainder=False,
                            convert={"x": "bfloat16"})
    assert not loader.uses_native and not native_available()
    pairs = list(loader.epoch(rng=np.random.default_rng(3), defer_release=True))
    assert [len(v["x"]) for v, _ in pairs] == [16, 16, 8]
    for (views, release), want in zip(pairs, native_batches):
        assert torch.equal(views["x"], want["x"].to(torch.bfloat16)) and torch.equal(views["y"], want["y"])
        release()
    assert tpacking.pack_sequences([np.arange(1, 5)], 8, impl="native")["input_ids"].shape == (1, 8)


def _build_stale_lib(tmp_path, monkeypatch):
    """A library at the hashed path that lacks the packer's symbols (built
    from prefetch.cpp alone), as a truncated or foreign build would."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    lib_path = native.library_path()
    lib_path.parent.mkdir(parents=True)
    subprocess.run(["g++", *native._FLAGS, str(native._SOURCES[0]), "-o", str(lib_path)], check=True,
                   capture_output=True)
    return lib_path


def test_stale_library_missing_symbols_self_heals(tmp_path, monkeypatch):
    lib_path = _build_stale_lib(tmp_path, monkeypatch)
    assert not hasattr(ctypes.CDLL(str(lib_path)), "upk_pack")
    lib = native.load_native_library()
    assert lib is not None and hasattr(lib, "upk_pack") and native.native_available()
    out = native.pack_sequences_native(np.arange(1, 5, dtype=np.int32), np.array([4], dtype=np.int64), 8, 0, 0)
    assert out is not None and out["input_ids"].shape == (1, 8)


def test_stale_library_degrades_when_rebuild_stays_stale(tmp_path, monkeypatch):
    lib_path = _build_stale_lib(tmp_path, monkeypatch)
    calls = []

    def rebuild_stale(path):
        calls.append(path)
        return ctypes.CDLL(str(lib_path))

    monkeypatch.setattr(native, "_rebuild_and_load_fresh", rebuild_stale)
    assert native.load_native_library() is None  # degraded, no AttributeError
    assert len(calls) == 1 and not native.native_available()
    assert tpacking.pack_sequences([np.arange(1, 5)], 8, impl="native")["input_ids"].shape == (1, 8)
    assert not PrefetchLoader(_data(n=16), batch_size=8).uses_native


def _mlp_data():
    rng = np.random.default_rng(0)
    return {"inputs": rng.normal(size=(96, 8)), "labels": rng.integers(0, 3, size=96).astype(np.int64)}


@pytest.fixture(scope="module")
def mlp_pair():
    jmlp = JaxMLP(hidden_sizes=(16,), num_classes=3)
    variables = jmlp.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    return jmlp, jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _port_mlp_state(variables):
    mlp = MLPClassifier(8, hidden_sizes=(16,), num_classes=3, device="cpu")
    mlp.load_state_dict(mlp_params_from_jax(variables))
    return create_train_state(mlp, learning_rate=1e-2)


def test_fit_prefetch_matches_fit_and_jax(mlp_pair):
    jmlp, variables = mlp_pair
    data = _mlp_data()
    convert = {"inputs": "float32", "labels": "int32"}
    kwargs = dict(batch_size=16, num_epochs=2, log_every=1, seed=3)
    off = fit(_port_mlp_state(variables), {"inputs": data["inputs"].astype(np.float32),
                                            "labels": data["labels"].astype(np.int32)}, **kwargs)
    on = fit(_port_mlp_state(variables), data, prefetch=True, prefetch_convert=convert, **kwargs)
    assert [h["loss"] for h in on.metrics_history] == [h["loss"] for h in off.metrics_history]
    assert on.steps == off.steps == 13  # the first step and 2 epochs of 6
    jstate = jtraining.create_train_state(jmlp, variables, learning_rate=1e-2)
    want = jtraining.fit(jstate, data, prefetch=True, prefetch_convert=convert, **kwargs)
    np.testing.assert_allclose([h["loss"] for h in on.metrics_history], [h["loss"] for h in want.metrics_history],
                               rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="unknown arrays"):
        fit(_port_mlp_state(variables), data, prefetch=True, prefetch_convert={"typo": "float32"}, **kwargs)
    with pytest.raises(ValueError, match="requires prefetch=True"):
        fit(_port_mlp_state(variables), data, prefetch_convert=convert, **kwargs)


@pytest.mark.parametrize("num_steps,num_epochs", [(5, 1), (None, 3)], ids=["steps", "epochs"])
def test_fit_prefetch_sees_the_jax_batches(num_steps, num_epochs):
    """The same batches in the same order as JAX's fit(prefetch=True),
    ragged epochs included (drop_remainder)."""
    data = {"inputs": np.arange(46 * 2, dtype=np.float32).reshape(46, 2), "labels": np.arange(46, dtype=np.int32)}
    seen = {"jax": [], "port": []}

    def recording(key):
        def step_fn(state, batch):
            seen[key].append(np.asarray(batch["labels"]).tolist())
            state.step += 1
            return state, {"loss": np.float32(0.0)}
        return step_fn

    kwargs = dict(batch_size=8, num_steps=num_steps, num_epochs=num_epochs, log_every=2, seed=11, prefetch=True)
    state = types.SimpleNamespace(step=0, device=torch.device("cpu"))
    got = fit(state, data, step_fn=recording("port"), **kwargs)
    want = jtraining.fit(types.SimpleNamespace(step=0), data, step_fn=recording("jax"), **kwargs)
    assert seen["port"] == seen["jax"] and got.steps == want.steps


def test_fit_lm_prefetch_matches_fit_lm():
    config = GPTConfig.tiny(dtype=torch.float32, dropout=0.1)
    params = random_params(config, seed=0)
    rng = np.random.default_rng(4)
    corpus = [rng.integers(1, 512, int(n)).astype(np.int32) for n in rng.integers(3, 40, 40)]
    losses = {}
    for prefetch in (False, True):
        state = create_train_state(init_gpt(config, params=params, device="cpu"), learning_rate=1e-3, seed=1)
        result = fit_lm(state, corpus, seq_len=32, batch_size=2, num_steps=5, log_every=1, prefetch=prefetch)
        losses[prefetch] = [h["loss"] for h in result.metrics_history]
    assert losses[True] == losses[False] and len(losses[True]) == 4
