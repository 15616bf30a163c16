"""The port's ``Dataset`` against the JAX package's, on the same seeded readers.

Splits and parsed features must be byte-identical (the default splitter draws
the same permutation for the same ``random_state``); ``device_format="torch"``
must hold the same values as ``device_format="jax"`` (float64 becomes float32
in both; JAX, with 64-bit types off, also narrows int64 to int32, which torch
keeps). Exact comparisons throughout: no arithmetic is compared.
"""

import sqlite3
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from unionml_tpu import Dataset as JDataset
from unionml_tpu_torch import Dataset as TDataset


def _frame_reader(n: int = 50, seed: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"a": rng.normal(size=n), "b": rng.normal(size=n), "y": rng.integers(0, 2, size=n)})


def _dict_reader(n: int = 37, seed: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(0, 1000, (n, 16)).astype(np.int32),
        "attention_mask": (rng.random((n, 16)) > 0.2).astype(np.int32),
        "labels": rng.integers(0, 2, n).astype(np.int32),
    }


def _array_reader(n: int = 23) -> np.ndarray:
    return np.arange(n * 3, dtype=np.float64).reshape(n, 3)


READERS = {"frame": (_frame_reader, ["y"]), "dict": (_dict_reader, ["labels"]), "array": (_array_reader, None)}


def _pair(kind: str, **kwargs):
    reader, targets = READERS[kind]
    datasets = []
    for cls, extra in ((JDataset, {}), (TDataset, {})):
        ds = cls(name=f"{kind}_ds", targets=targets, **kwargs, **extra)
        ds.reader(reader)
        datasets.append(ds)
    return datasets


def _host(value):
    """A host view of one split element: DataFrames as (columns, values, index),
    dicts key by key, tensors and device arrays as numpy."""
    if isinstance(value, pd.DataFrame):
        return list(value.columns), value.to_numpy(), value.index.to_numpy()
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, list):
        assert a == b
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", sorted(READERS))
@pytest.mark.parametrize("splitter_kwargs", [None, {"test_size": 0.5}, {"shuffle": False}, {"random_state": 7}],
                         ids=["default", "half", "no-shuffle", "seed-7"])
def test_splits_are_byte_identical(kind, splitter_kwargs):
    jds, tds = _pair(kind)
    raw = READERS[kind][0]()
    jdata, tdata = jds.get_data(raw, splitter_kwargs=splitter_kwargs), tds.get_data(raw, splitter_kwargs=splitter_kwargs)
    assert jdata.keys() == tdata.keys()
    for split in jdata:
        assert len(jdata[split]) == len(tdata[split])
        for a, b in zip(jdata[split], tdata[split]):
            _assert_same(_host(a), _host(b))


@pytest.mark.parametrize("kind", ["frame", "dict"])
def test_device_format_torch_matches_jax(kind):
    jds = JDataset(name="j", targets=READERS[kind][1], device_format="jax")
    tds = TDataset(name="t", targets=READERS[kind][1], device_format="torch", device="cpu")
    jds.reader(READERS[kind][0])
    tds.reader(READERS[kind][0])
    raw = READERS[kind][0]()
    jdata, tdata = jds.get_data(raw), tds.get_data(raw)
    for split in jdata:
        for a, b in zip(jdata[split], tdata[split]):
            if isinstance(a, dict):
                assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in b.values())
                a, b = {k: np.asarray(v) for k, v in a.items()}, _host(b)
            else:
                assert isinstance(a, jax.Array) and isinstance(b, torch.Tensor)
                a, b = {"": np.asarray(a)}, {"": b.numpy()}
            for key in a:
                want, got = a[key], b[key]
                if got.dtype == np.int64:  # JAX narrowed it
                    assert want.dtype == np.int32 and np.array_equal(got, want.astype(np.int64))
                else:
                    _assert_same(want, got)
    assert tds.feature_type is torch.Tensor and jds.feature_type is jax.Array


def test_default_feature_pipeline_matches():
    jds, tds = _pair("frame")
    rows = [{"a": 1.0, "b": 2.0, "y": 1}, {"a": -1.0, "b": 0.5, "y": 0}]
    jf, tf = jds.get_features(rows), tds.get_features(rows)
    assert list(tf.columns) == list(jf.columns) == ["a", "b"]
    _assert_same(_host(jf), _host(tf))


def test_custom_feature_pipeline():
    for cls in (JDataset, TDataset):
        ds = cls(name="ds", targets=["y"])
        ds.reader(_frame_reader)

        @ds.feature_loader
        def feature_loader(raw: List[List[float]]) -> pd.DataFrame:
            return pd.DataFrame(raw, columns=["a", "b"])

        @ds.feature_transformer
        def feature_transformer(features: pd.DataFrame) -> pd.DataFrame:
            return features * 2

        features = ds.get_features([[1.0, 2.0]])
        assert features.iloc[0, 0] == 2.0 and features.iloc[0, 1] == 4.0


def test_custom_splitter_and_parser_non_dataframe():
    shapes = []
    for cls in (JDataset, TDataset):
        ds = cls(name="ds")

        @ds.reader
        def reader() -> Dict[str, np.ndarray]:
            return {"x": np.arange(10.0), "y": np.arange(10.0) % 2}

        Splits = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]

        @ds.splitter
        def splitter(data: Dict[str, np.ndarray], test_size: float, shuffle: bool, random_state: int) -> Splits:
            n_test = int(len(data["x"]) * test_size)
            return {k: v[:-n_test] for k, v in data.items()}, {k: v[-n_test:] for k, v in data.items()}

        @ds.parser
        def parser(data: Dict[str, np.ndarray], features: Optional[List[str]], targets: List[str]) -> Tuple[np.ndarray, np.ndarray]:
            return data["x"], data["y"]

        data = ds.get_data(reader())
        shapes.append((data["train"][0].shape, data["test"][0].shape))
    assert shapes[0] == shapes[1] == ((8,), (2,))


def test_ragged_list_columns_split_the_same():
    outs = []
    for cls in (JDataset, TDataset):
        ds = cls(name="ragged_ds", test_size=0.25, shuffle=True, random_state=7)

        @ds.reader
        def reader() -> dict:
            return {"sequences": [[1], [2, 2], [3, 3, 3], [4, 4, 4, 4]], "flat": [10, 20, 30, 40]}

        splits = ds.get_data(reader())
        outs.append({s: (v[0]["sequences"], v[0]["flat"].tolist()) for s, v in splits.items()})
    assert outs[0] == outs[1]


def test_dataset_task_and_kwargs_types_match():
    jds, tds = _pair("frame")
    jtask, ttask = jds.dataset_task(), tds.dataset_task()
    assert ttask.name == jtask.name
    assert list(ttask.python_interface.inputs) == list(jtask.python_interface.inputs) == ["n", "seed"]
    assert list(ttask.python_interface.outputs) == ["data"]
    _assert_same(_host(ttask(n=10)), _host(jtask(n=10)))
    for attr in ("loader_kwargs_type", "splitter_kwargs_type", "parser_kwargs_type"):
        jt, tt = getattr(jds, attr), getattr(tds, attr)
        assert tt().to_dict() == jt().to_dict()


def test_reader_requires_return_annotation():
    for cls in (JDataset, TDataset):
        ds = cls(name="ds")
        with pytest.raises(TypeError, match="return type"):
            @ds.reader
            def reader(n: int = 10):
                return [1.0] * n


def test_from_sqlite_matches(tmp_path):
    db = tmp_path / "data.db"
    with sqlite3.connect(db) as conn:
        _frame_reader(30).to_sql("t", conn, index=False)
    query = "SELECT * FROM t WHERE a > :lo"
    jds = JDataset.from_sqlite(str(db), query, query_params={"lo": float}, name="sq", targets=["y"])
    tds = TDataset.from_sqlite(str(db), query, query_params={"lo": float}, name="sq", targets=["y"])
    _assert_same(_host(tds.dataset_task()(lo=0.0)), _host(jds.dataset_task()(lo=0.0)))


def test_device_format_validation_and_cuda_default():
    with pytest.raises(ValueError, match="device_format"):
        TDataset(name="ds", device_format="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TDataset(name="ds", device_format="torch")


def test_import_does_not_load_pandas():
    code = ("import sys; from unionml_tpu_torch import Dataset, Model; "
            "import unionml_tpu_torch.serving, unionml_tpu_torch.checkpoint; "
            "bad = [m for m in ('pandas', 'aiohttp', 'joblib', 'sklearn', 'jax') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
