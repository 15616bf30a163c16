"""The port's twin of ``tests/integration/flaky_app.py``: an app whose reader fails
on the first attempt in a fresh ``UNIONML_TEST_FLAKY_DIR`` (a transient worker
crash) and succeeds afterwards — exercises job-level retries."""

import os
from pathlib import Path
from typing import List

import numpy as np
import pandas as pd
from sklearn.linear_model import LogisticRegression

from unionml_tpu_torch import Dataset, Model

dataset = Dataset(name="flaky_dataset", targets=["y"])
model = Model(name="flaky_model", init=LogisticRegression, dataset=dataset)


@dataset.reader
def reader(n: int = 40) -> pd.DataFrame:
    sentinel = Path(os.environ["UNIONML_TEST_FLAKY_DIR"]) / "attempted"
    if not sentinel.exists():
        sentinel.parent.mkdir(parents=True, exist_ok=True)
        sentinel.touch()
        raise RuntimeError("transient failure (first attempt)")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 2))
    return pd.DataFrame({"a": x[:, 0], "b": x[:, 1], "y": (x.sum(axis=1) > 0).astype(int)})


@model.trainer
def trainer(estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> LogisticRegression:
    return estimator.fit(features, target.squeeze())


@model.predictor
def predictor(estimator: LogisticRegression, features: pd.DataFrame) -> List[float]:
    return [float(x) for x in estimator.predict(features)]


@model.evaluator
def evaluator(estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> float:
    return float(estimator.score(features, target.squeeze()))
