"""The port's twin of ``tests/integration/backend_app.py``: a real importable app
module on ``unionml_tpu_torch`` that the backend worker rehydrates by name
(``tests.torch_backend_app:model``)."""

from typing import List

import numpy as np
import pandas as pd
from sklearn.linear_model import LogisticRegression

from unionml_tpu_torch import Dataset, Model

dataset = Dataset(name="backend_dataset", targets=["y"], test_size=0.2)
model = Model(name="backend_model", init=LogisticRegression, dataset=dataset)


@dataset.reader
def reader(n: int = 80, random_state: int = 0) -> pd.DataFrame:
    rng = np.random.default_rng(random_state)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    return pd.DataFrame({"x1": x1, "x2": x2, "y": (x1 + x2 > 0).astype(int)})


@model.trainer
def trainer(estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> LogisticRegression:
    return estimator.fit(features, target.squeeze())


@model.predictor
def predictor(estimator: LogisticRegression, features: pd.DataFrame) -> List[float]:
    return [float(x) for x in estimator.predict(features)]


@model.evaluator
def evaluator(estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> float:
    return float(estimator.score(features, target.squeeze()))


model.schedule_training("nightly-train", expression="@daily", hyperparameters={"max_iter": 200}, n=40)
