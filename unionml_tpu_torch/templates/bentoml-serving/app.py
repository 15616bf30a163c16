"""{{app_name}}: digits classifier packaged and served through BentoML, on the
PyTorch port of unionml-tpu.

Reference parity: the upstream `basic-bentoml` scaffold. Train locally, save the
model object into the bento model store, `bentoml build` the service, and serve
the built bento — the runnable declares GPU resources (`nvidia.com/gpu`) and holds
a resident predictor. The model is a scikit-learn estimator, so the app needs
scikit-learn and pandas.
"""

from typing import List

import pandas as pd
from sklearn.datasets import load_digits
from sklearn.linear_model import LogisticRegression

from unionml_tpu_torch import Dataset, Model

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2, shuffle=True, targets=["target"])
model = Model(name="{{app_name}}", init=LogisticRegression, dataset=dataset)


@dataset.reader
def reader() -> pd.DataFrame:
    return load_digits(as_frame=True).frame


@model.trainer
def trainer(estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> LogisticRegression:
    return estimator.fit(features, target.squeeze())


@model.predictor
def predictor(estimator: LogisticRegression, features: pd.DataFrame) -> List[float]:
    return [float(x) for x in estimator.predict(features)]


@model.evaluator
def evaluator(estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame) -> float:
    from sklearn.metrics import accuracy_score

    return float(accuracy_score(target.squeeze(), estimator.predict(features)))


if __name__ == "__main__":
    from unionml_tpu_torch.services.bentoml_service import BentoMLService

    model.train(hyperparameters={"C": 1.0, "max_iter": 5000})
    # bentoml tags must be lowercase; the app name is any valid Python identifier
    saved = BentoMLService(model).save_model(name="{{app_name}}".lower())
    print(f"saved to the bento model store: {saved.tag}")
    print("next: bentoml build && bentoml serve " + "{{app_name}}".lower() + ":latest")
