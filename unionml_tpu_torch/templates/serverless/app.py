"""{{app_name}}: digits classifier served through a serverless event handler, on the
PyTorch port of unionml-tpu.

The handler speaks API-Gateway-style HTTP events and storage-notification events —
deployable to any FaaS runtime that invokes ``handler(event, context)``. The model is
a scikit-learn estimator, so the app needs scikit-learn and pandas and no card.
"""

from typing import List

import pandas as pd
from sklearn.datasets import load_digits
from sklearn.linear_model import LogisticRegression

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.services import make_event_handler

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


# the FaaS entrypoint: reads the model from UNIONML_MODEL_PATH at first invocation
handler = make_event_handler(model)


if __name__ == "__main__":
    import json

    model.train(hyperparameters={"C": 1.0, "max_iter": 5000})
    model.save("model.joblib")

    import os

    os.environ["UNIONML_MODEL_PATH"] = "model.joblib"
    sample = load_digits(as_frame=True).frame.sample(2, random_state=0).drop(columns=["target"])
    event = {"body": json.dumps({"features": sample.to_dict(orient="records")})}
    print(handler(event, None))
