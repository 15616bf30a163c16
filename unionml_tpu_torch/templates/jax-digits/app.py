"""{{app_name}}: digits MLP on the PyTorch port: the trainer is the ``fit()`` loop.

The name is the JAX package's template's: the same app, with the port's
``MLPClassifier`` and ``fit`` inside (the dataset hands the stages tensors,
``device_format="torch"``; persistence is the port's state format).

Runs on the card; set UNIONML_DEVICE=cpu to run on the CPU.
"""

import os

import numpy as np
import pandas as pd
import torch
from sklearn.datasets import load_digits

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.models import MLPClassifier, TrainState, create_train_state, fit, make_classifier_eval_step

DEVICE = os.environ.get("UNIONML_DEVICE", "cuda")

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2, targets=["target"], device_format="torch",
                  device=DEVICE)


def init(learning_rate: float = 1e-3) -> TrainState:
    torch.manual_seed(0)
    mlp = MLPClassifier(64, hidden_sizes=(128,), num_classes=10, device=DEVICE)
    return create_train_state(mlp, learning_rate=learning_rate)


model = Model(name="{{app_name}}", init=init, dataset=dataset)


@dataset.reader
def reader() -> pd.DataFrame:
    return load_digits(as_frame=True).frame


@model.trainer
def trainer(state: TrainState, features: torch.Tensor, target: torch.Tensor, *, num_epochs: int = 30) -> TrainState:
    data = {"inputs": features.cpu().numpy(), "labels": target.cpu().numpy().reshape(-1).astype(np.int32)}
    return fit(state, data, batch_size=512, num_epochs=num_epochs, log_every=10_000).state


@model.predictor
def predictor(state: TrainState, features: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return state.model(features).argmax(dim=-1).to(torch.float32)


@model.evaluator(jit=False)
def evaluator(state: TrainState, features: torch.Tensor, target: torch.Tensor) -> float:
    labels = target.reshape(-1).to(torch.int32)
    return float(make_classifier_eval_step()(state, {"inputs": features, "labels": labels})["accuracy"])


if __name__ == "__main__":
    state, metrics = model.train(hyperparameters={"learning_rate": 1e-3})
    print(f"metrics: {metrics}")
    model.save("model.ckpt")
