"""{{app_name}}: pytorch MLP digits classifier, the opaque-trainer path.

The reference's pytorch quickstart shape (a user-owned torch loop inside
@model.trainer): the framework runs the trainer as it is, and persistence uses
the torch state_dict default saver and loader.

Runs on the card; set UNIONML_DEVICE=cpu to run on the CPU.
"""

import os
from typing import List

import pandas as pd
import torch
import torch.nn as nn
from sklearn.datasets import load_digits

from unionml_tpu_torch import Dataset, Model

DEVICE = os.environ.get("UNIONML_DEVICE", "cuda")

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2, shuffle=True, targets=["target"])


class DigitsMLP(nn.Module):
    def __init__(self, in_dims: int = 64, hidden_dims: int = 100, num_classes: int = 10):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Linear(in_dims, hidden_dims), nn.ReLU(), nn.Linear(hidden_dims, num_classes)
        ).to(DEVICE)

    def forward(self, features):
        return self.layers(features)


model = Model(name="{{app_name}}", init=DigitsMLP, dataset=dataset)


@dataset.reader
def reader() -> pd.DataFrame:
    return load_digits(as_frame=True).frame


@model.trainer
def trainer(
    module: DigitsMLP,
    features: pd.DataFrame,
    target: pd.DataFrame,
    *,
    batch_size: int = 512,
    n_epochs: int = 30,
    learning_rate: float = 3e-4,
) -> DigitsMLP:
    opt = torch.optim.Adam(module.parameters(), lr=learning_rate)
    loss_fn = nn.CrossEntropyLoss()
    X = torch.tensor(features.values, dtype=torch.float32, device=DEVICE)
    y = torch.tensor(target.squeeze().values, dtype=torch.long, device=DEVICE)
    for _ in range(n_epochs):
        for start in range(0, len(X), batch_size):
            opt.zero_grad()
            loss = loss_fn(module(X[start : start + batch_size]), y[start : start + batch_size])
            loss.backward()
            opt.step()
    return module


@model.predictor(jit=False)
def predictor(module: DigitsMLP, features: pd.DataFrame) -> List[float]:
    with torch.no_grad():
        logits = module(torch.tensor(features.values, dtype=torch.float32, device=DEVICE))
    return [float(x) for x in logits.argmax(dim=1).cpu()]


@model.evaluator(jit=False)
def evaluator(module: DigitsMLP, features: pd.DataFrame, target: pd.DataFrame) -> float:
    from sklearn.metrics import accuracy_score

    return float(accuracy_score(target.squeeze(), predictor(module, features)))


if __name__ == "__main__":
    module, metrics = model.train(hyperparameters={"in_dims": 64, "hidden_dims": 100, "num_classes": 10})
    print(f"metrics: {metrics}")
    model.save("torch_model.pt")
