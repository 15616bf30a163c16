"""{{app_name}}: the unionml-tpu quickstart on the PyTorch port.

Digits classification with a from-scratch softmax regression written in torch
ops: the trainer is a plain full-batch gradient loop over a parameter dict, so
the same app runs on the card or the CPU. (For the framework's MLP and its
``fit()`` loop, see the ``jax-digits`` template; opaque model objects work too,
``torch-digits`` trains a user-owned pytorch MLP.)

Runs on the card; set UNIONML_DEVICE=cpu to run on the CPU.
"""

import os
from typing import Dict, List

import pandas as pd
import torch
from sklearn.datasets import load_digits

from unionml_tpu_torch import Dataset, Model

DEVICE = os.environ.get("UNIONML_DEVICE", "cuda")

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2, shuffle=True, targets=["target"])


def init(scale: float = 0.01, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A (64 pixels -> 10 classes) softmax regression, as a plain param dict."""
    generator = torch.Generator().manual_seed(seed)
    return {
        "w": (scale * torch.randn((64, 10), generator=generator)).to(DEVICE),
        "b": torch.zeros((10,), device=DEVICE),
    }


model = Model(name="{{app_name}}", init=init, dataset=dataset)


@dataset.reader
def reader() -> pd.DataFrame:
    return load_digits(as_frame=True).frame


def _pixels(features: pd.DataFrame) -> torch.Tensor:
    return torch.tensor(features.to_numpy(), dtype=torch.float32, device=DEVICE) / 16.0  # digits are 4-bit


def _step(params: Dict[str, torch.Tensor], pixels, labels, learning_rate: float) -> Dict[str, torch.Tensor]:
    """One full-batch SGD step on the cross-entropy."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = torch.nn.functional.cross_entropy(pixels @ leaves["w"] + leaves["b"], labels)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {k: (v - learning_rate * g).detach() for (k, v), g in zip(leaves.items(), grads)}


@model.trainer
def trainer(
    params: Dict[str, torch.Tensor],
    features: pd.DataFrame,
    target: pd.DataFrame,
    *,
    learning_rate: float = 0.5,
    num_epochs: int = 120,
) -> Dict[str, torch.Tensor]:
    pixels = _pixels(features)
    labels = torch.tensor(target.squeeze().to_numpy(), dtype=torch.long, device=DEVICE)
    for _ in range(num_epochs):
        params = _step(params, pixels, labels, learning_rate)
    return params


@model.predictor(jit=False)
def predictor(params: Dict[str, torch.Tensor], features: pd.DataFrame) -> List[float]:
    logits = _pixels(features) @ params["w"] + params["b"]
    return [float(c) for c in logits.argmax(dim=-1).cpu()]


@model.evaluator(jit=False)
def evaluator(params: Dict[str, torch.Tensor], features: pd.DataFrame, target: pd.DataFrame) -> float:
    guesses = torch.tensor(predictor(params, features))
    truth = torch.tensor(target.squeeze().to_numpy(), dtype=torch.float32)
    return float((guesses == truth).float().mean())


if __name__ == "__main__":
    params, metrics = model.train(hyperparameters={"scale": 0.01, "seed": 0})
    print(f"metrics: {metrics}")
    model.save("model.pt")
    sample = load_digits(as_frame=True).frame.sample(5, random_state=42).drop(columns=["target"])
    print(f"predictions: {model.predict(features=sample.to_dict(orient='records'))}")
