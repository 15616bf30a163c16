"""{{app_name}}: CNN image classifier (the Keras-MNIST tutorial shape) on the PyTorch port.

The reader returns a dict of arrays: images (n, 28, 28) float32 and labels (n,).
Training runs the port's ``fit()`` loop. Swap the synthetic reader for your
MNIST loader of choice.

Runs on the card; set UNIONML_DEVICE=cpu to run on the CPU.
"""

import os
from typing import Dict

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.models import CNNClassifier, TrainState, create_train_state, fit, make_classifier_eval_step

DEVICE = os.environ.get("UNIONML_DEVICE", "cuda")

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2, targets=["labels"])


def init(learning_rate: float = 3e-4) -> TrainState:
    torch.manual_seed(0)
    return create_train_state(CNNClassifier(num_classes=10, device=DEVICE), learning_rate=learning_rate)


model = Model(name="{{app_name}}", init=init, dataset=dataset)


@dataset.reader
def reader(n: int = 2048, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    images = rng.normal(size=(n, 28, 28)).astype(np.float32) + labels[:, None, None] * 0.1
    return {"images": images.astype(np.float32), "labels": labels.astype(np.int32)}


@model.trainer
def trainer(
    state: TrainState,
    features: Dict[str, np.ndarray],
    targets: Dict[str, np.ndarray],
    *,
    num_epochs: int = 10,
    batch_size: int = 512,
) -> TrainState:
    data = {"inputs": features["images"], "labels": targets["labels"]}
    return fit(state, data, batch_size=batch_size, num_epochs=num_epochs, log_every=100).state


@model.predictor(jit=False)
def predictor(state: TrainState, features: Dict[str, np.ndarray]) -> np.ndarray:
    with torch.no_grad():
        logits = state.model(torch.as_tensor(np.asarray(features["images"], np.float32), device=state.device))
    return logits.argmax(dim=-1).cpu().numpy()


@model.evaluator(jit=False)
def evaluator(state: TrainState, features: Dict[str, np.ndarray], targets: Dict[str, np.ndarray]) -> float:
    batch = {
        "inputs": torch.as_tensor(features["images"], device=state.device),
        "labels": torch.as_tensor(targets["labels"], device=state.device),
    }
    return float(make_classifier_eval_step()(state, batch)["accuracy"])


if __name__ == "__main__":
    state, metrics = model.train(hyperparameters={"learning_rate": 3e-4})
    print(f"metrics: {metrics}")
    model.save("cnn_model.ckpt")
