"""{{app_name}}: data-parallel training over every rank of a torch.distributed world.

The trainer lays a ``{"data": N}`` mesh over the world (one process per card,
NCCL; or CPU processes over gloo with UNIONML_DEVICE=cpu), each rank takes its
rows of every batch, and the gradients are all-reduced (a mean) before each
optimizer step, so every rank holds the same parameters. Launch one process
per card with ``torchrun --nproc-per-node=N app.py``; ``UNIONML_DEVICE=cpu
torchrun --nproc-per-node=2 app.py`` runs a gloo world of two on the CPU, and
``python app.py`` alone a world of one.
"""

import os
import socket
from typing import Dict

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.models import MLPClassifier, TrainState, create_train_state, fit, make_classifier_eval_step
from unionml_tpu_torch.parallel import initialize_distributed, is_primary_host, make_mesh

DEVICE = os.environ.get("UNIONML_DEVICE", "cuda")

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2, targets=["labels"])


def join_world() -> None:
    """The world torchrun describes in the environment (a failure to join it
    raises), else a world of one."""
    if os.environ.get("WORLD_SIZE"):
        initialize_distributed(strict=True, device=DEVICE)
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, strict=True, device=DEVICE)


def init(learning_rate: float = 1e-3) -> TrainState:
    torch.manual_seed(0)  # every rank starts from the same weights
    mlp = MLPClassifier(64, hidden_sizes=(256, 128), num_classes=10, device=DEVICE)
    return create_train_state(mlp, learning_rate=learning_rate)


model = Model(name="{{app_name}}", init=init, dataset=dataset)


@dataset.reader
def reader(n: int = 8192, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    inputs = rng.normal(size=(n, 64)).astype(np.float32) + labels[:, None] * 0.3
    return {"inputs": inputs, "labels": labels.astype(np.int32)}


@model.trainer
def trainer(
    state: TrainState,
    features: Dict[str, np.ndarray],
    targets: Dict[str, np.ndarray],
    *,
    num_epochs: int = 5,
    batch_size: int = 1024,
) -> TrainState:
    join_world()
    mesh = make_mesh(device=DEVICE)  # 1-D data axis over every rank
    data = {"inputs": np.asarray(features["inputs"], dtype=np.float32),
            "labels": np.asarray(targets["labels"]).reshape(-1).astype(np.int32)}
    result = fit(state, data, batch_size=batch_size, num_epochs=num_epochs, mesh=mesh, log_every=20)
    if is_primary_host():
        print(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} throughput: {result.examples_per_s:.0f} examples/s")
    return result.state


@model.predictor
def predictor(state: TrainState, features: Dict[str, np.ndarray]) -> np.ndarray:
    with torch.no_grad():
        logits = state.model(torch.as_tensor(np.asarray(features["inputs"], dtype=np.float32), device=state.device))
    return logits.argmax(dim=-1).cpu().numpy()


@model.evaluator
def evaluator(state: TrainState, features: Dict[str, np.ndarray], targets: Dict[str, np.ndarray]) -> float:
    batch = {"inputs": torch.as_tensor(np.asarray(features["inputs"], dtype=np.float32), device=state.device),
             "labels": torch.as_tensor(np.asarray(targets["labels"]).reshape(-1).astype(np.int32), device=state.device)}
    return float(make_classifier_eval_step()(state, batch)["accuracy"])


if __name__ == "__main__":
    state, metrics = model.train()
    if is_primary_host():
        print(f"metrics: {metrics}")
        model.save("model.ckpt")
