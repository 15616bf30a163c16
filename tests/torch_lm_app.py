"""A tiny GPT language-model app on ``unionml_tpu_torch`` for the CLI and backend
tests (the CPU stand-in of ``chip_smoke.py`` phase 20's GPT-2-small app): a
seeded token reader, ``fit_lm`` in the trainer (a ``TrainState`` model object,
which crosses the backend's wire in the checkpoint format), a generating
predictor, the LM loss with the trainer's kernel launch counts as metrics, and
a module-level ``generator`` factory that ``serve`` hands to ``/generate``.
Runs on the CPU (``DEVICE``)."""

from typing import Any, Dict

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model, kernels
from unionml_tpu_torch.models import GPTConfig, TrainState, create_train_state, fit_lm, generate, init_gpt
from unionml_tpu_torch.models import make_lm_eval_step

DEVICE = "cpu"
SEQ = 32
config = GPTConfig.tiny(dtype=torch.float32, dropout=0.0, max_position_embeddings=64)
TRAIN_LAUNCHES: Dict[str, int] = {}

dataset = Dataset(name="lm_app_dataset", test_size=0.25)


def init(learning_rate: float = 3e-3, seed: int = 0) -> TrainState:
    return create_train_state(init_gpt(config, seed=seed, device=DEVICE), learning_rate=learning_rate, seed=seed)


model = Model(name="lm_app", init=init, dataset=dataset)


@dataset.reader
def reader(n: int = 16, seed: int = 0) -> Dict[str, np.ndarray]:
    return {"input_ids": np.random.default_rng(seed).integers(1, config.vocab_size, (n, SEQ)).astype(np.int32)}


@dataset.feature_loader
def feature_loader(features: Any) -> Dict[str, Any]:
    return features


@model.trainer
def trainer(state: TrainState, features: Dict[str, np.ndarray], targets: Any, *, num_steps: int = 3,
            batch_size: int = 4) -> TrainState:
    before = dict(kernels.launches)
    result = fit_lm(state, list(np.asarray(features["input_ids"])), seq_len=SEQ, batch_size=batch_size,
                    pack=False, num_steps=num_steps, log_every=1, seed=0)
    TRAIN_LAUNCHES.update({k: kernels.launches[k] - before[k] for k in before})
    return result.state


@model.predictor(jit=False)
def predictor(state: TrainState, features: Dict[str, Any]) -> np.ndarray:
    ids = torch.tensor(np.asarray(features["prompt_ids"], np.int64), device=state.device)
    max_new = int(features.get("max_new_tokens", 4))
    with torch.no_grad():
        return generate(state.model, ids, max_new, max_len=ids.shape[1] + max_new).cpu().numpy()


@model.evaluator(jit=False)
def evaluator(state: TrainState, features: Dict[str, np.ndarray], targets: Any) -> Dict[str, float]:
    ids = torch.from_numpy(np.asarray(features["input_ids"])).to(state.device)
    loss = float(make_lm_eval_step()(state, {"input_ids": ids})["loss"])
    return {"lm_loss": loss, **{f"launches_{k}": float(v) for k, v in TRAIN_LAUNCHES.items()}}


def generator(replica: int = 0):
    """The ``/generate`` engine over the served state's model."""
    from unionml_tpu_torch.serving import DecodeEngine

    return DecodeEngine(model.artifact.model_object.model, num_slots=2, max_len=64, device=DEVICE)
