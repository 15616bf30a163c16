"""{{app_name}}: BERT-base text-classification fine-tune on the PyTorch port.

Data contract: the reader returns a dict of arrays (input_ids, attention_mask,
labels): plug in your tokenizer of choice upstream. Training runs the port's
``fit()`` loop with step checkpoints (resumed from ``checkpoint_dir`` when it
holds one); bf16 compute on f32 parameters, attention through the port's
flash kernels forward and backward on an H100.

Runs on the card; set UNIONML_DEVICE=cpu to run the plain PyTorch path on the
CPU (slow at BERT-base width).
"""

import os
from typing import Dict

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.models import BertConfig, TrainState, create_train_state, fit, init_bert, \
    make_classifier_eval_step

DEVICE = os.environ.get("UNIONML_DEVICE", "cuda")
SEQ_LEN = 128
SIGNATURE = ("input_ids", "attention_mask")

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.1, targets=["labels"])

config = BertConfig.base(num_labels=2, dtype=torch.bfloat16)


def init(learning_rate: float = 2e-5, warmup_steps: int = 100) -> TrainState:
    bert = init_bert(config, seed=0, device=DEVICE)  # or import_hf_weights(...)
    return create_train_state(bert, learning_rate=learning_rate, warmup_steps=warmup_steps, total_steps=10_000)


model = Model(name="{{app_name}}", init=init, dataset=dataset)


@dataset.reader
def reader(n: int = 1024, seed: int = 0) -> Dict[str, np.ndarray]:
    """Replace with your tokenized dataset; shapes: (n, SEQ_LEN) int32 + (n,) labels."""
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(0, config.vocab_size, size=(n, SEQ_LEN)).astype(np.int32),
        "attention_mask": np.ones((n, SEQ_LEN), dtype=np.int32),
        "labels": rng.integers(0, config.num_labels, size=(n,)).astype(np.int32),
    }


@model.trainer
def trainer(
    state: TrainState,
    features: Dict[str, np.ndarray],
    targets: Dict[str, np.ndarray],
    *,
    num_epochs: int = 3,
    batch_size: int = 32,
    checkpoint_dir: str = "checkpoints",
) -> TrainState:
    data = {**features, **targets}
    result = fit(
        state,
        data,
        batch_size=batch_size,
        num_epochs=num_epochs,
        input_signature=SIGNATURE,
        checkpoint_dir=checkpoint_dir,
        log_every=50,
    )
    print(f"throughput: {result.examples_per_s:.1f} examples/s")
    return result.state


@model.predictor(jit=False)
def predictor(state: TrainState, features: Dict[str, np.ndarray]) -> np.ndarray:
    inputs = [torch.as_tensor(np.asarray(features[k]), device=state.device) for k in SIGNATURE]
    with torch.no_grad():
        return state.model(*inputs, deterministic=True).argmax(dim=-1).cpu().numpy()


@model.evaluator(jit=False)
def evaluator(state: TrainState, features: Dict[str, np.ndarray], targets: Dict[str, np.ndarray]) -> float:
    batch = {k: torch.as_tensor(np.asarray(v), device=state.device) for k, v in {**features, **targets}.items()}
    return float(make_classifier_eval_step(input_signature=SIGNATURE)(state, batch)["accuracy"])


if __name__ == "__main__":
    state, metrics = model.train(trainer_kwargs={"num_epochs": 1, "batch_size": 32})
    print(f"metrics: {metrics}")
    model.save("bert_model.ckpt")
