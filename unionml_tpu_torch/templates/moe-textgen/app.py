"""{{app_name}}: sparse (mixture-of-experts) GPT text generation.

The sparse-decoder story end to end on the PyTorch port: every second decoder
block routes tokens through experts (top-2, capacity-bounded in training,
dropless at inference), the trainer folds the router z-loss and load-balancing
loss into the LM objective (``make_lm_train_step(moe_aux=True)``), and the
predictor generates with the KV-cache decode path.

Runs on the card; set UNIONML_DEVICE=cpu to run the plain PyTorch path on the CPU.
"""

import os
from typing import Dict

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.models import GPTConfig, TrainState, create_train_state, generate, init_gpt, lm_loss
from unionml_tpu_torch.models.training import make_lm_train_step

DEVICE = os.environ.get("UNIONML_DEVICE", "cuda")
SEQ_LEN = 64
VOCAB = 128  # ASCII char-level

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.1)

config = GPTConfig.tiny(
    vocab_size=VOCAB,
    hidden_size=128,
    num_heads=2,  # head_dim 64: the attention kernels take head widths 64 and 128
    max_position_embeddings=2 * SEQ_LEN,
    dropout=0.0,
    moe_every=2,  # every 2nd block is sparse
    num_experts=4,
    moe_k=2,
    moe_capacity_factor=1.25,
)


def encode(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("ascii", "replace"), dtype=np.uint8).astype(np.int32) % VOCAB


def decode(ids) -> str:
    return bytes(int(i) for i in ids).decode("ascii", "replace")


def init(learning_rate: float = 3e-3) -> TrainState:
    return create_train_state(init_gpt(config, seed=0, device=DEVICE), learning_rate=learning_rate,
                              max_grad_norm=1.0)


model = Model(name="{{app_name}}", init=init, dataset=dataset)


@dataset.reader
def reader(n: int = 256, seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic corpus: repeated pangram text; swap in your own text file."""
    corpus = encode("the quick brown fox jumps over the lazy dog. " * 200)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(corpus) - SEQ_LEN - 1, size=n)
    ids = np.stack([corpus[s : s + SEQ_LEN] for s in starts])
    return {"input_ids": ids}


@model.trainer
def trainer(
    state: TrainState,
    features: Dict[str, np.ndarray],
    targets: Dict[str, np.ndarray],
    *,
    num_steps: int = 200,
    batch_size: int = 32,
) -> TrainState:
    ids_all = np.asarray(features["input_ids"])
    rng = np.random.default_rng(0)
    # capacity-bounded (training) dispatch; each step draws its router jitter
    # from a dropout generator of its own
    step = make_lm_train_step(moe_aux=True)
    for i in range(num_steps):
        idx = rng.integers(0, len(ids_all), size=batch_size)
        state, metrics = step(state, {"input_ids": torch.from_numpy(ids_all[idx]).to(state.device)})
        if (i + 1) % 50 == 0:
            print(f"step {i + 1}: lm+aux loss {float(metrics['loss']):.3f}")
    return state


@model.predictor(jit=False)
def predictor(state: TrainState, features: Dict[str, np.ndarray]) -> np.ndarray:
    """Generate continuations (dropless expert dispatch: no token ever dropped)."""
    if "prompt" in features:
        prompts = [encode(p) for p in features["prompt"]]
    elif "prompt_ids" in features:
        prompts = [np.asarray(p) for p in features["prompt_ids"]]
    else:
        raise ValueError("features must contain 'prompt' (strings) or 'prompt_ids' (token arrays)")
    if not prompts or any(len(p) == 0 for p in prompts):
        raise ValueError("every prompt must contain at least one token")

    max_new = min(int(features.get("max_new_tokens", 32)), config.max_position_embeddings - 1)
    keep = config.max_position_embeddings - max_new
    prompts = [p[-keep:] for p in prompts]

    # ragged prompts batch through ONE generate call: rows left-pad to the longest
    # prompt and prompt_mask keeps attention and positions exact per row
    width = max(len(p) for p in prompts)
    ragged = any(len(p) != width for p in prompts)
    batch_ids = np.zeros((len(prompts), width), dtype=np.int64)
    mask = np.zeros((len(prompts), width), dtype=np.int64)
    for row, p in enumerate(prompts):
        batch_ids[row, width - len(p) :] = p
        mask[row, width - len(p) :] = 1
    with torch.no_grad():
        out = generate(state.model, torch.from_numpy(batch_ids), max_new, max_len=width + max_new,
                       prompt_mask=torch.from_numpy(mask) if ragged else None)
    return out.cpu().numpy()


@model.evaluator(jit=False)
def evaluator(state: TrainState, features: Dict[str, np.ndarray], targets: Dict[str, np.ndarray]) -> float:
    ids = torch.from_numpy(np.asarray(features["input_ids"])).to(state.device)
    with torch.no_grad():
        return float(lm_loss(state.model(ids, deterministic=True), ids))


if __name__ == "__main__":
    state, metrics = model.train(trainer_kwargs={"num_steps": 300})
    print(f"metrics (lm loss per split): {metrics}")
    model.save("moe_gpt_model.ckpt")
    out = model.predict(features={"prompt": ["the quick brown "], "max_new_tokens": 24})
    print("generated:", repr(decode(out[0])))
