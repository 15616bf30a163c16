"""{{app_name}}: packed-sequence GPT training through the Dataset/Model API.

Real corpora are RAGGED: sentences, comments, log lines of wildly different
lengths. Fixed-shape rows waste most of the batch on padding; this scaffold
trains on packed rows instead: the reader yields ragged token sequences, the
trainer hands them to :func:`unionml_tpu_torch.models.training.fit_lm` with
``pack=True`` (first-fit packing, the native packer for corpora of 2048 or
more sequences; segment-confined attention through the flash kernels'
segment-id mode; per-segment positions), and the predictor generates with the
KV-cache decode path.

Runs on the card; set UNIONML_DEVICE=cpu to run the plain PyTorch path on the CPU.
"""

import os
from typing import Dict, List

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.models import GPTConfig, TrainState, create_train_state, generate, init_gpt, lm_loss
from unionml_tpu_torch.models.training import fit_lm

DEVICE = os.environ.get("UNIONML_DEVICE", "cuda")
SEQ_LEN = 64
VOCAB = 128  # ASCII char-level

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.1)

# head_dim 64: the attention kernels take head widths 64 and 128
config = GPTConfig.tiny(
    vocab_size=VOCAB, hidden_size=128, num_heads=2, max_position_embeddings=2 * SEQ_LEN, dropout=0.0
)


def encode(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("ascii", "replace"), dtype=np.uint8).astype(np.int32) % VOCAB


def decode(ids) -> str:
    return bytes(int(i) for i in ids).decode("ascii", "replace")


def init(learning_rate: float = 3e-3) -> TrainState:
    return create_train_state(init_gpt(config, seed=0, device=DEVICE), learning_rate=learning_rate,
                              max_grad_norm=1.0)


model = Model(name="{{app_name}}", init=init, dataset=dataset)


@model.dataset.reader
def reader(n: int = 256, seed: int = 0) -> Dict[str, list]:
    """Ragged corpus: sentences of varying length (swap in your own text file)."""
    sentences = [
        "the quick brown fox jumps over the lazy dog.",
        "pack short sequences together.",
        "segment ids confine attention.",
        "positions restart at each segment start.",
        "no cross-segment loss transitions.",
        "a longer sentence pays for itself because the packer places it first and fills the row tail with short ones.",
    ]
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(sentences), size=n)
    return {"sequences": [encode(sentences[i]).tolist() for i in picks]}


@model.trainer
def trainer(
    state: TrainState,
    features: Dict[str, list],
    targets: Dict[str, list],
    *,
    num_epochs: int = 20,
    batch_size: int = 16,
    pack: bool = True,
) -> TrainState:
    sequences: List[np.ndarray] = [np.asarray(s, dtype=np.int32) for s in features["sequences"]]
    result = fit_lm(
        state,
        sequences,
        seq_len=SEQ_LEN,
        batch_size=batch_size,
        pack=pack,
        num_epochs=num_epochs,
        log_every=50,
    )
    return result.state


@model.predictor(jit=False)
def predictor(state: TrainState, features: Dict[str, list]) -> np.ndarray:
    """Generate continuations: features carry 'prompt' strings or 'prompt_ids' arrays."""
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
def evaluator(state: TrainState, features: Dict[str, list], targets: Dict[str, list]) -> float:
    """Held-out LM loss on right-padded rows (evaluation needs no packing)."""
    sequences = [np.asarray(s, dtype=np.int32)[:SEQ_LEN] for s in features["sequences"]]
    ids = np.zeros((len(sequences), SEQ_LEN), dtype=np.int64)
    mask = np.zeros((len(sequences), SEQ_LEN), dtype=np.float32)
    for i, s in enumerate(sequences):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1.0
    ids_t, mask_t = torch.from_numpy(ids).to(state.device), torch.from_numpy(mask).to(state.device)
    with torch.no_grad():
        return float(lm_loss(state.model(ids_t, deterministic=True), ids_t, mask=mask_t))


if __name__ == "__main__":
    state, metrics = model.train(trainer_kwargs={"num_epochs": 30})
    print(f"metrics (lm loss per split): {metrics}")
    model.save("packed_gpt_model.ckpt")
    out = model.predict(features={"prompt": ["the quick "], "max_new_tokens": 24})
    print("generated:", repr(decode(out[0])))
