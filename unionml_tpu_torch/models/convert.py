"""Carry GPT weights across: the JAX parameter tree <-> the port's state dict.

The JAX package keeps flax parameters as ``{"params": {"wte": {"embedding"},
"wpe": {"embedding"}, "layer_i": {"attn_norm": {"scale", "bias"}, "qkv":
{"kernel", "bias"}, "attn_out", "mlp_norm", "mlp_up", "mlp_down"},
"final_norm"}}``, with Dense kernels laid out ``(in, out)``. PyTorch's
``nn.Linear`` stores ``(out, in)``, so kernels transpose on the way across;
LayerNorm ``scale`` becomes ``weight`` and Embed ``embedding`` becomes
``weight``.
"""

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from unionml_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel

__all__ = ["init_gpt", "params_from_jax", "random_params"]

_DENSE = ("qkv", "attn_out", "mlp_up", "mlp_down")
_NORMS = ("attn_norm", "mlp_norm")


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX GPT parameter tree (nested dicts of numpy arrays, as
    ``jax.device_get(init_params(cfg))`` gives it, with or without the
    ``"params"`` wrapper) onto a :class:`GPTLMHeadModel` state dict."""
    tree = params.get("params", params)

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    state = {
        "wte.weight": t(tree["wte"]["embedding"]),
        "wpe.weight": t(tree["wpe"]["embedding"]),
        "final_norm.weight": t(tree["final_norm"]["scale"]),
        "final_norm.bias": t(tree["final_norm"]["bias"]),
    }
    layer = 0
    while f"layer_{layer}" in tree:
        src = tree[f"layer_{layer}"]
        for name in _NORMS:
            state[f"layers.{layer}.{name}.weight"] = t(src[name]["scale"])
            state[f"layers.{layer}.{name}.bias"] = t(src[name]["bias"])
        for name in _DENSE:
            state[f"layers.{layer}.{name}.weight"] = t(src[name]["kernel"]).t().contiguous()
            state[f"layers.{layer}.{name}.bias"] = t(src[name]["bias"])
        layer += 1
    return state


def random_params(config: GPTConfig, seed: int = 0, std: float = 0.02) -> Dict[str, Any]:
    """A JAX-layout parameter tree of seeded random weights (numpy float32):
    normal(0, ``std``) embeddings and Dense kernels (the GPT-2 recipe), zero
    biases, unit LayerNorm scales. The same tree feeds both packages."""
    rng = np.random.default_rng(seed)
    d = config.hidden_size

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def norm():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out), "bias": np.zeros(n_out, np.float32)}

    tree: Dict[str, Any] = {
        "wte": {"embedding": normal(config.vocab_size, d)},
        "wpe": {"embedding": normal(config.max_position_embeddings, d)},
        "final_norm": norm(),
    }
    for i in range(config.num_layers):
        tree[f"layer_{i}"] = {
            "attn_norm": norm(),
            "qkv": dense(d, 3 * d),
            "attn_out": dense(d, d),
            "mlp_norm": norm(),
            "mlp_up": dense(d, 4 * d),
            "mlp_down": dense(4 * d, d),
        }
    return {"params": tree}


def init_gpt(config: GPTConfig, seed: int = 0, device="cuda", std: float = 0.02,
             params: Optional[Mapping[str, Any]] = None) -> GPTLMHeadModel:
    """A :class:`GPTLMHeadModel` on ``device`` with the weights of ``params``
    (a JAX-layout tree), or of :func:`random_params` from ``seed`` — no
    checkpoint and no JAX needed."""
    model = GPTLMHeadModel(config, device=device)
    tree = params if params is not None else random_params(config, seed, std)
    model.load_state_dict(params_from_jax(tree))
    return model
