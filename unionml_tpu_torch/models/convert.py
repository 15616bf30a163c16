"""Carry GPT and BERT weights across: the JAX parameter tree <-> the port's state dict.

The JAX package keeps flax parameters as ``{"params": {"wte": {"embedding"},
"wpe": {"embedding"}, "layer_i": {"attn_norm": {"scale", "bias"}, "qkv":
{"kernel", "bias"}, "attn_out", "mlp_norm", "mlp_up", "mlp_down"},
"final_norm"}}``, with Dense kernels laid out ``(in, out)``. PyTorch's
``nn.Linear`` stores ``(out, in)``, so kernels transpose on the way across;
LayerNorm ``scale`` becomes ``weight`` and Embed ``embedding`` becomes
``weight``. A sparse block carries ``"moe_mlp": {"router": {"kernel",
"bias"}, "w_in", "w_out"}`` in place of ``mlp_up``/``mlp_down``: the router
kernel ``(d, E)`` transposes into its ``nn.Linear``, the stacked expert
weights keep their layout and land in the parameters' dtype
(``config.dtype``: a bf16 tree converts exactly). BERT's tree (``{"bert":
{"word_embeddings", ..., "encoder": {"layer_i": {"attention": {...}, "mlp":
{...}}}, "pooler"}, "classifier"}``)
maps the same way onto :class:`~unionml_tpu_torch.models.bert.
BertForSequenceClassification`; :func:`gpt_grads_to_jax` and
:func:`bert_grads_to_jax` map the port's named gradients back onto the trees,
so the two packages' gradients compare leaf by leaf. Both models keep float32
parameters, so weights load without rounding.
"""

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from unionml_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel

__all__ = [
    "bert_grads_to_jax",
    "bert_params_from_jax",
    "bert_random_params",
    "cnn_params_from_jax",
    "mlp_params_from_jax",
    "gpt_grads_to_jax",
    "init_gpt",
    "params_from_jax",
    "random_params",
]

_ATTN = ("qkv", "attn_out")
_MLP = ("mlp_up", "mlp_down")
_NORMS = ("attn_norm", "mlp_norm")
_EXPERTS = ("w_in", "w_out")


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
        dense = {name: src[name] for name in _ATTN + (() if "moe_mlp" in src else _MLP)}
        if "moe_mlp" in src:
            dense["moe_mlp.router"] = src["moe_mlp"]["router"]
            for name in _EXPERTS:
                state[f"layers.{layer}.moe_mlp.{name}"] = t(src["moe_mlp"][name])
        for name, node in dense.items():
            state[f"layers.{layer}.{name}.weight"] = t(node["kernel"]).t().contiguous()
            state[f"layers.{layer}.{name}.bias"] = t(node["bias"])
        layer += 1
    return state


def _np32(value) -> np.ndarray:
    if torch.is_tensor(value):
        value = value.detach().float().cpu().numpy()
    return np.asarray(value, dtype=np.float32)


def _dense_grads(named_grads: Mapping[str, Any], module: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np32(named_grads[module + ".weight"]).T.copy(), "bias": _np32(named_grads[module + ".bias"])}


def gpt_grads_to_jax(named_grads: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax` for gradients: port parameter
    names to tensors (e.g. ``zip(state.names, grads)``) become the JAX GPT
    tree layout (without the ``"params"`` wrapper) of numpy float32 arrays,
    dense kernels transposed back to ``(in, out)``."""
    tree: Dict[str, Any] = {
        "wte": {"embedding": _np32(named_grads["wte.weight"])},
        "wpe": {"embedding": _np32(named_grads["wpe.weight"])},
        "final_norm": {"scale": _np32(named_grads["final_norm.weight"]),
                       "bias": _np32(named_grads["final_norm.bias"])},
    }
    layer = 0
    while f"layers.{layer}.qkv.weight" in named_grads:
        node = tree[f"layer_{layer}"] = {}
        for name in _NORMS:
            node[name] = {"scale": _np32(named_grads[f"layers.{layer}.{name}.weight"]),
                          "bias": _np32(named_grads[f"layers.{layer}.{name}.bias"])}
        prefix = f"layers.{layer}."
        sparse = prefix + "moe_mlp.w_in" in named_grads
        for name in _ATTN + (() if sparse else _MLP):
            node[name] = _dense_grads(named_grads, prefix + name)
        if sparse:
            node["moe_mlp"] = {"router": _dense_grads(named_grads, prefix + "moe_mlp.router"),
                               **{w: _np32(named_grads[prefix + "moe_mlp." + w]) for w in _EXPERTS}}
        layer += 1
    return tree


def random_params(config: GPTConfig, seed: int = 0, std: float = 0.02) -> Dict[str, Any]:
    """A JAX-layout parameter tree of seeded random weights (numpy float32):
    normal(0, ``std``) embeddings and Dense kernels (the GPT-2 recipe), zero
    biases, unit LayerNorm scales; a sparse block's router kernel and
    stacked expert weights normal(0, ``std``) too. The same tree feeds both
    packages."""
    rng = np.random.default_rng(seed)
    d, experts = config.hidden_size, config.num_experts

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
        layer = tree[f"layer_{i}"] = {"attn_norm": norm(), "qkv": dense(d, 3 * d), "attn_out": dense(d, d),
                                      "mlp_norm": norm()}
        if config.moe_every > 0 and (i + 1) % config.moe_every == 0:
            layer["moe_mlp"] = {"router": dense(d, experts), "w_in": normal(experts, d, 4 * d),
                                "w_out": normal(experts, 4 * d, d)}
        else:
            layer.update(mlp_up=dense(d, 4 * d), mlp_down=dense(4 * d, d))
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


# ------------------------------------------------------------------ BERT

#: (port module name, JAX tree path, kind) of one BERT layer's leaves
_BERT_LAYER = [
    *((f"attention.{n}", ("attention", n), "dense") for n in ("query", "key", "value", "output")),
    ("attention.output_norm", ("attention", "output_norm"), "norm"),
    ("mlp.intermediate", ("mlp", "intermediate"), "dense"),
    ("mlp.output", ("mlp", "output"), "dense"),
    ("mlp.output_norm", ("mlp", "output_norm"), "norm"),
]
#: port parameter suffix and JAX leaf name of each kind (a dense kernel transposes)
_BERT_LEAVES = {
    "dense": (("weight", "kernel"), ("bias", "bias")),
    "norm": (("weight", "scale"), ("bias", "bias")),
    "embed": (("weight", "embedding"),),
}


def _bert_modules(num_layers: int) -> List[Tuple[str, Tuple[str, ...], str]]:
    """Every (port module, JAX path, kind) of a BERT classifier."""
    modules = [
        (f"bert.{n}", ("bert", n), "embed")
        for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")
    ]
    modules.append(("bert.embeddings_norm", ("bert", "embeddings_norm"), "norm"))
    for i in range(num_layers):
        modules += [(f"bert.encoder.layers.{i}.{name}", ("bert", "encoder", f"layer_{i}", *path), kind)
                    for name, path, kind in _BERT_LAYER]
    modules += [("bert.pooler", ("bert", "pooler"), "dense"), ("classifier", ("classifier",), "dense")]
    return modules


def bert_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX BERT classifier parameter tree (nested dicts of numpy
    arrays, with or without the ``"params"`` wrapper) onto a
    ``BertForSequenceClassification`` state dict (float32)."""
    tree = params.get("params", params)
    num_layers = sum(1 for name in tree["bert"]["encoder"] if name.startswith("layer_"))
    state = {}
    for module, path, kind in _bert_modules(num_layers):
        node = tree
        for key in path:
            node = node[key]
        for suffix, leaf in _BERT_LEAVES[kind]:
            value = torch.from_numpy(np.array(node[leaf], dtype=np.float32))
            state[f"{module}.{suffix}"] = value.t().contiguous() if leaf == "kernel" else value
    return state


def bert_grads_to_jax(named_grads: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`bert_params_from_jax` for gradients: a mapping of
    port parameter names to tensors (e.g. ``zip(names, torch.autograd.grad(...))``)
    becomes the JAX tree layout (without the ``"params"`` wrapper) of numpy
    float32 arrays, dense kernels transposed back to ``(in, out)``."""
    num_layers = len({name.split(".")[3] for name in named_grads if name.startswith("bert.encoder.layers.")})
    tree: Dict[str, Any] = {}
    for module, path, kind in _bert_modules(num_layers):
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        for suffix, leaf in _BERT_LEAVES[kind]:
            value = _np32(named_grads[f"{module}.{suffix}"])
            node[leaf] = value.T.copy() if leaf == "kernel" else value
    return tree


def bert_random_params(config: Any, seed: int = 0, std: float = 0.02) -> Dict[str, Any]:
    """A JAX-layout BERT classifier tree of seeded random weights (numpy
    float32): normal(0, ``std``) embeddings and Dense kernels (BERT's
    initializer range), zero biases, unit LayerNorm scales. The same tree
    feeds both packages."""
    rng = np.random.default_rng(seed)
    d, inter = config.hidden_size, config.intermediate_size

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def norm():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out), "bias": np.zeros(n_out, np.float32)}

    bert: Dict[str, Any] = {
        "word_embeddings": {"embedding": normal(config.vocab_size, d)},
        "position_embeddings": {"embedding": normal(config.max_position_embeddings, d)},
        "token_type_embeddings": {"embedding": normal(config.type_vocab_size, d)},
        "embeddings_norm": norm(),
        "encoder": {},
        "pooler": dense(d, d),
    }
    for i in range(config.num_layers):
        bert["encoder"][f"layer_{i}"] = {
            "attention": {
                "query": dense(d, d), "key": dense(d, d), "value": dense(d, d), "output": dense(d, d),
                "output_norm": norm(),
            },
            "mlp": {"intermediate": dense(d, inter), "output": dense(inter, d), "output_norm": norm()},
        }
    return {"params": {"bert": bert, "classifier": dense(d, config.num_labels)}}


def _t32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def mlp_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX ``MLPClassifier`` tree (``dense_i``, ``head``; with or
    without the ``"params"`` wrapper) onto the port's ``MLPClassifier``
    state dict (``hidden.i``, ``head``), kernels transposed."""
    tree = params.get("params", params)
    state: Dict[str, torch.Tensor] = {}
    names = [f"dense_{i}" for i in range(sum(1 for k in tree if k.startswith("dense_")))] + ["head"]
    for name in names:
        prefix = "head" if name == "head" else f"hidden.{name.split('_')[1]}"
        state[f"{prefix}.weight"] = _t32(tree[name]["kernel"]).t().contiguous()
        state[f"{prefix}.bias"] = _t32(tree[name]["bias"])
    return state


def cnn_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX ``CNNClassifier`` tree onto the port's state dict: conv
    kernels ``(kh, kw, in, out)`` become ``(out, in, kh, kw)``, dense kernels
    transpose."""
    tree = params.get("params", params)
    state: Dict[str, torch.Tensor] = {}
    for name in ("conv_0", "conv_1"):
        state[f"{name}.weight"] = _t32(tree[name]["kernel"]).permute(3, 2, 0, 1).contiguous()
        state[f"{name}.bias"] = _t32(tree[name]["bias"])
    for name in ("dense", "head"):
        state[f"{name}.weight"] = _t32(tree[name]["kernel"]).t().contiguous()
        state[f"{name}.bias"] = _t32(tree[name]["bias"])
    return state
