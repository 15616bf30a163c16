"""BERT encoder family (PyTorch): the model of the BERT-base fine-tune path.

Port of ``unionml_tpu/models/bert.py``: post-LN encoder layers, exact-erf
GELU (tanh with ``gelu_approximate``), a tanh pooler over ``[CLS]`` and a
float32 classification head, optional activation recompute (``remat``,
through ``torch.utils.checkpoint``).

Mixed precision as flax does it: parameters stay float32 and each layer
casts its weights and input to ``config.dtype`` in ``forward``, as
``nn.Dense(dtype=bf16)`` and ``nn.Embed(dtype=bf16)`` do; LayerNorm takes its
statistics in float32 and returns ``config.dtype``. ``torch.autocast`` is not
used: its casting rules differ. Gradients land on the float32 parameters.

The attention mask follows ``bert.py:167-184``: when attention resolves to the
kernel (``"auto"`` on CUDA, or ``"kernel"``), ``attention_mask`` becomes
``kv_lens = mask.sum(-1)``, exact for right padding, and attention runs K1
forward and K2/K3 backward; when it resolves to ``"reference"`` (``"auto"``
on the CPU) the full dense mask goes to the plain version.

Dropout draws its masks from an explicit ``torch.Generator`` passed to
``forward`` (the train step seeds one per step, as the JAX step folds the
step into its dropout key), so the kernel and plain paths drop the same
units for the same generator.
"""

import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models._layers import _dense, _dropout, _layer_norm
from unionml_tpu_torch.models.convert import bert_params_from_jax, bert_random_params
from unionml_tpu_torch.ops.attention import attention

__all__ = [
    "BertConfig",
    "BertEncoder",
    "BertForSequenceClassification",
    "BertLayer",
    "BertMlp",
    "BertModel",
    "BertSelfAttention",
    "import_hf_weights",
    "init_bert",
]

Device = Union[str, torch.device, None]

_IMPLS = ("auto", "kernel", "reference")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT-base by default (``bert.py:31-75``)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    #: kept for parity with the JAX config, whose layers apply no attention dropout either
    attention_dropout: float = 0.1
    num_labels: int = 2
    dtype: torch.dtype = torch.bfloat16
    #: "auto" (the kernels on CUDA), "kernel" or "reference"
    attention_impl: str = "auto"
    #: the JAX package's sequence-parallel mesh; not ported yet
    sp_mesh: Any = None
    remat: bool = False
    gelu_approximate: bool = False

    def __post_init__(self) -> None:
        if self.attention_impl in ("ring", "ulysses") or self.sp_mesh is not None:
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r} / sp_mesh: sequence-parallel attention is not "
                "ported yet (ROADMAP: M12)"
            )
        if self.attention_impl not in _IMPLS:
            raise ValueError(f"attention_impl must be one of {_IMPLS}, got {self.attention_impl!r}")
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must be divisible by num_heads")

    @classmethod
    def base(cls, **overrides) -> "BertConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "BertConfig":
        """A 2-layer config for tests."""
        defaults = dict(
            vocab_size=1024,
            hidden_size=128,
            num_layers=2,
            num_heads=4,
            intermediate_size=256,
            max_position_embeddings=128,
        )
        defaults.update(overrides)
        return cls(**defaults)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, device: torch.device) -> None:
        super().__init__()
        d, kw = config.hidden_size, dict(device=device, dtype=torch.float32)
        self.config = config
        self.query = nn.Linear(d, d, **kw)
        self.key = nn.Linear(d, d, **kw)
        self.value = nn.Linear(d, d, **kw)
        self.output = nn.Linear(d, d, **kw)
        self.output_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)

    def forward(self, hidden, kv_lens, dense_mask, generator):
        cfg = self.config
        batch, seq, _ = hidden.shape

        def split(x):
            return x.reshape(batch, seq, cfg.num_heads, cfg.head_dim).transpose(1, 2).contiguous()

        q, k, v = (split(_dense(m, hidden, cfg.dtype)) for m in (self.query, self.key, self.value))
        context = attention(q, k, v, mask=dense_mask, kv_lens=kv_lens, impl=cfg.attention_impl)
        context = context.transpose(1, 2).reshape(batch, seq, cfg.hidden_size)
        out = _dropout(_dense(self.output, context, cfg.dtype), cfg.hidden_dropout, generator)
        return _layer_norm(self.output_norm, out + hidden, cfg.dtype)


class BertMlp(nn.Module):
    def __init__(self, config: BertConfig, device: torch.device) -> None:
        super().__init__()
        d, kw = config.hidden_size, dict(device=device, dtype=torch.float32)
        self.config = config
        self.intermediate = nn.Linear(d, config.intermediate_size, **kw)
        self.output = nn.Linear(config.intermediate_size, d, **kw)
        self.output_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)

    def forward(self, hidden, generator):
        cfg = self.config
        up = _dense(self.intermediate, hidden, cfg.dtype)
        up = F.gelu(up, approximate="tanh" if cfg.gelu_approximate else "none")
        down = _dropout(_dense(self.output, up, cfg.dtype), cfg.hidden_dropout, generator)
        return _layer_norm(self.output_norm, down + hidden, cfg.dtype)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, device: torch.device) -> None:
        super().__init__()
        self.attention = BertSelfAttention(config, device)
        self.mlp = BertMlp(config, device)

    def forward(self, hidden, kv_lens, dense_mask, generator):
        return self.mlp(self.attention(hidden, kv_lens, dense_mask, generator), generator)


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig, device: torch.device) -> None:
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(BertLayer(config, device) for _ in range(config.num_layers))

    def forward(self, hidden, kv_lens, dense_mask, generator):
        for layer in self.layers:
            if self.config.remat and torch.is_grad_enabled():
                hidden = _recomputed(layer, hidden, kv_lens, dense_mask, generator)
            else:
                hidden = layer(hidden, kv_lens, dense_mask, generator)
        return hidden


def _recomputed(layer, hidden, kv_lens, dense_mask, generator):
    """``layer`` under ``torch.utils.checkpoint``. The recompute in the
    backward pass rewinds the dropout generator to its state before the layer,
    so it draws the same masks as the forward did."""
    state = generator.get_state() if generator is not None else None

    def run(h):
        if generator is not None:
            generator.set_state(state)
        return layer(h, kv_lens, dense_mask, generator)

    return checkpoint(run, hidden, use_reentrant=False)


class BertModel(nn.Module):
    """Embeddings + encoder + pooler (tanh over [CLS])."""

    def __init__(self, config: BertConfig, device: torch.device) -> None:
        super().__init__()
        d, kw = config.hidden_size, dict(device=device, dtype=torch.float32)
        self.config = config
        self.word_embeddings = nn.Embedding(config.vocab_size, d, **kw)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, d, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, d, **kw)
        self.embeddings_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)
        self.encoder = BertEncoder(config, device)
        self.pooler = nn.Linear(d, d, **kw)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, generator=None):
        cfg = self.config
        seq = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        kv_lens = dense_mask = None
        if attention_mask is not None:
            impl = cfg.attention_impl
            if impl == "auto":
                impl = "kernel" if input_ids.is_cuda else "reference"
            if impl == "reference":
                dense_mask = attention_mask[:, None, None, :].bool()
            else:
                # the kernels take per-row valid lengths: exact for right padding
                kv_lens = attention_mask.sum(dim=-1, dtype=torch.int32)

        positions = torch.arange(seq, device=input_ids.device)
        word = F.embedding(input_ids, self.word_embeddings.weight).to(cfg.dtype)
        position = F.embedding(positions, self.position_embeddings.weight).to(cfg.dtype)[None]
        token_type = F.embedding(token_type_ids, self.token_type_embeddings.weight).to(cfg.dtype)
        hidden = _layer_norm(self.embeddings_norm, word + position + token_type, cfg.dtype)
        hidden = _dropout(hidden, cfg.hidden_dropout, generator)
        hidden = self.encoder(hidden, kv_lens, dense_mask, generator)
        pooled = torch.tanh(_dense(self.pooler, hidden[:, 0], cfg.dtype))
        return hidden, pooled


class BertForSequenceClassification(nn.Module):
    """BERT + classification head — the fine-tune target model.

    :param device: where the parameters live; ``"cuda"`` (default) raises
        when no CUDA device is available — pass ``"cpu"`` explicitly for the
        plain PyTorch path.
    """

    def __init__(self, config: BertConfig, device: Device = "cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, device)
        self.classifier = nn.Linear(config.hidden_size, config.num_labels, device=device, dtype=torch.float32)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """float32 logits ``(batch, num_labels)``. With ``deterministic=False``
        dropout is on and draws its masks from ``generator``."""
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("deterministic=False draws dropout masks from `generator`; pass one")
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids, generator)
        pooled = _dropout(pooled, self.config.hidden_dropout, generator)
        # classification logits in f32 (bert.py:218-219)
        return F.linear(pooled.float(), self.classifier.weight, self.classifier.bias)


def init_bert(config: BertConfig, seed: int = 0, device: Device = "cuda", std: float = 0.02,
              params: Optional[Mapping[str, Any]] = None) -> BertForSequenceClassification:
    """A :class:`BertForSequenceClassification` on ``device`` with the weights
    of ``params`` (a JAX-layout tree), or of
    :func:`~unionml_tpu_torch.models.convert.bert_random_params` from ``seed``
    — no checkpoint and no JAX needed."""
    model = BertForSequenceClassification(config, device=device)
    tree = params if params is not None else bert_random_params(config, seed, std)
    model.load_state_dict(bert_params_from_jax(tree))
    return model


def import_hf_weights(hf_state_dict: Mapping[str, Any], config: BertConfig) -> Dict[str, torch.Tensor]:
    """Map a HuggingFace BERT state dict (torch tensors or numpy arrays) onto a
    :class:`BertForSequenceClassification` state dict (``bert.py:266-320``).

    Accepts ``BertModel`` or ``BertForSequenceClassification`` state dicts.
    Without a ``classifier`` the head is drawn from ``normal(0, 0.02)`` with
    numpy seed 0 and zero bias, as the JAX package does.
    """

    def t(name: str) -> np.ndarray:
        value = hf_state_dict[name]
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        return np.asarray(value, dtype=np.float32)

    def linear(prefix: str) -> Dict[str, np.ndarray]:
        return {"kernel": t(f"{prefix}.weight").T, "bias": t(f"{prefix}.bias")}

    def norm(prefix: str) -> Dict[str, np.ndarray]:
        return {"scale": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias")}

    prefix = "bert." if any(key.startswith("bert.") for key in hf_state_dict) else ""
    bert: Dict[str, Any] = {
        "word_embeddings": {"embedding": t(f"{prefix}embeddings.word_embeddings.weight")},
        "position_embeddings": {"embedding": t(f"{prefix}embeddings.position_embeddings.weight")},
        "token_type_embeddings": {"embedding": t(f"{prefix}embeddings.token_type_embeddings.weight")},
        "embeddings_norm": norm(f"{prefix}embeddings.LayerNorm"),
        "pooler": linear(f"{prefix}pooler.dense"),
        "encoder": {},
    }
    for i in range(config.num_layers):
        hf_layer = f"{prefix}encoder.layer.{i}"
        bert["encoder"][f"layer_{i}"] = {
            "attention": {
                "query": linear(f"{hf_layer}.attention.self.query"),
                "key": linear(f"{hf_layer}.attention.self.key"),
                "value": linear(f"{hf_layer}.attention.self.value"),
                "output": linear(f"{hf_layer}.attention.output.dense"),
                "output_norm": norm(f"{hf_layer}.attention.output.LayerNorm"),
            },
            "mlp": {
                "intermediate": linear(f"{hf_layer}.intermediate.dense"),
                "output": linear(f"{hf_layer}.output.dense"),
                "output_norm": norm(f"{hf_layer}.output.LayerNorm"),
            },
        }
    tree: Dict[str, Any] = {"bert": bert}
    if "classifier.weight" in hf_state_dict:
        tree["classifier"] = linear("classifier")
    else:
        rng = np.random.default_rng(0)
        tree["classifier"] = {
            "kernel": rng.normal(0, 0.02, (config.hidden_size, config.num_labels)).astype(np.float32),
            "bias": np.zeros((config.num_labels,), dtype=np.float32),
        }
    return bert_params_from_jax(tree)
