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

Tensor parallelism (:func:`param_shardings`, ``bert.py:224-261``): under a
mesh with a ``tensor`` axis of N ranks, :func:`tensor_parallel` gives each
rank a copy of the model holding its Megatron shard of every weight, as
``models/gpt.py`` does for the decoder: ``query``, ``key``, ``value`` and
``intermediate`` column-parallel (this rank's heads, its part of the MLP),
the attention and MLP ``output`` row-parallel (one all-reduce each, the bias
added by rank 0 alone inside its product), and the three embedding tables
split over their rows (a masked lookup and an all-reduce). Each rank
attends over ``num_heads / N`` heads, so K1 (``kv_lens``) and K2/K3 run at
that many heads; the pooler and the classifier are whole on every rank.
Where N does not divide the heads, q, k and v stay whole and only the
attention output's input rows split. In a forward that autograd records
the collectives are the differentiable pair of
:class:`~unionml_tpu_torch.models._layers.TensorParallel`, so the copy
trains (``fit(mesh=..., param_spec=...)``).

Sequence parallelism (``attention_impl="ring"`` or ``"ulysses"`` with
``sp_mesh``, ``bert.py:92-99``): the model takes THIS rank's chunk of every
row (ids, mask and token types; positions ``[r * L, (r + 1) * L)`` for
sequence rank r), offsets its position embeddings by ``r * L``, and
attends through :func:`~unionml_tpu_torch.parallel.sp_attention` with
per-row ``kv_lens``: the whole row's mask summed (each chunk's sum, summed
over the ``sequence`` axis), exact for right padding. ``[CLS]`` lies on the
first sequence rank; the pooler reads it on every rank through
:meth:`~unionml_tpu_torch.models._layers.SequenceParallel.broadcast_first`,
whose backward sums the ranks' gradients onto the first, so each rank's
classifier logits are the whole row's. On a mesh with a ``tensor`` axis
beside ``sequence`` the tensor-parallel copy keeps the config: each rank
computes its chunk at its ``num_heads / N`` heads (the ring as it is,
Ulysses exchanging by the model's heads, :func:`~unionml_tpu_torch.parallel.ulysses_attention`).
"""

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models._layers import (
    SEQUENCE_IMPLS,
    SequenceParallel,
    TensorParallel,
    _dense,
    _dropout,
    _layer_norm,
    one_hot_embedding,
    recomputed,
)
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
    "param_shardings",
    "tensor_parallel",
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
    #: "auto" (the kernels on CUDA), "kernel" or "reference"; "ring" or
    #: "ulysses" split every row's sequence over ``sp_mesh``
    attention_impl: str = "auto"
    #: the mesh whose "sequence" axis ring/ulysses attention splits rows over
    sp_mesh: Any = None
    remat: bool = False
    gelu_approximate: bool = False

    def __post_init__(self) -> None:
        if self.attention_impl not in _IMPLS + SEQUENCE_IMPLS:
            raise ValueError(f"attention_impl must be one of {_IMPLS + SEQUENCE_IMPLS}, got {self.attention_impl!r}")
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
        #: this rank's share of a tensor-parallel model (:func:`tensor_parallel`)
        self.tp: Optional[TensorParallel] = None

    def forward(self, hidden, kv_lens, dense_mask, generator):
        cfg, tp = self.config, self.tp
        batch, seq, _ = hidden.shape
        n_heads = cfg.num_heads if tp is None else tp.heads

        def split(x):
            return x.reshape(batch, seq, n_heads, cfg.head_dim).transpose(1, 2).contiguous()

        entered = hidden if tp is None else tp.enter(hidden)
        q, k, v = (split(_dense(m, entered, cfg.dtype)) for m in (self.query, self.key, self.value))
        if cfg.attention_impl in SEQUENCE_IMPLS:
            from unionml_tpu_torch.parallel import sp_attention

            context = sp_attention(q, k, v, cfg.sp_mesh, cfg.attention_impl, kv_lens=kv_lens,
                                   tensor_axis="tensor" if tp is not None and tp.split_heads else None)
        else:
            context = attention(q, k, v, mask=dense_mask, kv_lens=kv_lens, impl=cfg.attention_impl)
        context = context.transpose(1, 2).reshape(batch, seq, n_heads * cfg.head_dim)
        if tp is None:
            out = _dense(self.output, context, cfg.dtype)
        else:
            if not tp.split_heads:
                # whole heads on every rank: the output's input rows split all the same
                part = cfg.hidden_size // tp.size
                context = context[..., tp.index * part:(tp.index + 1) * part]
            out = tp.reduce(_dense(self.output, context, cfg.dtype, bias=tp.index == 0))
        out = _dropout(out, cfg.hidden_dropout, generator)
        return _layer_norm(self.output_norm, out + hidden, cfg.dtype)


class BertMlp(nn.Module):
    def __init__(self, config: BertConfig, device: torch.device) -> None:
        super().__init__()
        d, kw = config.hidden_size, dict(device=device, dtype=torch.float32)
        self.config = config
        self.intermediate = nn.Linear(d, config.intermediate_size, **kw)
        self.output = nn.Linear(config.intermediate_size, d, **kw)
        self.output_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)
        #: this rank's share of a tensor-parallel model (:func:`tensor_parallel`)
        self.tp: Optional[TensorParallel] = None

    def forward(self, hidden, generator):
        cfg, tp = self.config, self.tp
        up = _dense(self.intermediate, hidden if tp is None else tp.enter(hidden), cfg.dtype)
        up = F.gelu(up, approximate="tanh" if cfg.gelu_approximate else "none")
        if tp is None:
            down = _dense(self.output, up, cfg.dtype)
        else:
            down = tp.reduce(_dense(self.output, up, cfg.dtype, bias=tp.index == 0))
        down = _dropout(down, cfg.hidden_dropout, generator)
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
                hidden = recomputed(layer, generator, hidden, kv_lens, dense_mask, generator)
            else:
                hidden = layer(hidden, kv_lens, dense_mask, generator)
        return hidden


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
        #: this rank's share of a tensor-parallel model (:func:`tensor_parallel`)
        self.tp: Optional[TensorParallel] = None

    def _lookup(self, ids: torch.Tensor, table: nn.Embedding, embed=F.embedding) -> torch.Tensor:
        return embed(ids, table.weight) if self.tp is None else self.tp.lookup(ids, table.weight, embed)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, generator=None):
        cfg = self.config
        seq = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        sp = SequenceParallel.of(cfg.sp_mesh, "sequence") if cfg.attention_impl in SEQUENCE_IMPLS else None
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
                if sp is not None and sp.group is not None:
                    # this rank holds a chunk of each row: the whole row's length is the chunks' sum
                    dist.all_reduce(kv_lens, group=sp.group)

        positions = torch.arange(seq, device=input_ids.device)
        if sp is not None:
            positions = positions + sp.index * seq
        word = self._lookup(input_ids, self.word_embeddings).to(cfg.dtype)
        position = self._lookup(positions, self.position_embeddings).to(cfg.dtype)[None]
        # the two-row table as a one-hot product: its gradient sums in a fixed order on the card
        token_type = self._lookup(token_type_ids, self.token_type_embeddings, one_hot_embedding).to(cfg.dtype)
        hidden = _layer_norm(self.embeddings_norm, word + position + token_type, cfg.dtype)
        hidden = _dropout(hidden, cfg.hidden_dropout, generator)
        hidden = self.encoder(hidden, kv_lens, dense_mask, generator)
        first = hidden[:, 0] if sp is None else sp.broadcast_first(hidden[:, 0])  # [CLS] lies on the first chunk
        pooled = torch.tanh(_dense(self.pooler, first, cfg.dtype))
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


def param_shardings(params: Any, mesh_axis_names: Tuple[str, ...] = ("data", "tensor")) -> Any:
    """:class:`~unionml_tpu_torch.parallel.mesh.Spec` tree for the port's BERT
    parameter tree (``dict(model.named_parameters())``), the Megatron-style
    split of ``bert.py:224-261``:

    - ``query``/``key``/``value`` and ``intermediate``: the OUTPUT dim (heads) over ``tensor``
    - attention and MLP ``output``: the INPUT dim over ``tensor``
    - the embedding tables: their rows (vocabulary, positions, types) over ``tensor``
    - other matrices (pooler, classifier) over ``fsdp`` when present;
      everything else (norms, biases) replicated

    The entries are JAX's with each ``nn.Linear`` weight's two dimensions
    flipped (``(out, in)`` against flax's ``(in, out)``). FSDP2 lays out the
    ``fsdp`` entries (``models/_sharding.py``)."""
    from unionml_tpu_torch.models._sharding import shard_by_rules
    from unionml_tpu_torch.parallel.mesh import FSDP_AXIS, TENSOR_AXIS, Spec

    tensor = TENSOR_AXIS if TENSOR_AXIS in mesh_axis_names else None
    fsdp = FSDP_AXIS if FSDP_AXIS in mesh_axis_names else None

    def spec_for(path: Tuple[str, ...], leaf) -> Spec:
        path_str = "/".join(path)
        if len(leaf.shape) < 2:
            return Spec()
        if "embeddings" in path_str:
            return Spec(tensor, None)
        if any(n in path_str for n in ("query", "key", "value", "intermediate")):
            return Spec(tensor, fsdp)
        if "attention/output" in path_str or "mlp/output" in path_str:
            return Spec(fsdp, tensor)
        return Spec(None, fsdp)

    return shard_by_rules(params, spec_for)


def tensor_parallel(model: BertForSequenceClassification, mesh: Any, trainable: bool = False
                    ) -> Tuple[BertForSequenceClassification, Dict[str, Any]]:
    """``(this rank's model, its weight tree)``: a copy of ``model`` (which
    every rank holds whole, from the same seed or checkpoint, and which is
    left untouched) whose weights are this rank's shards under
    :func:`param_shardings`, and whose forward runs the tensor axis's
    collectives (see the module docstring). A mesh without a ``tensor`` axis
    gives ``model`` itself. Where the axis does not divide the heads,
    ``query``, ``key`` and ``value`` stay whole on every rank. Raises JAX's
    ``ValueError`` where the axis does not divide a sharded dimension (an
    embedding table's rows, the hidden or intermediate width).
    ``trainable=True`` gives shards that take gradients (the train step's
    layout).

    The copy's ``tp_partial`` names the parameters whose gradients are each
    rank's part of a sum over the tensor axis: the row-parallel biases, which
    rank 0 alone adds, and the whole ``query``/``key``/``value`` under an axis
    that does not divide the heads."""
    from unionml_tpu_torch.models._sharding import shard_model, weight_tree
    from unionml_tpu_torch.parallel.mesh import TENSOR_AXIS, Spec, axis_index, axis_names, axis_size

    cfg = model.config
    names = axis_names(mesh)
    tree = weight_tree(model)
    if TENSOR_AXIS not in names:
        return model, tree
    n = axis_size(mesh, TENSOR_AXIS)
    split_heads = cfg.num_heads % n == 0
    specs = param_shardings(tree, names)
    for name in specs:
        qkv = any(f".attention.{p}." in name for p in ("query", "key", "value"))
        if qkv and not split_heads:
            specs[name] = Spec()
        elif (qkv or ".mlp.intermediate." in name) and name.endswith("bias"):
            # a rank computes its columns' product whole: the column-parallel
            # biases split with their outputs (JAX replicates them and XLA slices)
            specs[name] = Spec(TENSOR_AXIS)
    tp = TensorParallel(group=mesh.get_group(TENSOR_AXIS), size=n, index=axis_index(mesh, TENSOR_AXIS),
                        heads=cfg.num_heads // n if split_heads else cfg.num_heads, split_heads=split_heads)
    partial = {name for name in tree if name.endswith((".attention.output.bias", ".mlp.output.bias"))
               or (not split_heads and any(f".attention.{p}." in name for p in ("query", "key", "value")))}
    return shard_model(model, mesh, specs, tp, (BertModel, BertSelfAttention, BertMlp), partial, trainable)


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
