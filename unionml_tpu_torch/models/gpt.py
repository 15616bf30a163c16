"""GPT-style causal decoder (PyTorch) with dense and paged KV caches.

Port of ``unionml_tpu/models/gpt.py``: pre-LN decoder blocks, tanh-approximate
GELU, learned positions, a tied LM head with float32 logits, and the cache
paths the serving engine drives:

- dense-cache prefill at position 0: causal attention over the chunk, the K1
  flash kernel on the card (``gpt.py:485-492``);
- dense-cache per-row decode (the ``paged=False`` engine, ``gpt.py:468-511``):
  each row writes its token at its own column and attends over its own
  ``[0, position]``; a mid-sequence chunk (a prefix hit's suffix) attends
  over the cache under a causal mask; :func:`gather_block_prefix` and
  :func:`slice_cache_blocks` move blocks between a dense cache and the
  dense engine's prefix pool;
- paged per-row decode: the int8 (or full-precision) append into each row's
  tail block, then K4 over the block table (``gpt.py:386-466``);
- paged batch-1 chunk prefill: :func:`_paged_chunk_quantized`, then K4;
- paged per-row chunks (speculative verify, ``gpt.py:157-251``):
  :func:`_paged_verify_chunk` scores S tokens per row without writing the
  pool, and :func:`paged_commit_chunk` appends the accepted ones afterwards.

Training (``cache=None``, ``deterministic=False`` with a ``generator``):
dropout at the JAX model's three sites (embeddings, after ``attn_out``, after
``mlp_down``), and packed rows through ``segment_ids``: attention confined to
same-segment keys (K1 forward, K2/K3 backward in their segment-id mode) and
positions restarting at every id change (``gpt.py:586-595``). :func:`lm_loss`
is the next-token cross-entropy with cross-segment transitions weighted 0.

Caches are dicts of tensors as in the JAX package (``{"layer_i": {"k", "v"
[, "k_scale", "v_scale"]}}``, plus ``"table"`` for paged caches). Unlike the
JAX package, the port updates cache and pool tensors IN PLACE (PyTorch tensors
are mutable; an in-place scatter saves a pool-sized copy per step); the
returned cache dict holds the same tensors.

Mixed precision as flax does it: parameters are float32, each layer casts
its weight and input to ``config.dtype`` (``models/_layers.py``), the
embedding lookups return ``config.dtype`` and the tied head multiplies
float32 hidden states by the float32 embedding. KV caches and pools keep
``config.dtype``. A serving copy made by
:func:`~unionml_tpu_torch.models._layers.quantize_model` keeps its decoder
kernels as int8 and dequantizes each just before its product.

Sparse configs (``moe_every > 0``, ``gpt.py:52-66``) swap every
``moe_every``-th block's MLP for a :class:`~unionml_tpu_torch.models.moe.MoEMlp`
(its expert weights in ``config.dtype``): capacity-bounded top-k dispatch in
training, dropless whenever the forward is deterministic (eval, ``generate``
and every serving path, where capacity would depend on the call's token
count). ``return_aux=True`` hands back the router losses of every sparse
block for :func:`~unionml_tpu_torch.models.moe.collect_aux_losses`.

``remat=True`` recomputes every decoder block of a training forward (no
cache, gradients on) in the backward pass instead of keeping its activations
(``gpt.py:615-619``), through
:func:`~unionml_tpu_torch.models._layers.recomputed`: the recompute draws
the forward's dropout masks and router jitter, and a sparse block's router
losses come out of the recomputed block as they do without it. Decode and
prefill never recompute.

Tensor parallelism (``param_shardings``, ``gpt.py:981-1042``): under a mesh
with a ``tensor`` axis of N ranks, :func:`tensor_parallel` gives each rank a
copy of the model holding its Megatron shard of every weight, and the
forward issues the collectives XLA inserts in the JAX package, over the
tensor axis's process group. ``qkv`` and ``mlp_up`` are column-parallel
(this rank's heads of q, k and v, its quarter of the MLP); ``attn_out`` and
``mlp_down`` are row-parallel, one all-reduce each, with the bias added by
rank 0 alone (inside its product, as the unsharded layer adds it, so a world
of one rank computes bit for bit what the unsharded model does); ``wte`` and
``wpe`` are vocab- and position-parallel (a masked lookup and an
all-reduce), and the tied head's f32 logits are all-gathered, so every rank
holds the same logits bit for bit. Each rank attends over ``num_heads / N``
heads, and its KV cache or pool holds only those (:func:`kv_cache_spec`).
Where N does not divide the heads, q, k, v and the cache stay whole on
every rank and only the projections after attention split.

A tensor-parallel model trains (``fit_lm(mesh=..., param_spec=...)``,
:mod:`~unionml_tpu_torch.models.training`): in a forward that autograd
records, the inputs of the column-parallel products (``qkv``, ``mlp_up`` and
the tied head) pass through
:meth:`~unionml_tpu_torch.models._layers.TensorParallel.enter` (identity
forward, gradient summed over the axis backward), the row-parallel sums and
the lookups' all-reduces pass the gradient through as it is, and the
gathered logits hand each rank its slice of theirs. K1, K2 and K3 then run
at a rank's heads. The gradients of what rank 0 alone adds (the row-parallel
biases) and, where the axis does not divide the heads, of the whole ``qkv``
are each rank's part of a sum, which the train step completes
(:func:`tensor_parallel`'s ``partial`` names).

Sequence parallelism (``attention_impl="ring"`` or ``"ulysses"`` with
``sp_mesh``, ``gpt.py:357-379``): a training forward (no cache) takes THIS
rank's chunk of every row, positions ``[r * L, (r + 1) * L)`` for sequence
rank r, and offsets its position embeddings by ``r * L``; each block's
causal attention goes through
:func:`~unionml_tpu_torch.parallel.sp_attention` (K1 per ring block, K2/K3
in the ring's backward; or Ulysses's all-to-alls around K1-K3). Everything
else in a block is per position, so it needs no exchange.
``segment_ids`` and ``pad_offsets`` raise JAX's ``ValueError``s. The cache
paths (``generate``, the engines) attend densely, K1 and K4 as in any other
config (``gpt.py:491``). On a mesh with a ``tensor`` axis beside
``sequence``, :func:`tensor_parallel`'s copy keeps the config: each rank
computes its chunk at its heads (the ring as it is, Ulysses exchanging by
the model's heads), its position-parallel ``wpe`` lookup takes the chunk's
offset positions and the tied head's gathered f32 logits are the chunk's.
Sparse blocks under sequence parallelism route the chunks of the batch's
rows together, in JAX's token order (see :class:`~unionml_tpu_torch.models.moe.MoEMlp`).

Expert parallelism (``ep_mesh`` with an ``expert`` axis, ``gpt.py:61-66``):
each rank's sparse blocks hold its ``1/N`` of the experts (the weight
bridge, :func:`~unionml_tpu_torch.models.convert.init_gpt`, slices them),
and a training forward dispatches by ``moe_dispatch`` (see
:class:`~unionml_tpu_torch.models.moe.MoEMlp`); every rank of the axis
holds the same rows and computes the same outside the experts. Sparse
blocks under a tensor mesh split every expert's hidden width as the dense
MLP's (``w_in`` column-parallel, ``w_out`` row-parallel, one all-reduce;
the router replicated). Served (:func:`tensor_parallel`), each rank keeps
its share (``ep_mesh``'s, or the serving mesh's ``expert`` axis cuts whole
stacks) and a dropless block sums its experts' outputs over the axis in f32;
beside a ``tensor`` axis each rank holds its experts' column/row share and
the outputs are summed over expert×tensor. Trained (``fit_lm(mesh=)`` on
the ``ep_mesh``), the experts split over ``expert`` beside ``fsdp``,
``tensor`` or ``sequence``, by JAX's specs ``P(expert, fsdp, tensor)`` /
``P(expert, tensor, fsdp)`` (:func:`param_shardings`).

Serving over an ``fsdp`` axis (``gpt.py:981-1026``): each rank keeps its
``1/N`` of every decoder-block matrix and expert stack at rest, and each
block all-gathers its weights into shared whole buffers just before it
computes (inside the engines' captured graphs on the card).
"""

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models._layers import (
    SEQUENCE_IMPLS,
    TensorParallel,
    _dense,
    _dropout,
    _kernel,
    _layer_norm,
    recomputed,
)
from unionml_tpu_torch.models.moe import MoEMlp
from unionml_tpu_torch.ops.attention import attention, reference_attention
from unionml_tpu_torch.ops.losses import cross_entropy_with_integer_labels
from unionml_tpu_torch.ops.paged_attention import paged_attention

Device = Union[str, torch.device, None]

_IMPLS = ("auto", "kernel", "reference")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """GPT-2 small by default (``gpt.py:28-78``)."""

    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    #: dropout rate at the embeddings and after each block's two residual branches
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    #: dense attention: "auto" (K1 kernel on CUDA), "kernel", or "reference";
    #: "ring" or "ulysses" train sequence-parallel over ``sp_mesh`` (the
    #: cache paths attend densely)
    attention_impl: str = "auto"
    #: paged attention: "auto" (K4 kernel on CUDA), "kernel", or "reference"
    paged_attn_impl: str = "auto"
    #: the mesh whose "sequence" axis ring/ulysses attention splits rows over
    sp_mesh: Any = None
    #: recompute the decoder blocks of training forwards in the backward pass
    #: instead of keeping their activations (decode and prefill never do)
    remat: bool = False
    #: sparse variant: every Nth block routes its MLP through experts (0 = dense)
    moe_every: int = 0
    num_experts: int = 8
    moe_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_router_noise: float = 0.0
    #: "gshard" (index dispatch, routed over the global batch; over
    #: ``ep_mesh``'s "expert" axis each rank runs its own experts) or "a2a"
    #: (needs ``ep_mesh``: only routed tokens move, by two all-to-alls over
    #: the "expert" axis); see :class:`~unionml_tpu_torch.models.moe.MoEMlp`
    moe_dispatch: str = "gshard"
    #: the expert-parallel mesh: an "expert" axis (each rank holds 1/N of
    #: every sparse block's experts), optionally "data"
    ep_mesh: Any = None

    def __post_init__(self) -> None:
        if self.moe_dispatch not in ("gshard", "a2a"):
            raise ValueError(f"moe_dispatch must be 'gshard' or 'a2a', got {self.moe_dispatch!r}")
        if self.attention_impl not in _IMPLS + SEQUENCE_IMPLS:
            raise ValueError(f"attention_impl must be one of {_IMPLS + SEQUENCE_IMPLS}, got {self.attention_impl!r}")
        if self.paged_attn_impl not in _IMPLS:
            raise ValueError(f"paged_attn_impl must be one of {_IMPLS}, got {self.paged_attn_impl!r}")
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must be divisible by num_heads")

    @classmethod
    def tiny(cls, **overrides) -> "GPTConfig":
        defaults = dict(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, max_position_embeddings=128
        )
        defaults.update(overrides)
        return cls(**defaults)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _per_row(position) -> bool:
    return torch.is_tensor(position) and position.dim() == 1


def _decode_slots(position: torch.Tensor, block_table: torch.Tensor, block_size: int):
    """``(pool block, offset)`` int64 of each row's decode write at its
    ``position``, clamped into the table's capacity (the same for every
    layer, so the model computes it once per step)."""
    pos = torch.clamp(position.long(), 0, block_table.shape[1] * block_size - 1)
    blk, off = pos // block_size, pos % block_size
    return torch.gather(block_table.long(), 1, blk[:, None])[:, 0], off


def _paged_append_quantized(pool_q, pool_scale, dst, off, vals):
    """Single-token decode append into an int8 pool tail block, in place.

    ``dst`` (batch,) pool block per row, ``off`` (batch,) offset inside it,
    ``vals`` (batch, heads, head_dim) the new token's K or V. Monotone-scale
    read-modify-write, float32 op for op as ``gpt.py:81-111``: a block's
    per-head scale resets on its first write (``off == 0``) and afterwards only
    grows; existing codes are rescaled only on growth (ratio exactly 1.0
    otherwise, a bit-exact no-op); offsets past the write point are zeroed.
    Rows retired to the scratch block write self-consistent garbage there.
    Returns ``(pool_q, pool_scale)``, the same tensors.
    """
    bs = pool_q.shape[2]
    dst = dst.long()
    old_q = pool_q[dst].float()  # (batch, heads, bs, hd)
    old_scale = pool_scale[dst]  # (batch, heads, 1, 1)
    vals32 = vals.float()[:, :, None, :]  # (batch, heads, 1, hd)
    tok_scale = vals32.abs().amax(dim=-1, keepdim=True) / 127.0
    fresh = (off == 0)[:, None, None, None]
    eff_old = torch.where(fresh, torch.zeros_like(old_scale), old_scale)
    new_scale = torch.maximum(eff_old, tok_scale)
    safe = torch.where(new_scale > 0, new_scale, torch.ones_like(new_scale))
    rescaled = torch.round(old_q * (eff_old / safe))
    tok_q = torch.round(vals32 / safe)
    slot_idx = torch.arange(bs, device=pool_q.device)[None, None, :, None]
    off_b = off.long()[:, None, None, None]
    new_q = torch.where(
        slot_idx < off_b, rescaled, torch.where(slot_idx == off_b, tok_q, torch.zeros_like(rescaled))
    )
    pool_q[dst] = torch.clamp(new_q, -127, 127).to(torch.int8)
    pool_scale[dst] = new_scale
    return pool_q, pool_scale


def _paged_chunk_quantized(pool_q, pool_scale, table_row, position: int, vals):
    """Batch-1 chunk prefill into an int8 pool, in place (``gpt.py:114-154``).

    ``vals`` (heads, seq, head_dim) is the chunk's K or V for positions
    ``[position, position + seq)``; ``table_row`` (width,) maps logical blocks
    to pool blocks. Touches only the ``ceil(seq/bs) + 1`` blocks the chunk can
    reach from ``position // bs``; the first may be mid-block (fresh only when
    the chunk starts at its offset 0), later ones are fresh. Logical blocks
    past the table width clamp to the trailing scratch column; positions past
    the chunk's end are zeroed. Returns ``(pool_q, pool_scale)``.
    """
    heads, seq, head_dim = vals.shape
    bs = pool_q.shape[2]
    width = table_row.shape[0]
    device = pool_q.device
    nb = -(-seq // bs) + 1
    blk_idx = position // bs + torch.arange(nb, device=device)
    dst = table_row.long()[torch.clamp(blk_idx, 0, width - 1)]
    old_q = pool_q[dst].float()  # (nb, heads, bs, hd)
    old_scale = pool_scale[dst]  # (nb, heads, 1, 1)
    gpos = blk_idx[:, None] * bs + torch.arange(bs, device=device)[None, :]  # (nb, bs)
    rel = gpos - position
    write = ((rel >= 0) & (rel < seq))[:, None, :, None]
    live = (gpos < position + seq)[:, None, :, None]
    chunk = vals.transpose(0, 1).float()  # (seq, heads, hd)
    take = chunk[torch.clamp(rel.reshape(-1), 0, seq - 1)]
    take = take.reshape(nb, bs, heads, head_dim).transpose(1, 2)  # (nb, heads, bs, hd)
    fresh = (blk_idx * bs >= position)[:, None, None, None]
    eff_old = torch.where(fresh, torch.zeros_like(old_scale), old_scale)
    chunk_absmax = torch.where(write, take, torch.zeros_like(take)).abs().amax(dim=(2, 3), keepdim=True)
    new_scale = torch.maximum(eff_old, chunk_absmax / 127.0)
    safe = torch.where(new_scale > 0, new_scale, torch.ones_like(new_scale))
    rescaled = torch.round(old_q * (eff_old / safe))
    new_q = torch.where(write, torch.round(take / safe), rescaled)
    new_q = torch.where(live, new_q, torch.zeros_like(new_q))
    pool_q[dst] = torch.clamp(new_q, -127, 127).to(torch.int8)
    pool_scale[dst] = new_scale
    return pool_q, pool_scale


def _dense_by_position(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, bias: bool = True) -> torch.Tensor:
    """:func:`~unionml_tpu_torch.models._layers._dense` of ``x`` (batch, S, in)
    one position at a time: each product has the decode step's shape
    (``batch`` rows), so a row's result is bit for bit the decode step's (a
    GEMM's rounding depends on its row count on the card and on the CPU)."""
    weight = _kernel(layer, dtype)
    bias = layer.bias.to(dtype) if bias and layer.bias is not None else None
    x = x.to(dtype)
    return torch.cat([F.linear(x[:, j:j + 1].contiguous(), weight, bias) for j in range(x.shape[1])], dim=1)


def _paged_verify_chunk(cache, block_table, position, q, k, v, out_dtype, impl="auto"):
    """Speculative verify (``gpt.py:157-251``): attention context for ``S``
    chunk tokens per row over the row's paged prefix, WITHOUT writing the pool.

    ``q``/``k``/``v`` are ``(batch, heads, S, head_dim)`` for chunk tokens at
    per-row positions ``[position, position + S)``. Each row's blocks are
    gathered into a local copy in the pool's own layout (int8 codes stay int8,
    scales f32); chunk position ``j`` then runs the decode append
    (:func:`_paged_append_quantized`, or the full-precision scatter) into that
    copy and :func:`paged_attention` at S = 1 over an identity table, so an
    accepted token scores bit for bit as plain decoding would have scored it,
    and a rejected one never touches the pool or its monotone int8 scales.
    Returns ``(batch, heads, S, head_dim)`` in ``out_dtype``.
    """
    batch, heads, S, head_dim = q.shape
    block_size = cache["k"].shape[2]
    width = block_table.shape[1]
    capacity = width * block_size
    device = q.device
    table = block_table.long()
    rows = torch.arange(batch, device=device)
    # row b's logical block w is local block b * width + w of the flattened copy
    local_table = (rows[:, None] * width + torch.arange(width, device=device)[None, :]).to(torch.int32)

    def local(leaf):
        return leaf[table].reshape((batch * width,) + tuple(leaf.shape[1:]))

    quantized = "k_scale" in cache
    kc, vc = local(cache["k"]), local(cache["v"])
    ks, vs = (local(cache["k_scale"]), local(cache["v_scale"])) if quantized else (None, None)
    pos0 = position.to(torch.int32)
    out = []
    for j in range(S):
        pos = torch.clamp(pos0 + j, 0, capacity - 1)
        blk, off = pos.long() // block_size, pos.long() % block_size
        dst = rows * width + blk
        if quantized:
            _paged_append_quantized(kc, ks, dst, off, k[:, :, j, :])
            _paged_append_quantized(vc, vs, dst, off, v[:, :, j, :])
        else:
            kc[dst, :, off, :] = k[:, :, j, :].to(kc.dtype)
            vc[dst, :, off, :] = v[:, :, j, :].to(vc.dtype)
        ctx = paged_attention(q[:, :, j:j + 1, :].contiguous(), kc, vc, local_table, pos, k_scale=ks, v_scale=vs,
                              out_dtype=out_dtype, impl=impl)
        out.append(ctx)
    return torch.cat(out, dim=2)


def paged_commit_chunk(layer_cache, block_table, position, counts, ck, cv):
    """Commit the first ``counts[row]`` verified chunk tokens of one layer into
    the paged pool as SEQUENTIAL single-token appends, in place
    (``gpt.py:254-303``).

    ``ck``/``cv`` are the ``(batch, heads, S, head_dim)`` K/V a verify pass
    stashed; row positions start at ``position`` (the row's length before the
    round). Chunk index ``j >= counts[row]`` (rejected proposals, tokens past a
    retirement, rows with count 0) writes at the sentinel position, the
    trailing scratch column, so the pool and its int8 scales follow exactly
    the trajectory plain decoding of the accepted prefix gives. Returns
    ``layer_cache``.
    """
    block_size = layer_cache["k"].shape[2]
    sentinel = (block_table.shape[1] - 1) * block_size
    pos0 = position.long()
    for j in range(ck.shape[2]):
        pos = torch.where(j < counts, pos0 + j, torch.full_like(pos0, sentinel))
        dst, off = _decode_slots(pos, block_table, block_size)
        if "k_scale" in layer_cache:
            _paged_append_quantized(layer_cache["k"], layer_cache["k_scale"], dst, off, ck[:, :, j, :])
            _paged_append_quantized(layer_cache["v"], layer_cache["v_scale"], dst, off, cv[:, :, j, :])
        else:
            layer_cache["k"][dst, :, off, :] = ck[:, :, j, :].to(layer_cache["k"].dtype)
            layer_cache["v"][dst, :, off, :] = cv[:, :, j, :].to(layer_cache["v"].dtype)
    return layer_cache


def kv_heads(model: nn.Module) -> int:
    """Attention heads of ``model``'s KV cache on this rank: this rank's share
    under tensor parallelism, else the config's."""
    tp = getattr(model, "tp", None)
    return model.config.num_heads if tp is None else tp.heads


class DecoderBlock(nn.Module):
    """Pre-LN block: attention then a tanh-GELU MLP (or, with ``use_moe``,
    a :class:`MoEMlp`), each with a residual."""

    def __init__(self, config: GPTConfig, device: torch.device, use_moe: bool = False) -> None:
        super().__init__()
        d, kw = config.hidden_size, dict(device=device, dtype=torch.float32)
        self.config = config
        self.attn_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)
        self.qkv = nn.Linear(d, 3 * d, **kw)
        self.attn_out = nn.Linear(d, d, **kw)
        self.mlp_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)
        if use_moe:
            self.moe_mlp = MoEMlp(d, config.num_experts, 4 * d, k=config.moe_k,
                                  capacity_factor=config.moe_capacity_factor, router_noise=config.moe_router_noise,
                                  dispatch=config.moe_dispatch, mesh=config.ep_mesh, dtype=config.dtype,
                                  device=device)
        else:
            self.mlp_up = nn.Linear(d, 4 * d, **kw)
            self.mlp_down = nn.Linear(4 * d, d, **kw)
        self.use_moe = use_moe
        #: this rank's share of a tensor-parallel model (:func:`tensor_parallel`)
        self.tp: Optional[TensorParallel] = None
        #: a serving copy's weights split over ``fsdp``, gathered before each
        #: forward (:func:`~unionml_tpu_torch.models._sharding.split_fsdp_weights`)
        self.fsdp: Any = None

    def forward(
        self,
        hidden: torch.Tensor,
        cache: Optional[Dict[str, torch.Tensor]],
        position: Union[int, torch.Tensor, None],
        pad_offsets: Optional[torch.Tensor] = None,
        block_table: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        decode_slots: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        verify: bool = False,
    ):
        """``(hidden, cache, aux)`` of a full sequence (``cache=None``,
        optionally packed by ``segment_ids``), a dense-cache or a paged
        step; ``aux`` is a sparse block's router losses (None when dense).
        ``generator`` turns dropout (and router jitter) on and draws its
        masks; without one a sparse block is dropless.

        Dense cache: ``{"k","v"}`` of shape (batch, heads, max_len, head_dim)
        and a scalar ``position``. Paged: pool leaves (num_blocks, heads,
        block_size, head_dim) shared by every row, ``block_table`` (batch,
        width), and either a (batch,) ``position`` tensor (each row at its own
        position: single-token decode, or a speculative verify chunk that
        leaves the pool untouched and returns its K/V as ``"ck"``/``"cv"``)
        or an int (batch-1 chunk);
        ``decode_slots`` (from :func:`_decode_slots`) saves each layer of a
        decode step from computing the rows' write slots again; ``verify``
        (set by the model for a paged per-row chunk of more than one token)
        routes the chunk through the speculative verify.
        """
        cfg, tp = self.config, self.tp
        if self.fsdp is not None:
            self.fsdp.gather()
        batch, seq, _ = hidden.shape
        # a speculative verify chunk takes each position's products at the
        # decode step's shape, so its tokens score as plain decoding scores them
        dense = _dense_by_position if verify else _dense
        normed = _layer_norm(self.attn_norm, hidden, cfg.dtype)
        qkv = dense(self.qkv, normed if tp is None else tp.enter(normed), cfg.dtype)
        n_heads = cfg.num_heads if tp is None else tp.heads
        width = n_heads * cfg.head_dim

        def heads(x):
            return x.reshape(batch, seq, n_heads, cfg.head_dim).transpose(1, 2).contiguous()

        def row_parallel(layer, x):
            # the shards' partial products summed over the tensor axis; rank 0
            # adds the bias inside its product, as the unsharded layer does
            if tp is None:
                return dense(layer, x, cfg.dtype)
            return tp.reduce(dense(layer, x, cfg.dtype, bias=tp.index == 0))

        q, k, v = (heads(x) for x in qkv.split(width, dim=-1))

        def pad_mask(k_positions):
            # (batch, 1, 1, Lk): keys in a row's left-pad region contribute nothing
            return (k_positions[None, :] >= pad_offsets[:, None])[:, None, None, :]

        new_cache = cache
        if cache is None:
            if cfg.attention_impl in SEQUENCE_IMPLS:
                # sequence-parallel training: this rank's chunk; causal masking happens inside
                if segment_ids is not None:
                    raise ValueError(
                        "segment_ids (packed training) composes with neither pad_offsets "
                        "(left-padded ragged batches) nor sequence-parallel attention"
                    )
                if pad_offsets is not None:
                    raise ValueError(
                        "ring/ulysses attention does not support pad_offsets (left-padded "
                        "ragged batches); train sequence-parallel configs on uniform-length "
                        "batches or use a dense attention_impl."
                    )
                from unionml_tpu_torch.parallel import sp_attention

                # under a tensor split q, k, v hold this rank's heads (Ulysses exchanges by the model's)
                context = sp_attention(q, k, v, cfg.sp_mesh, cfg.attention_impl, causal=True,
                                       tensor_axis="tensor" if tp is not None and tp.split_heads else None)
            elif segment_ids is not None:
                if pad_offsets is not None:
                    raise ValueError("segment_ids (packed training) does not compose with pad_offsets "
                                     "(left-padded ragged batches)")
                context = attention(q, k, v, causal=True, impl=cfg.attention_impl, segment_ids=segment_ids)
            elif pad_offsets is None:
                context = attention(q, k, v, causal=True, impl=cfg.attention_impl)
            else:
                context = reference_attention(
                    q, k, v, causal=True, mask=pad_mask(torch.arange(seq, device=q.device))
                )
        elif block_table is not None:
            if pad_offsets is not None:
                raise ValueError("paged decode does not support pad_offsets (left-padded rows)")
            if verify:
                # speculative verify: score the chunk without writing the pool;
                # the fresh K/V ride along for paged_commit_chunk
                context = _paged_verify_chunk(cache, block_table, position, q, k, v, cfg.dtype,
                                              impl=cfg.paged_attn_impl)
                new_cache = {**cache, "ck": k, "cv": v}
            else:
                context = self._paged(q, k, v, cache, position, block_table, decode_slots)
        else:
            context = self._dense(q, k, v, cache, position, pad_offsets, pad_mask)

        context = context.transpose(1, 2).reshape(batch, seq, width)
        if tp is not None and not tp.split_heads:
            # whole heads on every rank: attn_out's input rows split all the same
            part = cfg.hidden_size // tp.size
            context = context[..., tp.index * part:(tp.index + 1) * part]
        hidden = hidden + _dropout(row_parallel(self.attn_out, context), cfg.dropout, generator)
        normed = _layer_norm(self.mlp_norm, hidden, cfg.dtype)
        aux = None
        if not self.use_moe:
            up = dense(self.mlp_up, normed if tp is None else tp.enter(normed), cfg.dtype)
            down = row_parallel(self.mlp_down, F.gelu(up, approximate="tanh"))
        elif verify:
            # position by position, as _dense_by_position: each expert
            # product has the decode step's rows (the layer is dropless here)
            down = torch.cat([self.moe_mlp(normed[:, j:j + 1], dropless=True)[0] for j in range(seq)], dim=1)
        else:
            # dropless exactly when deterministic (gpt.py:534)
            down, aux = self.moe_mlp(normed, dropless=generator is None, generator=generator)
        return hidden + _dropout(down, cfg.dropout, generator), new_cache, aux

    def _dense(self, q, k, v, cache, position, pad_offsets, pad_mask):
        cfg = self.config
        batch, _, seq, _ = q.shape
        k_pos = torch.arange(cache["k"].shape[2], device=q.device)
        if _per_row(position):
            if seq != 1:
                raise ValueError("per-row cache positions require single-token decode (seq=1)")
            # continuous batching: each row writes its token's K/V at its own
            # column (one scatter; a position past the cache clamps to its
            # last column, which the engine allows only for finished rows) and
            # attends over exactly its own [0, position]
            position = position.long()
            rows = torch.arange(batch, device=q.device)
            cols = torch.clamp(position, 0, cache["k"].shape[2] - 1)
            cache["k"][rows, :, cols, :] = k[:, :, 0, :].to(cache["k"].dtype)
            cache["v"][rows, :, cols, :] = v[:, :, 0, :].to(cache["v"].dtype)
            mask = (k_pos[None, :] <= position[:, None])[:, None, None, :]
            if pad_offsets is not None:
                mask = mask & pad_mask(k_pos)
            return reference_attention(q, cache["k"], cache["v"], mask=mask)
        position = int(position)
        cache["k"][:, :, position:position + seq] = k.to(cache["k"].dtype)
        cache["v"][:, :, position:position + seq] = v.to(cache["v"].dtype)
        if seq > 1 and position == 0:
            # start-of-sequence prefill: plain causal attention over the chunk
            # is exact (the K1 kernel on the card); ragged rows add the pad
            # mask. A sequence-parallel config attends densely here (gpt.py:491)
            if pad_offsets is None:
                impl = "auto" if cfg.attention_impl in SEQUENCE_IMPLS else cfg.attention_impl
                return attention(q, k, v, causal=True, impl=impl)
            return reference_attention(
                q, k, v, causal=True, mask=pad_mask(torch.arange(seq, device=q.device))
            )
        q_pos = position + torch.arange(seq, device=q.device)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None, :, :]
        if pad_offsets is not None:
            mask = mask & pad_mask(k_pos)
        return reference_attention(q, cache["k"], cache["v"], mask=mask)

    def _paged(self, q, k, v, cache, position, block_table, decode_slots=None):
        cfg = self.config
        batch, _, seq, _ = q.shape
        per_row = _per_row(position)
        block_size = cache["k"].shape[2]
        quantized = "k_scale" in cache
        if per_row:
            # decode: each row appends one token into its own tail block
            dst, off = decode_slots if decode_slots is not None else _decode_slots(position, block_table, block_size)
            if quantized:
                _paged_append_quantized(cache["k"], cache["k_scale"], dst, off, k[:, :, 0, :])
                _paged_append_quantized(cache["v"], cache["v_scale"], dst, off, v[:, :, 0, :])
            else:
                cache["k"][dst, :, off, :] = k[:, :, 0, :].to(cache["k"].dtype)
                cache["v"][dst, :, off, :] = v[:, :, 0, :].to(cache["v"].dtype)
            base = position
        else:
            # chunked prefill through the table (batch 1) at positions
            # [position, position + seq) of row 0's blocks
            if batch != 1:
                raise ValueError("paged chunk prefill requires batch == 1")
            position = int(position)
            if quantized:
                _paged_chunk_quantized(cache["k"], cache["k_scale"], block_table[0], position, k[0])
                _paged_chunk_quantized(cache["v"], cache["v_scale"], block_table[0], position, v[0])
            else:
                capacity = block_table.shape[1] * block_size
                pos = torch.clamp(position + torch.arange(seq, device=q.device), 0, capacity - 1)
                dst = block_table[0].long()[pos // block_size]
                cache["k"][dst, :, pos % block_size, :] = k[0].transpose(0, 1).to(cache["k"].dtype)
                cache["v"][dst, :, pos % block_size, :] = v[0].transpose(0, 1).to(cache["v"].dtype)
            base = torch.full((1,), position, dtype=torch.int32, device=q.device)
        return paged_attention(
            q, cache["k"], cache["v"], block_table, base,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            out_dtype=cfg.dtype, impl=cfg.paged_attn_impl,
        )


class GPTLMHeadModel(nn.Module):
    """Decoder LM: token + position embeddings, N blocks, tied f32 LM head.

    :param device: where the parameters live; ``"cuda"`` (default) raises
        when no CUDA device is available — pass ``"cpu"`` explicitly for the
        plain PyTorch path.
    """

    def __init__(self, config: GPTConfig, device: Device = "cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=torch.float32)
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = nn.Embedding(config.max_position_embeddings, config.hidden_size, **kw)
        self.layers = nn.ModuleList(
            DecoderBlock(config, device, use_moe=config.moe_every > 0 and (i + 1) % config.moe_every == 0)
            for i in range(config.num_layers)
        )
        self.final_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, **kw)
        #: this rank's share of a tensor-parallel model (:func:`tensor_parallel`)
        self.tp: Optional[TensorParallel] = None

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def _lookup(self, ids: torch.Tensor, table: nn.Embedding) -> torch.Tensor:
        return F.embedding(ids, table.weight) if self.tp is None else self.tp.lookup(ids, table.weight)

    def forward(
        self,
        input_ids: torch.Tensor,
        cache: Optional[Dict[str, Any]] = None,
        position: Union[int, torch.Tensor, None] = None,
        pad_offsets: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        return_aux: bool = False,
    ):
        """Logits ``(batch, seq, vocab)`` f32, the updated cache when one is
        given, and with ``return_aux`` the list of the sparse blocks' router
        losses (``(logits[, cache], aux)``). ``pad_offsets`` (batch,) batches
        LEFT-padded ragged rows: each row's positions start at its first real
        token and its pad region is masked. A ``cache`` carrying a ``"table"`` key selects paged decoding
        (see :func:`init_block_pool`). ``segment_ids`` (batch, seq) packs
        several sequences per row (0 = padding; training only, no cache):
        attention stays inside each segment and positions restart at every id
        change. With ``deterministic=False`` dropout is on and draws its masks
        from ``generator``. Inference callers run this under ``torch.no_grad()``."""
        cfg = self.config
        if pad_offsets is not None and cfg.moe_every > 0 and not deterministic:
            raise ValueError(
                "pad_offsets with a MoE config requires deterministic=True: "
                "capacity-bounded expert dispatch lets pad tokens evict real tokens."
            )
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("deterministic=False draws dropout masks from `generator`; pass one")
        if segment_ids is not None and cache is not None:
            raise ValueError("segment_ids is a packed-TRAINING feature; decode caches are unpacked")
        batch, seq = input_ids.shape
        steps = torch.arange(seq, device=input_ids.device)
        if segment_ids is not None:
            # positions restart at each id change: subtract the running index
            # of the latest change (cummax of change positions), gpt.py:586-595
            ids = segment_ids.to(torch.int32)
            change = torch.ones((batch, seq), dtype=torch.bool, device=ids.device)
            change[:, 1:] = ids[:, 1:] != ids[:, :-1]
            starts = torch.where(change, steps[None, :], torch.zeros_like(steps)[None, :])
            positions = steps[None, :] - torch.cummax(starts, dim=1).values
        elif cache is None:
            positions = steps[None, :]
            if cfg.attention_impl in SEQUENCE_IMPLS:
                # this rank's chunk of the rows: positions [r * L, (r + 1) * L)
                from unionml_tpu_torch.parallel.mesh import sequence_index

                positions = positions + sequence_index(cfg.sp_mesh) * seq
        elif _per_row(position):
            positions = torch.clamp(position.long()[:, None] + steps[None, :], 0, cfg.max_position_embeddings - 1)
        else:
            positions = (int(position) + steps)[None, :]
        if pad_offsets is not None:
            positions = torch.clamp(positions - pad_offsets.long()[:, None], min=0)
        word = self._lookup(input_ids, self.wte).to(cfg.dtype)
        hidden = _dropout(word + self._lookup(positions, self.wpe).to(cfg.dtype), cfg.dropout, generator)

        new_cache: Dict[str, Any] = {}
        aux = []
        block_table = cache.get("table") if cache is not None else None
        decode_slots = None
        # a paged chunk of several tokens per row is a speculative verify: one
        # flag drives its per-position products, its attention route and its head
        verify = block_table is not None and _per_row(position) and seq > 1
        if block_table is not None and _per_row(position):
            # once per step, not per layer: K4 takes int32 positions, the
            # append its write slots
            position = position.to(torch.int32)
            if seq == 1:
                decode_slots = _decode_slots(position, block_table, cache["layer_0"]["k"].shape[2])
        # training forwards only, as JAX's nn.remat: a cached step never recomputes
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            layer_cache = None if cache is None else cache[f"layer_{i}"]
            args = (hidden, layer_cache, position, pad_offsets, block_table, segment_ids, generator, decode_slots,
                    verify)
            hidden, layer_cache, layer_aux = recomputed(layer, generator, *args) if remat else layer(*args)
            if layer_cache is not None:
                new_cache[f"layer_{i}"] = layer_cache
            if layer_aux is not None:
                aux.append(layer_aux)
        if block_table is not None:
            new_cache["table"] = block_table
        hidden = _layer_norm(self.final_norm, hidden, cfg.dtype).float()
        if self.tp is not None:  # the tied head is column-parallel over the vocabulary
            hidden = self.tp.enter(hidden)
        # tied head with genuinely-f32 logits: f32 hidden states times the f32
        # embedding (a verify chunk's position by position, as its blocks)
        if verify:
            logits = torch.cat([hidden[:, j:j + 1].contiguous() @ self.wte.weight.t() for j in range(seq)], dim=1)
        else:
            logits = hidden @ self.wte.weight.t()
        if self.tp is not None:
            logits = self.tp.gather_last(logits)
        out = (logits, new_cache) if cache is not None else (logits,)
        if return_aux:
            return (*out, aux)
        return out if cache is not None else logits


def init_cache(config: GPTConfig, batch: int, max_len: Optional[int] = None, dtype=None,
               device: Device = "cuda", heads: Optional[int] = None) -> Dict[str, Any]:
    """Zeroed dense KV cache (config's compute dtype) for incremental decoding;
    ``heads`` (default the config's) is a tensor-parallel rank's share
    (:func:`kv_heads`)."""
    device = resolve_device(device)
    max_len = max_len or config.max_position_embeddings
    dtype = dtype if dtype is not None else config.dtype
    shape = (batch, heads or config.num_heads, max_len, config.head_dim)
    return {
        f"layer_{i}": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
        for i in range(config.num_layers)
    }


def init_block_pool(
    config: GPTConfig,
    num_blocks: int,
    block_size: int,
    dtype=None,
    kv_quantize: Optional[str] = None,
    kv_quantize_skip_layers=(),
    device: Device = "cuda",
    heads: Optional[int] = None,
) -> Dict[str, Any]:
    """Zeroed KV block pool, ``(num_blocks, heads, block_size, head_dim)`` per
    layer. ``kv_quantize="int8"`` stores int8 codes with per-(block, head) f32
    scales (``k_scale``/``v_scale``, shape ``(blocks, heads, 1, 1)``); layers in
    ``kv_quantize_skip_layers`` keep full-precision leaves and no scales — the
    attention layer detects the mode per layer from the keys present.
    ``heads`` (default the config's) is a tensor-parallel rank's share: the
    scales are per head, so given the same K/V a rank's codes and scales are
    bit for bit the head slice of an unsharded pool's."""
    device = resolve_device(device)
    dtype = dtype if dtype is not None else config.dtype
    if kv_quantize not in (None, "int8"):
        raise ValueError(f"kv_quantize must be None or 'int8', got {kv_quantize!r}")
    skip = frozenset(int(i) for i in kv_quantize_skip_layers)
    heads = heads or config.num_heads
    shape = (num_blocks, heads, block_size, config.head_dim)
    scale_shape = (num_blocks, heads, 1, 1)
    pool: Dict[str, Any] = {}
    for i in range(config.num_layers):
        if kv_quantize == "int8" and i not in skip:
            pool[f"layer_{i}"] = {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
            }
        else:
            pool[f"layer_{i}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
            }
    return pool


def gather_block_prefix(pool: Dict[str, Any], block_ids: torch.Tensor, pad_len: int) -> Dict[str, Any]:
    """Pool blocks ``block_ids`` ``(n,)`` gathered in order into a fresh
    batch-1 dense cache of ``(1, heads, pad_len, head_dim)`` leaves, zero past
    the ``n * block_size`` restored columns (``gpt.py:823-840``)."""
    out: Dict[str, Any] = {}
    for name, layer in pool.items():
        out[name] = {}
        for key, leaf in layer.items():
            blocks = leaf[block_ids.long()]  # (n, heads, block_size, head_dim)
            n, heads, block_size, head_dim = blocks.shape
            cache = torch.zeros((1, heads, pad_len, head_dim), dtype=leaf.dtype, device=leaf.device)
            cache[0, :, : n * block_size] = blocks.transpose(0, 1).reshape(heads, n * block_size, head_dim)
            out[name][key] = cache
    return out


def slice_cache_blocks(cache: Dict[str, Any], row: int, start_block: int, num_blocks: int,
                       block_size: int) -> Dict[str, Any]:
    """Blocks ``[start_block, start_block + num_blocks)`` of dense-cache row
    ``row`` in pool layout, ``(num_blocks, heads, block_size, head_dim)`` per
    leaf (``gpt.py:843-862``)."""
    out: Dict[str, Any] = {}
    for name, layer in cache.items():
        out[name] = {}
        for key, leaf in layer.items():
            src = leaf[row, :, start_block * block_size : (start_block + num_blocks) * block_size]
            heads, _, head_dim = src.shape
            out[name][key] = src.reshape(heads, num_blocks, block_size, head_dim).transpose(0, 1)
    return out


def kv_pool_bytes(pool: Dict[str, Any], dense_dtype: torch.dtype) -> Tuple[int, int]:
    """``(bytes as stored, bytes at dense_dtype)`` of a block pool, from shapes
    only (``gpt.py:748-759``): the second prices the same K/V positions at
    ``dense_dtype`` without the scale leaves."""
    stored = full = 0
    for layer in pool.values():
        for name, leaf in layer.items():
            stored += leaf.numel() * leaf.element_size()
            if not name.endswith("_scale"):
                full += leaf.numel() * dense_dtype.itemsize
    return stored, full


def block_table_width(max_len: int, block_size: int) -> int:
    """Columns in a slot's block-table row: ``ceil(max_len / block_size)`` data
    blocks plus one trailing scratch column that absorbs retired rows' writes."""
    return -(-max_len // block_size) + 1


def init_block_tables(num_slots: int, max_len: int, block_size: int, scratch_id: int,
                      device: Device = "cuda") -> torch.Tensor:
    """int32 ``(num_slots, width)`` block tables, every entry on the scratch block."""
    width = block_table_width(max_len, block_size)
    return torch.full((num_slots, width), scratch_id, dtype=torch.int32, device=resolve_device(device))


def init_slot_state(num_slots: int, device: Device = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed device-resident ``(active, remaining)`` slot lifecycle state."""
    device = resolve_device(device)
    return (
        torch.zeros((num_slots,), dtype=torch.bool, device=device),
        torch.zeros((num_slots,), dtype=torch.int32, device=device),
    )


def advance_slot_state(
    active: torch.Tensor,
    remaining: torch.Tensor,
    new_lens: torch.Tensor,
    tokens: torch.Tensor,
    max_len: int,
    eos_token_id: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step's slot retirement on the device: budget exhausted,
    cache room (``max_len - 1``) reached, or ``eos_token_id`` decoded —
    the same rule the host applies to fetched tokens. Inactive rows pass
    through unchanged."""
    new_remaining = torch.where(active, remaining - 1, remaining)
    finished = (new_remaining <= 0) | (new_lens >= max_len - 1)
    if eos_token_id is not None:
        finished = finished | (tokens == eos_token_id)
    return active & ~finished, new_remaining


@torch.no_grad()
def generate(
    model: GPTLMHeadModel,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    prompt_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Autoregressive decoding over a dense KV cache (``gpt.py:865-948``).

    ``temperature=0`` is greedy; otherwise samples with ``generator``,
    optionally filtered by ``top_k`` / ``top_p``. ``prompt_mask`` (batch,
    prompt_len; 1 = real token) batches LEFT-padded ragged prompts, each row
    decoding exactly as it would alone. Returns (batch, prompt_len +
    max_new_tokens) token ids.
    """
    from unionml_tpu_torch.ops.sampling import sample_logits, validate_sampling

    config = model.config
    device = model.device
    prompt_ids = prompt_ids.to(device)
    batch, prompt_len = prompt_ids.shape
    total_len = prompt_len + max_new_tokens
    max_len = max_len or total_len
    if total_len > max_len:
        raise ValueError(f"prompt_len + max_new_tokens ({total_len}) exceeds max_len ({max_len})")
    if max_len > config.max_position_embeddings:
        raise ValueError(
            f"max_len ({max_len}) exceeds max_position_embeddings ({config.max_position_embeddings})"
        )
    temperature, top_k, top_p = validate_sampling(temperature, top_k, top_p)
    pad_offsets = None
    if prompt_mask is not None:
        # left padding: each row's pad count is its number of leading zeros
        pad_offsets = prompt_len - prompt_mask.to(device).long().sum(dim=1)

    cache = init_cache(config, batch, max_len, device=device, heads=kv_heads(model))
    logits, cache = model(prompt_ids, cache=cache, position=0, pad_offsets=pad_offsets)
    last = logits[:, -1, :]
    rows = torch.full((batch,), temperature, dtype=torch.float32, device=device)
    tokens = []
    for t in range(max_new_tokens):
        if temperature <= 0.0:
            token = torch.argmax(last, dim=-1)
        else:
            token = sample_logits(
                last, generator, rows,
                torch.full((batch,), top_k, device=device) if top_k > 0 else None,
                torch.full((batch,), top_p, device=device) if top_p < 1.0 else None,
            )
        tokens.append(token)
        logits, cache = model(token[:, None], cache=cache, position=prompt_len + t, pad_offsets=pad_offsets)
        last = logits[:, -1, :]
    return torch.cat([prompt_ids.long(), torch.stack(tokens, dim=1)], dim=1)


def param_shardings(params: Any, mesh_axis_names: Tuple[str, ...] = ("data", "tensor")) -> Any:
    """:class:`~unionml_tpu_torch.parallel.mesh.Spec` tree for the port's GPT
    parameter tree (``dict(model.named_parameters())``, or the weight tree of
    :func:`~unionml_tpu_torch.models._layers.quantize_model`), the
    Megatron-style split of ``gpt.py:981-1042``:

    - fused ``qkv`` and ``mlp_up``: the OUTPUT dim over ``tensor``
    - ``attn_out`` and ``mlp_down``: the INPUT dim over ``tensor``
    - ``wte``/``wpe``: the vocab/position dim over ``tensor``
    - expert stacks ``(E, d, h)``/``(E, h, d)``: the expert dim over
      ``expert``, inner dims Megatron-split like the dense MLP
    - other matrices FSDP-sharded over ``fsdp`` when present; everything
      else (norms, biases) replicated
    - a :class:`~unionml_tpu_torch.ops.quant.QuantizedArray` takes the
      kernel's spec for its codes and keeps, for its scale, only the axes
      where the scale has extent (the output channel)

    The entries are JAX's with each ``nn.Linear`` weight's two dimensions
    flipped (``(out, in)`` against flax's ``(in, out)``). The ``qkv`` spec
    also carries ``parts=3``: its rows are q, k and v, each split on its own
    (see :class:`~unionml_tpu_torch.parallel.mesh.Spec`)."""
    from unionml_tpu_torch.models._sharding import shard_by_rules
    from unionml_tpu_torch.ops.quant import QuantizedArray
    from unionml_tpu_torch.parallel.ep import EXPERT_AXIS
    from unionml_tpu_torch.parallel.mesh import FSDP_AXIS, TENSOR_AXIS, Spec

    tensor = TENSOR_AXIS if TENSOR_AXIS in mesh_axis_names else None
    fsdp = FSDP_AXIS if FSDP_AXIS in mesh_axis_names else None
    expert = EXPERT_AXIS if EXPERT_AXIS in mesh_axis_names else None

    def dense_spec(path_str: str, leaf) -> Spec:
        ndim = len(leaf.shape)
        if "w_in" in path_str and ndim == 3:
            return Spec(expert, fsdp, tensor)
        if "w_out" in path_str and ndim == 3:
            return Spec(expert, tensor, fsdp)
        if ndim < 2:
            return Spec()
        if "wte" in path_str or "wpe" in path_str:
            return Spec(tensor, None)
        if "qkv" in path_str:
            return Spec(tensor, fsdp, parts=3)
        if "mlp_up" in path_str:
            return Spec(tensor, fsdp)
        if "attn_out" in path_str or "mlp_down" in path_str:
            return Spec(fsdp, tensor)
        return Spec(None, fsdp)

    def spec_for(path: Tuple[str, ...], leaf):
        path_str = "/".join(path)
        if isinstance(leaf, QuantizedArray):
            base = dense_spec(path_str, leaf.q)
            entries = tuple(base) + (None,) * (leaf.q.dim() - len(base))
            scale = Spec(*(axis if leaf.scale.shape[i] > 1 else None for i, axis in enumerate(entries)),
                         parts=base.parts)
            return QuantizedArray(q=base, scale=scale, dtype=leaf.dtype)
        return dense_spec(path_str, leaf)

    return shard_by_rules(params, spec_for, is_leaf=lambda leaf: isinstance(leaf, QuantizedArray))


def kv_cache_spec(config: GPTConfig, mesh_axis_names: Tuple[str, ...]) -> Any:
    """Spec of KV-cache leaves ``(batch, heads, max_len, head_dim)``: heads on
    ``tensor`` (``gpt.py:659-674``), the split ``param_shardings`` gives
    ``qkv``, so each rank holds exactly the K/V its attention shard produces.
    The engine replicates the cache where the axis does not divide the heads."""
    from unionml_tpu_torch.parallel.mesh import TENSOR_AXIS, Spec

    return Spec(None, TENSOR_AXIS if TENSOR_AXIS in mesh_axis_names else None, None, None)


def kv_block_spec(config: GPTConfig, mesh_axis_names: Tuple[str, ...]) -> Any:
    """Spec of KV block-pool leaves ``(blocks, heads, block_size, head_dim)``
    (and their ``(blocks, heads, 1, 1)`` int8 scales): heads on ``tensor``,
    exactly like :func:`kv_cache_spec`, so pool and cache blocks move
    between each other shard-local."""
    return kv_cache_spec(config, mesh_axis_names)


def tensor_parallel(model: GPTLMHeadModel, mesh: Any, trainable: bool = False
                    ) -> Tuple[GPTLMHeadModel, Dict[str, Any]]:
    """``(this rank's model, its weight tree)``: a copy of ``model`` (which
    every rank holds whole, from the same seed or checkpoint, and which is
    left untouched) whose weights are this rank's shares under
    :func:`param_shardings`, and whose forward runs the mesh's collectives.
    A mesh that splits nothing gives ``model`` itself (every rank computes
    the same): ``data`` and ``sequence`` axes never split a decode.

    - ``tensor``: the Megatron split (heads, MLP, vocabulary). Where the
      axis does not divide the heads, ``qkv`` stays whole on every rank.
      Sparse blocks split every expert's hidden width like the dense MLP.
    - ``fsdp`` (serving): each rank keeps at rest its ``1/N`` of every leaf
      whose spec names ``fsdp`` (the decoder blocks' matrices and expert
      stacks, after the tensor and expert cuts), and each block all-gathers
      its weights into one whole buffer per shape, shared by the blocks,
      just before it computes (:func:`~unionml_tpu_torch.models._sharding.split_fsdp_weights`).
      The tree returned holds the pieces.
    - ``expert`` (serving): each rank holds ``E / ep`` experts of every
      sparse block and the dropless layer sums its experts' partial outputs
      over the axis (:class:`~unionml_tpu_torch.models.moe.MoEMlp`). A model
      whose ``ep_mesh`` splits its experts keeps its share as it is. Beside
      ``tensor`` each rank holds its experts' column/row share and the
      partial outputs are summed over expert×tensor in f32.

    Raises JAX's ``ValueError`` where an axis does not divide a sharded
    dimension (the vocabulary, the positions, the MLP, an fsdp-split
    matrix). ``trainable=True`` (the train
    step's layout) cuts the tensor axis only, into shards that take
    gradients, and leaves the data, fsdp and expert axes to the train step.

    The copy's ``tp_partial`` names the parameters whose gradients are each
    rank's part of a sum over the tensor axis: the row-parallel biases, which
    rank 0 alone adds, and a whole ``qkv`` under an axis that does not divide
    the heads (each rank's attention output feeds only its slice)."""
    from unionml_tpu_torch.models._sharding import shard_model, split_fsdp_weights, weight_tree
    from unionml_tpu_torch.ops.quant import QuantizedArray
    from unionml_tpu_torch.parallel.mesh import (
        EXPERT_AXIS, FSDP_AXIS, TENSOR_AXIS, Spec, axis_index, axis_names, axis_size,
    )

    cfg = model.config
    names = axis_names(mesh)
    check_serving_experts(model, mesh)
    tree = weight_tree(model)
    # a model whose ep_mesh splits its experts holds its share already
    held = cfg.moe_every > 0 and axis_size(cfg.ep_mesh, EXPERT_AXIS) > 1
    cut_experts = not trainable and cfg.moe_every > 0 and not held and axis_size(mesh, EXPERT_AXIS) > 1
    # a one-rank fsdp axis splits too (into one piece): a world of 1 runs every line
    fsdp = not trainable and FSDP_AXIS in names
    if TENSOR_AXIS not in names and not cut_experts and not fsdp:
        return model, tree
    tensor = TENSOR_AXIS in names
    n = axis_size(mesh, TENSOR_AXIS)
    split_heads = cfg.num_heads % n == 0
    specs = param_shardings(tree, names)
    for name in specs:
        spec = specs[name]
        # a rank computes its columns' product whole: the column-parallel
        # biases split with their outputs (JAX replicates them and XLA slices)
        column = ".qkv." in name or ".mlp_up." in name
        if tensor and ".qkv." in name and not split_heads:
            spec = Spec()
        elif tensor and column and name.endswith("bias"):
            spec = Spec(TENSOR_AXIS, parts=3 if ".qkv." in name else 1)
        elif held and name.endswith((".w_in", ".w_out")):
            spec = Spec(None, *spec[1:])
        else:
            continue
        specs[name] = QuantizedArray(q=spec, scale=spec, dtype=tree[name].dtype) \
            if isinstance(tree[name], QuantizedArray) else spec
    tp = TensorParallel(group=mesh.get_group(TENSOR_AXIS), size=n, index=axis_index(mesh, TENSOR_AXIS),
                        heads=cfg.num_heads // n if split_heads else cfg.num_heads,
                        split_heads=split_heads) if tensor else None
    partial = {name for name in tree if tensor and (name.endswith((".attn_out.bias", ".mlp_down.bias"))
                                                     or (not split_heads and ".qkv." in name))}
    shard, local = shard_model(model, mesh, specs, tp, (GPTLMHeadModel, DecoderBlock, MoEMlp), partial, trainable)
    for module in shard.modules():
        if isinstance(module, MoEMlp):
            if cut_experts:  # each sparse block runs its share of the experts over the mesh's expert axis
                module.mesh = mesh
            # read now, its expert×tensor group is made by every rank in the same order, not in a captured graph
            module.partial
    if fsdp:
        local = split_fsdp_weights(shard, local, specs, mesh, [(f"layers.{i}", block)
                                                               for i, block in enumerate(shard.layers)])
    return shard, local


def check_serving_experts(model: nn.Module, mesh: Any = None) -> None:
    """Serving splits the experts over the serving mesh's ``expert`` axis,
    or keeps the share a model's ``ep_mesh`` gives each rank: either way its
    sparse blocks sum their experts' outputs over the ranks (over
    expert×tensor beside a ``tensor`` axis), so a model whose experts are
    split serves only on a mesh (every rank builds the engine and follows
    rank 0; ``ValueError`` without one)."""
    from unionml_tpu_torch.parallel.mesh import EXPERT_AXIS, axis_size

    cfg = getattr(model, "config", None)
    if getattr(cfg, "moe_every", 0) <= 0:
        return
    held = axis_size(getattr(cfg, "ep_mesh", None), EXPERT_AXIS)
    if held > 1 and mesh is None:
        raise ValueError(f"this model's experts are split over the {held} ranks of its ep_mesh: serve it on a mesh "
                         "over the same world (mesh=config.ep_mesh), every rank building the engine")


def lm_targets(
    input_ids: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    span: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(targets, weights)`` of the next-token transitions of whole rows
    whose first token lies at ``[start, start + length)`` (``span``; every
    position when None): ``targets`` are the tokens at t+1, ``weights`` None
    when each transition counts alike, else the ``mask`` (1 = real token) at
    t+1 and, with ``segment_ids``, whether t and t+1 share a segment. The
    row's last position has no transition."""
    start, length = span if span is not None else (0, input_ids.shape[1])
    stop = min(start + length, input_ids.shape[1] - 1)
    targets = input_ids[:, start + 1:stop + 1]
    weights = None if mask is None else mask[:, start + 1:stop + 1].float()
    if segment_ids is not None:
        following = segment_ids[:, start + 1:stop + 1]
        same = (following == segment_ids[:, start:stop]) & (following > 0)
        weights = same.float() if weights is None else weights * same.float()
    return targets, weights


def lm_loss(
    logits: torch.Tensor,
    input_ids: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    span: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Next-token cross-entropy (``gpt.py:957-978``): logits at t predict
    ``input_ids`` at t+1, weighted by ``mask`` (1 = real token) at t+1. With
    ``segment_ids`` (packed rows) a transition counts only inside one
    segment: the last token of a packed sequence is not trained to predict
    the first token of the next, and padding is weighted 0.

    With ``span`` ``(start, length)`` (a sequence-parallel rank), ``logits``
    are those of the chunk at ``[start, start + length)`` and the ids, mask
    and segment ids the whole rows': the loss is the chunk's mean over the
    transitions from its own positions (:func:`lm_targets`)."""
    targets, weights = lm_targets(input_ids, mask, segment_ids, span)
    return cross_entropy_with_integer_labels(logits[:, :targets.shape[1]], targets, weights)


def import_hf_weights(hf_state_dict: Dict[str, Any], config: GPTConfig) -> Dict[str, Any]:
    """Map a HuggingFace GPT-2 state dict (torch tensors or numpy) onto the
    JAX-layout parameter tree that ``init_gpt(config, params=...)`` takes
    (``unionml_tpu/models/gpt.py:1050-1093``).

    Accepts ``GPT2Model`` or ``GPT2LMHeadModel`` state dicts (the latter's
    keys carry a ``transformer.`` prefix). HF GPT-2's Conv1D projections
    store their weights ``(in, out)``, the flax kernel layout, so they pass
    through as they are: :func:`~unionml_tpu_torch.models.convert.params_from_jax`
    transposes them into ``nn.Linear``'s ``(out, in)``. The LM head stays tied
    to ``wte``, as in this module.
    """
    if config.moe_every > 0:
        raise ValueError(
            "import_hf_weights supports dense GPT-2 checkpoints only: a sparse config "
            "(moe_every > 0) has expert parameters with no HF counterpart."
        )
    import numpy as np

    def t(name: str) -> "np.ndarray":
        value = hf_state_dict[name]
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        return np.asarray(value, dtype=np.float32)

    def conv1d(prefix: str) -> Dict[str, Any]:
        return {"kernel": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias")}

    def norm(prefix: str) -> Dict[str, Any]:
        return {"scale": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias")}

    prefix = "transformer." if any(key.startswith("transformer.") for key in hf_state_dict) else ""
    params: Dict[str, Any] = {
        "wte": {"embedding": t(f"{prefix}wte.weight")},
        "wpe": {"embedding": t(f"{prefix}wpe.weight")},
        "final_norm": norm(f"{prefix}ln_f"),
    }
    for i in range(config.num_layers):
        hf_layer = f"{prefix}h.{i}"
        params[f"layer_{i}"] = {
            "attn_norm": norm(f"{hf_layer}.ln_1"),
            "qkv": conv1d(f"{hf_layer}.attn.c_attn"),
            "attn_out": conv1d(f"{hf_layer}.attn.c_proj"),
            "mlp_norm": norm(f"{hf_layer}.ln_2"),
            "mlp_up": conv1d(f"{hf_layer}.mlp.c_fc"),
            "mlp_down": conv1d(f"{hf_layer}.mlp.c_proj"),
        }
    return {"params": params}
