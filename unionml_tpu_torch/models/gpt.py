"""GPT-style causal decoder (PyTorch) with dense and paged KV caches.

Port of ``unionml_tpu/models/gpt.py``: pre-LN decoder blocks, tanh-approximate
GELU, learned positions, a tied LM head with float32 logits, and the three
cache paths the serving engine drives:

- dense-cache prefill at position 0: causal attention over the chunk, the K1
  flash kernel on the card (``gpt.py:485-492``);
- paged per-row decode: the int8 (or full-precision) append into each row's
  tail block, then K4 over the block table (``gpt.py:386-466``);
- paged batch-1 chunk prefill: :func:`_paged_chunk_quantized`, then K4.

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
``config.dtype``. Not ported yet (each raises ``NotImplementedError`` naming
its ROADMAP item): the MoE and ring/ulysses layers, ``remat``, the
speculative-verify chunk (``_paged_verify_chunk`` / ``paged_commit_chunk``)
and ``param_shardings``.
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models._layers import _dense, _dropout, _layer_norm
from unionml_tpu_torch.ops.attention import attention, reference_attention
from unionml_tpu_torch.ops.losses import cross_entropy_with_integer_labels
from unionml_tpu_torch.ops.paged_attention import paged_attention

Device = Union[str, torch.device, None]

_IMPLS = ("auto", "kernel", "reference")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """GPT-2 small by default (``gpt.py:28-78``, minus the sequence- and
    expert-parallel fields, which the port has no counterpart for yet)."""

    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    #: dropout rate at the embeddings and after each block's two residual branches
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    #: dense attention: "auto" (K1 kernel on CUDA), "kernel", or "reference"
    attention_impl: str = "auto"
    #: paged attention: "auto" (K4 kernel on CUDA), "kernel", or "reference"
    paged_attn_impl: str = "auto"
    #: activation recompute for training forwards; not ported yet for GPT
    remat: bool = False

    def __post_init__(self) -> None:
        if self.remat:
            raise NotImplementedError("remat for GPT is not ported yet (ROADMAP: GPT remat, Queue 1)")
        for name in ("attention_impl", "paged_attn_impl"):
            value = getattr(self, name)
            if value in ("ring", "ulysses"):
                raise NotImplementedError(
                    f"{name}={value!r}: sequence-parallel attention is not ported yet "
                    "(ROADMAP: M12)"
                )
            if value not in _IMPLS:
                raise ValueError(f"{name} must be one of {_IMPLS}, got {value!r}")
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


class DecoderBlock(nn.Module):
    """Pre-LN block: attention then a tanh-GELU MLP, each with a residual."""

    def __init__(self, config: GPTConfig, device: torch.device) -> None:
        super().__init__()
        d, kw = config.hidden_size, dict(device=device, dtype=torch.float32)
        self.config = config
        self.attn_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)
        self.qkv = nn.Linear(d, 3 * d, **kw)
        self.attn_out = nn.Linear(d, d, **kw)
        self.mlp_norm = nn.LayerNorm(d, eps=config.layer_norm_eps, **kw)
        self.mlp_up = nn.Linear(d, 4 * d, **kw)
        self.mlp_down = nn.Linear(4 * d, d, **kw)

    def forward(
        self,
        hidden: torch.Tensor,
        cache: Optional[Dict[str, torch.Tensor]],
        position: Union[int, torch.Tensor, None],
        pad_offsets: Optional[torch.Tensor] = None,
        block_table: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """Full sequence (``cache=None``, optionally packed by
        ``segment_ids``), dense-cache or paged step. ``generator`` turns
        dropout on and draws its masks.

        Dense cache: ``{"k","v"}`` of shape (batch, heads, max_len, head_dim)
        and a scalar ``position``. Paged: pool leaves (num_blocks, heads,
        block_size, head_dim) shared by every row, ``block_table`` (batch,
        width), and either a (batch,) ``position`` tensor (single-token
        decode, each row at its own position) or an int (batch-1 chunk).
        """
        cfg = self.config
        batch, seq, _ = hidden.shape
        qkv = _dense(self.qkv, _layer_norm(self.attn_norm, hidden, cfg.dtype), cfg.dtype)

        def heads(x):
            return x.reshape(batch, seq, cfg.num_heads, cfg.head_dim).transpose(1, 2).contiguous()

        q, k, v = (heads(x) for x in qkv.split(cfg.hidden_size, dim=-1))

        def pad_mask(k_positions):
            # (batch, 1, 1, Lk): keys in a row's left-pad region contribute nothing
            return (k_positions[None, :] >= pad_offsets[:, None])[:, None, None, :]

        new_cache = cache
        if cache is None:
            if segment_ids is not None:
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
            context = self._paged(q, k, v, cache, position, block_table, pad_offsets)
        else:
            context = self._dense(q, k, v, cache, position, pad_offsets, pad_mask)

        context = context.transpose(1, 2).reshape(batch, seq, cfg.hidden_size)
        hidden = hidden + _dropout(_dense(self.attn_out, context, cfg.dtype), cfg.dropout, generator)
        normed = _layer_norm(self.mlp_norm, hidden, cfg.dtype)
        up = F.gelu(_dense(self.mlp_up, normed, cfg.dtype), approximate="tanh")
        return hidden + _dropout(_dense(self.mlp_down, up, cfg.dtype), cfg.dropout, generator), new_cache

    def _dense(self, q, k, v, cache, position, pad_offsets, pad_mask):
        cfg = self.config
        seq = q.shape[2]
        if _per_row(position):
            raise NotImplementedError(
                "per-row positions on a dense cache (the paged=False engine) are not ported "
                "yet (ROADMAP: DecodeEngine prefix cache / pipelining slice)"
            )
        position = int(position)
        cache["k"][:, :, position:position + seq] = k.to(cache["k"].dtype)
        cache["v"][:, :, position:position + seq] = v.to(cache["v"].dtype)
        if seq > 1 and position == 0:
            # start-of-sequence prefill: plain causal attention over the chunk
            # is exact (the K1 kernel on the card); ragged rows add the pad mask
            if pad_offsets is None:
                return attention(q, k, v, causal=True, impl=cfg.attention_impl)
            return reference_attention(
                q, k, v, causal=True, mask=pad_mask(torch.arange(seq, device=q.device))
            )
        k_pos = torch.arange(cache["k"].shape[2], device=q.device)
        q_pos = position + torch.arange(seq, device=q.device)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None, :, :]
        if pad_offsets is not None:
            mask = mask & pad_mask(k_pos)
        return reference_attention(q, cache["k"], cache["v"], mask=mask)

    def _paged(self, q, k, v, cache, position, block_table, pad_offsets):
        cfg = self.config
        batch, _, seq, _ = q.shape
        if pad_offsets is not None:
            raise ValueError("paged decode does not support pad_offsets (left-padded rows)")
        per_row = _per_row(position)
        if per_row and seq != 1:
            raise NotImplementedError(
                "multi-token per-row paged steps (speculative verify) are not ported yet "
                "(ROADMAP: speculation slice)"
            )
        block_size = cache["k"].shape[2]
        capacity = block_table.shape[1] * block_size
        quantized = "k_scale" in cache
        if per_row:
            # decode: each row appends one token into its own tail block
            pos = torch.clamp(position.long(), 0, capacity - 1)
            blk, off = pos // block_size, pos % block_size
            dst = torch.gather(block_table.long(), 1, blk[:, None])[:, 0]
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
        self.layers = nn.ModuleList(DecoderBlock(config, device) for _ in range(config.num_layers))
        self.final_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, **kw)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(
        self,
        input_ids: torch.Tensor,
        cache: Optional[Dict[str, Any]] = None,
        position: Union[int, torch.Tensor, None] = None,
        pad_offsets: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        """Logits ``(batch, seq, vocab)`` f32, and the updated cache when one
        is given. ``pad_offsets`` (batch,) batches LEFT-padded ragged rows: each
        row's positions start at its first real token and its pad region is
        masked. A ``cache`` carrying a ``"table"`` key selects paged decoding
        (see :func:`init_block_pool`). ``segment_ids`` (batch, seq) packs
        several sequences per row (0 = padding; training only, no cache):
        attention stays inside each segment and positions restart at every id
        change. With ``deterministic=False`` dropout is on and draws its masks
        from ``generator``. Inference callers run this under ``torch.no_grad()``."""
        if deterministic:
            generator = None
        elif generator is None:
            raise ValueError("deterministic=False draws dropout masks from `generator`; pass one")
        if segment_ids is not None and cache is not None:
            raise ValueError("segment_ids is a packed-TRAINING feature; decode caches are unpacked")
        cfg = self.config
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
        elif _per_row(position):
            positions = torch.clamp(position.long()[:, None] + steps[None, :], 0, cfg.max_position_embeddings - 1)
        else:
            positions = (int(position) + steps)[None, :]
        if pad_offsets is not None:
            positions = torch.clamp(positions - pad_offsets.long()[:, None], min=0)
        word = F.embedding(input_ids, self.wte.weight).to(cfg.dtype)
        hidden = _dropout(word + F.embedding(positions, self.wpe.weight).to(cfg.dtype), cfg.dropout, generator)

        new_cache: Dict[str, Any] = {}
        block_table = cache.get("table") if cache is not None else None
        for i, layer in enumerate(self.layers):
            layer_cache = None if cache is None else cache[f"layer_{i}"]
            hidden, layer_cache = layer(hidden, layer_cache, position, pad_offsets, block_table, segment_ids,
                                        generator)
            if layer_cache is not None:
                new_cache[f"layer_{i}"] = layer_cache
        if block_table is not None:
            new_cache["table"] = block_table
        hidden = _layer_norm(self.final_norm, hidden, cfg.dtype)
        # tied head with genuinely-f32 logits: f32 hidden states times the f32 embedding
        logits = hidden.float() @ self.wte.weight.t()
        return (logits, new_cache) if cache is not None else logits


def init_cache(config: GPTConfig, batch: int, max_len: Optional[int] = None, dtype=None,
               device: Device = "cuda") -> Dict[str, Any]:
    """Zeroed dense KV cache (config's compute dtype) for incremental decoding."""
    device = resolve_device(device)
    max_len = max_len or config.max_position_embeddings
    dtype = dtype if dtype is not None else config.dtype
    shape = (batch, config.num_heads, max_len, config.head_dim)
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
) -> Dict[str, Any]:
    """Zeroed KV block pool, ``(num_blocks, heads, block_size, head_dim)`` per
    layer. ``kv_quantize="int8"`` stores int8 codes with per-(block, head) f32
    scales (``k_scale``/``v_scale``, shape ``(blocks, heads, 1, 1)``); layers in
    ``kv_quantize_skip_layers`` keep full-precision leaves and no scales — the
    attention layer detects the mode per layer from the keys present."""
    device = resolve_device(device)
    dtype = dtype if dtype is not None else config.dtype
    if kv_quantize not in (None, "int8"):
        raise ValueError(f"kv_quantize must be None or 'int8', got {kv_quantize!r}")
    skip = frozenset(int(i) for i in kv_quantize_skip_layers)
    shape = (num_blocks, config.num_heads, block_size, config.head_dim)
    scale_shape = (num_blocks, config.num_heads, 1, 1)
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

    cache = init_cache(config, batch, max_len, device=device)
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


def _not_ported(name: str, item: str):
    def fail(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP: {item})")

    fail.__name__ = name
    return fail


paged_commit_chunk = _not_ported("paged_commit_chunk", "speculation slice")
param_shardings = _not_ported("param_shardings", "mesh-sharded serving")


def lm_loss(
    logits: torch.Tensor,
    input_ids: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next-token cross-entropy (``gpt.py:957-978``): logits at t predict
    ``input_ids`` at t+1, weighted by ``mask`` (1 = real token) at t+1. With
    ``segment_ids`` (packed rows) a transition counts only inside one
    segment: the last token of a packed sequence is not trained to predict
    the first token of the next, and padding is weighted 0."""
    shifted = logits[:, :-1, :]
    targets = input_ids[:, 1:]
    weights = None if mask is None else mask[:, 1:].float()
    if segment_ids is not None:
        same = (segment_ids[:, 1:] == segment_ids[:, :-1]) & (segment_ids[:, 1:] > 0)
        weights = same.float() if weights is None else weights * same.float()
    return cross_entropy_with_integer_labels(shifted, targets, weights)
