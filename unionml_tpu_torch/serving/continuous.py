"""Continuous batching for GPT generation over a paged KV pool.

Port of the paged subset of ``unionml_tpu/serving/continuous.py``
(``DecodeEngine``, ``:166-2763``; ``ContinuousBatcher``, ``:2766-2829``).
One decode step runs over a fixed set of slots; requests are inserted into
free slots between steps and evicted when they finish.

- The KV cache is a block POOL shared by all slots: ``(num_blocks, heads,
  block_size, head_dim)`` per layer, int8 codes plus per-(block, head) f32
  scales under ``kv_quantize="int8"``. A slot owns a block-table row and a
  length; admission allocates ``ceil(min(prompt + budget, max_len) /
  block_size)`` blocks and a shortfall raises
  ``EngineFailure(reason="pool_exhausted")``.
- The table's trailing column always points at a reserved scratch block, and a
  retired row decodes at the sentinel position ``(width - 1) * block_size``,
  so its unavoidable write lands in scratch, never in a block another slot
  now owns (``continuous.py:721-728``).
- Prefill is batched per bucket: queued prompts sharing a bucket prefill
  together, up to ``prefill_batch`` rows at a time (dense causal attention,
  the K1 kernel), then every row is quantized block by block into its pool
  blocks with positions past its real length masked to zero. Prompts longer
  than ``prefill_chunk`` prefill one chunk per :meth:`DecodeEngine.step`
  straight through the table (paged attention, the K4 kernel).
- Slot lifecycle (``active``/``remaining``) lives on the device and retires
  inside the step (``advance_slot_state``); the host replays the fetched
  tokens into its mirrors, one device-to-host copy per step burst.
- A slot whose logits went NaN/Inf is quarantined alone (its request fails
  with ``nan_logits``); its neighbours keep decoding.

Not ported yet: the prefix cache, depth-1 dispatch-ahead pipelining,
preemption, salvage and rebuild, fault plans, telemetry, mesh sharding,
weight-int8 ``quantize`` and the dense ``paged=False`` engine.
"""

import asyncio
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.models.gpt import (
    advance_slot_state,
    block_table_width,
    init_block_pool,
    init_block_tables,
    init_cache,
    init_slot_state,
)
from unionml_tpu_torch.ops.quant import quantize_blockwise
from unionml_tpu_torch.ops.sampling import sample_logits, validate_sampling
from unionml_tpu_torch.serving.faults import EngineFailure
from unionml_tpu_torch.serving.scheduler import FifoQueue, Ticket

__all__ = ["ContinuousBatcher", "DecodeEngine", "StepEvent", "block_demand"]

#: default prompt-prefill bucket lengths (right-padded)
DEFAULT_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)


def block_demand(prompt_len: int, budget: int, *, max_len: int, block_size: int) -> int:
    """Pool blocks one request needs for its whole lifetime: prompt plus
    budget, capped at cache capacity, rounded up to whole blocks."""
    need = min(int(prompt_len) + int(budget), int(max_len))
    return -(-need // int(block_size))


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One slot's outcome for one engine step."""

    slot: int
    token: int
    #: False for an EOS token (consumed, not part of the completion)
    emit: bool
    finished: bool
    #: failure slug when the ENGINE terminated this request (``nan_logits``);
    #: the event carries no token and the consumer must fail the request
    error: Optional[str] = None


class _BlockAllocator:
    """Free list of pool block ids (the JAX engine's ``PrefixCache`` doubles
    as its allocator; without the prefix cache a free list is all it does)."""

    def __init__(self, num_blocks: int) -> None:
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks))

    def available_blocks(self) -> int:
        return len(self._free)

    def alloc_blocks(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        ids, self._free = self._free[:n], self._free[n:]
        return ids

    def free_blocks(self, ids: Sequence[int]) -> None:
        self._free.extend(int(i) for i in ids)


class DecodeEngine:
    """Slot-based continuous-batching decode engine over a paged KV pool.

    :param model: a :class:`~unionml_tpu_torch.models.gpt.GPTLMHeadModel` on
        ``device``.
    :param num_slots: concurrent sequences (the decode batch).
    :param max_len: per-slot capacity (prompt + generated tokens); a slot
        force-finishes when its length reaches ``max_len - 1``.
    :param eos_token_id: token that terminates a completion (not emitted).
    :param temperature: default sampling temperature (0 = greedy).
    :param prefill_buckets: allowed padded prompt lengths; prompts longer than
        the largest bucket are rejected with ``ValueError``.
    :param seed: seeds the engine's ``torch.Generator`` for sampled slots.
    :param prefill_batch: max prompts prefilled together per bucket.
    :param prefill_chunk: prompts longer than this prefill in chunks of this
        many tokens, one chunk per :meth:`step`, through the block table.
    :param block_size: tokens per pool block (clamped to ``max_len``).
    :param pool_blocks: pool size in blocks including the scratch block;
        ``None`` sizes it so a free slot can always allocate
        (``num_slots * ceil(max_len / block_size) + 1``).
    :param kv_quantize: ``"int8"`` stores the pool as int8 codes with
        per-(block, head) f32 scales; ``None`` keeps the compute dtype.
    :param kv_quantize_skip_layers: layers whose pool stays full precision.
    :param paged: must be True (the dense engine is not ported yet).
    :param device: ``"cuda"`` (default; raises without a CUDA device) or
        ``"cpu"`` for the plain PyTorch path.
    """

    def __init__(
        self,
        model: Any,
        *,
        num_slots: int = 8,
        max_len: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        temperature: float = 0.0,
        prefill_buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS,
        seed: int = 0,
        prefill_batch: int = 4,
        prefill_chunk: Optional[int] = None,
        block_size: int = 16,
        pool_blocks: Optional[int] = None,
        kv_quantize: Optional[str] = None,
        kv_quantize_skip_layers: Sequence[int] = (),
        paged: bool = True,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        if not paged:
            raise NotImplementedError(
                "the dense (paged=False) engine is not ported yet (ROADMAP: DecodeEngine "
                "prefix cache / pipelining slice)"
            )
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine device is {self.device}")
        config = model.config
        max_len = max_len or config.max_position_embeddings
        if max_len > config.max_position_embeddings:
            raise ValueError(
                f"max_len ({max_len}) exceeds max_position_embeddings ({config.max_position_embeddings})"
            )
        if kv_quantize not in (None, "int8"):
            raise ValueError(f"Unknown kv_quantize mode {kv_quantize!r}; expected None or 'int8'")
        self._model = model
        self._config = config
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.prefill_batch = max(1, int(prefill_batch))
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self._buckets = tuple(sorted(b for b in prefill_buckets if b <= max_len)) or (max_len - 1,)
        self.kv_quantize = kv_quantize
        self.kv_quantize_skip_layers = tuple(int(i) for i in kv_quantize_skip_layers)
        if any(i < 0 or i >= config.num_layers for i in self.kv_quantize_skip_layers):
            raise ValueError(
                f"kv_quantize_skip_layers {self.kv_quantize_skip_layers} out of range "
                f"for {config.num_layers} layers"
            )
        self.block_size = min(int(block_size), self.max_len)
        self._table_width = block_table_width(self.max_len, self.block_size)
        if pool_blocks is None:
            pool_blocks = self.num_slots * (self._table_width - 1) + 1
        if int(pool_blocks) < 2:
            raise ValueError(f"pool_blocks must be >= 2 (1 usable + scratch), got {pool_blocks}")
        self.pool_blocks = int(pool_blocks)
        #: reserved block absorbing retired rows' masked writes; never allocated
        self._scratch_block = self.pool_blocks - 1
        self._allocator = _BlockAllocator(self.pool_blocks - 1)
        self._slot_blocks: Dict[int, List[int]] = {}

        # host mirrors (authoritative for scheduling; device tensors follow them)
        self._active = np.zeros(num_slots, dtype=bool)
        #: slots holding an in-progress chunked prefill: neither active nor free
        self._reserved = np.zeros(num_slots, dtype=bool)
        self._partials: Dict[int, Dict[str, Any]] = {}
        self._lens_host = np.zeros(num_slots, dtype=np.int64)
        self._remaining = np.zeros(num_slots, dtype=np.int64)
        self._slot_temp = np.full(num_slots, self.temperature, dtype=np.float32)
        #: requests terminated by the NaN/Inf-logits quarantine
        self.quarantined_requests = 0

        dev = self.device
        self._pool = init_block_pool(
            config, self.pool_blocks, self.block_size, kv_quantize=kv_quantize,
            kv_quantize_skip_layers=self.kv_quantize_skip_layers, device=dev,
        )
        self._tables = init_block_tables(num_slots, self.max_len, self.block_size, self._scratch_block, device=dev)
        self._lens = torch.zeros((num_slots,), dtype=torch.int32, device=dev)  # K4 takes int32 positions
        self._last_logits = torch.zeros((num_slots, config.vocab_size), dtype=torch.float32, device=dev)
        self._active_dev, self._remaining_dev = init_slot_state(num_slots, device=dev)
        self._temp_dev = torch.full((num_slots,), self.temperature, dtype=torch.float32, device=dev)
        self._top_k_dev = torch.zeros((num_slots,), dtype=torch.int64, device=dev)
        self._top_p_dev = torch.ones((num_slots,), dtype=torch.float32, device=dev)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(int(seed))

    # ------------------------------------------------------------ scheduling

    @property
    def free_slots(self) -> List[int]:
        return [int(s) for s in np.flatnonzero(~(self._active | self._reserved))]

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    @property
    def has_pending_prefill(self) -> bool:
        """Whether a chunked prefill is in progress (the engine must keep
        stepping even with nothing decoding)."""
        return bool(self._partials)

    def bucket_for(self, prompt_len: int) -> int:
        for bucket in self._buckets:
            if bucket >= prompt_len:
                return bucket
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill bucket "
            f"({self._buckets[-1]}); raise prefill_buckets/max_len or truncate"
        )

    def _chunkable(self, prompt_len: int) -> bool:
        chunk = self.prefill_chunk
        return chunk is not None and prompt_len > chunk and -(-prompt_len // chunk) * chunk <= self.max_len

    def block_demand(self, prompt_len: int, budget: int) -> int:
        return block_demand(prompt_len, budget, max_len=self.max_len, block_size=self.block_size)

    def available_blocks(self) -> int:
        return self._allocator.available_blocks()

    def validate_request(
        self, prompt_ids: Sequence[int], max_new_tokens: int, *,
        temperature: Optional[float] = None, top_k: int = 0, top_p: float = 1.0,
    ) -> Tuple[np.ndarray, int, float, int, float]:
        """Normalize one request, raising ``ValueError`` for anything the engine
        cannot serve. Returns ``(prompt, budget, temperature, top_k, top_p)``."""
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size >= self.max_len:
            raise ValueError(f"prompt length {prompt.size} >= max_len ({self.max_len})")
        if prompt.min() < 0 or prompt.max() >= self._config.vocab_size:
            raise ValueError(f"token ids must lie in [0, {self._config.vocab_size})")
        temperature, top_k, top_p = validate_sampling(temperature, top_k, top_p)
        temperature = self.temperature if temperature is None else temperature
        self.bucket_for(prompt.size)  # raises for prompts beyond the bucket ladder
        demand = self.block_demand(prompt.size, max_new_tokens)
        if demand > self._allocator.num_blocks:
            raise ValueError(
                f"request needs {demand} KV blocks but the pool has only "
                f"{self._allocator.num_blocks}; raise pool_blocks or lower max_new_tokens"
            )
        return prompt, int(max_new_tokens), float(temperature), int(top_k), float(top_p)

    # ---------------------------------------------------------- paged blocks

    def _alloc_slot_blocks(self, slot: int, need: int) -> List[int]:
        ids = self._allocator.alloc_blocks(need)
        if ids is None:
            raise EngineFailure(
                f"KV block pool exhausted: need {need} block(s), "
                f"{self._allocator.available_blocks()} free of {self._allocator.num_blocks}",
                reason="pool_exhausted", retryable=True,
            )
        self._slot_blocks[slot] = ids
        row = np.full((self._table_width,), self._scratch_block, dtype=np.int32)
        row[: len(ids)] = ids
        self._tables[slot] = torch.from_numpy(row).to(self.device)
        return ids

    def _free_slot_blocks(self, slot: int) -> None:
        ids = self._slot_blocks.pop(slot, None)
        if ids:
            self._allocator.free_blocks(ids)

    def _activate(self, slot: int, length: int, budget: int, temp: float, top_k: int, top_p: float) -> None:
        self._active[slot] = True
        self._reserved[slot] = False
        self._lens_host[slot] = length
        self._remaining[slot] = budget
        self._slot_temp[slot] = temp
        self._slot_device_update(slot, True, budget, temp, top_k, top_p)

    def _slot_device_update(self, slot, is_active, budget, temp, top_k, top_p) -> None:
        """Point-update one slot's device lifecycle and sampling controls."""
        self._active_dev[slot] = bool(is_active)
        self._remaining_dev[slot] = int(min(budget, np.iinfo(np.int32).max))
        self._temp_dev[slot] = float(temp)
        self._top_k_dev[slot] = int(top_k)
        self._top_p_dev[slot] = float(top_p)

    # -------------------------------------------------------------- admission

    def add_request(self, prompt_ids: Sequence[int], max_new_tokens: int, *,
                    temperature: Optional[float] = None, top_k: int = 0, top_p: float = 1.0) -> int:
        """Prefill ``prompt_ids`` into a free slot; returns the slot index. The
        single-request form of :meth:`admit_many`."""
        return self.admit_many(
            [(prompt_ids, max_new_tokens, dict(temperature=temperature, top_k=top_k, top_p=top_p))]
        )[0]

    def admit_many(self, requests: Sequence[Tuple]) -> List[int]:
        """Admit ``(prompt_ids, max_new_tokens[, sampling_dict])`` requests with
        batched bucket prefills; returns the slot of each request, in order.

        Every request validates before any device work; ``RuntimeError`` when
        fewer slots are free than requests. A failure part-way (e.g.
        ``pool_exhausted``) cancels the slots this call admitted and frees
        their blocks before it re-raises.
        """
        normalized = []
        for req in requests:
            sampling = dict(req[2]) if len(req) > 2 and req[2] else {}
            normalized.append(self.validate_request(req[0], req[1], **sampling))
        free = self.free_slots
        if len(normalized) > len(free):
            raise RuntimeError("no free decode slots")
        slots = free[: len(normalized)]
        try:
            groups: Dict[int, List[int]] = {}
            for slot, norm in zip(slots, normalized):
                if self._chunkable(norm[0].size):
                    self._start_chunked(slot, *norm)
                else:
                    groups.setdefault(self.bucket_for(norm[0].size), []).append(slot)
            self._flush_groups(groups, dict(zip(slots, normalized)))
        except Exception:
            for slot in slots:
                if self._active[slot] or self._reserved[slot]:
                    self.cancel(slot)
                else:
                    self._free_slot_blocks(slot)
            raise
        return slots

    def _flush_groups(self, groups: Dict[int, List[int]], slot_to_norm: Dict[int, Tuple]) -> None:
        """Per bucket, prefill up to ``prefill_batch`` rows together, then
        insert every row into its pool blocks."""
        for bucket, idxs in groups.items():
            for start in range(0, len(idxs), self.prefill_batch):
                chunk = idxs[start : start + self.prefill_batch]
                padded = np.zeros((len(chunk), bucket), dtype=np.int64)
                lengths = np.zeros((len(chunk),), dtype=np.int64)
                for r, slot in enumerate(chunk):
                    prompt, budget = slot_to_norm[slot][:2]
                    padded[r, : prompt.size] = prompt
                    lengths[r] = prompt.size
                    self._alloc_slot_blocks(slot, self.block_demand(prompt.size, budget))
                lengths_dev = torch.from_numpy(lengths).to(self.device)
                local_cache, last = self._prefill(torch.from_numpy(padded).to(self.device), lengths_dev)
                self._paged_insert(local_cache, last, torch.tensor(chunk, device=self.device), lengths_dev)
                for r, slot in enumerate(chunk):
                    self._activate(slot, int(lengths[r]), *slot_to_norm[slot][1:])

    def _prefill(self, prompt_ids: torch.Tensor, lengths: torch.Tensor):
        """Batched bucket prefill: right-padded rows, dense causal attention;
        each row's logits at its last REAL token."""
        rows, bucket = prompt_ids.shape
        local_cache = init_cache(self._config, rows, bucket, device=self.device)
        with torch.no_grad():  # the model's forward also trains; serving keeps no graph
            logits, local_cache = self._model(prompt_ids, cache=local_cache, position=0)
        idx = torch.clamp(lengths - 1, 0, bucket - 1)
        return local_cache, logits[torch.arange(rows, device=self.device), idx]

    def _paged_insert(self, local_cache, local_logits, slots, lengths) -> None:
        """Scatter a bucket prefill's dense K/V into the admitted slots' pool
        blocks through their table rows (``continuous.py:768-827``). Columns
        past a slot's allocation map to scratch. Quantized layers mask positions
        at/after a row's real length to zero, so bucket padding never inflates a
        block's absmax scale."""
        bs = self.block_size
        rows_tables = self._tables[slots].long()  # (rows, width)
        bucket = local_cache["layer_0"]["k"].shape[2]
        cols = torch.arange(bucket, device=self.device)
        dst = rows_tables[:, cols // bs]  # (rows, bucket)
        off = (cols % bs)[None, :]
        nb = -(-bucket // bs)
        dst_blocks = rows_tables[:, :nb]  # (rows, nb)
        pad = nb * bs - bucket
        valid = torch.arange(nb * bs, device=self.device).reshape(nb, bs)[None] < lengths[:, None, None]
        for name, layer in self._pool.items():
            for key in ("k", "v"):
                local = local_cache[name][key]  # (rows, heads, bucket, hd)
                if key + "_scale" in layer:
                    rows, heads, _, head_dim = local.shape
                    src = torch.nn.functional.pad(local.float(), (0, 0, 0, pad))
                    src = src.reshape(rows, heads, nb, bs, head_dim).transpose(1, 2)
                    src = torch.where(valid[:, :, None, :, None], src, torch.zeros_like(src))
                    codes, scale = quantize_blockwise(src, reduce_axes=(3, 4))
                    layer[key][dst_blocks] = codes
                    layer[key + "_scale"][dst_blocks] = scale
                else:
                    layer[key][dst, :, off, :] = local.transpose(1, 2).to(layer[key].dtype)
        self._lens[slots] = lengths.to(self._lens.dtype)
        self._last_logits[slots] = local_logits.float()

    # -------------------------------------------------------- chunked prefill

    def _start_chunked(self, slot: int, prompt: np.ndarray, budget: int,
                       temp: float, top_k: int, top_p: float) -> None:
        """Reserve ``slot`` for a chunked prefill: allocate its lifetime blocks
        now; every chunk then writes straight through the table."""
        self._alloc_slot_blocks(slot, self.block_demand(prompt.size, budget))
        self._reserved[slot] = True
        self._partials[slot] = {
            "prompt": prompt, "consumed": 0, "budget": budget, "temp": temp, "top_k": top_k, "top_p": top_p,
        }

    def _advance_partials(self) -> None:
        """Run ONE chunk of every in-progress chunked prefill; completed
        prefills seal their length and logits and activate."""
        chunk = self.prefill_chunk
        for slot in list(self._partials):
            state = self._partials[slot]
            prompt, consumed = state["prompt"], state["consumed"]
            take = min(chunk, prompt.size - consumed)
            ids = np.zeros((1, chunk), dtype=np.int64)
            ids[0, :take] = prompt[consumed : consumed + take]
            cache = {"table": self._tables[slot : slot + 1], **self._pool}
            with torch.no_grad():
                logits, _ = self._model(torch.from_numpy(ids).to(self.device), cache=cache, position=int(consumed))
            state["consumed"] = consumed + take
            if state["consumed"] < prompt.size:
                continue
            self._lens[slot] = int(prompt.size)
            self._last_logits[slot] = logits[0, take - 1]
            del self._partials[slot]
            self._activate(slot, prompt.size, state["budget"], state["temp"], state["top_k"], state["top_p"])

    # ------------------------------------------------------------------ decode

    def _decode_once(self, sampling: bool):
        """One decode step over every slot, on the device. Returns the
        step's ``(tokens, active-at-start, non-finite-logits)`` tensors."""
        last = self._last_logits
        active = self._active_dev
        bad = ~torch.isfinite(last).all(dim=-1)
        if sampling:
            tokens = sample_logits(last, self._generator, self._temp_dev, self._top_k_dev, self._top_p_dev)
        else:
            tokens = torch.argmax(last, dim=-1)
        # a retired row still writes one K/V column per step; the sentinel
        # position maps that write to the trailing scratch column
        sentinel = (self._table_width - 1) * self.block_size
        pos = torch.where(active, self._lens, torch.full_like(self._lens, sentinel))
        with torch.no_grad():
            logits, _ = self._model(tokens[:, None], cache={"table": self._tables, **self._pool}, position=pos)
        new_lens = torch.where(active, torch.clamp(self._lens + 1, max=self.max_len - 1), self._lens)
        self._last_logits = torch.where(active[:, None], logits[:, -1, :], last)
        self._lens = new_lens
        self._active_dev, self._remaining_dev = advance_slot_state(
            active, self._remaining_dev, new_lens, tokens, self.max_len, self.eos_token_id
        )
        return tokens, active, bad

    def step(self, lookahead: int = 1) -> List[StepEvent]:
        """Advance chunked prefills by one chunk, then decode ``lookahead``
        steps for every active slot with ONE device-to-host fetch; returns the
        per-slot events. Retirement runs on the device inside the burst, so a
        burst emits exactly what ``lookahead`` single steps would."""
        events: List[StepEvent] = []
        if self._partials:
            self._advance_partials()
        if not self._active.any():
            return events
        room = np.minimum(self._remaining[self._active], (self.max_len - 1) - self._lens_host[self._active])
        steps = max(1, min(int(lookahead), int(room.max())))
        sampling = bool((self._slot_temp[self._active] > 0).any())
        burst = [self._decode_once(sampling) for _ in range(steps)]
        tokens, masks, bads = (torch.stack(x).cpu().numpy() for x in zip(*burst))
        for i in range(steps):
            for slot in np.flatnonzero(masks[i]):
                slot = int(slot)
                if not self._active[slot]:
                    continue  # quarantined earlier in this burst
                if bads[i, slot]:
                    events.append(self._quarantine(slot))
                else:
                    events.append(self._apply_token(slot, int(tokens[i, slot])))
        return events

    def _apply_token(self, slot: int, token: int) -> StepEvent:
        """Advance the host mirrors for one decoded token (the rule
        ``advance_slot_state`` applies on the device)."""
        self._remaining[slot] -= 1
        self._lens_host[slot] = min(self._lens_host[slot] + 1, self.max_len - 1)
        is_eos = self.eos_token_id is not None and token == self.eos_token_id
        finished = is_eos or self._remaining[slot] <= 0 or self._lens_host[slot] >= self.max_len - 1
        if finished:
            self._active[slot] = False
            self._free_slot_blocks(slot)
        return StepEvent(slot=slot, token=token, emit=not is_eos, finished=bool(finished))

    def _quarantine(self, slot: int) -> StepEvent:
        """Terminate ONE slot whose logits went NaN/Inf; siblings keep decoding."""
        self.quarantined_requests += 1
        self._release(slot)
        logger.warning("slot %d quarantined: non-finite logits", slot)
        return StepEvent(slot=slot, token=-1, emit=False, finished=True, error="nan_logits")

    def _release(self, slot: int) -> None:
        self._active[slot] = False
        self._reserved[slot] = False
        self._remaining[slot] = 0
        self._slot_temp[slot] = self.temperature
        self._partials.pop(slot, None)
        self._free_slot_blocks(slot)
        self._slot_device_update(slot, False, 0, self.temperature, 0, 1.0)

    def cancel(self, slot: int) -> None:
        """Deactivate one slot (its request is abandoned; the slot is reusable)."""
        self._release(slot)

    def abort_all(self) -> None:
        """Deactivate every slot and return every block."""
        for slot in range(self.num_slots):
            self._release(slot)

    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int, *, lookahead: int = 1,
                 temperature: Optional[float] = None, top_k: int = 0, top_p: float = 1.0) -> List[int]:
        """Run one request to completion on an otherwise idle engine and return
        its emitted tokens."""
        slot = self.add_request(prompt_ids, max_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p)
        out: List[int] = []
        while self._active[slot] or slot in self._partials:
            for event in self.step(lookahead):
                if event.slot == slot and event.emit:
                    out.append(event.token)
        return out


class _FutureSink:
    """Buffers emitted tokens; resolves an asyncio future with the full list."""

    cancelled = False

    def __init__(self, loop: asyncio.AbstractEventLoop, future: asyncio.Future) -> None:
        self._loop = loop
        self._future = future
        self._tokens: List[int] = []

    def emit(self, token: int) -> None:
        self._tokens.append(token)

    def finish(self) -> None:
        tokens = list(self._tokens)
        self._loop.call_soon_threadsafe(lambda: self._future.done() or self._future.set_result(tokens))

    def fail(self, exc: BaseException) -> None:
        self._loop.call_soon_threadsafe(lambda: self._future.done() or self._future.set_exception(exc))


_STREAM_DONE = object()


class _QueueSink:
    """Forwards each token to an asyncio queue as it decodes (streaming)."""

    cancelled = False

    def __init__(self, loop: asyncio.AbstractEventLoop, queue: "asyncio.Queue") -> None:
        self._loop = loop
        self._queue = queue

    def emit(self, token: int) -> None:
        self._loop.call_soon_threadsafe(self._queue.put_nowait, token)

    def finish(self) -> None:
        self._loop.call_soon_threadsafe(self._queue.put_nowait, _STREAM_DONE)

    def fail(self, exc: BaseException) -> None:
        self._loop.call_soon_threadsafe(self._queue.put_nowait, exc)


def _as_engine_failure(exc: BaseException, reason: str) -> EngineFailure:
    if isinstance(exc, EngineFailure):
        return exc
    return EngineFailure(f"{type(exc).__name__}: {exc}", reason=reason)


class ContinuousBatcher:
    """Asyncio facade running a :class:`DecodeEngine` on a worker thread.

    ``await generate(prompt_ids, max_new_tokens)`` enqueues a request and
    resolves with its completion; ``stream(...)`` yields tokens as they decode.
    The worker admits queued requests in arrival order into free slots (and
    only as far as the pool has blocks for them) between decode steps. At most
    ``max_queue`` requests wait; a submit beyond that raises
    :class:`~unionml_tpu_torch.serving.scheduler.QueueFullError`.

    :param lookahead: decode steps per device-to-host fetch.
    :param device: must name the engine's device; ``"cuda"`` (default) raises
        without a CUDA device.
    """

    def __init__(self, engine: DecodeEngine, *, lookahead: int = 1, max_queue: int = 256,
                 device="cuda") -> None:
        device = resolve_device(device)
        if device.type != engine.device.type:
            raise ValueError(f"engine runs on {engine.device}, batcher device is {device}")
        self._engine = engine
        self._lookahead = max(1, int(lookahead))
        self._queue = FifoQueue(max_queue)  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._lock = threading.Lock()
        self._work = threading.Event()
        #: slot -> sink; worker-thread-only
        self._sinks: Dict[int, Any] = {}
        self._worker: Optional[threading.Thread] = None

    @property
    def engine(self) -> DecodeEngine:
        return self._engine

    def _submit(self, prompt_ids, max_new_tokens, sink, sampling) -> None:
        # bad requests fail on the caller's side, not the worker's
        prompt, budget, *_ = self._engine.validate_request(prompt_ids, max_new_tokens, **sampling)
        ticket = Ticket(prompt=prompt, budget=budget, sampling=dict(sampling), sink=sink)
        with self._lock:
            if self._closed:
                raise EngineFailure("batcher is closed", reason="batcher_closed", retryable=False)
            self._queue.submit(ticket)
            if self._worker is None:
                self._worker = threading.Thread(target=self._run, name="continuous-batcher", daemon=True)
                self._worker.start()
        self._work.set()

    async def generate(self, prompt_ids: Sequence[int], max_new_tokens: int, **sampling) -> List[int]:
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        self._submit(prompt_ids, max_new_tokens, _FutureSink(loop, future), sampling)
        return await future

    async def stream(self, prompt_ids: Sequence[int], max_new_tokens: int, **sampling):
        """Async iterator of tokens, yielded as the engine decodes them;
        abandoning it early cancels the request's slot."""
        loop = asyncio.get_running_loop()
        queue: "asyncio.Queue" = asyncio.Queue()
        sink = _QueueSink(loop, queue)
        self._submit(prompt_ids, max_new_tokens, sink, sampling)
        try:
            while True:
                item = await queue.get()
                if item is _STREAM_DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            sink.cancelled = True

    def _deliver(self, sink: Any, method: str, *args) -> None:
        """Invoke a sink callback; a dead consumer costs only its request."""
        try:
            getattr(sink, method)(*args)
        except RuntimeError:
            logger.warning("sink %s delivery failed (consumer gone?); dropping request", method)

    def _take_admissible(self) -> List[Ticket]:
        """Pop queued tickets in arrival order while slots and pool blocks last
        (head-of-line: a ticket the pool cannot hold yet waits at the head)."""
        engine = self._engine
        free = len(engine.free_slots)
        avail = engine.available_blocks()
        batch: List[Ticket] = []
        with self._lock:
            while len(batch) < free:
                head = self._queue.peek()
                if head is None:
                    break
                if head.sink.cancelled:
                    self._queue.pop()
                    continue
                demand = engine.block_demand(head.prompt.size, head.budget)
                if demand > avail:
                    break
                avail -= demand
                batch.append(self._queue.pop())
        return batch

    def _admit(self) -> None:
        batch = self._take_admissible()
        if not batch:
            return
        try:
            slots = self._engine.admit_many([(t.prompt, t.budget, t.sampling) for t in batch])
        except Exception as exc:  # the engine rolled this call back: fail its tickets only
            logger.exception("admission failed")
            for ticket in batch:
                self._deliver(ticket.sink, "fail", _as_engine_failure(exc, "prefill_failed"))
            return
        for slot, ticket in zip(slots, batch):
            self._sinks[slot] = ticket.sink

    def _dispatch(self, events: Sequence[StepEvent]) -> None:
        for event in events:
            sink = self._sinks.get(event.slot)
            if sink is None:
                continue
            if sink.cancelled:  # consumer abandoned the stream mid-decode
                del self._sinks[event.slot]
                if not event.finished:
                    self._engine.cancel(event.slot)
                continue
            if event.error is not None:
                del self._sinks[event.slot]
                self._deliver(sink, "fail", EngineFailure(
                    f"request terminated by the engine: {event.error}", reason=event.error))
                continue
            if event.emit:
                self._deliver(sink, "emit", event.token)
            if event.finished:
                del self._sinks[event.slot]
                self._deliver(sink, "finish")

    def _fail_all(self, exc: BaseException) -> None:
        failure = _as_engine_failure(exc, "engine_failure")
        for sink in self._sinks.values():
            self._deliver(sink, "fail", failure)
        self._sinks.clear()
        self._engine.abort_all()

    def _run(self) -> None:
        engine = self._engine
        while True:
            with self._lock:
                if self._closed and not len(self._queue) and not self._sinks:
                    return
            self._admit()
            busy = engine.num_active or engine.has_pending_prefill
            if not busy:
                self._work.clear()
                with self._lock:
                    if len(self._queue) or self._closed:
                        continue
                self._work.wait(timeout=0.5)
                continue
            try:
                events = engine.step(self._lookahead)
            except Exception as exc:
                logger.exception("continuous-batching step failed")
                self._fail_all(exc)
                continue
            self._dispatch(events)

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop accepting requests, fail the queued ones with ``batcher_closed``,
        let running requests finish, and join the worker."""
        closed = EngineFailure("batcher closed", reason="batcher_closed", retryable=False)
        with self._lock:
            self._closed = True
            queued = self._queue.drain()
            worker = self._worker
        for ticket in queued:
            self._deliver(ticket.sink, "fail", closed)
        self._work.set()
        if worker is not None:
            worker.join(timeout=timeout_s)
            if worker.is_alive():
                raise RuntimeError(f"batcher worker did not stop within {timeout_s}s")
