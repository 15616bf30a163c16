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
- Each (lookahead, sampling) burst is one CUDA graph on the card (the
  counterpart of JAX's compiled step programs), over static device buffers
  that admission updates in place by index; the bucket and chunk prefills run
  eagerly between bursts. A steady-state step copies nothing from the host.
- Depth-1 dispatch-ahead (``pipeline=True``, the default): :meth:`DecodeEngine.step`
  enqueues burst N+1 (its graph, then asynchronous copies of its tokens into
  pinned host memory and an event) before it waits for burst N's event.
  :meth:`DecodeEngine._dispatch_step` and :meth:`DecodeEngine._replay_burst`
  are the seam the speculative engine overrides.
- A slot whose logits went NaN/Inf is quarantined alone (its request fails
  with ``nan_logits``); its neighbours keep decoding.

Not ported yet: the prefix cache, preemption, salvage and rebuild, fault
plans, telemetry, mesh sharding, weight-int8 ``quantize`` and the dense
``paged=False`` engine.
"""

import asyncio
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch import _graphs
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.models.gpt import (
    advance_slot_state,
    block_table_width,
    init_block_pool,
    init_block_tables,
    init_cache,
    init_slot_state,
    kv_pool_bytes,
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


@dataclasses.dataclass
class _Burst:
    """One dispatched device program: its ``(steps, num_slots)`` tokens,
    start-of-step activity masks and non-finite-logits flags. On the card they
    are pinned host buffers filled by asynchronous copies that ``ready``
    marks; on the CPU, the tensors themselves. ``round`` marks a speculative
    round's burst."""

    tokens: torch.Tensor
    masks: torch.Tensor
    bads: torch.Tensor
    steps: int
    ready: Any = None
    round: bool = False


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
    :param pipeline: depth-1 dispatch-ahead (default on): each :meth:`step`
        enqueues the next burst before it fetches the previous one, so the
        card decodes while the host applies tokens; events then arrive one
        call later. Streams equal ``pipeline=False``'s under the same calls.
    :param paged: must be True (the dense engine is not ported yet).
    :param prefix_cache_blocks / faults / telemetry / mesh: not ported yet;
        anything but the default raises ``NotImplementedError``.
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
        pipeline: bool = True,
        paged: bool = True,
        prefix_cache_blocks: int = 0,
        faults: Any = None,
        telemetry: Any = None,
        mesh: Any = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        for value, what, item in ((prefix_cache_blocks, "prefix_cache_blocks", "DecodeEngine prefix cache, slice 5"),
                                  (faults, "faults (FaultPlan)", "DecodeEngine fault plans, slice 5"),
                                  (telemetry, "telemetry", "DecodeEngine telemetry, slice 5"),
                                  (mesh, "mesh", "M12")):
            if value:
                raise NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")
        if not paged:
            raise NotImplementedError(
                "the dense (paged=False) engine is not ported yet (ROADMAP: DecodeEngine "
                "prefix cache / preemption slice)"
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
        self._seed = int(seed)
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

        #: depth-1 dispatch-ahead: enqueue burst N+1 before fetching burst N
        self.pipeline = bool(pipeline)
        #: the dispatched-but-unfetched burst, or None
        self._inflight: Optional[_Burst] = None
        #: slots quarantined while ``_inflight`` was already dispatched: its
        #: replay skips them (the slot may hold a new occupant by then)
        self._inflight_skip: set = set()
        #: events replayed by an out-of-band flush (cancel, admission), handed
        #: out by the next :meth:`step` or :meth:`take_pending_events`
        self._pending_events: List[StepEvent] = []
        #: device programs by key: CUDA graphs on the card (the counterpart of
        #: JAX's compiled step programs), empty on the CPU
        self._step_fns: Dict[Any, Any] = {}
        self.step_dispatches = 0
        self.idle_dispatches = 0
        self.ema_host_gap_ms: Optional[float] = None
        self.ema_fetch_block_ms: Optional[float] = None
        self._last_fetch_done: Optional[float] = None
        self._init_device_state()

    def _init_device_state(self) -> None:
        """Allocate the device state: the pool, the tables and every buffer a
        decode burst reads or writes. They are static: every later write is
        in place, so a captured burst keeps reading the live values."""
        dev, config = self.device, self._config
        self._pool = init_block_pool(
            config, self.pool_blocks, self.block_size, kv_quantize=self.kv_quantize,
            kv_quantize_skip_layers=self.kv_quantize_skip_layers, device=dev,
        )
        self._tables = init_block_tables(self.num_slots, self.max_len, self.block_size, self._scratch_block,
                                         device=dev)
        self._lens = torch.zeros((self.num_slots,), dtype=torch.int32, device=dev)  # K4 takes int32 positions
        self._last_logits = torch.zeros((self.num_slots, config.vocab_size), dtype=torch.float32, device=dev)
        self._active_dev, self._remaining_dev = init_slot_state(self.num_slots, device=dev)
        self._temp_dev = torch.full((self.num_slots,), self.temperature, dtype=torch.float32, device=dev)
        self._top_k_dev = torch.zeros((self.num_slots,), dtype=torch.int64, device=dev)
        self._top_p_dev = torch.ones((self.num_slots,), dtype=torch.float32, device=dev)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(self._seed)

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

    @property
    def has_pending_events(self) -> bool:
        """Events replayed by an out-of-band flush (cancel, admission) wait for
        the next :meth:`step`: a drive loop keeps ticking while any do."""
        return bool(self._pending_events)

    def take_pending_events(self) -> List[StepEvent]:
        """Drain the events an out-of-band flush buffered. A caller that keys
        requests by slot drains them right after :meth:`admit_many` or
        :meth:`cancel`, under the slot mapping from before the call: a flush
        can retire a slot's previous occupant, and its events are that
        occupant's."""
        events, self._pending_events = self._pending_events, []
        return events

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

    def kv_pool_stats(self) -> Dict[str, Any]:
        """Byte accounting of the resident KV pool (shapes only): ``kv_dtype``,
        ``kv_pool_bytes`` as stored (scales included) and
        ``kv_pool_bytes_dense_equiv`` at the compute dtype."""
        stored, full = kv_pool_bytes(self._pool, self._config.dtype)
        return {
            "kv_dtype": self.kv_quantize or str(self._config.dtype).replace("torch.", ""),
            "kv_pool_bytes": stored,
            "kv_pool_bytes_dense_equiv": full,
        }

    def pipeline_stats(self) -> Dict[str, Any]:
        """Depth (1 pipelined, 0 not), whether a burst is in flight, dispatch
        and idle-dispatch counts, and the host-gap / fetch-block EMAs (ms)."""
        def rounded(value):
            return None if value is None else round(value, 3)

        return {
            "depth": 1 if self.pipeline else 0,
            "inflight": self._inflight is not None,
            "step_dispatches": self.step_dispatches,
            "idle_dispatches": self.idle_dispatches,
            "ema_host_gap_ms": rounded(self.ema_host_gap_ms),
            "ema_fetch_block_ms": rounded(self.ema_fetch_block_ms),
            "graphs": len(self._step_fns),
        }

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
        if ids is None and self._inflight is not None:
            # the in-flight burst's unreplayed retirements may free blocks
            self._pending_events.extend(self._fetch_inflight())
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
        """Point-update one slot's device lifecycle and sampling controls, in
        place (a full upload would roll back other slots' retirements inside
        a burst still in flight)."""
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
        fewer slots are free than requests (after fetching a burst in flight,
        whose retirements may free some: its events wait in
        :meth:`take_pending_events`). A failure part-way (e.g.
        ``pool_exhausted``) cancels the slots this call admitted and frees
        their blocks before it re-raises.
        """
        normalized = []
        for req in requests:
            sampling = dict(req[2]) if len(req) > 2 and req[2] else {}
            normalized.append(self.validate_request(req[0], req[1], **sampling))
        free = self.free_slots
        if len(normalized) > len(free) and self._inflight is not None:
            self._pending_events.extend(self._fetch_inflight())
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
                    self._release(slot)
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

    def _prefill(self, prompt_ids: torch.Tensor, lengths: torch.Tensor, model: Any = None):
        """Batched bucket prefill of ``model`` (default the engine's):
        right-padded rows, dense causal attention (K1 on the card); each row's
        logits at its last REAL token."""
        model = self._model if model is None else model
        rows, bucket = prompt_ids.shape
        local_cache = init_cache(model.config, rows, bucket, device=self.device)
        with torch.no_grad():  # the model's forward also trains; serving keeps no graph
            logits, local_cache = model(prompt_ids, cache=local_cache, position=0)
        idx = torch.clamp(lengths - 1, 0, bucket - 1)
        return local_cache, logits[torch.arange(rows, device=self.device), idx]

    def _paged_insert(self, local_cache, local_logits, slots, lengths, pool=None) -> None:
        """Scatter a bucket prefill's dense K/V into the admitted slots' pool
        blocks through their table rows (``continuous.py:768-827``). Columns
        past a slot's allocation map to scratch. Quantized layers mask positions
        at/after a row's real length to zero, so bucket padding never inflates a
        block's absmax scale. ``pool`` defaults to the engine's; without a
        ``pool`` the rows' lengths and logits are set too."""
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
        for name, layer in (self._pool if pool is None else pool).items():
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
        if pool is None:
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
        """Run ONE chunk of every in-progress chunked prefill (eagerly, between
        decode bursts); completed prefills seal their length and logits and
        activate."""
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
        """One decode step over every slot, in place on the static buffers.
        Returns the step's ``(tokens, active-at-start, non-finite-logits)``."""
        last, lens = self._last_logits, self._lens
        active = self._active_dev.clone()
        bad = ~torch.isfinite(last).all(dim=-1)
        if sampling:
            tokens = sample_logits(last, self._generator, self._temp_dev, self._top_k_dev, self._top_p_dev)
        else:
            tokens = torch.argmax(last, dim=-1)
        # a retired row still writes one K/V column per step; the sentinel
        # position maps that write to the trailing scratch column
        sentinel = (self._table_width - 1) * self.block_size
        pos = torch.where(active, lens, torch.full_like(lens, sentinel))
        with torch.no_grad():
            logits, _ = self._model(tokens[:, None], cache={"table": self._tables, **self._pool}, position=pos)
        new_lens = torch.where(active, torch.clamp(lens + 1, max=self.max_len - 1), lens)
        last.copy_(torch.where(active[:, None], logits[:, -1, :], last))
        new_active, new_remaining = advance_slot_state(
            active, self._remaining_dev, new_lens, tokens, self.max_len, self.eos_token_id
        )
        lens.copy_(new_lens)
        self._active_dev.copy_(new_active)
        self._remaining_dev.copy_(new_remaining)
        return tokens, active, bad

    def _burst(self, steps: int, sampling: bool):
        """``steps`` decode steps: the burst program, ``(steps, num_slots)``
        tokens, start-of-step masks and non-finite flags."""
        burst = [self._decode_once(sampling) for _ in range(steps)]
        return tuple(torch.stack(x) for x in zip(*burst))

    def _run_program(self, key: Any, fn, generators=()):
        """Run one device program: on the card, the CUDA graph of ``key``,
        captured at its first call (two eager warm-ups, then the recording,
        with every slot made inactive meanwhile so that neither changes a
        slot's state; ``generators`` register with the graph); on the CPU,
        ``fn`` itself. A capture that fails raises: nothing runs eagerly in
        its place on the card."""
        if self.device.type != "cuda":
            return fn()
        graph = self._step_fns.get(key)
        if graph is None:
            active = self._active_dev.clone()
            self._active_dev.zero_()
            try:
                graph = _graphs.capture(fn, (), {}, device=self.device, generators=tuple(generators))
            finally:
                self._active_dev.copy_(active)
            self._step_fns[key] = graph
        return graph(((), {}))

    def _enqueue_fetch(self, out, steps: int, round: bool = False) -> _Burst:
        """Wrap a dispatched program's ``(tokens, masks, bads)``: on the card,
        start their copies into pinned host buffers and record the event the
        fetch waits on."""
        if self.device.type != "cuda":
            return _Burst(*out, steps=steps, round=round)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out]
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return _Burst(*host, steps=steps, ready=ready, round=round)

    def _dispatch_step(self, lookahead: int) -> _Burst:
        """Dispatch ONE decode burst of ``lookahead`` steps and return it in
        flight. The seam :meth:`step` drives and subclasses override (the
        speculative engine swaps in its round here). Everything the burst
        reads rides in device buffers, so a steady-state dispatch copies
        nothing from the host."""
        sampling = bool((self._slot_temp[self._active] > 0).any())
        out = self._run_program(("decode", lookahead, sampling), lambda: self._burst(lookahead, sampling),
                                (self._generator,) if sampling else ())
        return self._enqueue_fetch(out, lookahead)

    def _fetch_inflight(self) -> List[StepEvent]:
        """Fetch the in-flight burst (none: no-op) and replay it under the
        slot mapping it was dispatched with."""
        if self._inflight is None:
            return []
        burst, skip = self._inflight, self._inflight_skip
        self._inflight, self._inflight_skip = None, set()
        return self._replay_burst(burst, skip)

    def _replay_burst(self, burst: _Burst, skip=frozenset()) -> List[StepEvent]:
        """Wait for one burst's host copies (the one designed sync) and apply
        its tokens to the host mirrors. A flagged ``(step, slot)``
        quarantines that slot; a slot in ``skip`` was quarantined or cancelled
        while the burst was in flight and its tokens are dropped."""
        t0 = time.perf_counter()
        if burst.ready is not None:
            burst.ready.synchronize()
        tokens, masks, bads = burst.tokens.numpy(), burst.masks.numpy(), burst.bads.numpy()
        done = time.perf_counter()
        block_ms = (done - t0) * 1e3
        self.ema_fetch_block_ms = block_ms if self.ema_fetch_block_ms is None else (
            0.8 * self.ema_fetch_block_ms + 0.2 * block_ms)
        self._last_fetch_done = done
        events: List[StepEvent] = []
        for i in range(tokens.shape[0]):
            for slot in np.flatnonzero(masks[i]):
                slot = int(slot)
                if slot in skip or not self._active[slot]:
                    continue  # quarantined or cancelled meanwhile, or earlier in this burst
                if bads[i, slot]:
                    events.append(self._quarantine(slot))
                else:
                    events.append(self._apply_token(slot, int(tokens[i, slot])))
        return events

    def step(self, lookahead: int = 1) -> List[StepEvent]:
        """Advance chunked prefills by one chunk, then decode up to
        ``lookahead`` steps for every active slot in ONE device program with
        ONE fetch; returns per-slot events. Retirement runs on the device
        inside the burst, so a burst emits exactly what ``lookahead`` single
        steps would.

        With ``pipeline=True`` each call dispatches the next burst before it
        fetches the previous one: the card decodes burst N+1 while the host
        applies burst N, and events arrive one call after the dispatch that
        made them. ``lookahead`` is cut to the next power of two above the
        steps the slots can still take, so a bounded ladder of programs
        serves every tail."""
        events: List[StepEvent] = []
        if self._pending_events:
            events.extend(self._pending_events)
            self._pending_events.clear()
        if self._partials:
            self._advance_partials()
        if not self._active.any():
            return events
        lookahead = max(1, int(lookahead))
        inflight_steps = self._inflight.steps if self._inflight is not None else 0
        room = np.minimum(self._remaining[self._active], (self.max_len - 1) - self._lens_host[self._active])
        headroom = max(1, int(room.max())) - inflight_steps
        if headroom <= 0:
            # every slot the host thinks active retires inside the in-flight
            # burst: fetch it instead of dispatching a fully masked one
            events.extend(self._fetch_inflight())
            return events
        if headroom < lookahead:
            lookahead = min(lookahead, 1 << (headroom - 1).bit_length())
        t0 = time.perf_counter()
        idle = self._inflight is None
        burst = self._dispatch_step(lookahead)
        self.step_dispatches += 1
        if self._last_fetch_done is not None:
            self.idle_dispatches += int(idle)
            gap_ms = min((t0 - self._last_fetch_done) * 1e3, 250.0) if idle else 0.0
            self.ema_host_gap_ms = gap_ms if self.ema_host_gap_ms is None else (
                0.8 * self.ema_host_gap_ms + 0.2 * gap_ms)
        previous, prev_skip = self._inflight, self._inflight_skip
        self._inflight, self._inflight_skip = burst, set()
        if previous is not None:
            events.extend(self._replay_burst(previous, prev_skip))
        if not self.pipeline:
            events.extend(self._fetch_inflight())
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
        if self._inflight is not None:
            # the burst in flight still decodes this slot under an active
            # mask: its replay must not credit those tokens to a new occupant
            self._inflight_skip.add(slot)

    def cancel(self, slot: int) -> None:
        """Deactivate one slot (its request is abandoned; the slot is reusable).
        A burst in flight is fetched first, so its tokens apply under the slot
        mapping it was dispatched with; the survivors' events wait in
        :meth:`take_pending_events`, the cancelled slot's are dropped."""
        self._pending_events.extend(self._fetch_inflight())
        self._pending_events = [ev for ev in self._pending_events if ev.slot != slot]
        self._release(slot)

    def abort_all(self) -> None:
        """Deactivate every slot and return every block. A burst in flight is
        discarded, not fetched: every request it could emit for is abandoned."""
        self._inflight, self._inflight_skip = None, set()
        self._pending_events.clear()
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

    A request's sampling keywords reach the engine as they are: with a
    :class:`~unionml_tpu_torch.serving.speculative.SpeculativeEngine`,
    ``speculative``/``seed``/``gamma`` among them (SLO classes, which set
    ``speculative`` per class in the JAX package, are not ported yet).

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
            self._dispatch(self._engine.take_pending_events())
            for ticket in batch:
                self._deliver(ticket.sink, "fail", _as_engine_failure(exc, "prefill_failed"))
            return
        # a flush inside admission replays events of the slots' previous
        # occupants: deliver them under the old sinks before re-keying
        self._dispatch(self._engine.take_pending_events())
        for slot, ticket in zip(slots, batch):
            self._sinks[slot] = ticket.sink

    def _dispatch(self, events: Sequence[StepEvent]) -> None:
        abandoned: List[int] = []
        for event in events:
            sink = self._sinks.get(event.slot)
            if sink is None:
                continue
            if sink.cancelled:  # consumer abandoned the stream mid-decode
                del self._sinks[event.slot]
                if not event.finished:
                    abandoned.append(event.slot)
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
        if abandoned:
            # a cancel fetches the burst in flight, whose tokens come after
            # every event of this list: the other slots get them only now
            for slot in abandoned:
                self._engine.cancel(slot)
            self._dispatch(self._engine.take_pending_events())

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
            busy = engine.num_active or engine.has_pending_prefill or engine.has_pending_events
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
