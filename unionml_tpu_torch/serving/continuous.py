"""Continuous batching for GPT generation over a paged KV pool or dense
per-slot caches.

Port of ``unionml_tpu/serving/continuous.py`` (``DecodeEngine``,
``:166-2763``; ``ContinuousBatcher``, ``:2829-3732``), on one device or
tensor-parallel over a mesh (below). One decode step runs over a fixed set of slots; requests are inserted into free
slots between steps and evicted when they finish.

- The KV cache is a block POOL shared by all slots: ``(num_blocks, heads,
  block_size, head_dim)`` per layer, int8 codes plus per-(block, head) f32
  scales under ``kv_quantize="int8"``. A slot owns a block-table row and a
  length; admission allocates ``ceil(min(prompt + budget, max_len) /
  block_size)`` blocks and a shortfall raises
  ``EngineFailure(reason="pool_exhausted")``.
- The pool's allocator is the radix index
  (:class:`~unionml_tpu_torch.serving.prefix_cache.PrefixCache`). With the
  prefix cache on (``prefix_cache_blocks > 0``), a prompt's full blocks are
  indexed by adoption once it prefills (no copy); a later prompt sharing them
  splices their ids into its table row and prefills only the suffix, at a
  block-aligned base, through the table (the K4 kernel's query tile on the
  card). :meth:`DecodeEngine.preempt` checkpoints a running slot the same way.
- The table's trailing column always points at a reserved scratch block, and a
  retired row decodes at the sentinel position ``(width - 1) * block_size``,
  so its unavoidable write lands in scratch, never in a block another slot
  now owns (``continuous.py:721-728``).
- Prefill is batched per bucket: queued prompts sharing a bucket prefill
  together, up to ``prefill_batch`` rows at a time (dense causal attention,
  the K1 kernel), then every row is quantized block by block into its pool
  blocks with positions past its real length masked to zero. Prompts whose
  uncached part is longer than ``prefill_chunk`` prefill one chunk per
  :meth:`DecodeEngine.step` straight through the table (the K4 kernel).
- Slot lifecycle (``active``/``remaining``) lives on the device and retires
  inside the step (``advance_slot_state``); the host replays the fetched
  tokens into its mirrors, one device-to-host copy per step burst.
- Each (lookahead, sampling) burst is one CUDA graph on the card (the
  counterpart of JAX's compiled step programs), over static device buffers
  that admission updates in place by index; the bucket, hit and chunk
  prefills run eagerly between bursts. A steady-state step copies nothing
  from the host. Whatever reallocates those buffers (:meth:`DecodeEngine.rebuild`,
  :meth:`DecodeEngine.reset`, a re-layout by
  :meth:`DecodeEngine.enable_prefix_cache`) drops every graph first.
- Depth-1 dispatch-ahead (``pipeline=True``, the default): :meth:`DecodeEngine.step`
  enqueues burst N+1 (its graph, then asynchronous copies of its tokens into
  pinned host memory and an event) before it waits for burst N's event.
  :meth:`DecodeEngine._dispatch_step` and :meth:`DecodeEngine._replay_burst`
  are the seam the speculative engine overrides.
- The dense engine (``paged=False``, JAX's A/B arm): each slot owns a
  ``max_len`` row of a ``(slots, heads, max_len, head_dim)`` cache per layer;
  a bucket prefill inserts its rows there, decode writes each row's token at
  its own column. Its prefix cache is a separate full-precision block pool
  behind its own radix index: a hit gathers the matched blocks into a local
  cache (restore) and prefills the suffix over it; indexing copies a slot's
  new full blocks out of its row into the pool (save), and a failed save
  rebuilds that pool empty. The pool and index survive an engine rebuild, so
  salvaged requests resume through hits. ``block_demand`` is 0,
  ``available_blocks`` and ``pool_signal`` are None, ``kv_pool_stats`` is
  ``{}`` (no block accounting).
- Weight-only int8 (``quantize="int8"``): the engine serves its own copy of
  the model (:func:`~unionml_tpu_torch.models._layers.quantize_model`) whose
  decoder kernels are int8 codes with per-output f32 scales, each
  dequantized just before its product, in every prefill, chunk and captured
  burst. The caller's model is left untouched.
- Faults: a slot whose logits went NaN/Inf is quarantined alone (its request
  fails with ``nan_logits``). A failed dispatch, fetch or device write fails
  the ENGINE: every slot's transcript is salvaged (host data only), the device
  state is rebuilt in place with the sampling generator put back where the
  first undelivered burst found it, and a supervising
  :class:`ContinuousBatcher` re-queues the requests, which resume token for
  token. :class:`~unionml_tpu_torch.serving.faults.FaultPlan` injects each
  fault deterministically.

- :class:`ContinuousBatcher` routes every request through the SLO scheduler
  (:mod:`unionml_tpu_torch.serving.scheduler`): priority classes, deadlines,
  sheds, and the preemption policy that drives :meth:`DecodeEngine.preempt`.
- Telemetry (:mod:`unionml_tpu_torch.serving.telemetry`): with a
  ``Telemetry`` attached, every request gets a trace (admission, queue wait,
  block allocation, prefill or prefix hit and chunks, preemption, quarantine,
  salvage, decode, end) and the metric families of ``/metrics``. Each hook is
  one host ``is not None`` branch; a burst's decode timing reads only the
  stamps its fetch already took and the host arrays it already produced.

- Engines that share one card (the replicas of
  :class:`~unionml_tpu_torch.serving.fleet.EngineFleet`) each issue their
  device work on their own CUDA stream (:attr:`DecodeEngine.stream`): a
  replica's fetch waits for its own bursts, not for another replica's
  prefill. A ``ContinuousBatcher`` whose engine died for good hands its
  tickets to the fleet (:attr:`ContinuousBatcher.on_tickets_orphaned`,
  :meth:`ContinuousBatcher.adopt_ticket`).

- Meshes (``mesh=``, ``continuous.py:300-329``): SPMD, one process per
  card. Every rank builds the engine from the same whole model; each serves
  its share of it (:func:`~unionml_tpu_torch.models.gpt.tensor_parallel`):
  its Megatron shard over a ``tensor`` axis, with a pool and cache of its
  own heads, so K1 and K4 run at ``num_heads / N`` heads; its ``1/N`` of
  every decoder block's weights over ``fsdp``, all-gathered block by block;
  its experts over ``expert``, their outputs summed over the axis. The
  collectives (NCCL on the card, captured in the prefill and burst graphs;
  gloo on the CPU) give every rank the same logits bit for bit. The
  block tables, the radix index, the scheduler state and the sampling
  generator are host state every rank holds identically, because every rank
  makes the same calls in the same order: rank 0 of the mesh LEADS (each of
  its public calls that changes slot or device state is sent over a gloo
  side group before it runs: one small all-reduce, which also carries every
  rank's outcome of the call before), and the other ranks
  :meth:`DecodeEngine.follow`, replaying those calls until
  :meth:`DecodeEngine.stop_followers` (a mesh of one rank has nobody to lead
  and runs its calls as they come). So a ``ContinuousBatcher`` or
  ``/generate`` app on rank 0 serves over the whole mesh; the batcher keeps
  idle followers alive (:meth:`DecodeEngine.keep_alive`) and releases them
  when it closes. A rank whose call raised where rank 0's did not (or the
  reverse) ends every rank's run with ``MeshDivergence`` at the next
  message; a rank that died ends the others' at their next collective,
  within the process group's timeout.
"""

import asyncio
import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from unionml_tpu_torch import _graphs
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.models._layers import quantize_model
from unionml_tpu_torch.models.gpt import (
    advance_slot_state,
    block_table_width,
    check_serving_experts,
    gather_block_prefix,
    init_block_pool,
    init_block_tables,
    init_cache,
    init_slot_state,
    kv_heads,
    kv_pool_bytes,
    slice_cache_blocks,
    tensor_parallel,
)
from unionml_tpu_torch.ops.quant import quantize_blockwise
from unionml_tpu_torch.ops.sampling import sample_logits, validate_sampling
from unionml_tpu_torch.parallel.distributed import collective_timeout_s
from unionml_tpu_torch.serving.faults import EngineFailure, FaultPlan
from unionml_tpu_torch.serving.lead import MeshDivergence, MeshLead, lead_calls
from unionml_tpu_torch.serving.prefix_cache import PrefixCache
from unionml_tpu_torch.serving.scheduler import (
    DeadlineExceededError,
    SchedulerConfig,
    SLOScheduler,
    Ticket,
    class_name,
)

__all__ = ["ContinuousBatcher", "DecodeEngine", "MeshDivergence", "PreemptedSlot", "SalvagedSlot", "StepEvent",
           "block_demand"]

#: default prompt-prefill bucket lengths (right-padded)
DEFAULT_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)


def block_demand(prompt_len: int, budget: int, *, max_len: int, block_size: int) -> int:
    """Pool blocks one request needs for its whole lifetime: prompt plus
    budget, capped at cache capacity, rounded up to whole blocks."""
    need = min(int(prompt_len) + int(budget), int(max_len))
    return -(-need // int(block_size))


def on_engine_stream(method):
    """Run an engine entry point on the engine's own CUDA stream
    (:meth:`DecodeEngine._on_stream`)."""

    @functools.wraps(method)
    def guarded(self, *args, **kwargs):
        with self._on_stream():
            return method(self, *args, **kwargs)

    return guarded


#: the public calls of :class:`DecodeEngine` that change slot, device or
#: radix-index state: rank 0 of a meshed engine sends each before it runs
#: (op code: index + 2)
_LED_CALLS = ("enable_prefix_cache", "add_request", "admit_many", "step", "cancel", "abort_all", "preempt",
              "release_preempted", "take_salvage", "discard_salvage", "note_external_failure", "rebuild", "reset",
              "generate")


@dataclasses.dataclass(frozen=True)
class _Handed:
    """A checkpoint crossing to the followers: its path of radix nodes is
    each rank's own, so it travels as the handle under which every rank
    registered that path when the call that made it returned."""

    checkpoint: Any
    handle: int


class _EngineLead(MeshLead):
    """The lead protocol (:class:`~unionml_tpu_torch.serving.lead.MeshLead`)
    over an engine's led calls. A checkpoint a led call hands out
    (:class:`PreemptedSlot`, :class:`SalvagedSlot`) holds a path of radix
    nodes that is each rank's own: every rank registers it under the same
    handle when the call returns, and a checkpoint passed back to a led call
    travels as that handle."""

    def __init__(self, mesh: Any, timeout_s: float) -> None:
        super().__init__(mesh, timeout_s, _LED_CALLS)
        #: the leader's id(path) -> (handle, path); a follower's handle -> path
        self._paths: Dict[int, Any] = {}
        self._handed = 0

    def _settled(self, result: Any) -> None:
        for item in result if isinstance(result, list) else [result]:
            if isinstance(item, (PreemptedSlot, SalvagedSlot)):
                key = id(item.path) if self.is_leader else self._handed
                self._paths[key] = (self._handed, item.path) if self.is_leader else item.path
                self._handed += 1

    def _encode(self, value: Any) -> Any:
        if isinstance(value, (tuple, list)):
            return type(value)(self._encode(v) for v in value)
        if isinstance(value, dict):
            return {k: self._encode(v) for k, v in value.items()}
        if isinstance(value, (PreemptedSlot, SalvagedSlot)):
            entry = self._paths.pop(id(value.path), None)
            if entry is None:
                raise ValueError("a checkpoint this meshed engine did not hand out, or one already released")
            return _Handed(dataclasses.replace(value, path=None), entry[0])
        return value

    def _decode(self, value: Any) -> Any:
        if isinstance(value, (tuple, list)):
            return type(value)(self._decode(v) for v in value)
        if isinstance(value, dict):
            return {k: self._decode(v) for k, v in value.items()}
        if isinstance(value, _Handed):
            return dataclasses.replace(value.checkpoint, path=self._paths.pop(value.handle))
        return value


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One slot's outcome for one engine step."""

    slot: int
    token: int
    #: False for an EOS token (consumed, not part of the completion)
    emit: bool
    finished: bool
    #: time the request spent queued before admission (ms), on its FIRST
    #: decoded token only (None on later events and on requests admitted
    #: without a queue), so a TTFT splits into queue wait and the rest
    queue_wait_ms: Optional[float] = None
    #: failure slug when the ENGINE terminated this request (``nan_logits``,
    #: ``prefill_failed``); the event carries no token and the consumer must
    #: fail the request
    error: Optional[str] = None


@dataclasses.dataclass
class PreemptedSlot:
    """A preempted request's checkpoint (:meth:`DecodeEngine.preempt`):
    ``tokens`` is its transcript (prompt plus every token decoded), the resume
    prompt; ``path`` the radix chain holding the transcript's full blocks,
    pinned until :meth:`DecodeEngine.release_preempted`."""

    tokens: List[int]
    path: List[Any]


@dataclasses.dataclass
class SalvagedSlot:
    """One slot's resumable state captured at an engine failure: host data
    only (the device state may be poisoned). ``tokens`` is the transcript
    delivered so far, ``remaining`` the unspent budget. A paged engine's pool
    is rebuilt empty, so its ``path`` is empty and the resume prefills the
    whole transcript; a dense engine's prefix pool survives the rebuild, and
    ``path`` is the slot's indexed chain, pinned until
    :meth:`DecodeEngine.release_preempted`."""

    slot: int
    tokens: List[int]
    path: List[Any]
    remaining: int


@dataclasses.dataclass
class _Burst:
    """One dispatched device program: its ``(steps, num_slots)`` tokens,
    start-of-step activity masks and non-finite-logits flags. On the card they
    are pinned host buffers filled by asynchronous copies that ``ready``
    marks; on the CPU, the tensors themselves. ``round`` marks a speculative
    round's burst; ``gen_state`` is the sampling generator's state before a
    burst that draws from it (None for one that does not)."""

    tokens: torch.Tensor
    masks: torch.Tensor
    bads: torch.Tensor
    steps: int
    ready: Any = None
    round: bool = False
    gen_state: Any = None


class DecodeEngine:
    """Slot-based continuous-batching decode engine over a paged KV pool (or
    dense per-slot caches with ``paged=False``).

    :param model: a :class:`~unionml_tpu_torch.models.gpt.GPTLMHeadModel` on
        ``device``.
    :param num_slots: concurrent sequences (the decode batch).
    :param max_len: per-slot capacity (prompt + generated tokens); a slot
        force-finishes when its length reaches ``max_len - 1``.
    :param eos_token_id: token that terminates a completion (not emitted).
    :param temperature: default sampling temperature (0 = greedy).
    :param prefill_buckets: allowed padded prompt lengths; prompts longer than
        the largest bucket are rejected with ``ValueError`` unless a cached
        prefix leaves a suffix that fits.
    :param seed: seeds the engine's ``torch.Generator`` for sampled slots.
    :param prefill_batch: max prompts prefilled together per bucket.
    :param prefill_chunk: prompts whose uncached part is longer than this
        prefill in chunks of this many tokens, one chunk per :meth:`step`,
        through the block table.
    :param block_size: tokens per pool block, which is also the prefix
        cache's match granularity (clamped to ``max_len``); JAX's
        ``prefix_block_size``.
    :param pool_blocks: pool size in blocks including the scratch block;
        ``None`` sizes it so a free slot can always allocate
        (``num_slots * ceil(max_len / block_size) + prefix_cache_blocks + 1``).
    :param kv_quantize: ``"int8"`` stores the pool as int8 codes with
        per-(block, head) f32 scales; ``None`` keeps the compute dtype.
        Requires ``paged=True``.
    :param kv_quantize_skip_layers: layers whose pool stays full precision.
    :param pipeline: depth-1 dispatch-ahead (default on): each :meth:`step`
        enqueues the next burst before it fetches the previous one, so the
        card decodes while the host applies tokens; events then arrive one
        call later. Streams equal ``pipeline=False``'s under the same calls.
    :param paged: the paged block pool (default). ``False`` keeps a dense
        ``max_len`` cache row per slot, with the prefix cache in a separate
        block pool of ``prefix_cache_blocks`` blocks (JAX's A/B arm).
    :param prefix_cache_blocks: when > 0, the prefix cache is on (see
        :meth:`enable_prefix_cache`) with this many blocks of headroom in the
        default pool size (dense: the prefix pool's size).
    :param prefix_cache_generated: also index a retiring slot's generated
        tokens, so a follow-up turn hits the whole previous turn.
    :param faults: a :class:`~unionml_tpu_torch.serving.faults.FaultPlan`
        (fault injection for tests and chaos runs); ``None`` makes every
        hook one host branch.
    :param telemetry: a :class:`~unionml_tpu_torch.serving.telemetry.Telemetry`
        (spans and metrics; ``None`` makes every hook one host branch).
    :param quantize: ``"int8"`` serves weight-only int8 decoder kernels (per
        output channel, :mod:`unionml_tpu_torch.ops.quant`) from the engine's
        own copy of the model; the caller's model is not modified.
    :param mesh: a ``DeviceMesh`` (:func:`~unionml_tpu_torch.parallel.mesh.make_mesh`)
        the engine serves over (:func:`~unionml_tpu_torch.models.gpt.tensor_parallel`):
        tensor-parallel over its ``tensor`` axis, with each rank's ``1/N`` of
        the decoder blocks' weights at rest over ``fsdp`` and ``E / ep``
        experts over ``expert`` (or the share a model's ``ep_mesh`` gives
        it); ``data`` and ``sequence`` split nothing in decode. Every rank of
        the mesh builds the engine with the same arguments, rank 0 drives it
        and the others call :meth:`follow`. ``None`` (default) serves on one
        device.
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
        prefix_cache_generated: bool = False,
        faults: Optional[FaultPlan] = None,
        quantize: Optional[str] = None,
        telemetry: Any = None,
        mesh: Any = None,
        device="cuda",
    ) -> None:
        #: rank 0's lead over a meshed engine's ranks (set last: the
        #: constructor's own calls run on every rank alike)
        self._lead: Optional[_EngineLead] = None
        self.device = resolve_device(device)
        #: the engine's own CUDA stream (None on the CPU): every entry point
        #: issues its device work there, so a fetch waits for this engine's
        #: bursts only, not for another engine's work on the same card
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"mesh is over {mesh.device_type} devices, engine device is {self.device}")
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine device is {self.device}")
        config = model.config
        max_len = max_len or config.max_position_embeddings
        if max_len > config.max_position_embeddings:
            raise ValueError(
                f"max_len ({max_len}) exceeds max_position_embeddings ({config.max_position_embeddings})"
            )
        if quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode {quantize!r}; expected None or 'int8'")
        if kv_quantize not in (None, "int8"):
            raise ValueError(f"Unknown kv_quantize mode {kv_quantize!r}; expected None or 'int8'")
        if kv_quantize is not None and not paged:
            raise ValueError("kv_quantize requires paged=True (the block pool is what quantizes)")
        #: the weights the engine serves (what ``quantized_bytes`` reads):
        #: with ``quantize="int8"`` the quantized tree of its own model copy
        #: (the caller's model, which a full-precision engine, fleet replicas
        #: or a draft may share, is not modified), else the model's parameters
        if quantize == "int8":
            model, self._variables = quantize_model(model)
        else:
            self._variables = dict(model.named_parameters())
        #: the mesh the engine serves over (None: one device); the weights it
        #: serves are then this rank's shares, and ``_variables`` holds what
        #: the rank keeps at rest (an fsdp-split leaf's piece)
        self.mesh = mesh
        check_serving_experts(model, mesh)
        if mesh is not None:
            # quantize first, then shard: the int8 codes and scales split as
            # their kernel does (continuous.py:300-303)
            model, self._variables = tensor_parallel(model, mesh)
        self._model = model
        self._config = config
        #: heads of this rank's KV pool and caches
        self._kv_heads = kv_heads(model)
        #: paged KV pool (default), or dense per-slot caches (``paged=False``)
        self.paged = bool(paged)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self._seed = int(seed)
        #: full resets (reset, or a rebuild that abandons its work): each
        #: reseeds the generator so sampled streams do not repeat
        self._resets = 0
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
        #: span/metrics collector (None: every hook is one host branch, as the
        #: fault hooks are; decode timing reuses the burst fetch's stamps)
        self._telemetry = telemetry
        if faults is not None and telemetry is not None and faults.telemetry is None:
            faults.telemetry = telemetry
        #: slot -> request_id of the occupant's trace (batcher-set); spans for
        #: a slot emitted before the id binds are buffered and flushed at bind
        self._slot_rid: Dict[int, str] = {}
        self._slot_pending_spans: Dict[int, List[Tuple[str, float, Optional[float], Dict[str, Any]]]] = {}
        #: the paged attention path the engine's programs run: the CUDA kernel,
        #: or its plain version (CPU tensors, or ``paged_attn_impl="reference"``);
        #: None on a dense engine
        self.paged_attn_impl: Optional[str] = None
        # the pool's block size IS the prefix cache's (one layout, spliced freely)
        self.block_size = min(int(block_size), self.max_len)
        self._explicit_pool_blocks = pool_blocks is not None
        #: the allocator of the paged pool, and its radix index once the prefix
        #: cache is on; None on a dense engine
        self._allocator: Optional[PrefixCache] = None
        #: the paged pool (or, dense, the prefix cache's block pool), the
        #: block tables and the dense per-slot cache, as the mode has them
        self._pool: Optional[Dict[str, Any]] = None
        self._tables: Optional[torch.Tensor] = None
        self._cache: Optional[Dict[str, Any]] = None
        if self.paged:
            self.paged_attn_impl = (
                "reference" if config.paged_attn_impl == "reference" or self.device.type != "cuda" else "kernel")
            self._table_width = block_table_width(self.max_len, self.block_size)
            if pool_blocks is None:
                pool_blocks = self.num_slots * (self._table_width - 1) + int(prefix_cache_blocks) + 1
            if int(pool_blocks) < 2:
                raise ValueError(f"pool_blocks must be >= 2 (1 usable + scratch), got {pool_blocks}")
            self.pool_blocks = int(pool_blocks)
            #: reserved block absorbing retired rows' masked writes; never allocated
            self._scratch_block = self.pool_blocks - 1
            self._allocator = PrefixCache(self.pool_blocks - 1, self.block_size, telemetry=self._telemetry)
            if self._telemetry is not None:
                self._telemetry.paged_attn_impl.set(1.0, self.paged_attn_impl)
        #: the radix index (the allocator itself) while the prefix cache is on, else None
        self.prefix_cache: Optional[PrefixCache] = None
        self.prefix_cache_generated = bool(prefix_cache_generated)
        #: per-slot PRIVATE blocks, block index -> pool block id (spliced
        #: shared blocks live in ``_slot_path``). Freeing at retirement is safe
        #: with a burst in flight: the retired row writes only scratch, and a
        #: new owner's writes queue behind that burst on the stream.
        self._slot_block_map: Dict[int, Dict[int, int]] = {}  # holds: kv-block
        #: per-slot radix paths held (matched or indexed blocks)
        self._slot_path: Dict[int, List[Any]] = {}
        #: per-slot transcript (prompt + applied tokens): generated-KV capture,
        #: preemption and salvage read it
        self._slot_tokens: Dict[int, List[int]] = {}

        #: the deterministic fault script (None: every hook is one host branch)
        self._faults = faults
        #: engine failures survived; the batcher keys recovery on its delta
        self.failure_count = 0
        #: device-state rebuilds performed
        self.rebuilds = 0
        #: wall ms of the last rebuild (the graphs' recapture comes at the
        #: next dispatch and is in each new graph's ``capture_ms``)
        self.last_rebuild_ms: Optional[float] = None
        #: salvage captured at the last failure, awaiting :meth:`take_salvage`
        self._salvage: List[SalvagedSlot] = []  # holds: kv-pin
        #: set when an in-place rebuild failed: the engine refuses work until
        #: :meth:`rebuild` succeeds
        self._failed = False
        #: set when an in-place device write failed part-way: the shared state
        #: is suspect, so the entry point escalates to an engine failure
        self._device_poisoned = False
        #: the generator state a resume rebuild restores (the state before the
        #: first burst whose tokens were never delivered)
        self._resume_gen: Any = None
        #: the generator state before the dispatch in progress, if it samples
        self._dispatch_gen: Any = None
        #: liveness stamp (monotonic) the supervisor's watchdog reads
        self.last_heartbeat = time.monotonic()
        #: slots admitted by the admit_many call in progress (its rollback set)
        self._admitting: Optional[List[int]] = None

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
        #: prefill device calls, and the REAL prompt tokens they computed
        #: (padding excluded; a prefix-cache hit counts only its suffix)
        self.prefill_dispatches = 0
        self.prefill_tokens_computed = 0
        #: logical prefix restores (copy-free splices) and saves (adoptions)
        self.prefix_restore_dispatches = 0
        self.prefix_save_dispatches = 0
        self.requests_admitted = 0
        self.tokens_decoded = 0
        #: running slots checkpointed by :meth:`preempt`
        self.preempted_requests = 0
        #: per-slot queue wait (:meth:`note_queue_wait`), handed out on the
        #: slot's first event, and its EMA over admissions
        self._slot_queue_wait: Dict[int, float] = {}
        self.ema_queue_wait_ms: Optional[float] = None

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
        #: graphs captured, graphs dropped because their buffers were
        #: reallocated, and captures that failed (each fails the engine: no
        #: burst ever runs eagerly in a graph's place on the card)
        self.graph_captures = 0
        self.graphs_dropped = 0
        self.capture_failures = 0
        self.step_dispatches = 0
        self.idle_dispatches = 0
        self.ema_host_gap_ms: Optional[float] = None
        self.ema_fetch_block_ms: Optional[float] = None
        self._last_fetch_done: Optional[float] = None
        with self._on_stream():
            self._init_device_state()
        if prefix_cache_blocks:
            self.enable_prefix_cache(prefix_cache_blocks, cache_generated=prefix_cache_generated)
        if mesh is not None and mesh.mesh.numel() > 1:
            # a mesh of one rank has no follower to tell or agree with
            self._lead = _EngineLead(mesh, collective_timeout_s())

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        lead_calls(cls, _LED_CALLS)

    def follow(self) -> int:
        """On a rank other than rank 0 of a meshed engine: replay rank 0's led
        calls, in order, until rank 0 calls :meth:`stop_followers`; returns
        the number replayed. Raises :class:`MeshDivergence` when this rank's
        call and rank 0's disagree, and the process group's error when a
        rank is gone."""
        if self._lead is None or self._lead.is_leader:
            raise RuntimeError("follow() runs on the ranks that follow rank 0 of a meshed engine")
        return self._lead.follow(self)

    def stop_followers(self) -> None:
        """On rank 0 of a meshed engine: end the other ranks' :meth:`follow`
        (a no-op on an unmeshed engine, or once they were released). Raises
        :class:`MeshDivergence` when the last led call diverged."""
        if self._lead is not None:
            self._lead.stop()

    @property
    def keepalive_s(self) -> Optional[float]:
        """How long rank 0 of a meshed engine may go without a led call before
        it must call :meth:`keep_alive` (a quarter of the collective timeout);
        None on an unmeshed engine."""
        return None if self._lead is None else self._lead.keepalive_s

    def keep_alive(self) -> None:
        """On rank 0 of a meshed engine idle for :attr:`keepalive_s`: send the
        followers a no-op, so their wait never reaches the side group's
        timeout (:class:`ContinuousBatcher` calls it whenever it idles). A
        no-op otherwise; raises :class:`MeshDivergence` when the last led
        call diverged."""
        if self._lead is not None:
            self._lead.keep_alive()

    def _init_device_state(self) -> None:
        """(Re)allocate the device state: the paged pool and its tables (or
        the dense per-slot cache) and every buffer a decode burst reads or
        writes. They are static: every later write is in place, so a captured
        burst keeps reading the live values. A reallocation drops every graph
        (each reads the old buffers at their addresses; one replayed over
        freed memory would corrupt silently) and the burst in flight; the
        next dispatch of each key captures anew. A dense engine's prefix pool
        is no burst's state: it survives (``continuous.py:870-915``)."""
        self.graphs_dropped += len(self._step_fns)
        self._step_fns = {}
        self._inflight, self._inflight_skip = None, set()
        dev, config = self.device, self._config
        if self.paged:
            self._pool = init_block_pool(
                config, self.pool_blocks, self.block_size, kv_quantize=self.kv_quantize,
                kv_quantize_skip_layers=self.kv_quantize_skip_layers, device=dev, heads=self._kv_heads,
            )
            self._tables = init_block_tables(self.num_slots, self.max_len, self.block_size, self._scratch_block,
                                             device=dev)
        else:
            self._cache = init_cache(config, self.num_slots, self.max_len, device=dev, heads=self._kv_heads)
        self._lens = torch.zeros((self.num_slots,), dtype=torch.int32, device=dev)  # K4 takes int32 positions
        self._last_logits = torch.zeros((self.num_slots, config.vocab_size), dtype=torch.float32, device=dev)
        self._active_dev, self._remaining_dev = init_slot_state(self.num_slots, device=dev)
        self._temp_dev = torch.full((self.num_slots,), self.temperature, dtype=torch.float32, device=dev)
        self._top_k_dev = torch.zeros((self.num_slots,), dtype=torch.int64, device=dev)
        self._top_p_dev = torch.ones((self.num_slots,), dtype=torch.float32, device=dev)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(self._seed + self._resets)

    @contextlib.contextmanager
    def _on_stream(self):
        """Issue the block's device work on :attr:`stream`. Entered from
        another stream (a caller driving the engine from its own thread), the
        engine's stream first waits for the caller's work, and the caller's
        stream waits for the block's work at the end: the order a single
        stream would give, without a host sync. A no-op on the CPU and on the
        engine's own stream (the batcher's worker runs there)."""
        stream = self.stream
        if stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        if caller == stream:
            yield
            return
        stream.wait_stream(caller)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            caller.wait_stream(stream)

    @contextlib.contextmanager
    def _device_write(self):
        """Mark the shared device state poisoned when an in-place write into
        it (pool, tables, lengths, logits, slot mirrors) fails part-way: the
        public entry points then escalate to an engine failure."""
        try:
            yield
        except Exception:
            self._device_poisoned = True
            raise

    @on_engine_stream
    def enable_prefix_cache(self, num_blocks: int, block_size: Optional[int] = None, *,
                            cache_generated: bool = False) -> None:
        """Turn the prefix cache on. Paged: the allocator already is the radix
        index, so indexing starts over the same pool; ``block_size`` (default
        the pool's) or extra headroom in a default-sized pool re-lays the pool
        out, which is legal only while nothing holds a block (and drops every
        graph). Dense: a separate pool of ``num_blocks`` full-precision blocks
        behind its own radix index (``continuous.py:1000-1008``). Callable
        once (the constructor calls it for ``prefix_cache_blocks > 0``)."""
        if self.prefix_cache is not None:
            raise RuntimeError("prefix cache is already enabled on this engine")
        block_size = self.block_size if block_size is None else int(block_size)
        if not 1 <= block_size < self.max_len:
            raise ValueError(f"block_size must be in [1, max_len) = [1, {self.max_len}), got {block_size}")
        if not self.paged:
            self.prefix_cache = PrefixCache(int(num_blocks), block_size, telemetry=self._telemetry)
            self.prefix_cache_generated = bool(cache_generated)
            self.block_size = block_size
            self._pool = init_block_pool(self._config, int(num_blocks), block_size, device=self.device,
                                         heads=self._kv_heads)
            return
        width = block_table_width(self.max_len, block_size)
        pool_blocks = self.pool_blocks
        if not self._explicit_pool_blocks:
            pool_blocks = self.num_slots * (width - 1) + int(num_blocks) + 1
        if block_size != self.block_size or pool_blocks != self.pool_blocks:
            if self.busy or self._inflight is not None or self._allocator.slot_blocks:
                raise RuntimeError("enable_prefix_cache cannot re-layout the block pool while requests hold "
                                   "blocks; call it before admitting work")
            self.block_size, self._table_width, self.pool_blocks = block_size, width, pool_blocks
            self._scratch_block = pool_blocks - 1
            self._allocator = PrefixCache(pool_blocks - 1, block_size, telemetry=self._telemetry)
            self._init_device_state()
        self.prefix_cache = self._allocator
        self.prefix_cache_generated = bool(cache_generated)

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

    def block_demand(self, prompt_len: int, budget: int) -> int:
        """Pool blocks a request needs for its whole lifetime (a hit's
        private share can be smaller: this is the conservative demand); 0 on
        a dense engine (no block accounting)."""
        if not self.paged:
            return 0
        return block_demand(prompt_len, budget, max_len=self.max_len, block_size=self.block_size)

    def available_blocks(self) -> Optional[int]:
        """Blocks an admission could allocate now: free plus evictable; None
        on a dense engine (unbounded)."""
        if not self.paged:
            return None
        return self._allocator.available_blocks()

    def kv_pool_stats(self) -> Dict[str, Any]:
        """Byte accounting of the resident KV pool (shapes only): ``kv_dtype``,
        ``kv_pool_bytes`` as stored (scales included),
        ``kv_pool_bytes_dense_equiv`` at the compute dtype, and ``impl``, the
        paged attention path (``"kernel"`` or ``"reference"``); ``{}`` on a
        dense engine."""
        if not self.paged:
            return {}
        stored, full = kv_pool_bytes(self._pool, self._config.dtype)
        return {
            "kv_dtype": self.kv_quantize or str(self._config.dtype).replace("torch.", ""),
            "kv_pool_bytes": stored,
            "kv_pool_bytes_dense_equiv": full,
            "impl": self.paged_attn_impl,
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
            "ema_queue_wait_ms": rounded(self.ema_queue_wait_ms),
            "graphs": len(self._step_fns),
        }

    def note_queue_wait(self, slot: int, wait_ms: Optional[float]) -> None:
        """Record how long ``slot``'s request waited queued (the batcher calls
        it right after admission): it rides the slot's first
        :class:`StepEvent` and feeds :meth:`pipeline_stats`'s EMA."""
        if wait_ms is None:
            return
        self._slot_queue_wait[slot] = float(wait_ms)
        self.ema_queue_wait_ms = float(wait_ms) if self.ema_queue_wait_ms is None else (
            0.8 * self.ema_queue_wait_ms + 0.2 * float(wait_ms))

    def note_request_id(self, slot: int, request_id: Optional[str]) -> None:
        """Bind ``slot``'s occupant to its trace (the batcher calls it at
        registration) and flush the spans its admission buffered meanwhile."""
        if self._telemetry is None or request_id is None:
            return
        self._slot_rid[slot] = request_id
        for kind, at, dur_ms, attrs in self._slot_pending_spans.pop(slot, ()):
            self._telemetry.span(request_id, kind, dur_ms=dur_ms, at=at, **attrs)

    def _note_span(self, slot: int, kind: str, dur_ms: Optional[float] = None, **attrs: Any) -> None:
        """Record a slot-keyed span, buffered (with its time) while the slot's
        request id is not bound yet: admission's spans come before the
        batcher's registration. Callers gate on ``self._telemetry is not None``."""
        rid = self._slot_rid.get(slot)
        if rid is not None:
            self._telemetry.span(rid, kind, dur_ms=dur_ms, **attrs)
        else:
            self._slot_pending_spans.setdefault(slot, []).append((kind, time.perf_counter(), dur_ms, attrs))

    def _drop_rid(self, slot: int) -> None:
        """Forget a freed slot's trace binding (the batcher, which owns
        terminal delivery, ends the trace)."""
        self._slot_rid.pop(slot, None)
        self._slot_pending_spans.pop(slot, None)

    def pool_signal(self) -> Optional[Dict[str, Any]]:
        """Block-pool occupancy for :meth:`SLOScheduler.load_signal`:
        ``num_blocks``, the free/live/cached/pinned fractions,
        ``available_blocks`` (free plus cached minus pinned, an upper bound on
        what eviction could reclaim) and ``pressure`` (1 minus the available
        fraction); None on a dense engine. Plain counter reads: the exact
        evictable walk (:meth:`available_blocks`) stays on the worker's
        admission path."""
        if not self.paged:
            return None
        stats = self._allocator.stats()
        total = max(1, int(stats["num_blocks"]))
        free, live = int(stats["free_blocks"]), int(stats["slot_blocks"])
        cached, pinned = int(stats["cached_blocks"]), int(stats["pinned_blocks"])
        available = max(0, min(total, free + cached - pinned))
        return {
            "num_blocks": total,
            "free_frac": round(free / total, 4),
            "live_frac": round(live / total, 4),
            "cached_frac": round(cached / total, 4),
            "pinned_frac": round(pinned / total, 4),
            "available_blocks": available,
            "pressure": round(1.0 - available / total, 4),
        }

    def robustness_stats(self) -> Dict[str, Any]:
        """Failure and recovery counters (a supervisor keeps its own beside them)."""
        stats: Dict[str, Any] = {
            "engine_failures": self.failure_count,
            "engine_rebuilds": self.rebuilds,
            "quarantined_requests": self.quarantined_requests,
            "salvage_pending": len(self._salvage),
            "graph_captures": self.graph_captures,
            "graphs_dropped": self.graphs_dropped,
            "last_rebuild_ms": self.last_rebuild_ms,
        }
        if self._faults is not None:
            stats["faults"] = self._faults.stats()
        return stats

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
        try:
            self.bucket_for(prompt.size)  # raises for prompts beyond the bucket ladder
        except ValueError:
            # a cached prefix can stand in for the missing bucket: a resumed
            # transcript longer than the largest bucket still re-admits
            if not self._prefix_coverable(prompt):
                raise
        demand = self.block_demand(prompt.size, max_new_tokens)
        if self.paged and demand > self._allocator.num_blocks:
            raise ValueError(
                f"request needs {demand} KV blocks but the pool has only "
                f"{self._allocator.num_blocks}; raise pool_blocks or lower max_new_tokens"
            )
        return prompt, int(max_new_tokens), float(temperature), int(top_k), float(top_p)

    def _prefix_coverable(self, prompt: np.ndarray) -> bool:
        """Whether the cached prefix of ``prompt`` leaves a suffix that fits
        the bucket ladder and the slot (a probe: no reference is taken)."""
        if self.prefix_cache is None:
            return False
        if self.prefill_chunk is not None and int(prompt.size) < self.max_len:
            return True  # the chunked path takes any in-capacity suffix
        block = self.block_size
        covered = self.prefix_cache.probe(prompt, (int(prompt.size) - 1) // block) * block
        if covered <= 0:
            return False
        try:
            return covered + self.bucket_for(int(prompt.size) - covered) <= self.max_len
        except ValueError:
            return False

    # ---------------------------------------------------------- paged blocks

    # transfers: kv-block
    def _alloc_slot_blocks(self, slot: int, start: int, need: int) -> List[int]:
        """Acquire ``need`` private blocks for ``slot``'s table columns
        ``[start, start + need)``, fetching the burst in flight once on a
        shortfall (its unreplayed retirements may free blocks); still short:
        the retryable ``pool_exhausted`` failure."""
        if need <= 0:
            self._slot_block_map.setdefault(slot, {})
            return []
        ids = self._allocator.alloc_blocks(need)
        if ids is None:
            if self._inflight is not None:
                self._pending_events.extend(self._fetch_inflight())
                ids = self._allocator.alloc_blocks(need)
            if ids is None:
                raise EngineFailure(
                    f"KV block pool exhausted: need {need} block(s), "
                    f"{self._allocator.available_blocks()} reclaimable of {self._allocator.num_blocks}",
                    reason="pool_exhausted", retryable=True,
                )
        self._slot_block_map[slot] = {start + i: b for i, b in enumerate(ids)}
        if self._telemetry is not None:
            self._telemetry.blocks_per_request.observe(float(need))
            self._note_span(slot, "block_alloc", blocks=need, shared=start)
            self._note_pool_gauges()
        return ids

    # owns: kv-block
    def _free_slot_blocks(self, slot: int) -> None:
        """Return ``slot``'s private blocks that the radix index did not adopt."""
        ids = self._slot_block_map.pop(slot, None)
        if ids:
            self._allocator.free_blocks(list(ids.values()))
            if self._telemetry is not None:
                self._note_pool_gauges()

    def _note_pool_gauges(self) -> None:
        """Refresh the pool gauges from host counters and shapes (no device
        work; callers gate on ``self._telemetry is not None``)."""
        stats = self._allocator.stats()
        self._telemetry.pool_free_blocks.set(float(stats["free_blocks"]))
        self._telemetry.pool_live_blocks.set(float(stats["slot_blocks"]))
        self._telemetry.pool_cached_blocks.set(float(stats["cached_blocks"]))
        self._telemetry.pool_pinned_blocks.set(float(stats["pinned_blocks"]))
        kv = self.kv_pool_stats()
        self._telemetry.pool_kv_bytes.set(float(kv["kv_pool_bytes"]), kv["kv_dtype"])
        self._telemetry.pool_kv_bytes_dense_equiv.set(float(kv["kv_pool_bytes_dense_equiv"]))
        self._telemetry.paged_attn_impl.set(1.0, kv["impl"])

    def _write_slot_row(self, slot: int, block_ids: Sequence[int]) -> None:
        """Write one slot's table row by index: spliced shared ids first, then
        private ones, scratch in every other column. A burst in flight read
        the row before this write on the stream."""
        row = np.full((self._table_width,), self._scratch_block, dtype=np.int32)
        row[: len(block_ids)] = block_ids
        with self._device_write():
            self._tables[slot] = torch.from_numpy(row).to(self.device)

    def _activate(self, slot: int, length: int, budget: int, temp: float, top_k: int, top_p: float) -> None:
        self._active[slot] = True
        self._reserved[slot] = False
        self._lens_host[slot] = length
        self._remaining[slot] = budget
        self._slot_temp[slot] = temp
        self.requests_admitted += 1
        if self._admitting is not None:
            self._admitting.append(slot)
        self._slot_device_update(slot, True, budget, temp, top_k, top_p)

    def _slot_device_update(self, slot, is_active, budget, temp, top_k, top_p) -> None:
        """Point-update one slot's device lifecycle and sampling controls, in
        place (a full upload would roll back other slots' retirements inside
        a burst still in flight)."""
        with self._device_write():
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

    @on_engine_stream
    def admit_many(self, requests: Sequence[Tuple]) -> List[int]:
        """Admit ``(prompt_ids, max_new_tokens[, sampling_dict])`` requests with
        batched bucket prefills; returns the slot of each request, in order.

        Every request validates before any device work; ``RuntimeError`` when
        fewer slots are free than requests (after fetching a burst in flight,
        whose retirements may free some: its events wait in
        :meth:`take_pending_events`). With the prefix cache on, a request
        whose prefix a request earlier in the same call will index waits for a
        second pass and admits as a hit on it.

        A failure part-way that leaves the device state intact (e.g.
        ``pool_exhausted``, an injected prefill fault) cancels the slots this
        call admitted and frees their blocks before it re-raises; one inside an
        in-place device write fails the engine (salvage, rebuild) instead.
        """
        self._ensure_usable()
        if self._faults is not None:
            self._faults.begin_admit()
        failures_before = self.failure_count
        self._admitting = []
        try:
            return self._admit_many_inner(requests)
        except Exception:
            if self.failure_count == failures_before:
                if self._device_poisoned:
                    self._on_failure()
                else:
                    for slot in list(self._admitting):
                        self.cancel(slot)
                    # blocks granted to slots that never activated
                    for slot in list(self._slot_block_map):
                        if not (self._active[slot] or self._reserved[slot]):
                            self._free_slot_blocks(slot)
            raise
        finally:
            self._admitting = None
            if self._faults is not None:
                self._faults.end_admit()

    def _admit_many_inner(self, requests: Sequence[Tuple]) -> List[int]:
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
        slot_to_norm = dict(zip(slots, normalized))
        groups: Dict[int, List[int]] = {}
        deferred: List[int] = []
        sibling_prefixes: set = set()
        for slot, norm in zip(slots, normalized):
            if self.prefix_cache is not None:
                if self._defer_for_sibling(norm[0], sibling_prefixes):
                    deferred.append(slot)
                    continue
                self._note_prefixes(norm[0], sibling_prefixes)
            self._admit_one(slot, norm, groups)
        self._flush_groups(groups, slot_to_norm)
        if deferred:
            # the siblings' blocks are indexed now: the deferred re-match as hits
            groups = {}
            for slot in deferred:
                self._admit_one(slot, slot_to_norm[slot], groups)
            self._flush_groups(groups, slot_to_norm)
        return slots

    def _admit_one(self, slot: int, norm: Tuple, groups: Dict[int, List[int]]) -> None:
        """Route one validated request: chunked prefill, a one-shot prefix
        hit, or the batched bucket path (queued in ``groups``)."""
        prompt, budget, temp, top_k, top_p = norm
        path, matched = self._match_prefix(prompt)
        if self._start_chunked(slot, prompt, budget, temp, top_k, top_p, path, matched):
            return
        if matched and self._admit_with_prefix(slot, prompt, budget, temp, top_k, top_p, path, matched):
            return
        groups.setdefault(self.bucket_for(prompt.size), []).append(slot)

    def _flush_groups(self, groups: Dict[int, List[int]], slot_to_norm: Dict[int, Tuple]) -> None:
        """Per bucket, prefill up to ``prefill_batch`` rows together, then
        insert every row into its pool blocks (dense: its cache row)."""
        for bucket, idxs in groups.items():
            for start in range(0, len(idxs), self.prefill_batch):
                chunk = idxs[start : start + self.prefill_batch]
                padded = np.zeros((len(chunk), bucket), dtype=np.int64)
                lengths = np.zeros((len(chunk),), dtype=np.int64)
                for r, slot in enumerate(chunk):
                    prompt, budget = slot_to_norm[slot][:2]
                    padded[r, : prompt.size] = prompt
                    lengths[r] = prompt.size
                    if self.paged:
                        blocks = self._alloc_slot_blocks(slot, 0, self.block_demand(prompt.size, budget))
                        self._write_slot_row(slot, blocks)
                if self._faults is not None:
                    self._faults.check_prefill()
                lengths_dev = torch.from_numpy(lengths).to(self.device)
                local_cache, last = self._prefill(torch.from_numpy(padded).to(self.device), lengths_dev)
                self._insert_into_slots(local_cache, last, torch.tensor(chunk, device=self.device), lengths_dev)
                self.prefill_dispatches += 1
                for r, slot in enumerate(chunk):
                    prompt = slot_to_norm[slot][0]
                    self._activate(slot, int(lengths[r]), *slot_to_norm[slot][1:])
                    self.prefill_tokens_computed += int(prompt.size)
                    self._index_prompt(slot, prompt)
                    if self._telemetry is not None:
                        self._telemetry.prefill_tokens_total.inc(float(prompt.size))
                        self._note_span(slot, "prefill", tokens=int(prompt.size), bucket=int(bucket),
                                        batch_rows=len(chunk))

    def _prefill(self, prompt_ids: torch.Tensor, lengths: torch.Tensor, model: Any = None):
        """Batched bucket prefill of ``model`` (default the engine's):
        right-padded rows, dense causal attention (K1 on the card); each row's
        logits at its last REAL token."""
        model = self._model if model is None else model
        rows, bucket = prompt_ids.shape
        local_cache = init_cache(model.config, rows, bucket, device=self.device, heads=kv_heads(model))
        with torch.no_grad():  # the model's forward also trains; serving keeps no graph
            logits, local_cache = model(prompt_ids, cache=local_cache, position=0)
        idx = torch.clamp(lengths - 1, 0, bucket - 1)
        return local_cache, logits[torch.arange(rows, device=self.device), idx]

    def _insert_into_slots(self, local_cache, local_logits, slots, lengths) -> None:
        """Insert a prefill's local cache rows and last logits into ``slots``
        (``continuous.py:1903-1922``): through the rows' block tables into
        the pool, or into the dense cache rows. A failure part-way poisons
        the shared state."""
        with self._device_write():
            if self.paged:
                self._paged_insert(local_cache, local_logits, slots, lengths)
                return
            for name, layer in self._cache.items():
                for key in ("k", "v"):
                    local = local_cache[name][key]  # (rows, heads, width, hd) into columns [0, width)
                    layer[key][slots, :, : local.shape[2]] = local.to(layer[key].dtype)
            self._lens[slots] = lengths.to(self._lens.dtype)
            self._last_logits[slots] = local_logits.float()

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

    def _defer_for_sibling(self, prompt: np.ndarray, sibling_prefixes: set) -> bool:
        """Whether a request earlier in this call will index a longer block
        prefix of ``prompt`` than the tree matches today."""
        block = self.block_size
        max_blocks = (int(prompt.size) - 1) // block
        for k in range(max_blocks, 0, -1):
            if tuple(int(t) for t in prompt[: k * block]) in sibling_prefixes:
                return k > self.prefix_cache.probe(prompt, max_blocks)
        return False

    def _note_prefixes(self, prompt: np.ndarray, sibling_prefixes: set) -> None:
        """Record every block prefix this request will index once it prefills."""
        block = self.block_size
        for k in range(1, int(prompt.size) // block + 1):
            sibling_prefixes.add(tuple(int(t) for t in prompt[: k * block]))

    # ---------------------------------------------------------- prefix cache

    def _match_prefix(self, prompt: np.ndarray) -> Tuple[List[Any], int]:
        """Longest cached full-block prefix of ``prompt``, capped one token
        short of it (one real token must prefill to seed decoding); ``([],
        0)`` with the cache off. The path is reference-held."""
        if self.prefix_cache is None:
            return [], 0
        max_blocks = (int(prompt.size) - 1) // self.block_size
        if max_blocks <= 0:
            return [], 0
        path = self.prefix_cache.match(prompt, max_blocks)
        return path, len(path) * self.block_size

    def _admit_with_prefix(self, slot: int, prompt: np.ndarray, budget: int, temp: float, top_k: int,
                           top_p: float, path: List[Any], matched: int) -> bool:
        """One-shot admission of a prefix-cache hit: splice the matched block
        ids into the slot's table row and prefill ONLY the suffix over it,
        bucket-padded, at base ``matched`` through the table (K4's query tile
        on the card). The base is block-aligned, so the suffix's writes,
        padding included, land in the slot's private blocks (or scratch),
        never in a shared one. A dense engine restores the matched blocks
        into a local cache of ``matched + bucket`` columns, prefills the
        suffix over it (the plain masked attention) and inserts it into the
        slot's row. The match shrinks a block at a time while the suffix
        bucket would overflow the slot; returns False (path released) when
        nothing survives, and the caller falls back to the bucket path."""
        block = self.block_size
        while matched:
            try:
                if matched + self.bucket_for(prompt.size - matched) <= self.max_len:
                    break
            except ValueError:
                # the suffix outgrew the bucket ladder while shrinking
                self.prefix_cache.release(path)
                path.clear()
                return False
            self.prefix_cache.release([path.pop()])
            matched -= block
        if not matched:
            return False
        suffix_len = int(prompt.size) - matched
        bucket = self.bucket_for(suffix_len)
        ids = np.zeros((1, bucket), dtype=np.int64)
        ids[0, :suffix_len] = prompt[matched:]
        try:
            if self.paged:
                private = self._alloc_slot_blocks(slot, len(path), self.block_demand(prompt.size, budget) - len(path))
                self._write_slot_row(slot, [node.block_id for node in path] + private)
            else:
                local_cache = self._restore(path, matched + bucket)  # exact: the suffix write never clamps
            self.prefix_restore_dispatches += 1
            if self._faults is not None:
                self._faults.check_prefill()
            if self.paged:
                logits = self._run_paged_chunk(ids, slot, matched)
            else:
                logits = self._run_dense_chunk(ids, local_cache, matched)
            self.prefill_dispatches += 1
            self.prefill_tokens_computed += suffix_len
            if self.paged:
                self._seal_slot(slot, int(prompt.size), logits[0, suffix_len - 1])
            else:
                self._insert_into_slots(local_cache, logits[:, suffix_len - 1], self._device_ints(slot),
                                        self._device_ints(prompt.size))
        except Exception:
            self.prefix_cache.release(path)
            path.clear()
            self._free_slot_blocks(slot)
            raise
        self.prefix_cache.record_hit(matched)
        self._activate(slot, int(prompt.size), budget, temp, top_k, top_p)
        self._slot_path[slot] = path
        self._index_prompt(slot, prompt)
        if self._telemetry is not None:
            self._telemetry.prefill_tokens_total.inc(float(suffix_len))
            self._note_span(slot, "prefix_hit", matched_tokens=matched, blocks=len(path))
            self._note_span(slot, "prefill", tokens=suffix_len, restored=matched)
        return True

    def _run_paged_chunk(self, ids: np.ndarray, slot: int, position: int) -> torch.Tensor:
        """One batch-1 prefill chunk straight into ``slot``'s pool blocks at
        ``position`` (the hit's suffix and every chunk of a chunked prefill);
        returns its logits."""
        cache = {"table": self._tables[slot : slot + 1], **self._pool}
        with torch.no_grad(), self._device_write():
            logits, _ = self._model(torch.from_numpy(ids).to(self.device), cache=cache, position=int(position))
        return logits

    def _run_dense_chunk(self, ids: np.ndarray, local_cache: Dict[str, Any], position: int) -> torch.Tensor:
        """One batch-1 prefill chunk into a local dense cache at ``position``
        (a dense hit's suffix, every chunk of a dense chunked prefill): K1 at
        position 0, the plain masked attention over the cache after it. It
        writes only the local cache; returns its logits."""
        with torch.no_grad():
            logits, _ = self._model(torch.from_numpy(ids).to(self.device), cache=local_cache, position=int(position))
        return logits

    def _restore(self, path: Sequence[Any], pad_len: int) -> Dict[str, Any]:
        """A dense engine's prefix restore: the matched blocks gathered from
        its prefix pool into a fresh batch-1 cache of ``pad_len`` columns."""
        return gather_block_prefix(self._pool, self._device_ints(*(node.block_id for node in path)), pad_len)

    def _device_ints(self, *values: int) -> torch.Tensor:
        return torch.tensor([int(v) for v in values], dtype=torch.int64, device=self.device)

    def _seal_slot(self, slot: int, length: int, last: torch.Tensor) -> None:
        """Set a table-resident prefill's length and sampling logits."""
        with self._device_write():
            self._lens[slot] = int(length)
            self._last_logits[slot] = last.float()

    def _index_prompt(self, slot: int, prompt: np.ndarray) -> None:
        """Start the slot's transcript and, with the cache on, index the
        prompt's full blocks. Runs after :meth:`_activate` on every admission
        path (the transcript serves salvage even with the cache off)."""
        self._slot_tokens[slot] = [int(t) for t in prompt]
        if self.prefix_cache is not None:
            self._extend_index(slot, prompt)

    def _extend_index(self, slot: int, tokens: np.ndarray) -> None:
        """Extend the slot's held path over ``tokens``' full blocks. Paged: by
        ADOPTION, each block the tree lacks moves from the slot's private
        blocks to the tree, no device work; only full blocks are indexed, so
        an int8 block's codes and scale never change once shared. Dense: the
        new blocks are copied out of the slot's cache row into the prefix
        pool (a save); a save that fails rebuilds the pool empty and forgets
        every cached prefix (``continuous.py:1694-1732``). An exhausted pool
        (injected) indexes nothing new; the request is never affected."""
        path = self._slot_path.pop(slot, [])
        if self._faults is not None and self._faults.pool_exhausted():
            self._faults.note_observed("pool_exhausted")
            if path:
                self._slot_path[slot] = path
            return
        max_blocks = int(tokens.size) // self.block_size
        if self.paged:
            full, adopted = self.prefix_cache.adopt(path, tokens, max_blocks,
                                                    self._slot_block_map.setdefault(slot, {}))
            if adopted:
                self.prefix_save_dispatches += 1
                if self._telemetry is not None:
                    self._note_pool_gauges()
        else:
            # graftlint: disable=resource-leak -- the pool-rebuild return path drops 'full' deliberately: _rebuild_pool() forgets every cached prefix, so the refs die with the rebuilt cache
            full, new = self.prefix_cache.extend(path, tokens, max_blocks)
            if new:
                try:
                    self._save(slot, len(full) - len(new), [node.block_id for node in new])
                except Exception as exc:
                    logger.warning("prefix-cache block save failed (%s); rebuilding the pool in place", exc)
                    self._rebuild_pool()
                    return
                self.prefix_save_dispatches += 1
        if full:
            self._slot_path[slot] = full

    def _save(self, slot: int, start_block: int, block_ids: Sequence[int]) -> None:
        """Copy blocks ``[start_block, start_block + len(block_ids))`` of
        ``slot``'s dense cache row into the prefix pool at ``block_ids``."""
        blocks = slice_cache_blocks(self._cache, slot, start_block, len(block_ids), self.block_size)
        dst = self._device_ints(*block_ids)
        for name, layer in self._pool.items():
            for key, leaf in layer.items():
                leaf[dst] = blocks[name][key].to(leaf.dtype)

    def _rebuild_pool(self) -> None:
        """Reallocate a dense engine's prefix pool and forget every cached
        prefix. Held paths (other slots', pinned checkpoints') now name
        orphaned nodes; releasing or unpinning them later is harmless."""
        self.prefix_cache.clear()
        self._slot_path.clear()
        self._pool = init_block_pool(self._config, self.prefix_cache.num_blocks, self.block_size, device=self.device,
                                     heads=self._kv_heads)

    def _capture_generated(self, slot: int) -> None:
        """At retirement (``prefix_cache_generated``): index the slot's whole
        transcript, eos included, up to its length."""
        tokens = self._slot_tokens.get(slot)
        if tokens:
            self._extend_index(slot, np.asarray(tokens[: int(self._lens_host[slot])], dtype=np.int32))

    def _release_prefix(self, slot: int) -> None:
        """Drop the slot's references into the radix tree and its transcript."""
        path = self._slot_path.pop(slot, None)
        if path and self.prefix_cache is not None:
            self.prefix_cache.release(path)
        self._slot_tokens.pop(slot, None)

    # -------------------------------------------------------- chunked prefill

    def _start_chunked(self, slot: int, prompt: np.ndarray, budget: int, temp: float, top_k: int, top_p: float,
                       path: Sequence[Any] = (), matched: int = 0) -> bool:
        """Reserve ``slot`` for a chunked prefill when the prompt's uncached
        part is longer than one chunk and its padded length fits the slot.
        Paged: allocate its lifetime blocks, splice a matched prefix into the
        row, and let every chunk write through the table from ``matched`` on.
        Dense: the chunks run over a local cache of the padded length, the
        restored prefix (or zeros) at first, inserted at the last chunk."""
        chunk = self.prefill_chunk
        if chunk is None or prompt.size - matched <= chunk:
            return False
        padded_len = matched + -(-(prompt.size - matched) // chunk) * chunk
        if padded_len > self.max_len:
            return False
        local_cache = None
        try:
            if self.paged:
                private = self._alloc_slot_blocks(slot, len(path),
                                                  self.block_demand(prompt.size, budget) - len(path))
                self._write_slot_row(slot, [node.block_id for node in path] + private)
            elif matched:
                local_cache = self._restore(path, padded_len)
            else:
                local_cache = init_cache(self._config, 1, padded_len, device=self.device, heads=self._kv_heads)
        except Exception:
            if path:
                self.prefix_cache.release(list(path))
            self._free_slot_blocks(slot)
            raise
        if matched:
            self.prefix_restore_dispatches += 1  # paged: a copy-free splice
            self.prefix_cache.record_hit(matched)
            self._slot_path[slot] = list(path)
            if self._telemetry is not None:
                self._note_span(slot, "prefix_hit", matched_tokens=matched, blocks=len(path))
        self._reserved[slot] = True
        if self._admitting is not None:
            self._admitting.append(slot)
        self._partials[slot] = {
            "prompt": prompt, "consumed": matched, "cache": local_cache, "budget": budget, "temp": temp,
            "top_k": top_k, "top_p": top_p,
        }
        return True

    @on_engine_stream
    def _advance_partials(self) -> None:  # graftlint: off-path (admission work, not steady-state decode)
        """Run ONE chunk of every in-progress chunked prefill (eagerly, between
        decode bursts); completed prefills seal their length and logits (dense:
        insert their local cache) and activate. A chunk that fails without
        touching shared state (an injected prefill fault, raised before the
        chunk runs; any failure of a dense chunk, which writes only its local
        cache) fails that request alone with a ``prefill_failed`` event; a
        paged chunk that fails while writing the pool raises (an engine
        failure)."""
        chunk = self.prefill_chunk
        for slot in list(self._partials):
            state = self._partials[slot]
            prompt, consumed = state["prompt"], state["consumed"]
            take = min(chunk, prompt.size - consumed)
            ids = np.zeros((1, chunk), dtype=np.int64)
            ids[0, :take] = prompt[consumed : consumed + take]
            try:
                if self._faults is not None:
                    self._faults.check_prefill()
                if self.paged:
                    logits = self._run_paged_chunk(ids, slot, int(consumed))
                else:
                    logits = self._run_dense_chunk(ids, state["cache"], int(consumed))
            except Exception as exc:
                if self._device_poisoned:
                    raise
                logger.warning("chunked prefill failed for slot %d: %s", slot, exc)
                self._fail_partial(slot)
                continue
            self.prefill_dispatches += 1
            self.prefill_tokens_computed += int(take)
            state["consumed"] = consumed + take
            if self._telemetry is not None:
                self._telemetry.prefill_tokens_total.inc(float(take))
                self._note_span(slot, "prefill_chunk", tokens=int(take), consumed=int(state["consumed"]),
                                total=int(prompt.size))
            if state["consumed"] < prompt.size:
                continue
            if self.paged:
                self._seal_slot(slot, int(prompt.size), logits[0, take - 1])
            else:
                self._insert_into_slots(state["cache"], logits[:, take - 1], self._device_ints(slot),
                                        self._device_ints(prompt.size))
            del self._partials[slot]
            self._activate(slot, prompt.size, state["budget"], state["temp"], state["top_k"], state["top_p"])
            self._index_prompt(slot, prompt)

    def _fail_partial(self, slot: int) -> None:
        """Drop one chunked prefill whose chunk failed: free the slot, release
        its matched path, and buffer the ``prefill_failed`` event."""
        self._partials.pop(slot, None)
        self._reserved[slot] = False
        self._slot_queue_wait.pop(slot, None)
        self._release_prefix(slot)
        self._free_slot_blocks(slot)
        self._drop_rid(slot)
        self._pending_events.append(StepEvent(slot=slot, token=-1, emit=False, finished=True, error="prefill_failed"))

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
        if self.paged:
            # a retired row still writes one K/V column per step; the sentinel
            # position maps that write to the trailing scratch column
            sentinel = (self._table_width - 1) * self.block_size
            pos = torch.where(active, lens, torch.full_like(lens, sentinel))
            cache = {"table": self._tables, **self._pool}
        else:
            # dense: a retired row writes at its own frozen length, a column
            # its next occupant's prefill or decode writes before reading
            pos, cache = lens, self._cache
        with torch.no_grad():
            logits, _ = self._model(tokens[:, None], cache=cache, position=pos)
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
            states = [g.get_state() for g in generators]
            self._active_dev.zero_()
            try:
                # recorded on the engine's own stream, so its cuBLAS workspace
                # is its own (engines on one card replay at once)
                graph = _graphs.capture(fn, (), {}, device=self.device, generators=tuple(generators),
                                        stream=self.stream)
            except _graphs.CaptureError:
                self.capture_failures += 1
                raise
            finally:
                self._active_dev.copy_(active)
                # the warm-up runs drew from the generators: putting their
                # states back makes every replay draw what an eager run of the
                # same burst would, whenever the graph was captured (so a
                # rebuild's recapture leaves a sampled stream where it was).
                # set_state writes the seed and offset into the generator's
                # state object in place, the object the graph registered, and
                # each replay reads that offset on the host before it launches
                for g, state in zip(generators, states):
                    g.set_state(state)
            self._step_fns[key] = graph
            self.graph_captures += 1
        return graph(((), {}))

    def _enqueue_fetch(self, out, steps: int, round: bool = False, gen_state: Any = None) -> _Burst:
        """Wrap a dispatched program's ``(tokens, masks, bads)``: on the card,
        start their copies into pinned host buffers and record the event the
        fetch waits on."""
        if self.device.type != "cuda":
            return _Burst(*out, steps=steps, round=round, gen_state=gen_state)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out]
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return _Burst(*host, steps=steps, ready=ready, round=round, gen_state=gen_state)

    def _dispatch_step(self, lookahead: int) -> _Burst:
        """Dispatch ONE decode burst of ``lookahead`` steps and return it in
        flight. The seam :meth:`step` drives and subclasses override (the
        speculative engine swaps in its round here). Everything the burst
        reads rides in device buffers, so a steady-state dispatch copies
        nothing from the host. A sampling burst records the generator's state
        first: a rebuild puts it back if the burst's tokens never arrive."""
        sampling = bool((self._slot_temp[self._active] > 0).any())
        if self._faults is not None:
            self._faults.check_step_dispatch()
        self._dispatch_gen = self._generator.get_state() if sampling else None
        out = self._run_program(("decode", lookahead, sampling), lambda: self._burst(lookahead, sampling),
                                (self._generator,) if sampling else ())
        return self._enqueue_fetch(out, lookahead, gen_state=self._dispatch_gen)

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
        while the burst was in flight and its tokens are dropped. A failed
        fetch fails the engine (the burst's tokens are lost with it)."""
        t0 = time.perf_counter()
        try:
            if self._faults is not None:
                stall_ms = self._faults.take_fetch_stall_ms()
                if stall_ms is not None:
                    time.sleep(stall_ms / 1e3)  # a wedged device queue, to the watchdog's eye
                self._faults.check_fetch()
            if burst.ready is not None:
                # graftlint: disable=host-sync -- the ONE designed sync per burst: one event fences the burst's tokens, masks and non-finite flags, copied together into pinned host buffers (the pipelined-decode contract)
                burst.ready.synchronize()
            tokens, masks, bads = burst.tokens.numpy(), burst.masks.numpy(), burst.bads.numpy()
        except Exception:
            self._on_failure(lost=burst)
            raise
        done = time.perf_counter()
        self.last_heartbeat = time.monotonic()
        block_ms = (done - t0) * 1e3
        self.ema_fetch_block_ms = block_ms if self.ema_fetch_block_ms is None else (
            0.8 * self.ema_fetch_block_ms + 0.2 * block_ms)
        self._last_fetch_done = done
        events: List[StepEvent] = []
        telemetry = self._telemetry
        emitted: Dict[Optional[str], int] = {}
        for i in range(tokens.shape[0]):
            for slot in np.flatnonzero(masks[i]):
                slot = int(slot)
                if slot in skip or not self._active[slot]:
                    continue  # quarantined or cancelled meanwhile, or earlier in this burst
                if bads[i, slot]:
                    events.append(self._quarantine(slot))
                    continue
                rid = self._slot_rid.get(slot) if telemetry is not None else None
                event = self._apply_token(slot, int(tokens[i, slot]))
                events.append(event)
                if telemetry is not None and event.emit:
                    emitted[rid] = emitted.get(rid, 0) + 1
        if telemetry is not None and emitted:
            # the burst's decode timing reads only the stamps this fetch took
            # (t0, done) and the host arrays it already produced: no sync, no
            # host read of a tensor, no new device tensor
            telemetry.decode_fetch_ms.observe(block_ms)
            for rid, n in emitted.items():
                telemetry.decode_tokens(rid, n, at=done)
        return events

    @on_engine_stream
    def step(self, lookahead: int = 1) -> List[StepEvent]:  # graftlint: hot-path
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
        serves every tail.

        A failure in a chunk, the dispatch or the fetch fails the ENGINE:
        salvage is captured for a supervising batcher, the device state is
        rebuilt in place, and the exception re-raises."""
        self._ensure_usable()
        events: List[StepEvent] = []
        if self._pending_events:
            events.extend(self._pending_events)
            self._pending_events.clear()
        if self._partials:
            try:
                self._advance_partials()
            except Exception:
                self._on_failure()
                raise
            # an injected chunk failure buffers its event: hand it out now
            events.extend(self._pending_events)
            self._pending_events.clear()
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
        try:
            burst = self._dispatch_step(lookahead)
        except Exception:
            self._on_failure()
            raise
        self._dispatch_gen = None
        self.last_heartbeat = time.monotonic()
        if self._faults is not None:
            for bad_slot in self._faults.take_nan_slots():
                # poison the slot's next sampling input in place, between
                # replays (queued behind the burst just dispatched): the next
                # burst's start-of-step finiteness flag reads this buffer
                self._last_logits[bad_slot] = float("nan")  # graftlint: disable=host-sync -- fault injection only: a FaultPlan's NaN poison, never run when faults is None
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
        self.tokens_decoded += 1
        self._remaining[slot] -= 1
        self._lens_host[slot] = min(self._lens_host[slot] + 1, self.max_len - 1)
        tokens = self._slot_tokens.get(slot)
        if tokens is not None:  # the transcript keeps eos too
            tokens.append(int(token))
        is_eos = self.eos_token_id is not None and token == self.eos_token_id
        finished = is_eos or self._remaining[slot] <= 0 or self._lens_host[slot] >= self.max_len - 1
        queue_wait_ms = self._slot_queue_wait.pop(slot, None)
        if finished:
            self._active[slot] = False
            if self.prefix_cache is not None and self.prefix_cache_generated:
                self._capture_generated(slot)  # adopts the slot's full blocks in place
            self._release_prefix(slot)
            self._free_slot_blocks(slot)
            self._drop_rid(slot)
        return StepEvent(slot=slot, token=token, emit=not is_eos, finished=bool(finished),
                         queue_wait_ms=queue_wait_ms)

    def _quarantine(self, slot: int) -> StepEvent:  # graftlint: off-path (error path: a slot's logits went non-finite)
        """Terminate ONE slot whose logits went NaN/Inf (its generated KV is
        not indexed); siblings keep decoding."""
        self.quarantined_requests += 1
        self._clear_slot(slot)
        if self._faults is not None:
            self._faults.note_observed("nan_logits")
        if self._telemetry is not None:
            self._note_span(slot, "quarantine", reason="nan_logits")
            self._telemetry.quarantines_total.inc()
        rid = self._slot_rid.get(slot)
        self._drop_rid(slot)
        logger.warning("slot %d quarantined: non-finite logits%s", slot,
                       f" (request_id={rid})" if rid is not None else "")
        return StepEvent(slot=slot, token=-1, emit=False, finished=True, error="nan_logits")

    def _clear_slot(self, slot: int) -> None:
        """Free one slot: host and device mirrors, its radix references,
        transcript and private blocks."""
        self._active[slot] = False
        self._reserved[slot] = False
        self._remaining[slot] = 0
        self._slot_temp[slot] = self.temperature
        self._partials.pop(slot, None)
        self._slot_queue_wait.pop(slot, None)
        self._release_prefix(slot)
        self._free_slot_blocks(slot)
        self._slot_device_update(slot, False, 0, self.temperature, 0, 1.0)
        if self._inflight is not None:
            # the burst in flight still decodes this slot under an active
            # mask: its replay must not credit those tokens to a new occupant
            self._inflight_skip.add(slot)

    @on_engine_stream
    def cancel(self, slot: int) -> None:
        """Deactivate one slot (its request is abandoned; the slot is reusable).
        A burst in flight is fetched first, so its tokens apply under the slot
        mapping it was dispatched with; the survivors' events wait in
        :meth:`take_pending_events`, the cancelled slot's are dropped."""
        self._ensure_usable()
        self._pending_events.extend(self._fetch_inflight())
        self._pending_events = [ev for ev in self._pending_events if ev.slot != slot]
        self._clear_slot(slot)
        self._drop_rid(slot)

    @on_engine_stream
    def abort_all(self) -> None:
        """Deactivate every slot and return every block. A burst in flight is
        discarded, not fetched: every request it could emit for is abandoned.
        The host state clears first; if the device then refuses the reset of
        its slot mirrors, the engine is marked failed (its next entry point
        rebuilds) instead of raising."""
        self._inflight, self._inflight_skip = None, set()
        self.discard_salvage()
        self._clear_host_slots()
        for slot in list(self._slot_block_map):
            self._free_slot_blocks(slot)
        try:
            # a full reset of the mirrors is legal: nothing is in flight any more
            self._active_dev.zero_()
            self._remaining_dev.zero_()
            self._temp_dev.fill_(self.temperature)
            self._top_k_dev.zero_()
            self._top_p_dev.fill_(1.0)
        except Exception:
            self._failed = True
            logger.exception("resetting the slot mirrors failed; engine marked failed")

    # transfers: kv-pin
    @on_engine_stream
    def preempt(self, slot: int) -> Optional[PreemptedSlot]:  # graftlint: off-path (scheduler policy action, not steady-state decode)
        """Checkpoint a RUNNING slot into the prefix cache and free it.

        The burst in flight is fetched first (its tokens extend the
        transcript and wait in :meth:`take_pending_events`). The transcript's
        full blocks are then indexed (paged: by adoption, no device copy;
        dense: by a device copy of the blocks the index lacks) and the path
        is pinned; the slot frees like :meth:`cancel`. Re-admitting
        ``tokens`` as the prompt resumes through the ordinary hit path and
        prefills only the suffix. The caller must :meth:`release_preempted`
        the checkpoint once the resume re-admitted (or was abandoned).

        Returns ``None``, the slot still running, when it retired during the
        flush or its checkpoint could not re-admit (a pool too full to index
        enough of a transcript beyond the bucket ladder). Raises
        ``RuntimeError`` with the prefix cache off. The batcher's
        ``_maybe_preempt`` chooses the victim (the SLO scheduler's policy)."""
        if self.prefix_cache is None:
            raise RuntimeError("preempt requires the prefix cache (prefix_cache_blocks > 0)")
        self._ensure_usable()
        self._pending_events.extend(self._fetch_inflight())
        if not self._active[slot]:
            return None
        transcript = self._slot_tokens.get(slot)
        if transcript is None:
            return None
        valid = int(self._lens_host[slot])
        tokens = np.asarray(transcript[:valid], dtype=np.int32)
        self._extend_index(slot, tokens)
        covered = len(self._slot_path.get(slot, ())) * self.block_size
        try:
            admissible = covered + self.bucket_for(valid - covered) <= self.max_len
        except ValueError:
            admissible = False
        if self.prefill_chunk is not None and valid < self.max_len:
            admissible = True  # the chunked path re-admits any in-capacity suffix
        if not admissible:
            return None
        path = self._slot_path.pop(slot, [])
        self.prefix_cache.pin(path)  # survives LRU and the working-ref release below
        try:
            self.prefix_cache.release(path)
            self._clear_slot(slot)
            self.preempted_requests += 1
            if self._telemetry is not None:
                self._note_span(slot, "preempted", transcript_tokens=valid, pinned_blocks=len(path))
                self._telemetry.preemptions_total.inc()
            self._drop_rid(slot)
        except Exception:
            self.prefix_cache.unpin(path)
            raise
        return PreemptedSlot(tokens=[int(t) for t in tokens], path=path)

    # owns: kv-pin
    def release_preempted(self, state: PreemptedSlot) -> None:
        """Drop a checkpoint's pin: after its resume re-admitted (the new slot
        holds its own references) or when its request was abandoned. Call it
        once per checkpoint."""
        if self.prefix_cache is not None and state.path:
            self.prefix_cache.unpin(state.path)

    # ------------------------------------------------------ failure & recovery

    @property
    def busy(self) -> bool:
        """Whether live requests should be making progress (the watchdog
        counts a stale heartbeat as a stall only then)."""
        return bool(self._active.any()) or bool(self._partials)

    @property
    def failed(self) -> bool:
        """True while an in-place rebuild has failed and not yet succeeded."""
        return self._failed

    def _ensure_usable(self) -> None:
        if self._failed:
            # unsupervised recovery: rebuild afresh (nobody collected the salvage)
            self.rebuild(resume=False)

    def note_external_failure(self) -> None:
        """Escalate a device write that failed in an out-of-band call
        (``cancel``, ``preempt``); a no-op when nothing is poisoned."""
        if self._device_poisoned:
            self._on_failure()

    def _on_failure(self, lost: Optional[_Burst] = None) -> None:  # graftlint: off-path (error recovery, not steady-state decode)
        """The device state is suspect: capture every salvageable slot's
        transcript, then rebuild in place with the sampling generator put back
        at its state before the first undelivered burst (``lost``, whose fetch
        failed, then the burst in flight, then the dispatch that failed). If
        the rebuild fails, the engine is marked failed for the supervisor's
        retries."""
        self.failure_count += 1
        self._device_poisoned = False
        pending = [b.gen_state for b in (lost, self._inflight) if b is not None] + [self._dispatch_gen]
        self._resume_gen = next((s for s in pending if s is not None), self._resume_gen)
        self._dispatch_gen = None
        self._inflight, self._inflight_skip = None, set()  # never fetched: its steps decode again
        self._pending_events.clear()
        self._capture_salvage()
        try:
            self.rebuild(resume=True)
        except Exception:
            self._failed = True
            logger.exception("in-place engine rebuild failed; engine marked failed")

    def _capture_salvage(self) -> None:
        """Snapshot every active or reserved slot's transcript and unspent
        budget (host data only). Paged: the rebuild reallocates the pool, so
        no block survives it: every block and path is released now (the
        engine reports no leaked block even if the rebuild fails) and each
        resume prefills its whole transcript. Dense: the prefix pool survives,
        so a resumable slot's indexed path is pinned and its resume hits it
        (``continuous.py:2024-2075``)."""
        self.discard_salvage()
        for slot in list(self._slot_block_map):
            self._free_slot_blocks(slot)
        records: List[SalvagedSlot] = []
        for slot in np.flatnonzero(self._active | self._reserved):
            slot = int(slot)
            if self._reserved[slot]:
                # a chunked prefill in progress delivered nothing yet
                part = self._partials.get(slot)
                tokens = [int(t) for t in part["prompt"]] if part else []
                remaining = int(part["budget"]) if part else 0
            else:
                tokens = [int(t) for t in (self._slot_tokens.get(slot) or [])[: int(self._lens_host[slot])]]
                remaining = int(self._remaining[slot])
            path = self._slot_path.pop(slot, [])
            resumable = bool(tokens) and remaining > 0
            if path and self.prefix_cache is not None:
                keep = resumable and not self.paged
                if keep:
                    self.prefix_cache.pin(path)  # outlives the slot's working refs, released next
                self.prefix_cache.release(path)
                path = path if keep else []
            if resumable:
                records.append(SalvagedSlot(slot=slot, tokens=tokens, path=path, remaining=remaining))
        self._salvage = records

    # transfers: kv-pin
    def take_salvage(self) -> List[SalvagedSlot]:
        """Collect (and clear) the salvage of the last failure; the caller
        releases each record's pin through :meth:`release_preempted`."""
        salvage, self._salvage = self._salvage, []
        return salvage

    # owns: kv-pin
    def discard_salvage(self) -> None:
        """Unpin and drop uncollected salvage."""
        for rec in self._salvage:
            if rec.path and self.prefix_cache is not None:
                self.prefix_cache.unpin(rec.path)
        self._salvage = []

    def _clear_host_slots(self) -> None:
        self._pending_events.clear()
        self._active[:] = False
        self._reserved[:] = False
        self._partials.clear()
        self._lens_host[:] = 0
        self._remaining[:] = 0
        self._slot_temp[:] = self.temperature
        self._slot_queue_wait.clear()
        self._slot_rid.clear()
        self._slot_pending_spans.clear()
        for slot in list(self._slot_path):
            self._release_prefix(slot)
        self._slot_tokens.clear()

    @on_engine_stream
    def rebuild(self, *, resume: bool = True) -> None:  # graftlint: off-path (error recovery, not steady-state decode)
        """Reallocate the device state (pool, tables, slot buffers, the
        generator) from the host-held parameters, dropping every CUDA graph;
        the allocator and radix index restart empty, since the pool did. On a
        dense engine the prefix pool and its index SURVIVE (a save's failure
        rebuilds that pool alone), so salvaged requests resume through their
        pinned hits and prefill only a suffix (``continuous.py:2092-2155``).

        Every failure reallocates, as in JAX, where the failed step had
        consumed the donated pool. Here a host-side raise (a dispatch or
        fetch that never reached the card) leaves the pool intact, so this
        costs the cached prefixes and makes each resume re-prefill its whole
        transcript; it is kept for counter parity with the JAX engine, and
        because a sticky CUDA error leaves no buffer that could be trusted.

        ``resume=True`` (supervised recovery) puts the sampling generator
        back at its state before the first burst whose tokens were never
        delivered, so resumed fixed-seed sampled streams continue as a
        fault-free run's. ``resume=False`` reseeds it (as :meth:`reset`) and
        drops uncollected salvage.

        Raises when the rebuild itself fails (a device that cannot allocate,
        an injected ``rebuild_failures``): the engine stays failed. Nothing
        ever falls back to the CPU."""
        t0 = time.perf_counter()
        if self._faults is not None:
            self._faults.check_rebuild()
        if resume:
            # the generator's state is host data (seed and offset on the card),
            # readable whatever the device's condition
            resume_state = self._resume_gen if self._resume_gen is not None else self._generator.get_state()
        else:
            resume_state = None
            self._resets += 1
            self.discard_salvage()
        self._reallocate(resume_state)
        self.rebuilds += 1
        self.last_rebuild_ms = (time.perf_counter() - t0) * 1e3

    @on_engine_stream
    def reset(self) -> None:  # graftlint: off-path (error recovery, not steady-state decode)
        """Reallocate the device state and clear every slot, the radix index
        and pins included (a dense engine's prefix pool too); in-flight
        requests are abandoned and the generator reseeds."""
        self._resets += 1
        self.discard_salvage()
        self._reallocate()
        if not self.paged and self.prefix_cache is not None:
            self._rebuild_pool()

    def _reallocate(self, resume_state: Any = None) -> None:
        """Clear every slot and reallocate the device state (paged: the
        allocator and the block map too); the fresh generator (seeded from
        the reset count) is put back at ``resume_state`` when one is given."""
        self._clear_host_slots()
        self._init_device_state()
        if self.paged:
            self._allocator.clear()
            self._slot_block_map.clear()
        if resume_state is not None:
            self._generator.set_state(resume_state)
        self._resume_gen = None
        self._device_poisoned = False
        self._failed = False

    @on_engine_stream
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


lead_calls(DecodeEngine, _LED_CALLS)


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


def _as_engine_failure(exc: BaseException, reason: str = "engine_failure") -> EngineFailure:
    """The structured failure a sink receives; an injected fault keeps its site."""
    if isinstance(exc, EngineFailure):
        return exc
    site = getattr(exc, "site", None)
    if site is not None:
        reason = f"injected_{site}"
    return EngineFailure(f"{type(exc).__name__}: {exc}", reason=reason)


class ContinuousBatcher:
    """Asyncio facade running a :class:`DecodeEngine` on a worker thread.

    ``await generate(prompt_ids, max_new_tokens)`` enqueues a request and
    resolves with its completion; ``stream(...)`` yields tokens as they decode.
    Every request routes through the SLO scheduler
    (:class:`~unionml_tpu_torch.serving.scheduler.SLOScheduler`): priority
    classes with aging, a bounded queue that sheds or displaces
    (``QueueFullError``, ``DeadlineInfeasibleError``, raised on the caller's
    side), deadlines enforced on queued AND running requests
    (``DeadlineExceededError``), and, with the engine's prefix cache on,
    preempt-to-prefix-cache of the worst running request when a strictly
    higher class waits against a full house or a starved pool. Between decode
    bursts the worker admits popped tickets into free slots as far as the pool
    has blocks for them (a ticket the pool cannot hold re-queues, and those
    behind it with it). An admission that fails without failing the engine is
    retried one request at a time, so only the request at fault fails.

    Deadlines are checked on the host clock between bursts, so a running
    request can overrun its deadline by up to one burst plus one eager
    admission; queued deadlines also expire while the engine idles (the
    worker's bounded 0.5 s wait).

    A request's sampling keywords reach the engine as they are; with a
    :class:`~unionml_tpu_torch.serving.speculative.SpeculativeEngine` a
    request of a class in ``SchedulerConfig.speculative_classes`` decodes
    speculatively unless it says ``speculative`` itself.

    :param lookahead: decode steps per device-to-host fetch; under contention
        (work queued, no slot free) bursts are cut to ``min(lookahead, 4)``.
    :param scheduler: an :class:`~unionml_tpu_torch.serving.scheduler.SLOScheduler`,
        or a :class:`~unionml_tpu_torch.serving.scheduler.SchedulerConfig` to
        build one (``None``: the default policy, whose bound is 256 queued
        requests). ``SchedulerConfig(fifo=True)`` is the arrival-order queue.
    :param supervisor: an :class:`~unionml_tpu_torch.serving.supervisor.EngineSupervisor`
        for supervised recovery: on an engine failure every salvaged request
        is re-queued as a resume (its sink keeps the tokens already
        delivered; its transcript becomes the prompt, its unspent budget the
        budget, its class and deadline ride along) once the engine is
        rebuilt, with bounded retries of the rebuild. ``None``: the requests
        in flight fail with a structured
        :class:`~unionml_tpu_torch.serving.faults.EngineFailure`, and the
        engine serves the next ones.
    :param telemetry: a :class:`~unionml_tpu_torch.serving.telemetry.Telemetry`
        (default: the engine's). The batcher wires the one instance into the
        engine, its fault plan and prefix cache, the scheduler and the
        supervisor, opens each request's trace at submit and ends it at
        terminal delivery.
    :param device: must name the engine's device; ``"cuda"`` (default) raises
        without a CUDA device.
    """

    #: the route forwards its ``request_id`` to ``generate``/``stream``
    accepts_request_id = True

    def __init__(self, engine: DecodeEngine, *, lookahead: int = 1, scheduler: Optional[Any] = None,
                 supervisor: Optional[Any] = None, telemetry: Optional[Any] = None, device="cuda") -> None:
        device = resolve_device(device)
        if device.type != engine.device.type:
            raise ValueError(f"engine runs on {engine.device}, batcher device is {device}")
        self._engine = engine
        self._lookahead = max(1, int(lookahead))
        #: the admission queue (thread-safe: it owns its own leaf lock)
        self.scheduler = scheduler if isinstance(scheduler, SLOScheduler) else SLOScheduler(
            scheduler if isinstance(scheduler, SchedulerConfig) else None)
        self.supervisor = supervisor
        #: span/metrics collector shared by the whole request path (None: off)
        self._telemetry = None
        self.attach_telemetry(telemetry if telemetry is not None else engine._telemetry)
        if self.scheduler.pool_signal is None:
            self.scheduler.pool_signal = engine.pool_signal
        self._closed = False  # guarded-by: _lock
        self._lock = threading.Lock()
        self._work = threading.Event()
        #: slot -> sink and slot -> ticket; worker-thread-only
        self._sinks: Dict[int, Any] = {}
        self._slot_meta: Dict[int, Ticket] = {}
        #: resume pins of tickets failed off the worker (close): the worker
        #: drops them, so only it mutates the radix index
        self._orphans: List[PreemptedSlot] = []  # guarded-by: _lock
        self._worker: Optional[threading.Thread] = None
        #: the fleet's hand-off: called on the worker thread with this
        #: batcher's tickets once its engine is dead for good (every rebuild
        #: failed); returns the tickets no other replica took, which then fail
        #: with the supervisor's unavailable error. None: all of them fail.
        self.on_tickets_orphaned: Optional[Callable[[List[Ticket]], Sequence[Ticket]]] = None
        if supervisor is not None:
            supervisor.attach(engine)
        if engine.keepalive_s is not None:
            # a meshed engine's followers wait from now on: the worker's idle
            # loop keeps them alive until the first request and between
            with self._lock:
                self._ensure_worker()

    @property
    def engine(self) -> DecodeEngine:
        return self._engine

    def attach_telemetry(self, telemetry: Any) -> None:
        """Wire one collector into the batcher, the engine, its fault plan
        and prefix cache, the scheduler and the supervisor, wherever none is
        attached yet (a no-op when the batcher has one). Call it before the
        first submission: the hooks are read without a lock."""
        if telemetry is None or self._telemetry is not None:
            return
        self._telemetry = telemetry  # graftlint: disable=data-race -- documented contract: called before the first submission, so the wiring happens-before every worker read
        engine = self._engine
        if engine._telemetry is None:
            engine._telemetry = telemetry
        if engine._faults is not None and engine._faults.telemetry is None:
            engine._faults.telemetry = telemetry
        if engine.prefix_cache is not None and engine.prefix_cache.telemetry is None:
            engine.prefix_cache.telemetry = telemetry
        if self.supervisor is not None and getattr(self.supervisor, "_telemetry", None) is None:
            self.supervisor._telemetry = telemetry  # graftlint: disable=data-race -- pre-traffic wiring (see docstring); supervisor is never rebound after __init__
        if self.scheduler._telemetry is None:
            self.scheduler._telemetry = telemetry  # graftlint: disable=data-race -- pre-traffic wiring; scheduler is never rebound after __init__ and SLOScheduler guards its own state

    def _submit(self, prompt_ids, max_new_tokens, sink, sampling, priority=None, deadline_ms=None,
                request_id=None) -> None:
        # bad requests fail on the caller's side, not the worker's
        prompt, budget, *_ = self._engine.validate_request(prompt_ids, max_new_tokens, **sampling)
        if self.supervisor is not None and self.supervisor.state == "failed":
            raise self.supervisor.unavailable_error()
        ticket = self.scheduler.make_ticket(prompt, budget, sampling, sink, priority=priority,
                                            deadline_ms=deadline_ms)
        ticket.request_id = request_id
        telemetry = self._telemetry
        if telemetry is not None:
            cls = class_name(ticket.priority)
            ticket.request_id = telemetry.new_trace(request_id, cls=cls)
            telemetry.note_tokens_in(ticket.request_id, int(prompt.size))
            # journal v2: the pool arithmetic at admission time
            pool = self._engine.pool_signal()  # None on a dense engine
            telemetry.span(ticket.request_id, "admission", prompt_tokens=int(prompt.size), budget=budget, cls=cls,
                           deadline_ms=deadline_ms, block_demand=self._engine.block_demand(int(prompt.size), budget),
                           available_blocks=None if pool is None else pool["available_blocks"])
        try:
            with self._lock:
                if self._closed:
                    raise EngineFailure("batcher is closed", reason="batcher_closed")
                # a shed raises here, on the caller's side, while the close check holds
                displaced = self.scheduler.submit(ticket)
                self._ensure_worker()
        except Exception as exc:
            # recorded outside both locks (telemetry is lock-leaf)
            self._tel_end(ticket, "shed", getattr(exc, "reason", "rejected"))
            raise
        if displaced is not None:
            # displaced tickets are never resumes: no pin to drop
            self._tel_end(displaced, "shed", "displaced")
            self._deliver(displaced.sink, "fail", displaced.shed_exc)
        self._work.set()

    def _ensure_worker(self) -> None:
        # guarded-by: _lock (both callers hold it)
        if self._worker is None:
            self._worker = threading.Thread(target=self._run, name="continuous-batcher", daemon=True)
            self._worker.start()

    def adopt_ticket(self, ticket: Ticket) -> None:
        """Take another batcher's orphaned ticket (fleet failover,
        ``continuous.py:3042-3062``). Its prompt is already the transcript,
        its budget the unspent rest, its class, deadline and sink untouched,
        and its resume pin was released on the dead engine (pins never cross
        engines: this one prefills afresh, shortened by what its own cache
        holds). Host work only: the ticket requeues through the scheduler's
        salvage path, past the queue bound. Raises ``ValueError`` for a prompt
        this engine cannot take and ``EngineFailure`` when this batcher is
        closed, so the caller tries the next replica."""
        prompt = np.asarray(ticket.prompt, dtype=np.int32).reshape(-1)
        self._engine.bucket_for(prompt.size)
        with self._lock:
            if self._closed:
                raise EngineFailure("batcher is closed", reason="batcher_closed")
            self.scheduler.requeue(ticket, preemption=False)
            self._ensure_worker()
        self._work.set()

    async def generate(self, prompt_ids: Sequence[int], max_new_tokens: int, *, priority: Any = None,
                       deadline_ms: Optional[float] = None, request_id: Optional[str] = None,
                       **sampling) -> List[int]:
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        self._submit(prompt_ids, max_new_tokens, _FutureSink(loop, future), sampling, priority, deadline_ms,
                     request_id)
        return await future

    async def stream(self, prompt_ids: Sequence[int], max_new_tokens: int, *, priority: Any = None,
                     deadline_ms: Optional[float] = None, request_id: Optional[str] = None, **sampling):
        """Async iterator of tokens, yielded as the engine decodes them;
        abandoning it early cancels the request's slot. A shed or a bad
        request raises at the first ``anext``."""
        loop = asyncio.get_running_loop()
        queue: "asyncio.Queue" = asyncio.Queue()
        sink = _QueueSink(loop, queue)
        self._submit(prompt_ids, max_new_tokens, sink, sampling, priority, deadline_ms, request_id)
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

    # owns: kv-pin
    def _release_ticket(self, ticket: Ticket) -> None:
        """Drop a ticket's resume pin (worker thread only)."""
        if ticket.resume is not None:
            self._engine.release_preempted(ticket.resume)
            ticket.resume = None

    # owns: trace
    def _tel_end(self, ticket: Ticket, status: str, reason: Optional[str] = None) -> None:
        """End a ticket's trace at terminal delivery (a shed also counts by
        reason); a no-op without telemetry. Called outside the batcher lock."""
        if self._telemetry is None or ticket.request_id is None:
            return
        if status == "shed" and reason is not None:
            self._telemetry.sheds_total.inc(1.0, reason)
        self._telemetry.end_trace(ticket.request_id, status, reason=reason)

    def _drain_orphans(self) -> None:
        with self._lock:
            orphans, self._orphans = self._orphans, []
        for state in orphans:
            self._engine.release_preempted(state)

    def _enforce_deadlines(self) -> None:  # graftlint: off-path (scheduler policy, not steady-state decode)
        """Fail queued tickets and cancel running slots whose deadline passed
        (``DeadlineExceededError``, HTTP 504). A cancel fetches the burst in
        flight and drops only this slot's tokens; the survivors' wait in the
        engine's pending events, delivered under the unchanged mapping."""
        now = time.monotonic()
        for ticket in self.scheduler.take_expired(now):
            self._release_ticket(ticket)
            self._tel_end(ticket, "shed", "deadline_exceeded")
            self._deliver(ticket.sink, "fail", DeadlineExceededError("deadline expired while queued"))
        for slot, ticket in list(self._slot_meta.items()):
            if ticket.expired(now):
                self._engine.cancel(slot)
                self.scheduler.note_deadline_miss_running()
                self._sinks.pop(slot, None)  # graftlint: disable=data-race -- _sinks is worker-thread-only by design (declared at __init__); the api-side accesses are drain/close idle probes that tolerate staleness
                self._slot_meta.pop(slot, None)
                self._tel_end(ticket, "shed", "deadline_exceeded")
                self._deliver(ticket.sink, "fail", DeadlineExceededError("deadline expired while decoding"))

    def _maybe_preempt(self) -> None:  # graftlint: off-path (scheduler policy, not steady-state decode)
        """Preempt-to-prefix-cache: when a strictly higher class waits and no
        slot is free (or the pool starves the head ticket), checkpoint the
        worst running victim (lowest class, most tokens left) and re-queue it
        as a resume. One victim per admission round."""
        config = self.scheduler.config
        if config.fifo or not config.preempt or self._engine.prefix_cache is None:
            return
        if self._engine.free_slots and not self._block_starved():
            return
        waiting = self.scheduler.best_waiting_priority()
        if waiting is None:
            return
        victims = sorted(
            ((ticket.priority, int(self._engine._remaining[slot]), slot, ticket)
             for slot, ticket in self._slot_meta.items()
             if ticket.priority > waiting and self._engine._active[slot]),
            key=lambda v: v[:3], reverse=True,
        )
        for _, _, slot, ticket in victims:
            state = self._engine.preempt(slot)
            try:
                # the preempt's flush ran under the OLD mapping: deliver the
                # victim's and the survivors' tokens before re-keying
                self._dispatch(self._engine.take_pending_events())
                if state is None:
                    # retired during the flush, or not checkpointable
                    if self._engine.free_slots:
                        return
                    continue
                # the sink keeps every token it received; the transcript
                # becomes the prompt and the budget shrinks by what was decoded
                sink = self._sinks.pop(slot, None)
                meta = self._slot_meta.pop(slot, ticket)
                generated = len(state.tokens) - len(meta.prompt)
                meta.prompt = np.asarray(state.tokens, dtype=np.int32)
                meta.budget = int(meta.budget) - max(0, generated)
                meta.resume = state
                meta.sink = sink if sink is not None else meta.sink
                self.scheduler.requeue(meta)
            except Exception as exc:
                # the checkpoint never reached the queue: drop its pin, and
                # fail the victim's consumer (it left the slot maps above)
                if state is not None:
                    self._engine.release_preempted(state)
                victim = self._sinks.pop(slot, None) or ticket.sink
                self._slot_meta.pop(slot, None)
                ticket.resume = None
                self._deliver(victim, "fail", exc)
                self._tel_end(ticket, "error", "preempt_requeue_failed")
                raise
            return

    def _block_starved(self) -> bool:
        """Whether the head ticket's block demand exceeds what the pool could
        allocate now: block pressure, not slot scarcity, gates admission.
        Never on a dense engine (no block accounting)."""
        avail = self._engine.available_blocks()
        head = self.scheduler.peek()
        if avail is None or head is None:
            return False
        return self._engine.block_demand(len(head.prompt), head.budget) > avail

    def _admit(self) -> None:  # graftlint: off-path (admission, not steady-state decode)
        self._drain_orphans()
        self._enforce_deadlines()
        self._maybe_preempt()
        engine = self._engine
        while True:
            free = engine.free_slots
            if not free:
                return
            batch = self.scheduler.pop(len(free))
            if not batch:
                return
            admissible: List[Ticket] = []
            blocked: List[Ticket] = []
            avail = engine.available_blocks()  # None on a dense engine: no block gate
            for ticket in batch:
                if blocked:
                    blocked.append(ticket)  # keep scheduler order behind the blocker
                    continue
                if ticket.sink.cancelled:  # the consumer gave up while queued
                    self._release_ticket(ticket)
                    self._tel_end(ticket, "cancelled")
                    continue
                try:
                    engine.validate_request(ticket.prompt, ticket.budget, **ticket.sampling)
                except Exception as exc:
                    self._release_ticket(ticket)
                    self._tel_end(ticket, "error", "invalid_request")
                    self._deliver(ticket.sink, "fail", exc)
                    continue
                if avail is not None:
                    demand = engine.block_demand(len(ticket.prompt), ticket.budget)
                    if demand > avail:
                        # head-of-line on purpose: admitting smaller latecomers
                        # around a starved head would starve it
                        blocked.append(ticket)
                        continue
                    avail -= demand
                admissible.append(ticket)
            for ticket in blocked:
                self.scheduler.requeue(ticket, preemption=False)
            if admissible and not self._admit_batch(admissible):
                return  # an engine failure ended this admission round
            if blocked:
                return  # the pool binds: wait for retirements

    def _register(self, slot: int, ticket: Ticket) -> None:
        """Bind an admitted ticket to its slot; a resume's pin can go now (the
        re-admission holds its own references)."""
        self._sinks[slot] = ticket.sink
        self._slot_meta[slot] = ticket
        self._engine.note_queue_wait(slot, ticket.queue_wait_ms)
        if self._telemetry is not None:
            # binds the trace to the slot and flushes the spans admission buffered
            self._engine.note_request_id(slot, ticket.request_id)
            self._telemetry.span(ticket.request_id, "admitted", slot=slot, resume=ticket.resume is not None)
        self._release_ticket(ticket)
        if hasattr(self._engine, "note_request_class"):
            # labels the slot for the per-class acceptance gauge
            self._engine.note_request_class(slot, class_name(ticket.priority))

    def _spec_sampling(self, ticket: Ticket) -> Dict[str, Any]:
        """The ticket's sampling with the class's speculation default
        (``SchedulerConfig.speculative_classes``) on an engine that speculates;
        a client's explicit ``speculative`` wins, and a plain engine gets the
        dict untouched (it rejects unknown keys)."""
        if not hasattr(self._engine, "speculation_stats"):
            return ticket.sampling
        sampling = dict(ticket.sampling)
        sampling.setdefault("speculative", class_name(ticket.priority) in self.scheduler.config.speculative_classes)
        return sampling

    def _admit_batch(self, batch: List[Ticket]) -> bool:  # graftlint: off-path (admission, not steady-state decode)
        """Admit popped tickets. A failure that left the engine intact (it
        rolled the call back) re-admits them one at a time, so only the raiser
        fails; an engine failure hands the tickets to recovery (they requeue
        untouched) and returns False."""
        engine = self._engine
        failures = engine.failure_count
        try:
            slots = engine.admit_many([(t.prompt, t.budget, self._spec_sampling(t)) for t in batch])
        except Exception as exc:
            logger.exception("admission failed")
            if engine.failure_count != failures or isinstance(exc, MeshDivergence):
                self._handle_engine_failure(exc, pending=batch)
                return False
            self._dispatch(engine.take_pending_events())
            if len(batch) == 1:
                self._release_ticket(batch[0])
                self._tel_end(batch[0], "error", "prefill_failed")
                self._deliver(batch[0].sink, "fail", _as_engine_failure(exc, "prefill_failed"))
                return True
            for ticket in batch:
                failures = engine.failure_count
                try:
                    (slot,) = engine.admit_many([(ticket.prompt, ticket.budget, self._spec_sampling(ticket))])
                except Exception as one_exc:
                    if engine.failure_count != failures or isinstance(one_exc, MeshDivergence):
                        self._handle_engine_failure(one_exc, pending=[ticket])
                        return False
                    self._dispatch(engine.take_pending_events())
                    self._release_ticket(ticket)
                    self._tel_end(ticket, "error", "prefill_failed")
                    self._deliver(ticket.sink, "fail", _as_engine_failure(one_exc, "prefill_failed"))
                    continue
                self._dispatch(engine.take_pending_events())
                self._register(slot, ticket)
            return True
        # a flush inside admission replays events of the slots' previous
        # occupants: deliver them under the old sinks before re-keying
        self._dispatch(engine.take_pending_events())
        for slot, ticket in zip(slots, batch):
            self._register(slot, ticket)
        return True

    def _dispatch(self, events: Sequence[StepEvent]) -> None:
        abandoned: List[int] = []
        for event in events:
            sink = self._sinks.get(event.slot)
            if sink is None:
                continue
            if sink.cancelled:  # consumer abandoned the stream mid-decode
                del self._sinks[event.slot]
                meta = self._slot_meta.pop(event.slot, None)
                if meta is not None:
                    self._tel_end(meta, "cancelled")
                if not event.finished:
                    abandoned.append(event.slot)
                continue
            if event.error is not None:
                del self._sinks[event.slot]
                meta = self._slot_meta.pop(event.slot, None)
                if meta is not None:
                    self._release_ticket(meta)
                    self._tel_end(meta, "error", event.error)
                if self.supervisor is not None:
                    self.supervisor.note_request_failed()
                self._deliver(sink, "fail", EngineFailure(
                    f"request terminated by the engine: {event.error}", reason=event.error))
                continue
            if event.emit:
                self._deliver(sink, "emit", event.token)
            if event.finished:
                del self._sinks[event.slot]
                meta = self._slot_meta.pop(event.slot, None)
                if meta is not None:
                    self._tel_end(meta, "ok")
                self._deliver(sink, "finish")
        if abandoned:
            # a cancel fetches the burst in flight, whose tokens come after
            # every event of this list: the other slots get them only now
            for slot in abandoned:
                self._engine.cancel(slot)
            self._dispatch(self._engine.take_pending_events())

    def _fail_all(self, exc: BaseException) -> None:  # graftlint: off-path (error path)
        failure = _as_engine_failure(exc)
        for ticket in self._slot_meta.values():
            self._tel_end(ticket, "error", failure.reason)
        for sink in self._sinks.values():
            self._deliver(sink, "fail", failure)
        self._sinks.clear()
        self._slot_meta.clear()
        self._engine.abort_all()

    def _fail_diverged(self, exc: MeshDivergence, pending: Sequence[Ticket]) -> None:  # graftlint: off-path (error path)
        """The meshed engine's ranks diverged and it refuses every call: the
        requests in flight, ``pending`` and the queue fail (nothing salvages
        or resumes; the pins go with the engine), and a supervisor ends
        ``failed``, each rebuild meeting the same refusal."""
        failure = EngineFailure(f"{type(exc).__name__}: {exc}", reason="mesh_diverged", retryable=False)
        for slot, sink in list(self._sinks.items()):
            meta = self._slot_meta.pop(slot, None)
            if meta is not None:
                self._tel_end(meta, "error", failure.reason)
            self._deliver(sink, "fail", failure)
        self._sinks.clear()
        self._slot_meta.clear()
        with self._lock:
            queued = self.scheduler.drain()
        for ticket in list(pending) + queued:
            self._tel_end(ticket, "error", failure.reason)
            self._deliver(ticket.sink, "fail", failure)
        if self.supervisor is not None:
            self.supervisor.note_failure(exc)
            self.supervisor.run_rebuild(self._engine.rebuild)

    # owns: kv-pin
    def _handle_engine_failure(self, exc: BaseException, pending: Sequence[Ticket] = ()) -> None:  # graftlint: off-path (error recovery)
        """Recover from an engine failure (``continuous.py:3436-3567``).

        With a supervisor: each salvaged request becomes a resume ticket
        (sink and delivered tokens kept, transcript as prompt, unspent budget,
        class and deadline unchanged) re-queued once the engine is rebuilt; a
        request that cannot resume fails with ``request_unrecoverable``; when
        every rebuild attempt fails, everything (resumes, ``pending``, the
        queue) is handed to :attr:`on_tickets_orphaned` (the fleet re-routes
        them to surviving replicas), each resume pin released on this engine
        first; what no replica takes fails with the supervisor's structured
        error. Without a supervisor: every request in flight fails,
        structured, and the salvage's pins are dropped. ``pending`` holds
        popped tickets of a failed admission; they requeue untouched.
        """
        engine = self._engine
        sup = self.supervisor
        if isinstance(exc, MeshDivergence):
            self._fail_diverged(exc, pending)
            return
        engine.note_external_failure()
        if sup is None:
            engine.discard_salvage()
            failure = _as_engine_failure(exc)
            for ticket in pending:
                self._release_ticket(ticket)
                self._tel_end(ticket, "error", failure.reason)
                self._deliver(ticket.sink, "fail", failure)
            self._fail_all(exc)
            return
        sup.note_failure(exc)
        resumes: List[Ticket] = []
        for rec in engine.take_salvage():
            sink = self._sinks.pop(rec.slot, None)
            meta = self._slot_meta.pop(rec.slot, None)
            pin = PreemptedSlot(tokens=list(rec.tokens), path=rec.path)
            if sink is None or meta is None or sink.cancelled:
                engine.release_preempted(pin)  # no consumer: drop the checkpoint
                if meta is not None:
                    self._tel_end(meta, "cancelled")
                continue
            try:
                engine.validate_request(rec.tokens, max(1, int(rec.remaining)), **meta.sampling)
            except Exception as not_resumable:
                engine.release_preempted(pin)
                self._release_ticket(meta)
                sup.note_request_failed()
                self._tel_end(meta, "error", "request_unrecoverable")
                self._deliver(sink, "fail", EngineFailure(
                    f"request not resumable after engine failure: {not_resumable}",
                    reason="request_unrecoverable", retryable=False))
                continue
            self._release_ticket(meta)  # the fresher checkpoint supersedes an older one
            meta.prompt = np.asarray(rec.tokens, dtype=np.int32)
            meta.budget = int(rec.remaining)
            meta.resume = pin
            meta.sink = sink
            if self._telemetry is not None:
                # the trace stays open across salvage, from the death to the resumed decode
                self._telemetry.span(meta.request_id, "salvaged", transcript_tokens=len(rec.tokens),
                                     remaining=int(rec.remaining))
            resumes.append(meta)
        failure = _as_engine_failure(exc)
        for slot, sink in list(self._sinks.items()):  # nothing salvageable behind these
            meta = self._slot_meta.pop(slot, None)
            if meta is not None:
                self._release_ticket(meta)
                self._tel_end(meta, "error", failure.reason)
            sup.note_request_failed()
            self._deliver(sink, "fail", failure)
        self._sinks.clear()
        self._slot_meta.clear()
        if engine.failed:
            rebuilt = sup.run_rebuild(engine.rebuild)
        else:
            sup.note_rebuilt()  # the engine rebuilt itself in place
            rebuilt = True
        if not rebuilt:
            # dead for good (``continuous.py:3529-3560``): every resume pin
            # points into this engine's pool, which no other engine can read,
            # so each is released here; the transcript-as-prompt carries the
            # resume to whichever replica adopts it
            orphans: List[Ticket] = []
            for ticket in resumes + list(pending) + self.scheduler.drain():
                self._release_ticket(ticket)
                orphans.append(ticket)
            unplaced: Sequence[Ticket] = orphans
            handoff = self.on_tickets_orphaned
            if handoff is not None and orphans:
                try:
                    unplaced = list(handoff(orphans))
                except Exception:
                    logger.exception("orphaned-ticket hand-off failed; failing all tickets")
                    unplaced = orphans
            if len(orphans) > len(unplaced):
                sup.note_recovered(len(orphans) - len(unplaced))
            unavailable = sup.unavailable_error()
            for ticket in unplaced:
                sup.note_request_failed()
                self._tel_end(ticket, "error", unavailable.reason)
                self._deliver(ticket.sink, "fail", unavailable)
            return
        for ticket in resumes + list(pending):
            self.scheduler.requeue(ticket, preemption=False)
        if resumes:
            sup.note_recovered(len(resumes))
        self._work.set()

    def _run(self) -> None:  # graftlint: hot-path
        # the worker issues its engine's device work on the engine's stream
        with self._engine._on_stream():
            self._loop()

    def _loop(self) -> None:
        engine = self._engine
        while True:
            with self._lock:
                if self._closed and not self.scheduler.depth and not self._sinks:
                    break
            if self.supervisor is not None and self.supervisor.state == "failed":
                # the engine is dead: its requests were failed and new ones are
                # refused, so nothing runs until close
                self._work.clear()
                self._work.wait(timeout=0.5)
                continue
            try:
                self._admit()
            except Exception as exc:  # policy engine work (a deadline cancel, a preempt) died
                logger.exception("admission round failed")
                self._handle_engine_failure(exc)
                continue
            busy = engine.num_active or engine.has_pending_prefill or engine.has_pending_events
            if not busy:
                self._work.clear()
                with self._lock:
                    if self.scheduler.depth or self._closed:
                        continue
                # bounded: the wait doubles as the queued-deadline tick and
                # a meshed engine's keep-alive (its followers wait meanwhile)
                self._work.wait(timeout=0.5)
                try:
                    engine.keep_alive()
                except Exception as exc:  # a follower is gone, or the last call diverged
                    logger.exception("meshed engine keep-alive failed")
                    self._handle_engine_failure(exc)
                continue
            # full house and work queued: shorter bursts readmit a retiring
            # slot within a few steps, without giving up the lookahead
            contended = bool(self.scheduler.depth) and not engine.free_slots
            try:
                events = engine.step(min(self._lookahead, 4) if contended else self._lookahead)
            except Exception as exc:
                logger.exception("continuous-batching step failed")
                self._handle_engine_failure(exc)
                continue
            try:
                self._dispatch(events)
            except Exception as exc:  # an abandoned stream's cancel fetched a failing burst
                logger.exception("event dispatch failed")
                self._handle_engine_failure(exc)
        self._drain_orphans()

    def drain(self, timeout_s: float = 5.0) -> None:
        """Graceful shutdown: refuse new submissions (``batcher_closed``)
        while queued and running requests decode to completion for up to
        ``timeout_s``, then :meth:`close`."""
        with self._lock:
            self._closed = True
        self._work.set()
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while time.monotonic() < deadline:
            worker = self._worker
            if worker is None or not worker.is_alive():
                break
            # advisory reads of worker-owned state: a stale one costs one poll
            if not self.scheduler.depth and not self._sinks and self._engine.num_active == 0:
                break
            time.sleep(0.02)
        self.close()

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop accepting requests, fail the queued ones with ``batcher_closed``,
        let running requests finish, and join the worker. Resume pins of the
        failed tickets are dropped on the worker (or here, once it stopped)."""
        closed = EngineFailure("batcher closed", reason="batcher_closed")
        with self._lock:
            self._closed = True
            queued = self.scheduler.drain()
            worker = self._worker
            for ticket in queued:
                if ticket.resume is not None:
                    self._orphans.append(ticket.resume)
                    ticket.resume = None
        for ticket in queued:
            self._tel_end(ticket, "shed", "batcher_closed")
            self._deliver(ticket.sink, "fail", closed)
        self._work.set()
        if worker is not None:
            worker.join(timeout=timeout_s)
            if worker.is_alive():
                raise RuntimeError(f"batcher worker did not stop within {timeout_s}s")
        self._drain_orphans()
        if self.supervisor is not None:
            self.supervisor.close()
        # a meshed engine's followers return from follow() (a no-op unmeshed)
        self._engine.stop_followers()
