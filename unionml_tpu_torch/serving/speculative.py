"""Speculative decoding on the paged engine, and a single-stream facade.

Port of ``unionml_tpu/serving/speculative.py``:

- :class:`SpeculativeEngine` (``:52-685``): speculation as a mode of the
  continuous-batching :class:`~unionml_tpu_torch.serving.continuous.DecodeEngine`.
  The draft's K/V lives in a second set of pool leaves indexed by the SAME
  block ids and tables, so admission and block accounting do not change. A
  round (heal, propose, verify, accept, emit, commit, adapt γ) is one device
  program: one CUDA graph per sampling switch on the card, dispatched ahead
  and fetched like a decode burst, with no host-to-device copy in steady state.
- :class:`SpeculativeBatcher` (``:687-923``): the single-stream facade over
  :func:`~unionml_tpu_torch.models.speculative.speculative_generate` (dense
  caches, fixed γ, batch 1).

Why a round is exact: every token choice (the round's bonus token, the draft's
proposals and the target's own choice at each chunk position) goes through ONE
rule, :func:`~unionml_tpu_torch.ops.sampling.keyed_select`, keyed by
``fold_in(slot key, position)``. A proposal is accepted iff it equals the
target's own choice at its position, so the emitted stream is, position by
position, what the target alone selects; the carried logits follow the last
fed token and the commit writes exactly the emitted tokens. Greedy streams
equal the vanilla engine's; sampled streams equal spec-off (γ = 0) streams of
the same engine bit for bit, and JAX's token for token (the keyed bits match).

A prefix-cache hit arms like a miss: the draft re-prefills the whole prompt
through the slot's table row, spliced shared blocks included (the draft
splice, ``speculative.py:443-500``). An engine failure rebuilds the draft pool
with the target's, and a rebuild drops the round graphs with the bursts'.
Behind ``ContinuousBatcher`` a request's class sets its speculation default
(``SchedulerConfig.speculative_classes``); ``SpeculativeBatcher`` takes turns
through the same SLO scheduler. With telemetry, each round feeds
``unionml_spec_proposed_total``/``unionml_spec_accepted_total``, a
``speculation`` span per armed slot, the per-class acceptance gauge and the
mean γ. Not ported here (raising ``NotImplementedError`` naming its ROADMAP
item where it is reachable): mesh sharding.
"""

import asyncio
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.models.gpt import init_block_pool, kv_pool_bytes, paged_commit_chunk
from unionml_tpu_torch.ops.sampling import keyed_select
from unionml_tpu_torch.serving.continuous import DecodeEngine, StepEvent, _Burst, on_engine_stream
from unionml_tpu_torch.serving.faults import EngineFailure, FaultPlan
from unionml_tpu_torch.serving.scheduler import DeadlineExceededError, SchedulerConfig, SLOScheduler, Ticket

__all__ = ["SpeculativeBatcher", "SpeculativeEngine"]


class SpeculativeEngine(DecodeEngine):
    """Continuous-batching decode engine with adaptive speculative rounds.

    Requests opt in through their sampling dict: ``{"speculative": True,
    "seed": ..., "gamma": ...}``. Whenever an active slot speculates or
    samples, :meth:`_dispatch_step` runs a round instead of a decode burst:
    select the bonus token from the carried logits; heal the draft's cache at
    the last committed position, then propose up to ``gamma_max`` tokens;
    verify the ``gamma_max + 1`` chunk in one target pass that leaves the pool
    untouched (:func:`~unionml_tpu_torch.models.gpt._paged_verify_chunk`);
    accept the longest prefix of proposals equal to the target's own choices;
    emit ``a + 1`` tokens under the vanilla retirement rule; commit exactly
    those (:func:`~unionml_tpu_torch.models.gpt.paged_commit_chunk`); and
    update each slot's acceptance EMA and γ on the device. The host replays
    the fetched masks into a mirror of the EMA/γ rule. γ = 0 is sticky until
    the slot re-arms: a request whose draft keeps missing decodes as vanilla.

    Sampled slots always go through the round (keyed selection), speculative
    or not, so spec-on and spec-off share one selection rule. ``top_k`` and
    ``top_p`` are rejected. A chunked-prefill admission is not armed: it
    decodes vanilla.

    :param model: the target :class:`~unionml_tpu_torch.models.gpt.GPTLMHeadModel`.
    :param draft: a cheaper GPT on the same vocabulary and device (the
        target itself for a self-draft).
    :param gamma_max: proposals per round at most (the verify chunk is
        ``gamma_max + 1`` tokens).
    :param gamma_init: γ of a newly armed slot unless its request names one.
    :param ema_beta / ema_hi / ema_lo: the acceptance EMA's weight and the
        thresholds above which γ grows and below which it shrinks.
    :param kwargs: :class:`DecodeEngine`'s (``paged`` must stay True).
    """

    def __init__(
        self,
        model: Any,
        draft: Any,
        *,
        gamma_max: int = 4,
        gamma_init: int = 2,
        ema_beta: float = 0.25,
        ema_hi: float = 0.6,
        ema_lo: float = 0.3,
        **kwargs: Any,
    ) -> None:
        if not kwargs.get("paged", True):
            raise ValueError("SpeculativeEngine requires paged=True (the shared block pool)")
        if int(gamma_max) < 1:
            raise ValueError(f"gamma_max must be >= 1, got {gamma_max}")
        if not 0 <= int(gamma_init) <= int(gamma_max):
            raise ValueError(f"gamma_init must be in [0, gamma_max], got {gamma_init}")
        if not 0.0 < float(ema_beta) <= 1.0:
            raise ValueError(f"ema_beta must be in (0, 1], got {ema_beta}")
        if not 0.0 <= float(ema_lo) < float(ema_hi) <= 1.0:
            raise ValueError(f"need 0 <= ema_lo < ema_hi <= 1, got lo={ema_lo} hi={ema_hi}")
        if draft.config.vocab_size != model.config.vocab_size:
            raise ValueError(f"draft vocab ({draft.config.vocab_size}) != target vocab "
                             f"({model.config.vocab_size}): acceptance compares token ids")
        max_len = int(kwargs.get("max_len") or model.config.max_position_embeddings)
        if draft.config.max_position_embeddings < max_len:
            raise ValueError(f"draft max_position_embeddings ({draft.config.max_position_embeddings}) "
                             f"< engine max_len ({max_len})")
        if draft.device != model.device:
            raise ValueError(f"draft lives on {draft.device}, target on {model.device}")
        # everything _init_device_state (run inside DecodeEngine.__init__) reads
        self._draft_model = draft
        self._draft_config = draft.config
        self._gamma_max = int(gamma_max)
        self._gamma_init = int(gamma_init)
        self._ema_beta, self._ema_hi, self._ema_lo = float(ema_beta), float(ema_hi), float(ema_lo)
        super().__init__(model, **kwargs)
        #: per-slot class labels (read by telemetry's per-class acceptance gauge)
        self._slot_class: Dict[int, str] = {}
        self.spec_rounds = 0  #: round bursts replayed
        self.spec_slot_rounds = 0  #: (slot, round) pairs that ran with γ > 0
        self.spec_proposed = 0  #: draft tokens proposed by those
        self.spec_accepted = 0  #: proposals the target accepted
        self.spec_fallback_rounds = 0  #: speculative slots' rounds at γ = 0
        self.spec_round_dispatches = 0
        self.draft_prefill_dispatches = 0
        self._spec_admissions = 0  # derives the keys of requests without a seed

    # ------------------------------------------------------------ device state

    def _init_device_state(self) -> None:
        super()._init_device_state()
        dev, n = self.device, self.num_slots
        # the draft pool mirrors the target's block for block (same ids, same
        # tables, draft shapes); every draft layer quantizes under kv_quantize
        self._draft_pool = init_block_pool(self._draft_config, self.pool_blocks, self.block_size,
                                           kv_quantize=self.kv_quantize, device=dev)
        self._gamma_dev = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._ema_dev = torch.ones((n,), dtype=torch.float32, device=dev)
        self._tprev_dev = torch.zeros((n,), dtype=torch.int64, device=dev)
        self._keys_dev = torch.zeros((n, 2), dtype=torch.int64, device=dev)
        # host mirrors of the device EMA/γ rule, replayed from fetched masks
        self._slot_gamma = np.zeros(n, dtype=np.int32)
        self._slot_ema = np.ones(n, dtype=np.float32)
        self._slot_spec = np.zeros(n, dtype=bool)

    # -------------------------------------------------------------- admission

    @staticmethod
    def _reject_unsupported_sampling(sampling: Dict[str, Any]) -> None:
        if sampling.get("top_k") or sampling.get("top_p") not in (None, 1.0):
            # engine-wide: a sampled sibling routes every burst through the
            # round, whose keyed selection implements temperature only
            raise ValueError("speculative engine supports temperature sampling only (no top_k/top_p)")

    def validate_request(self, prompt_ids: Sequence[int], max_new_tokens: int, *,
                         speculative: Optional[bool] = None, seed: Optional[int] = None,
                         gamma: Optional[int] = None, **sampling: Any):
        """The base validation, with the speculative keys accepted (and
        ignored) and top-k/top-p rejected. A request admissible to the vanilla
        engine is admissible here: verify never writes the pool, the commit
        writes only emitted tokens, and draft overshoot lands in scratch."""
        self._reject_unsupported_sampling(sampling)
        return super().validate_request(prompt_ids, max_new_tokens, **sampling)

    @on_engine_stream
    def admit_many(self, requests: Sequence[Tuple]) -> List[int]:
        """Peel ``speculative``/``seed``/``gamma`` off each sampling dict, admit
        through the base engine, then arm every admitted slot: its γ, EMA,
        last committed token and key rows, and for a speculative request the
        draft's prefill of the whole prompt through the slot's table row."""
        peeled, spec_args = [], []
        for req in requests:
            sampling = dict(req[2]) if len(req) > 2 and req[2] else {}
            spec = bool(sampling.pop("speculative", False))
            seed, gamma = sampling.pop("seed", None), sampling.pop("gamma", None)
            self._reject_unsupported_sampling(sampling)
            peeled.append((req[0], req[1], sampling))
            spec_args.append((spec, seed, gamma))
        slots = super().admit_many(peeled)
        try:
            for slot, req, (spec, seed, gamma) in zip(slots, peeled, spec_args):
                self._arm_slot(slot, np.asarray(req[0], dtype=np.int64).reshape(-1), spec, seed, gamma)
        except Exception:
            # the base admission committed the slots and arming writes device
            # state in place: a failure here is an engine failure
            self._on_failure()
            raise
        return slots

    def _arm_slot(self, slot: int, prompt: np.ndarray, spec: bool, seed: Optional[int],
                  gamma: Optional[int]) -> None:
        armed = spec and slot not in self._partials
        bucket = None
        if armed:
            try:
                bucket = self.bucket_for(int(prompt.size))
            except ValueError:
                armed = False
        g0 = (self._gamma_init if gamma is None else max(0, min(int(gamma), self._gamma_max))) if armed else 0
        self._slot_spec[slot] = armed
        self._slot_gamma[slot] = g0
        self._slot_ema[slot] = 1.0
        if seed is None:
            # a derived key: identical admission sequences draw identical keys
            seed = self._seed * 1_000_003 + self._spec_admissions
        self._spec_admissions += 1
        with self._device_write():
            self._gamma_dev[slot] = g0
            self._ema_dev[slot] = 1.0
            self._tprev_dev[slot] = int(prompt[-1])
            self._keys_dev[slot, 0] = (int(seed) >> 32) & 0xFFFFFFFF
            self._keys_dev[slot, 1] = int(seed) & 0xFFFFFFFF
        if armed:
            self._draft_prefill(slot, prompt, bucket)

    def _draft_prefill(self, slot: int, prompt: np.ndarray, bucket: int) -> None:
        """The draft's bucket prefill of the whole prompt (the K1 kernel),
        inserted into the draft pool through ``slot``'s table row.

        On a prefix-cache hit the row starts with shared blocks, whose draft
        leaves this rewrites (and so also fills for a prefix that a request
        without speculation indexed). On the CPU the rewrite is bitwise what
        was there; on the card a prefill of another row count may round
        differently, so a sibling reading those draft leaves may propose other
        tokens. The target alone decides what is emitted, so no stream
        changes, only acceptance."""
        ids = np.zeros((1, bucket), dtype=np.int64)
        ids[0, : prompt.size] = prompt
        lengths = torch.tensor([prompt.size], device=self.device)
        local_cache, _ = self._prefill(torch.from_numpy(ids).to(self.device), lengths, self._draft_model)
        with self._device_write():
            self._paged_insert(local_cache, None, torch.tensor([slot], device=self.device), lengths,
                               pool=self._draft_pool)
        self.draft_prefill_dispatches += 1
        if self._telemetry is not None:
            self._note_span(slot, "draft_prefill", tokens=int(prompt.size), bucket=int(bucket))

    def note_request_class(self, slot: int, cls: Optional[str]) -> None:
        """Label ``slot``'s occupant with its SLO class (the batcher sets it)
        so the acceptance gauge can report per class."""
        if cls is not None:
            self._slot_class[slot] = str(cls)

    # ------------------------------------------------------------ round program

    def _round(self, sampling: bool):
        """One speculative round over every slot, in place on the static
        buffers (``speculative.py:231-358``). Returns ``(tokens, masks,
        bads)``, each ``(gamma_max + 1, num_slots)``: the burst contract."""
        model, draft = self._model, self._draft_model
        S, n = self._gamma_max + 1, self.num_slots
        tables, pool, d_pool = self._tables, self._pool, self._draft_pool
        last_logits, lens, remaining = self._last_logits, self._lens, self._remaining_dev
        gamma, ema, t_prev = self._gamma_dev, self._ema_dev, self._tprev_dev
        keys, temp = self._keys_dev, self._temp_dev
        active = self._active_dev.clone()
        sentinel = torch.full_like(lens, (self._table_width - 1) * self.block_size)
        rows = torch.arange(n, device=self.device)

        def select(logits, positions):
            if sampling:
                return keyed_select(logits, keys, positions, temp)
            return torch.argmax(logits, dim=-1)

        drafting = active & (gamma > 0)
        e0 = select(last_logits, lens)
        with torch.no_grad():
            # draft: heal position lens - 1 (the previous round's last accepted
            # proposal was selected but never fed to the draft), then propose
            dcache = {"table": tables, **d_pool}
            draft(t_prev[:, None], cache=dcache, position=torch.where(drafting, torch.clamp_min(lens - 1, 0), sentinel))
            dlog, _ = draft(e0[:, None], cache=dcache, position=torch.where(drafting, lens, sentinel))
            props = []
            for j in range(1, S):
                props.append(select(dlog[:, -1, :], lens + j))
                if j < S - 1:
                    dlog, _ = draft(props[-1][:, None], cache=dcache,
                                    position=torch.where(drafting, lens + j, sentinel))
            # verify: one S-token target pass, the pool untouched
            chunk = torch.stack([e0] + props, dim=1)  # (n, S)
            vlogits, vcache = model(chunk, cache={"table": tables, **pool},
                                    position=torch.where(active, lens, sentinel))
        # accept: the longest prefix of proposals equal to the target's own choices
        sel = torch.stack([select(vlogits[:, j, :], lens + 1 + j) for j in range(S - 1)], dim=1)
        steps = torch.arange(1, S, device=self.device)
        ok = (chunk[:, 1:] == sel) & (steps[None, :] <= gamma[:, None]) & active[:, None]
        a = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        plan = a + 1  # the bonus token always emits
        # emit: a + 1 tokens under the vanilla retirement rule
        act, rem, cur_lens = active, remaining.clone(), lens.clone()
        mask_rows, bad_rows = [], []
        for j in range(S):
            tok = chunk[:, j]
            em = act & (j < plan)
            src = last_logits if j == 0 else vlogits[:, j - 1, :]
            bad_rows.append(~torch.isfinite(src).all(dim=-1))
            mask_rows.append(em)
            rem = torch.where(em, rem - 1, rem)
            cur_lens = torch.where(em, torch.clamp_max(cur_lens + 1, self.max_len - 1), cur_lens)
            finished = (rem <= 0) | (cur_lens >= self.max_len - 1)
            if self.eos_token_id is not None:
                finished = finished | (tok == self.eos_token_id)
            act = act & ~(em & finished)
        masks = torch.stack(mask_rows)
        m = masks.to(torch.int32).sum(dim=0)  # tokens fed and emitted per row
        # commit exactly the emitted tokens into the target pool
        for name, layer in pool.items():
            paged_commit_chunk(layer, tables, lens, m, vcache[name]["ck"], vcache[name]["cv"])
        # carry: the logits and token of the last fed token
        last_idx = torch.clamp(m - 1, 0, S - 1).long()
        fed = m > 0
        last_logits.copy_(torch.where(fed[:, None], vlogits[rows, last_idx], last_logits))
        t_prev.copy_(torch.where(fed, chunk[rows, last_idx], t_prev))
        # adaptive γ from the acceptance EMA (γ = 0 is sticky)
        alpha = a.float() / torch.clamp_min(gamma, 1).float()
        new_ema = torch.where(drafting, (1.0 - self._ema_beta) * ema + self._ema_beta * alpha, ema)
        bump = (new_ema >= self._ema_hi).to(torch.int32) - (new_ema < self._ema_lo).to(torch.int32)
        gamma.copy_(torch.where(drafting, torch.clamp(gamma + bump, 0, self._gamma_max), gamma))
        ema.copy_(new_ema)
        lens.copy_(cur_lens)
        self._active_dev.copy_(act)
        remaining.copy_(rem)
        return chunk.t().contiguous(), masks, torch.stack(bad_rows)

    # ---------------------------------------------------------- dispatch/replay

    def _dispatch_step(self, lookahead: int) -> _Burst:
        """A round whenever an active slot speculates or samples, else the
        base (all-greedy) burst, whose argmax is the round's greedy selection.
        A round ignores ``lookahead``: it already emits up to
        ``gamma_max + 1`` tokens per slot."""
        if not (self._active & (self._slot_spec | (self._slot_temp > 0))).any():
            return super()._dispatch_step(lookahead)
        sampling = bool((self._slot_temp[self._active] > 0).any())
        if self._faults is not None:
            self._faults.check_step_dispatch()
        out = self._run_program(("round", sampling), lambda: self._round(sampling))
        self.spec_round_dispatches += 1
        return self._enqueue_fetch(out, self._gamma_max + 1, round=True)

    def _replay_burst(self, burst: _Burst, skip=frozenset()) -> List[StepEvent]:
        """The base replay; for a round also the host mirror of the device
        EMA/γ rule: each clean event of a slot is one fed token, so
        ``a = fed - 1`` (a slot that retired inside the round under-counts its
        last round only; its state dies with it)."""
        if not burst.round:
            return super()._replay_burst(burst, skip)
        gammas, spec = self._slot_gamma.copy(), self._slot_spec.copy()
        events = super()._replay_burst(burst, skip)
        fed: Dict[int, int] = {}
        for ev in events:
            if ev.error is None:
                fed[ev.slot] = fed.get(ev.slot, 0) + 1
        self.spec_rounds += 1
        telemetry = self._telemetry
        for slot, m in fed.items():
            if not spec[slot]:
                continue
            g = int(gammas[slot])
            if g <= 0:
                self.spec_fallback_rounds += 1
                continue
            a = max(0, min(m - 1, g))
            self.spec_slot_rounds += 1
            self.spec_proposed += g
            self.spec_accepted += a
            ema = (1.0 - self._ema_beta) * float(self._slot_ema[slot]) + self._ema_beta * (a / g)
            self._slot_ema[slot] = ema
            bump = 1 if ema >= self._ema_hi else (-1 if ema < self._ema_lo else 0)
            self._slot_gamma[slot] = min(self._gamma_max, max(0, g + bump))
            if telemetry is not None:
                telemetry.spec_proposed_total.inc(float(g))
                telemetry.spec_accepted_total.inc(float(a))
                self._note_span(slot, "speculation", gamma=g, accepted=a, alpha=round(a / g, 4))
        if telemetry is not None:
            live = self._active & self._slot_spec
            by_class: Dict[str, List[float]] = {}
            for slot in np.flatnonzero(live):
                cls = self._slot_class.get(int(slot), "standard")
                by_class.setdefault(cls, []).append(float(self._slot_ema[int(slot)]))
            for cls, vals in by_class.items():
                telemetry.spec_acceptance.set(sum(vals) / len(vals), cls)
            if live.any():
                telemetry.spec_gamma.set(float(self._slot_gamma[live].mean()))
        return events

    def abort_all(self) -> None:
        super().abort_all()
        self._slot_spec[:] = False
        self._slot_gamma[:] = 0
        self._slot_class.clear()

    # ---------------------------------------------------------- observability

    def kv_pool_stats(self) -> Dict[str, Any]:
        """The base pool accounting plus the draft leaves, which speculation
        keeps resident for every block."""
        stats = super().kv_pool_stats()
        stored, full = kv_pool_bytes(self._draft_pool, self._draft_config.dtype)
        stats["kv_pool_bytes"] += stored
        stats["kv_pool_bytes_dense_equiv"] += full
        stats["draft_kv_pool_bytes"] = stored
        return stats

    def speculation_stats(self) -> Dict[str, Any]:
        """The ``generation.speculation`` block of ``GET /stats``.
        ``accepted_per_target_step`` counts every armed slot-round as one
        target pass, γ = 0 rounds included, so vanilla decoding reads 1.0."""
        live = self._active & self._slot_spec
        ran = self.spec_slot_rounds + self.spec_fallback_rounds
        return {
            "enabled_slots": int(live.sum()),
            "gamma_max": self._gamma_max,
            "rounds": self.spec_rounds,
            "round_dispatches": self.spec_round_dispatches,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "fallback_rounds": self.spec_fallback_rounds,
            "acceptance_ema": round(float(self._slot_ema[live].mean()), 4) if live.any() else None,
            "gamma": round(float(self._slot_gamma[live].mean()), 4) if live.any() else None,
            "accepted_per_target_step": round((self.spec_accepted + ran) / ran, 4) if ran else None,
        }


class SpeculativeBatcher:
    """Single-stream speculative generation behind the batcher contract.

    Requests route through the same SLO scheduler as
    :class:`~unionml_tpu_torch.serving.continuous.ContinuousBatcher`
    (:mod:`unionml_tpu_torch.serving.scheduler`): a bounded queue with
    structured sheds and displacement, priority-ordered turn-taking for the
    single stream, and deadlines enforced while queued, so ``GET /stats``
    reports one scheduler block whichever generator serves ``/generate``.
    Preemption does not apply (a batch-1 loop with no KV checkpoint to take).
    Each request runs through
    :func:`~unionml_tpu_torch.models.speculative.speculative_generate`. A
    request with a ``seed`` draws from a generator of that seed; others from
    the batcher's own, so identical unseeded sampled requests differ.
    ``faults``: a :class:`~unionml_tpu_torch.serving.faults.FaultPlan` whose
    ``speculative_round_failures`` fail those rounds' requests, structured.
    """

    def __init__(self, target: Any, draft: Any, *, gamma: int = 4, max_len: Optional[int] = None,
                 scheduler: Optional[Any] = None, faults: Optional[FaultPlan] = None, device="cuda") -> None:
        self.device = resolve_device(device)
        if target.device.type != self.device.type:
            raise ValueError(f"target lives on {target.device}, batcher device is {self.device}")
        self._target, self._draft, self._gamma = target, draft, int(gamma)
        self._max_len = int(max_len or target.config.max_position_embeddings)
        self.scheduler = scheduler if isinstance(scheduler, SLOScheduler) else SLOScheduler(
            scheduler if isinstance(scheduler, SchedulerConfig) else None)
        #: turn-taking for the single stream: executor threads wait here until
        #: the scheduler ranks their ticket first and no request runs
        self._turn = threading.Condition()
        self._current: Optional[Ticket] = None  # guarded-by: _turn
        self._closed = False
        self._lock = threading.Lock()  # serializes device work
        self._generator = torch.Generator(device=self.device)  # guarded-by: _lock
        self._generator.manual_seed(0)
        self.round_failures = 0  # guarded-by: _lock
        self._faults = faults  # guarded-by: _lock
        # the /stats view: one slot, and the continuous engine's counters;
        # bucket_for is the route's prompt check (no bucket ladder here)
        self.engine = SimpleNamespace(  # guarded-by: _lock
            num_slots=1, num_active=0, max_len=self._max_len, bucket_for=lambda n: n,
            requests_admitted=0, tokens_decoded=0, prefill_tokens_computed=0,
        )

    def _validate(self, prompt_ids: Sequence[int], max_new_tokens: int, sampling: dict):
        if self._closed:
            raise RuntimeError("SpeculativeBatcher is closed")
        prompt = np.asarray(list(prompt_ids), dtype=np.int64)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt_ids must be a non-empty 1-D token list")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens + self._gamma + 1 > self._max_len:
            need = prompt.size + max_new_tokens
            detail = "the request alone" if need > self._max_len else (
                f"the draft working window (gamma={self._gamma} proposals + 1 bonus token may be in flight "
                f"past the last emitted position)")
            raise ValueError(f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) exceeds max_len "
                             f"({self._max_len}) once the speculative round slack is reserved: {detail} is the "
                             f"binding constraint; lower max_new_tokens or gamma")
        if sampling.get("top_k") or sampling.get("top_p") not in (None, 1.0):
            raise ValueError("speculative decoding supports temperature sampling only (no top_k/top_p)")
        return prompt, float(sampling.get("temperature", 0.0) or 0.0), sampling.get("seed")

    def _await_turn(self, ticket: Ticket) -> None:
        """Block until the scheduler ranks ``ticket`` first and the stream is
        free. Raises the ticket's shed error when a later, higher-class submit
        displaced it, and ``DeadlineExceededError`` when its deadline passes
        while queued."""
        with self._turn:
            while True:
                if self._closed:
                    self.scheduler.remove(ticket)
                    raise RuntimeError("SpeculativeBatcher is closed")
                if ticket.shed_exc is not None:  # displaced under a full queue
                    raise ticket.shed_exc
                if ticket.expired(time.monotonic()):
                    # removes this ticket (and expired peers, whose threads
                    # raise on their next poll) and counts the misses
                    self.scheduler.take_expired()
                    raise DeadlineExceededError("deadline expired while queued")
                if self._current is None and self.scheduler.peek() is ticket:
                    if not self.scheduler.pop_ticket(ticket):
                        raise RuntimeError("ticket vanished from the scheduler queue")
                    self._current = ticket
                    return
                self._turn.wait(timeout=0.02)

    def _run(self, ticket: Ticket, max_new_tokens: int, temperature: float, seed) -> List[int]:
        from unionml_tpu_torch.models.speculative import speculative_generate

        self._await_turn(ticket)
        try:
            with self._lock:
                generator = self._generator
                if seed is not None:
                    generator = torch.Generator(device=self.device)
                    generator.manual_seed(int(seed))
                prompt = torch.from_numpy(ticket.prompt).to(self.device)[None, :]
                self.engine.num_active = 1
                self.engine.requests_admitted += 1
                try:
                    if self._faults is not None:
                        self._faults.check_speculative_round()
                    out = speculative_generate(self._target, self._draft, prompt, max_new_tokens, gamma=self._gamma,
                                               temperature=temperature, generator=generator)
                except Exception as exc:
                    # every round's state is call-local: a failure costs this request only
                    self.round_failures += 1
                    raise EngineFailure(f"speculative round failed: {exc}",
                                        reason="speculative_round_failed") from exc
                finally:
                    self.engine.num_active = 0
                tokens = out[0, ticket.prompt.size:].tolist()
                self.engine.prefill_tokens_computed += int(ticket.prompt.size)
                self.engine.tokens_decoded += len(tokens)
            return tokens
        finally:
            with self._turn:
                self._current = None
                self._turn.notify_all()

    async def generate(self, prompt_ids: Sequence[int], max_new_tokens: int, *, priority: Any = None,
                       deadline_ms: Optional[float] = None, request_id: Optional[str] = None,
                       **sampling) -> List[int]:
        prompt, temperature, seed = self._validate(prompt_ids, max_new_tokens, sampling)
        # sheds raise here, on the caller's side, before any device work
        ticket = self.scheduler.make_ticket(prompt, int(max_new_tokens), sampling, None, priority=priority,
                                            deadline_ms=deadline_ms)
        ticket.request_id = request_id
        displaced = self.scheduler.submit(ticket)
        if displaced is not None:
            with self._turn:  # wake the displaced ticket's waiting thread
                self._turn.notify_all()
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self._run, ticket, int(max_new_tokens), temperature, seed)

    async def stream(self, prompt_ids: Sequence[int], max_new_tokens: int, *, priority: Any = None,
                     deadline_ms: Optional[float] = None, request_id: Optional[str] = None, **sampling):
        """Tokens in one burst at completion: a round verifies whole proposal
        chunks, so there is no per-token step to stream from."""
        for token in await self.generate(prompt_ids, max_new_tokens, priority=priority, deadline_ms=deadline_ms,
                                         request_id=request_id, **sampling):
            yield token

    def close(self) -> None:
        self._closed = True
        with self._turn:  # wake queued waiters so they fail promptly
            self._turn.notify_all()
