"""Training loops for the port's classifiers and causal LMs: AdamW with optax's arithmetic.

Port of ``unionml_tpu/models/training.py`` for one device, run eagerly (no
``torch.compile``):

- :func:`create_train_state` — AdamW (b1 0.9, b2 0.999, eps 1e-8 added after
  the square root, decoupled weight decay on every parameter), global-norm
  clipping and a linear-warmup / cosine-decay schedule, written as plain
  torch (``torch._foreach_*``) with the arithmetic of ``optax.chain(
  clip_by_global_norm, adamw)`` (``training.py:56-75``). ``torch.optim.AdamW``
  is not used: it has no ``mu_dtype`` and ``clip_grad_norm_`` adds 1e-6.
- :func:`make_classifier_train_step` / :func:`make_classifier_eval_step` —
  the step functions ``(state, batch) -> (state, metrics)`` and ``(state,
  batch) -> metrics``. Metrics stay device tensors: a step never syncs with
  the host.
- :func:`make_lm_train_step` / :func:`make_lm_eval_step` — the causal-LM
  steps of ``training.py:217-311`` (packed rows carry ``segment_ids``);
  :func:`fit_lm` packs ragged sequences (or right-pads them one per row) and
  runs them through :func:`fit` (``training.py:524-603``).
- :func:`fit` — the loop of ``training.py:363-521``: the first step runs
  outside the timed window, the barrier is a host fetch of the loss; with
  ``checkpoint_dir`` it resumes from the latest step checkpoint, saves every
  step the interval admits and flushes at the end (``training.py:465-508``).

Unlike the JAX package, the train step updates the state IN PLACE (the
model's parameters and the moments) and returns the same object.
Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP item):
meshes and parameter specs (M12), the native prefetcher, and the MoE
auxiliary losses (M13).
"""

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.models.gpt import lm_loss
from unionml_tpu_torch.ops.losses import cross_entropy_and_accuracy
from unionml_tpu_torch.ops.packing import pack_sequences, packing_efficiency

__all__ = [
    "FitResult",
    "TrainState",
    "bert_flops_per_token",
    "classifier_grads",
    "create_train_state",
    "dict_batches",
    "dropout_generator",
    "fit",
    "fit_lm",
    "lm_grads",
    "make_classifier_eval_step",
    "make_classifier_train_step",
    "make_lm_eval_step",
    "make_lm_train_step",
]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it: the float32
    0.999 is 1.3e-5 away from 0.999 in relative terms after ``1 - b2``."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet (ROADMAP: {item})")


@dataclass(eq=False)
class TrainState:
    """A model, its AdamW moments and the step count.

    ``params`` are the model's parameters in ``model.named_parameters()``
    order (``names``); ``mu`` (in ``mu_dtype`` when given) and ``nu`` follow
    the same order. ``step`` counts applied updates, as optax's count does.
    """

    model: nn.Module = field(repr=False)
    names: List[str] = field(repr=False)
    params: List[torch.Tensor] = field(repr=False)
    mu: List[torch.Tensor] = field(repr=False)
    nu: List[torch.Tensor] = field(repr=False)
    learning_rate: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    max_grad_norm: float
    seed: int
    mu_dtype: Optional[torch.dtype] = None
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def learning_rate_at(self, count: int) -> float:
        """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, max(total,
        warmup + 1))`` (end value 0) at ``count``, in float32 as optax
        evaluates it; the constant ``lr`` without warmup."""
        if self.warmup_steps <= 0:
            return self.learning_rate
        f32 = np.float32
        peak, warmup = f32(self.learning_rate), self.warmup_steps
        if count < warmup:
            frac = f32(1.0) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float((f32(0.0) - peak) * frac + peak)
        decay = f32(max(self.total_steps, warmup + 1) - warmup)
        t = min(f32(count - warmup), decay)
        return float(peak * (f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t / decay))))

    @torch.no_grad()
    def apply_gradients(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """One optimizer update in place; returns the global norm of ``grads``
        (before clipping) as a device tensor.

        optax's arithmetic: ``g if norm < max else g / norm * max`` (here
        ``g / denom * max`` with ``denom = max`` below the threshold: exact for
        the default max 1.0, within an ulp otherwise); adam moments
        ``(1-b)*g^k + b*m``, bias correction (in float32) at the incremented count,
        ``mu_hat / (sqrt(nu_hat) + eps)``, plus ``weight_decay * p``, times
        ``-lr`` at the pre-increment count, added to the parameters.
        """
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        denom = torch.where(norm < self.max_grad_norm, torch.full_like(norm, self.max_grad_norm), norm)
        clipped = torch._foreach_div(grads, denom)
        torch._foreach_mul_(clipped, self.max_grad_norm)

        if self.mu_dtype is not None:
            # optax's weak-typed ``b1 * mu`` runs in mu_dtype, b1 rounded to
            # it first (0.8984375 in bf16); the sum with the f32 gradient term is f32
            b1 = float(torch.tensor(_B1, dtype=self.mu_dtype))
            mu = [m.float() for m in torch._foreach_mul(self.mu, b1)]
        else:
            mu = self.mu
            torch._foreach_mul_(mu, _B1)
        torch._foreach_add_(mu, clipped, alpha=1.0 - _B1)
        torch._foreach_mul_(self.nu, _B2)
        torch._foreach_addcmul_(self.nu, clipped, clipped, value=1.0 - _B2)
        count = self.step + 1
        updates = torch._foreach_div(mu, _bias_correction(_B1, count))
        denoms = torch._foreach_div(self.nu, _bias_correction(_B2, count))
        torch._foreach_sqrt_(denoms)
        torch._foreach_add_(denoms, _EPS)
        torch._foreach_div_(updates, denoms)
        torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(updates, -self.learning_rate_at(self.step))
        torch._foreach_add_(self.params, updates)
        if self.mu_dtype is not None:
            for stored, value in zip(self.mu, mu):
                stored.copy_(value)
        self.step = count
        return norm


def create_train_state(
    model: nn.Module,
    learning_rate: float = 2e-5,
    weight_decay: float = 0.01,
    warmup_steps: int = 0,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
    seed: int = 0,
    mu_dtype: Optional[torch.dtype] = None,
) -> TrainState:
    """AdamW + linear warmup / cosine decay + global-norm clipping (the BERT
    fine-tune recipe) over ``model``'s parameters.

    ``mu_dtype`` (e.g. ``torch.bfloat16``) stores adam's first moment in
    reduced precision; the second moment stays in the parameters' dtype.
    ``seed`` seeds the per-step dropout generators.
    """
    names, params = zip(*model.named_parameters())
    return TrainState(
        model=model,
        names=list(names),
        params=list(params),
        mu=[torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params],
        nu=[torch.zeros_like(p) for p in params],
        learning_rate=learning_rate,
        weight_decay=weight_decay,
        warmup_steps=warmup_steps,
        total_steps=total_steps,
        max_grad_norm=max_grad_norm,
        seed=seed,
        mu_dtype=mu_dtype,
    )


def dropout_generator(seed: int, step: int, device: torch.device, index: Optional[int] = None) -> torch.Generator:
    """The dropout generator of one step (and microbatch ``index``): seeded
    from ``(seed, step[, index])``, the counterpart of the JAX step's
    ``fold_in(dropout_rng, step)`` (``training.py:136``)."""
    words = [seed, step] if index is None else [seed, step, index]
    generator = torch.Generator(device=device)
    generator.manual_seed(int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return generator


def _microbatch_grads(
    state: TrainState, batch: Dict[str, torch.Tensor], grad_accum: int, loss_fn: Callable
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``(grads, values)`` of one step, dropout on: ``loss_fn(microbatch,
    generator)`` returns the loss to differentiate first, then any metrics.

    With ``grad_accum > 1`` the batch splits into equal sequential
    microbatches (each with its own dropout generator), whose gradients and
    values are summed and divided by ``grad_accum``: the mean of means of
    ``_accumulated_value_and_grad`` (``training.py:78-109``).
    """
    rows = len(next(iter(batch.values())))
    if rows % grad_accum:
        raise ValueError(f"grad_accum={grad_accum} must divide the batch size ({rows})")
    size = rows // grad_accum
    total = sums = None
    for index in range(grad_accum):
        micro = batch if grad_accum == 1 else {k: v[index * size:(index + 1) * size] for k, v in batch.items()}
        generator = dropout_generator(state.seed, state.step, state.device, None if grad_accum == 1 else index)
        loss, *extras = loss_fn(micro, generator)
        grads = list(torch.autograd.grad(loss, state.params))
        values = [loss.detach(), *extras]
        if total is None:
            total, sums = grads, values
        else:
            torch._foreach_add_(total, grads)
            sums = [a + b for a, b in zip(sums, values)]
    if grad_accum > 1:
        torch._foreach_div_(total, grad_accum)
        sums = [v / grad_accum for v in sums]
    return total, sums


def classifier_grads(
    state: TrainState, batch: Dict[str, torch.Tensor], input_signature: Tuple[str, ...], grad_accum: int = 1
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """``(grads, loss, accuracy)`` of one classifier train step, dropout on,
    over ``grad_accum`` microbatches (see :func:`_microbatch_grads`)."""

    def loss_fn(micro, generator):
        logits = state.model(*[micro[k] for k in input_signature], deterministic=False, generator=generator)
        return cross_entropy_and_accuracy(logits, micro["labels"])

    grads, (loss, acc) = _microbatch_grads(state, batch, grad_accum, loss_fn)
    return grads, loss, acc


def _lm_loss(model: nn.Module, batch: Dict[str, torch.Tensor], packed: bool, **kwargs) -> torch.Tensor:
    """``lm_loss`` of ``model`` on an LM batch: ``input_ids``, ``segment_ids``
    (looked up strictly) when packed, and an optional ``mask``."""
    # strict lookup: a packed step fed a batch without segment ids must fail,
    # not silently train across packed-sequence boundaries (training.py:250-252)
    segment_ids = batch["segment_ids"] if packed else None
    logits = model(batch["input_ids"], segment_ids=segment_ids, **kwargs)
    return lm_loss(logits, batch["input_ids"], mask=batch.get("mask"), segment_ids=segment_ids)


def lm_grads(
    state: TrainState, batch: Dict[str, torch.Tensor], packed: bool = False, grad_accum: int = 1
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(grads, loss)`` of one causal-LM train step, dropout on, over
    ``grad_accum`` microbatches (each weighted equally, as in JAX)."""

    def loss_fn(micro, generator):
        return (_lm_loss(state.model, micro, packed, deterministic=False, generator=generator),)

    grads, (loss,) = _microbatch_grads(state, batch, grad_accum, loss_fn)
    return grads, loss


def make_classifier_train_step(
    mesh: Any = None,
    param_spec: Any = None,
    input_signature: Tuple[str, ...] = ("inputs",),
    light_metrics: bool = False,
    grad_accum: int = 1,
) -> Callable:
    """The train step ``(state, batch) -> (state, metrics)``.

    ``batch`` is a dict of device tensors with the ``input_signature`` keys
    and ``"labels"``. Metrics: ``loss``, ``accuracy`` and, unless
    ``light_metrics``, ``grad_norm`` (before clipping), all device tensors.
    ``grad_accum=N`` splits each batch into N sequential microbatches whose
    gradients average before the one optimizer step.
    """
    if mesh is not None or param_spec is not None:
        raise _not_ported("mesh / param_spec (sharded training)", "M12")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        grads, loss, acc = classifier_grads(state, batch, input_signature, grad_accum)
        norm = state.apply_gradients(grads)
        metrics = {"loss": loss, "accuracy": acc}
        if not light_metrics:
            metrics["grad_norm"] = norm
        return state, metrics

    return train_step


def make_classifier_eval_step(input_signature: Tuple[str, ...] = ("inputs",)) -> Callable:
    """The eval step ``(state, batch) -> {"loss", "accuracy"}``, dropout off."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        logits = state.model(*[batch[k] for k in input_signature], deterministic=True)
        loss, acc = cross_entropy_and_accuracy(logits, batch["labels"])
        return {"loss": loss, "accuracy": acc}

    return eval_step


def _check_lm_options(mesh, param_spec, grad_accum: int, moe_aux: bool) -> None:
    if mesh is not None or param_spec is not None:
        raise _not_ported("mesh / param_spec (sharded training)", "M12")
    if moe_aux:
        raise _not_ported("moe_aux (the MoE router's auxiliary losses)", "M13")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")


def make_lm_train_step(
    packed: bool = False,
    light_metrics: bool = False,
    grad_accum: int = 1,
    moe_aux: bool = False,
    mesh: Any = None,
    param_spec: Any = None,
) -> Callable:
    """The causal-LM train step ``(state, batch) -> (state, metrics)``
    (``training.py:217-288``).

    ``batch`` carries ``"input_ids"`` plus, with ``packed=True``, the
    ``"segment_ids"`` of :func:`~unionml_tpu_torch.ops.packing.pack_sequences`;
    unpacked batches may carry a ``"mask"`` (1 = real token). Metrics:
    ``loss`` and, unless ``light_metrics``, ``grad_norm`` (before clipping),
    device tensors. ``grad_accum=N`` averages N sequential microbatches.
    """
    _check_lm_options(mesh, param_spec, grad_accum, moe_aux)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        grads, loss = lm_grads(state, batch, packed, grad_accum)
        norm = state.apply_gradients(grads)
        metrics = {"loss": loss}
        if not light_metrics:
            metrics["grad_norm"] = norm
        return state, metrics

    return train_step


def make_lm_eval_step(packed: bool = False) -> Callable:
    """The causal-LM eval step ``(state, batch) -> {"loss", "perplexity"}``,
    dropout off (``training.py:291-311``): the masked mean next-token
    cross-entropy over the batch's real transitions and its exp."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss = _lm_loss(state.model, batch, packed, deterministic=True)
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return eval_step


@dataclass
class FitResult:
    state: TrainState
    metrics_history: list = field(default_factory=list)
    steps: int = 0
    wall_time_s: float = 0.0
    steps_per_s: float = 0.0
    examples_per_s: float = 0.0


def dict_batches(
    data: Dict[str, np.ndarray],
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    device: Any = "cuda",
    drop_remainder: bool = True,
    mesh: Any = None,
) -> Iterable[Dict[str, torch.Tensor]]:
    """Static-shape dict batches of host ``data``, each copied to ``device``."""
    if mesh is not None:
        raise _not_ported("mesh (sharded batches)", "M12")
    device = resolve_device(device)
    host = {k: np.asarray(v) for k, v in data.items()}
    n_rows = len(next(iter(host.values())))
    indices = np.arange(n_rows) if rng is None else rng.permutation(n_rows)
    end = (n_rows // batch_size) * batch_size if drop_remainder else n_rows
    if end == 0:
        end = n_rows
    for start in range(0, end, batch_size):
        idx = indices[start:start + batch_size]
        yield {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(device) for k, v in host.items()}


def fit(
    state: TrainState,
    data: Dict[str, np.ndarray],
    *,
    batch_size: int,
    num_epochs: int = 1,
    num_steps: Optional[int] = None,
    mesh: Any = None,
    param_spec: Any = None,
    input_signature: Tuple[str, ...] = ("inputs",),
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    log_every: int = 50,
    seed: int = 0,
    prefetch: bool = False,
    prefetch_convert: Optional[Dict[str, str]] = None,
    step_fn: Optional[Callable] = None,
    grad_accum: int = 1,
) -> FitResult:
    """Run the train loop over host ``data`` on the state's device.

    The first step runs outside the timed window; ``num_steps`` (counting
    that first step) overrides ``num_epochs``. Every ``log_every`` steps the
    metrics are fetched to the host into ``metrics_history``.

    ``checkpoint_dir`` turns on step checkpoints
    (:class:`~unionml_tpu_torch.checkpoint.Checkpointer`, every
    ``checkpoint_every`` steps, with the SIGTERM flush): a directory that
    already holds one resumes from its latest step, restored in place into
    ``state``.
    """
    if mesh is not None or param_spec is not None:
        raise _not_ported("mesh / param_spec (sharded training)", "M12")
    if prefetch or prefetch_convert:
        raise _not_ported("prefetch / prefetch_convert", "the native prefetcher, slice 2b")
    if step_fn is not None and grad_accum != 1:
        raise ValueError("grad_accum applies to the built-in step; pass it to your step builder")
    if step_fn is None:
        step_fn = make_classifier_train_step(input_signature=input_signature, grad_accum=grad_accum)
    device = state.device

    def batches(epoch_rng):
        return dict_batches(data, batch_size, rng=epoch_rng, device=device)

    checkpointer = None
    if checkpoint_dir is not None:
        from unionml_tpu_torch.checkpoint import Checkpointer, install_preemption_handler

        checkpointer = Checkpointer(checkpoint_dir, save_interval_steps=checkpoint_every)
        install_preemption_handler(checkpointer)
        latest = checkpointer.latest_step()
        if latest is not None:
            logger.info("Resuming from checkpoint step %d", latest)
            state = checkpointer.restore(state)

    try:
        rng = np.random.default_rng(seed)
        history = []
        step = start_step = state.step
        # the first step (allocator and library warm-up) runs outside the timed window
        state, metrics = step_fn(state, next(iter(batches(rng))))
        float(metrics["loss"])  # host fetch = barrier
        step += 1

        t0 = time.perf_counter()
        done = False
        epochs = num_epochs if num_steps is None else max(num_epochs, 10**9)
        for _ in range(epochs):
            for batch in batches(rng):
                state, metrics = step_fn(state, batch)
                step += 1
                if step % log_every == 0:
                    metrics_host = {k: float(v) for k, v in metrics.items()}
                    history.append({"step": step, **metrics_host})
                    logger.info("step %d: %s", step, metrics_host)
                if checkpointer is not None:
                    checkpointer.save(step, state)
                if num_steps is not None and step - start_step >= num_steps:
                    done = True
                    break
            if done:
                break
        float(metrics["loss"])  # host fetch = barrier for the timed window
        wall = time.perf_counter() - t0
    finally:
        if checkpointer is not None:
            checkpointer.close()  # flushes the pending writes

    executed = step - start_step - 1  # the first step is excluded from the timing
    return FitResult(
        state=state,
        metrics_history=history,
        steps=step,
        wall_time_s=wall,
        steps_per_s=executed / wall if wall > 0 else 0.0,
        examples_per_s=executed * batch_size / wall if wall > 0 else 0.0,
    )


def fit_lm(
    state: TrainState,
    sequences: Sequence[np.ndarray],
    *,
    seq_len: int,
    batch_size: int,
    pack: bool = True,
    max_segments_per_row: int = 0,
    num_epochs: int = 1,
    num_steps: Optional[int] = None,
    mesh: Any = None,
    param_spec: Any = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    log_every: int = 50,
    seed: int = 0,
    prefetch: bool = False,
    prefetch_convert: Optional[Dict[str, str]] = None,
    grad_accum: int = 1,
    moe_aux: bool = False,
) -> FitResult:
    """Causal-LM training over ragged token sequences through :func:`fit`
    (``training.py:524-603``).

    ``pack=True`` (the default) runs :func:`pack_sequences`: several short
    sequences share each ``seq_len`` row, segment ids confine attention and
    restart positions per segment, and cross-segment transitions are masked
    out of the loss. ``pack=False`` right-pads one sequence per row with a
    loss mask. ``FitResult.examples_per_s`` counts rows.
    """
    if pack:
        packed = pack_sequences(sequences, seq_len, max_segments_per_row=max_segments_per_row)
        data = {"input_ids": packed["input_ids"], "segment_ids": packed["segment_ids"]}
        logger.info(
            "packed %d sequences into %d rows of %d (efficiency %.1f%%, %d truncated)",
            len(sequences), packed["input_ids"].shape[0], seq_len,
            100.0 * packing_efficiency(packed["segment_ids"]), packed["truncated"],
        )
    else:
        input_ids = np.zeros((len(sequences), seq_len), dtype=np.int32)
        mask = np.zeros((len(sequences), seq_len), dtype=np.float32)
        truncated = 0
        for i, seq in enumerate(sequences):
            arr = np.asarray(seq).reshape(-1)[:seq_len]
            truncated += int(np.asarray(seq).size > seq_len)
            input_ids[i, : arr.size] = arr
            mask[i, : arr.size] = 1.0
        if truncated:
            logger.info("truncated %d sequences to seq_len=%d", truncated, seq_len)
        data = {"input_ids": input_ids, "mask": mask}

    step_fn = make_lm_train_step(packed=pack, grad_accum=grad_accum, moe_aux=moe_aux, mesh=mesh,
                                 param_spec=param_spec)
    return fit(
        state, data, batch_size=batch_size, num_epochs=num_epochs, num_steps=num_steps,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, log_every=log_every, seed=seed,
        prefetch=prefetch, prefetch_convert=prefetch_convert, step_fn=step_fn,
    )


def bert_flops_per_token(config: Any) -> float:
    """Approximate training FLOPs per token for MFU accounting (6 * params-ish),
    as ``training.py:606-612`` counts them."""
    hidden, layers, inter = config.hidden_size, config.num_layers, config.intermediate_size
    per_layer = 4 * hidden * hidden + 2 * hidden * inter  # attn projections + mlp
    fwd = layers * 2 * per_layer  # 2 flops per MAC; embedding lookups are negligible
    return 3.0 * fwd  # fwd + bwd ~ 3x forward
