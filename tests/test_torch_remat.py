"""Port parity: GPT activation recompute (``GPTConfig(remat=True)``).

Tiny GPTs (vocab 512, d 64, 2 layers, 4 heads; dense, and sparse with
``moe_every=2``) with seeded weights from ``random_params``, fed to both
packages; packed corpora from numpy seeds. Tolerances:

- the port with ``remat=True`` against itself with ``remat=False`` in f32,
  dropout 0.1 (and router jitter 0.3 on the sparse model), so the recompute
  must draw the forward's masks: three ``fit_lm`` steps' losses within 1e-6
  relative, every parameter after them and the first step's gradients within
  1e-6 of each leaf's largest magnitude;
- in bf16 (the same comparison): losses within 1e-3 relative and gradients
  within 1e-2 of each leaf's largest magnitude (one bf16 rounding step; on
  the CPU the recompute runs the same ops in the same order, so the two
  agree to the bit);
- the port's ``remat=True`` step against JAX's ``GPTConfig(remat=True)``
  (``nn.remat``), dropout off: the loss within 1e-6 and each gradient leaf
  within 1e-5 of its largest magnitude, as ``test_torch_lm_training.py``
  holds the step without recompute (the sparse model with its router
  losses, as ``test_torch_moe_gpt.py`` does);
- decode, prefill and ``generate`` never recompute: no checkpointed call,
  parameter gradients stay ``None`` and the streams equal ``remat=False``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models import moe as jmoe
from unionml_tpu_torch.models import (
    GPTConfig,
    collect_aux_losses,
    create_train_state,
    fit_lm,
    generate,
    gpt_grads_to_jax,
    init_gpt,
    random_params,
)
from unionml_tpu_torch.models import _layers
from unionml_tpu_torch.models import training as ttraining
from unionml_tpu_torch.models.gpt import init_cache
from unionml_tpu_torch.models.training import lm_grads
from unionml_tpu_torch.ops.packing import pack_sequences

SEQ = 32
SPARSE = dict(moe_every=2, num_experts=4, moe_k=2)
KINDS = {"dense": {}, "sparse": SPARSE}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tiny models gain nothing from more, and the
    suite's workers share the cores (threads spinning at each op's barrier
    while descheduled slowed this file many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corpus(seed, n=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, int(m)).astype(np.int32) for m in rng.integers(3, 24, n)]


def _batch(seed, rows=4):
    packed = pack_sequences(_corpus(seed), SEQ)
    return {k: torch.from_numpy(packed[k][:rows]) for k in ("input_ids", "segment_ids")}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _model(params, remat, dtype=torch.float32, **kw):
    config = GPTConfig.tiny(dtype=dtype, remat=remat, **kw)
    return init_gpt(config, params=params, device="cpu")


@pytest.fixture(scope="module")
def trees():
    return {kind: random_params(GPTConfig.tiny(**kw), seed=0, std=0.2) for kind, kw in KINDS.items()}


def _close(got, want, rel):
    for a, b in zip(got, want):
        a, b = a.detach().float(), b.detach().float()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= rel * scale, (float((a - b).abs().max()), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_remat_trains_as_without_it(trees, kind, dtype):
    """Three fit_lm steps with remat on and off from one seed, dropout on
    (and router jitter on the sparse model): the recompute draws the
    forward's masks, so losses, gradients and parameters agree."""
    rel_loss, rel_leaf = (1e-6, 1e-6) if dtype == torch.float32 else (1e-3, 1e-2)
    kw = dict(KINDS[kind], dropout=0.1, **({"moe_router_noise": 0.3} if kind == "sparse" else {}))
    moe_aux = kind == "sparse"
    runs = {}
    for remat in (False, True):
        state = create_train_state(_model(trees[kind], remat, dtype, **kw), learning_rate=1e-3, seed=4)
        grads, loss = lm_grads(state, _batch(1), packed=True, moe_aux=moe_aux)
        result = fit_lm(state, _corpus(2), seq_len=SEQ, batch_size=2, num_steps=3, log_every=1, seed=5,
                        moe_aux=moe_aux)
        runs[remat] = (float(loss), grads, [h["loss"] for h in result.metrics_history], state.params)
    (loss0, grads0, hist0, params0), (loss1, grads1, hist1, params1) = runs[False], runs[True]
    assert len(hist0) == 2 and all(np.isfinite(hist0))
    np.testing.assert_allclose(loss1, loss0, rtol=rel_loss, atol=0)
    np.testing.assert_allclose(hist1, hist0, rtol=rel_loss, atol=0)
    _close(grads1, grads0, rel_leaf)
    _close(params1, params0, rel_leaf)


@pytest.mark.parametrize("kind", list(KINDS))
def test_remat_step_matches_jax_remat(trees, kind):
    """One packed step's loss and gradients against JAX's nn.remat model
    (dropout off: the two packages draw different masks)."""
    params = trees[kind]
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, attention_impl="xla", dropout=0.0, remat=True, **KINDS[kind])
    jmodel = jgpt.GPTLMHeadModel(jcfg)
    batch = _batch(3)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def loss_fn(p):
        logits, sown = jmodel.apply({"params": p}, jbatch["input_ids"], segment_ids=jbatch["segment_ids"],
                                    deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
                                    mutable=["intermediates"])
        aux = jmoe.collect_aux_losses(sown["intermediates"]) if kind == "sparse" else 0.0
        return aux + jgpt.lm_loss(logits, jbatch["input_ids"], segment_ids=jbatch["segment_ids"])

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params["params"])
    state = create_train_state(_model(params, True, dropout=0.0, **KINDS[kind]))
    grads, loss = lm_grads(state, batch, packed=True, moe_aux=kind == "sparse")
    np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-6, rtol=1e-6)
    got = dict(_leaves(gpt_grads_to_jax(dict(zip(state.names, grads)))))
    want = dict(_leaves(j_grads))
    assert set(got) == set(want)
    for path, value in want.items():
        assert float(np.abs(got[path] - value).max()) <= 1e-5 * float(np.abs(value).max()), path


def test_sparse_router_losses_come_out_of_the_recompute(trees):
    """collect_aux_losses sees the same router losses with remat on and off,
    and they carry gradient to the router."""
    batch = _batch(4)
    out = {}
    for remat in (False, True):
        model = _model(trees["sparse"], remat, dropout=0.1, moe_router_noise=0.3, **SPARSE)
        _, aux = model(batch["input_ids"], segment_ids=batch["segment_ids"], deterministic=False,
                       generator=torch.Generator().manual_seed(9), return_aux=True)
        total = collect_aux_losses(aux)
        router = model.layers[1].moe_mlp.router.weight
        out[remat] = (float(total.detach()), torch.autograd.grad(total, router)[0])
    assert out[True][0] == out[False][0]
    torch.testing.assert_close(out[True][1], out[False][1], atol=1e-6, rtol=0)


def test_step_generators_are_unchanged_by_remat(trees, monkeypatch):
    """With grad_accum=2 each microbatch gets its own dropout generator: the
    states handed out, and where each stands after the step, are the same
    with remat on and off (the recompute rewinds a generator and then puts
    it back)."""
    handed = []
    original = ttraining.dropout_generator

    def recording(*args, **kwargs):
        generator = original(*args, **kwargs)
        seed, step, _, index = args
        handed.append(((seed, step, index), generator.get_state().clone(), generator))
        return generator

    monkeypatch.setattr(ttraining, "dropout_generator", recording)
    seen = {}
    for remat in (False, True):
        handed.clear()
        state = create_train_state(_model(trees["dense"], remat, dropout=0.1), seed=2)
        grads, _ = lm_grads(state, _batch(5), packed=True, grad_accum=2)
        seen[remat] = ([(key, start, g.get_state()) for key, start, g in handed], grads)
    (off, grads_off), (on, grads_on) = seen[False], seen[True]
    assert [k for k, _, _ in off] == [k for k, _, _ in on] == [(2, 0, 0), (2, 0, 1)]
    for (_, start_off, end_off), (_, start_on, end_on) in zip(off, on):
        assert torch.equal(start_off, start_on) and torch.equal(end_off, end_on)
        assert not torch.equal(start_off, end_off)  # the masks were drawn
    _close(grads_on, grads_off, 1e-6)


def test_one_generator_across_steps_draws_as_without_remat(trees):
    """A caller that reuses one generator for two forward/backward passes
    sees the same masks with remat on and off."""
    batch = _batch(6)
    losses = {}
    for remat in (False, True):
        model = _model(trees["dense"], remat, dropout=0.3)
        generator = torch.Generator().manual_seed(11)
        values = []
        for _ in range(2):
            logits = model(batch["input_ids"], segment_ids=batch["segment_ids"], deterministic=False,
                           generator=generator)
            loss = logits.logsumexp(-1).mean()
            loss.backward()
            values.append(float(loss.detach()))
        losses[remat] = (values, generator.get_state())
    assert losses[True][0] == losses[False][0]
    assert torch.equal(losses[True][1], losses[False][1])


def test_decode_and_generate_never_recompute(trees, monkeypatch):
    calls = []
    original = _layers.checkpoint
    monkeypatch.setattr(_layers, "checkpoint", lambda *a, **k: calls.append(1) or original(*a, **k))
    prompt = torch.from_numpy(np.random.default_rng(7).integers(1, 512, (2, 6)))
    streams = {}
    for remat in (False, True):
        model = _model(trees["sparse"], remat, **SPARSE)
        with torch.no_grad():
            streams[remat] = generate(model, prompt, 8)
        # a cached prefill with gradients on does not recompute either
        model(prompt, cache=init_cache(model.config, 2, 16, device="cpu"), position=0)
        assert all(p.grad is None for p in model.parameters())
    assert calls == []
    assert torch.equal(streams[True], streams[False])
    # a training forward does recompute: one checkpointed call per block
    model = _model(trees["sparse"], True, **SPARSE)
    model(prompt)
    assert len(calls) == model.config.num_layers
