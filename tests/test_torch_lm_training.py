"""Port parity: packed causal-LM training of the tiny GPT against the JAX package.

The JAX tiny config (f32, dropout 0, vocab 512, d 64, 2 layers, 4 heads) is
initialised once and carried into the port by ``params_from_jax``; inputs
come from a numpy seed (corpora packed by ``pack_sequences``). Tolerances:
- packed logits (segment ids, positions restarting per segment) within atol
  1e-4 of the JAX model's, as the unpacked logits in ``test_torch_gpt.py``;
- the port's packed forward against its own per-sequence forward: atol 1e-5
  (the same arithmetic on fewer keys);
- ``lm_loss`` (packed, masked, plain) and the eval step's loss within 1e-6
  (f32 logsumexp in another order), perplexity within 1e-6 relative;
- one train step's gradients against ``jax.value_and_grad`` of the JAX LM
  loss: each leaf within 1e-5 of that leaf's largest magnitude (f32 backprop
  through two layers, summation order only);
- ``grad_accum=2`` against the full batch: atol 1e-6 (mean of means; the
  packed rows here carry equal token counts per half, so the two agree);
- ``fit_lm``: finite losses, and the step count and logged steps of the JAX
  ``fit`` over the same packed (or padded) data.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models import training as jtraining
from unionml_tpu.ops.packing import pack_sequences as jax_pack
from unionml_tpu_torch.models import (
    GPTConfig,
    create_train_state,
    fit_lm,
    gpt_grads_to_jax,
    init_gpt,
    lm_loss,
    make_lm_eval_step,
    make_lm_train_step,
)
from unionml_tpu_torch.models.training import lm_grads
from unionml_tpu_torch.ops.packing import pack_sequences

SEQ = 32


def _corpus(seed, n, low=2, high=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, int(m)).astype(np.int32) for m in rng.integers(low, high, n)]


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


@pytest.fixture(scope="module")
def pair():
    """(jax model, numpy params tree) of the tiny f32 GPT without dropout."""
    jcfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, attention_impl="xla")
    variables = jgpt.init_params(jcfg, seq_len=16)
    return jgpt.GPTLMHeadModel(jcfg), jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _port_model(params):
    return init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0), params=params, device="cpu")


def _packed(seed, rows=3):
    packed = pack_sequences(_corpus(seed, 12), SEQ)
    return {k: packed[k][:rows] for k in ("input_ids", "segment_ids")}


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_logits_match_jax(pair, seed):
    jmodel, params = pair
    batch = _packed(seed)
    batch["segment_ids"][0, 3:5] = 0  # interior padding: positions restart into and out of it
    want = jmodel.apply(params, jnp.asarray(batch["input_ids"]), segment_ids=jnp.asarray(batch["segment_ids"]))
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(batch["input_ids"]),
                                  segment_ids=torch.from_numpy(batch["segment_ids"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_packed_forward_equals_per_sequence_forward(pair):
    _, params = pair
    model = _port_model(params).requires_grad_(False)
    seqs = _corpus(5, 3, low=5, high=11)
    packed = pack_sequences(seqs, SEQ)
    assert packed["input_ids"].shape[0] == 1 and packed["segment_ids"].max() == 3
    logits = model(torch.from_numpy(packed["input_ids"]), segment_ids=torch.from_numpy(packed["segment_ids"]))
    offset = 0
    for seq in seqs:
        alone = model(torch.from_numpy(seq[None].astype(np.int64)))
        torch.testing.assert_close(logits[:, offset:offset + seq.size], alone, atol=1e-5, rtol=0)
        offset += seq.size


@pytest.mark.parametrize("kind", ["packed", "mask", "plain"])
def test_lm_loss_matches_jax(kind):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(3, SEQ, 40)).astype(np.float32)
    ids = rng.integers(0, 40, (3, SEQ)).astype(np.int32)
    segs = _packed(2)["segment_ids"] if kind == "packed" else None
    mask = (rng.uniform(size=(3, SEQ)) > 0.3).astype(np.float32) if kind == "mask" else None
    want = jgpt.lm_loss(jnp.asarray(logits), jnp.asarray(ids), mask=None if mask is None else jnp.asarray(mask),
                        segment_ids=None if segs is None else jnp.asarray(segs))
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(ids), mask=None if mask is None else torch.from_numpy(mask),
                  segment_ids=None if segs is None else torch.from_numpy(segs))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "padded"])
def test_one_step_gradients_match_jax(pair, packed):
    jmodel, params = pair
    if packed:
        batch = _packed(3)
    else:
        batch = _packed(3)
        batch = {"input_ids": batch["input_ids"], "mask": (batch["segment_ids"] > 0).astype(np.float32)}

    def loss_fn(p):
        segs = jnp.asarray(batch["segment_ids"]) if packed else None
        logits = jmodel.apply({"params": p}, jnp.asarray(batch["input_ids"]), segment_ids=segs)
        mask = None if packed else jnp.asarray(batch["mask"])
        return jgpt.lm_loss(logits, jnp.asarray(batch["input_ids"]), mask=mask, segment_ids=segs)

    j_loss, j_grads = jax.value_and_grad(loss_fn)(params["params"])
    state = create_train_state(_port_model(params))
    grads, loss = lm_grads(state, {k: torch.from_numpy(v) for k, v in batch.items()}, packed=packed)
    np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-6, rtol=0)
    got = dict(_leaves(gpt_grads_to_jax(dict(zip(state.names, grads)))))
    want = dict(_leaves(j_grads))
    assert set(got) == set(want)
    for path, value in want.items():
        limit = 1e-5 * float(np.abs(value).max())
        assert float(np.abs(got[path] - value).max()) <= limit, path


def test_grad_accum_matches_the_full_batch(pair):
    _, params = pair
    seqs = [np.arange(1, 17) + i for i in range(8)]  # 16 tokens each: two per 32-token row
    packed = pack_sequences(seqs, SEQ)
    batch = {k: torch.from_numpy(packed[k]) for k in ("input_ids", "segment_ids")}
    full = lm_grads(create_train_state(_port_model(params)), batch, packed=True)
    accum = lm_grads(create_train_state(_port_model(params)), batch, packed=True, grad_accum=2)
    for a, b in zip(full[0], accum[0]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    torch.testing.assert_close(full[1], accum[1], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divide"):
        lm_grads(create_train_state(_port_model(params)), batch, packed=True, grad_accum=3)


def test_eval_step_matches_jax(pair):
    jmodel, params = pair
    batch = _packed(4)
    want = jtraining.make_lm_eval_step(packed=True)(
        jtraining.create_train_state(jmodel, params), {k: jnp.asarray(v) for k, v in batch.items()}
    )
    state = create_train_state(_port_model(params))
    got = make_lm_eval_step(packed=True)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == {"loss", "perplexity"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got["perplexity"]), float(want["perplexity"]), rtol=1e-6)


def test_packed_step_needs_segment_ids(pair):
    _, params = pair
    batch = {"input_ids": torch.from_numpy(_packed(6)["input_ids"])}
    with pytest.raises(KeyError, match="segment_ids"):
        make_lm_train_step(packed=True)(create_train_state(_port_model(params)), batch)


@pytest.mark.parametrize("pack,num_steps,num_epochs,log_every", [
    (True, 5, 1, 2), (False, 4, 1, 1), (True, None, 2, 3),
], ids=["packed", "padded", "packed-epochs"])
def test_fit_lm_trains_with_the_jax_step_count(pair, pack, num_steps, num_epochs, log_every):
    _, params = pair
    corpus = _corpus(8, 40, high=SEQ + 8)  # some sequences are cut to SEQ
    kwargs = dict(batch_size=4, num_steps=num_steps, num_epochs=num_epochs, log_every=log_every, seed=3)
    state = create_train_state(_port_model(params), learning_rate=1e-3, warmup_steps=2, total_steps=20)
    before = [p.detach().clone() for p in state.params]
    got = fit_lm(state, corpus, seq_len=SEQ, pack=pack, **kwargs)
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in got.metrics_history)
    assert any(not torch.equal(a, b) for a, b in zip(before, state.params))
    # the JAX loop over the data the JAX fit_lm builds: the same count and logged steps
    if pack:
        packed = jax_pack(corpus, SEQ)
        data = {"input_ids": packed["input_ids"], "segment_ids": packed["segment_ids"]}
    else:
        data = {"input_ids": np.zeros((len(corpus), SEQ), np.int32)}

    def step_fn(s, batch):
        s.step += 1
        return s, {"loss": np.float32(0.0)}

    want = jtraining.fit(types.SimpleNamespace(step=0), data, step_fn=step_fn, **kwargs)
    assert got.steps == want.steps == state.step
    assert [h["step"] for h in got.metrics_history] == [h["step"] for h in want.metrics_history]


@pytest.mark.parametrize("option", [
    # moe_aux alone trains (tests/test_torch_moe_gpt.py); sharded sparse training is M12
    dict(moe_aux=True, mesh=object()), dict(mesh=object()), dict(prefetch=True),
], ids=["moe_aux", "mesh", "prefetch"])
def test_fit_lm_rejects_unported_options(pair, option):
    _, params = pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit_lm(create_train_state(_port_model(params)), _corpus(9, 8), seq_len=SEQ, batch_size=2, **option)


def test_fit_lm_checkpoints_and_resumes(pair, tmp_path):
    """fit_lm passes checkpoint_dir to fit: step checkpoints land every
    checkpoint_every steps, and a fresh state resumes from the latest one."""
    from unionml_tpu_torch.checkpoint import Checkpointer

    _, params = pair
    kwargs = dict(seq_len=SEQ, batch_size=2, num_steps=4, checkpoint_dir=str(tmp_path / "lm"), checkpoint_every=2)
    first = fit_lm(create_train_state(_port_model(params)), _corpus(9, 8), **kwargs)
    probe = Checkpointer(tmp_path / "lm")
    assert first.steps == 4 and probe.latest_step() == 4
    probe.close()
    resumed = fit_lm(create_train_state(_port_model(params)), _corpus(9, 8), **kwargs)
    assert resumed.steps == 8 and resumed.state.step == 8
