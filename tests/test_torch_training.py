"""Port parity: losses, the train step's gradients, the optimizer and the fit loop.

Inputs come from a numpy seed and go to both packages. Tolerances:
- loss and accuracy against ``cross_entropy_and_accuracy``: atol 1e-6
  (f32 logsumexp in another order);
- one train step's gradients on the tiny f32 BERT (dropout off) against
  ``jax.value_and_grad`` of the JAX loss: each leaf within 1e-5 of that
  leaf's largest magnitude (f32 backprop through two layers, summation order
  only), except the attention key biases, whose true gradient is 0 (both
  hold rounding noise below 1e-7); the loss within 1e-6;
- the optimizer fed the same numpy gradients as the JAX package's
  ``create_train_state`` (``optax.chain(clip_by_global_norm, adamw)``): the
  same parameters within 1e-7 over 3 steps (parameters of size ~0.1, whose
  f32 ulp is below 1e-8), with and without warmup and with a bf16 first
  moment; the schedule within 1e-6 relative (f64 here, f32 in optax);
- ``grad_accum=2`` against the full batch: atol 1e-6 (mean of means);
- the fit loop: the same batches in the same order, the same step count and
  the same logged steps as the JAX ``fit``.
Gradients are compared, not post-Adam parameters after different gradients
(Adam's normalisation amplifies rounding of near-zero gradients).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from unionml_tpu.models import bert as jbert
from unionml_tpu.models import training as jtraining
from unionml_tpu.ops.losses import cross_entropy_and_accuracy as jax_ce
from unionml_tpu_torch.models import (
    BertConfig,
    bert_grads_to_jax,
    bert_flops_per_token,
    create_train_state,
    dict_batches,
    fit,
    init_bert,
    make_classifier_eval_step,
    make_classifier_train_step,
)
from unionml_tpu_torch.models.training import FitResult, classifier_grads
from unionml_tpu_torch.ops.losses import cross_entropy_and_accuracy

SIG = ("input_ids", "attention_mask")


def _data(seed, rows, seq=16, vocab=1024):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, seq + 1, rows)
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(1, vocab, (rows, seq)).astype(np.int32) * mask
    return {"input_ids": ids, "attention_mask": mask, "labels": rng.integers(0, 2, rows).astype(np.int32)}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


@pytest.fixture(scope="module")
def jax_bert():
    jcfg = jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl="xla", hidden_dropout=0.0)
    variables = jbert.init_params(jcfg, seq_len=16)
    return jbert.BertForSequenceClassification(jcfg), jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def _port_state(params, impl="auto", **kwargs):
    cfg = BertConfig.tiny(dtype=torch.float32, hidden_dropout=0.0, attention_impl=impl)
    return create_train_state(init_bert(cfg, params=params, device="cpu"), **kwargs)


def _torch_batch(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_loss_and_accuracy_match_jax(weighted, dtype):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(12, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 12).astype(np.int32)
    weights = rng.uniform(0, 2, 12).astype(np.float32) if weighted else None
    t_logits = torch.from_numpy(logits).to(dtype)
    j_logits = jnp.asarray(t_logits.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    got = cross_entropy_and_accuracy(t_logits, torch.from_numpy(labels),
                                     None if weights is None else torch.from_numpy(weights))
    want = jax_ce(j_logits, jnp.asarray(labels), None if weights is None else jnp.asarray(weights))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(float(a), float(b), atol=1e-6, rtol=0)


def test_all_zero_weights_give_zero_not_nan():
    logits, labels = torch.randn(4, 3), torch.tensor([0, 1, 2, 0])
    loss, acc = cross_entropy_and_accuracy(logits, labels, torch.zeros(4))
    assert float(loss) == 0.0 and float(acc) == 0.0


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_one_step_gradients_match_jax(jax_bert, impl):
    jmodel, params = jax_bert
    data = _data(2, 6)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, data["input_ids"], data["attention_mask"], deterministic=True)
        return jax_ce(logits, data["labels"])

    (j_loss, j_acc), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params["params"])
    state = _port_state(params, impl)
    grads, loss, acc = classifier_grads(state, _torch_batch(data), SIG)
    assert abs(float(loss) - float(j_loss)) <= 1e-6 and float(acc) == float(j_acc)
    got = dict(_leaves(bert_grads_to_jax(dict(zip(state.names, grads)))))
    want = dict(_leaves(j_grads))
    assert set(got) == set(want)
    for path, value in want.items():
        if path[-2:] == ("key", "bias"):
            # softmax is shift-invariant per query row: the key bias's true
            # gradient is 0, and both packages hold only rounding noise there
            assert max(np.abs(got[path]).max(), np.abs(value).max()) <= 1e-7, path
            continue
        limit = 1e-5 * float(np.abs(value).max())
        assert float(np.abs(got[path] - value).max()) <= limit, path
    # the step's grad_norm metric is optax's global norm of the same gradients
    _, metrics = make_classifier_train_step(input_signature=SIG)(_port_state(params, impl), _torch_batch(data))
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(j_grads)), rtol=1e-5)


def _holder(arrays):
    module = nn.Module()
    for name, value in arrays.items():
        module.register_parameter(name, nn.Parameter(torch.from_numpy(value.copy())))
    return module


@pytest.mark.parametrize("warmup,mu_dtype", [(0, None), (2, None), (2, "bf16")],
                         ids=["constant-lr", "warmup", "warmup-bf16-mu"])
def test_optimizer_matches_optax(warmup, mu_dtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2, 5)}
    params = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
    scales = [0.5, 0.05, 2.0]  # global norms above, below and above the clip at 1.0
    grads = [{k: (sc * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()} for sc in scales]
    hyper = dict(learning_rate=1e-2, weight_decay=0.01, warmup_steps=warmup, total_steps=10, max_grad_norm=1.0)
    jstate = jtraining.create_train_state(
        types.SimpleNamespace(apply=None), {k: jnp.asarray(v) for k, v in params.items()},
        mu_dtype=jnp.bfloat16 if mu_dtype else None, **hyper,
    )
    state = create_train_state(_holder(params), mu_dtype=torch.bfloat16 if mu_dtype else None, **hyper)
    for step_grads in grads:
        jstate = jstate.apply_gradients(grads={k: jnp.asarray(v) for k, v in step_grads.items()})
        norm = state.apply_gradients([torch.from_numpy(step_grads[n]) for n in state.names])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(step_grads)), rtol=1e-6)
        for name, p in zip(state.names, state.params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[name]), atol=1e-7, rtol=0)
    assert state.step == int(jstate.step) == 3
    if mu_dtype:
        assert all(m.dtype == torch.bfloat16 for m in state.mu)


def test_schedule_matches_optax():
    state = create_train_state(_holder({"w": np.zeros(2, np.float32)}), learning_rate=2e-5, warmup_steps=10,
                               total_steps=40)
    schedule = optax.warmup_cosine_decay_schedule(0.0, 2e-5, 10, 40)
    for count in range(0, 45):
        np.testing.assert_allclose(state.learning_rate_at(count), float(schedule(count)), rtol=1e-6, atol=1e-13)
    assert state.learning_rate_at(0) == 0.0  # the first update under warmup has lr 0


def test_grad_accum_matches_the_full_batch(jax_bert):
    _, params = jax_bert
    batch = _torch_batch(_data(4, 8))
    full = classifier_grads(_port_state(params), batch, SIG, grad_accum=1)
    accum = classifier_grads(_port_state(params), batch, SIG, grad_accum=2)
    for a, b in zip(full[0], accum[0]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    torch.testing.assert_close(full[1], accum[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(full[2], accum[2], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divide"):
        classifier_grads(_port_state(params), batch, SIG, grad_accum=3)
    with pytest.raises(ValueError):
        make_classifier_train_step(grad_accum=0)


@pytest.mark.parametrize("num_steps,num_epochs,log_every", [(7, 1, 2), (None, 2, 3), (5, 1, 1)])
def test_fit_follows_the_jax_loop(jax_bert, num_steps, num_epochs, log_every):
    _, params = jax_bert
    data = _data(5, 20)
    seen = {"jax": [], "port": []}

    def recording(key, loss):
        def step_fn(state, batch):
            seen[key].append(np.asarray(batch["labels"]).tolist())
            state.step += 1
            return state, {"loss": loss}
        return step_fn

    kwargs = dict(batch_size=4, num_epochs=num_epochs, num_steps=num_steps, log_every=log_every, seed=11)
    want = jtraining.fit(types.SimpleNamespace(step=0), data, step_fn=recording("jax", np.float32(0.5)), **kwargs)
    got = fit(_port_state(params), data, step_fn=recording("port", torch.tensor(0.5)), **kwargs)
    assert isinstance(got, FitResult)
    assert seen["port"] == seen["jax"]
    assert got.steps == want.steps
    assert [h["step"] for h in got.metrics_history] == [h["step"] for h in want.metrics_history]


def test_fit_trains_and_evaluates_on_cpu(jax_bert):
    _, params = jax_bert
    data = _data(6, 16)
    state = _port_state(params, learning_rate=1e-3, warmup_steps=2, total_steps=10)
    before = [p.detach().clone() for p in state.params]
    result = fit(state, data, batch_size=4, num_steps=4, log_every=2, input_signature=SIG)
    assert result.steps == 4 and result.state is state and state.step == 4
    assert [h["step"] for h in result.metrics_history] == [2, 4]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in result.metrics_history)
    assert result.examples_per_s > 0 and result.steps_per_s > 0
    assert any(not torch.equal(a, b) for a, b in zip(before, state.params))
    metrics = make_classifier_eval_step(SIG)(state, next(iter(dict_batches(data, 8, device="cpu"))))
    assert set(metrics) == {"loss", "accuracy"} and torch.isfinite(metrics["loss"])


def test_train_step_metrics_stay_tensors(jax_bert):
    _, params = jax_bert
    step = make_classifier_train_step(input_signature=SIG, light_metrics=True)
    state, metrics = step(_port_state(params), _torch_batch(_data(7, 4)))
    assert set(metrics) == {"loss", "accuracy"} and all(torch.is_tensor(v) for v in metrics.values())
    assert state.step == 1


@pytest.mark.parametrize("option", [
    dict(prefetch=True), dict(prefetch_convert={"labels": "int32"}), dict(mesh=object()), dict(param_spec=object()),
], ids=["prefetch", "prefetch_convert", "mesh", "param_spec"])
def test_fit_rejects_unported_options(jax_bert, option):
    _, params = jax_bert
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit(_port_state(params), _data(8, 8), batch_size=4, input_signature=SIG, **option)


def test_steps_and_batches_reject_meshes():
    with pytest.raises(NotImplementedError, match="M12"):
        make_classifier_train_step(mesh=object())
    with pytest.raises(NotImplementedError, match="M12"):
        next(iter(dict_batches(_data(9, 4), 2, device="cpu", mesh=object())))


def test_bert_flops_per_token_matches_jax():
    for cfg, jcfg in ((BertConfig.base(), jbert.BertConfig.base()), (BertConfig.tiny(), jbert.BertConfig.tiny())):
        assert bert_flops_per_token(cfg) == jtraining.bert_flops_per_token(jcfg)
