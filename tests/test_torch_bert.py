"""Port parity: the BERT classifier — weights, logits, the mask rule, dropout.

The JAX tiny config (f32, vocab 1024, d 128, 2 layers, 4 heads, dropout 0,
``attention_impl="xla"``) is initialised once; ``bert_params_from_jax``
carries its tree into the port's ``BertForSequenceClassification`` on the
CPU. Tolerances: the state dict round-trips exactly (and
``bert_grads_to_jax`` inverts it exactly); float32 logits agree with the JAX
model within atol 1e-5 on right-padded masks; the ``kv_lens`` rule (the
kernel path) and the dense-mask rule (the plain path) agree within atol 1e-5
on logits and gradients; ``import_hf_weights`` gives exactly the JAX
package's tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import bert as jbert
from unionml_tpu_torch.models import (
    BertConfig,
    BertForSequenceClassification,
    bert_grads_to_jax,
    bert_params_from_jax,
    bert_random_params,
    import_hf_weights,
    init_bert,
)

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, numpy params tree, port model) on the tiny f32 config."""
    jcfg = jbert.BertConfig.tiny(dtype=jnp.float32, attention_impl="xla", hidden_dropout=0.0)
    variables = jbert.init_params(jcfg, seq_len=16)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    cfg = BertConfig.tiny(dtype=torch.float32, hidden_dropout=0.0)
    return jbert.BertForSequenceClassification(jcfg), variables, params, init_bert(cfg, params=params, device="cpu")


def _batch(seed, batch, seq, min_len=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (batch, seq)).astype(np.int32)
    lens = rng.integers(min_len, seq + 1, batch)
    lens[0] = seq
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def test_params_round_trip_and_grads_invert(pair):
    _, _, params, tmodel = pair
    state = bert_params_from_jax(params)
    assert set(state) == set(tmodel.state_dict())
    for name, value in tmodel.state_dict().items():
        assert torch.equal(value, state[name]), name
    tree = params["params"]
    layer = tree["bert"]["encoder"]["layer_1"]
    assert np.array_equal(state["bert.encoder.layers.1.attention.query.weight"].numpy().T,
                          layer["attention"]["query"]["kernel"])
    assert np.array_equal(state["bert.embeddings_norm.weight"].numpy(), tree["bert"]["embeddings_norm"]["scale"])
    back = dict(_leaves(bert_grads_to_jax(dict(tmodel.named_parameters()))))
    want = dict(_leaves(tree))
    assert set(back) == set(want)
    for path, value in want.items():
        assert np.array_equal(back[path], value), path


@pytest.mark.parametrize("impl", ["auto", "kernel", "reference"])
@pytest.mark.parametrize("batch,seq,seed", [(3, 16, 0), (2, 37, 1)])
def test_logits_match_jax_on_right_padded_masks(pair, impl, batch, seq, seed):
    jmodel, variables, params, _ = pair
    ids, mask = _batch(seed, batch, seq)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(mask), deterministic=True))
    cfg = BertConfig.tiny(dtype=torch.float32, hidden_dropout=0.0, attention_impl=impl)
    model = init_bert(cfg, params=params, device="cpu")
    got = model(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_logits_match_jax_with_token_types_and_no_mask(pair):
    jmodel, variables, _, tmodel = pair
    ids, _ = _batch(5, 2, 20)
    types = (np.arange(20)[None, :] >= 9).astype(np.int32).repeat(2, axis=0)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(ids), None, jnp.asarray(types), deterministic=True))
    got = tmodel(torch.from_numpy(ids), None, torch.from_numpy(types)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_kv_lens_rule_matches_the_dense_mask_rule(pair):
    """``"kernel"`` turns the mask into kv_lens (K1 forward, K2/K3 backward
    through the autograd Function); ``"reference"`` keeps the dense mask."""
    _, _, params, _ = pair
    ids, mask = _batch(3, 4, 24, min_len=1)
    results = []
    for impl in ("kernel", "reference"):
        model = init_bert(BertConfig.tiny(dtype=torch.float32, attention_impl=impl), params=params, device="cpu")
        logits = model(torch.from_numpy(ids), torch.from_numpy(mask), deterministic=False,
                       generator=torch.Generator().manual_seed(4))
        grads = torch.autograd.grad(logits.square().sum(), list(model.parameters()))
        results.append((logits.detach(), grads))
    (lk, gk), (lr, gr) = results
    torch.testing.assert_close(lk, lr, atol=ATOL, rtol=0)
    for a, b in zip(gk, gr):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_import_hf_weights_matches_the_jax_import():
    cfg = BertConfig.tiny(dtype=torch.float32)
    tree = bert_random_params(cfg, seed=3)["params"]
    d = cfg.hidden_size
    hf = {}

    def linear(name, node):
        hf[f"{name}.weight"] = torch.from_numpy(node["kernel"].T.copy())
        hf[f"{name}.bias"] = torch.from_numpy(node["bias"])

    def norm(name, node):
        hf[f"{name}.weight"], hf[f"{name}.bias"] = torch.from_numpy(node["scale"]), torch.from_numpy(node["bias"])

    bert = tree["bert"]
    for emb in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        hf[f"bert.embeddings.{emb}.weight"] = torch.from_numpy(bert[emb]["embedding"])
    norm("bert.embeddings.LayerNorm", bert["embeddings_norm"])
    linear("bert.pooler.dense", bert["pooler"])
    for i in range(cfg.num_layers):
        src, dst = bert["encoder"][f"layer_{i}"], f"bert.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            linear(f"{dst}.attention.self.{name}", src["attention"][name])
        linear(f"{dst}.attention.output.dense", src["attention"]["output"])
        norm(f"{dst}.attention.output.LayerNorm", src["attention"]["output_norm"])
        linear(f"{dst}.intermediate.dense", src["mlp"]["intermediate"])
        linear(f"{dst}.output.dense", src["mlp"]["output"])
        norm(f"{dst}.output.LayerNorm", src["mlp"]["output_norm"])
    jcfg = jbert.BertConfig.tiny(dtype=jnp.float32)
    for with_head in (True, False):
        state = dict(hf)
        if with_head:
            linear("classifier", tree["classifier"])
        else:  # a BertModel state dict: no prefix, no head
            state = {k[len("bert."):]: v for k, v in hf.items()}
        got = import_hf_weights(state, cfg)
        want = bert_params_from_jax(jbert.import_hf_weights(state, jcfg))
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        BertForSequenceClassification(cfg, device="cpu").load_state_dict(got)
    assert d == got["classifier.weight"].shape[1]


def test_dropout_masks_follow_the_generator():
    model = init_bert(BertConfig.tiny(dtype=torch.float32), device="cpu")
    ids, mask = (torch.from_numpy(x) for x in _batch(2, 2, 12))

    def run(seed):
        return model(ids, mask, deterministic=False, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(model(ids, mask), model(ids, mask, generator=torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="generator"):
        model(ids, mask, deterministic=False)


def test_remat_recomputes_the_same_dropout_masks():
    ids, mask = (torch.from_numpy(x) for x in _batch(6, 3, 16))
    grads = []
    for remat in (False, True):
        model = init_bert(BertConfig.tiny(dtype=torch.float32, remat=remat), seed=1, device="cpu")
        logits = model(ids, mask, deterministic=False, generator=torch.Generator().manual_seed(9))
        grads.append(torch.autograd.grad(logits.sum(), list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_bf16_computes_in_bf16_on_f32_parameters():
    model = init_bert(BertConfig.tiny(), device="cpu")
    ids, mask = (torch.from_numpy(x) for x in _batch(8, 2, 16))
    logits = model(ids, mask, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert logits.dtype == torch.float32
    hidden, pooled = model.bert(ids, mask)
    assert hidden.dtype == pooled.dtype == torch.bfloat16
    grads = torch.autograd.grad(logits.sum(), list(model.parameters()))
    assert all(p.dtype == torch.float32 and g.dtype == torch.float32 for p, g in zip(model.parameters(), grads))


def test_config_matches_jax_and_rejects_unported_modes():
    port, ref = BertConfig.base(), jbert.BertConfig.base()
    for field in dataclasses.fields(ref):
        if field.name not in ("dtype", "sp_mesh"):
            assert getattr(port, field.name) == getattr(ref, field.name), field.name
    assert BertConfig.tiny().head_dim == 32 and port.head_dim == 64
    # ring/ulysses are ported (tests/test_torch_sequence_parallel.py): the configs build, and JAX's
    # ValueErrors stay: an impl the port does not name, and an sp config's forward without its mesh
    for impl in ("ring", "ulysses"):
        assert BertConfig(attention_impl=impl).attention_impl == impl
    assert BertConfig(sp_mesh=object()).sp_mesh is not None
    with pytest.raises(ValueError):
        BertConfig(attention_impl="xla")
    model = init_bert(BertConfig.tiny(dtype=torch.float32, attention_impl="ring"), device="cpu")
    with pytest.raises(ValueError, match="requires a sequence-parallel mesh"):
        model(torch.ones((1, 8), dtype=torch.long))


def test_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertForSequenceClassification(BertConfig.tiny())
    with pytest.raises(RuntimeError):
        init_bert(BertConfig.tiny())
