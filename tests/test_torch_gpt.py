"""Port parity: the GPT model — weights, logits and greedy generation.

The JAX tiny config (f32, vocab 512, d 64, 2 layers, 4 heads) is initialised
once; ``params_from_jax`` carries its parameter tree into the port's
``GPTLMHeadModel`` on the CPU. Tolerances: the state dict round-trips
exactly; float32 logits (full-sequence forward, dense-cache prefill and
decode steps, paged decode over int8 and float32 pools) agree within atol
1e-4; greedy ``generate`` token ids are identical, including ragged
left-padded batches (``prompt_mask``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu_torch.models import GPTConfig, GPTLMHeadModel, convert, generate, init_gpt
from unionml_tpu_torch.models import gpt as tgpt

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, numpy params tree, port model) on the tiny f32 config."""
    jcfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, attention_impl="xla")
    jmodel = jgpt.GPTLMHeadModel(jcfg)
    variables = jgpt.init_params(jcfg, seq_len=16)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    # inference only: the port's forward also trains, so freeze the weights
    tmodel = init_gpt(GPTConfig.tiny(dtype=torch.float32), params=params, device="cpu").requires_grad_(False)
    return jmodel, variables, params, tmodel


def _ids(seed, batch, seq):
    return np.random.default_rng(seed).integers(0, 512, (batch, seq)).astype(np.int32)


def test_params_from_jax_round_trip(pair):
    _, _, params, tmodel = pair
    state = convert.params_from_jax(params)
    assert set(state) == set(tmodel.state_dict())
    for name, value in tmodel.state_dict().items():
        assert torch.equal(value, state[name]), name
    tree = params["params"]
    assert np.array_equal(state["layers.1.qkv.weight"].numpy().T, tree["layer_1"]["qkv"]["kernel"])
    assert np.array_equal(state["layers.0.attn_norm.weight"].numpy(), tree["layer_0"]["attn_norm"]["scale"])
    # the unwrapped tree maps the same way
    assert all(torch.equal(state[k], v) for k, v in convert.params_from_jax(tree).items())


@pytest.mark.parametrize("batch,seq", [(2, 11), (1, 32)])
def test_full_sequence_logits_match(pair, batch, seq):
    jmodel, variables, _, tmodel = pair
    ids = _ids(seq, batch, seq)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(ids)))
    got = tmodel(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_dense_cache_prefill_and_decode_logits_match(pair):
    jmodel, variables, _, tmodel = pair
    ids = _ids(4, 2, 9)
    jcache = jgpt.init_cache(jmodel.config, 2, 16)
    tcache = tgpt.init_cache(tmodel.config, 2, 16, device="cpu")
    jl, jcache = jmodel.apply(variables, jnp.asarray(ids), cache=jcache, position=0)
    tl, tcache = tmodel(torch.from_numpy(ids).long(), cache=tcache, position=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    token = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for step in range(3):
        jl, jcache = jmodel.apply(variables, jnp.asarray(token), cache=jcache, position=9 + step)
        tl, tcache = tmodel(torch.from_numpy(token).long(), cache=tcache, position=9 + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        token = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("kv_quantize", ["int8", None])
def test_paged_decode_step_logits_match(pair, kv_quantize):
    """One per-row paged decode step over a pool filled by a batch-1 chunk."""
    jmodel, variables, _, tmodel = pair
    bs, max_len, blocks = 4, 16, 6
    ids = _ids(9, 1, 6)
    jpool = jgpt.init_block_pool(jmodel.config, blocks, bs, kv_quantize=kv_quantize)
    tpool = tgpt.init_block_pool(tmodel.config, blocks, bs, kv_quantize=kv_quantize, device="cpu")
    table = np.asarray([[2, 0, 4, 5, 5]], dtype=np.int32)  # 4 data columns + scratch (block 5)
    jl, jc = jmodel.apply(variables, jnp.asarray(ids), cache={"table": jnp.asarray(table), **jpool}, position=0)
    tl, tc = tmodel(torch.from_numpy(ids).long(), cache={"table": torch.from_numpy(table), **tpool}, position=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    token = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    pos = np.asarray([6], dtype=np.int32)
    jl, _ = jmodel.apply(variables, jnp.asarray(token), cache=jc, position=jnp.asarray(pos))
    tl, _ = tmodel(torch.from_numpy(token).long(), cache=tc, position=torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert max_len // bs + 1 == table.shape[1] == tgpt.block_table_width(max_len, bs)


@pytest.mark.parametrize("batch,seq,new", [(1, 5, 12), (3, 9, 8), (2, 17, 6)])
def test_greedy_generate_matches(pair, batch, seq, new):
    jmodel, variables, _, tmodel = pair
    ids = _ids(seq * 3 + batch, batch, seq)
    want = np.asarray(jgpt.generate(jmodel, variables, jnp.asarray(ids), new))
    got = generate(tmodel, torch.from_numpy(ids).long(), new).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pads", [(3, 0), (0, 5, 2)])
def test_ragged_greedy_generate_matches(pair, pads):
    jmodel, variables, _, tmodel = pair
    ids = _ids(sum(pads) + 40, len(pads), 10)
    mask = np.ones_like(ids)
    for row, pad in enumerate(pads):
        mask[row, :pad] = 0
        ids[row, :pad] = 0
    want = np.asarray(jgpt.generate(jmodel, variables, jnp.asarray(ids), 7, prompt_mask=jnp.asarray(mask)))
    got = generate(tmodel, torch.from_numpy(ids).long(), 7, prompt_mask=torch.from_numpy(mask)).numpy()
    assert np.array_equal(got, want)


def test_sampled_generate_is_seeded_and_in_vocab(pair):
    *_, tmodel = pair
    ids = torch.from_numpy(_ids(1, 2, 5)).long()
    runs = [
        generate(tmodel, ids, 6, temperature=0.9, top_k=20, top_p=0.9,
                 generator=torch.Generator().manual_seed(3))
        for _ in range(2)
    ]
    assert torch.equal(runs[0], runs[1]) and int(runs[0].max()) < 512


def test_config_defaults_and_unported_paths():
    cfg = GPTConfig()
    jcfg = jgpt.GPTConfig()
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "max_position_embeddings",
                  "layer_norm_eps", "dropout", "remat"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.head_dim == 64 and cfg.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="M12"):
        dataclasses.replace(cfg, attention_impl="ring")
    with pytest.raises(NotImplementedError, match="GPT remat"):
        dataclasses.replace(cfg, remat=True)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, paged_attn_impl="pallas")
    for fn in (tgpt.param_shardings, tgpt.paged_commit_chunk):
        with pytest.raises(NotImplementedError):
            fn()
    model = GPTLMHeadModel(GPTConfig.tiny(dtype=torch.float32), device="cpu")
    ids, segs = torch.zeros((1, 4), dtype=torch.long), torch.ones((1, 4), dtype=torch.long)
    # packed training runs now (and lm_loss with it); packing composes with no cache and no pad_offsets
    assert torch.isfinite(tgpt.lm_loss(model(ids, segment_ids=segs), ids, segment_ids=segs))
    with pytest.raises(ValueError, match="packed-TRAINING"):
        model(ids, cache=tgpt.init_cache(model.config, 1, 8, device="cpu"), position=0, segment_ids=segs)
    with pytest.raises(ValueError, match="pad_offsets"):
        model(ids, segment_ids=segs, pad_offsets=torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError, match="generator"):
        model(ids, deterministic=False)
    with pytest.raises(NotImplementedError):  # speculative verify: multi-token per-row paged step
        pool = tgpt.init_block_pool(model.config, 3, 4, device="cpu")
        model(torch.zeros((1, 2), dtype=torch.long),
              cache={"table": torch.zeros((1, 2), dtype=torch.int32), **pool}, position=torch.tensor([0]))


def test_bf16_config_keeps_f32_parameters_equal_to_the_jax_tree(pair):
    """Mixed precision as flax does it: the bf16 config computes in bf16 but
    stores float32 parameters, loaded from the JAX tree without rounding."""
    _, _, params, _ = pair
    model = init_gpt(GPTConfig.tiny(), params=params, device="cpu")
    state = convert.params_from_jax(params)
    for name, value in model.state_dict().items():
        assert value.dtype == torch.float32 and torch.equal(value, state[name]), name
    with torch.no_grad():
        logits = model(torch.from_numpy(_ids(2, 2, 7)).long())
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
