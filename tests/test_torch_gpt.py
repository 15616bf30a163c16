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

from tests.torch_xp_axes_ranks import expert_tensor_layout
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
    # ring/ulysses are ported (tests/test_torch_sequence_parallel.py): the configs build, and JAX's
    # ValueErrors stay: a forward without sp_mesh, and either impl as paged_attn_impl
    for impl in ("ring", "ulysses"):
        assert dataclasses.replace(cfg, attention_impl=impl, sp_mesh=object()).attention_impl == impl
        with pytest.raises(ValueError):
            dataclasses.replace(cfg, paged_attn_impl=impl)
    with pytest.raises(ValueError, match="requires a sequence-parallel mesh"):
        GPTLMHeadModel(GPTConfig.tiny(dtype=torch.float32, attention_impl="ring"), device="cpu")(
            torch.zeros((1, 4), dtype=torch.long))
    # remat is ported (tests/test_torch_remat.py): the config builds and a tiny model's forward is unchanged
    assert dataclasses.replace(cfg, remat=True).remat
    ids = torch.from_numpy(_ids(0, 2, 6)).long()
    plain, remat = (GPTLMHeadModel(GPTConfig.tiny(dtype=torch.float32, remat=flag), device="cpu") for flag in (0, 1))
    remat.load_state_dict(plain.state_dict())
    torch.testing.assert_close(remat(ids), plain(ids), atol=0, rtol=0)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, paged_attn_impl="pallas")
    # param_shardings is ported (tests/test_torch_mesh.py), and so are sparse blocks under a tensor mesh
    # (tests/test_torch_expert_parallel.py), serving over an expert axis (tests/test_torch_moe.py,
    # tests/test_torch_mesh_serving_axes.py) and over an expert and a tensor axis at once
    # (tests/test_torch_expert_axes.py): tensor_parallel cuts a rank's 2 of the 4 experts at half their
    # hidden width, summed over the 4 ranks of expert×tensor
    sparse = GPTLMHeadModel(GPTConfig.tiny(dtype=torch.float32, moe_every=2, num_experts=4), device="cpu")
    assert expert_tensor_layout(sparse) == [((2, 64, 128), (2, 128, 64), 4)]
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
    # a multi-token per-row paged step is the speculative verify: it leaves the
    # pool untouched and hands back the chunk's K/V for paged_commit_chunk
    pool = tgpt.init_block_pool(model.config, 3, 4, device="cpu")
    with torch.no_grad():
        _, verified = model(torch.zeros((1, 2), dtype=torch.long),
                            cache={"table": torch.zeros((1, 2), dtype=torch.int32), **pool},
                            position=torch.tensor([0]))
    assert verified["layer_0"]["ck"].shape == (1, 4, 2, 16)
    assert all(not leaf.any() for layer in pool.values() for leaf in layer.values())


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


def _hf_state_dict(tree, lm_head: bool):
    """A HuggingFace GPT-2 state dict (``transformer.`` keys when ``lm_head``) of
    the JAX tree's weights: Conv1D weights keep the flax ``(in, out)`` layout."""
    prefix = "transformer." if lm_head else ""
    hf = {f"{prefix}wte.weight": tree["wte"]["embedding"], f"{prefix}wpe.weight": tree["wpe"]["embedding"],
          f"{prefix}ln_f.weight": tree["final_norm"]["scale"], f"{prefix}ln_f.bias": tree["final_norm"]["bias"]}
    names = {"attn_norm": "ln_1", "qkv": "attn.c_attn", "attn_out": "attn.c_proj", "mlp_norm": "ln_2",
             "mlp_up": "mlp.c_fc", "mlp_down": "mlp.c_proj"}
    i = 0
    while f"layer_{i}" in tree:
        for ours, theirs in names.items():
            node = tree[f"layer_{i}"][ours]
            hf[f"{prefix}h.{i}.{theirs}.weight"] = node["kernel" if "kernel" in node else "scale"]
            hf[f"{prefix}h.{i}.{theirs}.bias"] = node["bias"]
        i += 1
    if lm_head:
        hf["lm_head.weight"] = tree["wte"]["embedding"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in hf.items()}


@pytest.mark.parametrize("lm_head", [False, True], ids=["GPT2Model", "GPT2LMHeadModel"])
def test_import_hf_weights_matches_the_jax_import(pair, lm_head):
    """One HF-keyed dict built from the JAX package's seeded parameters, imported
    by both packages: the same tree, and float32 logits within 1e-5."""
    jmodel, _, params, _ = pair
    hf = _hf_state_dict(params["params"], lm_head)
    cfg = GPTConfig.tiny(dtype=torch.float32)
    got = tgpt.import_hf_weights(hf, cfg)
    want = jgpt.import_hf_weights(hf, jmodel.config)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    ids = _ids(77, 2, 13)
    jlogits = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray, want), jnp.asarray(ids)))
    tmodel = init_gpt(cfg, params=got, device="cpu").requires_grad_(False)
    np.testing.assert_allclose(tmodel(torch.from_numpy(ids).long()).numpy(), jlogits, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="dense GPT-2"):
        tgpt.import_hf_weights(hf, GPTConfig.tiny(moe_every=2))


def test_import_hf_weights_reproduces_transformers_logits():
    """``unionml_tpu/models/gpt.py``'s HF parity test on the port: a
    ``GPT2LMHeadModel`` built in code with random weights (no download)."""
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    torch.manual_seed(0)
    hf_model = transformers.GPT2LMHeadModel(hf_config).eval()
    config = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, max_position_embeddings=64,
                       dropout=0.0, dtype=torch.float32)
    model = init_gpt(config, params=tgpt.import_hf_weights(hf_model.state_dict(), config), device="cpu")
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 16))
    with torch.no_grad():
        want = hf_model(torch.tensor(ids)).logits.numpy()
        got = model(torch.tensor(ids), deterministic=True).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
