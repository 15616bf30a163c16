"""Port parity: the speculative verify chunk and its commit on the paged pool.

- ``_paged_verify_chunk`` (the plain path on the CPU) against the JAX
  package's on the same pool, table, positions and q/k/v, made with numpy
  from a seed: int8 and f32 pools, ragged per-row positions, a row at the
  sentinel position. Tolerance: f32 atol 1e-5 on live rows.
- Inside the port (``tests/unit/test_paged_spec_kernels.py``'s two facts),
  bitwise on both pools: chunk token j of a verify scores what the decode
  path (the append, then K4's plain version at S = 1) scores after tokens
  0..j; committing all S tokens leaves the pool sequential appends leave; a
  partial commit equals the accepted prefix, and a row with count 0 keeps
  its data blocks. Through the model too: the verify's logits equal feeding
  its tokens one at a time through decode, bit for bit (the verify takes each
  position's products at the decode step's shape), and the pool stays
  untouched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu_torch.models import GPTConfig, init_gpt
from unionml_tpu_torch.models import gpt as tgpt

BS, MAX_LEN, NSLOTS, S = 4, 32, 3, 4
HEADS, HD = 2, 16


def _pool_case(seed, quantized):
    rng = np.random.default_rng(seed)
    width = tgpt.block_table_width(MAX_LEN, BS)
    blocks = NSLOTS * (width - 1) + 1
    if quantized:
        cache = {"k": rng.integers(-127, 128, (blocks, HEADS, BS, HD)).astype(np.int8),
                 "v": rng.integers(-127, 128, (blocks, HEADS, BS, HD)).astype(np.int8),
                 "k_scale": rng.uniform(0.005, 0.05, (blocks, HEADS, 1, 1)).astype(np.float32),
                 "v_scale": rng.uniform(0.005, 0.05, (blocks, HEADS, 1, 1)).astype(np.float32)}
    else:
        cache = {"k": rng.normal(size=(blocks, HEADS, BS, HD)).astype(np.float32),
                 "v": rng.normal(size=(blocks, HEADS, BS, HD)).astype(np.float32)}
    table = np.full((NSLOTS, width), blocks - 1, dtype=np.int32)
    table[:, :-1] = rng.permutation(blocks - 1).reshape(NSLOTS, width - 1)
    position = np.array([6, 1, (width - 1) * BS], dtype=np.int32)  # ragged, the last row at the sentinel
    q, k, v = (rng.normal(size=(NSLOTS, HEADS, S, HD)).astype(np.float32) for _ in range(3))
    return cache, table, position, q, k, v


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "f32"])
def test_verify_chunk_matches_jax(quantized):
    cache, table, position, q, k, v = _pool_case(3 + quantized, quantized)
    want = np.asarray(jgpt._paged_verify_chunk(
        {n: jnp.asarray(x) for n, x in cache.items()}, jnp.asarray(table), jnp.asarray(position),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.float32, impl="xla"))
    t_cache = {n: torch.from_numpy(x.copy()) for n, x in cache.items()}
    got = tgpt._paged_verify_chunk(t_cache, torch.from_numpy(table), torch.from_numpy(position),
                                   *(torch.from_numpy(x) for x in (q, k, v)), torch.float32).numpy()
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-5, rtol=0)
    for name, leaf in cache.items():
        assert np.array_equal(t_cache[name].numpy(), leaf), f"verify wrote the pool: {name}"


def _decode_layer(cache, table, position, k, v):
    """The per-row decode path of one layer for one token: the append into
    the pool, then K4's plain version at S = 1 over the real table."""
    dst, off = tgpt._decode_slots(position, table, BS)
    if "k_scale" in cache:
        tgpt._paged_append_quantized(cache["k"], cache["k_scale"], dst, off, k)
        tgpt._paged_append_quantized(cache["v"], cache["v_scale"], dst, off, v)
    else:
        cache["k"][dst, :, off, :] = k
        cache["v"][dst, :, off, :] = v


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("counts", [(S, S, S), (2, 0, 4)], ids=["full", "partial"])
def test_verify_and_commit_equal_sequential_decode_bitwise(quantized, counts):
    """Token j of a verify chunk scores bit for bit what the decode path
    scores after appending tokens 0..j; committing ``counts`` tokens leaves the
    pool the decode path leaves after the first ``counts[row]`` appends (rows
    past their count write only the scratch block)."""
    np_cache, table, position, q, k, v = _pool_case(7 + quantized, quantized)
    position[2] = 9  # a live third row
    t = {n: torch.from_numpy(x) for n, x in np_cache.items()}
    table, position, q, k, v = (torch.from_numpy(x) for x in (table, position, q, k, v))
    verified = tgpt._paged_verify_chunk({n: x.clone() for n, x in t.items()}, table, position, q, k, v,
                                        torch.float32)
    counts = torch.tensor(counts)
    seq, ref = {n: x.clone() for n, x in t.items()}, {n: x.clone() for n, x in t.items()}
    sentinel = (table.shape[1] - 1) * BS
    for j in range(S):
        _decode_layer(seq, table, position + j, k[:, :, j], v[:, :, j])
        ctx = tgpt.paged_attention(q[:, :, j:j + 1], seq["k"], seq["v"], table, position + j,
                                   k_scale=seq.get("k_scale"), v_scale=seq.get("v_scale"), out_dtype=torch.float32)
        assert torch.equal(verified[:, :, j:j + 1], ctx), f"chunk token {j}"
        _decode_layer(ref, table, torch.where(j < counts, position + j, torch.full_like(position, sentinel)),
                      k[:, :, j], v[:, :, j])
    committed = tgpt.paged_commit_chunk({n: x.clone() for n, x in t.items()}, table, position, counts, k, v)
    data = table[:, :-1].reshape(-1).long()
    for name in t:
        assert torch.equal(committed[name], ref[name]), name
        if int(counts.min()) == 0:  # the zero-count row's data blocks keep their bytes
            rows = table[counts == 0, :-1].reshape(-1).long()
            assert torch.equal(committed[name][rows], t[name][rows]), name
        if int(counts.min()) == S:
            assert torch.equal(committed[name][data], seq[name][data]), name


@pytest.fixture(scope="module")
def model():
    return init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0), std=0.3, device="cpu")


def _state(model, kv_quantize, lens, seed):
    """A pool whose rows hold ``lens`` tokens, built by per-row decode."""
    width = tgpt.block_table_width(MAX_LEN, BS)
    pool = tgpt.init_block_pool(model.config, NSLOTS * (width - 1) + 1, BS, kv_quantize=kv_quantize, device="cpu")
    tables = torch.full((NSLOTS, width), NSLOTS * (width - 1), dtype=torch.int32)
    tables[:, :-1] = torch.arange(NSLOTS * (width - 1), dtype=torch.int32).reshape(NSLOTS, width - 1)
    rng = np.random.default_rng(seed)
    for j in range(int(lens.max())):
        toks = torch.from_numpy(rng.integers(1, 512, (NSLOTS, 1)))
        _forward(model, pool, tables, toks, torch.from_numpy(np.minimum(j, lens - 1)))
    return pool, tables, torch.from_numpy(rng.integers(1, 512, (NSLOTS, S)))


def _forward(model, pool, tables, tokens, positions):
    with torch.no_grad():
        return model(tokens, cache={"table": tables, **pool}, position=positions.to(torch.int32))


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32-pool", "int8-pool"])
def test_model_verify_matches_sequential_decode_and_leaves_the_pool(model, kv):
    """Through the model: the verify chunk's logits equal feeding its tokens
    one at a time bit for bit, and the pool leaves stay untouched."""
    lens = np.array([6, 3, 5])
    pool, tables, chunk = _state(model, kv, lens, seed=1)
    before = {name: {k: v.clone() for k, v in layer.items()} for name, layer in pool.items()}
    ver_logits, ver_cache = _forward(model, pool, tables, chunk, torch.from_numpy(lens))
    for name, layer in pool.items():
        assert all(torch.equal(layer[k], before[name][k]) for k in layer), f"verify wrote {name}"
        assert ver_cache[name]["ck"].shape == (NSLOTS, 4, S, 16)
    seq_logits = []
    for j in range(S):
        logits, _ = _forward(model, pool, tables, chunk[:, j:j + 1], torch.from_numpy(lens + j))
        seq_logits.append(logits[:, 0])
    assert torch.equal(ver_logits, torch.stack(seq_logits, dim=1))
