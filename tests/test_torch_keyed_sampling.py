"""Port parity: keyed selection (``ops/sampling.py``) against ``jax.random``.

The speculative round picks every token as a pure function of (slot key,
position): ``fold_in`` then ``categorical`` (``unionml_tpu/serving/
speculative.py:241-253``). The port's threefry2x32 in int64 torch ops must give
the installed JAX's bits exactly (threefry2x32, ``jax_threefry_partitionable``
on): ``fold_in`` keys and the random bits bitwise, the uniforms
``jax.random.uniform`` builds from them bitwise, and the categorical tokens
equal over 256 (key, position) draws on a small vocab. ``keyed_select``
equals the JAX round's ``select`` (greedy rows included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu_torch.ops import sampling as ts

TINY = np.finfo(np.float32).tiny


def _keys(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def test_threefry_config_is_the_one_ported():
    assert jax.config.jax_default_prng_impl == "threefry2x32" and jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("what", ["fold_in", "bits", "uniform"])
def test_keyed_bits_equal_jax_bitwise(what):
    keys = _keys(64, 0)
    if what == "fold_in":
        data = np.random.default_rng(1).integers(0, 2 ** 31, 64).astype(np.int32)
        want = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(data).astype(jnp.uint32))
        got = ts.fold_in(_t(keys), _t(data))
    else:
        want = jax.vmap(lambda k: jax.random.bits(k, (97,), jnp.uint32))(jnp.asarray(keys))
        got = ts.random_bits(_t(keys), 97)
        if what == "uniform":
            want = jax.vmap(lambda k: jax.random.uniform(k, (97,), minval=TINY, maxval=1.0))(jnp.asarray(keys))
            floats = ((got >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
            got = torch.clamp_min(floats + TINY, TINY)
            assert np.array_equal(np.asarray(want), got.numpy())
            return
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


def test_keyed_categorical_equals_jax_over_256_draws():
    keys, vocab = _keys(256, 2), 11
    logits = np.random.default_rng(3).normal(size=(256, vocab)).astype(np.float32) * 2.0
    positions = np.arange(256, dtype=np.int32) * 7
    folded = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(positions).astype(jnp.uint32))
    want = np.asarray(jax.vmap(jax.random.categorical)(folded, jnp.asarray(logits)))
    got = ts.keyed_categorical(ts.fold_in(_t(keys), _t(positions)), torch.from_numpy(logits)).numpy()
    assert np.array_equal(want, got)
    assert len(set(got.tolist())) > 5  # the draws do spread over the vocab


def test_keyed_select_equals_the_jax_round_rule():
    keys, n, vocab = _keys(8, 4), 8, 50
    logits = np.random.default_rng(5).normal(size=(n, vocab)).astype(np.float32) * 3.0
    positions = np.arange(n, dtype=np.int32) + 100
    temp = np.array([0.0, 0.7, 1.0, 0.0, 1.3, 0.9, 0.5, 2.0], dtype=np.float32)

    def select(logits, positions, keys, temp):  # unionml_tpu/serving/speculative.py:241-253
        greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        k = jax.vmap(jax.random.fold_in)(keys, positions.astype(jnp.uint32))
        scaled = logits.astype(jnp.float32) / jnp.maximum(temp, 1e-6)[:, None]
        drawn = jax.vmap(jax.random.categorical)(k, scaled)
        return jnp.where(temp > 0, drawn.astype(jnp.int32), greedy)

    want = np.asarray(select(*(jnp.asarray(x) for x in (logits, positions, keys, temp))))
    got = ts.keyed_select(torch.from_numpy(logits), _t(keys), _t(positions), torch.from_numpy(temp)).numpy()
    assert np.array_equal(want, got)
