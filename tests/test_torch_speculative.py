"""Port parity: ``speculative_generate`` (dense caches, batch 1, fixed γ).

Ports ``tests/unit/test_speculative.py:34-155`` on the tiny f32 GPT, the JAX
weights carried across: greedy speculative output equals target-only greedy
decoding token for token for any draft (a different one, the target itself,
or garbage weights) and any γ, and equals the JAX package's
``speculative_generate`` on the same weights; a self-draft accepts every
proposal; sampled output follows the TARGET's distribution (the exact
marginal of the third token, enumerated on a vocab of 8, against 80 seeded
draws: total variation below 0.25, JAX's bound); bad arguments raise as in
JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models.speculative import speculative_generate as jax_speculative_generate
from unionml_tpu_torch.models import GPTConfig, generate, init_gpt, speculative_generate


def _pair(seed, vocab=512):
    jcfg = jgpt.GPTConfig.tiny(vocab_size=vocab, dropout=0.0, dtype=jnp.float32, attention_impl="xla")
    variables = jgpt.init_params(jcfg, rng=jax.random.PRNGKey(seed), seq_len=16)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    tmodel = init_gpt(GPTConfig.tiny(vocab_size=vocab, dtype=torch.float32, dropout=0.0), params=params,
                      device="cpu")
    return jgpt.GPTLMHeadModel(jcfg), variables, tmodel


@pytest.fixture(scope="module")
def target():
    return _pair(0)


@pytest.fixture(scope="module")
def draft():
    """A different model (its own weights) on the same vocab."""
    return _pair(42)


def _ids(prompt):
    return torch.tensor([prompt])


@pytest.mark.parametrize("prompt,n,gamma,vs_jax", [
    ([3, 1, 4, 1, 5], 12, 1, False), ([3, 1, 4, 1, 5], 12, 2, True), ([3, 1, 4, 1, 5], 12, 4, True),
    ([3, 1, 4, 1, 5], 12, 7, False), ([2], 9, 3, False), ([7] * 7, 5, 3, False), ([1, 2, 3], 17, 3, False),
])
def test_greedy_equals_target_only_and_jax(target, draft, prompt, n, gamma, vs_jax):
    got = speculative_generate(target[2], draft[2], _ids(prompt), n, gamma=gamma)
    assert torch.equal(got, generate(target[2], _ids(prompt), n))
    if vs_jax:
        want = jax_speculative_generate(target[0], target[1], draft[0], draft[1],
                                        jnp.asarray([prompt], jnp.int32), n, gamma=gamma)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_self_draft_accepts_everything(target):
    model = target[2]
    got, stats = speculative_generate(model, model, _ids([3, 1, 4]), 10, gamma=4, return_stats=True)
    assert torch.equal(got, generate(model, _ids([3, 1, 4]), 10))
    assert stats["acceptance_rate"] == 1.0 and stats["rounds"] <= 2


def test_adversarial_draft_still_exact(target):
    model = target[2]
    bad = init_gpt(model.config, device="cpu", params=jax.tree_util.tree_map(
        lambda x: np.random.default_rng(9).normal(size=x.shape).astype(np.float32),
        jax.device_get(target[1])))
    got, stats = speculative_generate(model, bad, _ids([5, 4, 3, 2]), 8, gamma=4, return_stats=True)
    assert torch.equal(got, generate(model, _ids([5, 4, 3, 2]), 8))
    assert stats["acceptance_rate"] < 1.0


def test_sampled_self_draft_accepts_everything(target):
    model = target[2]
    out, stats = speculative_generate(model, model, _ids([3, 1, 4]), 12, gamma=4, temperature=1.0,
                                      generator=torch.Generator().manual_seed(5), return_stats=True)
    assert out.shape == (1, 15) and stats["acceptance_rate"] == 1.0 and int(out.max()) < 512


def test_sampled_distribution_matches_target():
    vocab = 8
    t_model, d_model = _pair(0, vocab)[2], _pair(99, vocab)[2]

    def probs(ids):
        with torch.no_grad():
            return torch.softmax(t_model(torch.tensor(ids))[:, -1, :], dim=-1).numpy()

    base = probs([[1, 2]])[0]
    p_t2 = probs([[1, 2, t1] for t1 in range(vocab)])
    p_t3 = probs([[1, 2, t1, t2] for t1 in range(vocab) for t2 in range(vocab)]).reshape(vocab, vocab, vocab)
    exact = np.einsum("a,ab,abc->c", base, p_t2, p_t3)
    n, spec = 80, np.zeros(vocab)
    for seed in range(n):
        out = speculative_generate(t_model, d_model, _ids([1, 2]), 3, gamma=2, temperature=1.0,
                                   generator=torch.Generator().manual_seed(seed))
        spec[int(out[0, -1])] += 1
    tv = 0.5 * np.abs(spec / n - exact).sum()
    assert tv < 0.25, (tv, spec / n, exact)


def test_validation_errors(target, draft):
    t_model, d_model = target[2], draft[2]
    ok = _ids([1, 2])
    with pytest.raises(ValueError, match=r"\(1, prompt_len\)"):
        speculative_generate(t_model, d_model, torch.zeros((2, 3), dtype=torch.long), 4)
    with pytest.raises(ValueError, match="gamma"):
        speculative_generate(t_model, d_model, ok, 4, gamma=0)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        speculative_generate(t_model, d_model, ok, 10_000)
    with pytest.raises(ValueError, match="vocab"):
        speculative_generate(t_model, init_gpt(GPTConfig.tiny(vocab_size=64, dtype=torch.float32), device="cpu"),
                             ok, 4)
