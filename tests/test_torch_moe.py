"""Port parity: the mixture-of-experts layer and its dispatch against the JAX package.

Inputs come from numpy seeds at tiny sizes (tokens 24-48, d 16, experts 4,
inner width 32) and go through ``unionml_tpu/models/moe.py`` and
``unionml_tpu/parallel/ep.py`` on the CPU and through the port's
``models/moe.py`` and ``parallel/ep.py`` on the CPU. Tolerances:

- router losses: within 1e-6 (f32, summation order only);
- ``moe_apply_topk`` and ``MoEMlp`` forwards: f32 within 1e-5 of the
  output's largest magnitude; bf16 within 2e-2 (atol and rtol: expert
  products rounded to bf16 in other orders);
- the routing itself (top-k indices, kept choices, buffer slots, the
  ``(T, E, C)`` dispatch tensor): exactly;
- gradients of the router, ``w_in`` and ``w_out`` against ``jax.grad`` (f32,
  task loss plus the collected router losses): within 1e-4 of each leaf's
  largest magnitude;
- the index dispatch against the port's one-hot plain version: f32 within
  1e-6, bf16 within one bf16 step (2^-7 relative), dropped sets exactly.

The ``cuda`` test needs the card (it captures a sparse decode step as a
CUDA graph) and skips elsewhere; the card's machine has no JAX, so the JAX
package is imported only by the tests that use it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unionml_tpu_torch.models import GPTConfig, MoEMlp, collect_aux_losses, init_gpt
from unionml_tpu_torch.models.moe import load_balancing_loss, router_z_loss
from unionml_tpu_torch.parallel import ep

D, H, E = 16, 32, 4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's MoE modules (absent on the card's machine)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from unionml_tpu.models import moe as jmoe
    from unionml_tpu.parallel import ep as jep

    return jax, jnp, jmoe, jep


def _experts(params, x):
    w_in, w_out = params
    return torch.bmm(F.gelu(torch.bmm(x, w_in), approximate="tanh"), w_out)


def _jax_expert(jax):
    return lambda p, x: jax.nn.gelu(x @ p[0]) @ p[1]


def _weights(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w_in = (rng.standard_normal((E, D, H)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((E, H, D)) * 0.3).astype(np.float32)
    return w_in, w_out


def _gates(seed, tokens, skew=1.5):
    """Softmax gates of a router that favours expert 0 (so capacity drops)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((tokens, E)).astype(np.float32)
    logits[:, 0] += skew
    return np.exp(logits) / np.exp(logits).sum(-1, keepdims=True), rng.standard_normal((tokens, D)).astype(np.float32)


def _dispatch_of(routing, num_experts, capacity):
    """The (T, E, C) 0/1 dispatch tensor of a port ``Routing``."""
    tokens, k = routing.index.shape
    out = torch.zeros(tokens, num_experts, capacity)
    for t in range(tokens):
        for j in range(k):
            if routing.keep[t, j]:
                out[t, routing.index[t, j], routing.position[t, j]] = 1.0
    return out


def _close(got, want, dtype, scale=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5 * (scale or np.abs(want).max()), rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_losses_match_jax(jx, seed):
    jax, jnp, jmoe, _ = jx
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, E)).astype(np.float32) * 2
    logits[::5, 1] = logits[::5, 2]  # exact ties: argmax takes the first index in both
    gates = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want_z = jmoe.router_z_loss(jnp.asarray(logits))
    want_b = jmoe.load_balancing_loss(gates, jnp.argmax(jnp.asarray(logits), axis=-1), E)
    t_logits = torch.from_numpy(logits)
    got_z = router_z_loss(t_logits)
    got_b = load_balancing_loss(torch.softmax(t_logits, -1), torch.argmax(t_logits, -1), E)
    np.testing.assert_allclose(float(got_z), float(want_z), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(got_b), float(want_b), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_apply_topk_matches_jax(jx, k, dropless):
    jax, jnp, _, jep = jx
    gates, tokens = _gates(k, 48)
    w_in, w_out = _weights(3)
    cf = None if dropless else 1.0
    want = jep.moe_apply_topk(_jax_expert(jax), (jnp.asarray(w_in), jnp.asarray(w_out)), jnp.asarray(tokens),
                              jnp.asarray(gates), None, k=k, capacity_factor=cf, normalize_gates=k > 1)
    t_gates = torch.from_numpy(gates)
    got = ep.moe_apply_topk(_experts, (torch.from_numpy(w_in), torch.from_numpy(w_out)), torch.from_numpy(tokens),
                            t_gates, k=k, capacity_factor=cf, normalize_gates=k > 1)
    _close(got, want, "f32")
    routing = ep.topk_route(t_gates, k, cf, k > 1)
    if not dropless:
        assert not bool(routing.keep.all()), "the skewed router must overflow expert 0"
        # JAX's one-hot dispatch tensor, exactly
        top_gates, top_index = jax.lax.top_k(jnp.asarray(gates), k)
        dispatch, _ = jep._topk_dispatch_combine(top_index, top_gates, E, routing.capacity, jnp.float32)
        np.testing.assert_array_equal(np.asarray(routing.index), np.asarray(top_index))
        np.testing.assert_array_equal(_dispatch_of(routing, E, routing.capacity).numpy(), np.asarray(dispatch))


def test_choice_major_drop_order(jx):
    """Every token's first choice takes a slot before any second choice:
    tokens 0-1 prefer expert 0 then 1, tokens 2-3 expert 1 then 0, capacity
    2 (cf 0.5): all four first choices stay and all four second choices drop
    (token-major order would have kept token 0's second choice)."""
    jax, jnp, _, jep = jx
    gates = np.array([[0.6, 0.4], [0.7, 0.3], [0.2, 0.8], [0.45, 0.55]], np.float32)
    routing = ep.topk_route(torch.from_numpy(gates), 2, 0.5, True)
    assert routing.capacity == 2
    assert routing.keep[:, 0].all() and not routing.keep[:, 1].any()
    assert routing.position.tolist() == [[0, 2], [1, 3], [0, 2], [1, 3]]
    top_gates, top_index = jax.lax.top_k(jnp.asarray(gates), 2)
    dispatch, _ = jep._topk_dispatch_combine(top_index, top_gates, 2, 2, jnp.float32)
    np.testing.assert_array_equal(_dispatch_of(routing, 2, 2).numpy(), np.asarray(dispatch))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_top_k_ties_break_toward_the_lower_index(jx, dtype):
    jax, jnp, _, _ = jx
    gates = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3], [0.4, 0.1, 0.4, 0.1],
                          [0.0, 0.0, 0.5, 0.5]], dtype=dtype)
    for k in (1, 2, 3):
        _, want = jax.lax.top_k(jnp.asarray(gates.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), k)
        np.testing.assert_array_equal(ep.topk_route(gates, k, None).index.numpy(), np.asarray(want))


def test_k1_keeps_the_raw_gate(jx):
    """k=1 scales the expert output by the top gate, unnormalised (capacity
    wrapper and dropless alike), as JAX's ``moe_apply_capacity``."""
    jax, jnp, _, jep = jx
    gates, tokens = _gates(5, 24, skew=0.0)
    w_in, w_out = _weights(6)
    params = (torch.from_numpy(w_in), torch.from_numpy(w_out))
    got = ep.moe_apply_capacity(_experts, params, torch.from_numpy(tokens), torch.from_numpy(gates),
                                capacity_factor=4.0)
    want = jep.moe_apply_capacity(_jax_expert(jax), (jnp.asarray(w_in), jnp.asarray(w_out)), jnp.asarray(tokens),
                                  jnp.asarray(gates), None, capacity_factor=4.0)
    _close(got, want, "f32")
    top = torch.from_numpy(gates).max(-1)
    all_out = _experts(params, torch.from_numpy(tokens).expand(E, 24, D))
    manual = top.values[:, None] * all_out[top.indices, torch.arange(24)]
    torch.testing.assert_close(got, manual, atol=1e-6, rtol=0)


def _jax_moe(jx, seed, k, cf, dtype):
    """(jax module, its params, port module) with the same weights."""
    jax, jnp, jmoe, _ = jx
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    module = jmoe.MoEMlp(num_experts=E, hidden_size=H, k=k, capacity_factor=cf, dtype=jdtype)
    rng = np.random.default_rng(seed)
    kernel = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    bias = np.array([1.0, 0.0, -0.2, 0.1], np.float32)  # expert 0 overflows
    w_in, w_out = _weights(seed + 100)
    params = {"params": {"router": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)},
                         "w_in": jnp.asarray(w_in).astype(jdtype), "w_out": jnp.asarray(w_out).astype(jdtype)}}
    port = MoEMlp(D, E, H, k=k, capacity_factor=cf, dtype=dtype, device="cpu")
    port.load_state_dict({"router.weight": torch.from_numpy(kernel.T.copy()), "router.bias": torch.from_numpy(bias),
                          "w_in": torch.from_numpy(w_in), "w_out": torch.from_numpy(w_out)})
    return module, params, port


@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_forward_matches_jax(jx, k, dtype, dropless):
    jax, jnp, jmoe, _ = jx
    module, params, port = _jax_moe(jx, 11 + k, k, 1.0, dtype)
    x = np.random.default_rng(k).standard_normal((2, 16, D)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want, sown = module.apply(params, xj, dropless=dropless, mutable=["intermediates"])
    with torch.no_grad():
        got, aux = port(torch.from_numpy(x).to(dtype), dropless=dropless)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got.float(), np.asarray(want.astype(jnp.float32)), "f32" if dtype == torch.float32 else "bf16")
    np.testing.assert_allclose(float(collect_aux_losses([aux])), float(jmoe.collect_aux_losses(sown["intermediates"])),
                               atol=1e-6, rtol=1e-5)


def test_moe_mlp_gradients_match_jax(jx):
    jax, jnp, jmoe, _ = jx
    module, params, port = _jax_moe(jx, 21, 2, 1.0, torch.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16, D)).astype(np.float32)
    r = rng.standard_normal((3, 16, D)).astype(np.float32)

    def loss(p):
        out, sown = module.apply(p, jnp.asarray(x), mutable=["intermediates"])
        return jnp.sum(out * jnp.asarray(r)) + jmoe.collect_aux_losses(sown["intermediates"])

    want = jax.grad(loss)(params)["params"]
    out, aux = port(torch.from_numpy(x))
    (torch.sum(out * torch.from_numpy(r)) + collect_aux_losses([aux])).backward()
    pairs = {
        "router.kernel": (port.router.weight.grad.t(), want["router"]["kernel"]),
        "router.bias": (port.router.bias.grad, want["router"]["bias"]),
        "w_in": (port.w_in.grad, want["w_in"]),
        "w_out": (port.w_out.grad, want["w_out"]),
    }
    for name, (got, ref) in pairs.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_index_dispatch_matches_the_one_hot_plain_version(k, dtype, dropless):
    gates, tokens = _gates(30 + k, 40)
    w_in, w_out = _weights(31)
    cf = None if dropless else 0.75
    params = tuple(torch.from_numpy(w).to(dtype).requires_grad_(True) for w in (w_in, w_out))
    t_gates = torch.from_numpy(gates).to(dtype).requires_grad_(True)
    x = torch.from_numpy(tokens).to(dtype).requires_grad_(True)
    kw = dict(k=k, capacity_factor=cf, normalize_gates=k > 1)
    got = ep.moe_apply_topk(_experts, params, x, t_gates, **kw)
    want = ep.reference_moe_apply_topk(_experts, params, x, t_gates, **kw)
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else dict(atol=1e-3, rtol=2 ** -7)
    torch.testing.assert_close(got, want, **tol)
    r = torch.randn(got.shape, generator=torch.Generator().manual_seed(k)).to(dtype)
    g_got = torch.autograd.grad((got.float() * r.float()).sum(), (x, t_gates, *params))
    g_want = torch.autograd.grad((want.float() * r.float()).sum(), (x, t_gates, *params))
    for a, b in zip(g_got, g_want):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=(1e-5 if dtype == torch.float32 else 2e-2) * scale,
                                   rtol=0)
    if not dropless:
        # the dropped set, exactly: which experts received each token
        routing = ep.topk_route(t_gates.detach(), k, cf, k > 1)
        order = torch.sort(t_gates.detach(), dim=-1, descending=True, stable=True).indices[:, :k]
        dispatch, _ = ep.reference_topk_dispatch_combine(order, routing.gates.detach(), E, routing.capacity,
                                                         torch.float32)
        assert torch.equal(_dispatch_of(routing, E, routing.capacity), dispatch)
        assert not bool(routing.keep.all())


def test_moe_decode_step_reads_nothing_to_the_host():
    """A dropless sparse decode step over an int8 paged pool runs no
    operator a CUDA graph cannot hold (the capture's own check)."""
    from unionml_tpu_torch import _graphs
    from unionml_tpu_torch.models.gpt import init_block_pool, init_block_tables

    config = GPTConfig.tiny(moe_every=1, num_experts=4, dtype=torch.float32, dropout=0.0)
    model = init_gpt(config, device="cpu")
    pool = init_block_pool(config, 16, 4, kv_quantize="int8", device="cpu")
    tables = init_block_tables(2, 16, 4, scratch_id=15, device="cpu")
    tables[:, :4] = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    with torch.no_grad(), _graphs._HostSyncCheck():
        logits, _ = model(torch.tensor([[3], [5]]), cache={"table": tables, **pool}, position=torch.tensor([2, 6]))
    assert logits.shape == (2, 1, config.vocab_size) and torch.isfinite(logits).all()


def test_unported_and_invalid_options_raise():
    with pytest.raises(NotImplementedError, match="M12"):
        GPTConfig.tiny(moe_every=2, moe_dispatch="a2a")
    with pytest.raises(NotImplementedError, match="M12"):
        GPTConfig.tiny(moe_every=2, ep_mesh=object())
    with pytest.raises(ValueError, match="moe_dispatch"):
        GPTConfig.tiny(moe_every=2, moe_dispatch="nope")
    with pytest.raises(NotImplementedError, match="M12"):
        MoEMlp(D, E, H, dispatch="a2a")
    with pytest.raises(ValueError, match="dispatch"):
        MoEMlp(D, E, H, dispatch="nope")
    gates, tokens = _gates(0, 8)
    params = tuple(torch.from_numpy(w) for w in _weights(0))
    with pytest.raises(NotImplementedError, match="M12"):
        ep.moe_apply_topk(_experts, params, torch.from_numpy(tokens), torch.from_numpy(gates), object())
    with pytest.raises(ValueError, match="k"):
        ep.moe_apply_topk(_experts, params, torch.from_numpy(tokens), torch.from_numpy(gates), k=E + 1)
    for fn in (ep.moe_apply_a2a, ep.expert_sharding, ep.moe_apply):
        with pytest.raises(NotImplementedError, match="M12"):
            fn()
    model = init_gpt(GPTConfig.tiny(moe_every=2, num_experts=4, dtype=torch.float32), device="cpu")
    ids = torch.zeros((2, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="pad_offsets"):
        model(ids, pad_offsets=torch.tensor([0, 2]), deterministic=False, generator=torch.Generator())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sparse decode step's kernels and graph)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moe_decode_step_replays_as_a_cuda_graph(cuda, dtype):
    """One dropless sparse decode step over an int8 pool, captured as a CUDA
    graph (the capture's first warm-up runs under the host-sync check) and
    replayed: logits and the pool bitwise equal to the eager step (a decode
    append at a fixed position rewrites the same codes and scales)."""
    from unionml_tpu_torch import _graphs
    from unionml_tpu_torch.models.gpt import init_block_pool, init_block_tables

    # head_dim 64: K4's bodies take it
    config = GPTConfig.tiny(hidden_size=128, num_heads=2, moe_every=1, num_experts=4, dtype=dtype, dropout=0.0)
    model = init_gpt(config, std=0.3, device=cuda)
    pool = init_block_pool(config, 32, 4, kv_quantize="int8", device=cuda)
    tables = init_block_tables(4, 32, 4, scratch_id=31, device=cuda)
    tables[:, :7] = torch.arange(28, dtype=torch.int32, device=cuda).reshape(4, 7)
    with torch.no_grad():
        for pos in range(6):  # fill the rows' first positions
            model(torch.full((4, 1), pos + 1, device=cuda), cache={"table": tables, **pool},
                  position=torch.full((4,), pos, dtype=torch.int32, device=cuda))

    def step(tokens, position):
        with torch.no_grad():
            return model(tokens[:, None], cache={"table": tables, **pool}, position=position)[0]

    tokens = torch.tensor([7, 11, 13, 17], device=cuda)
    position = torch.tensor([6, 6, 6, 6], dtype=torch.int32, device=cuda)
    eager = step(tokens, position)
    pool_after = {k: {n: t.clone() for n, t in v.items()} for k, v in pool.items()}
    graph = _graphs.capture(step, (tokens, position), {})
    replayed = graph(((tokens, position), {}))
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    for name, layer in pool.items():
        for leaf, value in layer.items():
            assert torch.equal(value, pool_after[name][leaf]), (name, leaf)
