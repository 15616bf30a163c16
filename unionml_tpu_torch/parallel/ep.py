"""Mixture-of-experts dispatch on one device: top-k routing, capacity buffers, dropless.

Port of the single-device half of ``unionml_tpu/parallel/ep.py``:
:func:`moe_apply_topk` (``ep.py:134-217``), :func:`moe_apply_capacity`
(``:95-131``, its k=1 case) and the choice-major slot assignment of
``_topk_dispatch_combine`` (``:220-241``), with JAX's semantics:

- top-k ties break toward the lower expert index, as ``lax.top_k`` does
  (k rounds of ``argmax``, which returns the first maximum, with the chosen
  expert masked between rounds: ``torch.topk`` promises no order of ties);
- ``normalize_gates`` renormalises the top-k gates over their sum (clamped
  at 1e-9), in the gates' dtype;
- ``capacity = max(ceil(T * k / E * capacity_factor), 1)`` in float64, the
  same order of operations as ``ep.py:199``;
- buffer positions are assigned choice-major with an integer cumsum: every
  token's first choice takes a slot before any token's second choice, so an
  overflowing expert drops the lower-priority choices first; a choice at or
  past ``capacity`` is dropped and contributes zero;
- ``capacity_factor=None`` is dropless: every expert runs every token and
  the top-k gates select the outputs (the inference mode).

The dispatch goes by index, not by the one-hot einsums of the JAX package:
each kept choice's token is gathered into its slot of an ``(E, C, d)``
buffer, the experts run as one batched product, and each token sums its
kept choices' outputs weighted by their gates (two products per token, in
float32, rounded once to the tokens' dtype, as an einsum with a float32
accumulator rounds). At GPT-2-small width and 8192 tokens the one-hot form's
``(T, E, C)`` dispatch and combine tensors alone would take 335 MB per layer
and their einsums more products than the experts. That formulation stays as
the plain version (:func:`reference_moe_apply_topk`), which the tests and
``chip_smoke.py`` hold the index dispatch against.

Every step is a device op with no host read, so a dropless layer records
into a CUDA graph (the decode burst). ``expert_fn(stacked_params, x)`` is
batched over the leading expert axis: ``x`` is ``(E, n, d)`` and each of
the ``stacked_params`` tensors has ``E`` rows (the counterpart of JAX's vmapped
per-expert function). Meshes, expert sharding and the all-to-all dispatch
raise ``NotImplementedError`` naming M12.
"""

import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = [
    "Routing",
    "expert_sharding",
    "moe_apply",
    "moe_apply_a2a",
    "moe_apply_capacity",
    "moe_apply_topk",
    "reference_moe_apply_topk",
    "reference_topk_dispatch_combine",
    "topk_route",
]

def _no_mesh(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name}: expert-parallel dispatch over a mesh is not ported yet (ROADMAP: M12)")


def moe_apply(*args: Any, **kwargs: Any):
    """Dense-masked top-1 experts sharded over a mesh (``ep.py:54-85``): M12."""
    raise _no_mesh("moe_apply")


def moe_apply_a2a(*args: Any, **kwargs: Any):
    """The all-to-all token dispatch over an ``"expert"`` axis (``ep.py:310``): M12."""
    raise _no_mesh("moe_apply_a2a")


def expert_sharding(*args: Any, **kwargs: Any):
    """Sharding of stacked expert parameters (``ep.py:88-90``): M12."""
    raise _no_mesh("expert_sharding")


class Routing(NamedTuple):
    """One call's top-k routing: ``gates`` and ``index`` ``(T, k)`` (the
    selected, optionally renormalised gates and their experts), ``position``
    ``(T, k)`` each choice's slot in its expert's buffer (choice-major),
    ``capacity`` (None when dropless) and ``keep`` ``(T, k)`` bool."""

    gates: torch.Tensor
    index: torch.Tensor
    position: torch.Tensor
    capacity: Optional[int]
    keep: torch.Tensor


def _stable_topk(gates: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: k rounds of ``argmax`` (the first
    maximum), each masking the expert it chose. Differentiable in the
    values (they are gathered from ``gates``)."""
    experts = torch.arange(gates.shape[-1], device=gates.device)
    masked = gates
    index = []
    for j in range(k):
        choice = torch.argmax(masked, dim=-1)
        index.append(choice)
        if j + 1 < k:
            masked = torch.where(experts[None, :] == choice[:, None], torch.full_like(masked, -math.inf), masked)
    top_index = torch.stack(index, dim=1)
    return torch.gather(gates, 1, top_index), top_index


def _capacity(num_tokens: int, k: int, num_experts: int, capacity_factor: float) -> int:
    # float64 in ep.py:199's order: T * k / E * cf
    return max(int(math.ceil(num_tokens * k / num_experts * capacity_factor)), 1)


def _check(gates: torch.Tensor, stacked_params: Any, k: int, mesh: Any) -> None:
    if mesh is not None:
        raise _no_mesh("moe_apply_topk(mesh=...)")
    num_experts = gates.shape[1]
    if stacked_params[0].shape[0] != num_experts:
        raise ValueError(f"gates are over {num_experts} experts but stacked_params carries "
                         f"{stacked_params[0].shape[0]}")
    if not 1 <= k <= num_experts:
        raise ValueError(f"k ({k}) must be in [1, num_experts={num_experts}]")


def topk_route(gates: torch.Tensor, k: int = 2, capacity_factor: Optional[float] = 1.25,
               normalize_gates: bool = True) -> Routing:
    """Top-k selection and choice-major slot assignment of ``gates``
    ``(T, E)`` (see the module docstring). Every choice is kept when
    ``capacity_factor`` is None."""
    num_tokens, num_experts = gates.shape
    top_gates, top_index = _stable_topk(gates, k)
    if normalize_gates:
        top_gates = top_gates / torch.clamp(top_gates.sum(dim=-1, keepdim=True), min=1e-9)
    # choice-major: column j * T + t is token t's j-th choice; a choice's slot
    # is the number of earlier columns routed to its expert (an integer
    # cumsum, along the inner axis: a scan down 8 long columns is far slower)
    flat = top_index.t().reshape(-1)
    hits = (torch.arange(num_experts, device=gates.device)[:, None] == flat[None, :]).to(torch.int32)
    earlier = torch.cumsum(hits, dim=1, dtype=torch.int32) - hits
    position = torch.gather(earlier, 0, flat[None, :])[0].reshape(k, num_tokens).t()
    if capacity_factor is None:
        return Routing(top_gates, top_index, position, None, torch.ones_like(position, dtype=torch.bool))
    capacity = _capacity(num_tokens, k, num_experts, capacity_factor)
    return Routing(top_gates, top_index, position, capacity, position < capacity)


def _combine(top_gates: torch.Tensor, picked: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # (T, k) gates times (T, k, d) outputs, summed over k in float32 and
    # rounded once, as an einsum with a float32 accumulator does
    return (top_gates.float()[:, :, None] * picked.float()).sum(dim=1).to(dtype)


def moe_apply_topk(
    expert_fn: Callable,
    stacked_params: Any,
    tokens: torch.Tensor,
    gates: torch.Tensor,
    mesh: Any = None,
    *,
    k: int = 2,
    capacity_factor: Optional[float] = 1.25,
    normalize_gates: bool = True,
) -> torch.Tensor:
    """GShard top-k mixture of experts over ``tokens`` ``(T, d)`` routed by
    ``gates`` ``(T, E)`` (router probabilities, in the tokens' dtype);
    returns ``(T, d_out)`` in the tokens' dtype. Capacity-bounded by
    ``capacity_factor``, or dropless when it is None; ``mesh`` is M12."""
    _check(gates, stacked_params, k, mesh)
    num_tokens, num_experts = gates.shape
    routing = topk_route(gates, k, capacity_factor, normalize_gates)
    rows = torch.arange(num_tokens, device=tokens.device)
    # every gather is an index_select: its backward is an index_add (atomic
    # adds; a token sums at most k rows, 2 values add alike in any order),
    # not advanced indexing's sorting backward, which serializes the many
    # duplicates of the zero row
    if capacity_factor is None:
        # dropless: every expert computes every token (E x the routed work),
        # the top-k gates pick each token's outputs
        all_out = expert_fn(stacked_params, tokens.expand(num_experts, *tokens.shape))  # (E, T, d_out)
        picked = all_out.reshape(num_experts * num_tokens, -1).index_select(
            0, (routing.index * num_tokens + rows[:, None]).reshape(-1))
        return _combine(routing.gates, picked.reshape(num_tokens, k, -1), tokens.dtype)

    capacity = routing.capacity
    dump = num_experts * capacity  # dropped choices point at a zero row past the buffer
    slot = torch.where(routing.keep, routing.index * capacity + routing.position,
                       torch.full_like(routing.position, dump))
    # the token of every buffer slot (T = the zero row: an unfilled slot)
    slot_token = torch.full((dump + 1,), num_tokens, dtype=torch.long, device=tokens.device)
    slot_token.scatter_(0, slot.reshape(-1).long(), rows[:, None].expand(num_tokens, k).reshape(-1))
    padded = torch.cat([tokens, tokens.new_zeros(1, tokens.shape[1])])
    expert_in = padded.index_select(0, slot_token[:dump]).reshape(num_experts, capacity, tokens.shape[1])
    expert_out = expert_fn(stacked_params, expert_in)  # (E, C, d_out)
    flat_out = torch.cat([expert_out.reshape(dump, -1), expert_out.new_zeros(1, expert_out.shape[-1])])
    picked = flat_out.index_select(0, slot.reshape(-1).long()).reshape(num_tokens, k, -1)
    return _combine(routing.gates, picked, tokens.dtype)


def moe_apply_capacity(
    expert_fn: Callable,
    stacked_params: Any,
    tokens: torch.Tensor,
    gates: torch.Tensor,
    mesh: Any = None,
    *,
    capacity_factor: float = 1.25,
) -> torch.Tensor:
    """Top-1 capacity dispatch: :func:`moe_apply_topk` with ``k=1`` and the
    top gate unnormalised (its value scales the expert's output, the
    router's only gradient path through the task loss)."""
    return moe_apply_topk(expert_fn, stacked_params, tokens, gates, mesh, k=1,
                          capacity_factor=capacity_factor, normalize_gates=False)


# ------------------------------------------------------------- plain version


def reference_topk_dispatch_combine(top_index: torch.Tensor, top_gates: torch.Tensor, num_experts: int,
                                    capacity: int, dtype: torch.dtype):
    """``_topk_dispatch_combine`` (``ep.py:220-241``) as written: ``(T, k)``
    routing to the ``(T, E, C)`` one-hot dispatch and combine tensors, slots
    from an int32 cumsum over the choice-major one-hots; the position
    one-hot of a slot at or past ``capacity`` is all zero (the drop)."""
    num_tokens, k = top_index.shape
    one_hot_i = F.one_hot(top_index.long(), num_experts).to(torch.int32)  # (t, k, e)
    choice_major = one_hot_i.transpose(0, 1).reshape(k * num_tokens, num_experts)
    positions = ((torch.cumsum(choice_major, dim=0, dtype=torch.int32) - choice_major) * choice_major).sum(dim=-1)
    position = positions.reshape(k, num_tokens).t()  # (t, k)
    one_hot = one_hot_i.to(dtype)
    # one_hot of an out-of-range slot is zero: pad one class and cut it off
    position_one_hot = F.one_hot(torch.clamp(position.long(), max=capacity), capacity + 1)[..., :capacity].to(dtype)
    dispatch = torch.einsum("tke,tkc->tec", one_hot, position_one_hot)
    combine = torch.einsum("tke,tkc,tk->tec", one_hot, position_one_hot, top_gates.to(dtype))
    return dispatch, combine


def reference_moe_apply_topk(
    expert_fn: Callable,
    stacked_params: Any,
    tokens: torch.Tensor,
    gates: torch.Tensor,
    *,
    k: int = 2,
    capacity_factor: Optional[float] = 1.25,
    normalize_gates: bool = True,
) -> torch.Tensor:
    """The plain version of :func:`moe_apply_topk`: JAX's one-hot einsum
    formulation, top-k by a stable descending sort (ties to the lower
    index)."""
    _check(gates, stacked_params, k, None)
    num_tokens, num_experts = gates.shape
    order = torch.sort(gates, dim=-1, descending=True, stable=True).indices[:, :k]
    top_gates = torch.gather(gates, 1, order)
    if normalize_gates:
        top_gates = top_gates / torch.clamp(top_gates.sum(dim=-1, keepdim=True), min=1e-9)
    dtype = tokens.dtype
    if capacity_factor is None:
        all_out = expert_fn(stacked_params, tokens.expand(num_experts, *tokens.shape))
        one_hot_k = F.one_hot(order, num_experts).to(dtype)
        weights = torch.einsum("tke,tk->te", one_hot_k, top_gates.to(dtype))
        return torch.einsum("te,etd->td", weights, all_out.to(dtype)).to(dtype)
    capacity = _capacity(num_tokens, k, num_experts, capacity_factor)
    dispatch, combine = reference_topk_dispatch_combine(order, top_gates, num_experts, capacity, dtype)
    expert_inputs = torch.einsum("tec,td->ecd", dispatch, tokens)
    expert_outputs = expert_fn(stacked_params, expert_inputs)
    return torch.einsum("tec,ecd->td", combine, expert_outputs.to(dtype)).to(dtype)
