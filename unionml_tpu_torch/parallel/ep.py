"""Mixture-of-experts dispatch: top-k routing, capacity buffers, dropless,
and expert parallelism over a mesh's ``"expert"`` axis.

Port of ``unionml_tpu/parallel/ep.py``: :func:`moe_apply_topk`
(``ep.py:134-217``), :func:`moe_apply_capacity` (``:95-131``, its k=1
case), the choice-major slot assignment of ``_topk_dispatch_combine``
(``:220-241``), the dense-masked oracle :func:`moe_apply` (``:52``),
:func:`expert_sharding` (``:90``) and the all-to-all dispatch
:func:`moe_apply_a2a` (``:300``, its body ``_moe_a2a_local`` ``:243``),
with JAX's semantics:

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
per-expert function).

Over a mesh (SPMD over ``torch.distributed``; every rank calls with its own
tokens, and rank ``e`` of the ``expert`` axis holds experts ``[e * E / ep,
(e + 1) * E / ep)``, :func:`expert_sharding`). The meshed functions take
either the whole stack of ``E`` experts (each rank uses its slice) or the
rank's slice:

- :func:`moe_apply`: the tokens are the same on every rank; each rank runs
  its experts over all of them, masks by the assignment and the outputs
  are summed over ``expert``;
- :func:`moe_apply_topk` with a ``mesh``: the tokens are the rank's share
  of the batch (split over the batch's ranks, data×fsdp, as
  ``batch_sharding`` lays rows; the same on every rank of ``expert``).
  Routing is GLOBAL, as JAX's one program routes the whole batch: each rank
  takes its tokens' top-k, an all-gather over the batch's ranks of one
  ``(k, E)`` int32 table per rank (how many of its choices j went to each
  expert) gives every rank the capacity of the global token count and the
  slot offsets of the tokens before its own, so a choice is kept exactly
  when JAX's global choice-major cumsum keeps it. A rank computes only its
  tokens on its experts; the partial outputs are summed over ``expert`` in
  float32. A sparse block trained on a mesh routes over the batch's
  ranks the layout binds to it (``MoEMlp.token_group``) the same way;
  under sequence parallelism those ranks are data×fsdp×sequence, each
  holding one chunk of its rows, and the all-gathered table holds one
  ``(k, E)`` entry per row chunk, so the slots follow JAX's flattened
  ``(B, S)`` order (:func:`_global_slots`). Beside a ``tensor`` axis a
  sparse block's rank holds its share of every expert's hidden width and
  the partials are summed over expert×tensor (``MoEMlp.partial``);
- :func:`moe_apply_a2a`: the tokens are the rank's share of the batch (the
  same on every rank of ``expert``). Its data shard's tokens (gathered over
  fsdp and sequence where the mesh has them, in JAX's flattened order) are
  cut into ``ep`` blocks: rank ``e`` takes block ``e`` (JAX's block of
  ``P((data, expert))``), routes it with the capacity of one source shard,
  sends each expert's buffer to the rank that holds it by one all-to-all,
  runs its experts on every source's buffers as one batched product, and a
  second all-to-all brings the outputs home for the combine; the blocks'
  outputs are then gathered over ``expert`` and each rank keeps its own.

Under a graph each collective is a differentiable operator
(:class:`~unionml_tpu_torch.models._layers.AxisGroup`): the gradient of
every leaf outside the experts comes out the same on every rank of
``expert``, and an expert leaf's gradient on its own rank is its whole
gradient over the rank's rows. Over one rank each collective is the
identity and runs no operation, so a mesh whose axes span one rank
computes bit for bit what the unmeshed call does.
"""

import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from unionml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    SEQUENCE_AXIS,
    NamedSharding,
    Spec,
    axes_order,
    axis_names,
    axis_size,
    batch_axis_size,
    batch_group,
    batch_index,
    batch_order,
)

__all__ = [
    "EXPERT_AXIS",
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


def _axis_group(mesh: Any, axis: str):
    from unionml_tpu_torch.models._layers import AxisGroup

    return AxisGroup.of(mesh, axis)


def _product_group(mesh: Any, axes: Sequence[str]):
    from unionml_tpu_torch.models._layers import AxisGroup

    return AxisGroup.over(mesh, tuple(axes))


def batch_ranks(mesh: Any, sequence: bool = False):
    """The batch's ranks of ``mesh`` (data×fsdp, rows split as
    ``batch_sharding`` lays them; with ``sequence``, times the ``sequence``
    axis, each rank holding one chunk of its rows) as a ``TokenGroup``;
    None over one rank."""
    from unionml_tpu_torch.models._layers import TokenGroup

    size = batch_axis_size(mesh, sequence=sequence)
    if size == 1:
        return None
    return TokenGroup(batch_group(mesh, sequence=sequence), size, batch_index(mesh, sequence=sequence),
                      chunks=axis_size(mesh, SEQUENCE_AXIS) if sequence else 1,
                      order=batch_order(mesh, sequence=sequence))


def _leaves(stacked_params: Any) -> List[torch.Tensor]:
    if torch.is_tensor(stacked_params):
        return [stacked_params]
    if isinstance(stacked_params, dict):
        return [v for leaf in stacked_params.values() for v in _leaves(leaf)]
    return [v for leaf in stacked_params for v in _leaves(leaf)]


def _map(fn: Callable, stacked_params: Any) -> Any:
    if torch.is_tensor(stacked_params):
        return fn(stacked_params)
    if isinstance(stacked_params, dict):
        return {k: _map(fn, v) for k, v in stacked_params.items()}
    return type(stacked_params)(_map(fn, v) for v in stacked_params)


def _local_params(stacked_params: Any, experts: Any, num_experts: int) -> Any:
    """The rank's experts of ``stacked_params``: its slice of a whole stack,
    or the stack itself when it is the rank's slice already."""
    if experts.size == 1 or _leaves(stacked_params)[0].shape[0] != num_experts:
        return stacked_params
    local = num_experts // experts.size
    return _map(lambda p: p[experts.index * local:(experts.index + 1) * local], stacked_params)


def _check_experts(held: int, num_experts: int, ep: int, axis: str) -> None:
    """JAX's validations (``ep.py:176-186``): the stack is the ``E`` experts
    the gates are over (or, on a mesh, this rank's ``E / ep`` of them)."""
    if held != num_experts and held * ep != num_experts:
        raise ValueError(f"gates are over {num_experts} experts but stacked_params carries {held}")
    if num_experts % ep:
        raise ValueError(f"num_experts ({num_experts}) must be divisible by the {axis!r} axis size ({ep})")


def expert_sharding(mesh: Any, axis: str = EXPERT_AXIS) -> NamedSharding:
    """Sharding of stacked per-expert parameters (``ep.py:88-90``): the
    leading expert dimension over ``axis``, so rank ``e`` holds experts
    ``[e * E / ep, (e + 1) * E / ep)``."""
    return NamedSharding(mesh, Spec(axis))


def moe_apply(
    expert_fn: Callable,
    stacked_params: Any,
    tokens: torch.Tensor,
    assignment: torch.Tensor,
    mesh: Any,
    *,
    axis: str = EXPERT_AXIS,
) -> torch.Tensor:
    """Top-1-routed experts sharded over ``axis`` (``ep.py:54-85``), the
    dense-masked oracle: every rank holds the same ``tokens`` ``(T, d)`` and
    ``assignment`` ``(T,)`` (an expert per token) and the whole stack of
    ``E`` experts; it runs its own experts over every token, keeps each
    token's assigned expert's output, and the outputs are summed over
    ``axis`` (its backward the identity; the tokens' gradient is summed
    over the axis)."""
    num_devices = axis_size(mesh, axis)
    num_experts = _leaves(stacked_params)[0].shape[0]
    if num_experts % num_devices:
        raise ValueError(
            f"num_experts ({num_experts}) must be divisible by the {axis!r} axis size ({num_devices})")
    experts = _axis_group(mesh, axis)
    local = num_experts // num_devices
    first = experts.index * local
    params = _local_params(stacked_params, experts, num_experts)
    x = experts.enter(tokens)
    out = expert_fn(params, x.expand(local, *x.shape))  # (local, T, d_out)
    mask = assignment.long()[None, :] == torch.arange(first, first + local, device=tokens.device)[:, None]
    out = (out * mask[..., None].to(out.dtype)).sum(dim=0).to(tokens.dtype)
    return experts.reduce(out)


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


def _check(gates: torch.Tensor, stacked_params: Any, k: int, ep: int = 1, axis: str = EXPERT_AXIS) -> None:
    num_experts = gates.shape[1]
    _check_experts(_leaves(stacked_params)[0].shape[0], num_experts, ep, axis)
    if not 1 <= k <= num_experts:
        raise ValueError(f"k ({k}) must be in [1, num_experts={num_experts}]")


def topk_route(gates: torch.Tensor, k: int = 2, capacity_factor: Optional[float] = 1.25,
               normalize_gates: bool = True, group: Any = None, rows: int = 1) -> Routing:
    """Top-k selection and choice-major slot assignment of ``gates``
    ``(T, E)`` (see the module docstring). Every choice is kept when
    ``capacity_factor`` is None.

    ``group`` (an ``AxisGroup`` over the ranks the batch's tokens are split
    over, this rank's tokens being block ``group.index`` of them) routes
    globally: the capacity is the global token count's and a choice is kept
    where its global slot is below it. ``position`` stays the slot among
    this rank's own choices (where its buffer holds the choice). A
    ``TokenGroup`` whose ranks hold chunks of their rows (``chunks`` > 1)
    routes this rank's ``rows`` rows, each a chunk of ``T / rows`` tokens,
    in JAX's global order (:func:`_global_slots`)."""
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
    if group is None or group.size == 1:
        capacity = _capacity(num_tokens, k, num_experts, capacity_factor)
        return Routing(top_gates, top_index, position, capacity, position < capacity)
    capacity = _capacity(num_tokens * group.size, k, num_experts, capacity_factor)
    return Routing(top_gates, top_index, position, capacity,
                   _global_slots(position, hits, top_index, group, rows) < capacity)


def _global_slots(position: torch.Tensor, hits: torch.Tensor, top_index: torch.Tensor, group: Any,
                  rows: int) -> torch.Tensor:
    """The global choice-major slot ``(T, k)`` of each of this rank's
    choices, JAX's one program routing the flattened ``(B, S)`` batch. A
    rank's tokens are one run of that order when it holds whole rows, and
    ``rows`` runs (one chunk of each of its rows) when ``group`` is a
    ``TokenGroup`` with ``chunks`` > 1. Every rank's ``(runs, k, E)`` table of
    its runs' choices is all-gathered (int32); a choice j of a token sits
    after every choice j' < j, then after the choices j of the runs before
    its own, then after its own run's earlier tokens'. ``position`` (this
    rank's own choice-major slots) already counts its choices j' < j and its
    earlier runs' choices j, which the offset takes back. ``hits`` ``(E, k *
    T)`` is the choice-major one-hot of ``top_index``. The gathered tables
    are put in batch-index order first (``TokenGroup.order``)."""
    num_tokens, k = top_index.shape
    num_experts, chunks = hits.shape[0], getattr(group, "chunks", 1)
    runs = rows if chunks > 1 else 1
    counts = hits.reshape(num_experts, k, runs, num_tokens // runs).sum(dim=3, dtype=torch.int32)
    counts = counts.permute(2, 1, 0).contiguous()  # (runs, k, E)
    table = group.gather(counts)  # (size * runs, k, E), in the group's rank order
    order = getattr(group, "order", None)
    if order is not None:  # the group numbers its ranks otherwise than their batch index
        table = table.reshape(group.size, runs, k, num_experts)[list(order)]
    # JAX's order: the global batch's rows in turn, each row's chunks in sequence order
    table = table.reshape(group.size // chunks, chunks, runs, k, num_experts).transpose(1, 2)
    table = table.reshape(-1, k, num_experts)
    total = table.sum(dim=0, dtype=torch.int32)
    before = (torch.cumsum(total, dim=0, dtype=torch.int32) - total)[None] + (
        torch.cumsum(table, dim=0, dtype=torch.int32) - table)
    block, chunk = divmod(group.index, chunks)
    mine = (block * runs + torch.arange(runs, device=hits.device)) * chunks + chunk
    own_total = counts.sum(dim=0, dtype=torch.int32)
    own = (torch.cumsum(own_total, dim=0, dtype=torch.int32) - own_total)[None] + (
        torch.cumsum(counts, dim=0, dtype=torch.int32) - counts)
    offset = (before[mine] - own).transpose(0, 1)  # (k, runs, E)
    chosen = top_index.t().reshape(k, runs, num_tokens // runs)
    return position + torch.gather(offset, 2, chosen).reshape(k, num_tokens).t()


def _combine(top_gates: torch.Tensor, picked: torch.Tensor, dtype: torch.dtype, partial: Any = None) -> torch.Tensor:
    # (T, k) gates times (T, k, d) outputs, summed over k in float32 and
    # rounded once, as an einsum with a float32 accumulator does; a partial
    # sum (each rank's experts or hidden shard) is summed over its ranks in
    # float32 before the rounding
    out = (top_gates.float()[:, :, None] * picked.float()).sum(dim=1)
    if partial is not None:
        out = partial.reduce(out)
    return out.to(dtype)


def _dispatch(tokens: torch.Tensor, routing: Routing, first: int, local: int, num_experts: int):
    """``(expert inputs (local, C, d), slot (T, k))``: each kept choice of an
    expert in ``[first, first + local)`` gathered into its buffer slot;
    ``slot`` indexes the flattened buffer, and a dropped choice (or one on
    another rank's expert) points at a zero row past it. ``C`` is the
    capacity, or ``T`` where that is smaller."""
    num_tokens, k = routing.index.shape
    # a token's k choices are distinct experts, so no expert keeps more than
    # T of this rank's choices: slots past T stay empty whatever the capacity
    capacity = min(routing.capacity, num_tokens)
    dump = local * capacity
    mine = routing.keep
    index = routing.index
    if local != num_experts:
        mine = mine & (index >= first) & (index < first + local)
        index = index - first
    slot = torch.where(mine, index * capacity + routing.position, torch.full_like(routing.position, dump))
    # the token of every buffer slot (T = the zero row: an unfilled slot)
    rows = torch.arange(num_tokens, device=tokens.device)
    slot_token = torch.full((dump + 1,), num_tokens, dtype=torch.long, device=tokens.device)
    slot_token.scatter_(0, slot.reshape(-1).long(), rows[:, None].expand(num_tokens, k).reshape(-1))
    # every gather is an index_select: its backward is an index_add (atomic
    # adds; a token sums at most k rows, 2 values add alike in any order),
    # not advanced indexing's sorting backward, which serializes the many
    # duplicates of the zero row
    padded = torch.cat([tokens, tokens.new_zeros(1, tokens.shape[1])])
    return padded.index_select(0, slot_token[:dump]).reshape(local, capacity, tokens.shape[1]), slot


def _combine_slots(expert_out: torch.Tensor, slot: torch.Tensor, routing: Routing, dtype: torch.dtype,
                   partial: Any = None) -> torch.Tensor:
    num_tokens, k = slot.shape
    flat_out = expert_out.reshape(-1, expert_out.shape[-1])
    flat_out = torch.cat([flat_out, flat_out.new_zeros(1, flat_out.shape[-1])])
    picked = flat_out.index_select(0, slot.reshape(-1).long()).reshape(num_tokens, k, -1)
    return _combine(routing.gates, picked, dtype, partial)


def _apply_topk(expert_fn: Callable, params: Any, tokens: torch.Tensor, gates: torch.Tensor, *, k: int,
                capacity_factor: Optional[float], normalize_gates: bool, num_experts: int, first: int = 0,
                local: Optional[int] = None, partial: Any = None, group: Any = None, rows: int = 1) -> torch.Tensor:
    """The top-k layer over this rank's experts ``[first, first + local)``
    (``params``). ``partial`` is the ``AxisGroup`` whose ranks each compute
    a part of every output (the expert axis, or a tensor axis splitting the
    experts' hidden width): the tokens and gates enter it and the combined
    outputs are summed over it. ``group`` routes globally over ``rows``
    rows of this rank's tokens (:func:`topk_route`)."""
    local = num_experts if local is None else local
    num_tokens = tokens.shape[0]
    if partial is not None and partial.size > 1:
        tokens, gates = partial.enter(tokens), partial.enter(gates)
    else:
        partial = None
    routing = topk_route(gates, k, capacity_factor, normalize_gates, group, rows)
    if capacity_factor is None:
        # dropless: every expert computes every token (E x the routed work),
        # the top-k gates pick each token's outputs
        all_out = expert_fn(params, tokens.expand(local, *tokens.shape))  # (local, T, d_out)
        rows = torch.arange(num_tokens, device=tokens.device)
        flat = all_out.reshape(local * num_tokens, -1)
        if local == num_experts:
            picked = flat.index_select(0, (routing.index * num_tokens + rows[:, None]).reshape(-1))
        else:  # another rank's expert's output is a zero row past this rank's
            mine = (routing.index >= first) & (routing.index < first + local)
            index = torch.where(mine, (routing.index - first) * num_tokens + rows[:, None],
                                torch.full_like(routing.index, local * num_tokens))
            flat = torch.cat([flat, flat.new_zeros(1, flat.shape[-1])])
            picked = flat.index_select(0, index.reshape(-1))
        return _combine(routing.gates, picked.reshape(num_tokens, k, -1), tokens.dtype, partial)
    expert_in, slot = _dispatch(tokens, routing, first, local, num_experts)
    return _combine_slots(expert_fn(params, expert_in), slot, routing, tokens.dtype, partial)


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
    axis: str = EXPERT_AXIS,
) -> torch.Tensor:
    """GShard top-k mixture of experts over ``tokens`` ``(T, d)`` routed by
    ``gates`` ``(T, E)`` (router probabilities, in the tokens' dtype);
    returns ``(T, d_out)`` in the tokens' dtype. Capacity-bounded by
    ``capacity_factor``, or dropless when it is None.

    With a ``mesh`` (see the module docstring) ``tokens`` are this rank's
    share of the batch (the same on every rank of the axes beside
    data×fsdp), routed globally over the batch's ranks; this rank computes
    them on its experts of ``axis`` and the outputs are summed over
    ``axis``. ``MoEMlp`` runs the same layer over a rank's sequence chunks
    and its hidden shares of a tensor axis (``_apply_topk``'s ``group`` and
    ``partial``)."""
    ep = axis_size(mesh, axis) if mesh is not None else 1
    _check(gates, stacked_params, k, ep, axis)
    num_experts = gates.shape[1]
    if mesh is None:
        return _apply_topk(expert_fn, stacked_params, tokens, gates, k=k, capacity_factor=capacity_factor,
                           normalize_gates=normalize_gates, num_experts=num_experts)
    experts = _axis_group(mesh, axis)
    local = num_experts // ep
    return _apply_topk(expert_fn, _local_params(stacked_params, experts, num_experts), tokens, gates, k=k,
                       capacity_factor=capacity_factor, normalize_gates=normalize_gates, num_experts=num_experts,
                       first=experts.index * local, local=local, partial=experts,
                       group=None if capacity_factor is None else batch_ranks(mesh))


def moe_apply_capacity(
    expert_fn: Callable,
    stacked_params: Any,
    tokens: torch.Tensor,
    gates: torch.Tensor,
    mesh: Any = None,
    *,
    capacity_factor: float = 1.25,
    axis: str = EXPERT_AXIS,
) -> torch.Tensor:
    """Top-1 capacity dispatch: :func:`moe_apply_topk` with ``k=1`` and the
    top gate unnormalised (its value scales the expert's output, the
    router's only gradient path through the task loss)."""
    return moe_apply_topk(expert_fn, stacked_params, tokens, gates, mesh, k=1,
                          capacity_factor=capacity_factor, normalize_gates=False, axis=axis)


def moe_apply_a2a(
    expert_fn: Callable,
    stacked_params: Any,
    tokens: torch.Tensor,
    gates: torch.Tensor,
    mesh: Any,
    *,
    k: int = 2,
    capacity_factor: float = 1.25,
    normalize_gates: bool = True,
    axis: str = EXPERT_AXIS,
    data_axis: Optional[str] = DATA_AXIS,
    tensor_axis: Optional[str] = None,
    rows: int = 1,
) -> torch.Tensor:
    """Top-k experts with the all-to-all token dispatch (``ep.py:300-368``).

    ``tokens`` ``(T, d)`` and ``gates`` ``(T, E)`` are this rank's share of
    the batch (its rows over data×fsdp; under a ``sequence`` axis its chunk
    of ``rows`` rows), the same on every rank of ``axis`` and
    ``tensor_axis``. JAX's tokens are the global ``(B, S)`` batch flattened
    and sharded over ``(data_axis, axis)``, the same on every rank of the
    other axes: rank ``e`` of ``axis`` routes block ``e`` of its data
    shard's tokens, ``t_local = T_global / (data * ep)`` of them, into
    per-expert buffers of the capacity of one source shard,
    ``ceil(t_local * k / E * capacity_factor)`` slots for each expert on
    each source (a choice drops when its own shard's demand for its expert
    overflows). So the data shard's tokens are first gathered over the
    batch's other ranks (fsdp, sequence: :func:`_holders`) and put in that
    order. One all-to-all over ``axis`` carries each expert's buffers to the
    rank holding it, the rank's experts run on ``(E / ep, ep * C, d)`` as
    one batched product, a second all-to-all brings the outputs back, and
    each token combines its kept choices at home; the blocks' outputs are
    gathered over ``axis`` and each rank keeps its own tokens', ``(T,
    d_out)`` in the tokens' dtype. JAX's experts are whole on every rank of
    the other axes; ``tensor_axis`` names the axis whose ranks each hold a
    share of every expert's hidden width instead (``stacked_params`` are
    those shares): the combined partial outputs are summed over it in
    float32, the split sum of the same products."""
    num_tokens, num_experts = gates.shape
    held = _leaves(stacked_params)[0].shape[0]
    names = axis_names(mesh)
    if axis not in names:
        raise ValueError(f"moe_apply_a2a shards experts over the mesh axis {axis!r}, which the mesh "
                         f"(axes {names}) does not have")
    ep_degree = axis_size(mesh, axis)
    _check_experts(held, num_experts, ep_degree, axis)
    if not 1 <= k <= num_experts:
        raise ValueError(f"k ({k}) must be in [1, num_experts={num_experts}]")
    token_axes = (data_axis, axis) if data_axis and data_axis in names else (axis,)
    data = axis_size(mesh, data_axis) if len(token_axes) == 2 else 1
    shard_count = data * ep_degree
    global_tokens = num_tokens * batch_axis_size(mesh, sequence=True)
    if global_tokens % shard_count:
        raise ValueError(
            f"num_tokens ({global_tokens}) must be divisible by the token-shard count "
            f"({shard_count}: mesh axes {token_axes})"
        )
    experts = _axis_group(mesh, axis)
    params = _local_params(stacked_params, experts, num_experts)
    holders, into, back = _holders(mesh, token_axes, num_tokens, rows, tokens.device)
    if into is not None:
        # the data shard's tokens, in JAX's order. Each holder keeps only its
        # own tokens' outputs, and the layer is token-wise (a token's output
        # depends on its own input and gates; the slots on the others', but
        # not differentiably), so the gradient of a rank's tokens is its own
        # outputs' alone: the gather's backward, this rank's block, is whole
        tokens, gates = holders.gather(tokens).index_select(0, into), holders.gather(gates).index_select(0, into)
    tensor = None if tensor_axis is None else _axis_group(mesh, tensor_axis)
    if tensor is not None and tensor.size > 1:
        tokens, gates = tensor.enter(tokens), tensor.enter(gates)
    else:
        tensor = None
    # block e of t_local = T_global / (data * ep) tokens, at one source shard's capacity
    [out] = _a2a(expert_fn, [params], [experts.take(tokens)], [experts.take(gates)],
                 lambda parts: experts.exchange(parts[0])[None], ep_degree, k=k, capacity_factor=capacity_factor,
                 normalize_gates=normalize_gates, partial=tensor)
    out = experts.gather(out)
    return out if back is None else out.index_select(0, back)


def _holders(mesh: Any, token_axes: Sequence[str], num_tokens: int, rows: int, device: Any):
    """``(group, into, back)`` of :func:`moe_apply_a2a`: the batch's ranks
    (data×fsdp×sequence) off JAX's token axes, which hold the other tokens
    of this rank's token shard, as an ``AxisGroup``; ``into`` the index
    that puts their tokens, gathered in the group's rank order, in JAX's
    flattened ``(B, S)`` order (their row blocks in turn, each row's chunks
    in sequence order); ``back`` the places of this rank's own ``rows``
    rows (of ``num_tokens / rows`` tokens each) in that order. ``into`` and
    ``back`` are None over one rank."""
    axes = tuple(a for a in (DATA_AXIS, FSDP_AXIS, SEQUENCE_AXIS) if a not in token_axes)
    group = _product_group(mesh, axes)
    if group.size == 1:
        return group, None, None
    chunks = axis_size(mesh, SEQUENCE_AXIS) if SEQUENCE_AXIS in axes else 1
    order = axes_order(mesh, axes)
    # the group rank of each holder, by its index over the axes (row block, then chunk)
    position = torch.tensor(list(order) if order is not None else list(range(group.size)), device=device)
    length = num_tokens // rows
    block, row, chunk, at = torch.meshgrid(*(torch.arange(n, device=device) for n in (
        group.size // chunks, rows, chunks, length)), indexing="ij")
    into = (position[block * chunks + chunk] * num_tokens + row * length + at).reshape(-1)
    back = torch.argsort(into)[group.index * num_tokens:(group.index + 1) * num_tokens]
    return group, into, back


def _stack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return tensors[0][None] if len(tensors) == 1 else torch.stack(list(tensors))


def _a2a(expert_fn: Callable, params: Sequence[Any], tokens: Sequence[torch.Tensor], gates: Sequence[torch.Tensor],
         exchange: Callable[[torch.Tensor], torch.Tensor], ep_degree: int, *, k: int, capacity_factor: float,
         normalize_gates: bool, partial: Any = None) -> List[torch.Tensor]:
    """The body of :func:`moe_apply_a2a` over the token blocks of the
    holders at hand (one, this rank, in a world): block ``r`` (``tokens[r]``,
    ``gates[r]``) is routed at its own capacity into an ``(E, C, d)`` send
    buffer in global expert order, cut into ``ep_degree`` parts of ``E / ep``
    experts; ``exchange`` moves part j of holder i (the ``(holders, ep,
    ...)`` stack's ``[i, j]``) to holder j's place i; holder ``r``'s experts
    (``params[r]``) run on every source's buffers as one batched product,
    the same exchange brings the outputs back, and each block combines its
    kept choices (its partial outputs summed over ``partial``, an
    ``AxisGroup`` whose ranks each hold a share of every expert's hidden
    width, in float32). Returns each block's ``(T_r, d_out)``."""
    num_experts = gates[0].shape[1]
    local = num_experts // ep_degree
    routed = [topk_route(g, k, capacity_factor, normalize_gates) for g in gates]
    sent = [_dispatch(t, r, 0, num_experts, num_experts) for t, r in zip(tokens, routed)]
    recv = exchange(_stack([send.reshape(ep_degree, -1, send.shape[-1]) for send, _ in sent]))
    outs = [expert_fn(p, _source_major_to_experts(part, local)) for p, part in zip(params, recv)]
    returned = exchange(_stack([_experts_to_source_major(out, ep_degree) for out in outs]))
    return [_combine_slots(back, slot, routing, t.dtype, partial)
            for back, (_, slot), routing, t in zip(returned, sent, routed, tokens)]


def _source_major_to_experts(recv: torch.Tensor, local: int) -> torch.Tensor:
    """``(ep, E/ep * C, d)`` as the exchange delivers it (source j's buffers
    for this rank's experts at part j) to ``(E/ep, ep * C, d)``: each local
    expert's slots from every source, source by source (``ep.py:286-291``)."""
    ep_degree, _, d = recv.shape
    if ep_degree == 1:
        return recv.reshape(local, -1, d)
    return recv.reshape(ep_degree, local, -1, d).transpose(0, 1).reshape(local, -1, d)


def _experts_to_source_major(out: torch.Tensor, ep_degree: int) -> torch.Tensor:
    """The inverse layout for the return trip: ``(E/ep, ep * C, d)`` to
    ``(ep, E/ep * C, d)``, part j the outputs of source j's tokens."""
    local, _, d = out.shape
    if ep_degree == 1:
        return out.reshape(1, -1, d)
    return out.reshape(local, ep_degree, -1, d).transpose(0, 1).reshape(ep_degree, -1, d)


def _in_process_moe_a2a(expert_fn: Callable, stacked_params: Any, tokens: torch.Tensor, gates: torch.Tensor,
                        ep_degree: int, *, k: int = 2, capacity_factor: float = 1.25,
                        normalize_gates: bool = True) -> torch.Tensor:
    """:func:`moe_apply_a2a` over ``ep_degree`` ranks simulated in one
    process (the test seam, as ``ring.py``'s in-process ring): block j of
    ``tokens`` and rank j's slice of the whole ``stacked_params`` are rank
    j's, and the exchange is the transpose of the ranks' parts in memory.
    Returns the whole ``(T, d_out)``."""
    _check(gates, stacked_params, k, ep_degree)
    local = gates.shape[1] // ep_degree
    params = [_map(lambda p, r=r: p[r * local:(r + 1) * local], stacked_params) for r in range(ep_degree)]
    return torch.cat(_a2a(expert_fn, params, tokens.chunk(ep_degree), gates.chunk(ep_degree),
                          lambda parts: parts.transpose(0, 1), ep_degree, k=k, capacity_factor=capacity_factor,
                          normalize_gates=normalize_gates))


class _Share:
    """One simulated rank of :func:`_in_process_dropless` and
    :func:`_in_process_split`: the ``partial`` of ``_apply_topk`` or
    ``_a2a`` that keeps the rank's f32 partial outputs (one per call or
    block) for the sum over the ranks instead of reducing them."""

    def __init__(self, size: int) -> None:
        self.size, self.parts = size, []

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        self.parts.append(x)
        return x


def _in_process_dropless(expert_fn: Callable, stacked_params: Any, tokens: torch.Tensor, gates: torch.Tensor,
                         ep_degree: int, *, k: int = 2, normalize_gates: bool = True) -> torch.Tensor:
    """The dropless layer (``capacity_factor=None``) served over
    ``ep_degree`` expert ranks simulated in one process (the test seam of
    the serving path, as :func:`_in_process_moe_a2a` is of training's): rank
    r runs its slice of the whole ``stacked_params`` over every token, and
    the ranks' f32 partial outputs are summed, then rounded once, as the
    all-reduce over the ``expert`` axis does. Returns ``(T, d_out)`` in the
    tokens' dtype."""
    _check(gates, stacked_params, k, ep_degree)
    num_experts = gates.shape[1]
    local = num_experts // ep_degree
    total = None
    for r in range(ep_degree):
        share = _Share(ep_degree)
        _apply_topk(expert_fn, _map(lambda p, r=r: p[r * local:(r + 1) * local], stacked_params), tokens, gates,
                    k=k, capacity_factor=None, normalize_gates=normalize_gates, num_experts=num_experts,
                    first=r * local, local=local, partial=share)
        total = share.parts[0] if total is None else total + share.parts[0]
    return total.to(tokens.dtype)


def _in_process_split(expert_fn: Callable, stacked_params: Any, tokens: torch.Tensor, gates: torch.Tensor,
                      ep_degree: int, tensor_degree: int, *, k: int = 2, capacity_factor: Optional[float] = 1.25,
                      normalize_gates: bool = True, dispatch: str = "gshard") -> torch.Tensor:
    """A sparse block's experts split over ``ep_degree`` expert ranks times
    ``tensor_degree`` tensor ranks, simulated in one process (the seam of
    the composed meshes, beside :func:`_in_process_dropless`).
    ``stacked_params`` is the whole ``(w_in (E, d, h), w_out (E, h, d))``
    pair of ``models/moe.py``'s experts; piece (e, t) holds experts ``[e *
    E / ep, (e + 1) * E / ep)`` at hidden columns ``[t * h / tp, (t + 1) *
    h / tp)``, as ``param_shardings``' ``P(expert, fsdp, tensor)`` /
    ``P(expert, tensor, fsdp)`` cut them. ``dispatch="gshard"`` (or
    ``capacity_factor=None``, dropless): every piece routes all the tokens
    (the global routing) through its experts; ``"a2a"``: the tokens are
    ``ep_degree`` source blocks, each routed at its own capacity, exchanged
    as :func:`_in_process_moe_a2a` does, each tensor rank running its
    hidden share. The pieces' f32 partial outputs are summed, then rounded
    once, as the all-reduce over expert×tensor does. Differentiable.
    Returns ``(T, d_out)`` in the tokens' dtype."""
    w_in, w_out = stacked_params
    _check(gates, w_in, k, ep_degree)
    num_experts, hidden = w_in.shape[0], w_in.shape[2]
    local, width = num_experts // ep_degree, hidden // tensor_degree

    def piece(e: int, t: int):
        experts, columns = slice(e * local, (e + 1) * local), slice(t * width, (t + 1) * width)
        return w_in[experts, :, columns], w_out[experts, columns, :]

    total = None
    for t in range(tensor_degree):
        if dispatch == "a2a" and capacity_factor is not None:
            share = _Share(tensor_degree)
            outs = _a2a(expert_fn, [piece(e, t) for e in range(ep_degree)], tokens.chunk(ep_degree),
                        gates.chunk(ep_degree), lambda parts: parts.transpose(0, 1), ep_degree, k=k,
                        capacity_factor=capacity_factor, normalize_gates=normalize_gates,
                        partial=share if tensor_degree > 1 else None)
            parts = [torch.cat(share.parts or outs)]
        else:
            parts = []
            for e in range(ep_degree):
                share = _Share(ep_degree * tensor_degree)
                out = _apply_topk(expert_fn, piece(e, t), tokens, gates, k=k, capacity_factor=capacity_factor,
                                  normalize_gates=normalize_gates, num_experts=num_experts, first=e * local,
                                  local=local, partial=share)
                parts += share.parts or [out]  # one piece: the layer's own rounded output
        for part in parts:
            total = part if total is None else total + part
    return total.to(tokens.dtype)


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
    _check(gates, stacked_params, k)
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
