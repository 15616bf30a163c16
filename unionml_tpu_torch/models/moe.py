"""The mixture-of-experts MLP block: router, router losses, top-k experts.

Port of ``unionml_tpu/models/moe.py``:

- :func:`router_z_loss` and :func:`load_balancing_loss`, the router's two
  regularisers (the ST-MoE z-loss, the Switch/GShard balance loss);
- :class:`MoEMlp`, a drop-in for a transformer MLP: an f32 router
  (``nn.Linear(d, E)`` with a bias, fed f32 inputs), softmax gates cast to
  the compute dtype, and top-k dispatch through
  :func:`unionml_tpu_torch.parallel.ep.moe_apply_topk` (index-based,
  capacity-bounded in training, dropless when asked). Experts are two-layer
  tanh-GELU MLPs without biases whose weights ``w_in`` ``(E, d, h)`` and
  ``w_out`` ``(E, h, d)`` are parameters IN the compute dtype, as flax's
  ``self.param(..., self.dtype)`` makes them (the dense layers keep f32
  parameters; the AdamW moments follow each parameter's dtype);
- :func:`collect_aux_losses`, the weighted sum to add to the task loss.

Expert parallelism (``mesh=`` with an ``"expert"`` axis of ``ep`` ranks):
the layer holds only its rank's ``E / ep`` experts. ``dispatch="gshard"``
routes this rank's tokens globally and sums the experts' partial outputs
over the axis (:func:`~unionml_tpu_torch.parallel.ep.moe_apply_topk` with
the mesh); ``dispatch="a2a"`` moves only the routed tokens by two
all-to-alls (:func:`~unionml_tpu_torch.parallel.ep.moe_apply_a2a`,
``moe.py:132-156``); the dropless (inference) path is the dense one either
way, over the rank's experts. A capacity-bounded (training) forward routes
over the ranks its ``token_group`` names, the ranks the batch's tokens are
split over: the ``ep_mesh``'s, or those that ``shard_train_state`` binds
when it lays a model out on a mesh (a data mesh with no ``ep_mesh``
included; under sequence parallelism the data×fsdp×sequence ranks, each
holding a chunk of its rows, routed in JAX's flattened ``(B, S)`` order).
Capacity, slots and the router's balance loss (``f_e`` and
``P_e``, :func:`load_balancing_loss`) are then the global batch's, as JAX's
one program routes it; the group is the layer's own, so the recompute of a
``remat`` block routes as its forward did. Under tensor parallelism (``tp``, set by
``models/gpt.py::tensor_parallel``) each rank holds a slice of every
expert's hidden width: the products are column- then row-parallel, and the
partial outputs are summed over the tensor axis, or over expert×tensor when
the experts are split over an ``expert`` axis too (:attr:`MoEMlp.partial`;
the dropless path included). The a2a dispatch beside ``fsdp`` or
``sequence`` first gathers its data shard's tokens (JAX's a2a shards tokens
over data×expert only).

Flax sows the router losses into the ``intermediates`` collection. The port
returns them instead: ``MoEMlp.forward`` gives ``(out, aux)`` with ``aux`` a
dict of the two scalars, and ``GPTLMHeadModel(..., return_aux=True)`` hands
the list of every sparse block's dicts to the caller. No module state holds
them (decode runs inside CUDA graphs, fleet replicas on several threads).
"""

from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unionml_tpu_torch.parallel.ep import _apply_topk, batch_ranks, moe_apply_a2a
from unionml_tpu_torch.parallel.mesh import EXPERT_AXIS, TENSOR_AXIS, axis_names, axis_size

__all__ = ["MoEMlp", "collect_aux_losses", "load_balancing_loss", "router_z_loss"]

_DISPATCH = ("gshard", "a2a")


def router_z_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """Mean squared logsumexp of the router logits (keeps them small)."""
    return torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)


def load_balancing_loss(gates: torch.Tensor, expert_index: torch.Tensor, num_experts: int,
                        group: Any = None) -> torch.Tensor:
    """``E * sum_e f_e * P_e``: ``f_e`` the fraction of tokens whose top
    choice is ``e``, ``P_e`` the mean gate of ``e``; 1.0 at perfect balance.

    ``group`` (an ``AxisGroup`` over the ranks a batch's tokens are split
    over, each holding as many) takes both means over the global tokens, by
    sums over the group: every rank gets the global value, and the gradient
    of its own gates' share is summed over the ranks (a product of means is
    not linear in the shards, so a rank's own loss would not do)."""
    one_hot = (expert_index[:, None] == torch.arange(num_experts, device=gates.device)[None, :]).to(gates.dtype)
    if group is None:
        return num_experts * torch.sum(one_hot.mean(dim=0) * gates.mean(dim=0))
    count = gates.shape[0] * group.size
    fraction = group.reduce(one_hot.sum(dim=0)) / count
    return num_experts * torch.sum(fraction * (group.total(gates.sum(dim=0)) / count))


def _experts(params: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The experts as two batched products: ``gelu(x @ w_in) @ w_out`` per expert."""
    w_in, w_out = params
    return torch.bmm(F.gelu(torch.bmm(x, w_in), approximate="tanh"), w_out)


class MoEMlp(nn.Module):
    """Transformer MLP block with top-k expert routing (``moe.py:53-160``).

    Input and output ``(..., d_model)``; leading dims flatten to one token
    axis for the dispatch; ``hidden_size`` is each expert's inner width.
    ``router_noise`` multiplies the router INPUTS by U[1 - noise, 1 + noise]
    when a ``generator`` is given (training); without one the layer is
    deterministic.
    """

    def __init__(self, d_model: int, num_experts: int, hidden_size: int, *, k: int = 2,
                 capacity_factor: float = 1.25, router_noise: float = 0.0, dispatch: str = "gshard",
                 mesh: Any = None, dtype: torch.dtype = torch.float32, device: Any = None) -> None:
        super().__init__()
        if dispatch not in _DISPATCH:
            raise ValueError(f"dispatch must be 'gshard' or 'a2a', got {dispatch!r}")
        ep = axis_size(mesh, EXPERT_AXIS)
        if num_experts % ep:
            raise ValueError(f"num_experts ({num_experts}) must be divisible by the {EXPERT_AXIS!r} axis size ({ep})")
        self.num_experts, self.k = num_experts, k
        self.capacity_factor, self.router_noise, self.dtype = capacity_factor, router_noise, dtype
        #: the expert-parallel mesh (None: every expert on this rank)
        self.dispatch, self.mesh = dispatch, mesh
        local = num_experts // ep
        self.router = nn.Linear(d_model, num_experts, device=device, dtype=torch.float32)
        self.w_in = nn.Parameter(torch.empty(local, d_model, hidden_size, device=device, dtype=dtype))
        self.w_out = nn.Parameter(torch.empty(local, hidden_size, d_model, device=device, dtype=dtype))
        #: this rank's share of a tensor-parallel model (``models/gpt.py::tensor_parallel``)
        self.tp = None
        #: the ranks a training batch's tokens are split over (an ``AxisGroup``;
        #: None over one rank), routed together: the mesh's, or the layout's
        #: (``models/training.py::shard_train_state``)
        self.token_group = None if mesh is None else batch_ranks(mesh)
        nn.init.normal_(self.w_in, std=0.02)
        nn.init.normal_(self.w_out, std=0.02)

    @property
    def experts(self):
        """The ``expert`` axis through this rank (an ``AxisGroup`` of one
        rank when the layer holds every expert)."""
        from unionml_tpu_torch.models._layers import AxisGroup

        return AxisGroup.of(self.mesh, EXPERT_AXIS)

    @property
    def partial(self):
        """The ranks whose outputs are each a part of the layer's (an
        ``AxisGroup``, summed in float32): the ``expert`` axis, the tensor
        axis (each rank a share of every expert's hidden width), or both
        (``expert`` × ``tensor``, over the mesh that splits the experts)."""
        from unionml_tpu_torch.models._layers import AxisGroup

        experts = self.experts
        if self.tp is None:
            return experts
        if experts.size == 1:
            return self.tp
        group = AxisGroup.over(self.mesh, (EXPERT_AXIS, TENSOR_AXIS))
        if group.size != experts.size * self.tp.size:
            raise ValueError(f"the experts are split over the {EXPERT_AXIS!r} axis of a mesh whose {TENSOR_AXIS!r} "
                             f"axis is not the model's ({self.tp.size} ranks): split both over one mesh")
        return group

    def route(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None, group: Any = None):
        """``(gates in the compute dtype, aux)`` of ``tokens`` ``(T, d)``: the
        f32 router (jittered when a ``generator`` is given), its softmax and
        the two router losses (the balance loss over ``group``'s global
        tokens when one is given)."""
        router_inputs = tokens.float()
        if self.router_noise > 0.0 and generator is not None:
            jitter = torch.rand(router_inputs.shape, generator=generator, device=router_inputs.device)
            router_inputs = router_inputs * (jitter * (2.0 * self.router_noise) + (1.0 - self.router_noise))
        logits = self.router(router_inputs)
        gates = torch.softmax(logits, dim=-1)
        aux = {
            "router_z_loss": router_z_loss(logits),
            "load_balancing_loss": load_balancing_loss(gates, torch.argmax(logits, dim=-1), self.num_experts, group),
        }
        return gates.to(self.dtype), aux

    def forward(self, x: torch.Tensor, dropless: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(out, aux)``. ``dropless`` lifts the capacity bound (inference:
        a trained, imbalanced router must not zero overflow tokens)."""
        tokens = x.reshape(-1, x.shape[-1])
        group = None if dropless else self.token_group
        gates, aux = self.route(tokens, generator, group)
        # k=1 keeps the raw top gate: top/top == 1 would erase the router's
        # gradient through the task loss (moe.py:127-131)
        normalize = self.k > 1
        params = (self.w_in, self.w_out)
        rows = x.shape[0] if x.dim() > 2 else 1
        if self.dispatch == "a2a" and not dropless:
            if self.mesh is None or EXPERT_AXIS not in axis_names(self.mesh):
                raise ValueError("dispatch='a2a' requires a mesh with an 'expert' axis")
            if axis_size(self.mesh, TENSOR_AXIS) != (1 if self.tp is None else self.tp.size):
                raise ValueError(f"dispatch='a2a' sums the experts' hidden shares over its mesh's {TENSOR_AXIS!r} "
                                 "axis: split the model over that mesh's tensor axis")
            out = moe_apply_a2a(_experts, params, tokens.to(self.dtype), gates, self.mesh, k=self.k,
                                capacity_factor=self.capacity_factor, normalize_gates=normalize,
                                tensor_axis=None if self.tp is None else TENSOR_AXIS, rows=rows)
        else:
            experts = self.experts
            local = self.w_in.shape[0]
            out = _apply_topk(_experts, params, tokens.to(self.dtype), gates, k=self.k,
                              capacity_factor=None if dropless else self.capacity_factor, normalize_gates=normalize,
                              num_experts=self.num_experts, first=experts.index * local, local=local,
                              partial=self.partial, group=group, rows=rows)
        return out.reshape(x.shape).to(x.dtype), aux


def collect_aux_losses(aux: Iterable[Dict[str, torch.Tensor]], z_weight: float = 1e-3,
                       balance_weight: float = 1e-2) -> torch.Tensor:
    """``z_weight * sum(z losses) + balance_weight * sum(balance losses)``
    over the sparse blocks' ``aux`` dicts (a float32 scalar to add to the
    task loss; 0 when there is none)."""
    total = None
    for layer in aux:  # in the order JAX's tree flattening visits the sown leaves
        term = balance_weight * layer["load_balancing_loss"].float()
        total = term if total is None else total + term
        total = total + z_weight * layer["router_z_loss"].float()
    return torch.zeros((), dtype=torch.float32) if total is None else total
