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

from unionml_tpu_torch.parallel.ep import moe_apply_topk

__all__ = ["MoEMlp", "collect_aux_losses", "load_balancing_loss", "router_z_loss"]

_DISPATCH = ("gshard", "a2a")


def router_z_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """Mean squared logsumexp of the router logits (keeps them small)."""
    return torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)


def load_balancing_loss(gates: torch.Tensor, expert_index: torch.Tensor, num_experts: int) -> torch.Tensor:
    """``E * sum_e f_e * P_e``: ``f_e`` the fraction of tokens whose top
    choice is ``e``, ``P_e`` the mean gate of ``e``; 1.0 at perfect balance."""
    one_hot = (expert_index[:, None] == torch.arange(num_experts, device=gates.device)[None, :]).to(gates.dtype)
    return num_experts * torch.sum(one_hot.mean(dim=0) * gates.mean(dim=0))


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
        if dispatch == "a2a" or mesh is not None:
            raise NotImplementedError(
                "MoEMlp with dispatch='a2a' or an expert mesh: expert parallelism is not ported yet "
                "(ROADMAP: M12, expert-parallel a2a)"
            )
        self.num_experts, self.k = num_experts, k
        self.capacity_factor, self.router_noise, self.dtype = capacity_factor, router_noise, dtype
        self.router = nn.Linear(d_model, num_experts, device=device, dtype=torch.float32)
        self.w_in = nn.Parameter(torch.empty(num_experts, d_model, hidden_size, device=device, dtype=dtype))
        self.w_out = nn.Parameter(torch.empty(num_experts, hidden_size, d_model, device=device, dtype=dtype))
        nn.init.normal_(self.w_in, std=0.02)
        nn.init.normal_(self.w_out, std=0.02)

    def route(self, tokens: torch.Tensor, generator: Optional[torch.Generator] = None):
        """``(gates in the compute dtype, aux)`` of ``tokens`` ``(T, d)``: the
        f32 router (jittered when a ``generator`` is given), its softmax and
        the two router losses."""
        router_inputs = tokens.float()
        if self.router_noise > 0.0 and generator is not None:
            jitter = torch.rand(router_inputs.shape, generator=generator, device=router_inputs.device)
            router_inputs = router_inputs * (jitter * (2.0 * self.router_noise) + (1.0 - self.router_noise))
        logits = self.router(router_inputs)
        gates = torch.softmax(logits, dim=-1)
        aux = {
            "router_z_loss": router_z_loss(logits),
            "load_balancing_loss": load_balancing_loss(gates, torch.argmax(logits, dim=-1), self.num_experts),
        }
        return gates.to(self.dtype), aux

    def forward(self, x: torch.Tensor, dropless: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(out, aux)``. ``dropless`` lifts the capacity bound (inference:
        a trained, imbalanced router must not zero overflow tokens)."""
        tokens = x.reshape(-1, x.shape[-1])
        gates, aux = self.route(tokens, generator)
        out = moe_apply_topk(
            _experts, (self.w_in, self.w_out), tokens.to(self.dtype), gates,
            k=self.k, capacity_factor=None if dropless else self.capacity_factor,
            # k=1 keeps the raw top gate: top/top == 1 would erase the
            # router's gradient through the task loss (moe.py:127-131)
            normalize_gates=self.k > 1,
        )
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
