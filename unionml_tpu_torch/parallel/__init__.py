"""Parallelism of the port: for now the single-device half of expert
parallelism (:mod:`unionml_tpu_torch.parallel.ep`). Meshes, sharded experts
and the all-to-all dispatch are not ported yet (ROADMAP: M12)."""

from unionml_tpu_torch.parallel.ep import (
    Routing,
    expert_sharding,
    moe_apply,
    moe_apply_a2a,
    moe_apply_capacity,
    moe_apply_topk,
    reference_moe_apply_topk,
    reference_topk_dispatch_combine,
    topk_route,
)

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
