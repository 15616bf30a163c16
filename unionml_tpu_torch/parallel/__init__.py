"""Parallelism of the port: device meshes and sharding specs over
``torch.distributed`` (:mod:`~unionml_tpu_torch.parallel.mesh`), process
init (:mod:`~unionml_tpu_torch.parallel.distributed`), and the
single-device half of expert parallelism
(:mod:`~unionml_tpu_torch.parallel.ep`). Tensor-parallel generation runs on
these (``DecodeEngine(mesh=...)``). Not ported yet (ROADMAP: M12): data
parallelism (``dp.py``, DDP/FSDP2 training), ring/ulysses sequence
parallelism, pipelines (``pp.py``) and the expert-parallel all-to-all."""

from unionml_tpu_torch.parallel.distributed import collective_timeout_s, initialize_distributed, is_primary_host
from unionml_tpu_torch.parallel.ep import (
    EXPERT_AXIS,
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
from unionml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    SEQUENCE_AXIS,
    TENSOR_AXIS,
    MeshSpec,
    NamedSharding,
    Spec,
    batch_axis_size,
    batch_sharding,
    logical_to_sharding,
    make_hybrid_mesh,
    make_mesh,
    named_sharding_tree,
    replicated,
    shard_batch,
    wrapped_row_indices,
)

__all__ = [
    "DATA_AXIS",
    "EXPERT_AXIS",
    "FSDP_AXIS",
    "SEQUENCE_AXIS",
    "TENSOR_AXIS",
    "MeshSpec",
    "NamedSharding",
    "Routing",
    "Spec",
    "batch_axis_size",
    "batch_sharding",
    "collective_timeout_s",
    "expert_sharding",
    "initialize_distributed",
    "is_primary_host",
    "logical_to_sharding",
    "make_hybrid_mesh",
    "make_mesh",
    "moe_apply",
    "moe_apply_a2a",
    "moe_apply_capacity",
    "moe_apply_topk",
    "named_sharding_tree",
    "reference_moe_apply_topk",
    "reference_topk_dispatch_combine",
    "replicated",
    "shard_batch",
    "topk_route",
    "wrapped_row_indices",
]
