"""Parallelism of the port: device meshes, their process groups and sharding
specs over ``torch.distributed`` (:mod:`~unionml_tpu_torch.parallel.mesh`),
process init (:mod:`~unionml_tpu_torch.parallel.distributed`), data-parallel
steps and batches (:mod:`~unionml_tpu_torch.parallel.dp`), and the
single-device half of expert parallelism (:mod:`~unionml_tpu_torch.parallel.ep`).
Tensor-parallel generation (``DecodeEngine(mesh=...)``), sharded training
over the data, fsdp and tensor axes (``fit(mesh=..., param_spec=...)``) and
the meshed predictor (``ResidentPredictor(mesh=...)``) run on these. Not
ported yet (ROADMAP: M12): ring/ulysses sequence parallelism, pipelines
(``pp.py``) and the expert-parallel all-to-all."""

from unionml_tpu_torch.parallel.distributed import collective_timeout_s, initialize_distributed, is_primary_host
from unionml_tpu_torch.parallel.dp import batches, data_parallel_eval, data_parallel_step, pad_to_multiple
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
    axis_group,
    batch_axis_size,
    batch_group,
    batch_index,
    batch_sharding,
    fsdp_mesh,
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
    "axis_group",
    "batch_axis_size",
    "batch_group",
    "batch_index",
    "batch_sharding",
    "batches",
    "collective_timeout_s",
    "data_parallel_eval",
    "data_parallel_step",
    "expert_sharding",
    "fsdp_mesh",
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
    "pad_to_multiple",
    "reference_moe_apply_topk",
    "reference_topk_dispatch_combine",
    "replicated",
    "shard_batch",
    "topk_route",
    "wrapped_row_indices",
]
