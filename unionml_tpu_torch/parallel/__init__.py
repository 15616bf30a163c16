"""Parallelism of the port: device meshes, their process groups and sharding
specs over ``torch.distributed`` (:mod:`~unionml_tpu_torch.parallel.mesh`),
process init (:mod:`~unionml_tpu_torch.parallel.distributed`), data-parallel
steps and batches (:mod:`~unionml_tpu_torch.parallel.dp`), expert
parallelism over the ``expert`` axis (:mod:`~unionml_tpu_torch.parallel.ep`:
``moe_apply``, ``moe_apply_topk(mesh=)`` routed over the global batch,
``moe_apply_a2a``), and sequence parallelism over the ``sequence`` axis: ring attention
(:mod:`~unionml_tpu_torch.parallel.ring`) and Ulysses
(:mod:`~unionml_tpu_torch.parallel.ulysses`), both behind
:func:`sp_attention`, the one dispatch the model families route through.
Generation over the tensor, fsdp, expert, data and sequence axes
(``DecodeEngine``/``SpeculativeEngine(mesh=...)``, ``ep_mesh`` models
included), sharded training over the data, fsdp, tensor and sequence axes
(``fit(mesh=..., param_spec=...)``; ``GPTConfig``/``BertConfig(attention_impl="ring"
or "ulysses", sp_mesh=mesh)``; the sparse GPT over data×expert,
``GPTConfig(moe_dispatch=, ep_mesh=mesh)``, beside fsdp, tensor or
sequence too) and the meshed predictor (``ResidentPredictor(mesh=...)``, a
ring or Ulysses model over the ``sequence`` axis included) run on these; the
``sequence`` axis composes with ``data``, ``fsdp`` and ``tensor`` in
training and serving, and with sparse blocks (routed over the sequence
chunks); experts split over ``expert`` serve beside ``tensor`` (summed over
expert×tensor). Not ported yet (ROADMAP: M12): pipelines (``pp.py``), the
fleet on sub-meshes, the multi-host backend."""

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
    batch_order,
    batch_sharding,
    fsdp_mesh,
    logical_to_sharding,
    make_hybrid_mesh,
    make_mesh,
    named_sharding_tree,
    replicated,
    shard_batch,
    shard_sequence,
    wrapped_row_indices,
)
from unionml_tpu_torch.parallel.ring import reference_ring_attention, ring_attention, sequence_sharding
from unionml_tpu_torch.parallel.ulysses import ulysses_attention

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
    "batch_order",
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
    "reference_ring_attention",
    "reference_topk_dispatch_combine",
    "replicated",
    "ring_attention",
    "sequence_sharding",
    "shard_batch",
    "shard_sequence",
    "sp_attention",
    "topk_route",
    "ulysses_attention",
    "wrapped_row_indices",
]


def sp_attention(q, k, v, mesh, impl: str, *, causal: bool = False, kv_lens=None, tensor_axis=None):
    """Dispatch to a sequence-parallel attention impl ("ring" | "ulysses")
    (``parallel/__init__.py:74-90``): the one place both model families
    route their long-context path through. ``q``, ``k``, ``v`` are this
    rank's sequence chunk (of its heads, under a tensor split); ``kv_lens``
    the whole rows' valid lengths. ``tensor_axis`` names the mesh axis a
    tensor-parallel model splits the heads over: the ring attends over the
    rank's heads as they are, Ulysses checks and exchanges by the model's
    heads (:func:`ulysses_attention`)."""
    if mesh is None:
        raise ValueError(f"attention_impl={impl!r} requires a sequence-parallel mesh (sp_mesh)")
    table = {"ring": ring_attention, "ulysses": ulysses_attention}
    try:
        fn = table[impl]
    except KeyError:
        raise ValueError(f"Unknown sequence-parallel impl {impl!r}; expected one of {sorted(table)}") from None
    if impl == "ulysses":
        return fn(q, k, v, mesh, causal=causal, kv_lens=kv_lens, tensor_axis=tensor_axis)
    return fn(q, k, v, mesh, causal=causal, kv_lens=kv_lens)
