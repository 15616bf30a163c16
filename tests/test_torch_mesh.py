"""The port's meshes and sharding specs (``unionml_tpu_torch.parallel``,
``models/_sharding.py``, ``models/gpt.py``'s spec tables) against the JAX
package's.

A mesh spans a ``torch.distributed`` world; here each world is PyTorch's
in-process ``fake`` backend (one process standing in for any rank of any
world size, no collective runs), against the JAX package's 8-device CPU
mesh (``tests/conftest.py``). ``tests/unit/test_parallel.py:24-66``'s
cases, ``shard_batch`` rank by rank, the spec trees of ``param_shardings``
(float and int8) and ``kv_cache_spec``, and a vocabulary the tensor axis
does not divide raising as JAX does.
"""

import contextlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding as JaxSharding
from jax.sharding import PartitionSpec as P

from unionml_tpu.models import gpt as jgpt
from unionml_tpu.models._sharding import place_by_specs as jax_place_by_specs
from unionml_tpu.ops.quant import QuantizedArray as JaxQuantized
from unionml_tpu.ops.quant import quantize_tree as jax_quantize_tree
from unionml_tpu.parallel import mesh as jmesh
from unionml_tpu_torch.models import GPTConfig, gpt as tgpt, init_gpt
from unionml_tpu_torch.models._layers import quantize_model
from unionml_tpu_torch.models._sharding import place_by_specs
from unionml_tpu_torch.ops.quant import QuantizedArray
from unionml_tpu_torch.parallel import distributed, mesh as tmesh


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A world of ``world`` ranks seen from ``rank``, in this process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=rank, world_size=world, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_default_data_axis():
    jax_mesh = jmesh.make_mesh()
    with fake_world(8):
        mesh = tmesh.make_mesh(device="cpu")
        assert tmesh.axis_names(mesh) == tuple(jax_mesh.axis_names) == ("data",)
        assert mesh.mesh.numel() == jax_mesh.devices.size == 8
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh(device="cpu")


@pytest.mark.parametrize("axes, n", [({"data": -1, "tensor": 2}, 8), ({"data": -1, "tensor": 3}, 8),
                                     ({"data": 4}, 8), ({"data": -1, "tensor": -1}, 8), ({"tensor": 4}, 4)])
def test_mesh_spec_resolves_and_raises_as_jax(axes, n):
    def outcome(spec_cls):
        try:
            return spec_cls.from_dict(axes).resolve_shape(n)
        except ValueError as exc:
            return str(exc)

    assert outcome(tmesh.MeshSpec) == outcome(jmesh.MeshSpec)
    assert tmesh.MeshSpec.from_dict(axes).axis_names == jmesh.MeshSpec.from_dict(axes).axis_names


@pytest.mark.parametrize("axes", [{"data": 2, "tensor": 4}, {"data": 2, "fsdp": 2, "tensor": 2}, {"tensor": 8}])
def test_mesh_shape_batch_axes_and_logical_specs(axes):
    jax_mesh = jmesh.make_mesh(axes)
    with fake_world(8, rank=5):
        mesh = tmesh.make_mesh(axes, device="cpu")
        for name, size in axes.items():
            assert tmesh.axis_size(mesh, name) == jax_mesh.shape[name] == size
        assert tmesh.batch_axis_size(mesh) == jmesh.batch_axis_size(jax_mesh)
        assert tuple(tmesh.batch_sharding(mesh).spec) == tuple(jmesh.batch_sharding(jax_mesh).spec)
        assert tuple(tmesh.replicated(mesh).spec) == tuple(jmesh.replicated(jax_mesh).spec)
        logical = ("data", "expert", "tensor")
        assert tuple(tmesh.logical_to_sharding(mesh, *logical).spec) == \
            tuple(jmesh.logical_to_sharding(jax_mesh, *logical).spec)
        # rank 5's coordinates: the last axis varies fastest, as jax's device grid
        coords = np.argwhere(np.vectorize(lambda d: d.id)(jax_mesh.devices) == 5)[0]
        assert [tmesh.axis_index(mesh, name) for name in axes] == list(coords)


def test_hybrid_mesh_places_host_axes_slowest():
    with fake_world(8, rank=3):
        mesh = tmesh.make_hybrid_mesh({"data": 2, "tensor": 2}, {"data": 2})
        assert tmesh.axis_names(mesh) == ("data", "tensor")
        assert mesh.mesh.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]


@pytest.mark.parametrize("n_rows, multiple", [(50, 8), (16, 8), (5, 1), (7, 3)])
def test_wrapped_row_indices_equal_jax(n_rows, multiple):
    mine, theirs = tmesh.wrapped_row_indices(n_rows, multiple), jmesh.wrapped_row_indices(n_rows, multiple)
    assert (mine is None and theirs is None) or np.array_equal(mine, theirs)


@pytest.mark.parametrize("axes", [{"data": 8}, {"data": 2, "fsdp": 2, "tensor": 2}])
def test_shard_batch_gives_each_rank_its_jax_shard(axes):
    """Rank by rank, the port's local rows are the rows JAX lays on that
    rank's device (numpy and torch leaves)."""
    batch = {"x": np.arange(16 * 4, dtype=np.float32).reshape(16, 4), "y": [np.arange(16)]}
    jax_mesh = jmesh.make_mesh(axes)
    sharded = jmesh.shard_batch(batch, jax_mesh)
    by_device = {s.device.id: s.index for s in sharded["x"].addressable_shards}
    for rank in range(8):
        with fake_world(8, rank=rank):
            mesh = tmesh.make_mesh(axes, device="cpu")
            mine = tmesh.shard_batch(batch, mesh)
            assert np.array_equal(mine["x"], batch["x"][by_device[rank]])
            assert np.array_equal(mine["y"][0], batch["y"][0][by_device[rank][:1]])
            rows = tmesh.shard_batch(torch.from_numpy(batch["x"]), mesh)
            assert torch.equal(rows, torch.from_numpy(batch["x"][by_device[rank]]))


def test_spec_pickles_with_its_parts():
    spec = tmesh.Spec("tensor", None, parts=3)
    back = pickle.loads(pickle.dumps(spec))
    assert back == ("tensor", None) and back.parts == 3 and repr(back) == "Spec('tensor', None, parts=3)"


def test_named_sharding_tree_binds_every_spec():
    specs = {"a": tmesh.Spec("tensor"), "b": [tmesh.Spec(), tmesh.Spec(None, "data")]}
    with fake_world(4):
        mesh = tmesh.make_mesh({"data": 2, "tensor": 2}, device="cpu")
        tree = tmesh.named_sharding_tree(mesh, specs)
        assert tree["a"] == tmesh.NamedSharding(mesh, specs["a"])
        assert [s.spec for s in tree["b"]] == specs["b"] and all(s.mesh is mesh for s in tree["b"])


def test_named_sharding_splits_each_part_of_a_fused_dimension():
    full = torch.arange(12 * 2).reshape(12, 2)
    with fake_world(2, rank=1):
        mesh = tmesh.make_mesh({"tensor": 2}, device="cpu")
        fused = tmesh.NamedSharding(mesh, tmesh.Spec("tensor", None, parts=3)).shard(full)
        assert torch.equal(fused, torch.cat([full[2:4], full[6:8], full[10:12]]))
        plain = tmesh.NamedSharding(mesh, tmesh.Spec(None, "tensor")).shard(full)
        assert torch.equal(plain, full[:, 1:])
        with pytest.raises(ValueError, match="not found in mesh"):
            tmesh.NamedSharding(mesh, tmesh.Spec("fsdp")).shard(full)


def test_initialize_distributed_without_a_world():
    assert distributed.initialize_distributed(device="cpu") is False
    assert distributed.is_primary_host()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize_distributed(strict=True, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    jcfg = jgpt.GPTConfig.tiny(dropout=0.0, dtype=jnp.float32, attention_impl="xla")
    variables = jgpt.init_params(jcfg, seq_len=16)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    return variables, init_gpt(GPTConfig.tiny(dtype=torch.float32, dropout=0.0), params=params, device="cpu")


def _jax_names(tree, prefix=()):
    """Flatten JAX's GPT tree to the port's parameter names (a Dense kernel is
    the ``nn.Linear`` weight, transposed)."""
    out = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            out.update(_jax_names(value, path))
            continue
        names = list(path[1:]) if path[0] == "params" else list(path)
        if names[0].startswith("layer_"):
            names = ["layers", names[0][len("layer_"):]] + names[1:]
        leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(names[-1], names[-1])
        out[".".join(names[:-1] + [leaf])] = (value, names[-1] == "kernel")
    return out


def _flip(spec, transposed, ndim):
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(reversed(entries)) if transposed else tuple(spec)


@pytest.mark.parametrize("axes", [("data", "tensor"), ("data", "fsdp", "tensor"), ("tensor",), ("data",)])
def test_param_shardings_match_jax(tiny, axes):
    variables, model = tiny
    jax_specs = _jax_names(jgpt.param_shardings(variables, axes))
    mine = tgpt.param_shardings(dict(model.named_parameters()), axes)
    assert set(mine) == set(jax_specs)
    for name, (spec, transposed) in jax_specs.items():
        ndim = model.get_parameter(name).dim()
        assert tuple(mine[name]) == _flip(spec, transposed, ndim) or \
            (ndim < 2 and tuple(mine[name]) == tuple(spec) == ()), name
    assert mine["layers.0.qkv.weight"].parts == 3 and mine["layers.0.mlp_up.weight"].parts == 1


def test_int8_param_shardings_match_jax(tiny):
    """QuantizedArray nodes: the codes take the kernel's spec, the scale only
    its channel axis, each flipped to the port's (out, in) layout."""
    variables, model = tiny
    axes = ("data", "tensor")
    jax_tree = jax_quantize_tree(variables["params"] if "params" in variables else variables)
    jax_specs = jgpt.param_shardings(jax_tree, axes)
    _, tree = quantize_model(model)
    mine = tgpt.param_shardings(tree, axes)
    quantized = 0
    for name, value in tree.items():
        if not isinstance(value, QuantizedArray):
            continue
        quantized += 1
        layer, kind = name.split(".")[1], name.split(".")[2]
        theirs = jax_specs[f"layer_{layer}"][kind]["kernel"]
        assert isinstance(theirs, JaxQuantized) and isinstance(mine[name], QuantizedArray)
        assert tuple(mine[name].q) == _flip(theirs.q, True, 2)
        assert tuple(mine[name].scale) == _flip(theirs.scale, True, 2)
    assert quantized == 8


@pytest.mark.parametrize("axes", [("data", "tensor"), ("data",)])
def test_kv_specs_match_jax(tiny, axes):
    cfg = GPTConfig.tiny()
    assert tuple(tgpt.kv_cache_spec(cfg, axes)) == tuple(jgpt.kv_cache_spec(jgpt.GPTConfig.tiny(), axes))
    assert tuple(tgpt.kv_block_spec(cfg, axes)) == tuple(jgpt.kv_block_spec(jgpt.GPTConfig.tiny(), axes))


def test_vocab_the_tensor_axis_does_not_divide_raises_as_jax():
    """GPT-2's 50257 rows on a tensor axis of 4: JAX's device_put refuses the
    layout, and so does the port's placement (the meshed engine's first step)."""
    table = np.zeros((50257, 8), dtype=np.float32)
    jax_mesh = jmesh.make_mesh({"tensor": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="divisible by 4") as theirs:
        jax.device_put(table, JaxSharding(jax_mesh, P("tensor", None)))
    with pytest.raises(ValueError, match="divisible by 4") as theirs_tree:
        jax_place_by_specs({"wte": table}, jax_mesh, {"wte": P("tensor", None)})
    cfg = GPTConfig(vocab_size=50257, hidden_size=64, num_layers=1, num_heads=4, max_position_embeddings=128,
                    dtype=torch.float32, dropout=0.0)
    model = tgpt.GPTLMHeadModel(cfg, device="cpu")
    with fake_world(4, rank=2):
        mesh = tmesh.make_mesh({"tensor": 4}, device="cpu")
        with pytest.raises(ValueError, match="divisible by 4") as mine:
            tgpt.tensor_parallel(model, mesh)
        # the padded vocabulary the multi-card arm serves shards evenly
        padded = tgpt.GPTLMHeadModel(GPTConfig(vocab_size=50304, hidden_size=64, num_layers=1, num_heads=4,
                                               max_position_embeddings=128, dtype=torch.float32), device="cpu")
        shard, local = tgpt.tensor_parallel(padded, mesh)
        assert local["wte.weight"].shape == (50304 // 4, 64) and shard.tp.heads == 1 and shard.tp.index == 2
        assert torch.equal(local["wte.weight"], padded.wte.weight[2 * 12576:3 * 12576])
    for exc in (theirs.value, theirs_tree.value, mine.value):
        assert "50257" in str(exc)


def test_place_by_specs_takes_each_ranks_shard_of_the_converted_tree(tiny):
    """JAX initialises, ``params_from_jax`` converts, and each rank's
    ``place_by_specs`` shard of the tree is its slice of JAX's laid-out
    arrays (a fused qkv takes its heads of q, k and v)."""
    variables, model = tiny
    tree = dict(model.named_parameters())
    specs = tgpt.param_shardings(tree, ("tensor",))
    jax_mesh = jmesh.make_mesh({"tensor": 4}, devices=jax.devices()[:4])
    laid = jax_place_by_specs(variables, jax_mesh, jgpt.param_shardings(variables, ("tensor",)))
    up = laid["params"]["layer_1"]["mlp_up"]["kernel"]
    up_shards = {s.device.id: np.asarray(s.data) for s in up.addressable_shards}
    for rank in range(4):
        with fake_world(4, rank=rank):
            local = place_by_specs(tree, tmesh.make_mesh({"tensor": 4}, device="cpu"), specs)
        assert np.array_equal(local["layers.1.mlp_up.weight"].detach().numpy(), up_shards[rank].T)
        q, k, v = tree["layers.0.qkv.weight"].split(64)
        assert torch.equal(local["layers.0.qkv.weight"], torch.cat([x[rank * 16:(rank + 1) * 16] for x in (q, k, v)]))
        assert torch.equal(local["layers.0.attn_norm.weight"], tree["layers.0.attn_norm.weight"])
