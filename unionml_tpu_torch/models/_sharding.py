"""Shared machinery for rule-based parameter sharding tables.

Port of ``unionml_tpu/models/_sharding.py``: a model family declares only its
``spec_for`` rule; walking the tree by name and laying it out live here.
The port's parameter tree is a dict keyed by parameter name
(``dict(model.named_parameters())``, or nested dicts), and a rank keeps only
its own shard of each leaf (SPMD), so :func:`place_by_specs` returns local
shards where JAX's ``device_put`` returns global arrays.
"""

from typing import Any, Callable, Optional, Tuple

from unionml_tpu_torch.ops.quant import QuantizedArray
from unionml_tpu_torch.parallel.mesh import NamedSharding, _tree_map


def shard_by_rules(
    params: Any,
    spec_for: Callable[[Tuple[str, ...], Any], Any],
    is_leaf: Optional[Callable[[Any], bool]] = None,
) -> Any:
    """Apply ``spec_for((path parts), leaf) -> Spec`` over a parameter tree.
    A key's dotted name splits into parts (``"layers.0.qkv.weight"`` is
    ``("layers", "0", "qkv", "weight")``); ``is_leaf`` stops the walk at
    composite leaves (``QuantizedArray``) so ``spec_for`` sees the whole node."""
    leaf_of = is_leaf or (lambda x: False)

    def walk(tree: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(tree, dict) and not leaf_of(tree):
            return {key: walk(value, path + tuple(str(key).split("."))) for key, value in tree.items()}
        return spec_for(path, tree)

    return walk(params, ())


def place_by_specs(params: Any, mesh: Any, spec_tree: Any) -> Any:
    """This rank's shard of every leaf of ``params`` under the matching spec
    tree: the serving-side layout of a full tree that every rank holds. A
    ``QuantizedArray`` node's codes and scales each take their own spec.
    Raises ``ValueError`` where an axis does not divide a dimension."""

    def place(leaf: Any, spec: Any) -> Any:
        if isinstance(leaf, QuantizedArray):
            return QuantizedArray(q=NamedSharding(mesh, spec.q).shard(leaf.q),
                                  scale=NamedSharding(mesh, spec.scale).shard(leaf.scale), dtype=leaf.dtype)
        return NamedSharding(mesh, spec).shard(leaf)

    return _tree_map(place, params, spec_tree, is_leaf=lambda x: isinstance(x, QuantizedArray))
