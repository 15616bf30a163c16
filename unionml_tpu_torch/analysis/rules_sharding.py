"""Rule ``sharding``: spec axis names and mesh hygiene (port of
``unionml_tpu/analysis/rules_sharding.py``).

The mesh axis vocabulary is collected from the scanned tree itself, so the
rule follows the code instead of a hard-coded list:

- module-level ``*_AXIS = "name"`` string constants (``parallel/mesh.py``
  owns the canonical four: data / fsdp / tensor / sequence);
- literal dict keys passed to ``make_mesh`` / ``MeshSpec.from_dict`` /
  ``make_hybrid_mesh``, and literal axis-name tuples given to
  ``init_device_mesh`` / ``DeviceMesh`` (``mesh_dim_names``).

Checks:

- **unknown axis** — a string literal inside ``Spec(...)`` (or JAX's
  ``PartitionSpec(...)`` / ``P(...)``) that names an axis no mesh in the tree
  declares. On the port such a spec raises only when a tensor is laid out
  with it; a spec table that is never laid out on that axis keeps the typo
  until a mesh with the intended axis meets it, and then shards the wrong
  dimension or none.
- **foreign mesh** — ``NamedSharding(X, ...)`` where the enclosing function
  binds mesh-like names (a ``mesh`` parameter or local, ``*_mesh`` names, a
  ``make_mesh``/``init_device_mesh`` result) and ``X`` is none of them: a
  shard cut against another mesh's coordinates than the one the function's
  collectives run over.
"""

import ast
from typing import Iterator, List, Set

from unionml_tpu_torch.analysis.callgraph import dotted
from unionml_tpu_torch.analysis.core import Finding, Project, register

_MESH_BUILDERS = {"make_mesh", "make_hybrid_mesh", "from_dict", "init_device_mesh", "DeviceMesh"}
_MESH_RESULTS = {"make_mesh", "make_hybrid_mesh", "init_device_mesh", "DeviceMesh", "build"}
_SPEC_NAMES = {"Spec", "PartitionSpec", "P"}


def _strings(node: ast.AST) -> List[ast.Constant]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [el for el in node.elts if isinstance(el, ast.Constant) and isinstance(el.value, str)]
    return []


def _axis_vocabulary(project: Project) -> Set[str]:
    vocab: Set[str] = set()
    for idx in project.graph.indexes:
        tree = idx.source.tree
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id.endswith("_AXIS"):
                vocab.update(c.value for c in _strings(stmt.value) if not isinstance(stmt.value, (ast.Tuple, ast.List)))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if (dotted(node.func) or "").rsplit(".", 1)[-1] not in _MESH_BUILDERS:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Dict):
                    vocab.update(k.value for k in arg.keys if isinstance(k, ast.Constant) and isinstance(k.value, str))
                elif isinstance(arg, (ast.Tuple, ast.List)):
                    vocab.update(c.value for c in _strings(arg))
    return vocab


def _mesh_like_names(fn_node: ast.AST) -> Set[str]:
    names: Set[str] = set()
    args = fn_node.args
    for a in list(args.args) + list(args.kwonlyargs) + list(getattr(args, "posonlyargs", [])):
        if a.arg == "mesh" or a.arg.endswith("_mesh"):
            names.add(a.arg)
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "mesh" or t.id.endswith("_mesh"):
                    names.add(t.id)
                elif isinstance(node.value, ast.Call) and \
                        (dotted(node.value.func) or "").rsplit(".", 1)[-1] in _MESH_RESULTS:
                    names.add(t.id)
    return names


@register("sharding", "Spec axes checked against declared mesh axes; mesh-variable hygiene")
def check(project: Project) -> Iterator[Finding]:
    vocab = _axis_vocabulary(project)
    for idx in project.graph.indexes:
        relpath = idx.source.relpath
        for fn in idx.functions.values():
            mesh_names = None  # computed lazily per function
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                leaf = (dotted(node.func) or "").rsplit(".", 1)[-1]
                if leaf in _SPEC_NAMES:
                    for arg in list(node.args) + [kw.value for kw in node.keywords if kw.arg != "parts"]:
                        for lit in _strings(arg):
                            if vocab and lit.value not in vocab:
                                yield Finding(
                                    "sharding", relpath, lit.lineno, lit.col_offset,
                                    f"spec axis '{lit.value}' is not declared by any mesh in the tree "
                                    f"(known axes: {', '.join(sorted(vocab))}); a typo'd axis shards the "
                                    "wrong dimension, or none, once a mesh meets it",
                                    symbol=fn.qualname,
                                )
                elif leaf == "NamedSharding" and node.args:
                    first = node.args[0]
                    if not isinstance(first, ast.Name):
                        continue  # self.mesh / call results: out of static reach
                    if mesh_names is None:
                        mesh_names = _mesh_like_names(fn.node)
                    if mesh_names and first.id not in mesh_names and not first.id.endswith("mesh"):
                        yield Finding(
                            "sharding", relpath, first.lineno, first.col_offset,
                            f"NamedSharding built off '{first.id}' while the enclosing context binds mesh "
                            f"variable(s) {', '.join(sorted(mesh_names))}; a shard cut against another mesh "
                            "than the one the collectives run over holds another rank's rows",
                            symbol=fn.qualname,
                        )
