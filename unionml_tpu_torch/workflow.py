"""A minimal imperative workflow graph + in-process executor.

This replaces the flytekit ``Workflow`` the reference builds its train/predict graphs on
(``unionml/model.py:425-510``): the same imperative API — ``add_workflow_input``,
``add_entity``, ``add_workflow_output`` — wired to an in-repo topological executor
instead of Flyte's compiler. Stages run in dependency order; data flows as plain Python
objects / device arrays (no literal-type serialization on the local path).

The graph is also the unit the execution backend serializes for remote jobs: every node
references a stage by its tracked address, so a worker can rebuild the identical graph.
"""

from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple

from unionml_tpu_torch.exceptions import WorkflowError
from unionml_tpu_torch.stage import Stage, _output_mapping


class Promise(NamedTuple):
    """A reference to a named output of a workflow node (or a workflow input)."""

    source: str  # node id, or "__inputs__"
    key: str


class Node:
    def __init__(self, node_id: str, stage: Stage, bindings: Dict[str, Any]):
        self.id = node_id
        self.stage = stage
        self.bindings = bindings  # arg name -> Promise | literal

    @property
    def outputs(self) -> Dict[str, Promise]:
        return {key: Promise(self.id, key) for key in _output_mapping(self.stage.output_annotation)}


class WorkflowInput(NamedTuple):
    name: str
    annotation: Any
    default: Any


_NO_DEFAULT = object()


class Workflow:
    """An imperative DAG of stages."""

    def __init__(self, name: str):
        self.name = name
        self._inputs: "OrderedDict[str, WorkflowInput]" = OrderedDict()
        self._nodes: "OrderedDict[str, Node]" = OrderedDict()
        self._outputs: "OrderedDict[str, Promise]" = OrderedDict()

    @property
    def inputs(self) -> Dict[str, Promise]:
        return {name: Promise("__inputs__", name) for name in self._inputs}

    @property
    def input_types(self) -> "OrderedDict[str, Any]":
        return OrderedDict((name, spec.annotation) for name, spec in self._inputs.items())

    @property
    def output_names(self) -> List[str]:
        return list(self._outputs)

    @property
    def nodes(self) -> List[Node]:
        return list(self._nodes.values())

    def add_workflow_input(self, name: str, annotation: Any, default: Any = _NO_DEFAULT) -> Promise:
        if name in self._inputs:
            raise WorkflowError(f"Workflow {self.name} already has an input named {name!r}")
        self._inputs[name] = WorkflowInput(name, annotation, default)
        return Promise("__inputs__", name)

    def add_entity(self, stage: Stage, **bindings: Any) -> Node:
        missing = [k for k in bindings if k not in stage.inputs]
        if missing:
            raise WorkflowError(f"Stage {stage.name} has no inputs named {missing}")
        node_id = f"n{len(self._nodes)}-{stage.name}"
        node = Node(node_id, stage, bindings)
        self._nodes[node_id] = node
        return node

    def add_workflow_output(self, name: str, promise: Promise) -> None:
        if not isinstance(promise, Promise):
            raise WorkflowError(f"Workflow output {name!r} must be bound to a Promise; got {promise!r}")
        self._outputs[name] = promise

    def execute(self, **inputs: Any) -> Any:
        """Run the graph in insertion (topological) order and return the declared outputs.

        Single output -> the bare value; multiple outputs -> NamedTuple-like tuple in
        declaration order (matching flytekit local-execution ergonomics the reference
        relies on at ``unionml/model.py:697-703``).
        """
        values: Dict[str, Dict[str, Any]] = {"__inputs__": {}}
        for name, spec in self._inputs.items():
            if name in inputs:
                values["__inputs__"][name] = inputs[name]
            elif spec.default is not _NO_DEFAULT:
                values["__inputs__"][name] = spec.default
            else:
                raise WorkflowError(f"Workflow {self.name} missing required input {name!r}")
        unknown = set(inputs) - set(self._inputs)
        if unknown:
            raise WorkflowError(f"Workflow {self.name} received unknown inputs: {sorted(unknown)}")

        for node in self._nodes.values():
            kwargs = {}
            for arg, binding in node.bindings.items():
                if isinstance(binding, Promise):
                    try:
                        kwargs[arg] = values[binding.source][binding.key]
                    except KeyError as exc:
                        raise WorkflowError(
                            f"Node {node.id} binding {arg!r} references unavailable value {binding}"
                        ) from exc
                else:
                    kwargs[arg] = binding
            result = node.stage(**kwargs)
            out_keys = list(_output_mapping(node.stage.output_annotation))
            if len(out_keys) == 1:
                values[node.id] = {out_keys[0]: result}
            else:
                values[node.id] = dict(zip(out_keys, result))

        resolved = [values[p.source][p.key] for p in self._outputs.values()]
        if len(resolved) == 1:
            return resolved[0]
        return tuple(resolved)

    __call__ = execute

    def __repr__(self) -> str:
        return f"Workflow(name={self.name!r}, inputs={list(self._inputs)}, nodes={len(self._nodes)})"
