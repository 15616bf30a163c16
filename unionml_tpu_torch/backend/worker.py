"""Worker entrypoint: rehydrate the app module and execute a workflow.

Port of ``unionml_tpu/backend/worker.py``. This is the process/machine boundary
of the backend — the analogue of the reference's task resolver running inside a
remote container (``unionml/task_resolver.py:16-31``): the worker receives an
execution directory containing ``meta.json`` with the app's ``(module,
variable)`` address, re-imports the module (which re-runs the ``Dataset``/
``Model`` decorators), rebuilds the named workflow, and executes it::

    python -m unionml_tpu_torch.backend.worker <execution_dir>

The app's stages run where the app puts them: the port's entry points run on
the CUDA device unless the app asks for the CPU, and raise without one. The
hand-written kernels load from ``build/torch_kernels/`` beside the package
(``kernels/_build.py``), whatever the worker's working directory. A job on
several hosts is not ported (the backend refuses it before a worker starts).
"""

import json
import pickle
import sys
from pathlib import Path
from typing import Any, Dict


def _resolve_workflow(model: Any, workflow_name: str):
    """Map a workflow name back to its factory on the rehydrated model object."""
    factories = {
        model.train_workflow_name: model.train_workflow,
        model.predict_workflow_name: model.predict_workflow,
        model.predict_from_features_workflow_name: model.predict_from_features_workflow,
    }
    try:
        return factories[workflow_name]()
    except KeyError:
        raise ValueError(
            f"Workflow {workflow_name!r} is not one of {sorted(factories)} for model {model.name!r}"
        ) from None


def _coerce_inputs(workflow, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Rebuild typed kwargs dataclasses from the plain-dict wire format."""
    coerced = {}
    for name, annotation in workflow.input_types.items():
        value = inputs.get(name)
        if (
            isinstance(value, dict)
            and isinstance(annotation, type)
            and hasattr(annotation, "from_dict")
        ):
            coerced[name] = annotation.from_dict(value)
        elif name in inputs:
            coerced[name] = value
    return coerced


def run_workflow_for_model(model: Any, workflow_name: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Execute a named workflow and map positional results to named outputs.

    Inputs are wire-decoded (state-dict-encoded model objects rebuilt via the app's
    init) and outputs wire-encoded back — see
    ``unionml_tpu_torch.backend.wire_encode_value``.
    """
    from unionml_tpu_torch.backend import _plain_inputs, wire_decode_value

    workflow = _resolve_workflow(model, workflow_name)
    inputs = {key: wire_decode_value(value, model) for key, value in inputs.items()}
    result = workflow(**_coerce_inputs(workflow, inputs))
    names = workflow.output_names
    if len(names) == 1:
        return _plain_inputs({names[0]: result})
    return _plain_inputs(dict(zip(names, result)))


def run_execution(execution_dir: Path) -> int:
    """Run one execution from its directory; 0 on success, 1 on failure (recorded)."""
    from unionml_tpu_torch._logging import logger
    from unionml_tpu_torch.tracker import load_tracked_instance

    with (execution_dir / "meta.json").open() as f:
        meta = json.load(f)
    (execution_dir / "status").write_text("RUNNING")
    try:
        model = load_tracked_instance(meta["app_module"], meta["app_variable"], meta.get("module_file"))
        with (execution_dir / "inputs.pkl").open("rb") as f:
            inputs = pickle.load(f)
        outputs = run_workflow_for_model(model, meta["workflow_name"], inputs)
        with (execution_dir / "outputs.pkl").open("wb") as f:
            pickle.dump(outputs, f)
        (execution_dir / "status").write_text("SUCCEEDED")
        return 0
    except Exception as exc:  # record failure for the waiting client
        logger.exception("Worker failed for execution %s", meta.get("execution_id"))
        (execution_dir / "error.txt").write_text(repr(exc))
        (execution_dir / "status").write_text("FAILED")
        return 1


def main() -> None:
    if len(sys.argv) != 2:
        print("usage: python -m unionml_tpu_torch.backend.worker <execution_dir>", file=sys.stderr)
        raise SystemExit(2)
    raise SystemExit(run_execution(Path(sys.argv[1])))


if __name__ == "__main__":
    main()
