"""Deployment client helpers: app versioning, deployment, and artifact lineage queries.

Reference parity: ``unionml/remote.py`` — ``get_app_version`` (git sha + dirty-tree
check, ``remote.py:45-59``), ``get_model`` app import (``remote.py:30-35``), workflow
deployment (``remote.py:125-161``), and the lineage queries (``remote.py:200-350``).

A port of ``unionml_tpu/remote.py`` (it imports no JAX; the port keeps its own):
no docker build/push — deployment records the app's rehydration address + GPU
resources in the backend's app registry; "patch" deployment (code-only fast
registration) maps to re-registering the same app version with a ``-patch<uuid>``
suffix without any image work. The app version comes from ``git`` through
``subprocess``; an explicit version never calls it.
"""

import subprocess
import sys
import uuid
from pathlib import Path
from typing import TYPE_CHECKING, Any, List, Optional

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.exceptions import BackendError, ModelArtifactNotFound, VersionFetchError

if TYPE_CHECKING:
    from unionml_tpu_torch.backend import Execution, LocalBackend
    from unionml_tpu_torch.model import Model, ModelArtifact


def get_model(app: str, reload: bool = False) -> "Model":
    """Import ``module:variable`` and return the Model (``remote.py:30-35``)."""
    import importlib

    module_name, model_var = app.split(":")
    sys.path.insert(0, str(Path.cwd()))
    try:
        module = importlib.import_module(module_name)
        if reload:
            importlib.reload(module)
        return getattr(module, model_var)
    finally:
        sys.path.pop(0)


def get_app_version(allow_uncommitted: bool = False) -> str:
    """Derive the app version from the git HEAD sha (``remote.py:45-59``)."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, check=True
        ).stdout.strip()
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        raise VersionFetchError(
            "Could not determine app version from git; run inside a git repository or pass app_version explicitly."
        ) from exc

    dirty = bool(
        subprocess.run(["git", "status", "--porcelain"], capture_output=True, text=True).stdout.strip()
    )
    if dirty:
        if not allow_uncommitted:
            raise VersionFetchError(
                "Version check failed: the repository has uncommitted changes. Commit them or pass "
                "allow_uncommitted=True."
            )
        return f"{sha[:12]}-dirty"
    return sha[:12]


def deploy_app(
    model: "Model",
    backend: "LocalBackend",
    app_version: Optional[str] = None,
    allow_uncommitted: bool = False,
    patch: bool = False,
    schedule: bool = True,
) -> str:
    """Register the app's three workflows (+ schedules) with the backend.

    Mirrors ``Model.remote_deploy`` (``unionml/model.py:983-1083``) minus docker: there
    is no image build — the job spec ships the module address and GPU resources.
    """
    explicit_version = app_version is not None
    app_version = app_version or get_app_version(allow_uncommitted=allow_uncommitted or patch)
    if patch and not explicit_version:
        app_version = f"{app_version}-patch{uuid.uuid4().hex[:7]}"

    backend.create_project(getattr(backend, "default_project", None))
    logger.info("Deploying app version %s", app_version)

    for workflow_name in (
        model.train_workflow_name,
        model.predict_workflow_name,
        model.predict_from_features_workflow_name,
    ):
        backend.deploy_workflow(model, workflow_name, app_version=app_version, patch=patch)

    if schedule:
        for sched in [*model.training_schedules, *model.prediction_schedules]:
            backend.deploy_schedule(model, sched, app_version=app_version)
            if sched.activate_on_deploy:
                backend.activate_schedule(model, sched, app_version=app_version)

    return app_version


def get_model_execution(
    model: "Model",
    app_version: Optional[str] = None,
    model_version: Optional[str] = None,
) -> "Execution":
    """Latest successful training execution, or a specific one by id (``remote.py:200-269``)."""
    backend = model._remote
    if model_version and model_version != "latest":
        return backend.get_execution(model_version)
    executions = backend.list_executions(
        workflow_name=model.train_workflow_name, app_version=app_version, only_successful=True, limit=1
    )
    if not executions:
        raise ModelArtifactNotFound(
            f"No successful training executions found for {model.train_workflow_name}"
            + (f" at app version {app_version}" if app_version else "")
        )
    return executions[0]


def get_model_artifact(
    model: "Model",
    app_version: Optional[str] = None,
    model_version: Optional[str] = None,
) -> "ModelArtifact":
    """Fetch a trained model artifact from backend lineage (``remote.py:272-280``)."""
    from unionml_tpu_torch.backend import wire_decode_value
    from unionml_tpu_torch.model import ModelArtifact

    execution = get_model_execution(model, app_version=app_version, model_version=model_version)
    try:
        outputs = execution.outputs
    except BackendError as exc:
        raise ModelArtifactNotFound(str(exc)) from exc
    model_object = wire_decode_value(outputs["model_object"], model)
    return ModelArtifact(model_object, outputs.get("hyperparameters"), outputs.get("metrics"))


def list_model_versions(model: "Model", app_version: Optional[str] = None, limit: int = 10) -> List[str]:
    """Training execution ids, newest first (``remote.py:283-305``)."""
    backend = model._remote
    return [
        e.id
        for e in backend.list_executions(
            workflow_name=model.train_workflow_name, app_version=app_version, only_successful=True, limit=limit
        )
    ]


def list_prediction_ids(model: "Model", app_version: Optional[str] = None, limit: int = 10) -> List[str]:
    """Batch-prediction execution ids, newest first (``remote.py:308-330``)."""
    backend = model._remote
    ids: List[str] = []
    for workflow_name in (model.predict_workflow_name, model.predict_from_features_workflow_name):
        ids.extend(
            e.id
            for e in backend.list_executions(
                workflow_name=workflow_name, app_version=app_version, only_successful=True, limit=limit
            )
        )
    return ids[:limit]


def get_scheduled_runs(
    backend: "LocalBackend", schedule_name: str, app_version: Optional[str] = None, limit: int = 5
) -> List["Execution"]:
    """``remote.py:333-350`` analogue."""
    return backend.list_scheduled_runs(schedule_name, app_version=app_version, limit=limit)
