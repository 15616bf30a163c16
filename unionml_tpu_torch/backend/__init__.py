"""Execution backend: the in-framework replacement for Flyte admin + propeller.

Port of ``unionml_tpu/backend/__init__.py`` (it imports no JAX; the port keeps
its own copy). Reference parity: the remote surface the reference gets from
``FlyteRemote`` (``unionml/model.py:967-981``, ``unionml/remote.py``) — app
deployment, workflow execution with versioned lineage, artifact queries,
schedule activation. The backend is a filesystem-rooted job store + executor:

- **Job specs carry GPU resources** (a GPU count and per-card memory, from
  :class:`unionml_tpu_torch.defaults.Resources`).
- **Workers rehydrate apps** exactly like the reference's task resolver
  (``unionml/task_resolver.py:16-31``): the job record stores
  ``(module, variable, workflow name)``; the worker imports the module and rebuilds the
  workflow (see :mod:`unionml_tpu_torch.backend.worker`).
- **Lineage**: every execution directory holds inputs/outputs/metadata; model versions
  are successful train-execution ids, newest first — the same query semantics as
  ``unionml/remote.py:200-330``.
- **Schedules** are driven by :class:`Scheduler`, an in-process cron loop using
  :func:`unionml_tpu_torch.schedule.next_fire_time`.
- **The wire format** of a training state (the port's ``TrainState`` or an
  ``nn.Module``) is the port's checkpoint format
  (:func:`unionml_tpu_torch.checkpoint.extract_state`: host tensors by
  parameter name) plus the hyperparameters its ``init`` rebuilds it from.

The root defaults to ``$UNIONML_TPU_HOME/backend`` (``~/.unionml-tpu``), the
JAX package's: both packages read one variable. Multi-host jobs
(``host_count > 1``) and the ``tpu-pod://`` targets raise
``NotImplementedError`` naming ROADMAP's M12 (parallelism): a job on several
hosts needs the process-group setup that item ports.
"""

import datetime
import json
import os
import pickle
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
from dataclasses import asdict, dataclass, is_dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.defaults import Resources
from unionml_tpu_torch.exceptions import BackendError
from unionml_tpu_torch.schedule import Schedule, next_fire_time

_STATUS_QUEUED = "QUEUED"
_STATUS_RUNNING = "RUNNING"
_STATUS_SUCCEEDED = "SUCCEEDED"
_STATUS_FAILED = "FAILED"


def default_backend_root() -> Path:
    return Path(os.getenv("UNIONML_TPU_HOME", Path.home() / ".unionml-tpu")) / "backend"


@dataclass
class JobSpec:
    """Serializable description of one workflow execution request.

    The resource block is the port's :class:`~unionml_tpu_torch.defaults.Resources`
    as a dict: cpu, memory, the GPU count and per-card memory, the host count.
    """

    app_module: str
    app_variable: str
    module_file: Optional[str]
    workflow_name: str
    app_version: str
    resources: Dict[str, Any]

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)


class Execution:
    """Handle to a (possibly running) workflow execution."""

    def __init__(self, execution_id: str, directory: Path, backend: "LocalBackend"):
        self.id = execution_id
        self.directory = directory
        self._backend = backend
        self._outputs: Optional[Dict[str, Any]] = None

    @property
    def metadata(self) -> Dict[str, Any]:
        with (self.directory / "meta.json").open() as f:
            return json.load(f)

    @property
    def status(self) -> str:
        status_file = self.directory / "status"
        return status_file.read_text().strip() if status_file.exists() else _STATUS_QUEUED

    @property
    def is_done(self) -> bool:
        return self.status in (_STATUS_SUCCEEDED, _STATUS_FAILED)

    @property
    def error(self) -> Optional[str]:
        err = self.directory / "error.txt"
        return err.read_text() if err.exists() else None

    @property
    def outputs(self) -> Dict[str, Any]:
        if self._outputs is None:
            if self.status != _STATUS_SUCCEEDED:
                raise BackendError(f"Execution {self.id} has no outputs (status={self.status}): {self.error}")
            with (self.directory / "outputs.pkl").open("rb") as f:
                self._outputs = pickle.load(f)
        return self._outputs

    def __repr__(self) -> str:
        return f"Execution(id={self.id!r}, status={self.status!r})"


class LocalBackend:
    """Filesystem-rooted execution backend running jobs in worker subprocesses.

    ``in_process=True`` skips the subprocess boundary (fast unit-test path);
    the default starts a worker (``python -m unionml_tpu_torch.backend.worker``)
    that re-imports the app module — the same process boundary a remote worker
    crosses.
    """

    def __init__(
        self,
        root: Optional[Path] = None,
        project: Optional[str] = None,
        domain: Optional[str] = None,
        in_process: bool = False,
        retries: int = 0,
    ):
        """
        :param retries: job-level retry budget — a failed/crashed worker is respawned
            up to this many times before the execution is reported FAILED (the
            failure-recovery obligation from SURVEY.md §5; the reference delegates
            retries to Flyte).
        """
        self.root = Path(root) if root is not None else default_backend_root()
        self.default_project = project or "default-project"
        self.default_domain = domain or "development"
        self.in_process = in_process
        self.retries = retries
        self._workers: Dict[str, subprocess.Popen] = {}
        self._owned: set = set()  # executions this client started (retry eligibility)
        self._base.mkdir(parents=True, exist_ok=True)

    # ---------------------------------------------------------------- layout

    @property
    def _base(self) -> Path:
        return self.root / self.default_project / self.default_domain

    @property
    def _executions_dir(self) -> Path:
        return self._base / "executions"

    @property
    def _apps_dir(self) -> Path:
        return self._base / "apps"

    @property
    def _schedules_dir(self) -> Path:
        return self._base / "schedules"

    # ---------------------------------------------------------------- deployment

    def create_project(self, project: Optional[str] = None) -> None:
        """``unionml/remote.py:38-43`` analogue."""
        if project:
            self.default_project = project
        self._base.mkdir(parents=True, exist_ok=True)

    def deploy_workflow(
        self,
        model: Any,
        workflow_name: str,
        app_version: str,
        patch: bool = False,
    ) -> None:
        """Register a workflow version: record the app's rehydration address + resources."""
        resources = model.resources or Resources()
        spec = JobSpec(
            app_module=model.instantiated_in or "__unknown__",
            app_variable=model.find_lhs(),
            module_file=model._module_file,
            workflow_name=workflow_name,
            app_version=app_version,
            resources=asdict(resources),
        )
        target = self._apps_dir / app_version
        target.mkdir(parents=True, exist_ok=True)
        with (target / f"{workflow_name}.json").open("w") as f:
            json.dump({**spec.to_json(), "patch": patch, "deployed_at": _now_iso()}, f, indent=2)
        logger.info("Deployed workflow %s at version %s", workflow_name, app_version)

    def list_app_versions(self) -> List[str]:
        if not self._apps_dir.exists():
            return []
        versions = [(p.stat().st_mtime, p.name) for p in self._apps_dir.iterdir() if p.is_dir()]
        return [name for _, name in sorted(versions, reverse=True)]

    def fetch_workflow_spec(self, workflow_name: str, app_version: Optional[str] = None) -> Dict[str, Any]:
        versions = [app_version] if app_version else self.list_app_versions()
        for version in versions:
            candidate = self._apps_dir / version / f"{workflow_name}.json"
            if candidate.exists():
                with candidate.open() as f:
                    return json.load(f)
        raise BackendError(
            f"Workflow {workflow_name!r} not deployed"
            + (f" at version {app_version!r}" if app_version else " at any version")
        )

    # ---------------------------------------------------------------- execution

    def execute(
        self,
        model: Any,
        workflow_name: str,
        inputs: Dict[str, Any],
        app_version: Optional[str] = None,
        schedule_name: Optional[str] = None,
    ) -> Execution:
        """Submit one workflow execution; returns immediately with a handle."""
        try:
            spec_json = self.fetch_workflow_spec(workflow_name, app_version)
        except BackendError:
            # undeployed local runs still execute (the reference requires deploy first;
            # we degrade gracefully using the in-memory model's address)
            spec_json = {
                "app_module": model.instantiated_in or "__unknown__",
                "app_variable": model.find_lhs(),
                "module_file": model._module_file,
                "workflow_name": workflow_name,
                "app_version": app_version or "dev",
                "resources": asdict(model.resources or Resources()),
            }

        if _host_count(spec_json.get("resources")) > 1:
            raise _multi_host()

        execution_id = "{}-{}-{}".format(
            workflow_name.replace(".", "-"),
            datetime.datetime.now().strftime("%Y%m%d%H%M%S"),
            uuid.uuid4().hex[:6],
        )
        exec_dir = self._executions_dir / execution_id
        exec_dir.mkdir(parents=True, exist_ok=True)

        with (exec_dir / "inputs.pkl").open("wb") as f:
            pickle.dump(_plain_inputs(inputs), f)
        meta = {
            "execution_id": execution_id,
            "workflow_name": spec_json["workflow_name"],
            "app_version": spec_json.get("app_version"),
            "app_module": spec_json["app_module"],
            "app_variable": spec_json["app_variable"],
            "module_file": spec_json.get("module_file"),
            "resources": spec_json.get("resources", {}),
            "schedule_name": schedule_name,
            "created_at": _now_iso(),
        }
        with (exec_dir / "meta.json").open("w") as f:
            json.dump(meta, f, indent=2)
        (exec_dir / "status").write_text(_STATUS_QUEUED)

        execution = Execution(execution_id, exec_dir, self)
        self._owned.add(execution_id)
        if self.in_process:
            self._run_in_process(execution, model)
        else:
            self._spawn_worker(execution)
        return execution

    def _run_in_process(self, execution: Execution, model: Any) -> None:
        from unionml_tpu_torch.backend.worker import run_workflow_for_model

        for attempt in range(1, self.retries + 2):
            (execution.directory / "attempts").write_text(str(attempt))
            (execution.directory / "status").write_text(_STATUS_RUNNING)
            try:
                with (execution.directory / "inputs.pkl").open("rb") as f:
                    inputs = pickle.load(f)
                outputs = run_workflow_for_model(model, execution.metadata["workflow_name"], inputs)
                with (execution.directory / "outputs.pkl").open("wb") as f:
                    pickle.dump(outputs, f)
                (execution.directory / "status").write_text(_STATUS_SUCCEEDED)
                return
            except Exception as exc:
                (execution.directory / "error.txt").write_text(repr(exc))
                (execution.directory / "status").write_text(_STATUS_FAILED)
                if attempt <= self.retries:
                    logger.warning(
                        "In-process execution %s failed (attempt %d/%d): retrying. Error: %r",
                        execution.id,
                        attempt,
                        self.retries + 1,
                        exc,
                    )
                else:
                    logger.exception("In-process execution %s failed", execution.id)

    def _spawn_worker(self, execution: Execution) -> None:
        """Start the worker entrypoint — the process/machine boundary (§3.2 call stack)."""
        if _host_count(execution.metadata.get("resources")) > 1:
            raise _multi_host()
        with (execution.directory / "worker.log").open("w") as log_file:
            process = subprocess.Popen(
                [sys.executable, "-m", "unionml_tpu_torch.backend.worker", str(execution.directory)],
                stdout=log_file,
                stderr=subprocess.STDOUT,
                cwd=os.getcwd(),
            )
        # keep the handles: poll() reaps children (no zombies) and detects crashes
        self._workers[execution.id] = [process]
        (execution.directory / "pid").write_text(str(process.pid))

    def _terminate_workers(self, execution_id: str, timeout: float = 5.0) -> None:
        """Kill every worker of an execution (before retries; on fleet failure)."""
        for process in self._workers.pop(execution_id, []):
            if process.poll() is None:
                process.terminate()
                try:
                    process.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    process.kill()
                    process.wait()

    def _reap_dead_worker(self, execution: Execution) -> None:
        """Failure detection: mark an execution FAILED if its worker died without a status.

        A worker OOM-killed or segfaulted (plausible under device memory pressure) never
        writes SUCCEEDED/FAILED; without this check ``wait`` would spin forever. Own
        children are poll()ed (which also reaps the zombie); foreign pids (another
        client waiting on the same store) are checked via /proc, treating zombie state
        as dead.
        """
        fleet = self._workers.get(execution.id)
        if fleet is not None:
            if all(process.poll() is None for process in fleet):
                return
            self._workers.pop(execution.id, None)  # exited: drop the handle
            dead = True
        else:
            pid_file = execution.directory / "pid"
            if not pid_file.exists():
                return
            try:
                pid = int(pid_file.read_text().strip())
            except ValueError:
                return
            dead = _pid_dead_or_zombie(pid)
        if dead and not execution.is_done:
            (execution.directory / "error.txt").write_text(
                "Worker process exited without reporting a status (killed or crashed)."
            )
            (execution.directory / "status").write_text(_STATUS_FAILED)

    def _attempts(self, execution: Execution) -> int:
        attempts_file = execution.directory / "attempts"
        return int(attempts_file.read_text()) if attempts_file.exists() else 1

    def _maybe_retry(self, execution: Execution) -> bool:
        """Respawn a failed worker while the retry budget lasts. True when retried.

        Only executions started by THIS client are eligible: ``wait`` on a historical
        FAILED execution is a status query and must never re-run the job.
        """
        if execution.id not in self._owned:
            return False
        attempts = self._attempts(execution)
        if attempts > self.retries:
            return False
        logger.warning(
            "Execution %s failed (attempt %d/%d): retrying. Error: %s",
            execution.id,
            attempts,
            self.retries + 1,
            execution.error,
        )
        self._terminate_workers(execution.id)  # no stale fleet racing the respawn
        (execution.directory / "attempts").write_text(str(attempts + 1))
        (execution.directory / "error.txt").unlink(missing_ok=True)
        (execution.directory / "status").write_text(_STATUS_QUEUED)
        execution._outputs = None
        self._spawn_worker(execution)
        return True

    def wait(self, execution: Execution, timeout: Optional[float] = None, poll_interval: float = 0.2) -> Execution:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            while not execution.is_done:
                self._reap_dead_worker(execution)
                if execution.is_done:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise BackendError(f"Timed out waiting for execution {execution.id}")
                time.sleep(poll_interval)
            if execution.status == _STATUS_FAILED and not self.in_process and self._maybe_retry(execution):
                continue
            break
        if execution.status == _STATUS_FAILED:
            raise BackendError(f"Execution {execution.id} failed: {execution.error}")
        return execution

    # ---------------------------------------------------------------- lineage queries

    def get_execution(self, execution_id: str) -> Execution:
        exec_dir = self._executions_dir / execution_id
        if not exec_dir.exists():
            raise BackendError(f"Execution {execution_id!r} not found")
        return Execution(execution_id, exec_dir, self)

    def list_executions(
        self,
        workflow_name: Optional[str] = None,
        app_version: Optional[str] = None,
        schedule_name: Optional[str] = None,
        only_successful: bool = True,
        limit: int = 10,
    ) -> List[Execution]:
        """Executions newest-first with the reference's filter semantics (``remote.py:200-269``)."""
        if not self._executions_dir.exists():
            return []
        candidates = sorted(self._executions_dir.iterdir(), key=lambda p: p.stat().st_mtime, reverse=True)
        results: List[Execution] = []
        for exec_dir in candidates:
            if len(results) >= limit:
                break
            execution = Execution(exec_dir.name, exec_dir, self)
            try:
                meta = execution.metadata
            except (OSError, json.JSONDecodeError):
                continue
            if workflow_name and meta.get("workflow_name") != workflow_name:
                continue
            if app_version and meta.get("app_version") != app_version:
                continue
            if schedule_name and meta.get("schedule_name") != schedule_name:
                continue
            if only_successful and execution.status != _STATUS_SUCCEEDED:
                continue
            results.append(execution)
        return results

    # ---------------------------------------------------------------- schedules

    def deploy_schedule(self, model: Any, schedule: Schedule, app_version: str) -> None:
        schedule.validate()
        self._schedules_dir.mkdir(parents=True, exist_ok=True)
        workflow_name = f"{model.name}.{'train' if schedule.workflow_kind == 'train' else 'predict'}"
        record = {
            "name": schedule.name,
            "workflow_name": workflow_name,
            "app_version": app_version,
            "expression": schedule.expression,
            "offset": schedule.offset,
            "fixed_rate_seconds": schedule.fixed_rate.total_seconds() if schedule.fixed_rate else None,
            "time_arg": schedule.time_arg,
            "active": False,
            "deployed_at": _now_iso(),
        }
        with (self._schedules_dir / f"{schedule.name}.json").open("w") as f:
            json.dump(record, f, indent=2)
        with (self._schedules_dir / f"{schedule.name}.inputs.pkl").open("wb") as f:
            pickle.dump(_plain_inputs(schedule.inputs or {}), f)

    def _set_schedule_active(self, name: str, active: bool) -> None:
        path = self._schedules_dir / f"{name}.json"
        if not path.exists():
            raise BackendError(f"Schedule {name!r} is not deployed")
        with path.open() as f:
            record = json.load(f)
        record["active"] = active
        with path.open("w") as f:
            json.dump(record, f, indent=2)

    def activate_schedule(self, model: Any, schedule: Schedule, app_version: Optional[str] = None) -> None:
        self._set_schedule_active(schedule.name, True)

    def deactivate_schedule(self, model: Any, schedule: Schedule, app_version: Optional[str] = None) -> None:
        self._set_schedule_active(schedule.name, False)

    def list_schedules(self) -> List[Dict[str, Any]]:
        if not self._schedules_dir.exists():
            return []
        records = []
        for path in sorted(self._schedules_dir.glob("*.json")):
            with path.open() as f:
                records.append(json.load(f))
        return records

    def list_scheduled_runs(self, schedule_name: str, app_version: Optional[str] = None, limit: int = 5):
        """``unionml/remote.py:333-350`` analogue: executions tagged with the schedule name."""
        return self.list_executions(
            schedule_name=schedule_name, app_version=app_version, only_successful=False, limit=limit
        )


class Scheduler:
    """In-process cron loop firing active schedules against a backend.

    The reference delegates this to Flyte's scheduler; here ``unionml-tpu-torch scheduler``
    (CLI) or ``Scheduler.start()`` runs it. Each fire creates a normal execution tagged
    with the schedule name so lineage queries work identically.
    """

    def __init__(self, backend: LocalBackend, poll_interval: float = 10.0):
        self.backend = backend
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_fire: Dict[str, datetime.datetime] = {}

    def tick(self, now: Optional[datetime.datetime] = None) -> List[Execution]:
        """Evaluate all active schedules once; fire those that are due. Returns fired executions."""
        now = now or datetime.datetime.now()
        fired: List[Execution] = []
        for record in self.backend.list_schedules():
            if not record.get("active"):
                self._next_fire.pop(record["name"], None)  # graftlint: disable=data-race -- tick() is driven either synchronously (CLI/tests) or by the single _loop thread, never both; start() hands the schedule state to the loop
                continue
            name = record["name"]
            schedule = Schedule(
                type="trainer" if record["workflow_name"].endswith(".train") else "predictor",
                name=name,
                expression=record.get("expression"),
                offset=record.get("offset"),
                fixed_rate=(
                    datetime.timedelta(seconds=record["fixed_rate_seconds"])
                    if record.get("fixed_rate_seconds")
                    else None
                ),
                time_arg=record.get("time_arg"),
            )
            if name not in self._next_fire:
                self._next_fire[name] = next_fire_time(schedule, now)
                continue
            if now >= self._next_fire[name]:
                fired.append(self._fire(record, schedule, now))
                self._next_fire[name] = next_fire_time(schedule, now)
        return fired

    def _fire(self, record: Dict[str, Any], schedule: Schedule, now: datetime.datetime) -> Execution:
        with (self.backend._schedules_dir / f"{record['name']}.inputs.pkl").open("rb") as f:
            inputs = pickle.load(f)
        if schedule.time_arg:
            inputs[schedule.time_arg] = now
        spec = self.backend.fetch_workflow_spec(record["workflow_name"], record.get("app_version"))
        from unionml_tpu_torch.tracker import load_tracked_instance

        model = load_tracked_instance(spec["app_module"], spec["app_variable"], spec.get("module_file"))
        logger.info("Schedule %s firing %s", record["name"], record["workflow_name"])
        return self.backend.execute(
            model,
            record["workflow_name"],
            inputs=inputs,
            app_version=record.get("app_version"),
            schedule_name=record["name"],
        )

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                logger.exception("Scheduler tick failed")
            self._stop.wait(self.poll_interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def backend_from_config(
    target: Optional[str] = None,
    config_file: Optional[str] = None,
    project: Optional[str] = None,
    domain: Optional[str] = None,
) -> LocalBackend:
    """Build a backend client from a target string / YAML config file.

    Config layering parity with ``Config.auto(config_file=...)`` (``model.py:972-974``):
    explicit args > config file > environment > defaults.
    """
    root: Optional[Path] = None
    in_process = False
    if config_file:
        import yaml

        with open(config_file) as f:
            config = yaml.safe_load(f) or {}
        backend_cfg = config.get("backend", config)
        root = Path(backend_cfg["root"]) if "root" in backend_cfg else None
        project = project or backend_cfg.get("project")
        domain = domain or backend_cfg.get("domain")
        in_process = bool(backend_cfg.get("in_process", False))
    if target:
        if target.startswith("tpu-pod://"):
            raise NotImplementedError(
                "the tpu-pod:// backend (a job store shared by the hosts of a pod) is not ported yet "
                "(ROADMAP: M12, the multi-host backend and store)"
            )
        if target.startswith("local://"):
            root = Path(target[len("local://") :]) if len(target) > len("local://") else None
        elif target not in ("local", "sandbox"):
            raise BackendError(
                f"Unknown backend target {target!r}; expected 'local', 'sandbox', "
                f"or 'local://<path>'"
            )
    return LocalBackend(root=root, project=project, domain=domain, in_process=in_process)


def _pid_dead_or_zombie(pid: int) -> bool:
    """True when ``pid`` no longer runs (gone, or a zombie awaiting reaping)."""
    if os.path.isdir("/proc"):
        try:
            with open(f"/proc/{pid}/stat") as f:
                # field 3 (after the parenthesized comm, which may contain spaces)
                state = f.read().rsplit(")", 1)[1].split()[0]
            return state == "Z"
        except (FileNotFoundError, ProcessLookupError, IndexError):
            return True
        except OSError:  # pragma: no cover - unreadable entry: assume alive
            return False
    # no procfs (macOS/BSD): signal-0 probe — cannot see zombies, but those only
    # arise for our own children, which are handled via Popen.poll()
    try:
        os.kill(pid, 0)
        return False
    except ProcessLookupError:
        return True
    except PermissionError:  # pragma: no cover - alive, owned elsewhere
        return False


_STATE_MARKER = "__unionml_state_dict__"


def _host_count(resources: Optional[Dict[str, Any]]) -> int:
    return int((resources or {}).get("host_count", 1) or 1)


def _multi_host() -> NotImplementedError:
    return NotImplementedError(
        "multi-host jobs (host_count > 1) are not ported yet (ROADMAP: M12, the multi-host backend and store)"
    )


def _is_model_state(value: Any) -> bool:
    """A training state or a module: sent in the checkpoint format, never pickled."""
    from torch import nn

    from unionml_tpu_torch.checkpoint import _is_train_state

    return _is_train_state(value) or isinstance(value, nn.Module)


def wire_encode_value(value: Any, hyperparameters: Any = None) -> Any:
    """Encode one value for cross-process transport.

    Three tiers (the type-engine replacement — SURVEY.md §7 "hard parts"):

    1. synthesized kwargs dataclasses -> plain dicts (their types don't exist in a
       fresh process);
    2. a training state (the port's ``TrainState``) or an ``nn.Module``, and any
       other unpicklable value -> the checkpoint format of
       :func:`unionml_tpu_torch.checkpoint.extract_state` (host tensors by
       parameter name) + the hyperparameters needed to rebuild the structure via
       the app's ``init`` on the other side;
    3. other picklable values pass through.
    """
    if is_dataclass(value) and not isinstance(value, type) and hasattr(type(value), "from_dict"):
        # synthesized kwargs/hyperparameter dataclasses: plain-dict wire format
        return asdict(value)

    def state_encode():
        from unionml_tpu_torch.checkpoint import extract_state

        hp = asdict(hyperparameters) if is_dataclass(hyperparameters) else hyperparameters
        if hp is None:
            logger.warning(
                "Encoding a non-picklable model object without hyperparameters; the "
                "receiving side rebuilds its structure via init() defaults."
            )
        return {_STATE_MARKER: extract_state(value), "hyperparameters": hp}

    if _is_model_state(value):
        return state_encode()
    # scalars / arrays / strings are trivially picklable: skip the probe entirely
    if value is None or isinstance(value, (bool, int, float, str, bytes, np.ndarray, np.generic)):
        return value
    try:
        pickle.dumps(value)
        return value
    except Exception:  # graftlint: disable=swallowed-exception -- a picklability PROBE: any failure routes the value to state_encode(), which is the handling
        return state_encode()


def wire_decode_value(value: Any, model: Any) -> Any:
    """Rebuild a state-dict-encoded model object using the app's init slot."""
    if isinstance(value, dict) and _STATE_MARKER in value:
        from unionml_tpu_torch.checkpoint import restore_state

        target = model._init_model_object(value.get("hyperparameters") or {})
        return restore_state(target, value[_STATE_MARKER])
    return value


def _plain_inputs(inputs: Dict[str, Any], hyperparameters: Any = None) -> Dict[str, Any]:
    """Encode every entry of an inputs/outputs mapping for transport."""
    hp = hyperparameters if hyperparameters is not None else inputs.get("hyperparameters")
    return {key: wire_encode_value(value, hp) for key, value in inputs.items()}


def _now_iso() -> str:
    return datetime.datetime.now().isoformat(timespec="seconds")
