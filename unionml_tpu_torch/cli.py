"""Command-line interface of the port: ``unionml-tpu-torch`` (click-based).

Port of ``unionml_tpu/cli.py``: the same fifteen commands with the same
arguments, options, defaults, messages and JSON output (``init``,
``templates``, ``deploy``, ``activate-schedules``, ``deactivate-schedules``,
``train``, ``predict``, ``list-model-versions``, ``list-prediction-ids``,
``list-scheduled-training-runs``, ``list-scheduled-prediction-runs``,
``fetch-model``, ``fetch-predictions``, ``serve``, ``scheduler``), over the
port's models, backend and serving.

Each command's body is a plain function of this module that returns what the
command prints (:func:`train`, :func:`predict`, ...), so a caller without
``click`` drives the same code; a usage error raises :class:`BadParameter` or
:class:`CommandError`, which the click group turns into click's own. ``click``
is imported only where the group is built (:func:`build_cli`): importing this
module needs neither ``click`` nor ``aiohttp``, and :func:`main` exits with
code 1 and a message naming ``click`` when it is missing. ``serve`` splits in
two: :func:`serve_kwargs` resolves the model and the keyword arguments of
``serving_app`` (replicas, telemetry, the trace journal, and the app
module's ``generator`` factory when it defines one, which enables
``/generate``), and :func:`serve` then builds the aiohttp app and runs it.

Note: the reference's deactivate command calls ``remote_activate_schedules``
(``cli.py:124`` — an upstream bug); this implementation deactivates.
"""

import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

from unionml_tpu_torch._logging import logger


class CommandError(Exception):
    """A command failed in a way its user can fix (click's ``ClickException``)."""


class BadParameter(CommandError):
    """An option's value is invalid (click's ``BadParameter``)."""


def _load_model(app: str):
    from unionml_tpu_torch.remote import get_model

    return get_model(app)


def _parse_json_opt(value: Optional[str], flag: str) -> dict:
    if not value:
        return {}
    try:
        return json.loads(value)
    except json.JSONDecodeError as exc:
        raise BadParameter(f"{flag} must be valid JSON: {exc}") from exc


# ---------------------------------------------------------------------- the commands' bodies


def init(app_name: str, template: str = "basic") -> str:
    """Initialize a unionml-tpu project from a template."""
    from unionml_tpu_torch.templates import list_templates, render_template

    if template not in list_templates():
        raise BadParameter(f"unknown template {template!r}; available: {', '.join(list_templates())}")
    try:
        target = render_template(template, app_name, Path.cwd())
    except (ValueError, FileExistsError) as exc:
        raise CommandError(str(exc)) from exc
    return f"Created {target} from template {template!r}"


def templates() -> str:
    """List available project templates."""
    from unionml_tpu_torch.templates import list_templates, template_description

    return "\n".join(f"{name:20s} {template_description(name)}" for name in list_templates())


def deploy(app: str, allow_uncommitted: bool = False, patch: bool = False, schedule: bool = True,
           app_version: Optional[str] = None) -> str:
    """Deploy a model app's workflows (and schedules) to the execution backend."""
    model = _load_model(app)
    version = model.remote_deploy(
        app_version=app_version, allow_uncommitted=allow_uncommitted, patch=patch, schedule=schedule
    )
    return f"Deployed app version {version}"


def activate_schedules(app: str, app_version: Optional[str] = None, schedule_names: Sequence[str] = ()) -> str:
    """Activate deployed schedules."""
    model = _load_model(app)
    model.remote_activate_schedules(app_version=app_version, schedule_names=list(schedule_names) or None)
    return ""


def deactivate_schedules(app: str, app_version: Optional[str] = None, schedule_names: Sequence[str] = ()) -> str:
    """Deactivate deployed schedules."""
    model = _load_model(app)
    model.remote_deactivate_schedules(app_version=app_version, schedule_names=list(schedule_names) or None)
    return ""


def train(app: str, inputs: Optional[str] = None, app_version: Optional[str] = None, local: bool = False,
          wait: bool = False, profile_dir: Optional[str] = None) -> str:
    """Run a training job (remote by default, local with ``local``)."""
    model = _load_model(app)
    parsed = _parse_json_opt(inputs, "--inputs")
    if local:
        if profile_dir:
            from unionml_tpu_torch.profiling import workflow_timings, xprof_trace

            with xprof_trace(profile_dir):
                _, metrics = model.train(**parsed)
            timings = workflow_timings(model.train_workflow())
            return json.dumps({"metrics": metrics, "stage_timings_s": timings}, default=str)
        _, metrics = model.train(**parsed)
        return json.dumps({"metrics": metrics}, default=str)
    result = model.remote_train(app_version=app_version, wait=wait, **parsed)
    if wait:
        return json.dumps({"metrics": result.metrics}, default=str)
    return f"Launched execution {result.id}"


def predict(app: str, inputs: Optional[str] = None, features: Optional[Path] = None,
            app_version: Optional[str] = None, model_version: Optional[str] = None, local: bool = False,
            model_path: Optional[Path] = None, wait: bool = False) -> str:
    """Generate predictions from reader inputs or raw features."""
    model = _load_model(app)
    parsed_inputs = _parse_json_opt(inputs, "--inputs")
    feature_payload = None
    if features is not None:
        feature_payload = json.loads(Path(features).read_text())

    if local:
        if model_path is not None:
            model.load(model_path)
        predictions = model.predict(features=feature_payload, **parsed_inputs)
    else:
        result = model.remote_predict(
            app_version=app_version,
            model_version=model_version,
            wait=wait,
            features=feature_payload,
            **parsed_inputs,
        )
        if not wait:
            return f"Launched execution {result.id}"
        predictions = result
    from unionml_tpu_torch.serving.app import jsonable

    return json.dumps(jsonable(predictions), default=str)


def list_model_versions(app: str, app_version: Optional[str] = None, limit: int = 10) -> str:
    """List model versions (training execution ids), newest first."""
    model = _load_model(app)
    return "\n".join(model.remote_list_model_versions(app_version=app_version, limit=limit))


def list_prediction_ids(app: str, app_version: Optional[str] = None, limit: int = 10) -> str:
    """List batch prediction ids, newest first."""
    model = _load_model(app)
    return "\n".join(model.remote_list_prediction_ids(app_version=app_version, limit=limit))


def list_scheduled_training_runs(app: str, schedule_name: str, app_version: Optional[str] = None,
                                 limit: int = 5) -> str:
    model = _load_model(app)
    runs = model.remote_list_scheduled_training_runs(schedule_name, app_version=app_version, limit=limit)
    return "\n".join(f"{execution.id}\t{execution.status}" for execution in runs)


def list_scheduled_prediction_runs(app: str, schedule_name: str, app_version: Optional[str] = None,
                                   limit: int = 5) -> str:
    model = _load_model(app)
    runs = model.remote_list_scheduled_prediction_runs(schedule_name, app_version=app_version, limit=limit)
    return "\n".join(f"{execution.id}\t{execution.status}" for execution in runs)


def fetch_model(app: str, output_file: Path, app_version: Optional[str] = None, model_version: str = "latest",
                kwargs: Optional[str] = None) -> str:
    """Fetch a trained model from backend lineage and save it locally."""
    from unionml_tpu_torch.remote import get_model_artifact

    model = _load_model(app)
    model.artifact = get_model_artifact(model, app_version=app_version, model_version=model_version)
    model.save(output_file, **_parse_json_opt(kwargs, "--kwargs"))
    return f"Saved model to {output_file}"


def fetch_predictions(app: str, output_file: Path, app_version: Optional[str] = None,
                      prediction_id: str = "latest") -> str:
    """Fetch batch predictions from backend lineage and write them as JSON."""
    model = _load_model(app)
    backend = model._remote
    if prediction_id == "latest":
        ids = model.remote_list_prediction_ids(app_version=app_version, limit=1)
        if not ids:
            raise CommandError("No predictions found.")
        prediction_id = ids[0]
    execution = backend.get_execution(prediction_id)
    predictions = model.remote_fetch_predictions(execution)
    Path(output_file).write_text(json.dumps(predictions, default=str))
    return f"Saved predictions to {output_file}"


def serve_kwargs(app: str, model_path: Optional[Path] = None, remote: bool = False,
                 app_version: Optional[str] = None, model_version: str = "latest", replicas: int = 1,
                 telemetry: bool = True, trace_journal: Optional[Path] = None) -> Tuple[Any, Dict[str, Any]]:
    """The model of ``app`` and the keyword arguments ``serve`` builds its app with:
    ``serving_app(model, **kwargs)``. ``model_path`` lands in ``UNIONML_MODEL_PATH``;
    a module-level ``generator`` factory of the app's module (a ``DecodeEngine``,
    or a callable returning one, taking ``replica=`` when ``replicas > 1``)
    enables ``/generate``."""
    if model_path is not None:
        os.environ["UNIONML_MODEL_PATH"] = str(model_path)
    if replicas < 1:
        raise BadParameter("--replicas must be >= 1")
    model = _load_model(app)
    kwargs: Dict[str, Any] = {"remote": remote, "app_version": app_version, "model_version": model_version}
    generator = getattr(sys.modules.get(model.instantiated_in or ""), "generator", None)
    if generator is not None:
        kwargs["generator"] = generator
    if replicas > 1:
        kwargs["generate_replicas"] = replicas
    if trace_journal is not None:
        telemetry = True
        kwargs["generate_trace_journal"] = str(trace_journal)
    kwargs["generate_telemetry"] = telemetry
    return model, kwargs


def serve(app: str, model_path: Optional[Path] = None, host: str = "127.0.0.1", port: int = 8000,
          remote: bool = False, app_version: Optional[str] = None, model_version: str = "latest",
          replicas: int = 1, telemetry: bool = True, trace_journal: Optional[Path] = None) -> str:
    """Serve the model over HTTP with a resident predictor (blocks until stopped)."""
    model, kwargs = serve_kwargs(app, model_path, remote, app_version, model_version, replicas, telemetry,
                                 trace_journal)
    from unionml_tpu_torch.serving import run_app, serving_app

    http_app = serving_app(model, **kwargs)
    logger.info("Serving %s on %s:%d (replicas=%d)", app, host, port, replicas)
    run_app(http_app, host=host, port=port)
    return ""


def scheduler(app: Optional[str] = None, poll_interval: float = 10.0) -> str:
    """Run the schedule executor loop (fires active cron / fixed-rate jobs) until interrupted."""
    from unionml_tpu_torch.backend import Scheduler, backend_from_config

    backend = _load_model(app)._remote if app else backend_from_config()
    runner = Scheduler(backend, poll_interval=poll_interval)
    try:
        runner.start()
        runner._thread.join()
    except KeyboardInterrupt:
        runner.stop()
    return ""


# ---------------------------------------------------------------------- the click group


def build_cli():
    """The ``unionml-tpu-torch`` click group over the functions above."""
    import click

    def run(body, *args: Any, **kwargs: Any) -> None:
        try:
            out = body(*args, **kwargs)
        except BadParameter as exc:
            raise click.BadParameter(str(exc)) from exc
        except CommandError as exc:
            raise click.ClickException(str(exc)) from exc
        if out:
            click.echo(out)

    @click.group(name="unionml-tpu-torch")
    def cli() -> None:
        """unionml-tpu-torch: model training, serving, and deployment on CUDA."""

    @cli.command("init")
    @click.argument("app_name")
    @click.option("--template", "-t", default="basic", show_default=True,
                  help="Project template (see `unionml-tpu-torch templates`).")
    def init_cmd(app_name: str, template: str) -> None:
        """Initialize a unionml-tpu project from a template."""
        run(init, app_name, template)

    @cli.command("templates")
    def templates_cmd() -> None:
        """List available project templates."""
        run(templates)

    @cli.command("deploy")
    @click.argument("app")
    @click.option("--allow-uncommitted", is_flag=True, help="Deploy even with uncommitted changes.")
    @click.option("--patch", is_flag=True, help="Code-only fast re-registration (no version bump of deps).")
    @click.option("--schedule/--no-schedule", default=True, show_default=True, help="Deploy registered schedules.")
    @click.option("--app-version", "-v", default=None, help="Explicit app version (default: git sha).")
    def deploy_cmd(app: str, allow_uncommitted: bool, patch: bool, schedule: bool, app_version: Optional[str]) -> None:
        """Deploy a model app's workflows (and schedules) to the execution backend."""
        run(deploy, app, allow_uncommitted, patch, schedule, app_version)

    @cli.command("activate-schedules")
    @click.argument("app")
    @click.option("--app-version", "-v", default=None)
    @click.option("--name", "-n", "schedule_names", multiple=True, help="Schedule names (default: all).")
    def activate_schedules_cmd(app: str, app_version: Optional[str], schedule_names) -> None:
        """Activate deployed schedules."""
        run(activate_schedules, app, app_version, schedule_names)

    @cli.command("deactivate-schedules")
    @click.argument("app")
    @click.option("--app-version", "-v", default=None)
    @click.option("--name", "-n", "schedule_names", multiple=True, help="Schedule names (default: all).")
    def deactivate_schedules_cmd(app: str, app_version: Optional[str], schedule_names) -> None:
        """Deactivate deployed schedules."""
        run(deactivate_schedules, app, app_version, schedule_names)

    @cli.command("train")
    @click.argument("app")
    @click.option("--inputs", "-i", default=None, help="JSON dict of training workflow inputs.")
    @click.option("--app-version", "-v", default=None)
    @click.option("--local", is_flag=True, help="Train locally in-process instead of on the backend.")
    @click.option("--wait", "-w", is_flag=True, help="Wait for the remote execution to complete.")
    @click.option("--profile-dir", default=None,
                  help="Capture a torch.profiler trace + stage timings into this directory (local mode).")
    def train_cmd(app: str, inputs: Optional[str], app_version: Optional[str], local: bool, wait: bool,
                  profile_dir: Optional[str]) -> None:
        """Run a training job (remote by default, local with --local)."""
        run(train, app, inputs, app_version, local, wait, profile_dir)

    @cli.command("predict")
    @click.argument("app")
    @click.option("--inputs", "-i", default=None, help="JSON dict of reader inputs.")
    @click.option("--features", "-f", default=None, type=click.Path(exists=True, path_type=Path),
                  help="JSON feature file.")
    @click.option("--app-version", "-v", default=None)
    @click.option("--model-version", "-m", default=None)
    @click.option("--local", is_flag=True, help="Predict locally (requires a trained/loaded artifact or --model-path).")
    @click.option("--model-path", default=None, type=click.Path(exists=True, path_type=Path),
                  help="Local model file for --local.")
    @click.option("--wait", "-w", is_flag=True)
    def predict_cmd(app: str, inputs: Optional[str], features: Optional[Path], app_version: Optional[str],
                    model_version: Optional[str], local: bool, model_path: Optional[Path], wait: bool) -> None:
        """Generate predictions from reader inputs or raw features."""
        run(predict, app, inputs, features, app_version, model_version, local, model_path, wait)

    @cli.command("list-model-versions")
    @click.argument("app")
    @click.option("--app-version", "-v", default=None)
    @click.option("--limit", default=10, show_default=True)
    def list_model_versions_cmd(app: str, app_version: Optional[str], limit: int) -> None:
        """List model versions (training execution ids), newest first."""
        run(list_model_versions, app, app_version, limit)

    @cli.command("list-prediction-ids")
    @click.argument("app")
    @click.option("--app-version", "-v", default=None)
    @click.option("--limit", default=10, show_default=True)
    def list_prediction_ids_cmd(app: str, app_version: Optional[str], limit: int) -> None:
        """List batch prediction ids, newest first."""
        run(list_prediction_ids, app, app_version, limit)

    @cli.command("list-scheduled-training-runs")
    @click.argument("app")
    @click.argument("schedule_name")
    @click.option("--app-version", "-v", default=None)
    @click.option("--limit", default=5, show_default=True)
    def list_scheduled_training_runs_cmd(app: str, schedule_name: str, app_version: Optional[str],
                                         limit: int) -> None:
        run(list_scheduled_training_runs, app, schedule_name, app_version, limit)

    @cli.command("list-scheduled-prediction-runs")
    @click.argument("app")
    @click.argument("schedule_name")
    @click.option("--app-version", "-v", default=None)
    @click.option("--limit", default=5, show_default=True)
    def list_scheduled_prediction_runs_cmd(app: str, schedule_name: str, app_version: Optional[str],
                                           limit: int) -> None:
        run(list_scheduled_prediction_runs, app, schedule_name, app_version, limit)

    @cli.command("fetch-model")
    @click.argument("app")
    @click.option("--app-version", "-v", default=None)
    @click.option("--model-version", "-m", default="latest", show_default=True)
    @click.option("--output-file", "-o", required=True, type=click.Path(path_type=Path))
    @click.option("--kwargs", default=None, help="JSON kwargs forwarded to model.save.")
    def fetch_model_cmd(app: str, app_version: Optional[str], model_version: str, output_file: Path,
                        kwargs: Optional[str]) -> None:
        """Fetch a trained model from backend lineage and save it locally."""
        run(fetch_model, app, output_file, app_version, model_version, kwargs)

    @cli.command("fetch-predictions")
    @click.argument("app")
    @click.option("--app-version", "-v", default=None)
    @click.option("--prediction-id", "-p", default="latest", show_default=True)
    @click.option("--output-file", "-o", required=True, type=click.Path(path_type=Path))
    def fetch_predictions_cmd(app: str, app_version: Optional[str], prediction_id: str, output_file: Path) -> None:
        """Fetch batch predictions from backend lineage and write them as JSON."""
        run(fetch_predictions, app, output_file, app_version, prediction_id)

    @cli.command("serve")
    @click.argument("app")
    @click.option("--model-path", default=None, type=click.Path(exists=True, path_type=Path))
    @click.option("--host", default="127.0.0.1", show_default=True)
    @click.option("--port", default=8000, show_default=True)
    @click.option("--remote", is_flag=True, help="Load the model from backend lineage instead of a file.")
    @click.option("--app-version", "-v", default=None)
    @click.option("--model-version", "-m", default="latest", show_default=True)
    @click.option("--replicas", default=1, show_default=True,
                  help="Generation engine replicas behind the fleet router (requires the app module to define a "
                  "`generator` factory; >1 enables /generate session routing and failover).")
    @click.option("--telemetry/--no-telemetry", "telemetry", default=True, show_default=True,
                  help="Per-request span tracing + the Prometheus /metrics, /trace/{request_id}, and "
                  "/traces/recent endpoints on the generation path (off: the request path pays one host "
                  "branch per hook and nothing else).")
    @click.option("--trace-journal", default=None, type=click.Path(path_type=Path),
                  help="Append completed request traces to this JSONL file (schema v1; the replay-simulator "
                  "input). Implies --telemetry.")
    def serve_cmd(app: str, model_path: Optional[Path], host: str, port: int, remote: bool,
                  app_version: Optional[str], model_version: str, replicas: int, telemetry: bool,
                  trace_journal: Optional[Path]) -> None:
        """Serve the model over HTTP with a resident predictor."""
        run(serve, app, model_path, host, port, remote, app_version, model_version, replicas, telemetry,
            trace_journal)

    @cli.command("scheduler")
    @click.argument("app", required=False)
    @click.option("--poll-interval", default=10.0, show_default=True, help="Seconds between schedule evaluations.")
    def scheduler_cmd(app: Optional[str], poll_interval: float) -> None:
        """Run the schedule executor loop (fires active cron / fixed-rate jobs)."""
        click.echo("Scheduler running; Ctrl-C to stop.")
        run(scheduler, app, poll_interval)

    return cli


def main() -> None:
    try:
        cli = build_cli()
    except ImportError as exc:
        if exc.name != "click":
            raise
        print("unionml-tpu-torch: the command line needs the click package (pip install click); "
              "the commands' bodies are the functions of unionml_tpu_torch.cli", file=sys.stderr)
        raise SystemExit(1) from exc
    cli(prog_name="unionml-tpu-torch")


if __name__ == "__main__":
    main()
