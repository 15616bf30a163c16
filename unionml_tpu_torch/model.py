"""Model: declarative spec for training, evaluation, prediction, and serving.

Port of ``unionml_tpu/model.py``: the same decorator slots (``trainer``,
``predictor``, ``evaluator`` required; ``init``/``saver``/``loader``
defaulted), task and workflow factories, local ``train``/``predict``,
persistence (``save``/``load``/``load_from_env``), ``resolve_model_artifact``
and ``serve``.

- ``trainer``/``predictor``/``evaluator`` are wrapped as
  :class:`~unionml_tpu_torch.stage.TracedFunction` — a CUDA graph per call
  signature when their inputs are tensors (the predictor and evaluator by
  default, ``jit="auto"``; the trainer only with ``jit=True``), eager for
  opaque model objects (sklearn).
- default persistence understands the port's ``TrainState``, ``nn.Module``s
  and tensor dicts (see :mod:`unionml_tpu_torch.checkpoint`).
- the schedule and remote-deployment surface is not ported yet: each of its
  methods raises ``NotImplementedError`` naming ROADMAP's M14.
"""

import inspect
import os
from collections import OrderedDict
from dataclasses import asdict, field, is_dataclass
from inspect import Parameter, signature
from pathlib import Path
from typing import IO, Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Type, Union, get_origin

from unionml_tpu_torch import type_guards
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.dataset import Dataset, is_dataframe_type
from unionml_tpu_torch.defaults import DEFAULT_RESOURCES, Resources
from unionml_tpu_torch.exceptions import ModelArtifactNotFound
from unionml_tpu_torch.stage import Stage, TracedFunction, _scalarize, stage
from unionml_tpu_torch.tracker import TrackedInstance
from unionml_tpu_torch.utils import make_json_dataclass
from unionml_tpu_torch.workflow import Workflow

_EMPTY = Parameter.empty


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: M14, the deploy surface)")


class BaseHyperparameters:
    """Base class for synthesized hyperparameter dataclasses (``model.py:35-43``)."""


class ModelArtifact(NamedTuple):
    """A trained model object plus the hyperparameters and metrics that produced it."""

    model_object: Any
    hyperparameters: Optional[Union[BaseHyperparameters, dict]] = None
    metrics: Optional[Dict[str, float]] = None


class Model(TrackedInstance):
    """Specification of a trainable, servable, deployable model."""

    def __init__(
        self,
        name: str = "model",
        init: Union[Type, Callable, None] = None,
        *,
        dataset: Dataset,
        hyperparameter_config: Optional[Dict[str, Type]] = None,
    ):
        super().__init__()
        self.name = name
        self._init_callable = init
        self._hyperparameter_config = hyperparameter_config
        self._dataset = dataset
        self._artifact: Optional[ModelArtifact] = None

        self._init: Callable = self._default_init
        self._saver: Callable = self._default_saver
        self._loader: Callable = self._default_loader
        self._trainer: Optional[Callable] = None
        self._predictor: Optional[Callable] = None
        self._evaluator: Optional[Callable] = None

        self._resources: Optional[Resources] = None

        if self._dataset.name is None:
            self._dataset.name = f"{self.name}.dataset"

        self._train_stage: Optional[Stage] = None
        self._predict_stage: Optional[Stage] = None
        self._predict_from_features_stage: Optional[Stage] = None
        self._predict_callbacks: Tuple[Callable, ...] = ()

        self._train_stage_kwargs: Optional[Dict[str, Any]] = None
        self._predict_stage_kwargs: Optional[Dict[str, Any]] = None

        self._hyperparameter_type: Optional[Type] = None

    # ------------------------------------------------------------------ properties

    @property
    def artifact(self) -> Optional[ModelArtifact]:
        """The in-memory model artifact (set by train/load/remote_load)."""
        return self._artifact

    @artifact.setter
    def artifact(self, new_value: ModelArtifact) -> None:
        self._artifact = new_value

    @property
    def dataset(self) -> Dataset:
        return self._dataset

    @property
    def predict_callbacks(self) -> Tuple[Callable, ...]:
        return self._predict_callbacks

    @predict_callbacks.setter
    def predict_callbacks(self, callbacks) -> None:
        if self._predict_callbacks:
            raise ValueError("Predict callbacks can only be set once on a model.")
        self._predict_callbacks = tuple(callbacks)

    @property
    def hyperparameter_type(self) -> Type:
        """Synthesize the hyperparameter dataclass type (``model.py:169-204``).

        Resolution order: explicit ``hyperparameter_config`` > single dict-annotated init
        argument > partially annotated signature (defaults fill types) > fully annotated
        signature.
        """
        if self._hyperparameter_type is None:
            self._hyperparameter_type = self._synthesize_hyperparameter_type(self._hyperparameter_config)
        return self._hyperparameter_type

    def _synthesize_hyperparameter_type(self, config: Optional[Dict[str, Any]]) -> Type:
        """Pure derivation of the hyperparameter type from an explicit config or the init
        signature — no instance state is read besides the init slots, none is written.
        (Thread-safety: ``train``/``remote_train`` call this with an ad-hoc config instead
        of temporarily mutating ``_hyperparameter_config``.)
        """
        init_fn = self._init_callable if self._init == self._default_init else self._init
        init_fn = init_fn or self._init_callable
        sig_params = [] if init_fn is None else [*signature(init_fn).parameters.values()]
        # drop a leading `self`-like hyperparameters param when init is the default bound method
        specs: List[Any] = []

        if config is not None:
            for hname, htype in config.items():
                specs.append((hname, htype))
        elif len(sig_params) == 1 and sig_params[0].annotation is dict:
            return dict
        elif any(p.annotation is _EMPTY for p in sig_params):
            for param in sig_params:
                if param.annotation is not _EMPTY:
                    htype: Any = param.annotation
                elif param.default is not None and param.default is not _EMPTY:
                    htype = type(param.default)
                else:
                    htype = Optional[Any]
                default = None if param.default is _EMPTY else param.default
                specs.append((param.name, htype, field(default=default)))
        else:
            for param in sig_params:
                default = None if param.default is _EMPTY else param.default
                specs.append((param.name, param.annotation, field(default=default)))

        return make_json_dataclass("Hyperparameters", specs, bases=(BaseHyperparameters,))

    def _resolve_hyperparameter_type(self, hyperparameters: Any) -> Type:
        """The type to wrap ``hyperparameters`` in for one call: the declared/synthesized
        type when a config or annotated init exists, else a type inferred from the ad-hoc
        dict — derived without mutating shared state (safe under concurrent train/serve).
        """
        if isinstance(hyperparameters, dict) and self._hyperparameter_config is None and hyperparameters:
            return self._synthesize_hyperparameter_type({k: type(v) for k, v in hyperparameters.items()})
        return self.hyperparameter_type

    @property
    def model_type(self) -> Optional[Type]:
        """The model-object type implied by the init slot (``model.py:1420-1423``)."""
        init = self._init_callable if self._init == self._default_init else (self._init or self._init_callable)
        if init is None:
            return None
        if inspect.isclass(init):
            return init
        annotation = signature(init).return_annotation
        return None if annotation is _EMPTY else annotation

    @property
    def prediction_type(self) -> Type:
        return signature(self._predictor).return_annotation

    @property
    def train_workflow_name(self) -> str:
        return f"{self.name}.train"

    @property
    def predict_workflow_name(self) -> str:
        return f"{self.name}.predict"

    @property
    def predict_from_features_workflow_name(self) -> str:
        return f"{self.name}.predict_from_features"

    @property
    def resources(self) -> Optional[Resources]:
        """GPU resources requested for deployed jobs (none until M14 ports deployment)."""
        return self._resources

    # ------------------------------------------------------------------ decorators

    def init(self, fn: Callable) -> Callable:
        """Register a function that creates a model object from hyperparameters."""
        self._init = fn
        return fn

    def _expected_parser_types(self) -> Tuple[Any, ...]:
        """Expected positional data types for trainer/evaluator (``model.py:276-287``).

        With ``device_format="torch"`` parsed splits arrive as tensors, so
        trainer/evaluator data arguments are ``torch.Tensor`` typed.
        """
        default_parser = self._dataset._parser == self._dataset._default_parser
        if default_parser:
            data_type = self._dataset.dataset_datatype["data"]
            # the default parser splits DataFrames AND dict datasets into (features, targets)
            splits_two = is_dataframe_type(data_type) or data_type is dict or get_origin(data_type) is dict
            expected = (data_type, data_type) if splits_two else (data_type,)
        else:
            expected = self._dataset.parser_return_types

        if self._dataset._device_format == "torch":
            import torch

            return (torch.Tensor,) * len(expected)
        return expected

    def trainer(
        self,
        fn: Optional[Callable] = None,
        *,
        jit: Union[bool, str] = False,
        static_argnames: Tuple[str, ...] = (),
        donate_argnums: Tuple[int, ...] = (),
        **train_stage_kwargs,
    ):
        """Register the training function.

        ``jit=True`` captures the whole trainer as a CUDA graph (a trainer whose
        loop never syncs the host); the default runs the trainer eagerly, as the
        JAX package does. ``donate_argnums`` is the JAX package's buffer donation,
        which a CUDA graph has no counterpart for: it must stay empty.
        """
        if fn is None:
            return lambda f: self.trainer(
                f, jit=jit, static_argnames=static_argnames, donate_argnums=donate_argnums, **train_stage_kwargs
            )
        if donate_argnums:
            raise ValueError("donate_argnums (JAX buffer donation) has no counterpart in the port; leave it empty")

        type_guards.guard_trainer(fn, self.model_type, self._expected_parser_types())
        self._trainer = TracedFunction(fn, jit=jit, static_argnames=static_argnames) if jit else fn
        self._train_stage_kwargs = {"requests": DEFAULT_RESOURCES, "limits": DEFAULT_RESOURCES, **train_stage_kwargs}
        self._train_stage = None

        if not hasattr(fn, "__unionml_model__"):
            fn.__unionml_model__ = self  # type: ignore[attr-defined]
        return fn

    def predictor(
        self,
        fn: Optional[Callable] = None,
        *,
        callbacks: Optional[List[Callable]] = None,
        jit: Union[bool, str] = "auto",
        static_argnames: Tuple[str, ...] = (),
        **predict_stage_kwargs,
    ):
        """Register the prediction function; captured as CUDA graphs by default when it can be."""
        if fn is None:
            return lambda f: self.predictor(
                f, callbacks=callbacks, jit=jit, static_argnames=static_argnames, **predict_stage_kwargs
            )

        type_guards.guard_predictor(fn, self.model_type, self._dataset.feature_type)
        self._predictor = TracedFunction(fn, jit=jit, static_argnames=static_argnames) if jit else fn
        self._predict_stage_kwargs = {
            "requests": DEFAULT_RESOURCES,
            "limits": DEFAULT_RESOURCES,
            **predict_stage_kwargs,
        }
        self._predict_stage = None
        self._predict_from_features_stage = None

        if callbacks is not None:
            for cb in callbacks:
                if not callable(cb):
                    raise ValueError("Callback must be a callable function.")
                type_guards.guard_prediction_callback(
                    callback=cb,
                    predictor=fn,
                    expected_model_type=self.model_type,
                    expected_data_type=self._dataset.feature_type,
                )
            self.predict_callbacks = tuple(callbacks)

        if not hasattr(fn, "__unionml_model__"):
            fn.__unionml_model__ = self  # type: ignore[attr-defined]
        return fn

    def evaluator(
        self,
        fn: Optional[Callable] = None,
        *,
        jit: Union[bool, str] = "auto",
        static_argnames: Tuple[str, ...] = (),
    ):
        """Register the metric function; captured as CUDA graphs by default when it can be."""
        if fn is None:
            return lambda f: self.evaluator(f, jit=jit, static_argnames=static_argnames)
        type_guards.guard_evaluator(fn, self.model_type, self._expected_parser_types())
        self._evaluator = TracedFunction(fn, jit=jit, static_argnames=static_argnames) if jit else fn
        return fn

    def saver(self, fn: Callable) -> Callable:
        """Register a function serializing (model_object, hyperparameters) to a file."""
        self._saver = fn
        return fn

    def loader(self, fn: Callable) -> Callable:
        """Register a function deserializing a model object from a file."""
        self._loader = fn
        return fn

    # ------------------------------------------------------------------ schedules

    def add_trainer_schedule(self, schedule: Any) -> None:
        raise _not_ported("add_trainer_schedule")

    def add_predictor_schedule(self, schedule: Any) -> None:
        raise _not_ported("add_predictor_schedule")

    def schedule_training(self, name: str, **kwargs: Any) -> None:
        raise _not_ported("schedule_training")

    def schedule_prediction(self, name: str, **kwargs: Any) -> None:
        raise _not_ported("schedule_prediction")

    # ------------------------------------------------------------------ stage factories

    @property
    def trainer_params(self) -> Dict[str, Parameter]:
        """Keyword-only trainer parameters exposed as workflow inputs (``model.py:416-423``)."""
        trainer_fn = getattr(self._trainer, "fn", self._trainer)
        return {
            name: param
            for name, param in signature(trainer_fn).parameters.items()
            if param.kind == Parameter.KEYWORD_ONLY
        }

    def train_task(self) -> Stage:
        """Build (once) the training stage (``model.py:512-578``)."""
        if self._train_stage is not None:
            return self._train_stage

        *_, hp_param = signature(self._init).parameters.values()
        hp_param = hp_param.replace(name="hyperparameters", annotation=self.hyperparameter_type)
        [(data_arg_name, data_arg_type)] = self._dataset.dataset_datatype.items()

        trainer_fn = getattr(self._trainer, "fn", self._trainer)
        evaluator_fn = getattr(self._evaluator, "fn", self._evaluator)
        artifact_type = NamedTuple(  # type: ignore[misc]
            "ModelArtifact",
            model_object=signature(trainer_fn).return_annotation,
            hyperparameters=self.hyperparameter_type,
            metrics=Dict[str, signature(evaluator_fn).return_annotation],
        )

        input_parameters = OrderedDict(
            (p.name, p)
            for p in [
                hp_param,
                Parameter(data_arg_name, kind=Parameter.KEYWORD_ONLY, annotation=data_arg_type),
                *[
                    Parameter(arg, kind=Parameter.KEYWORD_ONLY, annotation=dict)
                    for arg in ("loader_kwargs", "splitter_kwargs", "parser_kwargs")
                ],
                *self.trainer_params.values(),
            ]
        )

        @stage(
            unionml_obj=self,
            input_parameters=input_parameters,
            return_annotation=artifact_type,
            **(self._train_stage_kwargs or {}),
        )
        def train_task(**kwargs):
            hyperparameters = kwargs["hyperparameters"]
            raw_data = kwargs[data_arg_name]
            trainer_kwargs = {p: kwargs[p] for p in self.trainer_params}
            hp_dict = asdict(hyperparameters) if is_dataclass(hyperparameters) else dict(hyperparameters or {})

            training_data = self._dataset.get_data(
                raw_data,
                loader_kwargs=_as_dict(kwargs.get("loader_kwargs")),
                splitter_kwargs=_as_dict(kwargs.get("splitter_kwargs")),
                parser_kwargs=_as_dict(kwargs.get("parser_kwargs")),
            )
            model_object = self._trainer(
                self._init_model_object(hp_dict),
                *training_data["train"],
                **trainer_kwargs,
            )
            metrics = {
                split: _scalarize(self._evaluator(model_object, *training_data[split])) for split in training_data
            }
            return model_object, hyperparameters, metrics

        self._train_stage = train_task
        return train_task

    def predict_task(self) -> Stage:
        """Build (once) the predict-from-raw-data stage (``model.py:580-617``)."""
        if self._predict_stage is not None:
            return self._predict_stage

        predictor_fn = getattr(self._predictor, "fn", self._predictor)
        predictor_sig = signature(predictor_fn)
        model_param, *_ = predictor_sig.parameters.values()
        model_param = model_param.replace(name="model_object", kind=Parameter.KEYWORD_ONLY)
        [(data_arg_name, data_arg_type)] = self._dataset.dataset_datatype.items()
        data_param = Parameter(data_arg_name, kind=Parameter.KEYWORD_ONLY, annotation=data_arg_type)

        @stage(
            unionml_obj=self,
            input_parameters=OrderedDict([(p.name, p) for p in (model_param, data_param)]),
            return_annotation=predictor_sig.return_annotation,
            **(self._predict_stage_kwargs or {}),
        )
        def predict_task(**kwargs):
            model_object = kwargs["model_object"]
            parsed = self._dataset._parser(kwargs[data_arg_name], **self._dataset.parser_kwargs)
            features = self._dataset._feature_transformer(parsed[self._dataset._parser_feature_key])
            features = self._dataset.finalize_features(features)
            predictions = self._predictor(model_object, features)
            self._run_predict_callbacks(model_object, features, predictions)
            return predictions

        self._predict_stage = predict_task
        return predict_task

    def predict_from_features_task(self) -> Stage:
        """Build (once) the predict-from-features stage (``model.py:619-653``)."""
        if self._predict_from_features_stage is not None:
            return self._predict_from_features_stage

        predictor_fn = getattr(self._predictor, "fn", self._predictor)
        predictor_sig = signature(predictor_fn)
        model_param, *_ = predictor_sig.parameters.values()
        model_param = model_param.replace(name="model_object", kind=Parameter.KEYWORD_ONLY)
        [(_, data_arg_type)] = self._dataset.dataset_datatype.items()
        features_param = Parameter("features", kind=Parameter.KEYWORD_ONLY, annotation=data_arg_type)

        @stage(
            unionml_obj=self,
            input_parameters=OrderedDict([("model_object", model_param), ("features", features_param)]),
            return_annotation=predictor_sig.return_annotation,
            **(self._predict_stage_kwargs or {}),
        )
        def predict_from_features_task(**kwargs):
            model_object, features = kwargs["model_object"], kwargs["features"]
            predictions = self._predictor(model_object, features)
            self._run_predict_callbacks(model_object, features, predictions)
            return predictions

        self._predict_from_features_stage = predict_from_features_task
        return predict_from_features_task

    def _run_predict_callbacks(self, model_object, features, predictions) -> None:
        """Run post-prediction callbacks, swallowing exceptions (``model.py:608-612``)."""
        for callback in self._predict_callbacks:
            try:
                callback(model_object, features, predictions)
            except Exception as exc:
                logger.exception("Error in post-prediction callback[%s]: %s", callback.__name__, exc)

    # ------------------------------------------------------------------ workflow factories

    def train_workflow(self) -> Workflow:
        """Wire dataset_task -> train_task into a workflow (``model.py:425-471``)."""
        dataset_task = self._dataset.dataset_task()
        train_task = self.train_task()

        wf = Workflow(self.train_workflow_name)
        wf.add_workflow_input("hyperparameters", self.hyperparameter_type)
        wf.add_workflow_input("loader_kwargs", self._dataset.loader_kwargs_type)
        wf.add_workflow_input("splitter_kwargs", self._dataset.splitter_kwargs_type)
        wf.add_workflow_input("parser_kwargs", self._dataset.parser_kwargs_type)
        _add_stage_inputs(wf, dataset_task)
        trainer_param_types = {k: v.annotation for k, v in self.trainer_params.items()}
        for arg, param in self.trainer_params.items():
            if param.default is _EMPTY:
                wf.add_workflow_input(arg, param.annotation)
            else:
                wf.add_workflow_input(arg, param.annotation, default=param.default)

        dataset_node = wf.add_entity(
            dataset_task, **{k: wf.inputs[k] for k in dataset_task.python_interface.inputs}
        )
        (_, data_promise), *_ = dataset_node.outputs.items()
        [(data_arg_name, _)] = self._dataset.dataset_datatype.items()
        train_node = wf.add_entity(
            train_task,
            hyperparameters=wf.inputs["hyperparameters"],
            **{data_arg_name: data_promise},
            **{arg: wf.inputs[arg] for arg in trainer_param_types},
            **{arg: wf.inputs[arg] for arg in ("loader_kwargs", "splitter_kwargs", "parser_kwargs")},
        )
        wf.add_workflow_output("model_object", train_node.outputs["model_object"])
        wf.add_workflow_output("hyperparameters", train_node.outputs["hyperparameters"])
        wf.add_workflow_output("metrics", train_node.outputs["metrics"])
        return wf

    def predict_workflow(self) -> Workflow:
        """Wire dataset_task -> predict_task (``model.py:473-495``)."""
        dataset_task = self._dataset.dataset_task()
        predict_task = self.predict_task()

        wf = Workflow(self.predict_workflow_name)
        wf.add_workflow_input("model_object", predict_task.python_interface.inputs["model_object"])
        _add_stage_inputs(wf, dataset_task)

        dataset_node = wf.add_entity(
            dataset_task, **{k: wf.inputs[k] for k in dataset_task.python_interface.inputs}
        )
        (_, data_promise), *_ = dataset_node.outputs.items()
        [(data_arg_name, _)] = self._dataset.dataset_datatype.items()
        predict_node = wf.add_entity(
            predict_task, model_object=wf.inputs["model_object"], **{data_arg_name: data_promise}
        )
        for output_name, promise in predict_node.outputs.items():
            wf.add_workflow_output(output_name, promise)
        return wf

    def predict_from_features_workflow(self) -> Workflow:
        """Single-node workflow around predict_from_features_task (``model.py:497-510``)."""
        predict_task = self.predict_from_features_task()
        wf = Workflow(self.predict_from_features_workflow_name)
        for arg, annotation in predict_task.python_interface.inputs.items():
            wf.add_workflow_input(arg, annotation)
        node = wf.add_entity(predict_task, **{k: wf.inputs[k] for k in wf.inputs})
        for output_name, promise in node.outputs.items():
            wf.add_workflow_output(output_name, promise)
        return wf

    # ------------------------------------------------------------------ local execution

    def train(
        self,
        hyperparameters: Optional[Dict[str, Any]] = None,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        splitter_kwargs: Optional[Dict[str, Any]] = None,
        parser_kwargs: Optional[Dict[str, Any]] = None,
        trainer_kwargs: Optional[Dict[str, Any]] = None,
        **reader_kwargs,
    ) -> Tuple[Any, Any]:
        """Train locally through the full reader->...->evaluator graph (``model.py:655-709``)."""
        trainer_kwargs = trainer_kwargs or {}

        # infer hyperparameter types from the provided dict when no config exists
        # (pure derivation — no shared-state mutation, safe under concurrent calls)
        hp_type = self._resolve_hyperparameter_type(hyperparameters)
        hp_value = hyperparameters if hp_type is dict else hp_type(**(hyperparameters or {}))
        model_obj, hyperparameters_out, metrics = self.train_workflow()(
            hyperparameters=hp_value if hp_value is not None else {},
            loader_kwargs=self._dataset.loader_kwargs_type(**(loader_kwargs or {})),
            splitter_kwargs=self._dataset.splitter_kwargs_type(**(splitter_kwargs or {})),
            parser_kwargs=self._dataset.parser_kwargs_type(**(parser_kwargs or {})),
            **{**reader_kwargs, **trainer_kwargs},
        )

        self.artifact = ModelArtifact(model_obj, hyperparameters_out, metrics)
        return model_obj, metrics

    def predict(self, features: Any = None, **reader_kwargs):
        """Generate predictions locally (``model.py:711-741``)."""
        if features is None and not reader_kwargs:
            # a zero-arg call is valid when the reader itself needs no arguments
            # (serving's {"inputs": {}} payload means "run the reader with defaults")
            reader = getattr(self._dataset, "_reader", None)
            reader_ok = reader is not None and all(
                p.default is not _EMPTY or p.kind in (Parameter.VAR_KEYWORD, Parameter.VAR_POSITIONAL)
                for p in signature(reader).parameters.values()
            )
            if not reader_ok:
                raise ValueError("At least one of features or **reader_kwargs must be provided")
        if self.artifact is None:
            raise RuntimeError(
                "ModelArtifact not found: train a model with .train() or load one before predicting."
            )
        if features is None:
            return self.predict_workflow()(model_object=self.artifact.model_object, **reader_kwargs)
        return self.predict_from_features_workflow()(
            model_object=self.artifact.model_object,
            features=self._dataset.get_features(features),
        )

    # ------------------------------------------------------------------ persistence

    def save(self, file: Union[str, os.PathLike, IO], *args, **kwargs):
        """Serialize the current model artifact to disk (``model.py:743-747``)."""
        if self.artifact is None:
            raise AttributeError("`artifact` property is None. Call the `train` method to train a model first")
        return self._saver(self.artifact.model_object, self.artifact.hyperparameters, file, *args, **kwargs)

    def load(self, file: Union[str, os.PathLike, IO], *args, **kwargs):
        """Deserialize a model object and set the artifact (``model.py:749-757``)."""
        self.artifact = ModelArtifact(self._loader(file, *args, **kwargs))
        return self.artifact.model_object

    def load_from_env(self, env_var: str = "UNIONML_MODEL_PATH", *args, **kwargs):
        """Load from a path stored in an environment variable (``model.py:759-769``)."""
        model_path = os.getenv(env_var)
        if model_path is None:
            raise ValueError(f"env var for model path {env_var} doesn't exist.")
        return self.load(model_path, *args, **kwargs)

    def _default_init(self, hyperparameters: dict) -> Any:
        if self._init_callable is None:
            raise ValueError(
                "When using the default init, you must pass the `init` argument to the Model constructor."
            )
        return self._init_callable(**hyperparameters)

    def _init_model_object(self, hyperparameters: dict) -> Any:
        if self._init == self._default_init:
            return self._default_init(hyperparameters)
        return self._init(hyperparameters=hyperparameters)

    def _default_saver(
        self,
        model_obj: Any,
        hyperparameters: Union[dict, BaseHyperparameters, None],
        file: Union[str, os.PathLike, IO],
        *args,
        **kwargs,
    ) -> Any:
        """Framework-aware default serialization; see :mod:`unionml_tpu_torch.checkpoint`."""
        from unionml_tpu_torch.checkpoint import default_save

        hp = asdict(hyperparameters) if hyperparameters is not None and is_dataclass(hyperparameters) else hyperparameters
        return default_save(model_obj, hp, file, model_type=self.model_type, *args, **kwargs)

    def _default_loader(self, file: Union[str, os.PathLike, IO], *args, **kwargs) -> Any:
        """Framework-aware default deserialization; see :mod:`unionml_tpu_torch.checkpoint`."""
        from unionml_tpu_torch.checkpoint import default_load

        return default_load(
            file,
            model_type=self.model_type,
            init_fn=(self._init_model_object if (self._init_callable or self._init != self._default_init) else None),
            *args,
            **kwargs,
        )

    def resolve_model_artifact(
        self,
        model_object: Optional[Any] = None,
        model_version: Optional[str] = None,
        app_version: Optional[str] = None,
        model_file: Optional[Union[str, Path]] = None,
        loader_kwargs: Optional[dict] = None,
    ) -> ModelArtifact:
        """Resolve an artifact from object / backend version / file / self (``model.py:1521-1566``)."""
        if sum(x is not None for x in (model_object, model_version, model_file)) > 1:
            raise ValueError("You can specify only one of 'model_object', 'model_version', or 'model_file'.")
        if model_object is not None:
            return ModelArtifact(model_object)
        if model_version is not None:
            raise _not_ported("resolve_model_artifact(model_version=...)")
        if model_file is not None:
            return ModelArtifact(self.load(model_file, **(loader_kwargs or {})))
        if self.artifact is not None:
            return self.artifact
        raise ModelArtifactNotFound(
            "Model object not found: specify one of model_version, model_file, or model_object, or train a "
            "model locally with .train(...) first."
        )

    # ------------------------------------------------------------------ serving

    def serve(
        self,
        app: Any = None,
        remote: bool = False,
        app_version: Optional[str] = None,
        model_version: str = "latest",
        **serving_kwargs,
    ):
        """Attach this model's endpoints to a serving app (``model.py:771-784``).

        ``app=None`` builds the native aiohttp app with a resident predictor (a CUDA
        graph per bucket; see :class:`~unionml_tpu_torch.serving.resident.ResidentPredictor`);
        ``generator=`` with the ``generate_*`` options adds ``POST /generate``
        (see :func:`~unionml_tpu_torch.serving.app.build_aiohttp_app`).
        A FastAPI app raises ``TypeError``: the FastAPI adapter is not ported yet.
        """
        from unionml_tpu_torch.serving import serving_app

        return serving_app(
            self, app, remote=remote, app_version=app_version, model_version=model_version, **serving_kwargs
        )

    # ------------------------------------------------------------------ remote backend surface

    def remote(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote")

    def remote_deploy(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_deploy")

    def remote_train(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_train")

    def remote_predict(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_predict")

    def remote_wait(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_wait")

    def remote_load(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_load")

    def remote_fetch_model(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_fetch_model")

    def remote_fetch_predictions(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_fetch_predictions")

    def remote_list_model_versions(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_list_model_versions")

    def remote_list_prediction_ids(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_list_prediction_ids")

    def remote_activate_schedules(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_activate_schedules")

    def remote_deactivate_schedules(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_deactivate_schedules")

    def remote_list_scheduled_training_runs(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_list_scheduled_training_runs")

    def remote_list_scheduled_prediction_runs(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("Model.remote_list_scheduled_prediction_runs")


def _add_stage_inputs(wf: Workflow, task: Stage) -> None:
    """Expose a stage's parameters (with their defaults) as workflow inputs."""
    for arg, param in task.inputs.items():
        if param.default is _EMPTY:
            wf.add_workflow_input(arg, param.annotation)
        else:
            wf.add_workflow_input(arg, param.annotation, default=param.default)


def _as_dict(value: Any) -> Optional[Dict[str, Any]]:
    """Normalize kwargs payloads that may be dataclasses, dicts, or None."""
    if value is None:
        return None
    if is_dataclass(value):
        return asdict(value)
    return dict(value)
