"""BentoML adapter: package a model of the port as a bentoml service.

Port of ``unionml_tpu/services/bentoml_service.py`` (reference parity:
``unionml/services/bentoml.py:31-247``): a wrapper binding a Model to bentoml's
model store, runner, and service machinery, with IO descriptors inferred from
the dataset's feature type and the predictor's return type.

The runnable declares ``"nvidia.com/gpu"`` among its ``SUPPORTED_RESOURCES``,
as the reference's runnable does (``services/bentoml.py:202``), and holds a
:class:`~unionml_tpu_torch.serving.resident.ResidentPredictor` on ``device``
(the CUDA device by default), so batch inference replays its CUDA graphs.

The module imports WITHOUT bentoml installed: every entry point resolves the
``bentoml`` module attribute at call time, importing bentoml on first use (and
raising a clear ImportError when it is absent), so the adapter logic is
executable — and contract-testable — against a duck-typed stand-in set over the
module attribute.
"""

from typing import Any, Callable, List, Optional

from unionml_tpu_torch.serving.resident import ResidentPredictor

#: the bentoml module, imported on first use (a test may set a stand-in)
bentoml: Any = None


def _bentoml():
    global bentoml
    if bentoml is None:
        try:
            import bentoml as module
        except ImportError as exc:
            raise ImportError(
                "bentoml is not installed; install it (pip install bentoml) to use the "
                "BentoML serving adapter."
            ) from exc
        bentoml = module
    return bentoml


def infer_io_descriptors(model: Any):
    """Infer bentoml input/output IO descriptors from the app's types.

    Reference parity: ``services/bentoml.py:216-247``. The INPUT is always JSON: the
    API handler receives the raw wire payload and routes it through the dataset's
    feature pipeline (which owns deserialization), so the input descriptor must not
    pre-coerce it — only the OUTPUT descriptor is inferred from the predictor's
    return annotation (DataFrames -> PandasDataFrame, arrays and tensors ->
    NumpyNdarray).
    """
    import numpy as np

    bentoml = _bentoml()

    def descriptor(tp):
        if isinstance(tp, type):
            if getattr(tp, "__module__", "").startswith("pandas") and tp.__name__ == "DataFrame":
                return bentoml.io.PandasDataFrame()
            if issubclass(tp, np.ndarray):
                return bentoml.io.NumpyNdarray()
        if getattr(tp, "__module__", "").startswith("torch"):
            return bentoml.io.NumpyNdarray()
        return bentoml.io.JSON()

    try:
        prediction_type = model.prediction_type  # raises when no predictor registered yet
    except TypeError:
        prediction_type = None
    return bentoml.io.JSON(), descriptor(prediction_type)


def create_runnable(model: Any, tag: str, device: Any = "cuda") -> type:
    """Function-form runnable factory (``services/bentoml.py:create_runnable`` parity)."""
    return BentoMLService(model, device=device).create_runnable(tag)


def create_service(model: Any, tag: str, name: str = None, enable_async: bool = False, device: Any = "cuda"):
    """Function-form service factory (``services/bentoml.py:create_service`` parity)."""
    return BentoMLService(model, device=device).configure(tag, name=name, enable_async=enable_async)


class BentoMLService:
    """Binds a Model of the port to bentoml save/load/serve; its runnable's
    resident predictor runs on ``device``."""

    def __init__(self, model: Any, framework: str = "picklable_model", device: Any = "cuda"):
        self._model = model
        self._framework = framework
        self._device = device
        self._svc: Optional["bentoml.Service"] = None
        self._runner = None

    @property
    def model(self) -> Any:
        return self._model

    @property
    def svc(self) -> "bentoml.Service":
        if self._svc is None:
            raise RuntimeError("Call BentoMLService.configure(...) first.")
        return self._svc

    def save_model(self, name: Optional[str] = None, **save_kwargs) -> Any:
        """Store the trained model object in the bentoml model store."""
        if self._model.artifact is None:
            raise RuntimeError("Train or load a model before saving it to the bento store.")
        name = name or self._model.name
        module = getattr(_bentoml(), self._framework)
        return module.save_model(name, self._model.artifact.model_object, **save_kwargs)

    def load_model(self, tag: str) -> Any:
        module = getattr(_bentoml(), self._framework)
        return module.load_model(tag)

    def create_runnable(self, tag: str) -> type:
        """A bentoml Runnable whose resources include the GPU."""
        service = self
        bentoml = _bentoml()

        class UnionMLRunnable(bentoml.Runnable):
            SUPPORTED_RESOURCES = ("cpu", "nvidia.com/gpu")
            SUPPORTS_CPU_MULTI_THREADING = True

            def __init__(self):
                from unionml_tpu_torch.model import ModelArtifact

                model_object = service.load_model(tag)
                service._model.artifact = ModelArtifact(model_object)
                self._resident = ResidentPredictor(service._model, device=service._device)
                self._resident.setup()

            @bentoml.Runnable.method(batchable=False)
            def predict(self, features: Any) -> Any:
                return self._resident.predict(features=features)

        return UnionMLRunnable

    def configure(
        self,
        tag: str,
        name: Optional[str] = None,
        enable_async: bool = False,
        supported_resources: Optional[List[str]] = None,
    ) -> "bentoml.Service":
        """Build the runner + service (``services/bentoml.py:72-131`` analogue)."""
        bentoml = _bentoml()
        runnable = self.create_runnable(tag)
        if supported_resources:
            runnable.SUPPORTED_RESOURCES = tuple(supported_resources)
        self._runner = bentoml.Runner(runnable, name=f"{self._model.name}-runner")
        svc = bentoml.Service(name or self._model.name, runners=[self._runner])
        handler = self._make_api(enable_async)
        input_io, output_io = infer_io_descriptors(self._model)
        svc.api(input=input_io, output=output_io)(handler)
        self._svc = svc
        return svc

    def _make_api(self, enable_async: bool) -> Callable:
        runner = self._runner

        # ResidentPredictor.predict runs the dataset's feature pipeline itself —
        # the raw payload goes straight through to avoid double transformation
        if enable_async:

            async def predict(payload: Any) -> Any:
                return await runner.predict.async_run(payload)

            return predict

        def predict(payload: Any) -> Any:
            return runner.predict.run(payload)

        return predict
