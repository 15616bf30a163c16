"""Dataset: declarative spec for reading, splitting, parsing, and featurizing data.

Port of ``unionml_tpu/dataset.py``: the same six functional slots (``reader``
required; ``loader``/``splitter``/``parser``/``feature_loader``/
``feature_transformer`` defaulted), the same default pipeline over
DataFrames, arrays and dicts of arrays, dynamic kwargs dataclasses, a
``dataset_task`` stage factory, and SQL constructors. The default splitter
draws the same permutation as the JAX package for the same ``random_state``.

``device_format="torch"`` (the counterpart of ``"jax"``) converts parsed
splits and transformed features to tensors on ``device`` (default
``"cuda"``, which raises without a card unless ``"cpu"`` is asked for).
``pandas`` is imported only where a DataFrame is met.
"""

import json
from enum import Enum
from functools import partial
from inspect import Parameter, signature
from pathlib import Path
from typing import Any, Callable, Dict, Generic, List, NamedTuple, Optional, Tuple, Type, TypeVar, get_args

import numpy as np
import torch

from unionml_tpu_torch import type_guards
from unionml_tpu_torch._device import resolve_device
from unionml_tpu_torch.defaults import DEFAULT_RESOURCES
from unionml_tpu_torch.stage import Stage, stage
from unionml_tpu_torch.tracker import TrackedInstance
from unionml_tpu_torch.utils import kwargs_field_specs, make_json_dataclass, to_device_arrays

_EMPTY = Parameter.empty

DT = TypeVar("DT")
FT = TypeVar("FT")


def is_dataframe_type(tp: Any) -> bool:
    """True for ``pandas.DataFrame`` itself, told without importing pandas."""
    return isinstance(tp, type) and tp.__name__ == "DataFrame" and tp.__module__.startswith("pandas")


def is_dataframe(obj: Any) -> bool:
    return is_dataframe_type(type(obj))


class FeatureTypeUnion(Generic[DT, FT]):
    """Marker type for a feature slot fed by either the dataset type or loader output.

    Reference parity: ``unionml/dataset.py:30``.
    """


class DatasetTypeSource(Enum):
    """Which slot the materialized dataset type derives from (``dataset.py:34-40``)."""

    READER = "reader"
    LOADER = "loader"


class Dataset(TrackedInstance):
    """Specification of the data used to train and serve a model."""

    def __init__(
        self,
        name: str = "dataset",
        *,
        features: Optional[List[str]] = None,
        targets: Optional[List[str]] = None,
        test_size: float = 0.2,
        shuffle: bool = True,
        random_state: int = 12345,
        device_format: Optional[str] = None,
        batch_axis: str = "batch",
        device: Any = "cuda",
    ):
        """
        :param features: column/key names selecting feature data.
        :param targets: column/key names selecting target data.
        :param test_size: fraction of rows held out as the test split.
        :param shuffle: shuffle rows before splitting.
        :param random_state: seed for the shuffle.
        :param device_format: if ``"torch"``, parsed splits and transformed features are
            converted to tensors on ``device`` (float64 becomes float32) before they reach
            the trainer/predictor; ``None`` keeps host-native types (sklearn parity).
        :param batch_axis: logical name of the batch dimension, consumed by the
            data-parallel engine when sharding batches over a mesh.
        :param device: where ``device_format="torch"`` puts its tensors; ``"cuda"``
            (default) raises without a CUDA device unless ``"cpu"`` is asked for.
        """
        super().__init__()
        self.name = name
        self._features = [] if features is None else list(features)
        self._targets = targets
        self._test_size = test_size
        self._shuffle = shuffle
        self._random_state = random_state
        if device_format not in (None, "torch"):
            raise ValueError(f"device_format must be None or 'torch', got {device_format!r}")
        self._device_format = device_format
        self.device = resolve_device(device) if device_format == "torch" else None
        self.batch_axis = batch_axis

        self._loader: Callable = self._default_loader
        self._splitter: Callable = self._default_splitter
        self._parser: Callable = self._default_parser
        self._parser_feature_key: int = 0
        self._feature_loader: Callable = self._default_feature_loader
        self._feature_transformer: Callable = self._default_feature_transformer

        self._reader: Optional[Callable] = None
        self._reader_stage_kwargs: Optional[Dict[str, Any]] = None
        self._reader_input_parameters: Optional[List[Parameter]] = None
        self._materialized_datatype: Optional[Dict[str, Type]] = None
        self._dataset_stage: Optional[Stage] = None

        self._loader_kwargs_type: Optional[Type] = None
        self._splitter_kwargs_type: Optional[Type] = None
        self._parser_kwargs_type: Optional[Type] = None

    # ------------------------------------------------------------------ decorators

    def reader(self, fn: Optional[Callable] = None, **reader_stage_kwargs):
        """Register the function that fetches raw data from an external source."""
        if fn is None:
            return partial(self.reader, **reader_stage_kwargs)
        type_guards.guard_reader(fn)
        self._reader = fn
        self._reader_stage_kwargs = {"requests": DEFAULT_RESOURCES, "limits": DEFAULT_RESOURCES, **reader_stage_kwargs}
        return fn

    def loader(self, fn: Callable) -> Callable:
        """Register an optional function that loads raw reader output into memory."""
        type_guards.guard_loader(fn, self.dataset_datatype["data"])
        self._loader = fn
        self._loader_kwargs_type = None
        return fn

    def splitter(self, fn: Callable) -> Callable:
        """Register an optional function that partitions data into train/test splits."""
        type_guards.guard_splitter(fn, self.dataset_datatype["data"], self.dataset_datatype_source.value)
        self._splitter = fn
        self._splitter_kwargs_type = None
        return fn

    def parser(self, fn: Optional[Callable] = None, feature_key: int = 0):
        """Register an optional function producing (features, targets) from a split."""
        if fn is None:
            return partial(self.parser, feature_key=feature_key)
        type_guards.guard_parser(fn, self.dataset_datatype["data"], self.dataset_datatype_source.value)
        self._parser = fn
        self._parser_feature_key = feature_key
        self._parser_kwargs_type = None
        return fn

    def feature_loader(self, fn: Callable) -> Callable:
        """Register an optional function deserializing raw features (CLI / HTTP predict path)."""
        type_guards.guard_feature_loader(fn, Any)
        self._feature_loader = fn
        return fn

    def feature_transformer(self, fn: Callable) -> Callable:
        """Register an optional pre-processing function applied to features before prediction."""
        return_annotation = signature(self._feature_loader).return_annotation
        type_guards.guard_feature_transformer(fn, return_annotation)
        self._feature_transformer = fn
        return fn

    # ------------------------------------------------------------------ kwargs plumbing

    @property
    def splitter_kwargs(self) -> Dict[str, Any]:
        return {"test_size": self._test_size, "shuffle": self._shuffle, "random_state": self._random_state}

    @property
    def parser_kwargs(self) -> Dict[str, Any]:
        return {"features": self._features, "targets": self._targets}

    @property
    def loader_kwargs_type(self) -> Type:
        """JSON-able dataclass of the loader's trailing kwargs (``dataset.py:240-252``)."""
        if self._loader_kwargs_type is None:
            self._loader_kwargs_type = make_json_dataclass("LoaderKwargs", kwargs_field_specs(self._loader))
        return self._loader_kwargs_type

    @property
    def splitter_kwargs_type(self) -> Type:
        if self._splitter_kwargs_type is None:
            self._splitter_kwargs_type = make_json_dataclass(
                "SplitterKwargs", kwargs_field_specs(self._splitter, self.splitter_kwargs)
            )
        return self._splitter_kwargs_type

    @property
    def parser_kwargs_type(self) -> Type:
        if self._parser_kwargs_type is None:
            self._parser_kwargs_type = make_json_dataclass(
                "ParserKwargs", kwargs_field_specs(self._parser, self.parser_kwargs)
            )
        return self._parser_kwargs_type

    # ------------------------------------------------------------------ stages & pipelines

    def dataset_task(self) -> Stage:
        """Build (once) the stage that materializes raw data via the reader."""
        if self._dataset_stage is not None:
            return self._dataset_stage
        if self._reader is None:
            raise ValueError(f"Dataset {self.name!r} has no reader. Register one with @dataset.reader.")

        reader_sig = signature(self._reader)
        reader_output = NamedTuple("ReaderOutput", data=reader_sig.return_annotation)  # type: ignore[misc]

        @stage(
            unionml_obj=self,
            input_parameters=reader_sig.parameters,
            return_annotation=reader_output,
            **(self._reader_stage_kwargs or {}),
        )
        def dataset_task(**kwargs):
            return self._reader(**kwargs)

        self._dataset_stage = dataset_task
        return dataset_task

    def get_data(
        self,
        raw_data: Any,
        loader_kwargs: Optional[Dict[str, Any]] = None,
        splitter_kwargs: Optional[Dict[str, Any]] = None,
        parser_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, List[Any]]:
        """Run raw data through loader -> splitter -> parser -> feature_transformer.

        Returns ``{"train": [...], "test": [...]}`` (test omitted for single-split
        splitters). Reference parity: ``unionml/dataset.py:302-348``.
        """
        merged_loader = {**({} if loader_kwargs is None else loader_kwargs)}
        merged_splitter = {**self.splitter_kwargs, **({} if splitter_kwargs is None else splitter_kwargs)}
        merged_parser = {**self.parser_kwargs, **({} if parser_kwargs is None else parser_kwargs)}

        data = self._loader(raw_data, **merged_loader)
        splits = self._splitter(data, **merged_splitter)

        out: Dict[str, List[Any]] = {}
        split_names = ["train", "test", "validation"]
        for split_name, split in zip(split_names, splits):
            parsed = [*self._parser(split, **merged_parser)]
            parsed[self._parser_feature_key] = self._feature_transformer(parsed[self._parser_feature_key])
            if self._device_format == "torch":
                parsed = list(to_device_arrays(*parsed, device=self.device))
            out[split_name] = parsed
        return out

    def get_features(self, features: Any) -> Any:
        """Run raw features through feature_loader -> feature_transformer (``dataset.py:350-359``)."""
        features = self._feature_loader(features)
        return self.finalize_features(self._feature_transformer(features))

    def finalize_features(self, features: Any) -> Any:
        """Apply the device-format conversion to transformed features.

        Called by every path that hands features to the predictor (``get_features`` and
        the predict-from-reader task) so both agree on the on-device representation.
        """
        if self._device_format == "torch":
            (features,) = to_device_arrays(features, device=self.device)
        return features

    # ------------------------------------------------------------------ type derivation

    @property
    def reader_input_types(self) -> Optional[List[Parameter]]:
        if self._reader is not None and self._reader_input_parameters is None:
            return [*signature(self._reader).parameters.values()]
        return self._reader_input_parameters

    @property
    def dataset_datatype(self) -> Dict[str, Type]:
        """Materialized dataset type; loader return annotation wins over reader's."""
        if self._loader != self._default_loader:
            return {"data": signature(self._loader).return_annotation}
        if self._reader is not None and self._materialized_datatype is None:
            return {"data": signature(self._reader).return_annotation}
        if self._materialized_datatype is not None:
            return self._materialized_datatype
        raise ValueError(
            "dataset datatype is undefined: register a @dataset.reader function with a return annotation."
        )

    @property
    def dataset_datatype_source(self) -> DatasetTypeSource:
        return DatasetTypeSource.LOADER if self._loader != self._default_loader else DatasetTypeSource.READER

    @property
    def parser_return_types(self) -> Tuple[Any, ...]:
        return get_args(signature(self._parser).return_annotation)

    @property
    def feature_type(self) -> Type:
        """Type of the features accepted by the predictor (``dataset.py:398-424``).

        With ``device_format="torch"`` the pipeline converts features to
        tensors, so the predictor contract is ``torch.Tensor`` regardless of the
        host-side reader type.
        """
        if self._device_format == "torch":
            from typing import get_origin

            if self._feature_loader != self._default_feature_loader:
                # a custom loader returning a DICT defines a multi-input feature
                # structure (tokenized models); device conversion preserves it.
                # Loaders annotated with host-side types (DataFrame, lists) keep the
                # torch.Tensor contract — conversion flattens them to a tensor.
                annotation = signature(self._feature_loader).return_annotation
                if annotation is not Parameter.empty and get_origin(annotation) is dict:
                    return annotation
            return torch.Tensor
        dataset_type = (
            self.dataset_datatype["data"]
            if self._parser == self._default_parser
            else self.parser_return_types[self._parser_feature_key]
        )
        loaded_type = (
            signature(self._feature_loader).return_annotation
            if self._feature_transformer == self._default_feature_transformer
            else signature(self._feature_transformer).return_annotation
        )
        if self._feature_loader == self._default_feature_loader:
            return dataset_type
        if dataset_type != loaded_type:
            return FeatureTypeUnion[dataset_type, loaded_type]  # type: ignore[index]
        return dataset_type

    # ------------------------------------------------------------------ SQL constructors

    @classmethod
    def from_sqlite(
        cls,
        db_path: str,
        query: str,
        *,
        query_params: Optional[Dict[str, Type]] = None,
        **dataset_kwargs: Any,
    ) -> "Dataset":
        """Create a Dataset whose reader executes a SQLite query (needs ``pandas``).

        Reference parity: ``Dataset.from_sqlite_task`` (``unionml/dataset.py:442-455``)
        built on flytekit's SQLite3Task; here the reader uses the stdlib ``sqlite3``
        driver with named-placeholder parameters (``:param`` syntax).
        """
        import pandas as pd

        dataset = cls(**dataset_kwargs)

        params = query_params or {}

        def sqlite_reader(**kwargs) -> pd.DataFrame:
            import sqlite3

            with sqlite3.connect(db_path) as conn:
                return pd.read_sql_query(query, conn, params=kwargs or None)

        sqlite_reader.__signature__ = signature(sqlite_reader).replace(  # type: ignore[attr-defined]
            parameters=[Parameter(k, Parameter.KEYWORD_ONLY, annotation=v) for k, v in params.items()],
            return_annotation=pd.DataFrame,
        )
        sqlite_reader.__annotations__ = {**{k: v for k, v in params.items()}, "return": pd.DataFrame}
        dataset.reader(sqlite_reader)
        return dataset

    @classmethod
    def from_sqlalchemy(
        cls,
        url: str,
        query: str,
        *,
        query_params: Optional[Dict[str, Type]] = None,
        **dataset_kwargs: Any,
    ) -> "Dataset":
        """Create a Dataset whose reader executes a query against a SQLAlchemy URL.

        Reference parity: ``Dataset.from_sqlalchemy_task`` (``dataset.py:457-470``).
        Requires the optional ``sqlalchemy`` package.
        """
        import pandas as pd

        dataset = cls(**dataset_kwargs)
        params = query_params or {}

        def sqlalchemy_reader(**kwargs) -> pd.DataFrame:
            import sqlalchemy

            engine = sqlalchemy.create_engine(url)
            with engine.connect() as conn:
                return pd.read_sql_query(sqlalchemy.text(query), conn, params=kwargs or None)

        sqlalchemy_reader.__signature__ = signature(sqlalchemy_reader).replace(  # type: ignore[attr-defined]
            parameters=[Parameter(k, Parameter.KEYWORD_ONLY, annotation=v) for k, v in params.items()],
            return_annotation=pd.DataFrame,
        )
        sqlalchemy_reader.__annotations__ = {**{k: v for k, v in params.items()}, "return": pd.DataFrame}
        dataset.reader(sqlalchemy_reader)
        return dataset

    # ------------------------------------------------------------------ defaults

    def _default_loader(self, data: Any) -> Any:
        """Coerce raw reader output into the declared dataset type (``dataset.py:472-476``)."""
        [(_, declared)] = self.dataset_datatype.items()
        if is_dataframe_type(declared) and not is_dataframe(data):
            import pandas as pd

            return pd.DataFrame(data)
        return data

    def _default_splitter(self, data: Any, test_size: float, shuffle: bool, random_state: int) -> Tuple[Any, ...]:
        """Shuffle + hold out ``test_size`` of rows.

        Handles DataFrames, arrays, and dicts of same-length arrays; any other type
        passes through as a single train split (``dataset.py:478-487`` behavior).
        """
        if is_dataframe(data):
            n_rows = len(data)
        elif isinstance(data, np.ndarray):
            n_rows = data.shape[0]
        elif isinstance(data, dict) and data and all(hasattr(v, "__len__") for v in data.values()):
            n_rows = len(next(iter(data.values())))
        else:
            return (data,)

        n_test = int(n_rows * test_size)
        indices = np.arange(n_rows)
        if shuffle:
            indices = np.random.default_rng(random_state).permutation(n_rows)
        train_idx, test_idx = indices[: n_rows - n_test], indices[n_rows - n_test :]

        def take_rows(value, subset):
            if isinstance(value, (list, tuple)):
                try:
                    array = np.asarray(value)
                except ValueError:
                    array = np.empty(0, dtype=object)
                if array.dtype == object:
                    # only RAGGED columns (variable-length token sequences for
                    # packed LM training) stay python lists; rectangular list
                    # columns keep becoming arrays as they always have
                    return [value[i] for i in subset]
                return array[subset]
            return np.asarray(value)[subset]

        def take(subset):
            if is_dataframe(data):
                return data.iloc[subset]
            if isinstance(data, np.ndarray):
                return data[subset]
            return {k: take_rows(v, subset) for k, v in data.items()}

        return take(train_idx), take(test_idx)

    def _default_parser(
        self, data: Any, features: Optional[List[str]], targets: Optional[List[str]]
    ) -> Tuple[Any, Any]:
        """Select feature/target columns from a DataFrame or dict (``dataset.py:489-504``)."""
        if isinstance(data, dict):
            feature_keys = features or [k for k in data if k not in (targets or [])]
            feature_data = {k: data[k] for k in feature_keys}
            target_data = {k: data[k] for k in (targets or []) if k in data}
            return feature_data, target_data
        if not is_dataframe(data):
            return (data,)  # type: ignore[return-value]
        import pandas as pd

        if not features:
            features = [col for col in data.columns if col not in (targets or [])]
        try:
            target_data = data[targets] if targets else pd.DataFrame()
        except KeyError:
            target_data = pd.DataFrame()
        return data[features], target_data

    def _default_feature_loader(self, features: Any) -> Any:
        """Load features from a path / JSON / records into the dataset type (``dataset.py:506-520``)."""
        if isinstance(features, Path):
            with features.open() as f:
                features = json.load(f)

        [(_, declared)] = self.dataset_datatype.items()
        if is_dataframe_type(declared):
            import pandas as pd

            data = pd.DataFrame(features)
            feature_names = self._features
            if not feature_names and self._targets is not None:
                feature_names = [col for col in data.columns if col not in self._targets]
            return data[feature_names] if feature_names else data
        return features

    def _default_feature_transformer(self, features: Any) -> Any:
        return features
