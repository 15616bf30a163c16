"""Decoration-time signature validation for Dataset/Model component functions.

Port of ``unionml_tpu/type_guards.py``: every ``guard_*`` raises the same
exception type with the same message on the same bad signature. The array
family is ``torch.Tensor`` and ``np.ndarray`` (where the JAX package has
``jax.Array``, ``np.ndarray`` and ``jax.ShapeDtypeStruct``), so a reader
annotated with numpy arrays can feed a trainer annotated with tensors.
"""

import inspect
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple, get_args, get_origin

import numpy as np
import torch

_EMPTY = inspect.Parameter.empty

#: required keyword parameters (name -> type) for the splitter slot
SPLITTER_REQUIRED_KWARGS: Dict[str, object] = {"test_size": float, "shuffle": bool, "random_state": int}

#: required keyword parameters (name -> type) for the parser slot
PARSER_REQUIRED_KWARGS: Dict[str, object] = {"features": Optional[List[str]], "targets": List[str]}

#: annotations considered interchangeable for array data moving between stages
_ARRAY_FAMILY: Tuple[object, ...] = (torch.Tensor, np.ndarray)


def _is_array_type(tp: object) -> bool:
    return tp in _ARRAY_FAMILY


def types_compatible(actual: object, expected: object) -> bool:
    """True when ``actual`` may flow into a slot expecting ``expected``.

    Compatibility rules (same shape as the reference's ``_check_input_data_type``,
    ``type_guards.py:28-40``): ``Any`` on either side passes; exact equality passes;
    membership of one side in the other's Union/generic args passes. Added rule: both
    being array types passes.
    """
    if actual is Any or expected is Any or actual is _EMPTY:
        return True
    if expected is None or expected is _EMPTY:
        # unknown expected type (e.g. un-annotated init callable): nothing to enforce
        return True
    if actual == expected:
        return True
    if expected in get_args(actual) or actual in get_args(expected):
        return True
    if _is_array_type(actual) and _is_array_type(expected):
        return True
    # parameterized containers whose args differ only by array family are compatible:
    # Dict[str, np.ndarray] features arrive as Dict[str, torch.Tensor] after the
    # device-format conversion (tokenized multi-input models)
    actual_origin, expected_origin = get_origin(actual), get_origin(expected)
    if actual_origin is not None and actual_origin == expected_origin:
        actual_args, expected_args = get_args(actual), get_args(expected)
        if len(actual_args) == len(expected_args) and all(
            types_compatible(a, e) for a, e in zip(actual_args, expected_args)
        ):
            return True
    return False


def _require_compatible(fn_name: str, position: str, actual: object, expected: object) -> None:
    if not types_compatible(actual, expected):
        raise TypeError(
            f"'{fn_name}': the {position} must be compatible with the expected type {expected}; found {actual}"
        )


def _positional_annotations(params: List[inspect.Parameter]) -> List[object]:
    positional_kinds = {inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.POSITIONAL_ONLY}
    return [p.annotation for p in params if p.kind in positional_kinds]


def _splits_container(tp: object) -> bool:
    """True when ``tp`` is a tuple/list/NamedTuple generic holding data splits."""
    if get_origin(tp) in {tuple, list}:
        return True
    return getattr(tp, "__bases__", None) == (tuple,)


def _require_splits_container(fn_name: str, tp: object) -> None:
    if not _splits_container(tp):
        raise TypeError(
            f"'{fn_name}' must return a List, Tuple, or NamedTuple of data splits; found {tp}"
        )


def _require_split_element_types(fn_name: str, container: object, expected: object, source: str) -> None:
    for element_type in get_args(container):
        if element_type != expected and not (_is_array_type(element_type) and _is_array_type(expected)):
            raise TypeError(
                f"'{fn_name}': elements of the output container must match the '{source}' output "
                f"type {expected}; found {container}"
            )


def _require_keyword_params(fn_name: str, params: Mapping[str, inspect.Parameter], required: Dict[str, object]) -> None:
    for position, (argname, argtype) in enumerate(required.items()):
        param = params.get(argname)
        if param is None:
            raise TypeError(
                f"'{fn_name}' must accept an argument '{argname}' of type {argtype} at position "
                f"{position + 1}; found signature {dict(params)}"
            )
        if param.annotation != argtype:
            raise TypeError(f"'{fn_name}': argument '{argname}' must be annotated {argtype}; found {param.annotation}")


def _require_arity(fn_name: str, actual_types: List[object], expected_types: Iterable[object]) -> None:
    expected_types = list(expected_types)
    if len(actual_types) != len(expected_types):
        raise TypeError(
            f"'{fn_name}': positional data arguments must match {expected_types}; found {actual_types}"
        )


def guard_reader(reader: Callable) -> None:
    """The reader must declare a return annotation (``type_guards.py:79-86``)."""
    if inspect.signature(reader).return_annotation is _EMPTY:
        raise TypeError("The dataset.reader function must declare a return type annotation.")


def guard_loader(loader: Callable, expected_data_type: object) -> None:
    """The loader's first argument must accept the reader output (``type_guards.py:88-92``)."""
    params = list(inspect.signature(loader).parameters.values())
    _require_compatible("loader", "first argument", params[0].annotation, expected_data_type)


def guard_splitter(splitter: Callable, expected_data_type: object, source: str) -> None:
    """Splitter contract: data in, container of same-typed splits out (``type_guards.py:95-104``)."""
    sig = inspect.signature(splitter)
    params = list(sig.parameters.values())
    _require_compatible("splitter", "first argument", params[0].annotation, expected_data_type)
    _require_splits_container("splitter", sig.return_annotation)
    _require_split_element_types("splitter", sig.return_annotation, expected_data_type, source)
    _require_keyword_params("splitter", sig.parameters, SPLITTER_REQUIRED_KWARGS)


def guard_parser(parser: Callable, expected_data_type: object, source: str) -> None:
    """Parser contract: data in, (features, targets) container out (``type_guards.py:107-115``)."""
    sig = inspect.signature(parser)
    params = list(sig.parameters.values())
    _require_compatible("parser", "first argument", params[0].annotation, expected_data_type)
    _require_splits_container("parser", sig.return_annotation)
    _require_keyword_params("parser", sig.parameters, PARSER_REQUIRED_KWARGS)


def guard_trainer(trainer: Callable, expected_model_type: object, expected_data_types: Iterable[object]) -> None:
    """Trainer contract: (model, *data) -> model (``type_guards.py:118-132``)."""
    sig = inspect.signature(trainer)
    params = list(sig.parameters.values())
    _require_compatible("trainer", "first argument (model object)", params[0].annotation, expected_model_type)
    _require_compatible("trainer", "return annotation", sig.return_annotation, expected_model_type)
    actual_data_types = _positional_annotations(params[1:])
    _require_arity("trainer", actual_data_types, expected_data_types)
    for actual, expected in zip(actual_data_types, expected_data_types):
        _require_compatible("trainer", "data argument", actual, expected)


def guard_evaluator(evaluator: Callable, expected_model_type: object, expected_data_types: Iterable[object]) -> None:
    """Evaluator contract: (model, *data) -> metric (``type_guards.py:135-148``)."""
    sig = inspect.signature(evaluator)
    params = list(sig.parameters.values())
    _require_compatible("evaluator", "first argument (model object)", params[0].annotation, expected_model_type)
    actual_data_types = _positional_annotations(params[1:])
    _require_arity("evaluator", actual_data_types, expected_data_types)
    for actual, expected in zip(actual_data_types, expected_data_types):
        _require_compatible("evaluator", "data argument", actual, expected)


def guard_predictor(predictor: Callable, expected_model_type: object, expected_data_type: object) -> None:
    """Predictor contract: (model, features) -> predictions, annotated (``type_guards.py:151-169``)."""
    sig = inspect.signature(predictor)
    params = list(sig.parameters.values())
    actual_data_types = _positional_annotations(params[1:])
    if len(actual_data_types) != 1:
        raise TypeError(f"'predictor' must take a single 'features' argument; found {actual_data_types}")
    _require_compatible("predictor", "first argument (model object)", params[0].annotation, expected_model_type)
    _require_compatible("predictor", "features argument", actual_data_types[0], expected_data_type)
    if sig.return_annotation is _EMPTY:
        raise TypeError("The 'predictor' function needs a return type annotation.")


def guard_prediction_callback(
    callback: Callable,
    predictor: Callable,
    expected_model_type: object,
    expected_data_type: object,
) -> None:
    """Callback contract: (model, features, predictions) -> None (``type_guards.py:172-233``)."""
    expected_prediction_type = inspect.signature(predictor).return_annotation
    if expected_prediction_type is _EMPTY:
        raise TypeError("The 'predictor' function needs a return type annotation.")

    sig = inspect.signature(callback)
    if sig.return_annotation is not _EMPTY and sig.return_annotation is not None:
        raise TypeError(f"'callback[{callback.__name__}]' must have None as its return annotation.")

    params = list(sig.parameters.values())
    trailing = _positional_annotations(params[1:])
    if len(trailing) != 2:
        raise TypeError(
            f"'callback[{callback.__name__}]' must take both 'features' and 'prediction' arguments; found {trailing}"
        )
    name = f"callback[{callback.__name__}]"
    _require_compatible(name, "first argument (model object)", params[0].annotation, expected_model_type)
    _require_compatible(name, "second argument (features)", trailing[0], expected_data_type)
    _require_compatible(name, "third argument (predictions)", trailing[1], expected_prediction_type)


def guard_feature_loader(feature_loader: Callable, expected_data_type: object) -> None:
    """Feature loader contract: exactly one argument (``type_guards.py:235-244``)."""
    sig = inspect.signature(feature_loader)
    params = list(sig.parameters.values())
    if len(params) != 1:
        raise TypeError("The 'feature_loader' must take a single argument of raw features or a reference to them.")
    _require_compatible("feature_loader", "argument", params[0].annotation, expected_data_type)


def guard_feature_transformer(feature_transformer: Callable, expected_data_type: object) -> None:
    """Feature transformer contract: exactly one argument (``type_guards.py:247-254``)."""
    sig = inspect.signature(feature_transformer)
    params = list(sig.parameters.values())
    if len(params) != 1:
        raise TypeError("The 'feature_transformer' must take a single argument representing loaded features.")
    _require_compatible("feature_transformer", "argument", params[0].annotation, expected_data_type)
