"""Shared helpers: framework sniffing, tensor-tree utilities, dataclass synthesis.

Port of ``unionml_tpu/utils/__init__.py``. The device helpers work on
``torch.Tensor`` trees: :func:`hard_sync` is ``torch.cuda.synchronize`` on the
devices of a tree's CUDA tensors, and :func:`to_device_arrays` makes tensors on
an explicit device.
"""

import importlib
from dataclasses import asdict, field, fields, make_dataclass
from inspect import Parameter, signature
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Type, Union

import numpy as np
import torch
from torch.utils import _pytree

_EMPTY = Parameter.empty


def is_pytorch_model(model_type: Optional[type]) -> bool:
    """True when ``model_type`` is a torch ``nn.Module`` subclass (``utils.py:63-64``)."""
    if model_type is None or not isinstance(model_type, type):
        return False
    return any(base.__module__.startswith("torch") for base in model_type.__mro__)


def is_keras_model(model_type: Optional[type]) -> bool:
    """True when ``model_type`` is a keras model subclass (``utils.py:67-68``)."""
    if model_type is None or not isinstance(model_type, type):
        return False
    return any(base.__module__.startswith(("keras", "tensorflow.python.keras")) for base in model_type.__mro__)


def is_sklearn_model(obj_or_type: Any) -> bool:
    try:
        import sklearn.base
    except ImportError:  # pragma: no cover
        return False
    if isinstance(obj_or_type, type):
        return issubclass(obj_or_type, sklearn.base.BaseEstimator)
    return isinstance(obj_or_type, sklearn.base.BaseEstimator)


def module_is_installed(module: str) -> bool:
    """``utils.py:71-76`` parity."""
    try:
        importlib.import_module(module)
        return True
    except ImportError:
        return False


def pick_free_port() -> int:
    """Reserve an ephemeral localhost port (bind-probe; small TOCTOU window applies)."""
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def hard_sync(tree: Any) -> None:
    """Block until the work producing every CUDA tensor in ``tree`` is done:
    ``torch.cuda.synchronize`` once per device the tree's tensors lie on.
    CPU tensors and other leaves need no barrier."""
    devices = {leaf.device for leaf in _pytree.tree_leaves(tree) if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def to_device_arrays(*arrays: Any, device: Union[str, torch.device]) -> Tuple[Any, ...]:
    """Convert host data (pandas / numpy / lists / tensors) to tensors on ``device``.

    The host->device boundary of the default data pipeline: pandas objects go
    through ``.to_numpy()``; float64 data becomes float32, as in the JAX
    package; dicts keep their keys (multi-input features).
    """
    out = []
    for array in arrays:
        if isinstance(array, dict):
            out.append({k: to_device_arrays(v, device=device)[0] for k, v in array.items()})
            continue
        if isinstance(array, torch.Tensor):
            out.append((array.float() if array.dtype == torch.float64 else array).to(device))
            continue
        if hasattr(array, "to_numpy"):
            array = array.to_numpy()
        array = np.asarray(array)
        if array.dtype == np.float64:
            array = array.astype(np.float32)
        out.append(torch.tensor(array, device=device))  # a copy: host data never aliases the tensor
    return tuple(out)


def make_json_dataclass(name: str, field_specs: Sequence[Tuple], bases: Tuple[type, ...] = ()) -> Type:
    """``make_dataclass`` with ``to_dict``/``from_dict``/``to_json``/``from_json`` methods.

    Stands in for the reference's ``dataclasses_json`` decoration of synthesized kwargs
    dataclasses (``unionml/dataset.py:251``, ``model.py:201-203``) without the external
    dependency.
    """
    import json

    cls = make_dataclass(name, field_specs, bases=bases)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls_, data: Mapping[str, Any]):
        names = {f.name for f in fields(cls_)}
        return cls_(**{k: v for k, v in data.items() if k in names})

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls_, raw: str):
        return cls_.from_dict(json.loads(raw))

    cls.to_dict = to_dict
    cls.from_dict = from_dict
    cls.to_json = to_json
    cls.from_json = from_json
    return cls


def kwargs_field_specs(
    fn: Callable,
    default_overrides: Optional[Mapping[str, Any]] = None,
    skip_first: int = 1,
) -> List[Tuple]:
    """Field specs for a kwargs dataclass synthesized from ``fn``'s trailing parameters.

    Mirrors the synthesis at ``unionml/dataset.py:240-280``: the first ``skip_first``
    parameters (the data argument) are dropped; defaults come from ``default_overrides``
    first, then the signature.
    """
    default_overrides = default_overrides or {}
    specs: List[Tuple] = []
    for index, param in enumerate(signature(fn).parameters.values()):
        if index < skip_first:
            continue
        default = default_overrides.get(param.name, param.default)
        annotation = param.annotation if param.annotation is not _EMPTY else Any
        if default is _EMPTY:
            specs.append((param.name, annotation))
        elif isinstance(default, (list, dict, set)):
            specs.append((param.name, annotation, field(default_factory=lambda d=default: d)))
        else:
            specs.append((param.name, annotation, field(default=default)))
    return specs
