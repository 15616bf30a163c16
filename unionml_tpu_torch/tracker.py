"""Instance tracking: resolve Dataset/Model objects back to importable module variables.

Why this exists: when a stage runs in a *different process* (a backend worker, a serving
replica, or one host of a multi-host TPU slice), the worker only receives a string triple
``(module, variable, stage)``. It must re-import the user's app module and find the same
``Dataset``/``Model`` object to rebuild the stage. This mirrors the reference's tracker
(``unionml/tracker.py:21-99``, built on flytekit's tracker) but is self-contained.

The ``__main__`` edge case: if the app module was executed as a script, its module name is
``__main__`` which is not importable elsewhere; we reconstruct an importable dotted name
from the file path relative to the current working directory (``tracker.py:23-34`` in the
reference does the same).
"""

import importlib
import importlib.util
import inspect
import sys
from pathlib import Path
from typing import Any, Optional, Tuple

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.exceptions import TrackingError


def import_module_from_file(module_name: str, file: str) -> Any:
    """Import a module object given its dotted name and source file path."""
    existing = sys.modules.get(module_name)
    if existing is not None:
        return existing
    try:
        spec = importlib.util.spec_from_file_location(module_name, file)
        assert spec is not None and spec.loader is not None
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
        return module
    except Exception as exc:
        sys.modules.pop(module_name, None)
        raise TrackingError(f"Module {module_name} could not be loaded from {file}") from exc


def _module_name_from_path(file: str) -> Optional[str]:
    """Derive an importable dotted module name for a script executed as __main__."""
    path = Path(file).resolve()
    cwd = Path.cwd().resolve()
    try:
        rel = path.relative_to(cwd)
    except ValueError:
        return None
    parts = rel.with_suffix("").parts
    if not parts:
        return None
    return ".".join(parts)


def _caller_module() -> Tuple[Optional[str], Optional[str]]:
    """Walk up the interpreter stack to the module-level frame that created the instance."""
    frame = inspect.currentframe()
    while frame is not None:
        globals_ = frame.f_globals
        if frame.f_code.co_name == "<module>" and "__name__" in globals_:
            name = globals_["__name__"]
            file = globals_.get("__file__")
            if name == "__main__":
                if file is None:
                    return None, None
                resolved = _module_name_from_path(file)
                return resolved, file
            return name, file
        frame = frame.f_back
    return None, None


class InstanceTrackingMeta(type):
    """Metaclass stamping each new instance with the module it was defined in."""

    def __call__(cls, *args, **kwargs):
        instance = super().__call__(*args, **kwargs)
        mod_name, mod_file = _caller_module()
        instance._instantiated_in = mod_name
        instance._module_file = mod_file
        return instance


class TrackedInstance(metaclass=InstanceTrackingMeta):
    """Base class for objects that must be re-importable by (module, variable) name."""

    def __init__(self, *args, **kwargs):
        self._instantiated_in: Optional[str] = None
        self._module_file: Optional[str] = None
        self._lhs: Optional[str] = None
        super().__init__(*args, **kwargs)

    @property
    def instantiated_in(self) -> Optional[str]:
        return self._instantiated_in

    def find_lhs(self) -> str:
        """Find the module-level variable name this instance is bound to.

        Reference parity: ``unionml/tracker.py:78-99`` — scan the defining module for a
        variable holding an object of the same type and name.
        """
        if self._lhs is not None:
            return self._lhs

        if self._instantiated_in is None:
            raise TrackingError(f"Instance {self!r} was not created at module scope; cannot track it.")

        try:
            module = sys.modules.get(self._instantiated_in) or importlib.import_module(self._instantiated_in)
        except ImportError:
            if self._module_file is None:
                raise TrackingError(f"Cannot import module {self._instantiated_in} and no source file is known.")
            module = import_module_from_file(self._instantiated_in, self._module_file)

        for varname in dir(module):
            try:
                candidate = getattr(module, varname)
            except AttributeError:  # pragma: no cover - defensive
                continue
            if candidate is self:
                self._lhs = varname
                return varname
        # fall back to matching by type + name for re-imported module copies
        for varname in dir(module):
            try:
                candidate = getattr(module, varname)
            except AttributeError:  # pragma: no cover - defensive
                continue
            # a re-imported module copy holds a distinct-but-equivalent class object, so
            # compare by qualified type name rather than identity
            if (
                type(candidate).__qualname__ == type(self).__qualname__
                and isinstance(candidate, TrackedInstance)
                and getattr(candidate, "name", None) == getattr(self, "name", None)
                and candidate.__dict__.get("_instantiated_in") == self._instantiated_in
            ):
                self._lhs = varname
                return varname

        logger.error("Could not find variable for %r in module %s", self, self._instantiated_in)
        raise TrackingError(f"Could not find a module-level variable for {self!r} in {self._instantiated_in}")


def load_tracked_instance(module_name: str, variable: str, module_file: Optional[str] = None) -> Any:
    """Worker-side rehydration: import the app module and return the tracked object.

    This is the process/machine boundary crossing used by the backend worker entrypoint
    (reference: ``unionml/task_resolver.py:16-31``).
    """
    try:
        module = sys.modules.get(module_name) or importlib.import_module(module_name)
    except ImportError:
        if module_file is None:
            raise
        module = import_module_from_file(module_name, module_file)
    try:
        return getattr(module, variable)
    except AttributeError as exc:
        raise TrackingError(f"Module {module_name} has no attribute {variable!r}") from exc
