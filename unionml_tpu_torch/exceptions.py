"""Exception hierarchy of the port (a copy of ``unionml_tpu/exceptions.py``).

Reference parity: ``unionml/exceptions.py:4`` defines only ``ModelArtifactNotFound``; the
rebuild grows a small hierarchy covering the stage runtime, backend, and scheduling
subsystems (SURVEY.md §2 row 14).
"""


class UnionMLError(Exception):
    """Base class for all unionml_tpu_torch errors."""


class ModelArtifactNotFound(UnionMLError):
    """Raised when a model artifact cannot be resolved from any source."""


class VersionFetchError(UnionMLError):
    """Raised when an app version cannot be derived (e.g. dirty git tree).

    Reference parity: ``unionml/remote.py:26-27``.
    """


class StageError(UnionMLError):
    """Raised when a stage fails to execute or compile."""


class WorkflowError(UnionMLError):
    """Raised when a workflow graph is malformed or fails to execute."""


class BackendError(UnionMLError):
    """Raised by the execution backend (job submission, artifact store)."""


class ScheduleError(UnionMLError):
    """Raised for invalid schedule specifications."""


class TrackingError(UnionMLError):
    """Raised when a tracked instance cannot be resolved to a module-level variable."""
