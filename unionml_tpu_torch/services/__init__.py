"""Optional serving adapters: BentoML-style packaging and serverless event handlers.

A port of ``unionml_tpu/services/``: both import without their optional
dependency (``bentoml``; the event handler needs none).

Reference parity: ``unionml/services/__init__.py:4-6`` conditionally exposes the
bentoml integration; the serverless handler replaces the reference's Mangum/AWS-Lambda
*pattern* (shipped only via templates/tests there) with a first-class adapter.
"""

from unionml_tpu_torch.services.bentoml_service import (  # noqa: F401
    BentoMLService,
    create_runnable,
    create_service,
    infer_io_descriptors,
)
from unionml_tpu_torch.services.event_handler import make_event_handler

__all__ = [
    "BentoMLService",
    "create_runnable",
    "create_service",
    "infer_io_descriptors",
    "make_event_handler",
]
