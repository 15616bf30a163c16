"""The structured engine-failure error (the ``EngineFailure`` part of
``unionml_tpu/serving/faults.py``). Fault injection (``FaultPlan``) is not
ported yet."""

__all__ = ["EngineFailure"]


class EngineFailure(RuntimeError):
    """A structured engine-side failure delivered to a request.

    ``reason`` is a machine-readable slug (``pool_exhausted``, ``nan_logits``,
    ``prefill_failed``, ``engine_failure``, ``batcher_closed``, ...);
    ``retryable`` states whether a client retry can plausibly succeed.
    """

    def __init__(self, message: str, *, reason: str, retryable: bool = True) -> None:
        super().__init__(message)
        self.reason = reason
        self.retryable = retryable
