"""Admission queue of the port's batcher: arrival order, bounded.

The JAX package's ``serving/scheduler.py`` is an SLO scheduler (priority
classes, aging, deadlines, preemption). For requests that carry no priority
or deadline it behaves as a bounded FIFO, which is what this slice ports:
``max_queue`` (default 256, ``scheduler.py:150``) bounds the queued requests,
and a submit against a full queue fails with :class:`QueueFullError`.
"""

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np

__all__ = ["QueueFullError", "SchedulingError", "Ticket", "FifoQueue"]


class SchedulingError(RuntimeError):
    """Base of every structured scheduling rejection (``reason`` is a slug)."""

    reason = "scheduling_error"


class QueueFullError(SchedulingError):
    """Shed: the bounded queue is full."""

    reason = "queue_full"


@dataclasses.dataclass
class Ticket:
    """One queued request."""

    prompt: np.ndarray
    budget: int
    sampling: Dict[str, Any]
    sink: Any
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)


class FifoQueue:
    """Bounded arrival-order queue. Not thread-safe: the batcher guards it."""

    def __init__(self, max_queue: int = 256) -> None:
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue)
        self._queued: Deque[Ticket] = collections.deque()

    def __len__(self) -> int:
        return len(self._queued)

    def submit(self, ticket: Ticket) -> None:
        if len(self._queued) >= self.max_queue:
            raise QueueFullError(f"queue full ({self.max_queue} requests waiting)")
        self._queued.append(ticket)

    def peek(self) -> Optional[Ticket]:
        return self._queued[0] if self._queued else None

    def pop(self) -> Ticket:
        return self._queued.popleft()

    def drain(self) -> List[Ticket]:
        tickets = list(self._queued)
        self._queued.clear()
        return tickets
