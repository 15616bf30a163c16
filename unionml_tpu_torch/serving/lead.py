"""Rank 0 leads and the other ranks follow: the host protocol of a meshed serving object.

A meshed serving object (the tensor-parallel
:class:`~unionml_tpu_torch.serving.continuous.DecodeEngine`, the meshed
:class:`~unionml_tpu_torch.serving.resident.ResidentPredictor`) is SPMD: every
rank must make the same calls in the same order, so that each rank's
collectives meet the others'. Rank 0 of the mesh takes the requests; each of
its *led* calls is sent to the other ranks before it runs, and they replay it
(:meth:`MeshLead.follow`) until rank 0 releases them (:meth:`MeshLead.stop`).

One led call costs one all-reduce (MAX) of a small int64 header over a gloo
side group (host messages, whatever the card's backend), plus one pickled
broadcast when its arguments are not a few ints. The header also carries
every rank's outcome of its previous call, so a call that raised on some
ranks only ends every rank's run with :class:`MeshDivergence` at the next
message. A leader idle for a quarter of the side group's timeout sends a
no-op (:meth:`MeshLead.keep_alive`), so a follower's wait never reaches it.
"""

import datetime
import functools
import pickle
import time
import zlib
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["MeshDivergence", "MeshLead", "lead_calls", "leads"]


class MeshDivergence(RuntimeError):
    """The ranks of a meshed serving object no longer hold the same state: a
    led call raised on some ranks and not on others. Every rank raises it,
    and the object refuses every later call."""


#: the leader's other messages: release the followers, or keep them waiting
_STOP, _PING = 0, 1
#: int arguments a message carries in its header (more, or others, are pickled)
_PACKED = 4
#: header: op, packed-argument count (-1: pickled), payload bytes, the
#: packed arguments, then the sender's outcome of its last call and its negation
_HEADER = 3 + _PACKED + 2
#: a follower's share of the leader's fields: the MAX reduce keeps the leader's
_NONE = -(2 ** 63)


def leads(method):
    """Make ``method`` a led call of a meshed object (one whose ``_lead`` is
    a :class:`MeshLead`); on an unmeshed object, or inside another led
    call, it runs as it is."""
    name = method.__name__

    @functools.wraps(method)
    def led(self, *args, **kwargs):
        lead = self._lead
        if lead is None or lead.depth:
            return method(self, *args, **kwargs)
        return lead.run(self, name, method, args, kwargs)

    led.leads = True
    return led


def lead_calls(cls, names: Sequence[str]) -> None:
    """Make the calls of ``names`` that ``cls`` defines lead; an override in
    a subclass leads too, and its nested base call is not sent again."""
    for name in names:
        method = cls.__dict__.get(name)
        if method is not None and not getattr(method, "leads", False):
            setattr(cls, name, leads(method))


def _outcome(error: Optional[BaseException]) -> int:
    """A call's outcome as a number every rank computes alike: 0 for a
    return, else a code of the exception's class."""
    return 0 if error is None else (zlib.crc32(type(error).__name__.encode()) & 0x3FFFFFFF) + 1


class MeshLead:
    """Rank 0 of ``mesh`` leads the calls named in ``calls``; the other
    ranks follow.

    ``group`` is a gloo group over the mesh's ranks with ``timeout_s``. The
    leader waits for each message before it runs its call, so a follower
    that left on a divergence never leaves it inside a collective the
    follower will not join. A subclass may rewrite arguments on the way
    (:meth:`_encode` on the leader, :meth:`_decode` on a follower) and note
    each call's result (:meth:`_settled`)."""

    def __init__(self, mesh: Any, timeout_s: float, calls: Sequence[str]) -> None:
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        self.group = dist.new_group(ranks, backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
        self.keepalive_s = timeout_s / 4
        self.calls = tuple(calls)
        self.leader = ranks[0]
        self.rank = dist.get_rank()
        #: led calls in progress on this rank (a nested one is not sent)
        self.depth = 0
        self.broken: Optional[str] = None
        #: the leader released the followers (:meth:`stop`) and made no led
        #: call since: another stop is a no-op, and nothing keeps them alive
        self.stopped = False
        #: this rank's last led call and its outcome, sent with the next message
        self._last, self._outcome = "", 0
        self._sent = time.monotonic()

    @property
    def is_leader(self) -> bool:
        return self.rank == self.leader

    def _check(self) -> None:
        if self.broken is not None:
            raise MeshDivergence(self.broken)

    def _exchange(self, op: int = _NONE, packed: Optional[Tuple[int, ...]] = None,
                  payload: bytes = b"") -> Tuple[int, tuple, dict]:
        """One message: the leader's op and arguments to every rank, every
        rank's last outcome to all. A follower gets ``(op, args, kwargs)``."""
        fields = [_NONE] * _HEADER
        if self.is_leader:
            fields[:3] = [op, -1 if packed is None else len(packed), len(payload)]
            fields[3:3 + len(packed or ())] = packed or ()
        # graftlint: disable=data-race -- the owner serializes every call into its lead (ResidentPredictor._serial; a DecodeEngine's one driving thread)
        outcome, self._outcome = self._outcome, 0
        fields[-2:] = [outcome, -outcome]
        header = torch.tensor(fields, dtype=torch.int64)
        dist.all_reduce(header, op=dist.ReduceOp.MAX, group=self.group)
        # graftlint: disable=data-race -- the owner serializes every call into its lead (ResidentPredictor._serial; a DecodeEngine's one driving thread)
        self._sent = time.monotonic()
        values = header.tolist()
        if values[-2] != -values[-1]:
            # graftlint: disable=data-race -- the owner serializes every call into its lead (ResidentPredictor._serial; a DecodeEngine's one driving thread)
            self.broken = (f"rank {self.rank}'s {self._last}() {'raised' if outcome else 'returned'} where "
                           "another rank's did not: the mesh's ranks no longer hold the same state")
            raise MeshDivergence(self.broken)
        op, count, size = values[:3]
        if count >= 0:
            return op, tuple(values[3:3 + count]), {}
        if self.is_leader:
            dist.broadcast(torch.frombuffer(bytearray(payload), dtype=torch.uint8), src=self.leader,
                           group=self.group)
            return op, (), {}
        data = torch.empty(size, dtype=torch.uint8)
        dist.broadcast(data, src=self.leader, group=self.group)
        args, kwargs = self._decode(pickle.loads(data.numpy().tobytes()))
        return op, args, kwargs

    def run(self, obj: Any, name: str, method, args: tuple, kwargs: dict) -> Any:
        """The leader's led call: send, then run."""
        if not self.is_leader:
            raise RuntimeError(f"rank {self.rank} follows rank {self.leader} of this meshed {type(obj).__name__}: "
                               f"call follow(), not {name}()")
        self._check()
        packed = None
        if not kwargs and len(args) <= _PACKED and all(type(a) is int and abs(a) < 2 ** 62 for a in args):
            packed = tuple(args)
        payload = b"" if packed is not None else pickle.dumps((self._encode(args), self._encode(kwargs)))
        # after a stop the followers are to follow() again
        # graftlint: disable=data-race -- the owner serializes every call into its lead (ResidentPredictor._serial; a DecodeEngine's one driving thread)
        self.stopped = False
        self._exchange(2 + self.calls.index(name), packed, payload)
        result, error = self._settle(name, lambda: method(obj, *args, **kwargs))
        if error is not None:
            raise error
        return result

    def follow(self, obj: Any) -> int:
        """Replay the leader's calls on ``obj`` until it stops; returns how many ran."""
        calls = 0
        while True:
            self._check()
            op, args, kwargs = self._exchange()
            if op == _STOP:
                self.stopped = True
                return calls
            if op == _PING:
                continue
            name = self.calls[op - 2]
            # an error here the leader's outcome meets at the next message
            self._settle(name, lambda: getattr(obj, name)(*args, **kwargs))
            calls += 1

    def stop(self) -> None:
        if self.is_leader and self.broken is None and not self.stopped:
            self.stopped = True
            self._exchange(_STOP, ())

    def keep_alive(self) -> None:
        if (self.is_leader and self.broken is None and not self.stopped and not self.depth
                and time.monotonic() - self._sent >= self.keepalive_s):
            self._exchange(_PING, ())

    def _settle(self, name: str, call) -> Tuple[Any, Optional[Exception]]:
        # graftlint: disable=data-race -- the owner serializes every call into its lead (ResidentPredictor._serial; a DecodeEngine's one driving thread)
        self.depth += 1
        try:
            result, error = call(), None
        except Exception as exc:
            result, error = None, exc
        finally:
            self.depth -= 1
        # graftlint: disable=data-race -- the owner serializes every call into its lead (ResidentPredictor._serial; a DecodeEngine's one driving thread)
        self._last, self._outcome = name, _outcome(error)
        self._settled(result)
        return result, error

    def _settled(self, result: Any) -> None:
        """Note one led call's result on this rank (nothing by default)."""

    def _encode(self, value: Any) -> Any:
        return value

    def _decode(self, value: Any) -> Any:
        return value
