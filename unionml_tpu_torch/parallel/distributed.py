"""Joining N processes into one ``torch.distributed`` world.

Port of ``unionml_tpu/parallel/distributed.py``. Where the JAX package joins
hosts into one ``jax.distributed`` controller, the port runs one process per
card (SPMD, PyTorch's idiom): :func:`initialize_distributed` starts the
default process group, after which :func:`~unionml_tpu_torch.parallel.mesh.make_mesh`
lays a ``DeviceMesh`` over the world. The backend is ``nccl`` for CUDA
devices and ``gloo`` for ``device="cpu"``.

The address, world size and rank come from the arguments, else from
torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``). Nothing on a sealed machine tells a program of a
cluster, so a caller outside torchrun passes them itself
(``tcp://localhost:<port>``).
"""

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from unionml_tpu_torch._logging import logger

__all__ = ["collective_timeout_s", "initialize_distributed", "is_primary_host"]

#: the ``timeout_s`` the world was started with (:func:`initialize_distributed`)
_timeout_s: Optional[float] = None


def _int_env(name: str) -> Optional[int]:
    value = os.getenv(name)
    return int(value) if value is not None else None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    strict: bool = False,
    *,
    device="cuda",
    timeout_s: Optional[float] = None,
) -> bool:
    """Idempotently start the default process group; returns True when the
    world is up (``distributed.py:21-67``).

    ``coordinator_address`` is ``host:port`` or a ``tcp://`` URL (default:
    ``MASTER_ADDR``/``MASTER_PORT``); ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``. With no address and no world size
    in sight, a single-process context stays uninitialized (returns False).
    ``strict=True`` re-raises an init failure: a silent single-process
    fallback would make every process believe it is rank 0 and run N
    uncoordinated copies of the job. On a CUDA device each process binds
    ``torch.cuda.set_device(LOCAL_RANK)`` first. ``timeout_s`` bounds every
    collective (default: the backend's)."""
    if dist.is_initialized():
        return True
    device = torch.device(device)
    if coordinator_address is None and os.getenv("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.getenv('MASTER_PORT', '29500')}"
    num_processes = num_processes if num_processes is not None else _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")
    try:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("no coordinator address, world size or rank given or in the environment "
                             "(MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK)")
        address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            local = _int_env("LOCAL_RANK")
            torch.cuda.set_device(process_id if local is None else local)
        kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=float(timeout_s))}
        dist.init_process_group(backend, init_method=address, world_size=int(num_processes),
                                rank=int(process_id), **kwargs)
        global _timeout_s
        _timeout_s = None if timeout_s is None else float(timeout_s)
        logger.info("torch.distributed initialized: rank %d of %d over %s", dist.get_rank(),
                    dist.get_world_size(), backend)
        return True
    except (RuntimeError, ValueError) as exc:
        if strict:
            raise
        # single-process contexts (unit tests, one card) are fine without init
        logger.info("torch.distributed not initialized (%s); continuing single-process.", exc)
        return False


def collective_timeout_s() -> float:
    """The seconds a collective may wait: the ``timeout_s`` the world was
    started with, else gloo's default (a process group started elsewhere
    keeps its own; groups made for host messages take this one)."""
    return _timeout_s if _timeout_s is not None else dist.default_pg_timeout.total_seconds()


def is_primary_host() -> bool:
    """True on the process responsible for writing outputs and checkpoints
    (rank 0, or the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
