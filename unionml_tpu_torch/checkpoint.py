"""Persistence: framework-aware model serialization + step-level checkpointing.

Port of ``unionml_tpu/checkpoint.py``:

- :func:`default_save` / :func:`default_load` — the model's default saver and
  loader. The port's ``TrainState``, ``nn.Module``s and trees of tensors are
  written with ``torch.save`` as CPU tensors plus the hyperparameters, in a
  payload that loads with ``torch.load(weights_only=True)``; sklearn objects
  go through ``joblib`` (imported only for them), keras models through
  ``model.save``.
- :class:`Checkpointer` — step checkpoints with ``max_to_keep`` and
  ``save_interval_steps``. ``save`` copies the state to host memory before it
  returns (the train step updates the state in place, so the next step must
  not race the writer); a background thread writes the copy, as orbax's async
  save does. :meth:`Checkpointer.flush` waits for pending writes.
- :func:`install_preemption_handler` — flush on SIGTERM, then exit.

A ``TrainState`` restores in place into a target built from the same
hyperparameters (the app's ``init``): its parameters, moments and step are
copied bitwise; its model and optimizer settings are the target's own.

A ``TrainState`` laid out on a mesh (``models/training.py::shard_train_state``)
saves whole: :func:`extract_state` gathers each leaf from every rank's shard
(a collective every rank joins, in the same order) and only rank 0's
:class:`Checkpointer` writes. :func:`restore_state` into a laid-out target
cuts each whole leaf down to this rank's shard and keeps the target's
layout, so ``fit(checkpoint_dir=..., mesh=...)`` resumes at the same world
size. Multi-host stores (a directory each host cannot see) are not ported
(ROADMAP: M12, the multi-host backend and store).
"""

import os
import queue
import shutil
import threading
from pathlib import Path
from typing import IO, Any, Callable, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.parallel.distributed import is_primary_host
from unionml_tpu_torch.utils import is_keras_model, is_pytorch_model, is_sklearn_model

FileLike = Union[str, os.PathLike, IO]

#: tag embedded in serialized payloads so the loader can dispatch without the model type
_FORMAT_KEY = "__unionml_tpu_torch_format__"
_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's zip container


def _is_train_state(obj: Any) -> bool:
    from unionml_tpu_torch.models.training import TrainState

    return isinstance(obj, TrainState)


def _to_host(leaf: Any) -> Any:
    """A host copy of one leaf: tensors detached onto the CPU (cloned when
    already there, so an in-place update of the original cannot reach it),
    numpy arrays as tensors, anything else as it is."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf.copy())
    if isinstance(leaf, np.generic):
        return leaf.item()
    return leaf


def extract_state(obj: Any) -> Any:
    """Pure-data host copy of a model object: a ``TrainState``'s parameters,
    moments (by parameter name) and step; a module's state dict; or a tree
    (dicts, lists, tuples) of tensors, arrays and scalars."""
    if _is_train_state(obj):
        layout = obj.layout

        def whole(group: str) -> dict:
            leaves = getattr(obj, group)
            if layout is None:
                return {n: _to_host(t) for n, t in zip(obj.names, leaves)}
            return {n: _to_host(layout.gather(i, t)) for i, (n, t) in enumerate(zip(obj.names, leaves))}

        return {"params": whole("params"), "mu": whole("mu"), "nu": whole("nu"), "step": int(obj.step)}
    if isinstance(obj, nn.Module):
        return {k: _to_host(v) for k, v in obj.state_dict().items()}
    return _pytree.tree_map(_to_host, obj)


@torch.no_grad()
def restore_state(target: Any, state: Any) -> Any:
    """Inverse of :func:`extract_state`: ``TrainState`` and module targets
    are filled in place (bitwise copies; a laid-out ``TrainState``'s each
    rank with its shard) and returned; a tree target comes
    back as a new tree whose tensors take the target leaves' device and
    dtype."""
    if _is_train_state(target):
        for group in ("params", "mu", "nu"):
            saved = state[group]
            missing = set(target.names) ^ set(saved)
            if missing:
                raise ValueError(f"checkpoint {group} do not match the target's parameters: {sorted(missing)}")
            for i, (name, tensor) in enumerate(zip(target.names, getattr(target, group))):
                whole = saved[name]
                tensor.copy_(whole if target.layout is None else target.layout.shard(i, whole.to(tensor.device)))
        target.step = int(state["step"])
        return target
    if isinstance(target, nn.Module):
        target.load_state_dict(state)
        return target
    target_leaves, spec = _pytree.tree_flatten(target)
    saved_leaves, saved_spec = _pytree.tree_flatten(state)
    if str(spec) != str(saved_spec):
        raise ValueError(f"checkpoint structure {saved_spec} does not match the target's {spec}")

    def place(want: Any, got: Any) -> Any:
        if isinstance(want, torch.Tensor):
            return torch.as_tensor(got).to(device=want.device, dtype=want.dtype)
        return got

    return _pytree.tree_unflatten([place(w, g) for w, g in zip(target_leaves, saved_leaves)], spec)


def _is_tensor_tree(obj: Any) -> bool:
    """True when obj is a non-trivial tree whose leaves are all tensors/arrays/scalars."""
    leaves = _pytree.tree_leaves(obj)
    if not leaves or (len(leaves) == 1 and leaves[0] is obj and not isinstance(obj, (torch.Tensor, np.ndarray))):
        return False
    return all(isinstance(leaf, (torch.Tensor, np.ndarray, np.generic, float, int, bool)) for leaf in leaves)


def default_save(
    model_obj: Any,
    hyperparameters: Optional[dict],
    file: FileLike,
    *args,
    model_type: Optional[type] = None,
    **kwargs,
) -> Any:
    """Framework-aware default saver (``unionml_tpu/checkpoint.py:111-135``)."""
    if is_sklearn_model(model_obj):
        import joblib

        joblib.dump({_FORMAT_KEY: "sklearn", "model_obj": model_obj, "hyperparameters": hyperparameters}, file)
        return file
    if _is_train_state(model_obj):
        kind = "train_state"
    elif isinstance(model_obj, nn.Module):
        kind = "module"
    elif is_keras_model(type(model_obj)):
        model_obj.save(file, *args, **kwargs)
        return file
    elif _is_tensor_tree(model_obj):
        kind = "tree"
    else:
        raise NotImplementedError(
            f"Default saver not defined for type {type(model_obj)}. Use the Model.saver decorator to define one."
        )
    payload = {_FORMAT_KEY: kind, "model_obj": extract_state(model_obj), "hyperparameters": hyperparameters}
    torch.save(payload, file, *args, **kwargs)
    return file


def _is_torch_file(file: FileLike) -> bool:
    if hasattr(file, "read"):
        position = file.tell()
        magic = file.read(4)
        file.seek(position)
        return magic == _ZIP_MAGIC
    with open(file, "rb") as f:
        return f.read(4) == _ZIP_MAGIC


def default_load(
    file: FileLike,
    *args,
    model_type: Optional[type] = None,
    init_fn: Optional[Callable[[dict], Any]] = None,
    **kwargs,
) -> Any:
    """Framework-aware default loader (``unionml_tpu/checkpoint.py:138-172``).

    A ``torch.save`` payload loads with ``weights_only=True`` onto the CPU; a
    ``TrainState`` or module is rebuilt by ``init_fn(hyperparameters)`` (else
    ``model_type(**hyperparameters)`` for a module) and filled in place.
    """
    if model_type is not None and is_keras_model(model_type):
        import keras  # standalone keras 3; also provided by tensorflow installs

        return keras.models.load_model(file)
    if not _is_torch_file(file):
        import joblib  # sklearn payloads

        payload = joblib.load(file)
        if isinstance(payload, dict) and "model_obj" in payload:
            return payload["model_obj"]
        return payload

    payload = torch.load(file, *args, map_location="cpu", weights_only=True, **kwargs)
    kind = payload.get(_FORMAT_KEY)
    hyperparameters = payload.get("hyperparameters") or {}
    state = payload["model_obj"]
    if kind in ("train_state", "module") or (kind is None and model_type is not None and is_pytorch_model(model_type)):
        if init_fn is not None:
            target = init_fn(hyperparameters)
        elif model_type is not None:
            target = model_type(**hyperparameters)
        else:
            raise ValueError(f"loading a saved {kind} needs the model's init (or a model type) to rebuild it")
        return restore_state(target, state)
    if kind == "tree" and init_fn is not None:
        return restore_state(init_fn(hyperparameters), state)
    return state


class Checkpointer:
    """Step-level checkpointing for long-running trainers.

    Usage::

        ckpt = Checkpointer(dir, max_to_keep=3)
        start_step = ckpt.latest_step() or 0
        state = ckpt.restore(state) if start_step else state
        for step in range(start_step, n_steps):
            state = train_step(state, batch)
            ckpt.save(step, state)   # host copy now; the file is written in the background
        ckpt.close()

    Each step lands in ``<directory>/<step>/state.pt``, written under a
    temporary name and renamed when complete, so a step directory is always
    whole. ``save`` keeps every ``save_interval_steps``-th step (``step %
    interval == 0``, as orbax decides) and, once a write lands, removes all
    but the newest ``max_to_keep``. A failed background write is raised by
    the next ``save`` or ``flush``.

    In a ``torch.distributed`` world only rank 0 writes; every rank decides
    alike which steps to save (the steps on disk when it was made and those
    it saved since), so a laid-out state's gather runs on all of them.
    """

    def __init__(self, directory: Union[str, os.PathLike], max_to_keep: int = 3, save_interval_steps: int = 1):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(int(save_interval_steps), 1)
        self._queue: "queue.Queue" = queue.Queue()
        self._error_lock = threading.Lock()
        self._error: Optional[BaseException] = None  # guarded-by: _error_lock
        #: steps saved or found on disk: the same on every rank of a world
        self._known = set(self._steps())
        self._writer = threading.Thread(target=self._write_loop, name="checkpoint-writer", daemon=True)
        self._writer.start()

    def _steps(self):
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / "state.pt").is_file())

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _raise_pending_error(self) -> None:
        # taken and cleared in one step: a failure the writer records meanwhile is kept for the next call
        with self._error_lock:
            error, self._error = self._error, None
        if error is not None:
            raise RuntimeError("a background checkpoint write failed") from error

    def save(self, step: int, state: Any) -> bool:
        """Snapshot ``state`` to host memory and queue its write; False when
        the interval skips this step (or it is already saved)."""
        self._raise_pending_error()
        if step % self.save_interval_steps or step in self._known:
            return False
        self._known.add(int(step))
        host_state = extract_state(state)
        if is_primary_host():
            self._queue.put((int(step), host_state))
        return True

    def _write_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, host_state = item
                tmp = self.directory / f"{step}.tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                tmp.mkdir()
                torch.save({"step": step, "state": host_state}, tmp / "state.pt")
                os.replace(tmp, self.directory / str(step))
                for old in self._steps()[: -self.max_to_keep]:
                    shutil.rmtree(self.directory / str(old), ignore_errors=True)
            except Exception as exc:  # the writer thread must keep serving; the next save/flush raises it
                logger.exception("checkpoint write failed")
                with self._error_lock:
                    self._error = exc
            finally:
                self._queue.task_done()

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Restore step ``step`` (default: the latest) into ``target``
        (see :func:`restore_state`)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoint found under {self.directory}")
        payload = torch.load(self.directory / str(step) / "state.pt", map_location="cpu", weights_only=True)
        return restore_state(target, payload["state"])

    def flush(self) -> None:
        """Block until pending background writes land (preemption-safe shutdown)."""
        self._queue.join()
        self._raise_pending_error()

    def close(self) -> None:
        self.flush()
        if self._writer.is_alive():
            self._queue.put(None)
            self._writer.join(timeout=60)


def install_preemption_handler(checkpointer: Checkpointer) -> None:
    """Flush checkpoints on SIGTERM, then run the previous handler or exit 143
    (``unionml_tpu/checkpoint.py:237-251``)."""
    import signal

    previous = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        logger.warning("SIGTERM received: flushing checkpoints before exit.")
        checkpointer.flush()
        if callable(previous):
            previous(signum, frame)
        else:
            raise SystemExit(143)

    signal.signal(signal.SIGTERM, _handler)
