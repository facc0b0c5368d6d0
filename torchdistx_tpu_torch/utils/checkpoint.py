"""Checkpoint/resume of the training state.

Counterpart of ``torchdistx_tpu/utils/checkpoint.py`` (``save_state``,
``restore_state``, ``latest_step`` and :class:`Checkpointer`, with the same
retry, fault site and pure-read rules).  The JAX package stores through
orbax, which the port does not have: the port stores with ``torch.save`` and
loads with ``torch.load(weights_only=True, mmap=True)``.  Reading orbax
checkpoints written by the JAX package (or the reverse) is out of scope.

**Layout.**  One directory per committed step under the checkpoint
directory, named by the integer as orbax names them, holding ``state.pt``.
A save writes into a temporary directory beside it (``<step>.tmp``), fsyncs
the file, and commits with an atomic ``os.rename``: a failed or killed save
leaves no committed step.

**What is stored.**  A :class:`~torchdistx_tpu_torch.parallel.train_step.
TrainState` is stored as ``{"model": model.state_dict(), "optimizer":
optimizer.state_dict(), "step": step}``; any other state (nested dicts,
lists and tuples of tensors and Python scalars) as it is.  Restoring into a
``TrainState`` target loads in place with ``load_state_dict`` on its model
and optimizer, so the card never holds two states (the JAX package restores
into ``eval_shape`` targets for the same reason).

**Async save.**  The port's state updates in place: the next ``step_fn``
changes the model and the optimizer's moments.  So ``save(wait=False)``
takes its snapshot before it returns: CUDA tensors are copied into pinned
host memory with ``non_blocking=True`` on the current stream and an event
is recorded after the copies (stream order puts the next step's in-place
updates after them); CPU tensors are cloned.  A writer thread waits on the
event, then writes and commits; :meth:`Checkpointer.wait_until_finished`
joins it and re-raises its error.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional

import torch
import torch.utils._pytree as pytree

from .. import telemetry as _telemetry
from ..resilience import faults as _faults
from ..resilience.retry import RetryPolicy

__all__ = ["save_state", "restore_state", "latest_step", "Checkpointer"]

# Granted retries of checkpoint IO (save dispatch, write + restore), visible
# in traces so flaky storage degrades loudly instead of silently.
_T_CKPT_RETRIES = _telemetry.counter("ckpt.retries")

_FILE = "state.pt"


def _to_tree(state: Any) -> Any:
    """The storable form of ``state`` (a TrainState becomes state dicts)."""
    from ..parallel.train_step import TrainState

    if isinstance(state, TrainState):
        return {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(), "step": state.step}
    return state


def _snapshot(tree: Any):
    """``(copy, events)``: ``tree`` with every tensor copied to host memory
    that later in-place updates of the originals cannot reach, and one CUDA
    event per device recorded after its copies were queued."""
    devices = set()

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if not x.is_cuda:
            return x.clone()
        devices.add(x.device)
        dst = torch.empty_like(x, device="cpu", pin_memory=True)
        dst.copy_(x, non_blocking=True)
        return dst

    out = pytree.tree_map(copy, tree)
    events = []
    for device in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        events.append(ev)
    return out, events


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _commit(path: str, tree: Any) -> None:
    """Write ``tree`` to the step directory ``path`` through a temporary
    directory and an atomic rename."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)  # left by a killed save
    os.makedirs(tmp)
    with open(os.path.join(tmp, _FILE), "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _load(path: str) -> Any:
    return torch.load(os.path.join(path, _FILE), map_location="cpu",
                      weights_only=True, mmap=True)


def _restore_into(target: Any, tree: Any) -> Any:
    """``tree`` loaded into ``target`` in place (a TrainState), or ``tree``
    itself with no target."""
    from ..parallel.train_step import TrainState

    if target is None:
        return tree
    if not isinstance(target, TrainState):
        raise TypeError(f"restore target must be a TrainState or None, not "
                        f"{type(target).__name__}")
    target.model.load_state_dict(tree["model"])
    target.optimizer.load_state_dict(tree["optimizer"])
    return TrainState(target.model, target.optimizer, tree["step"])


def save_state(path: str | os.PathLike, state: Any, *, force: bool = False) -> None:
    """Write ``state`` (a TrainState, or nested containers of tensors) to the
    directory ``path``; an existing ``path`` raises unless ``force``."""
    path = os.fspath(path)
    if os.path.exists(path):
        if not force:
            raise FileExistsError(f"checkpoint {path} exists (pass force=True)")
        shutil.rmtree(path)
    snap, events = _snapshot(_to_tree(state))
    for ev in events:
        ev.synchronize()
    _commit(path, snap)


def restore_state(path: str | os.PathLike, *, target: Optional[Any] = None) -> Any:
    """Read the state saved at ``path``: loaded into ``target`` (a
    TrainState, in place; returns a TrainState with the saved step) or, with
    no target, as the stored tree on the CPU."""
    return _restore_into(target, _load(os.fspath(path)))


def _committed_steps(directory: str) -> list:
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


class Checkpointer:
    """Step-numbered checkpoint manager for a training run.

    ``Checkpointer(dir).save(step, state)`` keeps the ``max_to_keep`` most
    recent steps (``None`` keeps all); ``restore_latest(target=...)``
    resumes.  Saving a step that is already committed does nothing, as with
    orbax.

    ``retry`` (a :class:`~torchdistx_tpu_torch.resilience.retry.RetryPolicy`)
    makes save dispatch, the write and restore survive transient IO errors —
    attempts beyond the first bump the ``ckpt.retries`` counter.  Saves are
    safe to re-enter: each writes into a fresh temporary directory and
    commits atomically, so a failed attempt leaves no committed step.
    """

    def __init__(
        self,
        directory: str | os.PathLike,
        *,
        max_to_keep: Optional[int] = 3,
        retry: Optional[RetryPolicy] = None,
    ):
        self.directory = os.fspath(directory)
        self.max_to_keep = max_to_keep
        self._retry = retry
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.directory, exist_ok=True)

    def _call(self, fn, *, site: str):
        if self._retry is None:
            return fn()
        return self._retry.call(fn, counter=_T_CKPT_RETRIES, site=site)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, *, wait: bool = True) -> None:
        """Write a checkpoint for ``step``.

        The state is snapshotted before this returns, so training may update
        it in place at once.  ``wait=False`` returns then and writes in a
        background thread — the overlap of checkpoint IO with the next
        steps.  Call :meth:`wait_until_finished` before relying on the
        files: a pending save is not seen by ``restore_latest`` until it
        commits.  One save is in flight at a time: a new ``save`` first
        waits for the last one (and raises its error).
        """
        self.wait_until_finished()

        def _dispatch():
            _faults.fire("ckpt.save", step)
            if step in _committed_steps(self.directory):
                return None
            return _snapshot(_to_tree(state))

        dispatched = self._call(_dispatch, site=f"ckpt.save[{step}]")
        if dispatched is None:
            return
        snap, events = dispatched

        def _write():
            for ev in events:
                ev.synchronize()
            self._call(lambda: _commit(self._step_dir(step), snap),
                       site=f"ckpt.write[{step}]")
            self._prune()

        if wait:
            _write()
            return
        self._writer = threading.Thread(target=self._run, args=(_write,),
                                        name=f"ckpt-save-{step}")
        self._writer.start()

    def _run(self, write) -> None:
        try:
            write()
        except BaseException as e:  # noqa: BLE001 — re-raised by wait_until_finished
            self._error = e

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        for old in _committed_steps(self.directory)[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Join the background save, if any, and raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        steps = _committed_steps(self.directory)
        return steps[-1] if steps else None

    def restore_latest(self, *, target: Any = None):
        """``(step, state)`` of the latest committed step, or ``(None,
        None)``.  With a TrainState ``target`` the state is loaded into it
        in place (see :func:`restore_state`)."""
        step = self.latest_step()
        if step is None:
            return None, None
        tree = self._call(lambda: _load(self._step_dir(step)),
                          site=f"ckpt.restore[{step}]")
        return step, _restore_into(target, tree)


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    """Latest committed step under ``directory``, or None.

    A pure read: querying a run that never checkpointed does not create its
    directory.
    """
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = _committed_steps(directory)
    return steps[-1] if steps else None
