"""Preemption flag: SIGTERM/SIGINT → a boolean checked at step boundaries.

Counterpart of ``torchdistx_tpu/resilience/preemption.py``.  Preemptible
cloud VMs get SIGTERM with a grace window; Ctrl-C is the
interactive equivalent.  A signal handler must not checkpoint (it can
interrupt arbitrary code, including a checkpoint mid-write) — it only sets a
flag here, and the flag's consumers act at their own safe boundaries:
the training loop (:func:`torchdistx_tpu_torch.parallel.fit.fit`) checks it at
each step boundary, where state is consistent, saves a final
checkpoint, flushes telemetry, and returns resumably; the serving
engine (the JAX package's ``serving.Engine``) checks it at each tick
and moves through its graceful-drain state machine — admission closed,
in-flight requests finished within the drain deadline, the remainder
failed with a retryable typed error.  Both clear the flag once acted
on (a platform that is really going down keeps signalling).

Semantics:

* :func:`install` is idempotent, chains to previously installed
  handlers, and degrades gracefully off the main thread (signal
  handlers can only be installed there; callers in worker threads get
  ``False`` and rely on :func:`request`).
* The FIRST signal sets the flag.  A SECOND signal of the same kind
  escalates to the previous handler — so a double Ctrl-C still raises
  ``KeyboardInterrupt`` and a double SIGTERM still runs the outer
  framework's handler; graceful draining never traps the operator.
* :func:`request` sets the flag programmatically — for tests and for
  cluster preemption-notice APIs (GCE metadata watcher, k8s preStop)
  that learn about preemption without a signal.

Multihost note: the flag is HOST-LOCAL (the scheduler may signal hosts
at different times).  ``fit()`` agrees on it across hosts with
:func:`torchdistx_tpu_torch.parallel.distributed.any_flag` before acting, so
every host checkpoints the same step.

Each signal received bumps the ``preempt.signals`` telemetry counter.
"""

from __future__ import annotations

import signal
import threading
from typing import Dict, Iterable

from .. import telemetry as _telemetry

__all__ = [
    "clear",
    "install",
    "installed",
    "request",
    "requested",
    "uninstall",
]

_T_SIGNALS = _telemetry.counter("preempt.signals")

_flag = threading.Event()
_lock = threading.Lock()
_prev_handlers: Dict[int, object] = {}


def _handler(signum, frame):
    if _flag.is_set():
        # Second signal: escalate to whoever was installed before us
        # (default SIGINT raises KeyboardInterrupt; SIG_DFL for SIGTERM
        # means the caller really wants out — re-raise via the default).
        prev = _prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
        return
    _flag.set()
    _T_SIGNALS.add()


def install(
    signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT),
) -> bool:
    """Install the flag-setting handlers.  Idempotent; returns False
    (without raising) off the main thread, where handlers cannot be
    installed — callers there use :func:`request` instead."""
    with _lock:
        try:
            for sig in signals:
                if sig in _prev_handlers:
                    continue  # already ours
                _prev_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:  # not the main thread
            return False
        return True


def uninstall() -> None:
    """Restore the previously installed handlers.

    A previous handler that ``signal.signal`` cannot re-install (it
    returned None for a C-installed handler) is replaced by ``SIG_DFL``
    — leaving OUR handler silently installed while the bookkeeping says
    otherwise would make a later :func:`install` record ``_handler`` as
    its own "previous" handler and recurse on escalation.  Off the main
    thread (``ValueError``) nothing can be restored: the entry is kept
    so :func:`installed` stays truthful.
    """
    with _lock:
        for sig, prev in list(_prev_handlers.items()):
            try:
                signal.signal(sig, prev)
            except ValueError:  # not the main thread: nothing restorable
                continue
            except TypeError:
                try:
                    signal.signal(sig, signal.SIG_DFL)
                except (ValueError, OSError):
                    continue
            del _prev_handlers[sig]


def installed() -> bool:
    return bool(_prev_handlers)


def requested() -> bool:
    """True once a preemption signal (or :func:`request`) arrived."""
    return _flag.is_set()


def request() -> None:
    """Set the flag programmatically (tests, preemption-notice APIs)."""
    _flag.set()


def clear() -> None:
    """Reset the flag (tests; a new run in the same process)."""
    _flag.clear()
