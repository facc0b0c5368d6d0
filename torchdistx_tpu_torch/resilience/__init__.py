"""Resilience: preemption-safe training, retrying IO, non-finite guards,
and deterministic fault injection.

Counterpart of ``torchdistx_tpu.resilience``, the same modules and names:

* :mod:`~torchdistx_tpu_torch.resilience.retry` — :class:`RetryPolicy`:
  exponential backoff + jitter with attempt/deadline caps and
  retryable-exception classification, applied to checkpoint IO and the
  ``fit()`` data iterator (``ckpt.retries`` / ``data.retries`` counters).
* :mod:`~torchdistx_tpu_torch.resilience.preemption` — SIGTERM/SIGINT
  handlers that set a flag checked at every step boundary; on preemption
  ``fit()`` checkpoints the current step, flushes telemetry, and returns
  resumably (across processes the flag is agreed via
  :func:`torchdistx_tpu_torch.parallel.distributed.any_flag`).
* :mod:`~torchdistx_tpu_torch.resilience.guard` — the step's finiteness
  check over loss and gradients with skip-step semantics (state left
  unchanged, ``train.skipped_steps`` bumped) and host-side escalation
  (:class:`NonFiniteError` after K consecutive skips).
* :mod:`~torchdistx_tpu_torch.resilience.faults` — deterministic fault
  injection (``TDX_FAULT="site:step:kind"``) so tests prove the
  crash/retry/skip paths without flaky process games.

The JAX package also exports ``select_tree``; the port's step skips in
place and has no use for it (see :mod:`.guard`).
"""

from .faults import (  # noqa: F401
    CRASH_EXIT_CODE,
    FaultSpec,
    InjectedFault,
    parse_faults,
)
from .guard import NonFiniteError, SkipTracker, tree_allfinite  # noqa: F401
from .retry import RetriesExhausted, RetryPolicy  # noqa: F401
from . import faults, guard, preemption, retry  # noqa: F401

__all__ = [
    "CRASH_EXIT_CODE",
    "FaultSpec",
    "InjectedFault",
    "NonFiniteError",
    "RetriesExhausted",
    "RetryPolicy",
    "SkipTracker",
    "faults",
    "guard",
    "parse_faults",
    "preemption",
    "retry",
    "tree_allfinite",
]
