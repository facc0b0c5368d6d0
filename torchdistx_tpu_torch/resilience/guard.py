"""Non-finite step guard: skip poisoned steps, escalate when they persist.

Counterpart of ``torchdistx_tpu/resilience/guard.py``.  One NaN/Inf gradient
silently corrupts optimizer moments forever, so a step whose loss or any
gradient is non-finite is skipped:

* :func:`tree_allfinite` reduces the finiteness of every floating tensor in
  a nested structure to one bool tensor on the device.
  :func:`~torchdistx_tpu_torch.parallel.train_step.make_train_step` reads
  it on the host before ``optimizer.step()`` and, when it is false, leaves
  the parameters, the optimizer's moments and the step count untouched: the
  skip the JAX step takes with ``select_tree`` of the prior state, with no
  second copy of the state.
* :class:`SkipTracker` (used by ``fit()``) bumps the
  ``train.skipped_steps`` telemetry counter per skip and raises
  :class:`NonFiniteError` after ``max_consecutive`` skips in a row.

The JAX package's ``select_tree`` has no counterpart: the port's step skips
by not calling ``optimizer.step()``, so there is no prior state to select.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as pytree

from .. import telemetry as _telemetry

__all__ = ["NonFiniteError", "SkipTracker", "tree_allfinite"]

_T_SKIPPED = _telemetry.counter("train.skipped_steps")


class NonFiniteError(RuntimeError):
    """Raised after ``max_consecutive`` non-finite steps in a row."""

    def __init__(self, step: int, consecutive: int):
        self.step = step
        self.consecutive = consecutive
        super().__init__(
            f"{consecutive} consecutive non-finite training step(s), "
            f"last at step {step}: loss/grads contain NaN or Inf and "
            "skipping is not recovering — stopping so the run can be "
            "restarted from the last checkpoint with different "
            "hyperparameters."
        )


def tree_allfinite(*trees: Any) -> torch.Tensor:
    """Bool scalar tensor: every floating-point tensor leaf of every tree
    is finite.  Other leaves (integers, ``None``, Python objects) are
    skipped.  Computed on the leaves' device, with no host sync."""
    flags = [
        torch.isfinite(leaf).all()
        for tree in trees
        for leaf in pytree.tree_leaves(tree)
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
    ]
    if not flags:
        return torch.tensor(True)
    device = flags[0].device
    return torch.stack([f.to(device) for f in flags]).all()


class SkipTracker:
    """Host-side escalation policy over the per-step ``nonfinite`` flag.

    ``observe(skipped, step)`` bumps ``train.skipped_steps`` and raises
    :class:`NonFiniteError` once ``max_consecutive`` skips arrive with no
    finite step in between.  ``max_consecutive <= 0`` disables escalation
    (skips are still counted).
    """

    def __init__(self, max_consecutive: int = 8):
        self.max_consecutive = max_consecutive
        self.consecutive = 0
        self.total = 0

    def observe(self, skipped: bool, step: int) -> None:
        if not skipped:
            self.consecutive = 0
            return
        self.total += 1
        self.consecutive += 1
        _T_SKIPPED.add()
        if 0 < self.max_consecutive <= self.consecutive:
            raise NonFiniteError(step, self.consecutive)
