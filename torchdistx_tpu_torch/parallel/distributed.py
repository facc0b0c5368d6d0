"""Agreement on host-local flags across processes.

Counterpart of ``any_flag`` / ``any_flags`` in
``torchdistx_tpu/parallel/distributed.py``.  The rest of that module
(process-group init, hybrid meshes) belongs to the multi-device port.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["any_flag", "any_flags"]


def any_flag(local: bool) -> bool:
    """Agree on a process-local boolean across all processes: True anywhere
    → True everywhere.  Single-flag convenience over :func:`any_flags`."""
    return any_flags((local,))[0]


def any_flags(local: Sequence[bool]) -> tuple:
    """Agree on a vector of process-local booleans across all processes, in
    ONE collective: position i of the result is True iff any process passed
    True at position i.

    The preemption/exit protocol's collective (see
    :mod:`torchdistx_tpu_torch.resilience.preemption`): processes may be
    signalled at different instants and their data streams may end at
    different steps, but a resumable checkpoint needs every process to stop
    at the SAME step, so ``fit()`` folds its exit flags through this
    ``all_reduce(MAX)`` of a small int tensor at each step boundary.

    With one process, or no initialized ``torch.distributed`` group, the
    local flags are returned (no collective, no cost).  With a group, every
    process must call it at the same point, like any collective; the tensor
    lives on the group's device (the current CUDA device under NCCL, the CPU
    otherwise).
    """
    flags = tuple(bool(x) for x in local)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return flags
    device = (torch.device("cuda", torch.cuda.current_device())
              if "nccl" in str(dist.get_backend()) else torch.device("cpu"))
    t = torch.tensor(flags, dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return tuple(bool(x) for x in t.tolist())
