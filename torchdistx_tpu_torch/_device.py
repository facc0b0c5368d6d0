"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.overrides import _get_current_function_mode_stack
from torch.utils._device import DeviceContext


def _context_device() -> Optional[torch.device]:
    """The device of the innermost ``with torch.device(...)`` in force.

    Read from the mode stack: ``torch.get_default_device()`` would build a
    tensor on that device, which fails for a ``cuda`` claimed on a host
    without CUDA.
    """
    for mode in reversed(_get_current_function_mode_stack()):
        if isinstance(mode, DeviceContext):
            return torch.device(mode.device)
    return None


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """The device an entry point runs on.

    An explicit ``device`` is returned as given.  ``None`` means CUDA: the
    device of a ``torch.device(...)`` context in force (as
    :func:`~torchdistx_tpu_torch.deferred_init.deferred_init` with
    ``device_=`` sets one) is honoured, and otherwise ``cuda`` is returned.
    Raises if that needs CUDA and CUDA is unavailable — the CPU is never
    chosen quietly; pass ``device="cpu"`` for it.
    """
    if device is not None:
        return torch.device(device)
    default = _context_device()
    if default is not None and default.type != "cpu":
        return default
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the host"
        )
    return torch.device("cuda")
