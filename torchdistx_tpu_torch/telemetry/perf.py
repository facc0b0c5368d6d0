"""Perf plane, the HBM ledger part: device bytes by component, with OOM
forensics.

Counterpart of the ledger half of ``torchdistx_tpu/telemetry/perf.py``
(``pytree_nbytes``, ``Ledger``, ``ledger``, ``is_oom``, ``oom_dump``).
Device memory is spent by a few subsystems — weights, the KV page pool,
swap staging on the host, cached prefix pages — and an OOM names none of
them.  The ledger attributes bytes to named components per owner:
``register(component, nbytes, owner=...)`` sets one owner's share, the
``mem.hbm_bytes{component=}`` gauge is the sum over owners, and
``owners()`` is what the model pool's eviction policy reads.  An OOM (or
a page-pool reservation that could not be met) dumps the flight ring
with the ledger attached, so the post-mortem reads what held the memory.

The compile observatory (``JitProgram``, ``program``,
``install_monitoring``) is ROADMAP A8: CUDA-graph captures
(``serve.graph_captures``) take its place.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from . import _core

__all__ = ["Ledger", "is_oom", "ledger", "oom_dump", "pytree_nbytes"]

_T_OOMS = _core.counter("mem.ooms")

# Substrings of the errors PyTorch raises when device memory runs out.
_OOM_MARKERS = ("CUDA out of memory", "out of memory", "OutOfMemoryError")


def pytree_nbytes(tree: Any) -> int:
    """Total tensor bytes of a nested dict / list / tuple of tensors
    (anything with ``nbytes``, numpy arrays included)."""
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0) or 0)


class Ledger:
    """Attribute device bytes to named components.

    ``register(component, nbytes, owner=...)`` sets one owner's share of
    a component; the exported ``mem.hbm_bytes{component=}`` gauge is the
    sum over owners, so N engines each registering their ``kv_pool``
    read as one pool total, while N engines sharing one set of weights
    register ``weights`` under the same owner key and count once.  An
    owner that goes away (engine close) ``unregister``-s; a component
    whose last owner leaves is pruned from the registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], int] = {}

    def register(self, component: str, nbytes: int, owner: Any = None) -> None:
        key = (str(component), str(owner) if owner is not None else "")
        with self._lock:
            self._entries[key] = int(nbytes)
            _core.gauge("mem.hbm_bytes", component=component).set(
                self._component_total(component))

    def unregister(self, component: str, owner: Any = None) -> None:
        key = (str(component), str(owner) if owner is not None else "")
        with self._lock:
            self._entries.pop(key, None)
            total = self._component_total(component)
            if total:
                _core.gauge("mem.hbm_bytes", component=component).set(total)
            else:
                _core.remove("mem.hbm_bytes", component=component)

    def _component_total(self, component: str) -> int:
        return sum(v for (c, _), v in self._entries.items() if c == component)

    def components(self) -> Dict[str, int]:
        """``{component: total bytes}`` — the snapshot OOM dumps carry."""
        with self._lock:
            out: Dict[str, int] = {}
            for (c, _), v in self._entries.items():
                out[c] = out.get(c, 0) + v
        return out

    def owners(self, component: Optional[str] = None) -> Dict[Tuple[str, str], int]:
        """``{(component, owner): bytes}`` — the per-owner attribution
        (``component`` filters to one component's owners)."""
        with self._lock:
            return {k: v for k, v in self._entries.items()
                    if component is None or k[0] == component}

    def total(self) -> int:
        with self._lock:
            return sum(self._entries.values())

    def _clear(self) -> None:
        with self._lock:
            comps = {c for c, _ in self._entries}
            self._entries.clear()
        for c in comps:
            _core.remove("mem.hbm_bytes", component=c)


ledger = Ledger()


def is_oom(err: BaseException) -> bool:
    """True when ``err`` is a device out-of-memory:
    ``torch.OutOfMemoryError``, or the ``RuntimeError`` CUDA raises."""
    import torch

    if isinstance(err, torch.OutOfMemoryError):
        return True
    msg = f"{type(err).__name__}: {err}"
    return any(marker in msg for marker in _OOM_MARKERS)


def oom_dump(reason: str, *, engine: Optional[str] = None, **attrs) -> int:
    """The OOM post-mortem moment: count it, emit the event, and dump the
    flight ring with the ledger snapshot attached.  ``reason`` is
    ``"device_oom"`` for a failed device call and ``"pool_exhausted"``
    for a page-pool reservation that could not be met.  Returns the
    number of flight records dumped."""
    _T_OOMS.add()
    components = ledger.components()
    _core.event("mem.oom", engine=engine, reason=reason, hbm_bytes=components, **attrs)
    return _core.flight_dump(reason, engine=engine, ledger=components,
                             hbm_total_bytes=sum(components.values()), **attrs)


_core.on_reset(ledger._clear)
