"""Perf plane: the compile observatory, and the HBM ledger with OOM
forensics.

Counterpart of ``torchdistx_tpu/telemetry/perf.py``.

**Compile observatory.**  The port has no JIT and no compiler event
stream, so each compile is recorded exactly at the site that makes it.
There are two kinds:

* a decode chunk's program: a :class:`~torchdistx_tpu_torch.serving.
  engine.DecodeChunk` captured as one CUDA graph (on the CPU, where there
  is no graph, its first eager run stands in, so the counts are the same on
  both devices), recorded through :class:`GraphProgram` under
  ``decode_chunk``.  Its identity is *(program, engine, model tag)*: a graph
  holds one model's weights by address, so two resident tags are two
  programs, and a re-capture of one identity (a model-pool tag evicted and
  brought back, a dropped capture rebuilt) is a recompile;
* a kernel library's nvcc build (``ops/cuda/_build.py``), recorded under
  ``kernel:<name>``, untracked; a library found fresh on disk counts as a
  program load, as JAX counts a persistent-cache hit.

Three labelled families make them visible: ``compile.count{program=}``,
``compile.time_s{program=}`` (the capture's or the build's own seconds)
and ``compile.recompiles{program=}`` (tracked identities past their
first compile).  :class:`program` is the thread's ambient label scope (it
nests; the innermost wins); the JAX package's ``materialize`` scope is
kept, though an eager replay compiles nothing, so only a capture or a
build inside it would count there.

The **recompile-storm detector** rides the recompile counter: one
identity recompiled ``TDX_RECOMPILE_STORM_N`` times (default 3) inside
``TDX_RECOMPILE_STORM_WINDOW_S`` (default 30 s) latches
``serve.recompile_storm{engine=}``, adds to ``serve.recompile_storms``,
dumps the flight recorder with ``reason="recompile_storm"`` and the ledger,
fires the time plane's profiler trigger, and marks the owning engine
OVERLOADED (the stall watchdog's convention: its own healthy ticks restore
READY).  The latch clears once the identity goes a full window without
recompiling; the engine gauge clears when the engine's last latched
identity drains.  On the card a decode-chunk capture costs about a second,
so that churn is the port's storm.

Not ported, by design: ``install_monitoring`` / ``monitoring_installed``
(there is no compiler event stream to listen to) and ``JitProgram``'s
wall-time fallback without monitoring (every compile is timed at its
site).

**HBM ledger** (``pytree_nbytes``, ``Ledger``, ``ledger``, ``is_oom``,
``oom_dump``).  Device memory is spent by a few subsystems — weights, the
KV page pool, swap staging on the host, cached prefix pages — and an OOM
names none of them.  The ledger attributes bytes to named components per
owner: ``register(component, nbytes, owner=...)`` sets one owner's share,
the ``mem.hbm_bytes{component=}`` gauge is the sum over owners, and
``owners()`` is what the model pool's eviction policy reads.  An OOM (or
a page-pool reservation that could not be met) dumps the flight ring
with the ledger attached, so the post-mortem reads what held the memory.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from . import _core
from . import timeplane as _timeplane

__all__ = [
    "GraphProgram",
    "Ledger",
    "is_oom",
    "ledger",
    "oom_dump",
    "program",
    "pytree_nbytes",
    "record_compile",
    "storm_config",
]

_T_OOMS = _core.counter("mem.ooms")
_T_STORMS = _core.counter("serve.recompile_storms")

# Substrings of the errors PyTorch raises when device memory runs out.
_OOM_MARKERS = ("CUDA out of memory", "out of memory", "OutOfMemoryError")


# ---------------------------------------------------------------------------
# Program attribution scopes

_tls = threading.local()


class _Scope:
    """One thread's ambient program label.  ``counted`` is the number of
    compiles recorded on this thread while the scope was open (inside
    nested scopes too).  ``track`` marks a label that denotes ONE program
    identity (the :class:`GraphProgram` scope): only those feed the
    recompile counter and the storm detector."""

    __slots__ = ("label", "owner", "counted", "track")

    def __init__(self, label: str, owner: Any = None, track: bool = False):
        self.label = label
        self.owner = owner
        self.counted = 0
        self.track = track


class program:
    """Context manager: attribute compiles in this thread to ``label``
    (``with perf.program("materialize"): ...``).  Nests — the innermost
    scope wins.  Yields the scope object."""

    def __init__(self, label: str, owner: Any = None, track: bool = False):
        self.scope = _Scope(label, owner, track)

    def __enter__(self) -> _Scope:
        stack = getattr(_tls, "scopes", None)
        if stack is None:
            stack = _tls.scopes = []
        stack.append(self.scope)
        return self.scope

    def __exit__(self, *exc) -> bool:
        stack = getattr(_tls, "scopes", None)
        if stack and stack[-1] is self.scope:
            stack.pop()
        elif stack and self.scope in stack:  # tolerate imbalance
            stack.remove(self.scope)
        return False


def _current_scope() -> Optional[_Scope]:
    stack = getattr(_tls, "scopes", None)
    return stack[-1] if stack else None


# ---------------------------------------------------------------------------
# Compile recording + the recompile-storm detector

_storm_lock = threading.Lock()
# (program, engine_id, identity) -> compiles seen for that exact program
# identity (tracked compiles only).  One process may hold N engines, each
# legitimately capturing "decode_chunk" once a model tag: a recompile is
# the SAME engine's program for the same tag compiled again.
_per_owner_compiles: Dict[Tuple[str, str, str], int] = {}
# identity key -> deque of recompile timestamps in the window
_recompiles: Dict[Tuple[str, str, str], deque] = {}
# identity key -> when its latched storm last recompiled
_latched: Dict[Tuple[str, str, str], float] = {}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


_STORM_N = max(2, int(_env_float("TDX_RECOMPILE_STORM_N", 3)))
_STORM_WINDOW_S = _env_float("TDX_RECOMPILE_STORM_WINDOW_S", 30.0)


def storm_config(
    threshold: Optional[int] = None, window_s: Optional[float] = None
) -> Tuple[int, float]:
    """Read (and optionally set — tests) the storm detector's knobs:
    ``threshold`` recompiles of one identity within ``window_s`` seconds
    latch the storm.  Returns the previous ``(threshold, window_s)``."""
    global _STORM_N, _STORM_WINDOW_S
    prev = (_STORM_N, _STORM_WINDOW_S)
    if threshold is not None:
        if threshold < 2:
            raise ValueError("storm threshold must be >= 2")
        _STORM_N = int(threshold)
    if window_s is not None:
        if window_s <= 0:
            raise ValueError("storm window_s must be > 0")
        _STORM_WINDOW_S = float(window_s)
    return prev


def record_compile(
    prog: str, duration_s: float, owner: Any = None, track: bool = False,
    identity: Any = None,
) -> None:
    """Count one compile of ``prog``: the count/time families always;
    with ``track`` (the label denotes one exact program identity, with
    ``identity`` naming it within ``owner``: the model tag of a decode
    chunk), also the per-identity recompile counter past that identity's
    first compile, and the storm check."""
    _core.counter("compile.count", program=prog).add()
    _core.histogram("compile.time_s", program=prog).observe(max(0.0, float(duration_s)))
    for scope in getattr(_tls, "scopes", None) or ():
        scope.counted += 1
    if track:
        _note_tracked_compile(prog, owner, identity)


def _owner_eid(owner: Any) -> str:
    return str(getattr(owner, "engine_id", "")) if owner is not None else ""


def _key(prog: str, owner: Any, identity: Any) -> Tuple[str, str, str]:
    return (prog, _owner_eid(owner), "" if identity is None else str(identity))


def _note_tracked_compile(prog: str, owner: Any, identity: Any = None) -> None:
    key = _key(prog, owner, identity)
    eid = key[1]
    now = time.monotonic()
    cut = now - _STORM_WINDOW_S
    with _storm_lock:
        n = _per_owner_compiles.get(key, 0) + 1
        _per_owner_compiles[key] = n
        if n <= 1:
            return  # this identity's FIRST compile: not a recompile
        dq = _recompiles.setdefault(key, deque())
        dq.append(now)
        while dq and dq[0] < cut:
            dq.popleft()
        storming = len(dq) >= _STORM_N
        fresh = storming and key not in _latched
        if storming:
            _latched[key] = now
    _core.counter("compile.recompiles", program=prog).add()
    if not fresh:
        return
    # Side effects OUTSIDE the lock (flight_dump is file I/O and the owner
    # hook takes the engine's health lock).
    _T_STORMS.add()
    if eid:
        _core.gauge("serve.recompile_storm", engine=eid).set(1)
    _core.event("perf.recompile_storm", engine=eid or None, program=prog,
                identity=key[2] or None, n=_STORM_N, window_s=_STORM_WINDOW_S)
    _core.flight_dump("recompile_storm", program=prog, engine=eid or None,
                      identity=key[2] or None, n_recompiles=_STORM_N,
                      window_s=_STORM_WINDOW_S, ledger=ledger.components())
    # Trigger-fired profiler capture (rate-limited; a no-op with no
    # trigger installed): the storm's dump comes with a profile of the
    # recompiling window.
    _timeplane.fire_profile("recompile_storm", engine=eid or None, program=prog)
    if owner is not None:
        try:
            # The stall watchdog's convention: OVERLOADED routes a fleet
            # around the engine; its own healthy ticks restore READY.
            owner._mark_stalled()
        except Exception:  # noqa: BLE001 — observability never fails serving
            pass


def _maybe_unlatch(prog: str, owner: Any, identity: Any = None) -> None:
    """Clear a latched storm once the identity has gone a full window with
    no recompile (called from the wrapped call's no-compile path: one dict
    probe when nothing is latched)."""
    if not _latched:
        return
    key = _key(prog, owner, identity)
    eid = key[1]
    with _storm_lock:
        last = _latched.get(key)
        if last is None or time.monotonic() - last < _STORM_WINDOW_S:
            return
        del _latched[key]
        # The engine gauge covers EVERY identity on the engine: it clears
        # only when the last of the engine's latched storms drains.
        still_latched = any(k[1] == eid for k in _latched)
    if eid and not still_latched:
        _core.gauge("serve.recompile_storm", engine=eid).set(0)


# ---------------------------------------------------------------------------
# GraphProgram: exact per-identity compile detection at the call site


def _capture_count(fn: Any) -> Optional[int]:
    """The callable's capture count (``n_captures``), or None for anything
    that keeps none (a plain function, a test's stand-in): those pass
    through uninstrumented."""
    n = getattr(fn, "n_captures", None)
    return n if isinstance(n, int) else None


class GraphProgram:
    """One captured program under a stable observatory label: the port's
    counterpart of JAX's ``JitProgram``.

    ``call(fn, owner, identity, *args, **kwargs)`` calls ``fn`` (a
    :class:`~torchdistx_tpu_torch.serving.engine.DecodeChunk`) inside the
    label's scope and, where its capture count (``n_captures``; on the CPU
    its first-run count) grew, records the compile against ``owner`` (the
    engine the storm detector marks) and ``identity`` (the model tag), timed
    by the capture's own seconds (``capture_s``, which a counted callable
    keeps beside its count).  A call that captured nothing may clear a
    drained storm latch.  ``fn`` is resolved by the
    caller at each call, so a patched ``DecodeChunk.__call__`` stays
    patchable, and a callable without a capture count passes through."""

    __slots__ = ("program",)

    def __init__(self, program: str):
        self.program = program

    def call(self, fn: Callable[..., Any], owner: Any, identity: Any, *args, **kwargs) -> Any:
        n0 = _capture_count(fn)
        if n0 is None:
            return fn(*args, **kwargs)
        with program(self.program, owner, track=True):
            out = fn(*args, **kwargs)
        if _capture_count(fn) > n0:
            record_compile(self.program, fn.capture_s, owner=owner, track=True,
                           identity=identity)
        else:
            _maybe_unlatch(self.program, owner, identity)
        return out


# ---------------------------------------------------------------------------
# HBM ledger


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




def _reset() -> None:
    """Test isolation: ``telemetry.reset()`` clears the storm detector's
    state and the ledger."""
    with _storm_lock:
        _per_owner_compiles.clear()
        _recompiles.clear()
        _latched.clear()
    ledger._clear()


_core.on_reset(_reset)
