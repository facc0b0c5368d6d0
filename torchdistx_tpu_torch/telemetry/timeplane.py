"""Time plane: tick-phase decomposition, host/device attribution, and
trigger-fired profiler capture.

Counterpart of ``torchdistx_tpu/telemetry/timeplane.py``, with the same
phases, metric names, trigger rules and environment variables.

**Tick phases.**  The engine's tick marks phase boundaries into a
:class:`TickTimer` (one ``perf_counter`` call a transition, only with the
ops plane attached or tick attribution forced on), and :func:`publish_tick`
folds the per-phase durations into the labelled histograms
``serve.tick_phase_s{engine=,phase=}``:

* ``schedule`` — reap, admit, swap-in and lifecycle bookkeeping (host),
* ``audit_pump`` — the shadow auditor's pump,
* ``prefill_dispatch`` — the prefill chunks' host dispatch,
* ``decode_dispatch`` — loading the decode chunk's inputs and launching it
  (on CUDA one graph replay),
* ``device_wait`` — the host blocked on the device: the decode chunk's one
  read-back a chunk, and the last prefill chunk's sampled token,
* ``commit`` — pushing committed tokens to handles and retiring slots.

``serve.host_overhead_frac{engine=}`` is ``(tick_s - device_wait) /
tick_s``: near 1, the tick is host-bound and a faster kernel buys nothing.
With anything recording (``events_enabled``) each non-idle tick also emits
one ``serve.tick`` event carrying its ordered segments.

**ProfilerTrigger.**  A rate-limited, bounded ``torch.profiler`` capture
(CPU and CUDA activities) on a daemon thread: :func:`fire_profile` starts
it into a fresh artifact directory, holds it open for the window, stops it
and writes a Chrome trace ``trace.json`` there (JAX writes TensorBoard's
``plugins/profile/*/`` layout instead).  CUDA activity is process-wide, so
a capture started from the trigger's thread records the kernels the
engine launches on the main thread, those inside a replayed CUDA graph
included.  The stall watchdog, the SLO burn monitor and the slow-tick
check (``tick_s > k x p50``) route here; the ops plane's
``/profile?seconds=N`` fires on demand.

Environment (read once, at first use; :func:`set_trigger` wins):

* ``TDX_PROFILE_DIR=/path`` — enable trigger-fired capture under it.
  Unset: automatic capture is off (``/profile`` still works, into a
  temporary directory).
* ``TDX_PROFILE_SECONDS`` — capture window (default 2.0).
* ``TDX_PROFILE_COOLDOWN_S`` — minimum spacing between captures (default
  120); a trigger inside it, or while a capture runs, is suppressed.
* ``TDX_SLOW_TICK_K`` — the slow-tick multiple over the engine's own
  ``serve.tick_s`` p50 (default 8; needs 64 recorded ticks first).

Stdlib-only at import (torch is imported inside the capture thread),
never fails the instrumented operation, and free when off.
"""

from __future__ import annotations

import logging
import os
import re
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import _core

_logger = logging.getLogger(__name__)

__all__ = [
    "PHASES",
    "ProfilerTrigger",
    "TickTimer",
    "fire_profile",
    "get_trigger",
    "phase_summaries",
    "prune_engine",
    "publish_tick",
    "set_trigger",
]

# The tick decomposition, in canonical display order (the exporter lays
# segments out in recorded order; this tuple is the label universe the
# per-engine prune walks).
PHASES = (
    "schedule",
    "audit_pump",
    "prefill_dispatch",
    "decode_dispatch",
    "device_wait",
    "commit",
)

_T_PROFILES = _core.counter("ops.profiles")
_T_SUPPRESSED = _core.counter("ops.profiles_suppressed")

# Slots of the tick histogram the slow-tick check needs before a p50 is
# trustworthy — cold-start ticks (graph captures, first admissions) must
# never fire a capture.
_SLOW_TICK_MIN_TICKS = 64


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


_SLOW_TICK_K = _env_float("TDX_SLOW_TICK_K", 8.0)


# ---------------------------------------------------------------------------
# Tick-phase timing


class TickTimer:
    """Ordered phase segments of one engine tick.

    ``begin(phase)`` closes the current segment and opens the next —
    one ``perf_counter`` call per transition, a handful per tick, no
    allocation beyond the segment tuples.  The engine creates one per
    tick only when the ops plane (or forced tick attribution) is on,
    so the disabled path builds nothing."""

    __slots__ = ("t0", "ts", "segments", "_phase", "_p0")

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.ts = time.time()  # wall-clock tick start, for the exporter
        self.segments: List[Tuple[str, float, float]] = []
        self._phase: Optional[str] = None
        self._p0 = self.t0

    def begin(self, phase: str) -> None:
        now = time.perf_counter()
        if self._phase is not None:
            self.segments.append((self._phase, self._p0 - self.t0, now - self._p0))
        self._phase = phase
        self._p0 = now

    def end(self) -> None:
        """Close the open segment (idempotent)."""
        if self._phase is not None:
            now = time.perf_counter()
            self.segments.append((self._phase, self._p0 - self.t0, now - self._p0))
            self._phase = None

    def totals(self) -> Dict[str, float]:
        """Accumulated seconds per phase (phases that never ran absent)."""
        out: Dict[str, float] = {}
        for phase, _, dur in self.segments:
            out[phase] = out.get(phase, 0.0) + dur
        return out


def publish_tick(engine, timer: TickTimer, tick_s: float, idle: bool = False) -> None:
    """Fold one tick's phase segments into the engine's labeled
    histograms, set ``serve.host_overhead_frac``, emit the ``serve.tick``
    timeline event (when anything records), and run the slow-tick
    outlier check.  Fully idle ticks publish nothing (the ops plane's
    idle rule) beyond zeroing the host gauge once at the idle edge."""
    state = engine._tp_state
    if idle:
        if state is not None and not engine._was_idle:
            state["host"].set(0)
        return
    eid = engine.engine_id
    if state is None:
        state = engine._tp_state = {
            "hists": {
                ph: _core.histogram("serve.tick_phase_s", engine=eid, phase=ph)
                for ph in PHASES
            },
            "host": _core.gauge("serve.host_overhead_frac", engine=eid),
        }
    totals = timer.totals()
    for phase, dur in totals.items():
        h = state["hists"].get(phase)
        if h is not None:
            h.observe(dur)
    device_s = totals.get("device_wait", 0.0)
    host_frac = (
        max(0.0, min(1.0, (tick_s - device_s) / tick_s)) if tick_s > 0 else 0.0
    )
    state["host"].set(round(host_frac, 4))
    if _core.events_enabled():
        # dur_s is the SLICE duration for the exporter: the tail
        # segment closes after tick_s was measured (it covers the
        # attribution writes themselves), so the slice must extend to
        # the last segment's end or the Perfetto children would escape
        # their parent.  tick_s is the measured tick, unchanged.
        span_end = max(
            [tick_s] + [off + dur for _, off, dur in timer.segments]
        )
        _core.event(
            "serve.tick",
            engine=eid,
            tick=engine._tick_no,
            t0=round(timer.ts, 6),
            dur_s=round(span_end, 6),
            tick_s=round(tick_s, 6),
            host_overhead_frac=round(host_frac, 4),
            segments=[
                [phase, round(off, 6), round(dur, 6)]
                for phase, off, dur in timer.segments
            ],
        )
    # Slow-tick outlier → profiler capture.  Checked only with a trigger
    # installed (the p50 readback copies the bucket array), against the
    # engine's OWN tick distribution, and only once it has real history.
    # A manual_only trigger (the /profile temp-dir default) is not an
    # opt-in to automatic capture — same gate as fire_profile.
    trigger = get_trigger()
    if trigger is not None and not trigger.manual_only:
        h_tick = getattr(engine, "_h_tick", None)
        if h_tick is not None and h_tick.count >= _SLOW_TICK_MIN_TICKS:
            p50 = h_tick.percentile(50)
            if p50 and tick_s > _SLOW_TICK_K * p50:
                trigger.fire(
                    "slow_tick",
                    engine=eid,
                    tick_s=round(tick_s, 6),
                    p50_s=round(p50, 6),
                    k=_SLOW_TICK_K,
                )


def phase_summaries(engine_id: str) -> Dict[str, Dict[str, Any]]:
    """One engine's tick-phase breakdown, phase → histogram summary
    (``{count, sum, min, max, p50, p95, p99}``; phases never observed
    omitted).  The ONE readback bench/bench_gate consume — callers must
    not hand-parse the rendered ``serve.tick_phase_s{...}`` registry
    names, whose label encoding belongs to ``_core``."""
    out: Dict[str, Dict[str, Any]] = {}
    for ph in PHASES:
        name = _core._labeled(
            "serve.tick_phase_s", {"engine": engine_id, "phase": ph}
        )
        h = _core._state.histograms.get(name)
        if h is not None and h.count:
            out[ph] = h.summary()
    return out


def prune_engine(engine_id: str) -> None:
    """Drop a stopped engine's time-plane rows from the registry — the
    same bounded-cardinality rule as the tenant/stall families: no
    ``serve.tick_phase_s`` row survives ``_finish_drain``."""
    for ph in PHASES:
        _core.remove("serve.tick_phase_s", engine=engine_id, phase=ph)
    _core.remove("serve.host_overhead_frac", engine=engine_id)


# ---------------------------------------------------------------------------
# Trigger-fired profiler capture


class ProfilerTrigger:
    """Rate-limited, bounded ``torch.profiler`` capture windows.

    ``fire(reason)`` creates a fresh artifact directory under
    ``log_dir``, records ``ops.profile`` with its path, and runs the
    capture (start → bounded sleep → stop) on a daemon thread so the
    serving tick loop never blocks on it.  A fire while a capture is in
    flight, or inside ``cooldown_s`` of the last accepted one, is
    SUPPRESSED (``ops.profiles_suppressed`` + an
    ``ops.profile_suppressed`` event) — the profiler is process-global
    and a burst of stalls should yield one profile of the first, not a
    pile-up.  ``_start_profiler``/``_stop_profiler`` are the profiler
    seam (tests stub them; a profiler that fails to start leaves the
    artifact directory and the event, and the capture is then empty,
    never an error).  The trace lands in ``<path>/trace.json``."""

    def __init__(
        self,
        log_dir: str,
        seconds: float = 2.0,
        cooldown_s: float = 120.0,
        manual_only: bool = False,
    ):
        if seconds <= 0:
            raise ValueError("seconds must be > 0")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.log_dir = str(log_dir)
        self.seconds = float(seconds)
        self.cooldown_s = float(cooldown_s)
        # manual_only: the /profile endpoint's default temp-dir trigger
        # serves ON-DEMAND captures only — fire_profile (the automatic
        # stall/burn/slow-tick funnel) skips it, so one curl of
        # /profile on a box without TDX_PROFILE_DIR cannot silently arm
        # automatic profiling into directories nobody collects.
        self.manual_only = bool(manual_only)
        self.captures: List[str] = []  # artifact dirs, in fire order
        self.suppressed = 0
        self._lock = threading.Lock()
        self._seq = 0
        self._last_fire: Optional[float] = None
        self._active = False
        self._thread: Optional[threading.Thread] = None
        self._prof: Any = None
        self._prof_path = ""

    # -- the profiler seam -------------------------------------------------

    def _start_profiler(self, path: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._prof = prof

    def _stop_profiler(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        prof.export_chrome_trace(os.path.join(self._prof_path, "trace.json"))

    # -- firing -------------------------------------------------------------

    def fire(
        self,
        reason: str,
        engine: Optional[str] = None,
        seconds: Optional[float] = None,
        **attrs,
    ) -> Optional[str]:
        """Capture one bounded window; returns the artifact directory,
        or None when suppressed (cooldown / capture in flight) or the
        directory could not be created."""
        now = time.monotonic()
        with self._lock:
            suppressed = self._active or (
                self._last_fire is not None
                and now - self._last_fire < self.cooldown_s
            )
            if suppressed:
                self.suppressed += 1
            else:
                self._seq += 1
                seq = self._seq
                self._active = True
                prev_last_fire = self._last_fire
                self._last_fire = now
        if suppressed:
            # Side effects OUTSIDE the lock (the repo-wide rule — see
            # SLOMonitor): _core.event fans out to
            # listeners on this thread, and a listener path re-entering
            # fire() must contend, not deadlock.
            _T_SUPPRESSED.add()
            _core.event(
                "ops.profile_suppressed",
                engine=engine,
                reason=reason,
                **attrs,
            )
            return None
        slug = re.sub(r"[^\w.-]", "_", reason) or "capture"
        path = os.path.join(self.log_dir, f"profile-{seq:04d}-{slug}")
        try:
            os.makedirs(path, exist_ok=True)
        except OSError as e:
            # A capture that never happened must not arm the cooldown
            # (the NEXT incident would be suppressed for a window with
            # nothing to show for it) — roll the state back and say so.
            with self._lock:
                self._active = False
                self._last_fire = prev_last_fire
            _logger.warning(
                "timeplane: profiler capture dir %s failed (%s); "
                "capture skipped, cooldown not armed", path, e,
            )
            _core.event(
                "ops.profile_failed", engine=engine, reason=reason,
                path=path, error=str(e),
            )
            return None
        window_s = float(seconds) if seconds is not None else self.seconds
        _T_PROFILES.add()
        _core.event(
            "ops.profile",
            engine=engine,
            reason=reason,
            path=path,
            seconds=window_s,
            **attrs,
        )
        self.captures.append(path)
        t = threading.Thread(
            target=self._capture,
            args=(path, window_s),
            name=f"tdx-profiler-{seq}",
            daemon=True,
        )
        self._thread = t
        t.start()
        return path

    def _capture(self, path: str, window_s: float) -> None:
        started = False
        self._prof_path = path
        try:
            self._start_profiler(path)
            started = True
        except Exception:  # noqa: BLE001 — profiler busy: the dir stays
            pass
        try:
            time.sleep(window_s)
        finally:
            if started:
                try:
                    self._stop_profiler()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            with self._lock:
                self._active = False

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the in-flight capture (if any) finishes."""
        t = self._thread
        if t is not None:
            t.join(timeout)


# Module-level trigger: env-seeded lazily, programmatic set_trigger wins.
_TRIGGER: Any = "__unset__"
_TRIGGER_LOCK = threading.Lock()


def _env_trigger() -> Optional[ProfilerTrigger]:
    d = os.environ.get("TDX_PROFILE_DIR", "").strip()
    if not d:
        return None
    return ProfilerTrigger(
        d,
        seconds=max(0.01, _env_float("TDX_PROFILE_SECONDS", 2.0)),
        cooldown_s=max(0.0, _env_float("TDX_PROFILE_COOLDOWN_S", 120.0)),
    )


def get_trigger(create_default: bool = False) -> Optional[ProfilerTrigger]:
    """The installed trigger (env-seeded on first call), or None when
    capture is disabled.  ``create_default=True`` (the ``/profile``
    endpoint) installs a temp-directory trigger when nothing else is
    configured, so on-demand capture always has somewhere to write —
    marked ``manual_only`` so it never arms AUTOMATIC capture."""
    global _TRIGGER
    with _TRIGGER_LOCK:
        if isinstance(_TRIGGER, str):
            _TRIGGER = _env_trigger()
        if _TRIGGER is None and create_default:
            _TRIGGER = ProfilerTrigger(
                tempfile.mkdtemp(prefix="tdx-profile-"), manual_only=True
            )
        return _TRIGGER


def set_trigger(trigger: Any) -> Any:
    """Install (or disable, with None) the process trigger.  Returns
    the previous value for restoration — pass it back verbatim
    (``"__unset__"`` restores the not-yet-env-read state)."""
    global _TRIGGER
    with _TRIGGER_LOCK:
        prev = _TRIGGER
        _TRIGGER = trigger
    return prev


def fire_profile(
    reason: str,
    engine: Optional[str] = None,
    seconds: Optional[float] = None,
    **attrs,
) -> Optional[str]:
    """Fire the installed trigger (no-op None when capture is off) —
    the one funnel the stall watchdog, SLO burn monitor and slow-tick check
    all call.  A ``manual_only`` trigger
    (the ``/profile`` endpoint's temp-dir default) does not count as
    opting into automatic capture."""
    trigger = get_trigger()
    if trigger is None or trigger.manual_only:
        return None
    return trigger.fire(reason, engine=engine, seconds=seconds, **attrs)


def _reset() -> None:
    # Test isolation: a trigger installed (or env-seeded) by one test
    # must not rate-limit the next; env re-reads on next use.
    global _TRIGGER
    with _TRIGGER_LOCK:
        _TRIGGER = "__unset__"


_core.on_reset(_reset)
