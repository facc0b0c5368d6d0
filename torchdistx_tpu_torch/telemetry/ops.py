"""Live ops plane: metrics exposition, health, SLO burn rate, stall watchdog.

Counterpart of ``torchdistx_tpu/telemetry/ops.py``, with the same
endpoints, metric names and rules.  A running engine or fleet answers
"what is happening right now" over HTTP.  All opt-in
(``Engine(ops_port=...)`` / ``FleetRouter(ops_port=...)`` /
``TDX_OPS_PORT``) and free when off:

* **Metrics exposition** — :class:`OpsServer`, a stdlib ``http.server``
  listener bound to 127.0.0.1 by default, serving ``/metrics`` (the whole
  telemetry registry in Prometheus text format, :func:`render_prometheus`,
  byte-identical to the JAX package's over the same registry),
  ``/healthz`` (per-engine health as JSON: 200 while any watched engine is
  READY or STARTING, else 503), ``/requests`` (in-flight request timelines
  rebuilt by ``scripts/trace_report.reconstruct()`` over the live flight
  ring; the ``?limit=`` most recent, default 256) and
  ``/profile?seconds=N`` (a bounded ``torch.profiler`` capture through the
  time plane's rate-limited trigger: 200 with the artifact path, 429 when
  suppressed).  The handlers read host state only: no CUDA call is made
  from the HTTP thread.

* **Per-tick utilization attribution** — the engine's tick (gated on this
  plane being attached, or :func:`enable_tick_attribution`) publishes
  ``serve.occupancy``, ``serve.prefill_budget``, ``serve.page_util``,
  ``serve.churn``, ``serve.goodput`` and a ``serve.tick_s`` histogram, all
  ``{engine=}``-labelled, plus the time plane's phase split.

* **SLO burn-rate monitor** — :class:`SLOMonitor`, a telemetry record
  listener tracking per tenant, over fast and slow windows, the
  deadline-hit rate against the target, TTFT p95 and the shed and failover
  rates; a burn in both windows flips ``serve.slo_burning{tenant=}`` and
  fires the callback (default: ``flight_dump("slo_burn")`` and a profile).

* **Stall watchdog** — :class:`StallWatchdog`, a daemon thread per watched
  engine: work pending but no tick, token or prefill dispatch for
  ``stall_deadline_s`` flight-dumps ``reason="stall"``, bumps
  ``serve.stalls``, sets ``serve.stalled{engine=}`` and marks the engine
  OVERLOADED (``_mark_stalled``, which takes the engine's health lock);
  the engine's next tick restores READY.

An :class:`OpsPlane` owns one server and one monitor and watches N engines
(a watchdog each); ``FleetRouter(ops_port=...)`` ``retain()``-s it across
replica churn.  The plane closes when the last engine and the last retain
are gone.  Engines are duck-typed: ``health()``, ``engine_id``,
``_tick_no`` / ``_decode_tokens`` / ``_prefill_no``, ``scheduler``,
``_n_running()``, ``_mark_stalled()``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from . import _core
from . import timeplane as _timeplane

__all__ = [
    "OpsConfig",
    "OpsPlane",
    "OpsServer",
    "SLOConfig",
    "SLOMonitor",
    "StallWatchdog",
    "attach_engine",
    "enable_tick_attribution",
    "get_plane",
    "render_prometheus",
    "tick_attribution_enabled",
]

_T_SCRAPES = _core.counter("ops.scrapes")
_T_STALLS = _core.counter("serve.stalls")
_T_SLO_BURNS = _core.counter("serve.slo_burns")

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# ---------------------------------------------------------------------------
# Prometheus text exposition rendering

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _parse_labeled(name: str) -> Tuple[str, Dict[str, str]]:
    """Split a canonical registry name (``serve.health{engine=eng0}``,
    see ``_core._labeled``) back into ``(base, labels)``.  Label values
    are percent-escaped by ``_core._label_escape`` at registration, so
    free-form values (a tenant id containing ``,`` or ``=``) split
    correctly and round-trip through ``_label_unescape``."""
    i = name.find("{")
    if i < 0 or not name.endswith("}"):
        return name, {}
    labels: Dict[str, str] = {}
    for part in name[i + 1 : -1].split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            labels[k] = _core._label_unescape(v)
    return name[:i], labels


def _prom_name(base: str) -> str:
    """``serve.queue_wait_s`` → ``serve_queue_wait_s`` (Prometheus metric
    names admit only ``[a-zA-Z0-9_:]`` and must not start with a digit)."""
    n = _NAME_SANITIZE.sub("_", base)
    if n and n[0].isdigit():
        n = "_" + n
    return n or "_"


def _escape_label(v: Any) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_prom_name(str(k))}="{_escape_label(labels[k])}"'
        for k in sorted(labels)
    )
    return "{" + inner + "}"


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def render_prometheus() -> str:
    """The whole telemetry registry in Prometheus text exposition format.

    Counters render as ``counter`` families, numeric gauges as ``gauge``
    families, and non-numeric gauges (``serve.health`` holds a Health
    *string*) as enum-style gauges — the value becomes a ``state`` label
    with sample value 1 (``serve_health{engine="eng0",state="ready"} 1``)
    so a dead-simple alert (``serve_health{state="ready"} < 1``) works
    without a value mapping.  Histograms render the cumulative
    ``_bucket`` series (``le`` upper edges + ``+Inf``), ``_sum``, and
    ``_count``; each histogram's series is one locked snapshot
    (:meth:`~._core.Histogram.bucket_counts`), so the ``+Inf`` bucket
    always equals ``_count`` even mid-tick.  ``# TYPE`` is emitted once
    per family — labeled instruments of one base name group under it.
    A name registered as more than one KIND (``serve.ttft_s`` is both a
    back-compat last-reading gauge and a labeled histogram family)
    would render two conflicting ``# TYPE`` lines, which Prometheus
    rejects outright — the non-histogram family re-emits as
    ``<name>_value`` (histograms keep the base name: their
    ``_bucket``/``_sum``/``_count`` series are the ones dashboards
    aggregate)."""
    counters, gauges, histograms = _core.registry_view()
    lines: List[str] = []

    hfams: Dict[str, List[Tuple[Dict[str, Any], Any]]] = {}
    for name, h in histograms.items():
        base, labels = _parse_labeled(name)
        hfams.setdefault(_prom_name(base), []).append((labels, h))
    reserved = set(hfams)
    for p in list(reserved):
        reserved.update((f"{p}_bucket", f"{p}_sum", f"{p}_count"))

    fams: Dict[str, List[Tuple[Dict[str, Any], Any]]] = {}
    for name, c in counters.items():
        base, labels = _parse_labeled(name)
        pname = _prom_name(base)
        if pname in reserved:
            pname += "_value"
        fams.setdefault(pname, []).append((labels, c.value))
    for pname in sorted(fams):
        lines.append(f"# TYPE {pname} counter")
        for labels, v in fams[pname]:
            lines.append(f"{pname}{_fmt_labels(labels)} {_fmt_value(v)}")
    reserved.update(fams)

    fams = {}
    for name, g in gauges.items():
        v = g.value
        if v is None:
            continue
        base, labels = _parse_labeled(name)
        if not isinstance(v, (int, float, bool)):
            labels = {**labels, "state": str(v)}
            v = 1
        pname = _prom_name(base)
        if pname in reserved:
            pname += "_value"
        fams.setdefault(pname, []).append((labels, v))
    for pname in sorted(fams):
        lines.append(f"# TYPE {pname} gauge")
        for labels, v in fams[pname]:
            lines.append(f"{pname}{_fmt_labels(labels)} {_fmt_value(v)}")
    for pname in sorted(hfams):
        lines.append(f"# TYPE {pname} histogram")
        for labels, h in hfams[pname]:
            bounds, cum, total, hsum = h.bucket_counts()
            for edge, c in zip(bounds, cum):
                lines.append(
                    f"{pname}_bucket"
                    f"{_fmt_labels({**labels, 'le': format(edge, 'g')})} {c}"
                )
            lines.append(
                f"{pname}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} "
                f"{total}"
            )
            lines.append(
                f"{pname}_sum{_fmt_labels(labels)} {_fmt_value(hsum)}"
            )
            lines.append(f"{pname}_count{_fmt_labels(labels)} {total}")

    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# /requests: in-process timeline reconstruction over the live ring

_reconstruct: Any = "__unset__"


def _load_reconstruct() -> Optional[Callable]:
    """Lazy import of ``scripts/trace_report.reconstruct`` (repo tooling
    that imports neither jax nor the JAX package), so the live
    ``/requests`` view cannot drift from the post-mortem one.  In a
    checkout the scripts directory sits beside the package; an
    installation without it degrades ``/requests`` to 503."""
    global _reconstruct
    if _reconstruct != "__unset__":
        return _reconstruct
    try:
        from trace_report import reconstruct  # scripts/ already on path
    except ImportError:
        scripts = os.path.join(
            os.path.dirname(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            ),
            "scripts",
        )
        reconstruct = None
        if os.path.isfile(os.path.join(scripts, "trace_report.py")):
            if scripts not in sys.path:
                sys.path.insert(0, scripts)
            try:
                from trace_report import reconstruct
            except ImportError:  # pragma: no cover — half-broken checkout
                reconstruct = None
    _reconstruct = reconstruct
    return reconstruct


# ---------------------------------------------------------------------------
# SLO burn-rate monitor


@dataclasses.dataclass
class SLOConfig:
    """Targets and windows of the burn-rate monitor.

    ``slo`` is the target deadline-hit rate (the error budget is
    ``1 - slo``); the burn rate of a window is its SLO-relevant failure
    fraction divided by that budget (burn 1.0 = exactly consuming
    budget).  A tenant starts *burning* when the burn rate meets
    ``burn_threshold`` in BOTH the fast and the slow window (the
    multi-window rule: the fast window makes the alert prompt, the slow
    window keeps a single blip from firing it), or when its fast-window
    TTFT p95 exceeds ``ttft_target_s`` (when set).  Windows with fewer
    than ``min_samples`` terminal events never fire."""

    slo: float = 0.99
    ttft_target_s: Optional[float] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    burn_threshold: float = 4.0
    min_samples: int = 10
    # (tenant, info) -> None; None = flight_dump("slo_burn", ...)
    on_burn: Optional[Callable[[str, Dict[str, Any]], None]] = None


class _TenantWindows:
    """One tenant's fast/slow rolling windows with incremental per-kind
    counters: appends and evictions are O(1) amortized, so the monitor
    costs O(1) per event on the emitting (serving) thread instead of
    rescanning the whole slow-window deque."""

    __slots__ = ("fast", "slow", "fast_n", "slow_n")

    def __init__(self):
        self.fast: deque = deque()  # (ts, kind, value) in the fast window
        self.slow: deque = deque()  # ... in the slow window
        self.fast_n: Dict[str, int] = {}
        self.slow_n: Dict[str, int] = {}

    def add(self, ts, kind, value, fast_cut, slow_cut) -> None:
        self.fast.append((ts, kind, value))
        self.fast_n[kind] = self.fast_n.get(kind, 0) + 1
        self.slow.append((ts, kind, value))
        self.slow_n[kind] = self.slow_n.get(kind, 0) + 1
        self.evict(fast_cut, slow_cut)

    def evict(self, fast_cut, slow_cut) -> None:
        for dq, counts, cut in (
            (self.fast, self.fast_n, fast_cut),
            (self.slow, self.slow_n, slow_cut),
        ):
            while dq and dq[0][0] < cut:
                _, kind, _ = dq.popleft()
                left = counts[kind] - 1
                if left:
                    counts[kind] = left
                else:
                    del counts[kind]

    @staticmethod
    def terminal(counts: Dict[str, int]) -> int:
        return (
            counts.get("good", 0)
            + counts.get("miss", 0)
            + counts.get("infra", 0)
        )

    @staticmethod
    def rates(counts: Dict[str, int]) -> Dict[str, Any]:
        t = _TenantWindows.terminal(counts)
        return {
            "n": t,
            "deadline_hit_rate": round(counts.get("good", 0) / max(1, t), 4),
            "shed": counts.get("shed", 0),
            "failovers": counts.get("failover", 0),
        }

    def fast_ttfts(self) -> List[float]:
        return [v for _, kind, v in self.fast if kind == "ttft"]


class SLOMonitor:
    """Windowed SLO tracker over the request-lifecycle event stream.

    Subscribed as a telemetry record listener (:func:`subscribe`), it
    watches ``req.*`` events: ``req.submitted`` binds a rid to its
    tenant, ``req.finished`` counts good, ``req.failed`` classifies by
    error type (``DeadlineExceeded`` → miss, ``EngineOverloaded`` →
    shed, client cancels ignored, other *non-retryable* terminals →
    infra; retryable failures are a router's to heal and only feed the
    shed/failover rates), ``req.first_token`` feeds the TTFT window,
    ``req.failover_hop`` the failover rate.  Event timestamps — not the
    wall clock — drive the windows, so replayed traces evaluate
    deterministically.

    State is bounded: the rid→tenant map is a capped LRU, window deques
    drop past the slow window, and a tenant with no events left is
    pruned from the monitor and its ``serve.slo_burning`` gauge removed
    from the registry.

    Locking: window state mutates under the monitor's lock on the
    emitting thread, but state-transition SIDE EFFECTS — the gauge
    write, the burn counter, and the ``on_burn`` callback (default:
    ``flight_dump`` file I/O) — run after it is released, so a callback
    that reads :meth:`summary`/:meth:`burning` cannot deadlock the
    serving tick loop."""

    _RID_CAP = 8192
    _PRUNE_EVERY = 512

    def __init__(self, config: Optional[SLOConfig] = None):
        self.config = config or SLOConfig()
        if not 0.0 < self.config.slo < 1.0:
            raise ValueError("slo must be in (0, 1)")
        if self.config.fast_window_s > self.config.slow_window_s:
            raise ValueError("fast_window_s must be <= slow_window_s")
        self._lock = threading.Lock()
        self._rid_ctx: OrderedDict = OrderedDict()  # rid -> tenant
        self._events: Dict[str, _TenantWindows] = {}
        self._burning: Dict[str, bool] = {}
        self._n_seen = 0
        # Burn-transition listeners (add_burn_listener): consumers of
        # burn state — an autoscaler, a pager bridge — that COMPOSE with
        # the primary on_burn callback instead of replacing it.
        self._listeners: List[Callable[[str, bool, Optional[Dict]], None]] = []

    # -- lifecycle ----------------------------------------------------------

    def subscribe(self) -> "SLOMonitor":
        _core.add_listener(self._on_record)
        return self

    def close(self) -> None:
        _core.remove_listener(self._on_record)
        with self._lock:
            tenants = set(self._events) | set(self._burning)
            self._events.clear()
            self._rid_ctx.clear()
            self._burning.clear()
            self._listeners.clear()
        for tenant in tenants:
            _core.remove("serve.slo_burning", tenant=tenant)

    # -- burn-transition listeners ------------------------------------------

    def add_burn_listener(
        self, fn: Callable[[str, bool, Optional[Dict[str, Any]]], None]
    ) -> None:
        """Register ``fn(tenant, burning, info)`` for burn-state
        transitions.  Unlike ``SLOConfig.on_burn`` — the PRIMARY
        callback, which replaces the default flight-dump action —
        listeners COMPOSE: the primary runs first, then every listener
        in registration order, so an autoscaler subscribing here never
        silences the flight recorder.  Listeners see BOTH edges:
        ``burning=True`` with the burn info dict, and ``burning=False``
        with ``info=None`` when the tenant genuinely recovers.  A tenant
        pruned for idleness does NOT emit a recovery edge — no traffic
        is not evidence the SLO is healthy again — its gauge simply
        leaves the registry."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_burn_listener(self, fn) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    # -- the listener -------------------------------------------------------

    def _on_record(self, rec: Dict[str, Any]) -> None:
        if rec.get("type") != "event":
            return
        name = rec.get("name", "")
        if not name.startswith("req."):
            return
        rid = rec.get("rid")
        if rid is None:
            return
        attrs = rec.get("attrs") or {}
        ts = float(rec.get("ts") or time.time())
        transition = None
        with self._lock:
            if name == "req.submitted":
                tenant = attrs.get("tenant")
                if tenant is not None:
                    self._rid_ctx[rid] = str(tenant)
                    self._rid_ctx.move_to_end(rid)
                    while len(self._rid_ctx) > self._RID_CAP:
                        self._rid_ctx.popitem(last=False)
                return
            tenant = self._rid_ctx.get(rid)
            if tenant is None:
                return
            if name == "req.first_token":
                t = attrs.get("ttft_s")
                if t is not None:
                    transition = self._observe(tenant, ts, "ttft", float(t))
            elif name == "req.failover_hop":
                transition = self._observe(tenant, ts, "failover", 1.0)
            elif name == "req.finished":
                self._rid_ctx.pop(rid, None)
                transition = self._observe(tenant, ts, "good", 1.0)
            elif name == "req.failed":
                err = attrs.get("error", "")
                retryable = bool(attrs.get("retryable", False))
                if err == "RequestCancelled":
                    self._rid_ctx.pop(rid, None)  # the client's own doing
                elif err == "DeadlineExceeded":
                    self._rid_ctx.pop(rid, None)
                    transition = self._observe(tenant, ts, "miss", 1.0)
                elif err == "EngineOverloaded":
                    # Shed is retryable (a router re-places it): rate
                    # signal only, the rid stays bound for its retry.
                    transition = self._observe(tenant, ts, "shed", 1.0)
                elif not retryable:
                    self._rid_ctx.pop(rid, None)
                    transition = self._observe(tenant, ts, "infra", 1.0)
                # retryable non-shed failures: a hop will follow.
        if transition is not None:
            self._apply_transition(*transition)

    # -- windows ------------------------------------------------------------

    def _observe(self, tenant: str, ts: float, kind: str, value: float):
        """Record one observation; returns a ``(tenant, burning, info)``
        state transition for the caller to apply OUTSIDE the lock, or
        None."""
        cfg = self.config
        tw = self._events.setdefault(tenant, _TenantWindows())
        tw.add(
            ts, kind, value,
            ts - cfg.fast_window_s, ts - cfg.slow_window_s,
        )
        self._n_seen += 1
        if self._n_seen % self._PRUNE_EVERY == 0:
            self._prune_idle(ts)
        return self._evaluate(tenant, tw)

    def _evaluate(self, tenant: str, tw: _TenantWindows):
        cfg = self.config
        budget = max(1e-9, 1.0 - cfg.slo)

        def burn(counts: Dict[str, int]) -> float:
            t = _TenantWindows.terminal(counts)
            if t < cfg.min_samples:
                return 0.0
            return (
                (counts.get("miss", 0) + counts.get("infra", 0)) / t
            ) / budget

        burning = (
            burn(tw.fast_n) >= cfg.burn_threshold
            and burn(tw.slow_n) >= cfg.burn_threshold
        )
        ttft_p95 = None
        if cfg.ttft_target_s is not None:
            xs = tw.fast_ttfts()
            if len(xs) >= cfg.min_samples:
                xs.sort()
                ttft_p95 = xs[min(len(xs) - 1, int(0.95 * len(xs)))]
                burning = burning or ttft_p95 > cfg.ttft_target_s
        prev = self._burning.get(tenant, False)
        if burning == prev:
            return None
        self._burning[tenant] = burning
        if not burning:
            return tenant, False, None
        info = {
            "burn_fast": round(burn(tw.fast_n), 3),
            "burn_slow": round(burn(tw.slow_n), 3),
            "fast": _TenantWindows.rates(tw.fast_n),
            "slow": _TenantWindows.rates(tw.slow_n),
        }
        if ttft_p95 is not None:
            info["ttft_p95_s"] = round(ttft_p95, 6)
        return tenant, True, info

    def _apply_transition(
        self, tenant: str, burning: bool, info: Optional[Dict[str, Any]]
    ) -> None:
        """Side effects of a burn-state change, run WITHOUT the
        monitor's lock: the gauge write, the counter, and the user (or
        default flight-dump) callback — an ``on_burn`` that reads
        :meth:`summary` must not deadlock the serving thread."""
        _core.gauge("serve.slo_burning", tenant=tenant).set(int(burning))
        if burning:
            _T_SLO_BURNS.add()
            # The PRIMARY action first (user on_burn replaces the
            # default flight dump), then the composing listeners — an
            # autoscaler reacting to the burn must find the dump already
            # on the ring, not race it.
            cb = self.config.on_burn or self._default_on_burn
            try:
                cb(tenant, info)
            except Exception:  # noqa: BLE001 — monitoring never fails serving
                pass
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(tenant, burning, info)
            except Exception:  # noqa: BLE001 — monitoring never fails serving
                pass

    @staticmethod
    def _default_on_burn(tenant: str, info: Dict[str, Any]) -> None:
        # The post-mortem moment the flight recorder exists for: the
        # ring holds the requests that burned the budget — and, with a
        # profiler trigger installed (docs/observability.md, "Time
        # plane"), a bounded device profile of the burning window rides
        # along.
        _core.flight_dump("slo_burn", tenant=tenant, **info)
        _timeplane.fire_profile("slo_burn", tenant=tenant)

    def _drop_tenant(self, tenant: str) -> None:
        # Deliberately NOT a burn transition: a tenant pruned while
        # burning went idle, it did not recover — listeners (the
        # autoscaler's cooldown logic) never see a False edge here, and
        # the gauge is removed rather than zeroed.
        self._events.pop(tenant, None)
        self._burning.pop(tenant, None)
        # Registry prune: an idle tenant's gauge leaves /metrics (and
        # the exported counters snapshots) entirely — bounded
        # cardinality under free-form tenant ids.  (Registry removal
        # takes only the registry lock — no user code, no I/O — so it
        # is safe under the monitor's lock.)
        _core.remove("serve.slo_burning", tenant=tenant)

    def _prune_idle(self, now: float) -> None:
        cutoff = now - self.config.slow_window_s
        for tenant in [
            t
            for t, tw in self._events.items()
            if not tw.slow or tw.slow[-1][0] < cutoff
        ]:
            self._drop_tenant(tenant)

    # -- introspection ------------------------------------------------------

    def burning(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self._burning)

    def summary(self) -> Dict[str, Any]:
        """Per-tenant fast/slow window rates (the live SLO view)."""
        cfg = self.config
        out: Dict[str, Any] = {}
        with self._lock:
            for tenant, tw in self._events.items():
                if not tw.slow:
                    continue
                now = tw.slow[-1][0]
                tw.evict(now - cfg.fast_window_s, now - cfg.slow_window_s)
                out[tenant] = {
                    "burning": self._burning.get(tenant, False),
                    "fast": _TenantWindows.rates(tw.fast_n),
                    "slow": _TenantWindows.rates(tw.slow_n),
                }
        return out


# ---------------------------------------------------------------------------
# Stall watchdog


class StallWatchdog(threading.Thread):
    """Detect a silently stalled engine: work pending but no progress.

    A daemon thread samples the engine's progress key — ``(_tick_no,
    _decode_tokens, _prefill_no)`` (ticks executed, decode tokens
    committed, prefill chunks dispatched) — every ``poll_s``.  When work
    is pending (waiting queue non-empty or slots occupied) and the key
    has not moved for ``deadline_s``, the engine's tick loop has stopped
    making progress — a wedged caller, a hung device call, a consumer
    that stopped pulling — the exact failure mode that raises nothing
    and that chaos soaks survive without noticing.  Detection:
    ``flight_dump(reason="stall")``, an ``ops.stall`` event, the
    ``serve.stalls`` counter, ``serve.stalled{engine=...}`` set to 1,
    the engine marked OVERLOADED (``_mark_stalled``) so a fleet router
    routes around it, and the optional ``on_stall`` callback.  The latch
    clears (gauge back to 0) when progress resumes; the engine's own
    next tick restores READY.

    Reads are lock-free snapshots of ints (exact under the GIL); a
    torn read costs one poll, never a crash."""

    def __init__(
        self,
        engine,
        deadline_s: float = 30.0,
        poll_s: Optional[float] = None,
        on_stall: Optional[Callable] = None,
    ):
        eid = getattr(engine, "engine_id", "eng?")
        super().__init__(name=f"tdx-stall-{eid}", daemon=True)
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.engine = engine
        self.deadline_s = float(deadline_s)
        self.poll_s = (
            float(poll_s)
            if poll_s is not None
            else min(max(self.deadline_s / 4.0, 0.01), 0.25)
        )
        self.on_stall = on_stall
        self.stalls = 0
        self._eid = eid
        self._stop_evt = threading.Event()
        self._gauge = _core.gauge("serve.stalled", engine=eid)
        self._gauge.set(0)

    def stop(self) -> None:
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=max(1.0, 4 * self.poll_s))
        # A fleet respawning replicas mints fresh engine ids: the
        # stopped watchdog's gauge leaves the registry with it, so
        # replica churn cannot grow /metrics one series per engine ever
        # seen (same bounded-cardinality rule as the tenant families).
        _core.remove("serve.stalled", engine=self._eid)

    def run(self) -> None:
        last_key = None
        last_change = time.monotonic()
        fired = False
        while not self._stop_evt.wait(self.poll_s):
            eng = self.engine
            try:
                if getattr(eng.health(), "value", None) == "stopped":
                    break
                key = (eng._tick_no, eng._decode_tokens, eng._prefill_no)
                pending = len(eng.scheduler) + eng._n_running()
            except Exception:  # noqa: BLE001 — mid-teardown races
                continue
            now = time.monotonic()
            if key != last_key or pending == 0:
                last_key = key
                last_change = now
                if fired:
                    fired = False
                    self._gauge.set(0)
                continue
            if not fired and now - last_change >= self.deadline_s:
                fired = True
                self._fire(pending)

    def _fire(self, pending: int) -> None:
        self.stalls += 1
        _T_STALLS.add()
        self._gauge.set(1)
        eid = getattr(self.engine, "engine_id", "eng?")
        _core.event(
            "ops.stall",
            engine=eid,
            pending=pending,
            deadline_s=self.deadline_s,
        )
        _core.flight_dump(
            "stall", engine=eid, pending=pending, deadline_s=self.deadline_s
        )
        # Trigger-fired profiler capture (rate-limited; no-op with no
        # trigger installed): the stall's flight dump comes with a
        # bounded device profile of the wedged window.
        _timeplane.fire_profile("stall", engine=eid, pending=pending)
        try:
            self.engine._mark_stalled()
        except Exception:  # noqa: BLE001 — a dying engine is already routed out
            pass
        if self.on_stall is not None:
            try:
                self.on_stall(self.engine)
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------------------
# The plane: server + monitor + watchdogs, refcounted


@dataclasses.dataclass
class OpsConfig:
    """Knobs of one :class:`OpsPlane` (engine/router ``ops_config=``)."""

    host: str = "127.0.0.1"
    stall_deadline_s: float = 30.0
    watchdog_poll_s: Optional[float] = None
    watchdog: bool = True
    monitor: bool = True
    slo: Optional[SLOConfig] = None  # None → SLOConfig() defaults


_PLANES: Dict[int, "OpsPlane"] = {}
_PLANES_LOCK = threading.Lock()


class OpsPlane:
    """One live ops plane: HTTP server + SLO monitor + per-engine
    watchdogs.  Engines :meth:`watch`/:meth:`unwatch`; a router
    :meth:`retain`-s across replica churn.  The plane closes itself —
    server down (connection refused, no dangling listener thread),
    monitor unsubscribed, watchdogs stopped — when the last watched
    engine and the last retain are gone."""

    def __init__(self, port: int = 0, config: Optional[OpsConfig] = None):
        self.config = config or OpsConfig()
        self._lock = threading.RLock()
        self._engines: "OrderedDict[int, tuple]" = OrderedDict()
        self._retained = 0
        self._closed = False
        self.monitor: Optional[SLOMonitor] = None
        if self.config.monitor:
            self.monitor = SLOMonitor(self.config.slo).subscribe()
        try:
            self.server = OpsServer(self, port, host=self.config.host)
        except OSError:
            # Bind failure (port in use, privileged port): the half-built
            # plane is unreachable, so its listener must not outlive it —
            # a leaked listener keeps events_enabled() True process-wide.
            if self.monitor is not None:
                self.monitor.close()
            raise
        self.port = self.server.port
        with _PLANES_LOCK:
            _PLANES[self.port] = self

    @property
    def closed(self) -> bool:
        return self._closed

    def engines(self) -> List[Any]:
        with self._lock:
            return [eng for eng, _ in self._engines.values()]

    def watch(self, engine) -> None:
        """Register an engine: healthz entry + stall watchdog + the
        per-tick attribution gate (the engine's ``_ops_plane`` back-ref,
        set only when the engine doesn't already carry one).  Idempotent
        per engine."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ops plane is closed")
            if id(engine) in self._engines:
                return
            wd = None
            if self.config.watchdog:
                wd = StallWatchdog(
                    engine,
                    deadline_s=self.config.stall_deadline_s,
                    poll_s=self.config.watchdog_poll_s,
                )
                wd.start()
            self._engines[id(engine)] = (engine, wd)
        if getattr(engine, "_ops_plane", "__missing__") is None:
            engine._ops_plane = self

    def unwatch(self, engine) -> None:
        """Drop an engine (idempotent); closes the plane when it was the
        last and nothing retains it."""
        with self._lock:
            ent = self._engines.pop(id(engine), None)
        if ent is None:
            return
        _, wd = ent
        if wd is not None:
            wd.stop()
        if getattr(engine, "_ops_plane", None) is self:
            engine._ops_plane = None
        self._maybe_close()

    def retain(self) -> "OpsPlane":
        with self._lock:
            self._retained += 1
        return self

    def release(self) -> None:
        with self._lock:
            self._retained = max(0, self._retained - 1)
        self._maybe_close()

    def _maybe_close(self) -> None:
        with self._lock:
            if self._closed or self._engines or self._retained > 0:
                return
        self.close()

    def close(self) -> None:
        """Tear the plane down NOW: watchdogs stopped, monitor
        unsubscribed, server shut (its port refuses connections — the
        strongest form of a non-200 ``/healthz``).  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._engines.values())
            self._engines.clear()
        for engine, wd in entries:
            if wd is not None:
                wd.stop()
            if getattr(engine, "_ops_plane", None) is self:
                engine._ops_plane = None
        if self.monitor is not None:
            self.monitor.close()
        self.server.close()
        with _PLANES_LOCK:
            if _PLANES.get(self.port) is self:
                del _PLANES[self.port]

    # -- endpoint bodies ----------------------------------------------------

    def _healthz(self) -> Tuple[int, Dict[str, Any]]:
        states: Dict[str, str] = {}
        ready = False
        for eng in self.engines():
            try:
                hv = getattr(eng.health(), "value", str(eng.health()))
            except Exception:  # noqa: BLE001 — an engine mid-teardown
                hv = "unknown"
            states[str(getattr(eng, "engine_id", id(eng)))] = hv
            ready = ready or hv in ("ready", "starting")
        return (
            200 if ready else 503,
            {"status": "ok" if ready else "unavailable", "engines": states},
        )

    def _requests(self, limit: int = 256) -> Tuple[int, Dict[str, Any]]:
        reconstruct = _load_reconstruct()
        if reconstruct is None:
            return 503, {
                "error": "scripts/trace_report.py not importable in this "
                "installation"
            }
        records = _core.flight_records()
        source = "flight"
        if not records and _core._state.collect:
            records = list(_core._state.spans)
            source = "collector"
        report = reconstruct(records)
        # Bounded response: the `limit` MOST-RECENT timelines (by last
        # event timestamp), so a long-lived engine's flight ring can
        # never produce an unbounded JSON body.  `?limit=N` overrides;
        # `n_timelines` is the unbounded count for the caller to page.
        def last_ts(rid: str) -> float:
            return max(
                (float(e.get("ts") or 0.0)
                 for e in report.requests[rid].events),
                default=0.0,
            )

        rids = sorted(report.requests, key=lambda r: (last_ts(r), r))
        if limit > 0:
            rids = rids[-limit:]
        return 200, {
            "source": source,
            "n_records": len(records),
            "n_timelines": len(report.requests),
            "limit": limit,
            "requests": [
                report.requests[rid].summary() for rid in sorted(rids)
            ],
        }

    def _profile(self, seconds: Optional[float]) -> Tuple[int, Dict[str, Any]]:
        """On-demand bounded profiler capture (``/profile?seconds=N``):
        fires the process trigger (created into a temp directory when
        none is configured) and reports the artifact path, or 429 when
        the rate limit (cooldown / capture in flight) suppressed it."""
        trigger = _timeplane.get_trigger(create_default=True)
        window = seconds if seconds is not None else trigger.seconds
        path = trigger.fire("manual", seconds=window)
        if path is None:
            return 429, {
                "fired": False,
                "reason": "suppressed: capture in flight or inside the "
                f"{trigger.cooldown_s}s cooldown",
            }
        return 200, {"fired": True, "path": path, "seconds": window}


class _OpsHandler(BaseHTTPRequestHandler):
    server_version = "tdx-ops/1"

    def log_message(self, *args) -> None:  # silent: telemetry, not noise
        pass

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        path, _, query = self.path.partition("?")
        qs = parse_qs(query)
        plane: OpsPlane = self.server.plane  # type: ignore[attr-defined]
        try:
            if path == "/metrics":
                _T_SCRAPES.add()
                body = render_prometheus().encode("utf-8")
                code, ctype = 200, PROM_CONTENT_TYPE
            elif path == "/healthz":
                code, payload = plane._healthz()
                body = json.dumps(payload).encode("utf-8")
                ctype = "application/json"
            elif path == "/requests":
                try:
                    limit = int(qs.get("limit", ["256"])[0])
                    if limit < 1:  # the bound is the endpoint's contract
                        raise ValueError
                except ValueError:
                    code, payload = 400, {"error": "limit must be an int >= 1"}
                else:
                    code, payload = plane._requests(limit=limit)
                body = json.dumps(payload).encode("utf-8")
                ctype = "application/json"
            elif path == "/profile":
                try:
                    seconds = (
                        float(qs["seconds"][0]) if "seconds" in qs else None
                    )
                    if seconds is not None and not 0 < seconds <= 600:
                        raise ValueError
                except ValueError:
                    code, payload = 400, {
                        "error": "seconds must be a float in (0, 600]"
                    }
                else:
                    code, payload = plane._profile(seconds)
                body = json.dumps(payload).encode("utf-8")
                ctype = "application/json"
            else:
                code, ctype = 404, "text/plain"
                body = b"not found: /metrics /healthz /requests /profile\n"
        except Exception as e:  # noqa: BLE001 — a scrape must never crash
            code, ctype = 500, "text/plain"
            body = f"ops endpoint error: {e!r}\n".encode("utf-8")
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):  # pragma: no cover
            pass


class OpsServer:
    """The HTTP listener: a ``ThreadingHTTPServer`` on a daemon thread.
    ``port=0`` binds an ephemeral port (read it back from ``.port``)."""

    def __init__(self, plane: OpsPlane, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _OpsHandler)
        self._httpd.daemon_threads = True
        self._httpd.plane = plane  # type: ignore[attr-defined]
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"tdx-ops-{self.port}",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# Wiring helpers


def get_plane(
    port: int = 0, config: Optional[OpsConfig] = None
) -> OpsPlane:
    """The plane listening on ``port``, created if absent.  ``port=0``
    always creates a fresh plane on an ephemeral port.  ``config``
    applies only at creation — joiners share the creator's plane as-is."""
    port = int(port)
    if port:
        with _PLANES_LOCK:
            plane = _PLANES.get(port)
        if plane is not None and not plane.closed:
            return plane
    return OpsPlane(port, config)


def attach_engine(
    engine, port: int = 0, config: Optional[OpsConfig] = None
) -> OpsPlane:
    """``Engine(ops_port=...)``'s implementation: get-or-create the
    plane on ``port`` and watch the engine."""
    plane = get_plane(port, config)
    plane.watch(engine)
    return plane


def env_ops_port() -> Optional[int]:
    """``TDX_OPS_PORT`` as an int, or None (unset/empty/malformed)."""
    raw = os.environ.get("TDX_OPS_PORT", "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


# Per-tick attribution without a server (bench: utilization numbers with
# no HTTP listener).  The engine's gate is
# ``self._ops_plane is not None or ops.tick_attribution_enabled()`` —
# one attribute read and one module-global read per tick, no allocation.
_TICK_ATTRIBUTION = False


def enable_tick_attribution(on: bool = True) -> bool:
    """Force per-tick utilization attribution on (or off) process-wide,
    independent of any ops server.  Returns the previous value so a
    scope (bench) can restore it."""
    global _TICK_ATTRIBUTION
    prev = _TICK_ATTRIBUTION
    _TICK_ATTRIBUTION = bool(on)
    return prev


def tick_attribution_enabled() -> bool:
    return _TICK_ATTRIBUTION
