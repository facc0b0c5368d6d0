"""Signal-driven elastic autoscaler: the observe-act loop for the fleet.

Counterpart of ``torchdistx_tpu/fleet/autoscale.py``, with the same policy,
decisions and telemetry.  :class:`Autoscaler` consumes the serving
stack's signals (per-tenant SLO burn from :class:`~torchdistx_tpu_torch.
telemetry.ops.SLOMonitor`, per-engine occupancy and TTFT, the divergence
latch) and drives the fleet's actuators: scale-out through an engine
factory (:func:`engine_factory` builds one over a shared module) into
:meth:`FleetRouter.add_replica`, scale-in through ``Engine.begin_drain()``
and a reap by :meth:`FleetRouter.poll`.  A retired engine's ``close()``
releases its page pool and decode graph.

Policy (every knob on :class:`AutoscaleConfig`; ticks are control-loop
iterations, not engine ticks):

* **Scale-out** on any of, subject to the scale-out cooldown and
  ``max_replicas``:

  - an **SLO burn** — the monitor's multi-window rule already demands
    the burn sustain in both its fast and slow windows, so a burn edge
    fires a scale-out immediately (no extra sustain);
  - **occupancy** ≥ ``occupancy_high`` (mean over capacity replicas)
    sustained ``fast_ticks`` consecutive ticks — likewise TTFT ≥
    ``ttft_high_s`` when set;
  - the **queue-slope predictor**: total queue depth (read from the
    per-engine ``serve.queue_depth{engine=}`` family) growing ≥
    ``slope_high`` requests/tick over the last ``slope_window`` ticks
    pre-scales *ahead* of a ramp, before occupancy saturates.

* **Scale-in** only when the fleet is *quiet* — no tenant burning, mean
  occupancy ≤ ``occupancy_low`` AND queue depth ≤
  ``queue_low_per_replica`` × replicas — sustained ``slow_ticks``
  consecutive ticks, subject to the scale-in cooldown and
  ``min_replicas``.  The gap between the high and low water marks is the
  **hysteresis band**: a signal oscillating inside it resets both
  sustain counters and produces no decision at all, so the fleet never
  flaps.  The victim **drains by migration** first
  (:meth:`~torchdistx_tpu_torch.fleet.router.FleetRouter.migrate_out_streams`):
  its in-flight streams warm-migrate to same-version peers with zero
  recomputed prefill tokens, and only what could not move rides the
  normal drain out.

* **Role-aware placement**: in a fleet running prefill/decode
  disaggregation (engines with ``role=`` set), every spawn picks the
  scarcer role — a replacement keeps its predecessor's role — passed to
  the factory as ``make_engine(role=...)`` when it accepts the keyword
  (a role-less factory is called as before).

* **Replace, don't count**: a replica whose engine latched the
  divergence flag (the audit plane) is
  **never capacity** — it is drained and a fresh replica spawned in its
  place (``reason=replace_diverging``), independent of the load signals.
  The same deficit path respawns capacity lost to crashes below
  ``min_replicas``.

* **Recovery is an edge, not an absence**: burn state latches via the
  monitor's :meth:`~torchdistx_tpu_torch.telemetry.ops.SLOMonitor
  .add_burn_listener` API (composing with — never replacing — the
  default flight-dump ``on_burn``), and only a genuine ``burning=False``
  transition counts as a recovery.  A tenant the monitor pruned for
  idleness silently disappears instead; the autoscaler does not mistake
  "no traffic" for "SLO healthy again", and a burn that clears during a
  cooldown cannot double-fire a stale scale-out once the cooldown ends
  (the live monitor state is re-checked at decision time).

Telemetry: ``fleet.scale_outs``
/ ``fleet.scale_ins`` counters, the per-reason decision counter family
``fleet.autoscale_decision{reason=}`` (bounded: reasons are a fixed
enum), the ``fleet.replicas_target`` gauge, and one ``fleet.autoscale``
trace event per decision.  All of it is pruned by
:meth:`Autoscaler.close` per the cardinality contract.

The loop is deterministic and thread-free by default: call
:meth:`Autoscaler.tick` from your own loop (tests do).
:meth:`Autoscaler.start` runs the same tick on a daemon thread for
deployments without a convenient loop of their own.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .. import telemetry as _telemetry
from ..serving.lifecycle import Health

__all__ = ["AutoscaleConfig", "Autoscaler", "engine_factory"]

_T_SCALE_OUTS = _telemetry.counter("fleet.scale_outs")
_T_SCALE_INS = _telemetry.counter("fleet.scale_ins")
_G_TARGET = _telemetry.gauge("fleet.replicas_target")

# The full decision-reason enum (the {reason=} label set is bounded by
# construction — free-form strings would break the cardinality contract).
REASONS = (
    "burn",
    "occupancy",
    "ttft",
    "queue_slope",
    "below_min",
    "replace_diverging",
    "quiet",
)


@dataclasses.dataclass
class AutoscaleConfig:
    """Knobs of one :class:`Autoscaler` (see the module docstring for
    the policy they parameterize).  Tick-denominated windows count
    *control-loop* ticks."""

    min_replicas: int = 1
    max_replicas: int = 4
    # -- scale-out (high water) --------------------------------------------
    occupancy_high: float = 0.85
    ttft_high_s: Optional[float] = None
    fast_ticks: int = 2  # consecutive ticks a high signal must sustain
    # -- queue-slope predictor ---------------------------------------------
    slope_window: int = 4  # ticks of total-queue-depth history
    slope_high: float = 2.0  # growth (requests/tick) that pre-scales
    # -- scale-in (low water: the hysteresis band's floor) -----------------
    occupancy_low: float = 0.30
    queue_low_per_replica: float = 0.5
    slow_ticks: int = 8  # consecutive quiet ticks before scale-in
    # -- cooldowns (ticks since the LAST scaling action) -------------------
    scale_out_cooldown: int = 3
    scale_in_cooldown: int = 6

    def validate(self) -> "AutoscaleConfig":
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                "need 1 <= min_replicas <= max_replicas, got "
                f"[{self.min_replicas}, {self.max_replicas}]"
            )
        if not 0.0 <= self.occupancy_low < self.occupancy_high <= 1.0:
            raise ValueError(
                "need 0 <= occupancy_low < occupancy_high <= 1 (the "
                "hysteresis band), got "
                f"[{self.occupancy_low}, {self.occupancy_high}]"
            )
        for field in (
            "fast_ticks",
            "slow_ticks",
            "slope_window",
            "scale_out_cooldown",
            "scale_in_cooldown",
        ):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1")
        return self


def engine_factory(model, *, device: Optional[Any] = None, **engine_kwargs) -> Callable:
    """A replica factory over one shared module: ``make(role=None)`` builds
    ``Engine(model, device=..., role=..., **engine_kwargs)``.  Replicas of
    one version share the module, so its weights are held once, and so is
    its ``prep_decode`` copy while the weights are unchanged (it leaves
    with the last engine holding it); each engine adds its own page pool
    and decode graph, both released by its ``close()``.

    ``device=None`` is CUDA, resolved when the factory is built (raises
    without CUDA); pass ``"cpu"`` for the host."""
    from .._device import resolve_device
    from ..serving.engine import Engine

    dev = resolve_device(device)

    def make(role: Optional[str] = None):
        kw = dict(engine_kwargs)
        if role is not None:
            kw["role"] = role
        return Engine(model, device=dev, **kw)

    return make


class Autoscaler:
    """The control loop: one :meth:`tick` observes, decides, acts.

    Parameters
    ----------
    router : :class:`~torchdistx_tpu_torch.fleet.router.FleetRouter`
        The fleet whose membership this loop owns.
    make_engine : ``() -> Engine``
        Replica factory for scale-out and replacement — typically wraps
        :func:`~torchdistx_tpu_torch.fleet.hot_swap.materialize_standby` +
        ``Engine(...)``.  Called inline from :meth:`tick`.
    config : :class:`AutoscaleConfig`
    monitor : :class:`~torchdistx_tpu_torch.telemetry.ops.SLOMonitor`, optional
        Burn-signal source.  Defaults to the router's ops plane monitor
        (``router.ops_plane.monitor``) when the plane exists; without
        either, the loop runs on occupancy/queue signals alone.
    version : weights version tag passed to ``add_replica``.
    """

    def __init__(
        self,
        router,
        make_engine: Callable[[], Any],
        *,
        config: Optional[AutoscaleConfig] = None,
        monitor=None,
        version: str = "v0",
    ):
        self.router = router
        self.make_engine = make_engine
        self.config = (config or AutoscaleConfig()).validate()
        self.version = version
        if monitor is None:
            plane = getattr(router, "ops_plane", None)
            monitor = getattr(plane, "monitor", None)
        self.monitor = monitor
        # Decision/introspection state (instance-local so tests and
        # benches read deltas without rummaging in global counters):
        self.scale_outs = 0
        self.scale_ins = 0
        self.replaces = 0
        self.recoveries = 0  # genuine burning→False edges seen
        self.decisions: deque = deque(maxlen=256)  # (tick, reason, n, target)
        self.burn_events: deque = deque(maxlen=256)  # (t, tenant, burning)
        # Control-loop state:
        self._tick_no = 0
        self._hi_ticks = 0
        self._lo_ticks = 0
        self._last_out: Optional[int] = None  # tick of last out/replace
        self._last_in: Optional[int] = None
        self._q_hist: deque = deque(maxlen=self.config.slope_window)
        # Burn latch, written by the monitor's listener thread:
        self._lock = threading.Lock()
        self._burning: Dict[str, bool] = {}
        self._burn_edge = False
        self._attached = False
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.attach()

    # ------------------------------------------------------------------
    # Lifecycle

    def attach(self) -> "Autoscaler":
        """Subscribe the burn listener (idempotent; composes with the
        monitor's default flight-dump callback, see
        :meth:`SLOMonitor.add_burn_listener`)."""
        if self.monitor is not None and not self._attached:
            self.monitor.add_burn_listener(self._on_burn)
            self._attached = True
        return self

    def close(self) -> None:
        """Detach from the monitor, stop the background thread if any,
        and prune this loop's registry families (cardinality contract:
        a retired control plane leaves nothing behind in /metrics)."""
        self.stop()
        if self.monitor is not None and self._attached:
            self.monitor.remove_burn_listener(self._on_burn)
            self._attached = False
        _G_TARGET.set(None)
        for reason in REASONS:
            _telemetry.remove("fleet.autoscale_decision", reason=reason)

    # ------------------------------------------------------------------
    # Burn listener (monitor's emitting thread)

    def _on_burn(self, tenant: str, burning: bool, info) -> None:
        with self._lock:
            self.burn_events.append((time.time(), tenant, burning))
            if burning:
                self._burning[tenant] = True
                self._burn_edge = True
            elif self._burning.pop(tenant, None):
                # A REAL recovery transition.  Idle-pruned tenants never
                # reach here (the monitor suppresses that edge), so
                # "tenant went quiet" is never miscounted as "SLO
                # recovered".
                self.recoveries += 1

    # ------------------------------------------------------------------
    # Signals

    def _signals(self, capacity: List[Any]) -> Dict[str, Any]:
        """One observation of the fleet: occupancy / TTFT from the
        per-engine attribution gauges when the ops plane publishes them
        (falling back to the engines' own hooks), queue depth from the
        ``serve.queue_depth{engine=}`` family (satellite of this PR —
        the unlabeled gauge is clobbered by N replicas)."""
        gauges = _telemetry.gauges()
        occs: List[float] = []
        ttfts: List[float] = []
        queue = 0.0
        for rep in capacity:
            eng = rep.engine
            eid = getattr(eng, "engine_id", None)
            occ = gauges.get(f"serve.occupancy{{engine={eid}}}")
            if occ is None:
                slots = max(1, getattr(eng, "num_slots", 1))
                occ = eng._n_running() / slots
            occs.append(float(occ))
            q = gauges.get(f"serve.queue_depth{{engine={eid}}}")
            if q is None:
                q = len(eng.scheduler)
            queue += float(q)
            t = gauges.get(f"serve.est_ttft_s{{engine={eid}}}")
            if t is None:
                t = eng.est_ttft_s()
            ttfts.append(float(t))
        self._q_hist.append(queue)
        slope = 0.0
        if len(self._q_hist) == self._q_hist.maxlen:
            slope = (self._q_hist[-1] - self._q_hist[0]) / max(
                1, len(self._q_hist) - 1
            )
        return {
            "occupancy": sum(occs) / len(occs) if occs else 0.0,
            "ttft_s": max(ttfts) if ttfts else 0.0,
            "queue": queue,
            "queue_slope": slope,
        }

    # ------------------------------------------------------------------
    # The control tick

    def tick(self) -> str:
        """One observe→decide→act iteration; returns the decision reason
        (one of :data:`REASONS`, or ``"hold"``)."""
        cfg = self.config
        self._tick_no += 1
        # 1. Supervision: reap STOPPED replicas (crashed, closed, or
        # drained out by an earlier scale-in) — their gauge families
        # were pruned by the engines' own teardown; the router notifies
        # its reap listeners.  No user-code poll() required.
        self.router.poll()
        # 2. Partition the fleet.  Latched-diverging replicas are NEVER
        # capacity (hard rule): they serve wrong-token streams, so
        # counting them would both under-scale and route load into the
        # incident.
        reps = self.router.replicas()
        capacity: List[Any] = []
        diverging: List[Any] = []
        draining: List[Any] = []
        for rep in reps:
            h = rep.engine.health()
            if h is Health.DRAINING:
                draining.append(rep)
            elif getattr(rep.engine, "_diverging", False):
                diverging.append(rep)
            else:
                capacity.append(rep)
        # 3. Step draining replicas so drains progress even when no
        # consumer is pulling their handles (same rationale as
        # router.step()); they re-enter poll()'s reap at STOPPED.
        for rep in draining:
            try:
                rep.engine.step()
            except Exception:  # noqa: BLE001 — a dying drain is poll()'s problem
                pass
        # 4. Replace rule: drain every newly-diverging replica and spawn
        # its replacement immediately — replacement is incident
        # remediation, not load-driven growth, so it bypasses the
        # sustain windows (but still lands inside max_replicas via the
        # fleet-size guard below).
        decision = "hold"
        for rep in diverging:
            self.router.close_admission(rep.rid)
            rep.engine.begin_drain()
            self.replaces += 1
            if len(capacity) + 1 <= cfg.max_replicas:
                # The replacement inherits the drained replica's role so
                # a disaggregated fleet keeps its prefill/decode shape.
                self._spawn(role=getattr(rep.engine, "role", None))
                capacity.append(self.router.replicas()[-1])
            self._last_out = self._tick_no
            decision = self._decide("replace_diverging", len(capacity))
        n = len(capacity)
        sig = self._signals(capacity)
        with self._lock:
            burn_edge = self._burn_edge
            self._burn_edge = False
        # Live burn state re-checked at decision time: a burn that
        # cleared (or was idle-pruned) during a cooldown must not fire a
        # stale scale-out from the edge latch alone.
        burning_now = bool(self.monitor and any(self.monitor.burning().values()))
        # 5. Sustain counters for the high/low signal bands.  Anything
        # inside the hysteresis band resets both: no decision, no flap.
        high = None
        if burn_edge or burning_now:
            high = "burn"
        elif sig["occupancy"] >= cfg.occupancy_high:
            high = "occupancy"
        elif (
            cfg.ttft_high_s is not None and sig["ttft_s"] >= cfg.ttft_high_s
        ):
            high = "ttft"
        self._hi_ticks = self._hi_ticks + 1 if high else 0
        predict = (
            len(self._q_hist) == self._q_hist.maxlen
            and sig["queue_slope"] >= cfg.slope_high
        )
        quiet = (
            not burning_now
            and not burn_edge
            and sig["occupancy"] <= cfg.occupancy_low
            and sig["queue"] <= cfg.queue_low_per_replica * max(1, n)
        )
        self._lo_ticks = self._lo_ticks + 1 if quiet else 0
        # 6. Decide.  Deficit repair first (capacity below the floor is
        # an outage, not a load signal — no cooldown applies), then
        # scale-out under cooldown, then scale-in under its own.
        want_out = (
            high == "burn"  # the monitor already enforced dual-window sustain
            or (high is not None and self._hi_ticks >= cfg.fast_ticks)
            or predict
        )
        if n < cfg.min_replicas:
            while n < cfg.min_replicas:
                self._spawn(role=self._desired_role())
                n += 1
            self._last_out = self._tick_no
            self._hi_ticks = self._lo_ticks = 0
            decision = self._decide("below_min", n)
        elif (
            want_out
            and n < cfg.max_replicas
            and self._cooled(self._last_out, cfg.scale_out_cooldown)
        ):
            reason = high if high is not None else "queue_slope"
            self._spawn(role=self._desired_role())
            self.scale_outs += 1
            _T_SCALE_OUTS.add()
            self._last_out = self._tick_no
            self._hi_ticks = 0
            self._lo_ticks = 0
            n += 1
            decision = self._decide(reason, n)
        elif (
            quiet
            and self._lo_ticks >= cfg.slow_ticks
            and n > cfg.min_replicas
            and self._cooled(self._last_in, cfg.scale_in_cooldown)
            and self._cooled(self._last_out, cfg.scale_in_cooldown)
        ):
            victim = max(capacity, key=lambda r: (-r.load(), r.rid))
            self.router.close_admission(victim.rid)
            # Drain by migration: ship the victim's in-flight streams to
            # surviving same-version peers (zero recomputed tokens);
            # whatever could not move finishes under the normal drain.
            self.router.migrate_out_streams(victim.rid)
            victim.engine.begin_drain()
            self.scale_ins += 1
            _T_SCALE_INS.add()
            self._last_in = self._tick_no
            self._lo_ticks = 0
            n -= 1
            decision = self._decide("quiet", n)
        _G_TARGET.set(max(cfg.min_replicas, min(cfg.max_replicas, n)))
        # One trace event per tick (free when nothing records): the
        # decision timeline scripts/autoscale_report.py reads back.
        _telemetry.event(
            "fleet.autoscale",
            decision=decision,
            replicas=n,
            draining=len(draining) + len(diverging),
            occupancy=round(sig["occupancy"], 4),
            queue=sig["queue"],
            queue_slope=round(sig["queue_slope"], 3),
            burning=burning_now,
            tick=self._tick_no,
        )
        return decision

    def _cooled(self, last: Optional[int], cooldown: int) -> bool:
        return last is None or self._tick_no - last >= cooldown

    def _desired_role(self) -> Optional[str]:
        """Role for the next spawn in a disaggregated fleet: the
        scarcer of prefill/decode among non-draining replicas (ties go
        to decode — decode capacity bounds steady-state throughput).
        None (factory default) in a role-less fleet."""
        roles = [
            getattr(rep.engine, "role", "mixed")
            for rep in self.router.replicas()
            if rep.engine.health() is not Health.DRAINING
        ]
        if not any(r != "mixed" for r in roles):
            return None
        n_prefill = sum(r == "prefill" for r in roles)
        n_decode = sum(r == "decode" for r in roles)
        return "prefill" if n_prefill < n_decode else "decode"

    def _spawn(self, role: Optional[str] = None) -> int:
        if role is not None:
            try:
                eng = self.make_engine(role=role)
            except TypeError:
                # Factory predates roles (or hard-pins its own): spawn
                # role-less rather than refusing to scale.
                eng = self.make_engine()
        else:
            eng = self.make_engine()
        return self.router.add_replica(eng, version=self.version)

    def _decide(self, reason: str, n: int) -> str:
        _telemetry.counter("fleet.autoscale_decision", reason=reason).add()
        self.decisions.append((self._tick_no, reason, n))
        return reason

    # ------------------------------------------------------------------
    # Optional background loop

    def start(self, interval_s: float = 1.0) -> "Autoscaler":
        """Run :meth:`tick` on a daemon thread every ``interval_s``.
        Deployments with their own serving loop should call ``tick()``
        directly instead (deterministic, single-threaded)."""
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def _loop() -> None:
            while not self._stop_evt.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — scaling never kills serving
                    pass

        self._thread = threading.Thread(
            target=_loop, name="tdx-autoscale", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        self._thread = None
