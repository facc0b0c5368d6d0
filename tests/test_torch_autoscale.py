"""The port's autoscaler on the CPU, after ``tests/test_autoscale.py``.

Over duck-typed engines (each package's own ``Health``) driven through one
scripted signal sequence (occupancy, queue depth, a crash, a diverging
replica, an SLO burn and its recovery fed to each package's
``SLOMonitor``), ``Autoscaler.tick`` makes JAX's decisions tick by tick,
with the same replica counts.  Over real port engines on ``llama_test``
(f32) built by ``engine_factory``, a burst scales out and the idle fleet
scales back in: every page free and every engine STOPPED at the end.
Tolerance: none (exact).
"""

import itertools

import pytest

from torchdistx_tpu import fleet as jfleet
from torchdistx_tpu.serving import Health as JHealth
from torchdistx_tpu.telemetry import ops as jops
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.fleet import (
    Autoscaler,
    AutoscaleConfig,
    FleetRouter,
    engine_factory,
)
from torchdistx_tpu_torch.resilience import preemption
from torchdistx_tpu_torch.serving import Health
from torchdistx_tpu_torch.telemetry import ops

from _torch_serving_planes import load, prompt_of

ENGINE_KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 handle_preemption=False, prefix_cache=False)


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    yield
    preemption.clear()


class _Queue:
    def __init__(self):
        self.n = 0

    def __len__(self):
        return self.n


def fake_engine_cls(health_enum):
    seq = itertools.count()

    class FakeEngine:
        def __init__(self, role=None):
            self.engine_id = f"fake{next(seq)}"
            self.num_slots = 4
            self.scheduler = _Queue()
            self.occ = 0.0
            self.est = 0.01
            self._health = health_enum.READY
            self._diverging = False
            self.drain_steps = 2
            if role is not None:
                self.role = role

        def health(self):
            return self._health

        def est_ttft_s(self):
            return self.est

        def _n_running(self):
            return int(round(self.occ * self.num_slots))

        def begin_drain(self):
            if self._health is not health_enum.STOPPED:
                self._health = health_enum.DRAINING

        def step(self):
            if self._health is health_enum.DRAINING:
                self.drain_steps -= 1
                if self.drain_steps <= 0:
                    self._health = health_enum.STOPPED

        def close(self):
            self._health = health_enum.STOPPED

    return FakeEngine


def _rec(name, rid, ts, **attrs):
    return {"type": "event", "name": name, "rid": rid, "ts": ts, "attrs": attrs}


def _feed(mon, first_rid, ts, n, ok):
    for i in range(n):
        rid = first_rid + i
        mon._on_record(_rec("req.submitted", rid, ts + i * 0.1, tenant="acme"))
        if ok:
            mon._on_record(_rec("req.finished", rid, ts + i * 0.1 + 0.01))
        else:
            mon._on_record(_rec("req.failed", rid, ts + i * 0.1 + 0.01,
                                error="DeadlineExceeded", retryable=False))


def _script(router_cls, scaler_cls, cfg_cls, ops_mod, health_enum):
    """One scripted run; returns ``[(decision, n replicas, n live)]``."""
    mon = ops_mod.SLOMonitor(ops_mod.SLOConfig(slo=0.9, fast_window_s=10, slow_window_s=50,
                                               burn_threshold=2.0, min_samples=5,
                                               on_burn=lambda t, i: None))
    fake = fake_engine_cls(health_enum)
    router = router_cls([])
    router.add_replica(fake())
    cfg = cfg_cls(min_replicas=1, max_replicas=4, fast_ticks=2, slow_ticks=3,
                  slope_window=3, slope_high=2.0, scale_out_cooldown=2, scale_in_cooldown=3)
    scaler = scaler_cls(router, fake, config=cfg, monitor=mon)
    out = []

    def tick(occ=None, queue=None):
        for rep in router.replicas():
            if occ is not None:
                rep.engine.occ = occ
            if queue is not None:
                rep.engine.scheduler.n = queue
        decision = scaler.tick()
        live = [r for r in router.replicas() if r.engine.health() is not health_enum.DRAINING]
        out.append((decision, len(router.replicas()), len(live)))

    tick(0.95)
    tick(0.95)  # sustained: scale out
    tick(0.6)  # inside the band: hold
    tick(0.95)
    tick(0.95)  # cooled: scale out again
    for q in (0, 3, 6, 9, 12):  # the queue-slope predictor
        tick(0.5, q)
    for _ in range(12):  # quiet: scale in, one at a time under cooldowns
        tick(0.0, 0)
    router.replicas()[0].engine.close()  # a crash below the floor
    tick(0.0, 0)
    router.replicas()[-1].engine._diverging = True  # replaced, never capacity
    tick(0.0, 0)
    _feed(mon, 0, 1000.0, 8, ok=False)  # an SLO burn
    tick(0.1, 0)
    tick(0.1, 0)
    _feed(mon, 100, 1060.0, 20, ok=True)  # recovery: no second scale-out
    for _ in range(4):
        tick(0.1, 0)
    out.append(("counts", scaler.scale_outs, scaler.scale_ins, scaler.replaces,
                scaler.recoveries))
    out.append(("decisions", list(scaler.decisions)))
    scaler.close()
    mon.close()
    return out


def test_tick_decisions_equal_jax():
    theirs = _script(jfleet.FleetRouter, jfleet.Autoscaler, jfleet.AutoscaleConfig, jops,
                     JHealth)
    ours = _script(FleetRouter, Autoscaler, AutoscaleConfig, ops, Health)
    assert ours == theirs
    decisions = [row[0] for row in ours[:-2]]
    for reason in ("occupancy", "queue_slope", "quiet", "below_min", "replace_diverging",
                   "burn"):
        assert reason in decisions, reason


def test_role_aware_spawn_equals_jax():
    got = []
    for router_cls, scaler_cls, cfg_cls, health in (
            (jfleet.FleetRouter, jfleet.Autoscaler, jfleet.AutoscaleConfig, JHealth),
            (FleetRouter, Autoscaler, AutoscaleConfig, Health)):
        fake = fake_engine_cls(health)
        router = router_cls([])
        router.add_replica(fake(role="prefill"))
        router.add_replica(fake(role="decode"))
        router.add_replica(fake(role="decode"))
        scaler = scaler_cls(router, fake, config=cfg_cls(min_replicas=1, max_replicas=6,
                                                         fast_ticks=1, scale_out_cooldown=1))
        roles = []
        for _ in range(3):
            for rep in router.replicas():
                rep.engine.occ = 0.95
            scaler.tick()
            roles.append([getattr(r.engine, "role", "mixed") for r in router.replicas()])
        got.append(roles)
        scaler.close()
    assert got[1] == got[0]


def test_config_validation():
    for bad in (dict(min_replicas=3, max_replicas=2), dict(occupancy_low=0.9, occupancy_high=0.8),
                dict(fast_ticks=0)):
        with pytest.raises(ValueError):
            AutoscaleConfig(**bad).validate()
        with pytest.raises(ValueError):
            jfleet.AutoscaleConfig(**bad).validate()


def test_scale_out_and_in_over_real_engines():
    """A burst of 8 requests on one replica (both slots busy) scales out;
    a second wave lands on the new replica; the idle fleet scales back in
    to one, each retired engine's pool and graphs released."""
    model = load("llama")[3]
    make = engine_factory(model, device="cpu", max_prefills_per_tick=2, **ENGINE_KW)
    router = FleetRouter([make()], version="v1")
    cfg = AutoscaleConfig(min_replicas=1, max_replicas=3, fast_ticks=2, slow_ticks=2,
                          scale_out_cooldown=1, scale_in_cooldown=1)
    scaler = Autoscaler(router, make, config=cfg, version="v1")
    made = [router.replicas()[0].engine]

    def tick():
        for rep in router.replicas():
            if rep.engine.health() is not Health.STOPPED:
                rep.engine.step()
        scaler.tick()
        made.extend(r.engine for r in router.replicas() if r.engine not in made)

    burst = [router.submit(prompt_of(4 + i % 5, base=i), max_new_tokens=24, key=i)
             for i in range(8)]
    while scaler.scale_outs == 0:
        assert not all(h.done for h in burst), "the burst ended without a scale-out"
        tick()
    wave = [router.submit(prompt_of(5, base=40 + i), max_new_tokens=8, key=40 + i)
            for i in range(2)]
    assert {h.replica_id for h in wave} - {0}, "the second wave avoided the new replica"
    for _ in range(60):
        if all(h.done for h in burst + wave) and len(router.replicas()) == 1:
            break
        tick()
    assert scaler.scale_ins >= 1 and len(router.replicas()) == 1
    assert [len(h.result()) for h in burst + wave] == [24] * 8 + [8] * 2
    survivor = router.replicas()[0].engine
    g = telemetry.gauges()
    for eng in made:
        if eng is not survivor:
            assert eng.health() is Health.STOPPED
            assert eng._cache is None and not eng._decoders  # pool and graphs released
            assert f"serve.queue_depth{{engine={eng.engine_id}}}" not in g
    scaler.close()
    router.close()
    for eng in made:
        assert eng.health() is Health.STOPPED and eng.allocator.num_in_use == 0
