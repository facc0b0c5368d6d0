"""The port's time plane on the CPU, after ``tests/test_timeplane.py``.

``PHASES`` is JAX's; on the same traffic over the same ``llama_test``
weights (f32), every non-idle tick of the port's engine publishes the same
phase labels, in the same order, as the JAX engine's tick; idle ticks
publish nothing; the phase rows leave the registry with the engine.  The
profiler trigger's rate limit and suppression counts equal JAX's under one
fake clock; a real ``torch.profiler`` capture on the CPU writes a Chrome
trace.  No test holds a host-time ratio (those vary with the machine):
only that ``serve.host_overhead_frac`` lies in [0, 1].
"""

import json
import os
import time

import pytest
import torch

from torchdistx_tpu import telemetry as jtelemetry
from torchdistx_tpu.telemetry import ops as jops
from torchdistx_tpu.telemetry import timeplane as jtimeplane
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.resilience import preemption
from torchdistx_tpu_torch.serving import Health
from torchdistx_tpu_torch.telemetry import ops, timeplane

from _torch_serving_planes import engines, load, prompt_of

ENGINE_KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4)
TRAFFIC = [dict(prompt=prompt_of(4), max_new_tokens=9, key=0),
           dict(prompt=prompt_of(20, base=3), max_new_tokens=6, key=1),
           dict(prompt=prompt_of(7, base=9), max_new_tokens=5, key=2)]


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    saved = [(t, t.configure(collect=False, jsonl=None, flight=None)) for t in
             (telemetry, jtelemetry)]
    for t in (telemetry, jtelemetry):
        t.reset()
    yield
    for o in (ops, jops):
        o.enable_tick_attribution(False)
        for plane in list(o._PLANES.values()):
            plane.close()
    for tp in (timeplane, jtimeplane):
        tp.set_trigger(None)
    for t, prev in saved:
        t.configure(**prev)
        t.reset()


@pytest.fixture(scope="module")
def fam():
    return load("llama")


def stub(cls, path, **kw):
    """A trigger of ``cls`` whose profiler seam only counts."""

    class Stub(cls):
        def _start_profiler(self, p):
            self.started.append(p)

        def _stop_profiler(self):
            self.stopped += 1

    kw.setdefault("seconds", 0.01)
    trig = Stub(str(path), **kw)
    trig.started, trig.stopped = [], 0
    return trig


def _tick_labels(tel, eid):
    return [[seg[0] for seg in r["attrs"]["segments"]] for r in tel.snapshot()["spans"]
            if r.get("name") == "serve.tick" and r.get("engine") == eid]


def test_phases_equal_jax():
    assert timeplane.PHASES == jtimeplane.PHASES
    assert timeplane._SLOW_TICK_MIN_TICKS == jtimeplane._SLOW_TICK_MIN_TICKS


def test_tick_phase_labels_equal_jax_and_idle_ticks_publish_nothing(fam):
    for t in (telemetry, jtelemetry):
        t.configure(collect=True)
    for o in (ops, jops):
        o.enable_tick_attribution(True)
    jeng, teng = engines(fam, **ENGINE_KW)
    got = {}
    for name, eng, tel in (("jax", jeng, jtelemetry), ("port", teng, telemetry)):
        hs = [eng.submit(**r) for r in TRAFFIC]
        ticks = 0
        while not all(h.done for h in hs):
            eng.step()
            ticks += 1
        eid = eng.engine_id
        labels = _tick_labels(tel, eid)
        assert len(labels) == ticks
        hists = tel.histograms()
        counts = {ph: hists[f"serve.tick_phase_s{{engine={eid},phase={ph}}}"]["count"]
                  for ph in timeplane.PHASES if ph != "audit_pump"}
        for _ in range(4):  # idle: no event, no observation
            eng.step()
        assert _tick_labels(tel, eid) == labels
        hists = tel.histograms()
        assert counts == {
            ph: hists[f"serve.tick_phase_s{{engine={eid},phase={ph}}}"]["count"]
            for ph in counts}
        frac = tel.gauges()[f"serve.host_overhead_frac{{engine={eid}}}"]
        assert frac == 0  # zeroed at the idle edge
        got[name] = labels
        eng.close()
    assert got["port"] == got["jax"]
    flat = {ph for tick in got["port"] for ph in tick}
    assert flat == {"schedule", "prefill_dispatch", "decode_dispatch", "device_wait", "commit"}
    summaries = timeplane.phase_summaries(teng.engine_id)
    assert summaries == {}  # pruned with the engine


def test_host_overhead_frac_in_unit_interval_and_rows_pruned(fam):
    ops.enable_tick_attribution(True)
    for stop in ("drain", "close"):
        eng = engines_port(fam)
        h = eng.submit(prompt_of(4), max_new_tokens=6, key=0)
        while not h.done:
            eng.step()
            eid = eng.engine_id
            frac = telemetry.gauges()[f"serve.host_overhead_frac{{engine={eid}}}"]
            assert 0.0 <= frac <= 1.0
        assert timeplane.phase_summaries(eid)
        if stop == "drain":
            eng.begin_drain()
            while eng.health() is not Health.STOPPED:
                eng.step()
        else:
            eng.close()
        assert not any(k.startswith(f"serve.tick_phase_s{{engine={eid}")
                       for k in telemetry.histograms())
        assert f"serve.host_overhead_frac{{engine={eid}}}" not in telemetry.gauges()


def engines_port(fam):
    from torchdistx_tpu_torch.serving import Engine

    return Engine(fam[3], device="cpu", handle_preemption=False, **ENGINE_KW)


def test_default_engine_builds_no_timer(fam):
    eng = engines_port(fam)
    h = eng.submit(prompt_of(4), max_new_tokens=4, key=0)
    assert h.result()
    assert eng._tp_state is None and eng._tick_timer is None
    assert not any(k.startswith("serve.tick_phase_s") for k in telemetry.histograms())
    eng.close()


def test_tick_timer_segments_equal_jax_layout():
    for mod in (timeplane, jtimeplane):
        t = mod.TickTimer()
        t.begin("schedule")
        t.begin("decode_dispatch")
        t.begin("schedule")
        t.end()
        t.end()
        assert [s[0] for s in t.segments] == ["schedule", "decode_dispatch", "schedule"]
        for (_, off1, dur1), (_, off2, _) in zip(t.segments, t.segments[1:]):
            assert off2 == pytest.approx(off1 + dur1, abs=1e-6)


def test_trigger_rate_limit_equals_jax_under_a_fake_clock(tmp_path, monkeypatch):
    """The same fire times against both triggers: the same accepted
    captures and suppressions (cooldown and in-flight)."""
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    fires = [0.0, 1.0, 5.0, 10.0, 10.5, 31.0, 31.0, 70.0]
    outcomes = []
    for mod, tel in ((jtimeplane, jtelemetry), (timeplane, telemetry)):
        tel.configure(collect=True)
        trig = stub(mod.ProfilerTrigger, tmp_path / mod.__name__, cooldown_s=20.0)
        row = []
        for t in fires:
            clock["t"] = 1000.0 + t
            trig.wait(5.0)  # the previous window closes before the next fire
            row.append(trig.fire("stall", engine="eng0") is not None)
        trig.wait(5.0)
        spans = tel.snapshot()["spans"]
        outcomes.append((row, trig.suppressed, len(trig.captures),
                         sum(r.get("name") == "ops.profile_suppressed" for r in spans),
                         [os.path.basename(p) for p in trig.captures]))
        assert trig.started == trig.captures and trig.stopped == len(trig.captures)
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][0] == [True, False, False, False, False, True, False, True]


def test_fire_profile_skips_manual_only_and_missing_triggers():
    assert timeplane.get_trigger() is None
    assert timeplane.fire_profile("stall") is None
    trig = timeplane.get_trigger(create_default=True)
    assert trig.manual_only and timeplane.fire_profile("stall") is None
    assert trig.captures == []


def test_slow_tick_fires_only_a_real_trigger(tmp_path, fam):
    ops.enable_tick_attribution(True)
    eng = engines_port(fam)
    for manual_only, want in ((True, 0), (False, 1)):
        trig = stub(timeplane.ProfilerTrigger, tmp_path / str(want), cooldown_s=0.0)
        trig.manual_only = manual_only
        timeplane.set_trigger(trig)
        for _ in range(timeplane._SLOW_TICK_MIN_TICKS):
            eng._tick_telemetry(0.001, 0, 1, 0)
        timer = timeplane.TickTimer()
        timer.begin("schedule")
        timer.end()
        timeplane.publish_tick(eng, timer, tick_s=1.0)
        trig.wait(5.0)
        assert len(trig.captures) == want
    eng.close()


def test_cpu_profiler_capture_writes_a_chrome_trace(tmp_path):
    """A real capture: torch.profiler with the CPU activity, started on
    the trigger's thread while this thread runs ops, written as
    ``trace.json`` under the artifact directory."""
    trig = timeplane.ProfilerTrigger(str(tmp_path), seconds=0.3, cooldown_s=0.0)
    path = trig.fire("manual")
    assert path is not None
    x = torch.randn(64, 64)
    t_end = time.monotonic() + 0.5
    while time.monotonic() < t_end:
        x = torch.tanh(x @ x)
    trig.wait(30.0)
    trace = os.path.join(path, "trace.json")
    assert os.path.isfile(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert events


def test_prune_engine_leaves_no_labelled_series():
    for ph in timeplane.PHASES:
        telemetry.histogram("serve.tick_phase_s", engine="ex", phase=ph).observe(0.001)
    telemetry.gauge("serve.host_overhead_frac", engine="ex").set(0.5)
    assert timeplane.phase_summaries("ex")
    timeplane.prune_engine("ex")
    assert timeplane.phase_summaries("ex") == {}
    assert not any("engine=ex" in k for k in telemetry.histograms())
    assert not any("engine=ex" in k for k in telemetry.gauges())
