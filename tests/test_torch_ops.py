"""The port's ops plane on the CPU, after ``tests/test_ops.py``.

``render_prometheus`` over identical registry contents is byte-identical
to JAX's; ``SLOMonitor`` fed the same record sequence (event timestamps
are its clock) makes the same burn transitions, callbacks and summary; the
``StallWatchdog`` marks a wedged port engine OVERLOADED and its next tick
restores READY; the HTTP endpoints of a port engine on 127.0.0.1 answer
``/metrics`` (a valid exposition with the tick attribution), ``/healthz``,
``/requests?limit=2`` and ``/profile`` (200, then 429); ``TDX_OPS_PORT``
attaches a plane; two engines share one, and it closes with the last.
Tolerance: none (exact).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from torchdistx_tpu import telemetry as jtelemetry
from torchdistx_tpu.telemetry import _core as jcore
from torchdistx_tpu.telemetry import ops as jops
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.resilience import preemption
from torchdistx_tpu_torch.serving import Engine, Health
from torchdistx_tpu_torch.telemetry import _core, ops, timeplane

from _torch_serving_planes import load, prompt_of

ENGINE_KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 handle_preemption=False)


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    prev = telemetry.configure(collect=False, jsonl=None, flight=None)
    telemetry.reset()
    yield
    for plane in list(ops._PLANES.values()):
        plane.close()
    ops.enable_tick_attribution(False)
    timeplane.set_trigger(None)
    telemetry.configure(**prev)
    telemetry.reset()


@pytest.fixture(scope="module")
def model():
    return load("llama")[3]


def http_get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_for(pred, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


# ---------------------------------------------------------------------------
# render_prometheus


def _registry_a(t):
    t.counter("serve.requests").add(7)
    t.counter("serve.shed", engine="eng0").add(2)
    t.gauge("serve.running_slots").set(3)
    t.gauge("serve.health", engine="eng0").set("ready")
    t.gauge("serve.health", engine="eng1").set("overloaded")
    t.gauge("serve.est_ttft_s").set(0.125)
    t.gauge("serve.flag").set(True)
    t.gauge("serve.unset")  # None: not rendered


def _registry_b(t):
    t.gauge("serve.slo_burning", tenant='we,ird="t\\n=x').set(1)
    t.gauge("9lives.metric-name").set(2.5)
    for v in (0.001, 0.02, 0.02, 0.5, 3.0, 1e4):
        t.histogram("serve.ttft_s", engine="eng0").observe(v)
    t.gauge("serve.ttft_s").set(0.02)  # a gauge sharing the histogram's name
    t.counter("serve.tick_s_count").add(4)  # collides with a histogram series
    t.histogram("serve.tick_s").observe(0.25)


def _registry_c(t):
    for ph in ("schedule", "device_wait", "commit"):
        h = t.histogram("serve.tick_phase_s", engine="eng0", phase=ph)
        for v in (1e-5, 3e-4, 0.0071):
            h.observe(v)
    t.gauge("serve.host_overhead_frac", engine="eng0").set(0.4821)
    t.counter("ops.scrapes").add(1)
    t.gauge("fleet.replicas_ready").set(2)


@pytest.mark.parametrize("fill", [_registry_a, _registry_b, _registry_c], ids="abc")
def test_render_prometheus_is_byte_identical_to_jax(monkeypatch, fill):
    for core in (_core, jcore):
        for attr in ("counters", "gauges", "histograms"):
            monkeypatch.setattr(core._state, attr, {})
    fill(telemetry)
    fill(jtelemetry)
    ours, theirs = ops.render_prometheus(), jops.render_prometheus()
    assert ours == theirs
    assert ours.endswith("\n") and "# TYPE" in ours


# ---------------------------------------------------------------------------
# SLOMonitor


def _rec(name, rid, ts, **attrs):
    return {"type": "event", "name": name, "rid": rid, "ts": ts, "attrs": attrs}


def _slo_records():
    """Misses that burn, a recovery, a blip, TTFT breaches, shed and
    failover rates, a cancel, an idle tenant pruned by far-future
    traffic."""
    out, t0, rid = [], 1000.0, 0
    rng = np.random.default_rng(3)

    def terminal(ts, tenant, kind):
        nonlocal rid
        rid += 1
        out.append(_rec("req.submitted", rid, ts, tenant=tenant))
        out.append(_rec("req.first_token", rid, ts + 0.005,
                        ttft_s=float(rng.choice([0.05, 0.3, 0.9]))))
        if kind == "ok":
            out.append(_rec("req.finished", rid, ts + 0.01))
        elif kind == "shed":
            out.append(_rec("req.failed", rid, ts + 0.01, error="EngineOverloaded",
                            retryable=True))
            out.append(_rec("req.failover_hop", rid, ts + 0.02))
            out.append(_rec("req.finished", rid, ts + 0.03))
        elif kind == "cancel":
            out.append(_rec("req.failed", rid, ts + 0.01, error="RequestCancelled",
                            retryable=False))
        elif kind == "infra":
            out.append(_rec("req.failed", rid, ts + 0.01, error="RecoveryFailed",
                            retryable=False))
        else:
            out.append(_rec("req.failed", rid, ts + 0.01, error="DeadlineExceeded",
                            retryable=False))

    for i in range(12):
        terminal(t0 + i * 0.1, "acme", "miss" if i % 4 else "infra")
    for i in range(30):
        terminal(t0 + 70 + i * 0.1, "acme", ["ok", "shed", "cancel"][i % 3])
    for i in range(40):
        terminal(t0 + 80 + i, "beta", "ok")
    for i in range(6):
        terminal(t0 + 121 + i * 0.1, "beta", "miss")
    for i in range(8):
        terminal(t0 + 130 + i * 0.1, "ghost", "miss")
    for i in range(600):
        terminal(t0 + 10_000 + i, "live", "ok" if i % 7 else "miss")
    return out


@pytest.mark.parametrize("ttft_target", [None, 0.2], ids=["burn", "ttft"])
def test_slo_monitor_transitions_equal_jax(ttft_target):
    runs = []
    for mod in (jops, ops):
        fired, edges = [], []
        mon = mod.SLOMonitor(mod.SLOConfig(
            slo=0.9, ttft_target_s=ttft_target, fast_window_s=10, slow_window_s=50,
            burn_threshold=2.0, min_samples=5,
            on_burn=lambda tenant, info: fired.append((tenant, info))))
        mon.add_burn_listener(lambda tenant, burning, info: edges.append(
            (tenant, burning, info)))
        summaries = []
        for i, rec in enumerate(_slo_records()):
            mon._on_record(rec)
            if i % 97 == 0:
                summaries.append((mon.burning(), mon.summary()))
        runs.append((fired, edges, summaries, mon.burning(), mon.summary()))
        mon.close()
    assert runs[1] == runs[0]
    fired = runs[1][0]
    assert fired and fired[0][0] == "acme"
    assert any(not burning for _, burning, _ in runs[1][1])  # a recovery edge
    assert "ghost" not in runs[1][3]  # idle-pruned, no recovery edge
    assert ("ghost", False, None) not in runs[1][1]


def test_slo_monitor_as_listener_and_gauges():
    assert not telemetry.events_enabled()
    mon = ops.SLOMonitor(ops.SLOConfig(min_samples=1)).subscribe()
    try:
        assert telemetry.events_enabled()
        telemetry.event("req.submitted", rid="r1", tenant="t")
        telemetry.event("req.finished", rid="r1")
        assert mon.summary()["t"]["fast"]["n"] == 1
    finally:
        mon.close()
    assert not telemetry.events_enabled()


# ---------------------------------------------------------------------------
# Stall watchdog


def test_watchdog_marks_a_wedged_engine_and_its_tick_restores_ready(model):
    telemetry.configure(collect=True, flight=True)
    eng = Engine(model, device="cpu", ops_port=0, **ENGINE_KW,
                 ops_config=ops.OpsConfig(stall_deadline_s=0.15, watchdog_poll_s=0.02))
    try:
        h = eng.submit(prompt_of(4), max_new_tokens=32, key=0)
        eng.step()  # prefill and a first chunk; then the caller wedges
        assert _wait_for(lambda: eng.health() is Health.OVERLOADED)
        dumps = [r for r in telemetry.snapshot()["spans"] if r.get("type") == "flight_dump"]
        assert dumps and dumps[-1]["reason"] == "stall"
        assert telemetry.counters()["serve.stalls"] >= 1
        assert telemetry.gauges()[f"serve.stalled{{engine={eng.engine_id}}}"] == 1
        eng.step()
        assert eng.health() is Health.READY  # its own tick re-checked
        assert _wait_for(
            lambda: telemetry.gauges()[f"serve.stalled{{engine={eng.engine_id}}}"] == 0)
        assert h.result()
    finally:
        eng.close()
    assert f"serve.stalled{{engine={eng.engine_id}}}" not in telemetry.gauges()


def test_watchdog_quiet_on_an_idle_engine(model):
    eng = Engine(model, device="cpu", ops_port=0, **ENGINE_KW,
                 ops_config=ops.OpsConfig(stall_deadline_s=0.05, watchdog_poll_s=0.01))
    time.sleep(0.2)
    assert eng.health() is Health.STARTING and telemetry.counters().get("serve.stalls", 0) == 0
    eng.close()


# ---------------------------------------------------------------------------
# The endpoints on a live port engine


def test_engine_endpoints_and_teardown(model, tmp_path):
    telemetry.configure(collect=True, flight=True)

    class Stub(timeplane.ProfilerTrigger):
        def _start_profiler(self, path):
            pass

        def _stop_profiler(self):
            pass

    trig = Stub(str(tmp_path), seconds=0.01, cooldown_s=300.0)
    timeplane.set_trigger(trig)
    eng = Engine(model, device="cpu", ops_port=0, ops_config=ops.OpsConfig(watchdog=False),
                 **ENGINE_KW)
    url = eng._ops_plane.server.url
    assert url.startswith("http://127.0.0.1:")
    try:
        code, body = http_get(url + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        hs = [eng.submit(prompt_of(4 + i), max_new_tokens=12, key=i) for i in range(3)]
        eng.step()
        eng.step()
        code, body = http_get(url + "/metrics")
        assert code == 200
        text = body.decode()
        eid = eng.engine_id
        for fam in ("serve_occupancy", "serve_page_util", "serve_goodput",
                    "serve_tick_s_count", "serve_tick_phase_s_bucket",
                    "serve_host_overhead_frac", "ops_scrapes"):
            assert fam in text, fam
        assert f'serve_tick_s_count{{engine="{eid}"}} 2' in text
        code, body = http_get(url + "/requests?limit=2")
        payload = json.loads(body)
        assert code == 200 and payload["limit"] == 2 and len(payload["requests"]) == 2
        assert payload["n_timelines"] == 3
        code, _ = http_get(url + "/requests?limit=0")
        assert code == 400
        code, body = http_get(url + "/profile?seconds=0.05")
        assert code == 200 and json.loads(body)["fired"]
        assert os.path.isdir(json.loads(body)["path"])
        code, body = http_get(url + "/profile")
        assert code == 429 and not json.loads(body)["fired"]
        code, _ = http_get(url + "/nope")
        assert code == 404
        for h in hs:
            assert h.result()
    finally:
        eng.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=2.0)
    assert not any(t.name.startswith(("tdx-ops", "tdx-stall")) and t.is_alive()
                   for t in threading.enumerate())


def test_env_ops_port(model, monkeypatch):
    monkeypatch.setenv("TDX_OPS_PORT", "0")
    assert ops.env_ops_port() == jops.env_ops_port() == 0
    eng = Engine(model, device="cpu", **ENGINE_KW)
    try:
        assert eng._ops_plane is not None
        assert http_get(eng._ops_plane.server.url + "/healthz")[0] == 200
    finally:
        eng.close()
    monkeypatch.setenv("TDX_OPS_PORT", "bogus")
    assert ops.env_ops_port() is None
    monkeypatch.delenv("TDX_OPS_PORT")
    eng = Engine(model, device="cpu", **ENGINE_KW)
    assert eng._ops_plane is None
    eng.close()


def test_two_engines_share_a_plane_until_the_last_unwatches(model):
    e1 = Engine(model, device="cpu", ops_port=0, ops_config=ops.OpsConfig(watchdog=False),
                **ENGINE_KW)
    port = e1._ops_plane.port
    e2 = Engine(model, device="cpu", ops_port=port, **ENGINE_KW)
    url = e1._ops_plane.server.url
    assert e2._ops_plane is e1._ops_plane
    code, body = http_get(url + "/healthz")
    assert code == 200 and len(json.loads(body)["engines"]) == 2
    e1.close()
    code, body = http_get(url + "/healthz")
    payload = json.loads(body)
    assert code == 200 and list(payload["engines"]) == [e2.engine_id]
    e2.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=2.0)


def test_disabled_path_runs_no_attribution(model, monkeypatch):
    def bomb(self, *a, **k):  # pragma: no cover — the point is it never runs
        raise AssertionError("_tick_telemetry ran with the ops plane off")

    monkeypatch.setattr(Engine, "_tick_telemetry", bomb)
    eng = Engine(model, device="cpu", **ENGINE_KW)
    assert eng.submit(prompt_of(4), max_new_tokens=4, key=0).result()
    eng.close()
    assert eng._g_occupancy is None
    eid = eng.engine_id
    assert f"serve.tick_s{{engine={eid}}}" not in telemetry.histograms()
    assert not any(k.startswith("serve.tick_phase_s") for k in telemetry.histograms())
    for g in ("serve.occupancy", "serve.page_util", "serve.goodput", "serve.prefill_budget",
              "serve.churn"):
        assert f"{g}{{engine={eid}}}" not in telemetry.gauges()


def test_bad_audit_sample_leaks_no_plane(model):
    with pytest.raises(ValueError):
        Engine(model, device="cpu", ops_port=0, audit_sample=2.0,
               ops_config=ops.OpsConfig(watchdog=False), **ENGINE_KW)
    assert not ops._PLANES
