"""The port's telemetry core against the JAX package's, on the same call
sequence: counters, labeled gauges and counters, histogram percentiles,
nested and traced spans, events, ``emit_counters`` and a flight dump give
equal ``snapshot()`` values and equal JSONL records, with timestamps,
durations and thread ids left aside.  Exact: this is bookkeeping.

The port's one departure, the ``torch.profiler`` pass-through that takes
the place of ``jax.profiler``, is checked on its own.
"""

import json

import pytest
import torch

from torchdistx_tpu import telemetry as jtel
from torchdistx_tpu_torch import telemetry as ttel

PREFIX = "parity."
VOLATILE = ("ts", "dur_s", "thread")


@pytest.fixture(autouse=True)
def _clean():
    for tel in (jtel, ttel):
        tel.reset()
    yield
    for tel in (jtel, ttel):
        tel.reset()


def _drive(tel, tmp_path):
    """One call sequence; returns (snapshot, JSONL records, flight records)."""
    tmp_path.mkdir()
    jsonl, flight = tmp_path / "trace.jsonl", tmp_path / "flight.jsonl"
    prev = tel.configure(jsonl=str(jsonl), collect=True, flight=str(flight))
    try:
        tel.counter("parity.calls").add()
        tel.counter("parity.calls").add(4)
        tel.counter("parity.shed", engine="e0").add(2)
        tel.gauge("parity.health", engine="e0").set("ready")
        tel.gauge("parity.health", engine="e,1=x").set(0.5)  # escaped label value
        lat = tel.histogram("parity.lat_s")
        for v in (0.001, 0.002, 0.5, 3.0, 0.02, 0.0001, 150.0, 0.002):
            lat.observe(v)
        tel.histogram("parity.size", bounds=(1, 10, 100), engine="e0").observe(42, n=3)
        with tel.span("parity.outer", step=1):
            with tel.span("parity.inner", n=2):
                tel.event("parity.evt", rid="r1", x=1)
            with tel.tracing(rid="r2", engine="e0", hop=1):
                with tel.span("parity.traced"):
                    pass
                tel.event("parity.evt2", why="because")
        sp = tel.start_span("parity.manual", a=1)
        sp.end(extra=True)
        tel.start_span("parity.cancelled").cancel()
        tel.emit_counters()
        snap = tel.snapshot()
        percentiles = [lat.percentile(p) for p in (50, 95, 99)]
        n_dumped = tel.flight_dump("parity", reason_code=7)
    finally:
        tel.configure(**prev)
    with open(jsonl) as f:
        records = [json.loads(line) for line in f]
    with open(flight) as f:
        flight_records = [json.loads(line) for line in f]
    return snap, records, flight_records, percentiles, n_dumped


def _ours(d):
    return {k: v for k, v in d.items() if k.startswith(PREFIX)}


def _strip(rec):
    """A record without its timestamps, durations and thread id, and with
    only this test's metrics in a counters line."""
    rec = {k: v for k, v in rec.items() if k not in VOLATILE}
    for key in ("values", "gauges", "histograms"):
        if rec.get("type") == "counters" and key in rec:
            rec[key] = _ours(rec[key])
    return rec


def _relevant(records):
    return [_strip(r) for r in records
            if r.get("type") in ("counters", "flight_dump")
            or str(r.get("name", "")).startswith(PREFIX)]


def test_same_calls_give_the_same_snapshot_and_records(tmp_path):
    got = _drive(ttel, tmp_path / "port")
    want = _drive(jtel, tmp_path / "jax")
    (t_snap, t_rec, t_flight, t_pct, t_n), (j_snap, j_rec, j_flight, j_pct, j_n) = got, want
    for key in ("counters", "gauges", "histograms"):
        assert _ours(t_snap[key]) == _ours(j_snap[key]), key
    assert _ours(t_snap["counters"]) == {
        "parity.calls": 5, "parity.shed{engine=e0}": 2}
    assert "parity.health{engine=e%2C1%3Dx}" in t_snap["gauges"]
    assert [_strip(r) for r in t_snap["spans"]] == [_strip(r) for r in j_snap["spans"]]
    assert _relevant(t_rec) == _relevant(j_rec)
    assert len(_relevant(t_rec)) == 7  # 4 spans, 2 events and the counters line
    assert t_pct == j_pct and t_n == j_n > 0
    assert [_strip(r) for r in t_flight] == [_strip(r) for r in j_flight]
    # The nesting itself: inner under outer at depth 1, the traced span
    # carries the trace context.
    spans = {r["name"]: r for r in t_snap["spans"] if r["type"] == "span"}
    assert spans["parity.inner"]["parent"] == "parity.outer"
    assert spans["parity.inner"]["depth"] == 1
    assert spans["parity.traced"]["rid"] == "r2" and spans["parity.traced"]["hop"] == 1
    assert "parity.cancelled" not in spans


def test_configure_returns_previous_settings_like_the_reference():
    t_prev, j_prev = ttel.configure(collect=True), jtel.configure(collect=True)
    try:
        renamed = {"jax_annotations": "profiler_annotations"}
        assert t_prev == {renamed.get(k, k): v for k, v in j_prev.items()}
    finally:
        ttel.configure(**t_prev)
        jtel.configure(**j_prev)


def test_profiler_annotations_show_spans_in_torch_profiler():
    from torch.profiler import ProfilerActivity, profile

    prev = ttel.configure(profiler_annotations=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with ttel.span("train.step", step=3):
                torch.ones(4).sum()
    finally:
        ttel.configure(**prev)
    assert any(ev.name == "train.step" for ev in prof.events())


def test_profiler_annotations_off_enter_nothing():
    prev = ttel.configure(profiler_annotations=False)
    try:
        sp = ttel.start_span("parity.quiet", step=1)
        assert sp._annotation is None
        sp.end()
    finally:
        ttel.configure(**prev)


def test_profiler_switch_from_the_environment(monkeypatch):
    monkeypatch.setenv("TDX_TELEMETRY_PROFILER", "1")
    state = ttel._core._State()
    state.ensure_init()
    assert state.profiler_annotations is True
