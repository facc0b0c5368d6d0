"""The port's compile observatory on the CPU, after ``tests/test_perf_plane.py``.

The port records a compile where it is made: a decode chunk's capture as
one CUDA graph (on the CPU its first eager run), through
``perf.GraphProgram``, and a kernel library's nvcc build.  Held to JAX's
semantics with JAX's thresholds, and where a check has a JAX counterpart
both run the same script: exact counts through a wrapped callable whose
count grows (JAX: a jitted function's cache), a stand-in without a count
passing through, the storm latch (gauge, one ``reason="recompile_storm"``
flight dump naming the engine, the owner marked), its clearing after a
quiet window.  Then the port's own: the decode chunk counted once through
the lifecycle script of ``test_decode_chunk_compiles_exactly_once_through_
lifecycle`` (its geometry, streams equal to ``generate``), one program a
(engine, model tag), and an nvcc build.  Tolerance: none (exact counts).
"""

import json
import os
import time

import jax
import numpy as np
import pytest

from torchdistx_tpu import telemetry as jtelemetry
from torchdistx_tpu.telemetry import perf as jperf
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.deferred_init import deferred_init
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.ops.cuda import _build
from torchdistx_tpu_torch.resilience import preemption
from torchdistx_tpu_torch.serving import Engine, Health, ModelPool
from torchdistx_tpu_torch.telemetry import perf

from _torch_serving_planes import load, prompt_of, solo


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    yield
    preemption.clear()


@pytest.fixture(scope="module")
def model():
    return load("llama")[3]


def _count(tel, name):
    return tel.counters().get(name, 0)


class Captured:
    """A stand-in for a ``DecodeChunk``: its capture count grows the first
    time it sees a geometry, as a jitted function's cache does at a new
    shape."""

    def __init__(self):
        self.n_captures, self.capture_s, self._seen = 0, None, set()

    def __call__(self, x):
        if x not in self._seen:
            self._seen.add(x)
            self.n_captures += 1
            self.capture_s = 0.25
        return x


class Owner:
    def __init__(self, eid):
        self.engine_id, self.marked = eid, 0

    def _mark_stalled(self):
        self.marked += 1


def _jax_caller(label):
    f = jax.jit(lambda x: x + 1)
    jp = jperf.JitProgram(lambda: f, label)
    return lambda owner, n: jp.call(owner, None, jax.numpy.ones((n,)))


def _port_caller(label):
    gp, f = perf.GraphProgram(label), Captured()
    return lambda owner, n: gp.call(f, owner, "tag", n)


def test_graph_program_counts_compiles_exactly_as_jax():
    """One count a new geometry, none on reuse, recompiles past the
    first, the same sequence as JAX's jit cache on the same script."""
    seqs = []
    for tel, label, make in ((jtelemetry, "tdx_obs_exact_j", _jax_caller),
                             (telemetry, "tdx_obs_exact_t", _port_caller)):
        call = make(label)
        c, r = f"compile.count{{program={label}}}", f"compile.recompiles{{program={label}}}"
        base_c, base_r = _count(tel, c), _count(tel, r)
        seq = []
        for n in (2, 2, 3):
            call(None, n)
            seq.append((_count(tel, c) - base_c, _count(tel, r) - base_r))
        seqs.append(seq)
        assert tel.histograms()[f"compile.time_s{{program={label}}}"]["count"] == 2
    assert seqs[1] == seqs[0] == [(1, 0), (1, 0), (2, 1)]
    # The port's time is the capture's own seconds.
    assert telemetry.histograms()["compile.time_s{program=tdx_obs_exact_t}"]["sum"] == 0.5


def test_stand_in_without_a_count_passes_through():
    """A plain function (a test's patched dispatch) is neither
    instrumented nor broken, as under JAX's ``JitProgram``."""
    calls = []

    def stand_in(x):
        calls.append(x)
        return x

    for tel, gp_call, label in (
            (jtelemetry, lambda: jperf.JitProgram(lambda: stand_in, "tdx_obs_plain_j").call(
                None, None, 7), "tdx_obs_plain_j"),
            (telemetry, lambda: perf.GraphProgram("tdx_obs_plain_t").call(
                stand_in, None, "tag", 7), "tdx_obs_plain_t")):
        assert gp_call() == 7
        assert f"compile.count{{program={label}}}" not in tel.counters()
    assert calls == [7, 7]


def test_scopes_nest_and_count_what_compiles_inside():
    with perf.program("materialize") as outer:
        with perf.program("inner") as inner:
            assert perf._current_scope() is inner
            perf.record_compile("tdx_obs_scoped", 0.1)
        assert perf._current_scope() is outer
    assert perf._current_scope() is None
    assert (outer.counted, inner.counted) == (1, 1)
    assert perf.storm_config() == jperf.storm_config()


def test_recompile_storm_latches_dumps_and_marks_owner_as_jax(tmp_path):
    """Five new geometries under threshold 3: both packages latch the
    engine's gauge, dump ``reason="recompile_storm"`` naming the engine
    (the port's with the ledger), and mark the owner once."""
    got = []
    for tel, perf_mod, make, label in ((jtelemetry, jperf, _jax_caller, "tdx_obs_churn_j"),
                                       (telemetry, perf, _port_caller, "tdx_obs_churn_t")):
        flight = str(tmp_path / f"{label}.jsonl")
        prev_cfg = tel.configure(flight=flight)
        prev_storm = perf_mod.storm_config(threshold=3, window_s=60.0)
        owner = Owner(f"storm-{label}")
        try:
            call = make(label)
            for n in range(1, 6):
                call(owner, n)
            gauge = tel.gauges()[f"serve.recompile_storm{{engine={owner.engine_id}}}"]
            dumps = [r for r in map(json.loads, open(flight)) if r.get("type") == "flight_dump"
                     and r.get("reason") == "recompile_storm"]
            got.append((owner.marked, gauge, len(dumps), dumps[0]["attrs"]["engine"]
                        == owner.engine_id, dumps[0]["attrs"]["program"] == label))
            if perf_mod is perf:
                assert "ledger" in dumps[0]["attrs"] and dumps[0]["attrs"]["identity"] == "tag"
                assert _count(telemetry, "serve.recompile_storms") >= 1
        finally:
            perf_mod.storm_config(*prev_storm)
            tel.configure(**prev_cfg)
    assert got[1] == got[0] == (1, 1, 1, True, True)


def test_storm_latch_clears_after_quiet_window_as_jax(tmp_path):
    got = []
    for tel, perf_mod, make, label in ((jtelemetry, jperf, _jax_caller, "tdx_obs_quiet_j"),
                                       (telemetry, perf, _port_caller, "tdx_obs_quiet_t")):
        prev_cfg = tel.configure(flight=str(tmp_path / f"{label}.jsonl"))
        prev_storm = perf_mod.storm_config(threshold=2, window_s=30.0)
        owner = Owner(f"quiet-{label}")
        g = f"serve.recompile_storm{{engine={owner.engine_id}}}"
        try:
            call = make(label)
            for n in range(1, 4):
                call(owner, n)
            latched = tel.gauges()[g]
            perf_mod.storm_config(threshold=2, window_s=0.05)
            time.sleep(0.1)  # a full window without a recompile
            call(owner, 3)  # a warm call: nothing compiles
            got.append((latched, tel.gauges()[g]))
        finally:
            perf_mod.storm_config(*prev_storm)
            tel.configure(**prev_cfg)
    assert got[1] == got[0] == (1, 0)


def test_engine_gauge_clears_only_when_its_last_identity_drains(tmp_path):
    """Two latched identities on one engine: the first to go quiet clears
    its own latch, not the engine's gauge."""
    prev_cfg = telemetry.configure(flight=str(tmp_path / "f.jsonl"))
    prev_storm = perf.storm_config(threshold=2, window_s=30.0)
    owner = Owner("two-ids")
    gp = perf.GraphProgram("tdx_obs_two")
    fns = {"a": Captured(), "b": Captured()}
    try:
        for tag, fn in fns.items():
            for n in range(1, 4):
                gp.call(fn, owner, tag, n)
        assert owner.marked == 2
        perf.storm_config(window_s=0.05)
        time.sleep(0.1)
        gp.call(fns["a"], owner, "a", 3)
        assert telemetry.gauges()["serve.recompile_storm{engine=two-ids}"] == 1
        gp.call(fns["b"], owner, "b", 3)
        assert telemetry.gauges()["serve.recompile_storm{engine=two-ids}"] == 0
    finally:
        perf.storm_config(*prev_storm)
        telemetry.configure(**prev_cfg)


def test_decode_chunk_counts_exactly_once_through_lifecycle(model):
    """JAX's lifecycle script and geometry on the port's engine: admission,
    chunked prefill, slot recycling and a replay preemption, with the
    prefix cache on.  One decode-chunk compile, no recompile (the registry
    is the process's: a row other tests' engines made does not move),
    streams equal to ``generate``."""
    eng = Engine(model, device="cpu", scheduler="qos", num_slots=3, block_size=8,
                 max_model_len=64, decode_chunk=5, prefill_chunk=4, min_prefill_bucket=4,
                 preempt_mechanism="replay", handle_preemption=False)
    assert eng.prefix is not None
    name = "compile.count{program=decode_chunk}"
    base = _count(telemetry, name)
    recompiles = _count(telemetry, "compile.recompiles{program=decode_chunk}")
    p0 = np.arange(1, 13, dtype=np.int32)
    h0 = eng.submit(p0, max_new_tokens=8, key=0, priority=0)
    h1 = eng.submit(np.arange(2, 8, dtype=np.int32), max_new_tokens=6, key=1, priority=0)
    eng.drain()
    victims = [eng.submit(np.arange(3, 9, dtype=np.int32), max_new_tokens=20, key=10 + i,
                          priority=0) for i in range(3)]
    eng.step()
    urgent = eng.submit(np.arange(4, 10, dtype=np.int32), max_new_tokens=6, key=99, priority=5)
    eng.drain()
    assert eng.stats()["preemptions_replay"] >= 1
    assert h0.result() == solo(model, p0, 0, 8)
    assert h1.result() == solo(model, np.arange(2, 8), 1, 6)
    assert urgent.result() == solo(model, np.arange(4, 10), 99, 6)
    for i, v in enumerate(victims):
        assert v.result() == solo(model, np.arange(3, 9), 10 + i, 20)
    assert _count(telemetry, name) - base == 1
    assert _count(telemetry, "compile.recompiles{program=decode_chunk}") == recompiles
    assert eng.decoder().n_captures == 1 and eng.decoder().capture_s > 0
    assert eng.allocator.num_in_use == len(eng.prefix)
    eng.close()


def _pool_engine(model, max_resident):
    pool = ModelPool(max_resident=max_resident)
    for tag, seed in (("tuna", 1), ("bass", 2)):
        pool.register(tag, module=deferred_init(tllama.Llama, tllama.llama_test(),
                                                device_="cuda"), seed=seed)
    return Engine(model, device="cpu", model_pool=pool, num_slots=2, block_size=8,
                  max_model_len=64, decode_chunk=4, handle_preemption=False)


@pytest.mark.parametrize("max_resident, tags, counts, recompiles", [
    (2, ("tuna", "bass", "tuna", "bass"), 2, 0),
    (1, ("tuna", "bass", "tuna"), 3, 1),
], ids=["two_resident", "evicted_and_back"])
def test_one_program_a_model_tag(model, max_resident, tags, counts, recompiles):
    """A graph holds one model's weights by address, so each resident tag
    is its own program (JAX shares one compile across tags, a designed
    difference); a tag evicted and brought back captures again, one
    recompile of its identity."""
    eng = _pool_engine(model, max_resident)
    c0 = _count(telemetry, "compile.count{program=decode_chunk}")
    r0 = _count(telemetry, "compile.recompiles{program=decode_chunk}")
    for i, tag in enumerate(tags):
        eng.submit(prompt_of(6, base=i + 1), max_new_tokens=5, key=i, model=tag).result()
    assert _count(telemetry, "compile.count{program=decode_chunk}") - c0 == counts
    assert _count(telemetry, "compile.recompiles{program=decode_chunk}") - r0 == recompiles
    assert eng.health() is Health.READY
    eng.close()


def test_nvcc_build_and_load_are_recorded(tmp_path, monkeypatch):
    """A build (nvcc stubbed by a script that writes the library) counts
    under ``kernel:<name>`` timed by its process; loading the library it
    built counts nothing more; a library found fresh on disk by a later
    process counts once as a program load."""
    src, out = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    (src / "tdx_obs_k.cu").write_text("// stub\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'sleep 0.2\n: > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_built", set())
    loads = []
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loads.append(path) or object())
    monkeypatch.setattr(_build, "_libs", {})
    c = "compile.count{program=kernel:tdx_obs_k}"
    base = _count(telemetry, c)
    assert _build.build(["tdx_obs_k"]) == ["tdx_obs_k"]
    assert os.path.exists(out / "libtdx_obs_k.so")
    assert _count(telemetry, c) - base == 1
    assert telemetry.histograms()["compile.time_s{program=kernel:tdx_obs_k}"]["sum"] >= 0.2
    _build.load("tdx_obs_k")
    assert _count(telemetry, c) - base == 1 and len(loads) == 1
    monkeypatch.setattr(_build, "_built", set())  # a later process: the library is fresh
    monkeypatch.setattr(_build, "_libs", {})
    _build.load("tdx_obs_k")
    assert _count(telemetry, c) - base == 2 and len(loads) == 2
    assert "compile.recompiles{program=kernel:tdx_obs_k}" not in telemetry.counters()
