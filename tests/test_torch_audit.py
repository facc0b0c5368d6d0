"""The port's shadow auditor on the CPU, after ``tests/test_audit.py``.

The JAX engine and the port's engine run the same requests on the same
``llama_test`` weights (f32, carried from JAX), both with
``audit_sample``: the port samples the same requests (the digest's leading
32 bits; greedy digests are equal), checks as many, finds no divergence on
clean traffic, and a ``serve.step:k:corrupt`` fault is caught as exactly
one divergence at the same token and chunk as JAX's.  The latch holds
OVERLOADED until ``clear_divergence``; ``max_pending`` drops as JAX's;
audits admit only on quiet ticks (the same slot trace as JAX, tick by
tick); ``drain()`` waits out audits; a replay killed by ``close`` counts as
aborted; ``TDX_AUDIT_SAMPLE`` switches it on.  Tolerance: none (exact).
"""

import numpy as np
import pytest

from torchdistx_tpu.resilience import faults as jfaults
from torchdistx_tpu.telemetry import audit as jaudit
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.resilience import faults, preemption
from torchdistx_tpu_torch.serving import Engine, Health
from torchdistx_tpu_torch.telemetry import audit

from _torch_serving_planes import SAMPLED, engines, load, prompt_of, run_script, solo

EOS = 5
ENGINE_KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4)
N_REQUESTS = 6


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    faults.reset("")
    jfaults.reset("")
    yield
    preemption.clear()
    faults.reset("")
    jfaults.reset("")


@pytest.fixture(scope="module")
def fam():
    return load("llama")


def traffic(n=N_REQUESTS):
    rng = np.random.default_rng(7)
    return [dict(prompt=prompt_of(int(rng.integers(3, 12)), base=int(rng.integers(1, 40))),
                 max_new_tokens=int(rng.integers(4, 10)), key=100 + i) for i in range(n)]


def port_engine(fam, **kw):
    return Engine(fam[3], device="cpu", handle_preemption=False, **{**ENGINE_KW, **kw})


def test_env_audit_sample_and_token_chunk(fam, monkeypatch):
    assert audit.env_audit_sample() is None
    for text in ("0", "0.25", "1.0"):
        monkeypatch.setenv("TDX_AUDIT_SAMPLE", text)
        assert audit.env_audit_sample() == jaudit.env_audit_sample() == float(text)
    monkeypatch.setenv("TDX_AUDIT_SAMPLE", "1.0")
    eng = port_engine(fam)
    assert eng._auditor is not None and eng._auditor.sample == 1.0
    eng.close()
    for bad in ("nope", "1.5"):
        monkeypatch.setenv("TDX_AUDIT_SAMPLE", bad)
        with pytest.raises(ValueError):
            audit.env_audit_sample()
        with pytest.raises(ValueError):
            port_engine(fam)
    monkeypatch.delenv("TDX_AUDIT_SAMPLE")
    eng = port_engine(fam, audit_sample=0.0)
    assert eng._auditor is None and eng.audit_backlog() == 0
    eng.close()
    with pytest.raises(ValueError):
        port_engine(fam, audit_sample=1.5)
    for i in range(0, 14):
        assert audit.token_chunk(i, 4) == jaudit.token_chunk(i, 4)
    assert audit.AUDIT_PRIORITY == jaudit.AUDIT_PRIORITY


@pytest.mark.parametrize("sample", [0.25, 0.5, 1.0])
def test_sampled_set_and_checks_equal_jax(fam, sample):
    """Greedy: the same requests are sampled and checked as on the JAX
    engine, with no divergence; the streams are JAX's."""
    jeng, teng = engines(fam, audit_sample=sample, eos_id=EOS, **ENGINE_KW)
    out = []
    for eng in (jeng, teng):
        hs = [eng.submit(**r) for r in traffic()]
        eng.drain()
        assert eng.audit_backlog() == 0
        picked = {i for i, h in enumerate(hs) if eng._auditor._sampled(h._req)}
        out.append(([h.result() for h in hs], picked, eng.stats()))
        eng.close()
    (jstreams, jpicked, jst), (tstreams, tpicked, tst) = out
    assert tstreams == jstreams
    assert tpicked == jpicked
    if sample == 1.0:
        assert len(tpicked) == N_REQUESTS
    assert tst["audit_checked"] == jst["audit_checked"] == len(tpicked)
    assert tst["audit_divergences"] == jst["audit_divergences"] == 0


def test_clean_sampled_traffic_has_no_divergence(fam):
    """Sampled with top-k, every replay reproduces its stream: 0
    divergences, every request checked, streams equal solo generate."""
    eng = port_engine(fam, audit_sample=1.0, eos_id=EOS, **SAMPLED)
    hs = [eng.submit(**r) for r in traffic(4)]
    eng.drain()
    st = eng.stats()
    assert st["audit_checked"] == 4 and st["audit_divergences"] == 0
    assert eng.health() is Health.READY
    for r, h in zip(traffic(4), hs):
        assert h.result() == solo(fam[3], r["prompt"], r["key"], r["max_new_tokens"],
                                  eos=EOS, **SAMPLED)
    eng.close()


def test_corrupt_fault_is_one_divergence_at_jax_token_and_chunk(fam):
    """``serve.step:4:corrupt`` flips one committed token: exactly that
    stream diverges, at the same token and chunk as on JAX; the latch
    reads OVERLOADED until ``clear_divergence``."""
    jeng, teng = engines(fam, audit_sample=1.0, max_prefills_per_tick=2, **ENGINE_KW)
    details = []
    for eng, fmod in ((jeng, jfaults), (teng, faults)):
        fmod.reset("serve.step:4:corrupt")
        hs = [eng.submit(prompt_of(5), max_new_tokens=16, key=200 + i) for i in range(3)]
        eng.drain()
        fmod.reset("")
        st = eng.stats()
        assert st["audit_checked"] == 3 and st["audit_divergences"] == 1
        d = eng._auditor.divergence_detail[0]
        details.append((d["first_diverging_token"], d["first_diverging_chunk"],
                        d["expected_tokens"], d["replayed_tokens"]))
        assert d["rid"] == (hs[0]._req.trace_id or f"{eng.engine_id}-r0")
        if eng is teng:
            assert eng.health() is Health.OVERLOADED and st["diverging"] is True
            eid = eng.engine_id
            assert telemetry.gauges()[f"serve.diverging{{engine={eid}}}"] == 1
            eng.step()
            assert eng.health() is Health.OVERLOADED
            eng.clear_divergence()
            eng.step()
            assert eng.health() is Health.READY
            truth = solo(fam[3], prompt_of(5), 200, 16)
            got = hs[0].result()
            assert [i for i, (a, b) in enumerate(zip(truth, got)) if a != b] == [d[
                "first_diverging_token"]]
            for i, h in enumerate(hs[1:], start=1):
                assert h.result() == solo(fam[3], prompt_of(5), 200 + i, 16)
        eng.close()
    assert details[1] == details[0]
    assert details[1][1] == audit.token_chunk(details[1][0], 4)


def test_max_pending_drops_equal_jax(fam):
    """Six requests behind two slots with a pending bound of 2: finished
    requests sampled while user work waits overflow the queue; the drops
    and checks equal JAX's."""
    jeng, teng = engines(fam, audit_sample=1.0, **ENGINE_KW)
    got = []
    for eng in (jeng, teng):
        eng._auditor.max_pending = 2
        for r in traffic(6):
            eng.submit(**r)
        eng.drain()
        st = eng.stats()
        got.append((st["audit_dropped"], st["audit_checked"], st["audit_divergences"]))
        eng.close()
    assert got[1] == got[0]
    assert got[1][0] > 0 and got[1][0] + got[1][1] == 6


def test_audits_admit_on_the_same_ticks_as_jax(fam):
    """Two requests finish and are sampled; three user requests arrive
    while their audits are pending.  The pump submits an audit only on a
    tick with no user work waiting, so the slot trace, tick by tick, and
    every request's slot (audit replays included) equal JAX's, with
    auditing on and off."""
    first = traffic(2)
    late = [dict(r, key=r["key"] + 50) for r in traffic(3)]
    script = ([("submit", r) for r in first] + [("step",)] * 6
              + [("submit", r) for r in late])
    for sample in (1.0, None):
        jeng, teng = engines(fam, audit_sample=sample, **ENGINE_KW)
        traces = []
        for eng in (jeng, teng):
            hs, trace = run_script(eng, script)
            eng.drain()
            traces.append([slots for _, slots in trace])
            if sample:
                assert eng.stats()["audit_checked"] == 5
            eng.close()
        assert traces[1] == traces[0]


def test_drain_waits_out_audits_and_close_aborts_one(fam):
    eng = port_engine(fam, audit_sample=1.0)
    h = eng.submit(prompt_of(6), max_new_tokens=8, key=1)
    h.result()
    assert eng.audit_backlog() == 1
    eng.drain()
    assert eng.audit_backlog() == 0 and eng.stats()["audit_checked"] == 1
    # A replay in flight when the engine closes fails typed and counts as
    # aborted, never as checked or diverged.
    h = eng.submit(prompt_of(6, base=3), max_new_tokens=12, key=2)
    h.result()
    while not eng._auditor._inflight:
        eng.step()
    before = telemetry.counter("audit.aborted").value
    eng.close()
    st = eng.stats()
    assert st["audit_aborted"] == 1 and st["audit_checked"] == 1
    assert st["audit_divergences"] == 0
    assert telemetry.counter("audit.aborted").value == before + 1
