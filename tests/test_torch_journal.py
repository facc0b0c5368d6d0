"""The port's request journal against JAX's on the CPU, after
``tests/test_journal.py``.

WAL mechanics (round trip, a torn tail at every byte offset, a corrupt
byte, fsync degrading to async, claims, rotation) hold as in JAX; the
port's segments read through JAX's ``read_records`` / ``fold_records``,
and JAX's through the port's, to equal entries (the bytes on disk are one
format).  Engine integration: an in-process resume is token-identical to
the uninterrupted run; a journal written by the JAX engine (greedy,
``llama_test``) resumes on the port's engine token-identical to JAX's
uninterrupted streams, digests included; a geometry mismatch is refused
before the claim; an expired deadline fails typed; resume re-materializes
an evicted pool model; and a real process killed by SIGKILL
(``_torch_serving_crash_child.py``) resumes in a fresh engine with nothing
twice and nothing lost.  Tolerance: none (exact).
"""

import json
import os
import signal
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from torchdistx_tpu.serving import Engine as JaxEngine
from torchdistx_tpu.serving import RequestJournal as JaxJournal
from torchdistx_tpu.serving import journal as jjournal
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.deferred_init import deferred_init
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.resilience import faults, preemption
from torchdistx_tpu_torch.serving import (
    DeadlineExceeded,
    Engine,
    JournalOwned,
    ModelPool,
    RequestJournal,
)
from torchdistx_tpu_torch.serving import journal as journal_mod
from torchdistx_tpu_torch.serving.journal import fold_records, read_records, read_segment

import _torch_serving_crash_child as child
from _torch_serving_planes import load

ENGINE_KW = dict(num_slots=4, block_size=8, num_blocks=41, max_model_len=64, decode_chunk=4,
                 max_prefills_per_tick=4, handle_preemption=False)
CHILD = os.path.join(os.path.dirname(__file__), "_torch_serving_crash_child.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    faults.reset("")
    yield
    preemption.clear()
    faults.reset("")


@pytest.fixture(scope="module")
def fam():
    return load("llama")


def _prompts(vocab, n=3, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=6).astype(np.int32) for _ in range(n)]


def _simulate_kill9(eng):
    """In-process stand-in for a hard kill (the real one is the last
    test): the engine forgets its journal unclosed and the lock drops."""
    j = eng._journal
    eng._journal = None
    j.release()
    eng.close()


# ---------------------------------------------------------------------------
# WAL mechanics


def test_wal_roundtrip_and_fold(tmp_path):
    d = str(tmp_path / "j")
    j = RequestJournal(d, fsync="always")
    j.claim("eng-a")
    j.write_config(engine="eng-a", decode_chunk=4, model_version="v0")
    j.append({"t": "admit", "u": 1, "prompt": [1, 2], "key": [0, 7], "max_new": 8,
              "model": "default", "version": "v0"})
    j.append({"t": "commit", "u": 1, "toks": [5, 6], "n": 2, "d": "ab"})
    j.append({"t": "admit", "u": 2, "prompt": [3], "key": [0, 1], "max_new": 4})
    j.append({"t": "retire", "u": 2, "outcome": "cancelled"})
    assert j.stats()["live"] == 1
    j.close()
    entries, config = fold_records(read_records(d))
    assert config["engine"] == "eng-a"
    assert entries[1].prompt == [1, 2] and entries[1].tokens == [5, 6]
    assert entries[1].digest == "ab" and not entries[1].retired
    assert entries[2].retired and entries[2].outcome == "cancelled"
    j2 = RequestJournal(d)
    unfinished, _ = j2.recover()
    assert set(unfinished) == {1} and j2.next_uid() == 3
    j2.claim("eng-b")
    j2.write_config(engine="eng-b", decode_chunk=4)
    j2.close()
    assert RequestJournal(d).peek_config()["engine"] == "eng-b"


def test_torn_tail_at_every_byte_offset(tmp_path):
    d = str(tmp_path / "j")
    j = RequestJournal(d, fsync="always")
    j.claim("eng")
    recs = [{"t": "admit", "u": i, "prompt": [i] * 4, "key": [0, i], "max_new": 8}
            for i in range(1, 5)]
    for r in recs:
        j.append(r)
    j.close()
    seg = journal_mod._segments(d)[0]
    with open(seg, "rb") as f:
        data = f.read()
    bounds, off = [0], 0
    while off < len(data):
        (length,) = struct.unpack_from("<I", data, off)
        off += 8 + length
        bounds.append(off)
    scratch = str(tmp_path / "trunc.wal")
    for cut in range(len(data) + 1):
        with open(scratch, "wb") as f:
            f.write(data[:cut])
        got, torn = read_segment(scratch)
        n_intact = sum(1 for b in bounds[1:] if b <= cut)
        assert [r["u"] for r in got] == [r["u"] for r in recs[:n_intact]]
        assert torn == (cut not in bounds)
        # JAX's reader agrees at every offset.
        assert jjournal.read_segment(scratch) == (got, torn)


def test_corrupt_byte_stops_reader_cleanly(tmp_path):
    d = str(tmp_path / "j")
    j = RequestJournal(d, fsync="always")
    j.claim("eng")
    for i in range(1, 4):
        j.append({"t": "admit", "u": i, "prompt": [i], "key": [0, i], "max_new": 8})
    j.close()
    seg = journal_mod._segments(d)[0]
    with open(seg, "rb") as f:
        data = bytearray(f.read())
    (len0,) = struct.unpack_from("<I", data, 0)
    data[8 + len0 + 8 + 2] ^= 0xFF
    with open(seg, "wb") as f:
        f.write(bytes(data))
    got, torn = read_segment(seg)
    assert [r["u"] for r in got] == [1] and torn


def test_fsync_io_fault_degrades_to_async(tmp_path):
    d = str(tmp_path / "j")
    j = RequestJournal(d, fsync="tick")
    j.claim("eng")
    degraded = telemetry.counter("journal.fsync_degraded")
    before = degraded.value
    j.append({"t": "admit", "u": 1, "prompt": [1], "key": [0, 0], "max_new": 2})
    faults.reset("journal.fsync:1:io")
    j.sync()
    assert j.degraded and j.stats()["degraded"] and degraded.value == before + 1
    j.append({"t": "commit", "u": 1, "toks": [9], "n": 1, "d": "cc"})
    j.sync()
    j.close()
    assert fold_records(read_records(d))[0][1].tokens == [9]


def test_double_claim_and_stale_steal(tmp_path):
    d = str(tmp_path / "j")
    j1 = RequestJournal(d)
    j1.claim("eng-a")
    with pytest.raises(JournalOwned):
        RequestJournal(d).claim("eng-b")
    j1.close()
    j2 = RequestJournal(d)
    j2.claim("eng-b")
    j2.close()
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    with open(os.path.join(d, journal_mod._LOCK_NAME), "w") as f:
        json.dump({"owner": "ghost", "pid": p.pid}, f)
    j3 = RequestJournal(d)
    j3.claim("eng-c")  # the dead pid's lock is stale: stolen, not refused
    j3.close()


def test_rotation_compacts_retired_keeps_live(tmp_path):
    d = str(tmp_path / "j")
    j = RequestJournal(d, fsync="async", rotate_bytes=4096)
    j.claim("eng")
    j.write_config(engine="eng", decode_chunk=4)
    j.append({"t": "admit", "u": 1, "prompt": [1, 2, 3], "key": [0, 1], "max_new": 64})
    j.append({"t": "commit", "u": 1, "toks": [7, 8], "n": 2, "d": "aa"})
    u = 2
    while j.stats()["segments_compacted"] == 0:
        j.append({"t": "admit", "u": u, "prompt": [0] * 30, "key": [0, u], "max_new": 8})
        j.append({"t": "retire", "u": u, "outcome": "finished", "n": 0})
        u += 1
        assert u < 500, "rotation never triggered"
    j.close()
    assert len(journal_mod._segments(d)) == 1
    entries, config = fold_records(read_records(d))
    assert config["engine"] == "eng"
    assert {uu for uu, e in entries.items() if not e.retired} == {1}
    assert entries[1].tokens == [7, 8] and entries[1].digest == "aa"


def _write_mixed(j):
    j.claim("eng")
    j.write_config(engine="eng", temperature=0.0, top_k=None, eos_id=5, decode_chunk=4,
                   model_version="v0")
    for u in range(1, 6):
        j.append({"t": "admit", "u": u, "prompt": [u, u + 1], "key": [0, u], "max_new": 9,
                  "model": "default", "version": "v0", "tenant": "t", "priority": u % 2,
                  "deadline": None, "trace": None})
        j.append({"t": "commit", "u": u, "toks": [u] * u, "n": u, "d": f"d{u}"})
    j.append({"t": "retire", "u": 2, "outcome": "finished", "n": 2, "toks": [4], "d": "x"})
    j.append({"t": "admit", "u": 6, "prompt": [1], "key": [3, 4], "max_new": 2,
              "tokens": [8, 9], "d": "h"})
    j.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segments_read_across_packages(tmp_path, writer):
    """One package's segments, the other's reader: equal records, equal
    folded entries, and the same bytes for the same appends."""
    d = str(tmp_path / writer)
    _write_mixed(RequestJournal(d) if writer == "port" else JaxJournal(d))
    recs_port, recs_jax = list(read_records(d)), list(jjournal.read_records(d))
    assert recs_port == recs_jax and len(recs_port) == 13
    ours, cfg_o = fold_records(recs_port)
    theirs, cfg_j = jjournal.fold_records(recs_jax)
    assert cfg_o == cfg_j
    assert {u: vars(e) for u, e in ours.items()} == {u: vars(e) for u, e in theirs.items()}
    other = str(tmp_path / "other")
    _write_mixed(JaxJournal(other) if writer == "port" else RequestJournal(other))
    seg = lambda p: open(journal_mod._segments(p)[0], "rb").read()  # noqa: E731
    assert seg(d) == seg(other)


# ---------------------------------------------------------------------------
# Engine integration


def test_resume_in_process_token_identical(tmp_path, fam):
    model = fam[3]
    ps = _prompts(model.cfg.vocab_size)
    eng = Engine(model, device="cpu", **ENGINE_KW)
    ref = [eng.submit(p, max_new_tokens=24, key=i).result() for i, p in enumerate(ps)]
    eng.close()
    d = str(tmp_path / "j")
    eng1 = Engine(model, device="cpu", journal=RequestJournal(d), **ENGINE_KW)
    hs = [eng1.submit(p, max_new_tokens=24, key=i) for i, p in enumerate(ps)]
    for _ in range(3):
        eng1.step()
    assert all(0 < len(h._tokens) < 24 for h in hs)
    _simulate_kill9(eng1)
    resumed = telemetry.counter("journal.resumed")
    before = resumed.value
    eng2 = Engine(model, device="cpu", **ENGINE_KW)
    handles = eng2.resume_from_journal(RequestJournal(d))
    assert sorted(handles) == [1, 2, 3]
    assert [handles[u].result() for u in sorted(handles)] == ref
    assert eng2.stats()["journal"]["live"] == 0 and resumed.value == before + 3
    eng2.close()


def test_jax_journal_resumes_on_the_port(tmp_path, fam):
    """The JAX engine journals four greedy streams and dies mid-decode; the
    port's engine resumes the journal: every stream equals JAX's
    uninterrupted one, token for token and digest for digest."""
    jmod, cfg, params, model = fam
    ps = _prompts(cfg.vocab_size, n=4, seed=11)
    ref_eng = JaxEngine(params, model=jmod, cfg=cfg, **ENGINE_KW)
    ref_h = [ref_eng.submit(p, max_new_tokens=24, key=i) for i, p in enumerate(ps)]
    ref = [h.result() for h in ref_h]
    ref_digests = [h.digest for h in ref_h]
    ref_eng.close()
    d = str(tmp_path / "j")
    jeng = JaxEngine(params, model=jmod, cfg=cfg, journal=JaxJournal(d), **ENGINE_KW)
    hs = [jeng.submit(p, max_new_tokens=24, key=i) for i, p in enumerate(ps)]
    for _ in range(3):
        jeng.step()
    assert all(0 < len(h._tokens) < 24 for h in hs)
    _simulate_kill9(jeng)
    eng = Engine(model, device="cpu", **ENGINE_KW)
    handles = eng.resume_from_journal(RequestJournal(d))
    assert sorted(handles) == [1, 2, 3, 4]
    assert [handles[u].result() for u in sorted(handles)] == ref
    assert [handles[u].digest for u in sorted(handles)] == ref_digests
    eng.close()
    # The port's retirements landed in JAX's format: JAX folds them.
    entries, _ = jjournal.fold_records(jjournal.read_records(d))
    assert all(e.retired and e.outcome == "finished" for e in entries.values())
    assert [entries[u].tokens for u in sorted(entries)] == ref


def test_geometry_mismatch_refused_before_claim(tmp_path, fam):
    model = fam[3]
    d = str(tmp_path / "j")
    eng1 = Engine(model, device="cpu", journal=RequestJournal(d), **ENGINE_KW)
    eng1.submit(_prompts(model.cfg.vocab_size)[0], max_new_tokens=24, key=0)
    for _ in range(3):
        eng1.step()
    _simulate_kill9(eng1)
    eng2 = Engine(model, device="cpu", **dict(ENGINE_KW, decode_chunk=8))
    with pytest.raises(ValueError, match="journal"):
        eng2.resume_from_journal(RequestJournal(d))
    eng2.close()
    assert not os.path.exists(os.path.join(d, journal_mod._LOCK_NAME))
    eng3 = Engine(model, device="cpu", **ENGINE_KW)
    handles = eng3.resume_from_journal(RequestJournal(d))
    assert sorted(handles) == [1]
    handles[1].result()
    with pytest.raises(JournalOwned):  # eng3 holds it: a second resume is refused
        Engine(model, device="cpu", **ENGINE_KW).resume_from_journal(RequestJournal(d))
    eng3.close()


def test_resume_expired_deadline_fails_typed(tmp_path, fam):
    model = fam[3]
    d = str(tmp_path / "j")
    j = RequestJournal(d, fsync="always")
    j.claim("dead-engine")
    j.append({"t": "admit", "u": 1, "prompt": [int(x) for x in _prompts(256)[0]],
              "key": [0, 0], "max_new": 8, "deadline": time.time() - 5.0})
    j.close()
    expired = telemetry.counter("journal.resume_expired")
    before = expired.value
    eng = Engine(model, device="cpu", **ENGINE_KW)
    handles = eng.resume_from_journal(RequestJournal(d))
    with pytest.raises(DeadlineExceeded):
        handles[1].result()
    eng.close()
    assert expired.value == before + 1


def test_resume_rematerializes_evicted_model(tmp_path, fam):
    model = fam[3]
    p = _prompts(model.cfg.vocab_size)[0]

    def pool():
        mp = ModelPool()
        mp.register("tuna", module=deferred_init(tllama.Llama, tllama.llama_test(),
                                                 device_="cuda"), seed=1)
        return mp

    eng = Engine(model, device="cpu", model_pool=pool(), **ENGINE_KW)
    ref = eng.submit(p, max_new_tokens=24, key=0, model="tuna").result()
    eng.close()
    d = str(tmp_path / "j")
    eng1 = Engine(model, device="cpu", model_pool=pool(), journal=RequestJournal(d),
                  **ENGINE_KW)
    h = eng1.submit(p, max_new_tokens=24, key=0, model="tuna")
    for _ in range(4):
        eng1.step()
    assert 0 < len(h._tokens) < 24
    _simulate_kill9(eng1)
    pool2 = pool()  # a fresh process: tuna registered but cold
    eng2 = Engine(model, device="cpu", model_pool=pool2, **ENGINE_KW)
    handles = eng2.resume_from_journal(RequestJournal(d))
    assert handles[1].result() == ref
    assert pool2.stats()["models"]["tuna"]["materializations"] == 1
    eng2.close()
    unreg = Engine(model, device="cpu", **ENGINE_KW)  # no pool: the stream fails typed
    d2 = str(tmp_path / "j2")
    eng3 = Engine(model, device="cpu", model_pool=pool(), journal=RequestJournal(d2),
                  **ENGINE_KW)
    eng3.submit(p, max_new_tokens=24, key=0, model="tuna")
    eng3.step()
    _simulate_kill9(eng3)
    handles = unreg.resume_from_journal(RequestJournal(d2))
    with pytest.raises(Exception, match="does not register"):
        handles[1].result()
    unreg.close()


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_sigkill_crash_resume_token_identical(tmp_path, temperature):
    """A real process serving through a journal is killed by SIGKILL once
    every stream has committed tokens; a fresh engine resumes the journal
    (stealing the dead pid's lock) and every stream ends with the tokens
    and digest of an uninterrupted run — resumed now or journaled as
    finished before the kill, nothing twice, nothing lost."""
    eng = child.build(temperature)
    ps = child.prompts(eng.cfg.vocab_size)
    ref_h = [eng.submit(p, max_new_tokens=child.MAX_NEW, key=i) for i, p in enumerate(ps)]
    ref = {i + 1: (h.result(), h.digest) for i, h in enumerate(ref_h)}
    eng.close()

    jdir = str(tmp_path / "journal")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("TDX_FAULT", None)
    proc = subprocess.Popen([sys.executable, CHILD, jdir, str(temperature)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.strip() == "PROGRESS", line + proc.stderr.read()
        os.kill(proc.pid, signal.SIGKILL)
        assert proc.wait(timeout=60) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert os.path.exists(os.path.join(jdir, journal_mod._LOCK_NAME))  # left behind

    eng = child.build(temperature)
    handles = eng.resume_from_journal(RequestJournal(jdir))
    resumed = {u: (h.result(), h.digest) for u, h in handles.items()}
    eng.close()
    assert resumed, "the kill landed after every stream finished"
    entries, _ = fold_records(read_records(jdir))
    for u, want in ref.items():
        if u in resumed:
            assert resumed[u] == want, f"uid {u} diverged"
        else:
            e = entries[u]
            assert e.retired and e.outcome == "finished" and e.tokens == want[0]
    assert set(entries) == set(ref)  # no stream admitted twice
