"""The port's stream migration on the CPU, after ``tests/test_migration.py``.

A stream moved mid-decode from one port engine to another continues
token-identically to the stream that never moved, greedy and sampled with
top-k, prefix cache on and off; greedy, it also equals JAX's stream moved
the same way between two JAX engines, with JAX's page accounting on both
sides after every tick.  Shared prefix pages travel in the snapshot and
the refcounts settle on both sides; the destination's pages hold the
source's bits.  A geometry mismatch raises ``MigrationIncompatible`` with
nothing scattered; faults at ``serve.migrate_out`` leave the source
running and at ``serve.migrate_in`` free the destination's pages; the
deadline travels with the stream; the journal hands ownership over.

Through the ``FleetRouter`` (after ``tests/test_migration.py:131-395``):
``migrate_stream`` moves a live stream token-identically (greedy: equal to
JAX's router moving it the same way), prefix-shared pages settle on both
sides, ``migrate_out_streams`` drains a replica by migration, a refused
import falls back to the cold replay, a version-pinned stream with no
peer and a faulted export stay on the source, a faulted import frees the
destination's pages and falls back, the absolute deadline travels and an
expired one is never exported, and roles steer prompts with ``rebalance``
handing decode to the decode replica.
Tolerance: none (exact).
"""

import time

import pytest
import torch

from torchdistx_tpu import fleet as jfleet
from torchdistx_tpu.serving import Engine as JaxEngine
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.fleet import FleetRouter

from torchdistx_tpu_torch.resilience import faults, preemption
from torchdistx_tpu_torch.serving import (
    DeadlineExceeded,
    Engine,
    Health,
    MigrationIncompatible,
    RequestJournal,
    RequestPreempted,
)
from torchdistx_tpu_torch.serving.journal import fold_records, read_records

from _torch_serving_planes import accounting, engines, load, prompt_of, solo

EOS = 5
ENGINE_KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4)


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


def port_engine(fam, **over):
    return Engine(fam[3], device="cpu", handle_preemption=False, **{**ENGINE_KW, **over})


def settled(eng):
    held = 0 if eng.prefix is None else len(eng.prefix)
    return eng.allocator.num_in_use == held and eng.allocator.num_swapped == 0


def _move(a, b, prompt, key, max_new, *, warm=None):
    """Submit on ``a`` (after an optional warm-up request), step until two
    chunks are committed, migrate to ``b``, drain both; returns the
    handle, the snapshot and ``(a, b)`` accounting after every tick."""
    if warm is not None:
        a.submit(warm, max_new_tokens=4, key=99).result()
    h = a.submit(prompt, max_new_tokens=max_new, key=key)
    trace = []
    while len(h._tokens) < 5:
        a.step()
        trace.append((accounting(a), accounting(b)))
    (slot,) = a.migratable_slots()
    snap = a.migrate_out(slot)
    back = b.migrate_in(snap)
    assert back is h
    while not h.done:
        b.step()
        trace.append((accounting(a), accounting(b)))
    return h, snap, trace


@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.8, 8)],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("cache", [False, True], ids=["nocache", "cache"])
def test_migration_token_identical(fam, temperature, top_k, cache):
    kw = dict(temperature=temperature, top_k=top_k, eos_id=EOS, prefix_cache=cache,
              **ENGINE_KW)
    a, b = port_engine(fam, **kw), port_engine(fam, **kw)
    h, _, trace = _move(a, b, prompt_of(6), 3, 16)
    expect = solo(fam[3], prompt_of(6), 3, 16, eos=EOS, temperature=temperature,
                  top_k=top_k)
    assert h.result() == expect
    assert a.stats()["migrations_out"] == 1 and b.stats()["migrations_in"] == 1
    assert a.stats()["recoveries"] == 0 and b.stats()["recoveries"] == 0
    assert settled(a) and settled(b)
    if temperature == 0.0:
        # JAX's engines, the same move: the same stream and accounting.
        ja, _ = engines(fam, **kw)
        jb, _ = engines(fam, **kw)
        jh, _, jtrace = _move(ja, jb, prompt_of(6), 3, 16)
        assert jh.result() == h.result()
        assert jtrace == trace
    a.close()
    b.close()


def test_shared_prefix_pages_migrate_with_their_bits(fam):
    a, b = port_engine(fam, prefix_cache=True), port_engine(fam, prefix_cache=True)
    prompt = prompt_of(16)  # two full pages: indexable
    h, snap, _ = _move(a, b, prompt, 4, 12, warm=prompt)
    assert snap["n_pages"] == 4  # every page of the table: 16 + 12 positions
    assert a.prefix.hits == 1  # the moved stream held shared pages on A
    assert h.result() == solo(fam[3], prompt, 4, 12)
    assert settled(a) and settled(b)
    assert a.prefix.check(a.allocator) is None
    # The snapshot's pages are A's bits and landed on B unchanged.
    c = port_engine(fam, prefix_cache=False)
    slot_h = c.submit(prompt, max_new_tokens=12, key=4)
    while len(slot_h._tokens) < 5:
        c.step()
    (slot,) = c.migratable_slots()
    pages = list(c._slot_req[slot].blocks)
    before = {n: p[:, pages].clone() for n, p in c._cache.items()}
    snap = c.migrate_out(slot)
    for n in before:
        assert torch.equal(snap["host"][n], before[n])
    d = port_engine(fam, prefix_cache=False)
    d.migrate_in(snap)
    (dslot,) = d.migratable_slots()
    for n in before:
        assert torch.equal(d._cache[n][:, d._slot_req[dslot].blocks], before[n])
    assert slot_h.result() == solo(fam[3], prompt, 4, 12)


def test_geometry_mismatch_raises_before_any_scatter(fam):
    a = port_engine(fam, prefix_cache=False)
    h = a.submit(prompt_of(6), max_new_tokens=12, key=5)
    while len(h._tokens) < 5:
        a.step()
    snap = a.migrate_out(a.migratable_slots()[0])
    for other in (port_engine(fam, block_size=16, prefix_cache=False),
                  Engine(load("gpt2")[3], device="cpu", handle_preemption=False,
                         **ENGINE_KW)):
        with pytest.raises(MigrationIncompatible):
            other.migrate_in(snap)
        assert other.allocator.num_in_use == 0
        assert all(not p.any() for p in other._cache.values())  # nothing scattered
        other.close()
    assert MigrationIncompatible.retryable
    b = port_engine(fam, prefix_cache=False)  # a compatible peer still takes it
    b.migrate_in(snap)
    assert h.result() == solo(fam[3], prompt_of(6), 5, 12)


def test_migrate_out_fault_leaves_the_source_running(fam):
    a = port_engine(fam, prefix_cache=False)
    h = a.submit(prompt_of(6), max_new_tokens=12, key=6)
    while len(h._tokens) < 5:
        a.step()
    faults.reset("serve.migrate_out:1:io")
    with pytest.raises(OSError):
        a.migrate_out(a.migratable_slots()[0])
    faults.reset("")
    assert a.stats()["migrations_out"] == 0 and a._n_running() == 1
    assert h.result() == solo(fam[3], prompt_of(6), 6, 12)
    assert settled(a)


def test_migrate_in_fault_frees_the_destination_pages(fam):
    a, b = port_engine(fam, prefix_cache=False), port_engine(fam, prefix_cache=False)
    h = a.submit(prompt_of(6), max_new_tokens=12, key=7)
    while len(h._tokens) < 5:
        a.step()
    snap = a.migrate_out(a.migratable_slots()[0])
    faults.reset("serve.migrate_in:1:io")
    with pytest.raises(OSError):
        b.migrate_in(snap)
    faults.reset("")
    assert b.allocator.num_in_use == 0 and b._n_running() == 0
    b.migrate_in(snap)  # the snapshot still holds the stream: a retry lands it
    assert h.result() == solo(fam[3], prompt_of(6), 7, 12)
    assert settled(a) and settled(b)


def test_deadline_travels_with_the_stream(fam):
    a, b = port_engine(fam, prefix_cache=False), port_engine(fam, prefix_cache=False)
    h = a.submit(prompt_of(6), max_new_tokens=40, key=8, deadline_s=30.0)
    while len(h._tokens) < 5:
        a.step()
    deadline = h._req.deadline
    b.migrate_in(a.migrate_out(a.migratable_slots()[0]))
    assert h._req.deadline == deadline
    h._req.deadline = 0.0  # expire it on the destination
    b.step()
    assert isinstance(h.error, DeadlineExceeded) and settled(b)


def test_journal_hands_ownership_over(fam, tmp_path):
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    a = port_engine(fam, prefix_cache=False, journal=RequestJournal(da))
    b = port_engine(fam, prefix_cache=False, journal=RequestJournal(db))
    h = a.submit(prompt_of(6), max_new_tokens=12, key=9)
    while len(h._tokens) < 5:
        a.step()
    moved = list(h._tokens)
    b.migrate_in(a.migrate_out(a.migratable_slots()[0]))
    toks = h.result()
    a.close()
    b.close()
    ea, _ = fold_records(read_records(da))
    eb, _ = fold_records(read_records(db))
    (src,), (dst,) = ea.values(), eb.values()
    assert src.retired and src.outcome == "migrated" and src.tokens == moved
    assert dst.retired and dst.outcome == "finished" and dst.tokens == toks
    assert dst.prompt == [int(t) for t in prompt_of(6)]


def test_only_resident_decode_streams_migrate(fam):
    a = port_engine(fam, prefix_cache=False)
    with pytest.raises(ValueError, match="idle"):
        a.migrate_out(0)
    a.submit(prompt_of(6), max_new_tokens=12, key=10)
    assert a.migratable_slots() == []
    g = load("gpt2")[3]  # the GPT-2 family migrates the same way
    ga, gb = (Engine(g, device="cpu", handle_preemption=False, prefix_cache=False,
                     **ENGINE_KW) for _ in range(2))
    h = ga.submit(prompt_of(7), max_new_tokens=10, key=11)
    while len(h._tokens) < 5:
        ga.step()
    gb.migrate_in(ga.migrate_out(ga.migratable_slots()[0]))
    assert h.result() == solo(g, prompt_of(7), 11, 10)
    a.close()


# ---------------------------------------------------------------------------
# Through the router


def rport(fam, **over):
    return port_engine(fam, **{"prefix_cache": False, **over})


def _router_move(router_cls, a, b):
    router = router_cls([a, b], version="v1")
    b.detector.observe_tick(0.5)
    h = router.submit(prompt_of(6), max_new_tokens=10, key=3)
    assert h.replica_id == 0
    g = h.tokens()
    first = [next(g), next(g)]
    (slot,) = a.migratable_slots()
    assert router.migrate_stream(0, slot)
    return first + list(g), router


def test_router_migrate_stream_equals_jax(fam):
    jmod, cfg, params, _ = fam
    jkw = dict(ENGINE_KW, eos_id=EOS, handle_preemption=False, prefix_cache=False)
    want, jr = _router_move(jfleet.FleetRouter,
                            *(JaxEngine(params, model=jmod, cfg=cfg, **jkw) for _ in range(2)))
    before = telemetry.counter("fleet.migrations").value
    a, b = rport(fam, eos_id=EOS), rport(fam, eos_id=EOS)
    got, router = _router_move(FleetRouter, a, b)
    assert got == want == solo(fam[3], prompt_of(6), 3, 10, eos=EOS)
    assert telemetry.counter("fleet.migrations").value == before + 1
    assert a.stats()["migrations_out"] == b.stats()["migrations_in"] == 1
    assert b.stats()["recoveries"] == 0
    assert settled(a) and settled(b)
    router.close()
    jr.close()


def test_router_shared_prefix_pages_settle(fam):
    a, b = port_engine(fam), port_engine(fam)
    router = FleetRouter([a, b], version="v1")
    b.detector.observe_tick(50.0)
    warm = router.submit(prompt_of(16), max_new_tokens=2, key=0)
    assert warm.replica_id == 0 and len(warm.result()) == 2 and len(a.prefix) == 2
    b.detector.observe_tick(50.0)
    h = router.submit(prompt_of(16), max_new_tokens=8, key=1)
    g = h.tokens()
    first = [next(g)]
    (slot,) = a.migratable_slots()
    req = a._slot_req[slot]
    assert [p for p in req.blocks if a.allocator.refcount(p) > 1]
    assert router.migrate_stream(0, slot)
    assert a.allocator.num_in_use == len(a.prefix) == 2
    assert all(a.allocator.refcount(p) == 1 for p in a.prefix._pages.values())
    assert len(b.prefix) == 0 and all(b.allocator.refcount(p) == 1 for p in req.blocks)
    assert first + list(g) == solo(fam[3], prompt_of(16), 1, 8)
    assert settled(a) and settled(b)


def test_router_drain_by_migration(fam):
    a, b = rport(fam), rport(fam)
    router = FleetRouter([a, b], version="v1")
    b.detector.observe_tick(0.5)
    h = router.submit(prompt_of(6), max_new_tokens=10, key=7)
    g = h.tokens()
    first = [next(g)]
    router.close_admission(0)
    assert router.migrate_out_streams(0) == {"migrated": 1, "fallbacks": 0, "left": 0}
    a.begin_drain()
    while a.health() is not Health.STOPPED:
        a.step()
    assert first + list(g) == solo(fam[3], prompt_of(6), 7, 10)
    assert b.stats()["migrations_in"] == 1 and b.stats()["recoveries"] == 0
    assert settled(b)


@pytest.mark.parametrize("refusal", ["geometry", "migrate_in_fault"])
def test_router_refused_import_falls_back_to_cold_replay(fam, refusal):
    a = rport(fam)
    b = rport(fam, block_size=16) if refusal == "geometry" else rport(fam)
    if refusal == "migrate_in_fault":
        faults.reset("serve.migrate_in:1:io")
    router = FleetRouter([a, b], version="v1")
    b.detector.observe_tick(0.5)
    before = telemetry.counter("fleet.migration_fallbacks").value
    h = router.submit(prompt_of(6), max_new_tokens=10, key=9)
    g = h.tokens()
    first = [next(g)]
    (slot,) = a.migratable_slots()
    assert not router.migrate_stream(0, slot)
    assert b.allocator.num_in_use == 0
    assert telemetry.counter("fleet.migration_fallbacks").value == before + 1
    assert isinstance(h._inner.error, RequestPreempted) and h._inner.error.retryable
    assert first + list(g) == solo(fam[3], prompt_of(6), 9, 10)
    assert h.hops == 1 and settled(a) and settled(b)


@pytest.mark.parametrize("why", ["no_same_version_peer", "migrate_out_fault"])
def test_router_refused_export_leaves_the_stream_running(fam, why):
    a, b = rport(fam), rport(fam)
    if why == "no_same_version_peer":
        router = FleetRouter([a], version="v1")
        router.add_replica(b, version="v2")
    else:
        faults.reset("serve.migrate_out:1:io")
        router = FleetRouter([a, b], version="v1")
        b.detector.observe_tick(0.5)
    h = router.submit(prompt_of(6), max_new_tokens=8, key=4)
    g = h.tokens()
    first = [next(g)]
    (slot,) = a.migratable_slots()
    assert not router.migrate_stream(0, slot)
    assert first + list(g) == solo(fam[3], prompt_of(6), 4, 8)
    assert h.hops == 0 and a.stats()["migrations_out"] == 0
    assert b.stats()["migrations_in"] == 0 and settled(a) and settled(b)


def test_router_deadline_travels_and_expired_is_not_exported(fam):
    a, b = rport(fam), rport(fam)
    router = FleetRouter([a, b], version="v1")
    b.detector.observe_tick(0.5)
    h = router.submit(prompt_of(6), max_new_tokens=8, key=1, deadline_s=60.0)
    g = h.tokens()
    next(g)
    (slot,) = a.migratable_slots()
    req = a._slot_req[slot]
    deadline = req.deadline
    assert router.migrate_stream(0, slot) and req.deadline == deadline
    list(g)
    b.detector.observe_tick(50.0)
    h = router.submit(prompt_of(6), max_new_tokens=32, key=8, deadline_s=60.0)
    assert h.replica_id == 0
    g = h.tokens()
    next(g)
    (slot,) = a.migratable_slots()
    a._slot_req[slot].deadline = time.perf_counter() - 0.001
    assert not router.migrate_stream(0, slot)
    assert a.stats()["migrations_out"] == 1  # the first stream only
    with pytest.raises(DeadlineExceeded):
        list(g)
    first_err = h.error
    h._inner._fail(RequestPreempted("late loser"))
    assert h.error is first_err and settled(a) and settled(b)


def test_router_role_steering_and_rebalance(fam):
    p, d = rport(fam, role="prefill"), rport(fam, role="decode")
    router = FleetRouter(version="v1", long_prompt_tokens=16)
    router.add_replica(p, version="v1")
    router.add_replica(d, version="v1")
    short = router.submit(prompt_of(4), max_new_tokens=2, key=0)
    assert short.replica_id == 1 and len(short.result()) == 2
    h = router.submit(prompt_of(24), max_new_tokens=8, key=5)
    assert h.replica_id == 0
    g = h.tokens()
    first = [next(g)]
    assert router.rebalance() == 1
    assert first + list(g) == solo(fam[3], prompt_of(24), 5, 8)
    assert p.stats()["migrations_out"] == d.stats()["migrations_in"] == 1
    assert d.stats()["recoveries"] == 0 and settled(p) and settled(d)
    assert [r["role"] for r in router.stats()["replicas"]] == ["prefill", "decode"]
