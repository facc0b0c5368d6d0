"""The port's fleet on the CPU, after ``tests/test_fleet.py``.

A ``FleetRouter`` over port engines picks replicas in JAX's order on the
same traffic, avoids OVERLOADED and excludes DRAINING replicas, and fails a
stream over mid-flight after ``close()``: greedy, token-identical to JAX's
router doing the same on ``llama_test`` and ``gpt2_test`` (f32, the port's
weights carried from JAX); sampled with top-k, token-identical to the
port's solo ``generate(key=)``.  A prefix-cached stream fails over; a
version-pinned stream, a diverged prefix, an exhausted hop budget and a
deadline spanning hops fail typed; the QoS context, ``model`` and ``n``
ride every hop.  ``hot_swap`` to a standby built by ``materialize_standby``
drops nothing under load, no stream mixes versions, and the streams equal
JAX's hot swap onto the same weights; ``materialize_standby`` records with
no storage and equals a direct seeded ``materialize_module_torch``;
``recover(journal)`` resumes a dead replica's streams on a live one.
Tolerance: none (exact).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu import fleet as jfleet
from torchdistx_tpu.serving import Engine as JaxEngine
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.deferred_init import deferred_init, is_deferred
from torchdistx_tpu_torch.fleet import (
    FailoverDiverged,
    FailoverExhausted,
    FleetRouter,
    NoReplicaAvailable,
    hot_swap,
    materialize_standby,
)
from torchdistx_tpu_torch.materialize import materialize_module_torch
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import to_jax_params
from torchdistx_tpu_torch.models.generate import fold_key
from torchdistx_tpu_torch.resilience import faults, preemption
from torchdistx_tpu_torch.serving import (
    DeadlineExceeded,
    Engine,
    EngineOverloaded,
    Health,
    ModelPool,
    RequestCancelled,
    RequestError,
    RequestJournal,
)

from _torch_serving_planes import SAMPLED, load, prompt_of, solo

EOS = 5
ENGINE_KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 handle_preemption=False, prefix_cache=False)


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    yield
    preemption.clear()
    faults.reset("")


@pytest.fixture(scope="module")
def fams():
    return {name: load(name) for name in ("llama", "gpt2")}


@pytest.fixture(scope="module")
def fam(fams):
    return fams["llama"]


def port(fam, **over):
    return Engine(fam[3], device="cpu", **{**ENGINE_KW, **over})


def jax_engine(fam, params=None, **over):
    jmod, cfg, jparams, _ = fam
    return JaxEngine(jparams if params is None else params, model=jmod, cfg=cfg,
                     **{**ENGINE_KW, **over})


# ---------------------------------------------------------------------------
# Routing


def _pick_trace(router, engines):
    """A fixed routing script: detector readings, submissions without
    stepping (load grows), health changes; the replica id of each pick."""
    a, b, c = engines
    out = []
    a.detector.observe_tick(0.5)
    b.detector.observe_tick(0.01)
    for i in range(3):
        out.append(router.submit(prompt_of(4 + i), max_new_tokens=2, key=i).replica_id)
    for e in engines:
        e.detector._tick_ewma_s = None
    for i in range(4):
        out.append(router.submit(prompt_of(5, base=i), max_new_tokens=2, key=10 + i).replica_id)
    c._set_health(type(c.health())("overloaded"))  # each package's own enum
    out.append(router._pick().rid)
    b.begin_drain()
    out.append(router._pick().rid)
    a.begin_drain()
    out.append(router._pick().rid)
    return out


def test_pick_order_equals_jax(fam):
    traces = []
    for mk, rcls in ((jax_engine, jfleet.FleetRouter), (port, FleetRouter)):
        engines = [mk(fam) for _ in range(3)]
        router = rcls(engines, version="v1")
        traces.append(_pick_trace(router, engines))
        router.close()
    assert traces[1] == traces[0]
    assert traces[1][-3:] == [0, 0, 2]  # OVERLOADED avoided, then the last resort


def test_overloaded_avoided_draining_excluded(fam):
    a, b = port(fam), port(fam)
    router = FleetRouter([a, b], version="v1")
    b._set_health(Health.OVERLOADED)
    assert router._pick().rid == 0
    a.begin_drain()
    assert router._pick().rid == 1
    b._set_health(Health.READY)
    b.begin_drain()
    with pytest.raises(NoReplicaAvailable) as ei:
        router.submit(prompt_of(4), max_new_tokens=2, key=0)
    assert ei.value.retryable
    while a.health() is not Health.STOPPED or b.health() is not Health.STOPPED:
        router.step()
    assert router.replicas() == []


def test_replicas_ready_gauge_and_respawn(fam):
    a, b = port(fam), port(fam)
    router = FleetRouter([a, b], version="v1")
    assert telemetry.gauge("fleet.replicas_ready").value == 2
    a.close()
    assert router.poll() == [0]
    assert telemetry.gauge("fleet.replicas_ready").value == 1
    rid = router.add_replica(port(fam), version="v1")
    b.begin_drain()
    h = router.submit(prompt_of(4), max_new_tokens=3, key=0)
    assert h.replica_id == rid and len(h.result()) == 3
    router.close()


# ---------------------------------------------------------------------------
# Failover


def _failover(router_cls, engines, n_first=2):
    router = router_cls(engines, version="v1")
    h = router.submit(prompt_of(6), max_new_tokens=10, key=3)
    assert h.replica_id == 0
    g = h.tokens()
    first = [next(g) for _ in range(n_first)]
    engines[0].close()
    toks = first + list(g)
    assert h.replica_id == 1 and h.hops == 1 and h.version == "v1"
    return toks, h, router


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_greedy_failover_equals_jax(fams, name):
    fam = fams[name]
    jtoks, jh, jr = _failover(jfleet.FleetRouter, [jax_engine(fam, eos_id=EOS)
                                                   for _ in range(2)])
    before = telemetry.counter("fleet.failovers").value
    engines = [port(fam, eos_id=EOS) for _ in range(2)]
    toks, h, router = _failover(FleetRouter, engines)
    assert toks == jtoks == solo(fam[3], prompt_of(6), 3, 10, eos=EOS)
    assert h.digest == jh.digest
    assert telemetry.counter("fleet.failovers").value == before + 1
    assert engines[0].allocator.num_in_use == engines[1].allocator.num_in_use == 0
    router.close()
    jr.close()


def test_sampled_failover_equals_solo(fam):
    engines = [port(fam, eos_id=EOS, **SAMPLED) for _ in range(2)]
    toks, h, router = _failover(FleetRouter, engines, n_first=1)
    assert toks == solo(fam[3], prompt_of(6), 3, 10, eos=EOS, **SAMPLED)
    router.close()


def test_failover_replays_a_prefix_cached_stream(fam):
    kw = dict(eos_id=EOS, prefix_cache=True, **SAMPLED)
    a, b = port(fam, **kw), port(fam, **kw)
    router = FleetRouter([a, b], version="v1")
    b.detector.observe_tick(5.0)  # route onto A
    warm = router.submit(prompt_of(16), max_new_tokens=2, key=7)
    assert warm.replica_id == 0 and len(warm.result()) == 2
    victim = np.concatenate([prompt_of(16), prompt_of(4, base=90)])
    hits = a.stats()["prefix_hits"]
    h = router.submit(victim, max_new_tokens=10, key=8)
    g = h.tokens()
    first = [next(g)]
    assert a.stats()["prefix_hits"] == hits + 1
    a.close()
    assert first + list(g) == solo(fam[3], victim, 8, 10, eos=EOS, **SAMPLED)
    assert h.replica_id == 1 and h.hops == 1
    assert a.allocator.num_in_use == 0
    assert b.stats()["prefix_cached_pages"] >= 2
    router.close()


def test_failover_is_version_pinned(fam):
    a, b = port(fam), port(fam)
    router = FleetRouter([a], version="v1")
    router.add_replica(b, version="v2")
    h = router.submit(prompt_of(6), max_new_tokens=8, key=0)
    g = h.tokens()
    next(g)
    a.close()
    with pytest.raises(NoReplicaAvailable) as ei:
        list(g)
    assert "version" in str(ei.value)
    h2 = router.submit(prompt_of(4), max_new_tokens=3, key=1)
    assert h2.version == "v2" and h2.result() == solo(fam[3], prompt_of(4), 1, 3)
    router.close()


def test_diverged_prefix_fails_typed(fam):
    other = load("llama", seed=99)[3]
    a = port(fam)
    b = Engine(other, device="cpu", **ENGINE_KW)
    router = FleetRouter([a], version="v1")
    router.add_replica(b, version="v1")  # lies about its weights
    h = router.submit(prompt_of(6), max_new_tokens=8, key=0)
    g = h.tokens()
    assert [next(g), next(g)] == solo(fam[3], prompt_of(6), 0, 8)[:2]
    a.close()
    with pytest.raises(FailoverDiverged) as ei:
        list(g)
    assert not ei.value.retryable and h.error is ei.value
    b.step()
    assert b.allocator.num_in_use == 0
    # The same weights under another model_version: token-equal, digest not.
    a = port(fam, model_version="weights-a")
    b = port(fam, model_version="weights-b")
    router = FleetRouter([a, b], version="v1")
    h = router.submit(prompt_of(6), max_new_tokens=8, key=0)
    g = h.tokens()
    next(g), next(g)
    a.close()
    with pytest.raises(FailoverDiverged, match="model_version"):
        list(g)
    router.close()


def test_hop_budget_exhausted_fails_typed(fam):
    a, b = port(fam), port(fam)
    router = FleetRouter([a, b], version="v1", max_hops=0)
    before = telemetry.counter("fleet.hops_exhausted").value
    h = router.submit(prompt_of(6), max_new_tokens=8, key=0)
    g = h.tokens()
    next(g)
    a.close()
    with pytest.raises(FailoverExhausted) as ei:
        list(g)
    assert ei.value.retryable and isinstance(ei.value.__cause__, RequestError)
    assert telemetry.counter("fleet.hops_exhausted").value == before + 1
    with pytest.raises(FailoverExhausted):
        h.result()
    # A single replica shedding once is retried after a backoff hop.
    eng = port(fam)
    real = eng.submit
    state = {"n": 0}

    def shed_once(*args, **kwargs):
        state["n"] += 1
        if state["n"] == 1:
            raise EngineOverloaded("transient shed")
        return real(*args, **kwargs)

    eng.submit = shed_once
    h = FleetRouter([eng], version="v1", max_hops=3).submit(prompt_of(5), max_new_tokens=4,
                                                           key=0)
    assert h.hops == 1 and h.result() == solo(fam[3], prompt_of(5), 0, 4)
    with pytest.raises(NoReplicaAvailable):
        FleetRouter([], version="v1", max_hops=2).submit(prompt_of(4), max_new_tokens=2, key=0)


def test_deadline_spans_hops_and_cancel_never_fails_over(fam):
    a, b = port(fam), port(fam)
    router = FleetRouter([a, b], version="v1")
    h = router.submit(prompt_of(6), max_new_tokens=8, key=0, deadline_s=60.0)
    g = h.tokens()
    next(g)
    h._deadline = 0.0  # expired: a re-route grants no more wall clock
    a.close()
    with pytest.raises(DeadlineExceeded):
        list(g)
    assert b.allocator.num_in_use == 0
    c = port(fam)
    router.add_replica(c, version="v1")
    h = router.submit(prompt_of(6), max_new_tokens=20, key=0)
    g = h.tokens()
    next(g)
    assert h.cancel()
    with pytest.raises(RequestCancelled):
        list(g)
    assert h.hops == 0 and not h.cancel()
    router.close()


def test_qos_context_model_and_n_ride_every_hop(fam):
    """A queued request on a QoS replica that closes re-places on its peer
    with tenant, priority and deadline (the peer preempts its own
    low-class stream for it); a pool-model fork stream re-places with
    ``model`` and ``n`` (the peer materializes the model on demand and
    forks again)."""
    a, b = (port(fam, scheduler="qos", num_slots=1) for _ in range(2))
    router = FleetRouter([a, b], version="v1", max_hops=3)
    a.submit(prompt_of(6), max_new_tokens=30, key=50)
    a.step()
    b_local = b.submit(prompt_of(6, base=2), max_new_tokens=30, key=51)
    b.step()
    a.detector._tick_ewma_s = b.detector._tick_ewma_s = None
    h = router.submit(prompt_of(5, base=4), max_new_tokens=6, key=52, deadline_s=60.0,
                      tenant="gold", priority=3)
    queued = a.scheduler.peek()
    assert (queued.tenant, queued.priority) == ("gold", 3) and queued.deadline is not None
    before = telemetry.counter("serve.preemptions_replay").value
    a.close()
    assert h.result() == solo(fam[3], prompt_of(5, base=4), 52, 6)
    assert h.replica_id == 1 and telemetry.counter("serve.preemptions_replay").value > before
    b.drain()
    assert b_local.result() == solo(fam[3], prompt_of(6, base=2), 51, 30)
    router.close()

    tuna = load("llama", seed=9)[3]

    def pooled():
        pool = ModelPool()
        pool.register("tuna", module=deferred_init(tllama.Llama, tuna.cfg, device_="cuda"),
                      materialize=lambda: copy.deepcopy(tuna))
        return port(fam, num_slots=4, eos_id=EOS, model_pool=pool, **SAMPLED)

    a, b = pooled(), pooled()
    router = FleetRouter([a, b], version="v1", max_hops=3)
    h = router.submit(prompt_of(6), max_new_tokens=10, key=3, model="tuna", n=2)
    g = h.tokens()
    first = [next(g)]
    assert "tuna" in {r.model_tag for r in a._slot_req if r is not None}
    assert a.stats()["forks"] == 1
    a.close()
    assert first + list(g) == solo(tuna, prompt_of(6), fold_key(3, 0), 10, eos=EOS, **SAMPLED)
    assert h.replica_id == 1 and b.model_pool.ready("tuna") and b.stats()["forks"] == 1
    b.drain()
    router.close()


# ---------------------------------------------------------------------------
# Hot swap


def test_materialize_standby_records_nothing_and_equals_a_direct_replay(monkeypatch):
    seen = {}
    real = materialize_module_torch

    def watched(module, **kw):
        params = list(module.parameters())
        seen["fake"] = all(is_deferred(p) for p in params)
        seen["bytes"] = sum(p.untyped_storage().nbytes() for p in params
                            if not is_deferred(p))
        return real(module, **kw)

    import torchdistx_tpu_torch.materialize as mat_mod
    monkeypatch.setattr(mat_mod, "materialize_module_torch", watched)
    cfg = tllama.llama_test()
    got = materialize_standby(tllama.Llama, cfg, device="cpu", seed=4)
    assert seen == {"fake": True, "bytes": 0}
    assert isinstance(got, tllama.Llama) and hasattr(got, "prep_decode")
    skeleton = deferred_init(tllama.Llama, cfg, device_="cuda")
    want = real(skeleton, device="cpu", seed=4)
    state = got.state_dict()
    assert set(state) >= set(want)
    for name, value in want.items():
        assert torch.equal(state[name], value), name
    other = materialize_standby(tllama.Llama, cfg, device="cpu", seed=5)
    assert not torch.equal(other.embed.weight, got.embed.weight)
    flat = materialize_standby(tllama.Llama, cfg, device="cpu", seed=4, convert=dict)
    assert set(flat) == set(want) and all(torch.equal(flat[k], want[k]) for k in want)


def _swap_under_load(router_cls, hot_swap_fn, eng_v1, make_v2):
    router = router_cls([eng_v1], version="v1")
    live = router.submit(prompt_of(6), max_new_tokens=8, key=0)
    g = live.tokens()
    first = [next(g), next(g)]
    queued = [router.submit(prompt_of(5, base=i + 2), max_new_tokens=5, key=10 + i)
              for i in range(3)]
    hot_swap_fn(router, make_v2, version="v2")
    out = {"live": first + list(g), "queued": [h.result() for h in queued],
           "versions": [live.version] + [h.version for h in queued],
           "hops": [live.hops] + [h.hops for h in queued]}
    fresh = router.submit(prompt_of(4), max_new_tokens=3, key=99)
    out["fresh"] = fresh.result()
    out["replicas"] = [r.version for r in router.replicas()]
    assert eng_v1.health().value == "stopped" and eng_v1.allocator.num_in_use == 0
    router.close()
    return out


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_hot_swap_zero_drops_one_version_a_stream_equal_jax(fams, name):
    fam = fams[name]
    jmod, cfg, jparams, model = fam
    tcfg = model.cfg
    v2 = materialize_standby(type(model), dataclasses.replace(tcfg), device="cpu", seed=1)
    params_v2 = jax.tree.map(jnp.asarray, to_jax_params(v2))
    before = telemetry.counter("fleet.swaps").value
    got = _swap_under_load(FleetRouter, hot_swap, port(fam),
                           lambda: Engine(v2, device="cpu", **ENGINE_KW))
    want = _swap_under_load(jfleet.FleetRouter, jfleet.hot_swap, jax_engine(fam),
                            lambda: jax_engine(fam, params_v2))
    assert telemetry.counter("fleet.swaps").value == before + 1
    assert got == want
    assert got["versions"] == ["v1", "v2", "v2", "v2"] and got["hops"][0] == 0
    assert min(got["hops"][1:]) >= 1 and got["replicas"] == ["v2"]
    assert got["live"] == solo(model, prompt_of(6), 0, 8)
    for i, toks in enumerate(got["queued"]):
        assert toks == solo(v2, prompt_of(5, base=i + 2), 10 + i, 5)
    assert got["fresh"] == solo(v2, prompt_of(4), 99, 3)


# ---------------------------------------------------------------------------
# Journal recovery


def test_recover_resumes_a_dead_replicas_journal(fam, tmp_path):
    ps = [prompt_of(6, base=1 + 3 * i) for i in range(3)]
    ref = [solo(fam[3], p, i, 16) for i, p in enumerate(ps)]
    d = str(tmp_path / "j")
    dead = port(fam, journal=RequestJournal(d), num_slots=4, max_prefills_per_tick=4)
    hs = [dead.submit(p, max_new_tokens=16, key=i) for i, p in enumerate(ps)]
    for _ in range(3):
        dead.step()
    assert all(0 < len(h._tokens) < 16 for h in hs)
    j = dead._journal
    dead._journal = None  # a hard kill: the journal is never sealed
    j.release()
    dead.close()
    a, b = port(fam), port(fam)
    router = FleetRouter([a, b], version="v1")
    b.submit(prompt_of(4), max_new_tokens=20, key=9)  # B is busier
    rid, handles = router.recover(RequestJournal(d), version="v1")
    assert rid == 0
    assert [handles[u].result() for u in sorted(handles)] == ref
    from torchdistx_tpu_torch.serving import JournalOwned

    with pytest.raises(JournalOwned):
        router.recover(RequestJournal(d))
    b.drain()
    router.close()
