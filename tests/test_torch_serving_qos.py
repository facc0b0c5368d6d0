"""The port's QoS plane against JAX's on the CPU, after
``tests/test_serving_qos.py``.

``QoSScheduler`` pops in JAX's exact order for the same push / pop /
requeue / shed sequences (the weight-8-vs-1 starvation bound and the
idle-tenant clamp included).  The QoS engine, greedy, matches JAX's QoS
engine on ``llama_test`` in f32: streams token for token, the same slots
admitted on the same ticks, the same swap and replay preemption counts,
and the same page accounting (in use, free, swapped, cached) after every
tick.  Sampled streams equal the port's solo ``generate(key=)`` (JAX's
threefry draws are not reproduced).  ``swap_out_pages`` /
``swap_in_pages`` move JAX's bits exactly.  Tolerance: none (exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.serving import BlockAllocator as JaxAllocator
from torchdistx_tpu.serving import EngineOverloaded as JaxOverloaded
from torchdistx_tpu.serving import QoSScheduler as JaxQoS
from torchdistx_tpu.serving import cache as jcache
from torchdistx_tpu.serving.scheduler import Request as JaxRequest
from torchdistx_tpu.serving.scheduler import RequestHandle as JaxHandle
from torchdistx_tpu_torch.resilience import faults, preemption
from torchdistx_tpu_torch.serving import (
    BlockAllocator,
    Engine,
    EngineOverloaded,
    MigrationIncompatible,
    QoSScheduler,
    RequestCancelled,
    cache,
)
from torchdistx_tpu_torch.serving.scheduler import Request, RequestHandle

from _torch_serving_planes import SAMPLED, engines, load, prompt_of, run_script, solo

EOS = 5
ENGINE_KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 prefix_cache=False)
# 8 usable pages; each request reserves 5 (8 prompt + 26 out): two can
# never both hold pages, so the second's admission is page pressure.
PRESSURE_KW = dict(scheduler="qos", num_slots=2, block_size=8, num_blocks=9,
                   max_model_len=64, decode_chunk=4)


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


# ---------------------------------------------------------------------------
# QoSScheduler against JAX's, exact pop order


def _req(cls, handle_cls, rid, tenant, priority, n_chunks, deadline):
    return cls(rid, np.zeros(4, np.int32), 4, np.zeros(2, np.uint32), handle_cls(None, rid),
               deadline=deadline, n_chunks=n_chunks, tenant=tenant, priority=priority)


class _Pair:
    """The same operations on the port's scheduler and JAX's; every
    result compared as request ids."""

    def __init__(self, weights=None):
        self.ours = QoSScheduler(tenant_weights=weights)
        self.theirs = JaxQoS(tenant_weights=weights)
        self.reqs = {}

    def push(self, rid, tenant="default", priority=0, n_chunks=1, deadline=None):
        a = _req(Request, RequestHandle, rid, tenant, priority, n_chunks, deadline)
        b = _req(JaxRequest, JaxHandle, rid, tenant, priority, n_chunks, deadline)
        self.reqs[rid] = (a, b)
        self.ours.push(a)
        self.theirs.push(b)

    def pop(self, n=1):
        got = [[r.rid for r in sched.pop_admissible(n, alloc, 8)]
               for sched, alloc in ((self.ours, BlockAllocator(4096, 8)),
                                    (self.theirs, JaxAllocator(4096, 8)))]
        assert got[0] == got[1], got
        return got[0]

    def requeue(self, rids):
        self.ours.requeue([self.reqs[r][0] for r in rids])
        self.theirs.requeue([self.reqs[r][1] for r in rids])

    def shed(self, kind, below=None):
        fn = "shed_oldest" if kind == "oldest" else "shed_lowest"
        args = () if kind == "oldest" else (below,)
        a, b = getattr(self.ours, fn)(*args), getattr(self.theirs, fn)(*args)
        assert (a and a.rid) == (b and b.rid)
        return a and a.rid

    def drain(self):
        out = []
        while len(self.ours):
            out += self.pop()
        assert len(self.theirs) == 0
        return out


def test_scheduler_starvation_bound_weight_8_vs_1():
    p = _Pair({"whale": 8.0, "minnow": 1.0})
    for i in range(30):
        p.push(i, "whale")
    p.push(100, "minnow")
    p.push(101, "minnow")
    order = p.drain()
    first, second = order.index(100), order.index(101)
    assert second - first <= 9, order


def test_scheduler_idle_tenant_banks_no_credit():
    p = _Pair()
    for i in range(6):
        p.push(i, "busy")
    p.pop(3)
    # "sleepy" arrives late: clamped to the class clock, no banked credit.
    for i in range(10, 14):
        p.push(i, "busy")
    p.push(50, "sleepy")
    p.push(51, "sleepy")
    order = p.drain()
    assert order.index(51) > order.index(50)


def test_scheduler_vclock_scoped_per_class_priority_and_edf():
    p = _Pair({"a": 2.0})
    p.push(0, "a", 0, n_chunks=3)
    p.push(1, "b", 0, n_chunks=1, deadline=50.0)
    p.push(2, "b", 0, n_chunks=1, deadline=10.0)
    p.push(3, "a", 2, n_chunks=2)
    p.push(4, "c", 2, n_chunks=1, deadline=5.0)
    p.push(5, "c", 1)
    assert p.pop() == [3]  # the top class first; its tenants tie at 0, by name
    p.push(6, "a", 2, n_chunks=4)
    assert p.drain()[0] == 4  # "a" was charged 2 / 2 for request 3


def test_scheduler_requeue_and_shed_hooks():
    p = _Pair()
    for i, (t, pr) in enumerate([("x", 0), ("y", 1), ("x", 1), ("z", 0), ("y", 0)]):
        p.push(i, t, pr, n_chunks=i + 1)
    got = p.pop(2)
    p.requeue(got)  # back at the head of the line, no second charge
    assert p.pop(2) == got
    assert p.shed("lowest", below=1) is not None
    assert p.shed("lowest", below=0) is None
    assert p.shed("oldest") is not None
    p.drain()


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_random_sequences_match_jax(seed):
    """Random pushes (tenants with weights, classes, deadlines, chunk
    costs), pops of 1-3, head-of-line requeues and sheds: every result
    equals JAX's."""
    rng = np.random.default_rng(seed)
    p = _Pair({"t0": 4.0, "t1": 1.0, "t2": 2.5})
    rid = 0
    for _ in range(120):
        op = rng.integers(0, 10)
        if op < 5 or not len(p.ours):
            dl = None if rng.random() < 0.5 else float(rng.integers(0, 100))
            p.push(rid, f"t{rng.integers(0, 4)}", int(rng.integers(0, 3)),
                   int(rng.integers(1, 5)), dl)
            rid += 1
        elif op < 8:
            got = p.pop(int(rng.integers(1, 4)))
            if got and rng.random() < 0.3:
                p.requeue(got)
        elif op == 8:
            p.shed("oldest")
        else:
            p.shed("lowest", below=int(rng.integers(0, 3)))
    p.drain()


# ---------------------------------------------------------------------------
# The QoS engine against JAX's: tokens, admissions, preemptions, pages


def _compare(fam, kw, script):
    jeng, teng = engines(fam, **kw)
    jh, jtrace = run_script(jeng, script)
    th, ttrace = run_script(teng, script)
    assert [h.result() for h in th] == [h.result() for h in jh]
    assert ttrace == jtrace  # page accounting and slot occupancy, tick by tick
    js, ts = jeng.stats(), teng.stats()
    for k in ("preemptions_swap", "preemptions_replay", "swapped_pages", "requests",
              "ticks", "prefix_hits", "cow_copies"):
        assert ts.get(k) == js.get(k), k
    jeng.close()
    teng.close()
    return th, ts


def _pressure_script(prompt_b, key=800):
    return [("submit", dict(prompt=prompt_of(8), max_new_tokens=26, key=key, priority=0)),
            ("step",),
            ("submit", dict(prompt=prompt_b, max_new_tokens=26, key=key + 1, priority=5))]


@pytest.mark.parametrize("mechanism", ["swap", "replay"])
@pytest.mark.parametrize("cache_on", [False, True], ids=["cache_off", "cache_on"])
def test_page_pressure_preemption_matches_jax(fam, mechanism, cache_on):
    prompt_b = prompt_of(8) if cache_on else prompt_of(8, base=2)
    _, st = _compare(fam, dict(PRESSURE_KW, prefix_cache=cache_on,
                               preempt_mechanism=mechanism), _pressure_script(prompt_b))
    assert st["preemptions_swap" if mechanism == "swap" else "preemptions_replay"] >= 1
    assert st["swapped_pages"] == 0


@pytest.mark.parametrize("cache_on", [False, True], ids=["cache_off", "cache_on"])
def test_slot_pressure_replay_matches_jax(fam, cache_on):
    script = [("submit", dict(prompt=prompt_of(6), max_new_tokens=24, key=700, priority=0)),
              ("step",),
              ("submit", dict(prompt=prompt_of(6, base=3), max_new_tokens=8, key=701,
                              priority=5))]
    _, st = _compare(fam, dict(scheduler="qos", num_slots=1, block_size=8, max_model_len=64,
                               decode_chunk=4, prefix_cache=cache_on), script)
    assert st["preemptions_replay"] >= 1


@pytest.mark.parametrize("mechanism", ["swap", "replay"])
def test_mixed_tenants_and_classes_match_jax(fam, mechanism):
    """Four class-0 requests with long prompts, chunked
    (``prefill_chunk=8``), then four short class-1/2 arrivals of three
    tenants on three slots and 13 pages, EOS on: a higher class aborts a
    lower class's prefill."""
    rng = np.random.default_rng(4)
    script = []
    for i in range(8):
        hi = i >= 4
        script.append(("submit", dict(
            prompt=rng.integers(0, 256, size=int(rng.integers(4, 12) if hi
                                                 else rng.integers(20, 30))).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 12)) if hi else 16, key=600 + i,
            tenant=("gold", "free", "team")[i % 3], priority=(1 + i % 2) if hi else 0)))
        script += [("step",)] * (4 if i == 3 else 1)
    _, st = _compare(fam, dict(scheduler="qos", tenant_weights={"gold": 4.0}, eos_id=EOS,
                               num_slots=3, block_size=8, num_blocks=14, max_model_len=64,
                               decode_chunk=4, prefill_chunk=8, preempt_mechanism=mechanism),
                     script)
    assert st["preemptions_replay"] >= 1


@pytest.mark.parametrize("mechanism", ["swap", "replay"])
def test_sampled_preempted_streams_equal_solo_generate(fam, mechanism):
    model = fam[3]
    eng = Engine(model, device="cpu", handle_preemption=False, prefix_cache=False,
                 preempt_mechanism=mechanism, **SAMPLED, **PRESSURE_KW)
    handles, _ = run_script(eng, _pressure_script(prompt_of(8, base=2), key=900))
    st = eng.stats()
    assert st["preemptions_swap" if mechanism == "swap" else "preemptions_replay"] >= 1
    assert handles[0].result() == solo(model, prompt_of(8), 900, 26, **SAMPLED)
    assert handles[1].result() == solo(model, prompt_of(8, base=2), 901, 26, **SAMPLED)
    assert eng.allocator.num_in_use == 0 and eng.allocator.num_swapped == 0


def test_swap_pages_round_trip_exact_against_jax():
    """The same random pool in both packages: the port's swap-out equals
    JAX's bit for bit, and a swap-in into other pages lands JAX's bits."""
    rng = np.random.default_rng(7)
    shape = (2, 12, 8, 2, 16)
    pool = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    ours = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    theirs = {n: jnp.asarray(a) for n, a in pool.items()}
    pages = [3, 7, 1, 10]
    host_t = cache.swap_out_pages(ours, pages)
    host_j = jcache.swap_out_pages(theirs, pages)
    for n in ("k", "v"):
        assert np.array_equal(host_t[n].numpy(), host_j[n])
    dst = [2, 5, 6, 11]
    cache.swap_in_pages(ours, host_t, dst)
    theirs = jcache.swap_in_pages(theirs, host_j, dst)
    for n in ("k", "v"):
        assert np.array_equal(ours[n].numpy(), np.asarray(theirs[n]))
        assert np.array_equal(ours[n].numpy()[:, dst], pool[n][:, pages])
    with pytest.raises(MigrationIncompatible, match="destination page"):
        cache.swap_in_pages(ours, host_t, dst[:3])
    bad = {n: t[:1] for n, t in host_t.items()}  # one layer: another geometry
    with pytest.raises(MigrationIncompatible, match="geometry"):
        cache.swap_in_pages(ours, bad, dst)


def test_swap_fault_falls_back_to_replay_same_tokens(fam):
    model = fam[3]
    ref_eng = Engine(model, device="cpu", handle_preemption=False, prefix_cache=False,
                     **PRESSURE_KW)
    ref, _ = run_script(ref_eng, _pressure_script(prompt_of(8, base=2), key=820))
    faults.reset("serve.swap:1:io")
    eng = Engine(model, device="cpu", handle_preemption=False, prefix_cache=False,
                 **PRESSURE_KW)
    got, _ = run_script(eng, _pressure_script(prompt_of(8, base=2), key=820))
    st = eng.stats()
    assert st["preemptions_swap"] == 0 and st["preemptions_replay"] >= 1
    assert [h.result() for h in got] == [h.result() for h in ref]
    assert eng.allocator.num_in_use == 0 and eng.allocator.num_swapped == 0


def test_cancel_swapped_slot_settles_every_page(fam):
    model = fam[3]
    eng = Engine(model, device="cpu", handle_preemption=False, prefix_cache=False,
                 **PRESSURE_KW)
    victim = eng.submit(prompt_of(8), max_new_tokens=26, key=830, priority=0)
    eng.step()
    urgent = eng.submit(prompt_of(8, base=2), max_new_tokens=26, key=831, priority=5)
    eng.step()
    assert eng.allocator.num_swapped > 0 and eng._swap_host_bytes > 0
    victim.cancel()
    eng.step()
    assert victim.done and isinstance(victim.error, RequestCancelled)
    assert eng.allocator.num_swapped == 0 and eng._swap_host_bytes == 0
    eng.drain()
    assert urgent.result() == solo(model, prompt_of(8, base=2), 831, 26)
    assert eng.allocator.num_in_use == 0


def test_shed_by_priority_matches_jax(fam):
    """``shed_policy="by-priority"`` under ``max_queue``: the same victims
    shed, the same arrivals refused."""
    outs = []
    for eng in engines(fam, scheduler="qos", shed_policy="by-priority", max_queue=2,
                       **ENGINE_KW):
        log = []
        hs = []
        for i, pr in enumerate([0, 2, 1, 0, 3, 1]):
            try:
                hs.append(eng.submit(prompt_of(4, base=i + 1), max_new_tokens=4, key=i,
                                     priority=pr))
                log.append(("ok", i))
            except (EngineOverloaded, JaxOverloaded):
                log.append(("refused", i))
        eng.drain()
        log += [(type(h.error).__name__ if h.error else "done", h.rid) for h in hs]
        outs.append(log)
        eng.close()
    assert outs[0] == outs[1]


def test_qos_knob_validation(fam):
    model = fam[3]
    with pytest.raises(ValueError, match="tenant_weights needs"):
        Engine(model, device="cpu", tenant_weights={"a": 2.0}, **ENGINE_KW)
    with pytest.raises(ValueError, match="by-priority"):
        Engine(model, device="cpu", shed_policy="by-priority", **ENGINE_KW)
    with pytest.raises(ValueError, match="preempt_mechanism"):
        Engine(model, device="cpu", scheduler="qos", preempt_mechanism="x", **ENGINE_KW)
    with pytest.raises(ValueError, match="weights must be > 0"):
        Engine(model, device="cpu", scheduler="qos", tenant_weights={"a": 0}, **ENGINE_KW)
