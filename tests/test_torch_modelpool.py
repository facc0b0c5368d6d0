"""The port's model plane against JAX's on the CPU, after
``tests/test_modelpool.py``.

A skeleton recorded by the port's ``deferred_init(..., device_="cuda")``
registers at 0 bytes (the ledger's total does not move) with its geometry
read from its shapes; an incompatible page geometry is refused at register
time; a model materialized on demand (the skeleton's seeded replay) streams
exactly what an engine built directly on the same seeded weights streams.
With JAX's weights carried in by a ``materialize=`` factory, the pool
evicts and re-materializes in JAX's order under ``max_resident`` and its
greedy streams equal JAX's pool engine's.  A live model is never evicted;
the same prompt under two models gives distinct digests and no shared
prefix page; a ``serve.materialize`` io fault retries next tick.
Tolerance: none (exact).
"""

import jax
import numpy as np
import pytest

from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.serving import Engine as JaxEngine
from torchdistx_tpu.serving import ModelPool as JaxPool
from torchdistx_tpu_torch.deferred_init import deferred_init, is_deferred
from torchdistx_tpu_torch.materialize import materialize_module_torch
from torchdistx_tpu_torch.models import gpt2 as tgpt2
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import llama_from_jax_params
from torchdistx_tpu_torch.resilience import faults, preemption
from torchdistx_tpu_torch.serving import DEFAULT_MODEL, Engine, ModelPool
from torchdistx_tpu_torch.telemetry import perf

from _torch_serving_planes import load, prompt_of

EOS = 5
ENGINE_KW = dict(num_slots=4, block_size=8, num_blocks=41, max_model_len=64, decode_chunk=4,
                 eos_id=EOS, handle_preemption=False)


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


def skeleton(cls=tllama.Llama, cfg=None):
    return deferred_init(cls, cfg or tllama.llama_test(), device_="cuda")


def jax_weights(seed):
    """A ``materialize=`` factory: JAX's ``init_params(PRNGKey(seed))`` as a
    port module on the CPU, and the JAX pool's factory for the same."""
    cfg = jllama.llama_test()
    params = jllama.init_params(jax.random.PRNGKey(seed), cfg)
    port = lambda: llama_from_jax_params(jax.tree.map(np.asarray, params),  # noqa: E731
                                         tllama.llama_test(), device="cpu")
    return port, (lambda: params)


def settled(eng):
    assert eng.allocator.num_in_use == (len(eng.prefix) if eng.prefix is not None else 0)


def test_skeleton_registers_at_zero_bytes(fam):
    eng = Engine(fam[3], device="cpu", model_pool=ModelPool(), **ENGINE_KW)
    before = perf.ledger.total()
    sk = skeleton()
    eng.model_pool.register("tuna", module=sk, seed=1)
    eng.model_pool.register("bass", module=skeleton(), seed=2)
    assert perf.ledger.total() == before  # nothing materialized, nothing on the ledger
    assert all(is_deferred(p) for p in sk.parameters())  # fake: 0 bytes anywhere
    g = eng.model_pool.geometry("tuna")
    n_params = sum(p.numel() for p in sk.parameters())
    assert g == {"tag": "tuna", "version": "tuna", "materialized": False,
                 "n_leaves": len(list(sk.parameters())), "n_params": n_params,
                 "nbytes": n_params * 4}
    assert eng.model_pool.resident() == [] and not eng.model_pool.ready("tuna")
    with pytest.raises(ValueError):
        eng.model_pool.register(DEFAULT_MODEL, module=skeleton())
    with pytest.raises(ValueError, match="already registered"):
        eng.model_pool.register("tuna", module=skeleton())
    eng.close()


def test_geometry_mismatch_refused_at_register(fam):
    bad = ModelPool()
    bad.register("wrong", module=skeleton(tgpt2.GPT2, tgpt2.gpt2_test()))
    with pytest.raises(ValueError, match="geometry"):
        Engine(fam[3], device="cpu", model_pool=bad, **ENGINE_KW)
    pool = ModelPool()
    eng = Engine(fam[3], device="cpu", model_pool=pool, **ENGINE_KW)
    with pytest.raises(ValueError, match="geometry"):
        pool.register("wrong", module=skeleton(tgpt2.GPT2, tgpt2.gpt2_test()))
    assert "wrong" not in pool
    with pytest.raises(ValueError, match="already bound"):
        Engine(fam[3], device="cpu", model_pool=pool, **ENGINE_KW)
    with pytest.raises(ValueError, match="not registered"):
        eng.submit(prompt_of(8), max_new_tokens=4, model="ghost")
    eng.close()


def test_on_demand_stream_equals_an_engine_on_the_seeded_weights(fam):
    """The pool's default materialize is the skeleton's seeded replay: its
    stream equals an engine built on ``materialize_module_torch(seed=)``."""
    direct = skeleton()
    direct.load_state_dict(materialize_module_torch(direct, seed=3, device="cpu"), assign=True)
    ref_eng = Engine(direct, device="cpu", **ENGINE_KW)
    ref = [ref_eng.submit(prompt_of(8 + i, base=10), max_new_tokens=8, key=i).result()
           for i in range(3)]
    ref_eng.close()
    pool = ModelPool()
    sk = skeleton()
    pool.register("tuna", module=sk, seed=3)
    eng = Engine(fam[3], device="cpu", model_pool=pool, **ENGINE_KW)
    hs = [eng.submit(prompt_of(8 + i, base=10), max_new_tokens=8, key=i, model="tuna")
          for i in range(3)]
    assert not pool.ready("tuna")
    eng.drain()
    assert [h.result() for h in hs] == ref
    entry = pool._entries["tuna"]
    assert pool.stats()["models"]["tuna"]["materializations"] == 1
    assert entry.last_stall_s is not None and entry.last_stall_s > 0
    # The weights row holds the parameters and their prep_decode copy.
    want = sum(t.numel() * 4 for t in entry.model.parameters()) + sum(
        t.numel() * 4 for ts in entry.weights.values() for t in ts)
    assert perf.ledger.owners("weights")[("weights", f"model:{eng.engine_id}:tuna")] == want
    assert all(is_deferred(p) for p in sk.parameters())  # the skeleton is untouched
    settled(eng)
    eng.close()
    assert ("weights", f"model:{eng.engine_id}:tuna") not in perf.ledger.owners()


def test_eviction_order_and_streams_match_jax(fam):
    """``max_resident=1`` over three models and alternating demand: the
    resident set after each request, the materialize / evict counts and
    the greedy streams equal JAX's pool engine's on JAX's weights."""
    jmod, cfg, params, model = fam
    tags = {"tuna": 1, "bass": 2, "carp": 3}
    traffic = ["tuna", "bass", "tuna", None, "carp", "carp", "bass", "tuna"]
    runs = []
    for side in ("jax", "port"):
        if side == "jax":
            pool = JaxPool(max_resident=1)
            for tag, seed in tags.items():
                pool.register(tag, model=jmod, cfg=cfg, materialize=jax_weights(seed)[1])
            eng = JaxEngine(params, model=jmod, cfg=cfg, model_pool=pool, **ENGINE_KW)
        else:
            pool = ModelPool(max_resident=1)
            for tag, seed in tags.items():
                pool.register(tag, module=skeleton(), materialize=jax_weights(seed)[0])
            eng = Engine(model, device="cpu", model_pool=pool, **ENGINE_KW)
        log = []
        for i, tag in enumerate(traffic):
            toks = eng.submit(prompt_of(9, base=20 + i), max_new_tokens=6, key=i,
                              model=tag).result()
            log.append((toks, sorted(pool.resident())))
        st = pool.stats()["models"]
        log.append({t: (st[t]["materializations"], st[t]["evictions"]) for t in tags})
        runs.append(log)
        eng.close()
    assert runs[1] == runs[0]


def test_live_model_is_never_evicted(fam):
    pool = ModelPool(max_resident=1)
    t_port, _ = jax_weights(1)
    b_port, _ = jax_weights(2)
    pool.register("tuna", module=skeleton(), materialize=t_port)
    pool.register("bass", module=skeleton(), materialize=b_port)
    eng = Engine(fam[3], device="cpu", model_pool=pool, **ENGINE_KW)
    live = eng.submit(prompt_of(8, base=10), max_new_tokens=24, key=3, model="tuna")
    while not live._tokens:
        eng.step()
    assert pool.evict("tuna") is False  # pinned by its slot
    other = eng.submit(prompt_of(32, base=100), max_new_tokens=8, key=0, model="bass")
    got = live.result()
    other.result()
    assert pool.stats()["models"]["tuna"]["evictions"] == 0
    assert set(pool.resident()) == {"tuna", "bass"}
    ref_eng = Engine(t_port(), device="cpu", **ENGINE_KW)
    assert got == ref_eng.submit(prompt_of(8, base=10), max_new_tokens=24, key=3).result()
    ref_eng.close()
    settled(eng)
    eng.close()


def test_models_never_share_digests_or_prefix_pages(fam):
    pool = ModelPool()
    pool.register("tuna", module=skeleton(), seed=1)
    pool.register("bass", module=skeleton(), seed=2)
    eng = Engine(fam[3], device="cpu", model_pool=pool, **ENGINE_KW)
    long = prompt_of(16, base=30)  # two full pages
    digests = {}
    for tag in (None, "tuna", "bass"):
        h = eng.submit(long, max_new_tokens=4, key=0, model=tag)
        h.result()
        digests[tag] = h.digest
    assert len(set(digests.values())) == 3
    assert eng.prefix.hits == 0  # the same tokens under three models: no hit
    eng.submit(long, max_new_tokens=4, key=0, model="tuna").result()
    assert eng.prefix.hits == 1
    settled(eng)
    eng.close()


def test_materialize_io_fault_retries_next_tick(fam):
    pool = ModelPool()
    pool.register("tuna", module=skeleton(), seed=1)
    eng = Engine(fam[3], device="cpu", model_pool=pool, **ENGINE_KW)
    faults.reset("serve.materialize:1:io")
    got = eng.submit(prompt_of(8, base=10), max_new_tokens=8, key=0, model="tuna").result()
    faults.reset("")
    assert pool.materialize_retries == 1
    assert pool.stats()["models"]["tuna"]["materializations"] == 1
    pool2 = ModelPool()
    pool2.register("tuna", module=skeleton(), seed=1)
    eng2 = Engine(fam[3], device="cpu", model_pool=pool2, **ENGINE_KW)
    assert eng2.submit(prompt_of(8, base=10), max_new_tokens=8, key=0,
                       model="tuna").result() == got
    eng.close()
    eng2.close()


def test_hbm_budget_evicts_by_the_ledger(fam):
    """A budget over what is held plus one model (read from the ledger's
    rows) keeps one pool model resident: the second demand evicts the
    first, its decode graph dropped with it."""
    pool = ModelPool()
    pool.register("tuna", module=skeleton(), seed=1)
    pool.register("bass", module=skeleton(), seed=2)
    eng = Engine(fam[3], device="cpu", model_pool=pool, **ENGINE_KW)
    one = pool._entries["tuna"].nbytes_estimate
    pool.hbm_budget_bytes = sum(perf.ledger.owners().values()) + 2 * one
    eng.submit(prompt_of(8), max_new_tokens=4, key=0, model="tuna").result()
    assert any(g[-1] == "tuna" for g in eng._decoders)
    eng.submit(prompt_of(8), max_new_tokens=4, key=0, model="bass").result()
    assert pool.resident() == ["bass"]
    assert pool.stats()["models"]["tuna"]["evictions"] == 1
    assert not any(g[-1] == "tuna" for g in eng._decoders)
    assert eng.stats()["models"]["n_resident"] == 1
    eng.close()
