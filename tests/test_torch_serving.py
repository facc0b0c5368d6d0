"""The port's serving engine on the CPU, mirroring ``tests/test_serving.py``.

The greedy engine is token-identical to the JAX ``Engine`` on the same
weights (``llama_test`` and ``gpt2_test`` in f32, out-of-order admission,
slot recycling, the prefix cache with a copy-on-write hit, chunked
prefill), and to the port's solo ``generate``; the sampled engine is
token-identical to the port's ``generate(key=)`` (JAX's threefry draws are
not reproduced, by design).  The allocator's page ids match JAX's for the
same operations.  Faults, the recovery supervisor (pages overwritten with
garbage), its budget and the replay digest check are driven through the
public surface.  Engines over one model share its fused decode weights
only while its parameters are unchanged, and the shared copy leaves with
the last engine holding it.
"""

import copy
import gc

import jax
import numpy as np
import pytest
import torch

from torchdistx_tpu.models import gpt2 as jgpt2
from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.serving import BlockAllocator as JaxBlockAllocator
from torchdistx_tpu.serving import Engine as JaxEngine
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.telemetry import perf
from torchdistx_tpu_torch.models import gpt2 as tgpt2
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import gpt2_from_jax_params, llama_from_jax_params
from torchdistx_tpu_torch.models.generate import generate, keyed_uniform, sample_keyed
from torchdistx_tpu_torch.resilience import faults, preemption
from torchdistx_tpu_torch.serving import (
    BlockAllocator,
    DeterminismDiverged,
    Engine,
    Health,
    RecoveryFailed,
    blocks_needed,
)
from torchdistx_tpu_torch.serving import engine as eng_mod

EOS = 5
SAMPLED = dict(temperature=0.8, top_k=20)
# The JAX serving tests' geometry (tests/test_serving.py ENGINE_KW).
ENGINE_KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 prefix_cache=False, device="cpu")


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    yield
    preemption.clear()
    faults.reset("")


FAMILIES = {
    "llama": (jllama, jllama.llama_test, tllama.llama_test, llama_from_jax_params),
    "gpt2": (jgpt2, jgpt2.gpt2_test, tgpt2.gpt2_test, gpt2_from_jax_params),
}


def _load(name):
    jmod, jcfg_fn, tcfg_fn, convert = FAMILIES[name]
    cfg = jcfg_fn()
    params = jmod.init_params(jax.random.PRNGKey(0), cfg)
    return jmod, cfg, params, convert(jax.tree.map(np.asarray, params), tcfg_fn(), device="cpu")


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    return _load(request.param)


@pytest.fixture(scope="module")
def llama_model():
    return _load("llama")[3]


def solo(model, prompt, key, max_new, *, eos=None, **sample):
    """Reference: the port's solo generate, truncated at the first EOS
    (inclusive) as a finished stream is."""
    out = generate(model, torch.as_tensor(np.asarray(prompt, np.int64))[None],
                   max_new_tokens=max_new, eos_id=eos, key=key, **sample)
    toks = out[0].tolist()
    if eos is not None and eos in toks:
        toks = toks[: toks.index(eos) + 1]
    return toks


def mixed_requests(rng, vocab, n, budgets=(5, 9, 16)):
    reqs = []
    for i in range(n):
        plen = int(rng.integers(3, 16))
        mnt = int(rng.choice(budgets))
        reqs.append((rng.integers(0, vocab, size=plen).astype(np.int32), mnt, i))
    return reqs


def _drive(eng, reqs, key_base=0):
    handles = [eng.submit(p, max_new_tokens=m, key=key_base + k) for p, m, k in reqs]
    eng.drain()
    return [h.result() for h in handles]


# ---------------------------------------------------------------------------
# Block allocator


def test_allocator_invariants():
    a = BlockAllocator(num_blocks=8, block_size=4)
    assert a.capacity == 7
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert a.alloc(5) is None and a.num_in_use == 3  # no partial grant
    a.share(got)
    a.free(got)
    assert a.num_in_use == 3  # the shared references survive
    a.free(got)
    assert a.num_in_use == 0 and a.num_free == 7
    with pytest.raises(RuntimeError, match="not in use"):
        a.free(got)
    with pytest.raises(RuntimeError, match="stray share"):
        a.share([0])
    assert blocks_needed(9, 8) == 2


def test_allocator_page_ids_match_jax():
    """The same random alloc / share / free / reset sequence gives the same
    page ids, refcounts and free counts as the JAX allocator."""
    rng = np.random.default_rng(3)
    ours, theirs = BlockAllocator(17, 4), JaxBlockAllocator(17, 4)
    held = []
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0 or not held:
            n = int(rng.integers(0, 5))
            got = ours.alloc(n)
            assert got == theirs.alloc(n)
            if got:
                held.append(got)
        elif op == 1:
            pages = held[int(rng.integers(0, len(held)))]
            ours.share(pages)
            theirs.share(pages)
            held.append(list(pages))
        elif op == 2:
            pages = held.pop(int(rng.integers(0, len(held))))
            ours.free(pages)
            theirs.free(pages)
        elif rng.random() < 0.05:
            ours.reset()
            theirs.reset()
            held.clear()
        assert ours.num_free == theirs.num_free and ours.num_in_use == theirs.num_in_use
        assert {p: ours.refcount(p) for p in range(17)} == {
            p: theirs.refcount(p) for p in range(17)}
        assert ours.fragmentation() == theirs.fragmentation()


# ---------------------------------------------------------------------------
# Engine against the JAX engine and against solo generate


def test_greedy_engine_matches_jax_engine(family):
    """6 mixed requests on 2 slots (out-of-order retirement, slot recycling)
    plus 3 sharing a 16-token prefix (two prefix hits, one of them a
    full-prompt hit that copies its last shared page on write), with
    chunked prefill: every stream equals the JAX engine's, and the prefix
    counters agree."""
    jmod, cfg, params, model = family
    rng = np.random.default_rng(0)
    reqs = mixed_requests(rng, cfg.vocab_size, 6)
    system = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    tail = rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
    reqs += [(np.concatenate([system, tail]), 9, 6), (system, 9, 7),
             (np.concatenate([system, tail[:2]]), 5, 8)]
    kw = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4, eos_id=EOS,
              prefix_cache=True, prefill_chunk=8, min_prefill_bucket=4)
    jeng = JaxEngine(params, model=jmod, cfg=cfg, **kw)
    want = _drive(jeng, reqs)
    eng = Engine(model, device="cpu", **kw)
    got = _drive(eng, reqs)
    assert got == want
    for name in ("prefix_hits", "prefix_hit_tokens", "cow_copies", "decode_tokens"):
        assert eng.stats()[name] == jeng.stats()[name], name
    assert eng.stats()["prefix_hits"] == 2 and eng.stats()["cow_copies"] >= 1
    assert eng.allocator.num_in_use == len(eng.prefix)
    assert eng.prefix.check(eng.allocator) is None
    for (prompt, mnt, key), toks in zip(reqs, got):
        assert toks == solo(model, prompt, key, mnt, eos=EOS), f"request {key}"


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_engine_matches_solo_generate(family, sampled):
    _, cfg, _, model = family
    sample = SAMPLED if sampled else {}
    reqs = mixed_requests(np.random.default_rng(1), cfg.vocab_size, 6)
    eng = Engine(model, eos_id=EOS, **sample, **ENGINE_KW)
    got = _drive(eng, reqs, key_base=100)
    for (prompt, mnt, key), toks in zip(reqs, got):
        assert toks == solo(model, prompt, 100 + key, mnt, eos=EOS, **sample), f"request {key}"
    assert eng.allocator.num_in_use == 0


@pytest.mark.parametrize("chunk", [1, 4])
def test_decode_chunk_sizes_agree(llama_model, chunk):
    """The decode chunk run eagerly at 1 and 4 steps a host sync gives the
    same streams (sampled: the keyed schedule is chunk-independent)."""
    reqs = mixed_requests(np.random.default_rng(2), 256, 4)
    eng = Engine(llama_model, eos_id=EOS, **SAMPLED, **{**ENGINE_KW, "decode_chunk": chunk})
    got = _drive(eng, reqs, key_base=40)
    for (prompt, mnt, key), toks in zip(reqs, got):
        assert toks == solo(llama_model, prompt, 40 + key, mnt, eos=EOS, **SAMPLED)
    assert eng.stats()["decode_graphs"] == 0  # no graph off CUDA


# ---------------------------------------------------------------------------
# The keyed sampler


def test_sampler_is_batch_and_slot_independent():
    """A row's draw depends on its key and step alone: the same rows in
    another order, batch size or alongside other rows give the same
    tokens, and keyed_uniform matches element for element."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32))
    keys = torch.from_numpy(rng.integers(0, 2**32, size=(6, 2)).astype(np.int64))
    steps = torch.from_numpy(rng.integers(0, 100, size=6).astype(np.int64))
    full = sample_keyed(logits, keys, steps, 0.8, 20)
    perm = torch.from_numpy(rng.permutation(6))
    np.testing.assert_array_equal(sample_keyed(logits[perm], keys[perm], steps[perm], 0.8, 20),
                                  full[perm])
    for i in range(6):
        one = sample_keyed(logits[i:i + 1], keys[i:i + 1], steps[i:i + 1], 0.8, 20)
        assert int(one) == int(full[i])
        np.testing.assert_array_equal(keyed_uniform(keys[i:i + 1], steps[i:i + 1], 50),
                                      keyed_uniform(keys, steps, 50)[i:i + 1])
    u = keyed_uniform(keys, steps, 50)
    assert (u > 0).all() and (u < 1).all()
    # Another step or key draws differently; greedy is argmax.
    assert not torch.equal(keyed_uniform(keys, steps + 1, 50), u)
    np.testing.assert_array_equal(sample_keyed(logits, keys, steps, 0.0, None),
                                  logits.argmax(-1))


def test_sampler_frequencies_match_softmax():
    """20,000 keys at one step over fixed logits: the counts against
    softmax(logits / 0.8) by chi-square.  7 degrees of freedom; 24.32 is
    the 0.001 quantile's bound, and the draws are a fixed function of the
    keys, so the statistic is the same every run.  With top_k=3 nothing
    outside the top 3 is ever drawn."""
    logits = torch.tensor([[1.0, 0.5, 2.0, -1.0, 0.0, 1.5, -0.5, 0.3]])
    n = 20000
    keys = torch.stack([torch.zeros(n, dtype=torch.int64), torch.arange(n)], dim=1)
    steps = torch.full((n,), 3, dtype=torch.int64)
    toks = sample_keyed(logits.expand(n, 8), keys, steps, 0.8, None)
    counts = torch.bincount(toks, minlength=8).double()
    expect = torch.softmax(logits[0].double() / 0.8, 0) * n
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 24.32, (chi2, counts.tolist(), expect.tolist())
    top = sample_keyed(logits.expand(n, 8), keys, steps, 0.8, 3)
    assert set(top.tolist()) == {0, 2, 5}


# ---------------------------------------------------------------------------
# Streaming, backpressure, admission


def test_streaming_is_incremental(llama_model):
    eng = Engine(llama_model, **ENGINE_KW)
    prompt = np.arange(1, 9, dtype=np.int32)
    h = eng.submit(prompt, max_new_tokens=12, key=0)
    it = h.tokens()
    first = next(it)
    assert isinstance(first, int) and not h.done
    assert [first] + list(it) == solo(llama_model, prompt, 0, 12)


def test_backpressure_not_crash(llama_model):
    before = telemetry.counter("serve.backpressure").value
    eng = Engine(llama_model, device="cpu", num_slots=4, block_size=8, num_blocks=5,
                 max_model_len=32, decode_chunk=2, prefix_cache=False)
    handles = [eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8, key=i)
               for i in range(3)]
    eng.drain()
    assert all(len(h.result()) == 8 for h in handles)
    assert telemetry.counter("serve.backpressure").value > before
    assert eng.allocator.num_in_use == 0


def test_rejects_oversized_request(llama_model):
    eng = Engine(llama_model, device="cpu", num_slots=1, block_size=8, max_model_len=32)
    with pytest.raises(ValueError, match="max_model_len"):
        eng.submit(np.zeros(30, np.int32), max_new_tokens=30)
    eng2 = Engine(llama_model, device="cpu", num_slots=1, block_size=8, num_blocks=3,
                  max_model_len=32)
    with pytest.raises(ValueError, match="num_blocks"):
        eng2.submit(np.zeros(20, np.int32), max_new_tokens=10)
    with pytest.raises(ValueError, match="max_seq_len"):
        Engine(llama_model, device="cpu", max_model_len=10**6)


# ---------------------------------------------------------------------------
# Prefix cache + chunked prefill


def _shared_prefix(vocab, n=4):
    rng = np.random.default_rng(7)
    system = rng.integers(0, vocab, size=16).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, vocab, size=5).astype(np.int32)])
            for _ in range(n)]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_prefix_cache_token_identical(llama_model, sampled):
    sample = SAMPLED if sampled else {}
    prompts = _shared_prefix(256)
    reqs = [(p, 9, i) for i, p in enumerate(prompts)]
    results = {}
    for cache_on in (False, True):
        eng = Engine(llama_model, eos_id=EOS, **sample, **{**ENGINE_KW, "prefix_cache": cache_on})
        results[cache_on] = _drive(eng, reqs, key_base=200)
        if cache_on:
            st = eng.stats()
            assert st["prefix_hits"] >= len(prompts) - 1, st
            assert st["prefix_hit_tokens"] >= (len(prompts) - 1) * 16, st
            assert eng.prefix.check(eng.allocator) is None
            assert eng.allocator.num_in_use == len(eng.prefix)
            eng.prefix.release(eng.allocator)
        assert eng.allocator.num_in_use == 0
    for i, p in enumerate(prompts):
        ref = solo(llama_model, p, 200 + i, 9, eos=EOS, **sample)
        assert results[False][i] == ref and results[True][i] == ref, i


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_chunked_prefill_token_identical(llama_model, sampled):
    sample = SAMPLED if sampled else {}
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, 256, size=n).astype(np.int32), 9, i)
            for i, n in enumerate((19, 32, 7))]
    for chunk in (4, 512):
        eng = Engine(llama_model, eos_id=EOS, prefill_chunk=chunk, min_prefill_bucket=4,
                     **sample, **ENGINE_KW)
        for (p, mnt, i), toks in zip(reqs, _drive(eng, reqs, key_base=300)):
            assert toks == solo(llama_model, p, 300 + i, mnt, eos=EOS, **sample), (chunk, i)
        assert eng.allocator.num_in_use == 0


def test_chunked_prefill_interleaves_decode(llama_model):
    eng = Engine(llama_model, device="cpu", num_slots=2, block_size=8, max_model_len=64,
                 decode_chunk=2, prefill_chunk=4, min_prefill_bucket=4, prefix_cache=False)
    running = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=40, key=0)
    eng.step()
    emitted_before = len(running._tokens)
    long = eng.submit(np.random.default_rng(3).integers(0, 256, size=32).astype(np.int32),
                      max_new_tokens=4, key=1)
    progress = []
    while long.ttft_s is None:
        eng.step()
        progress.append(len(running._tokens))
    assert len(progress) >= 8
    assert progress[0] > emitted_before
    assert all(b > a for a, b in zip(progress, progress[1:])), progress
    eng.drain()
    assert running.result() == solo(llama_model, np.arange(1, 7), 0, 40)


def test_cow_divergence_mid_page(llama_model):
    before = telemetry.counter("serve.cow_copies").value
    eng = Engine(llama_model, eos_id=EOS, **SAMPLED, **{**ENGINE_KW, "prefix_cache": True})
    prompt = np.random.default_rng(23).integers(0, 256, size=16).astype(np.int32)
    ha = eng.submit(prompt, max_new_tokens=8, key=400)
    eng.drain()
    hb = eng.submit(prompt, max_new_tokens=8, key=401)
    hc = eng.submit(prompt, max_new_tokens=8, key=402)
    eng.drain()
    st = eng.stats()
    assert st["prefix_hits"] == 2 and st["cow_copies"] == 2, st
    assert telemetry.counter("serve.cow_copies").value == before + 2
    for h, key in ((ha, 400), (hb, 401), (hc, 402)):
        assert h.result() == solo(llama_model, prompt, key, 8, eos=EOS, **SAMPLED), key
    # The shared pages were never written: a divergent tail still hits the
    # intact first page only.
    tail = np.concatenate([prompt[:12], prompt[:9]]).astype(np.int32)
    hd = eng.submit(tail, max_new_tokens=8, key=403)
    eng.drain()
    assert hd.result() == solo(llama_model, tail, 403, 8, eos=EOS, **SAMPLED)
    assert eng.stats()["prefix_hits"] == 3
    assert eng.prefix.check(eng.allocator) is None


def test_prefix_eviction_under_pressure(llama_model):
    eng = Engine(llama_model, device="cpu", num_slots=2, block_size=8, num_blocks=10,
                 max_model_len=64, decode_chunk=4, prefix_cache=True)
    rng = np.random.default_rng(29)
    reqs = [(rng.integers(0, 256, size=8).astype(np.int32), 16, i) for i in range(8)]
    got = _drive(eng, reqs, key_base=500)
    assert eng.stats()["prefix_evictions"] >= 1
    for (p, mnt, i), toks in zip(reqs, got):
        assert toks == solo(llama_model, p, 500 + i, mnt)
    assert eng.prefix.check(eng.allocator) is None
    assert eng.allocator.num_in_use == len(eng.prefix)
    eng.close()
    assert eng.allocator.num_in_use == 0


def test_stats_and_telemetry_spans(llama_model):
    prev = telemetry.configure(collect=True)
    try:
        eng = Engine(llama_model, **ENGINE_KW)
        for i in range(3):
            eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=6, key=i)
        eng.drain()
        st = eng.stats()
        assert st["requests"] == 3 and st["running"] == 0
        assert st["decode_tokens_per_s"] > 0
        assert 0 <= st["ttft_p50_s"] <= st["ttft_p95_s"]
        assert st["tpot_p50_s"] > 0
        snap = telemetry.snapshot()
        assert {"serve.prefill", "serve.step"} <= {s["name"] for s in snap["spans"]}
        assert snap["counters"]["serve.tokens_out"] >= 18
        assert snap["gauges"]["serve.health"] == "ready"
    finally:
        telemetry.configure(**prev)


# ---------------------------------------------------------------------------
# Fault sites, the supervisor, the digest check


@pytest.mark.parametrize("spec, counter, delta", [
    ("serve.step:2:nan", "serve.skipped_steps", 1),
    ("serve.step:2:io", "serve.step_retries", 1),
    ("serve.step:2:io,serve.step:3:io", "serve.recoveries", 1),
    ("serve.prefill:1:io", "serve.prefill_retries", 1),
    ("serve.prefill:2:nan", "serve.prefill_retries", 1),
    ("serve.admit:2:io", "serve.admit_retries", 1),
], ids=["step_nan", "step_io", "step_io_twice", "prefill_io", "prefill_nan", "admit_io"])
def test_fault_sites_stay_token_identical(llama_model, spec, counter, delta):
    """A poisoned chunk is skipped, an io fault retried (two consecutive
    decode failures go to the supervisor), and every stream still equals
    solo generate."""
    before = telemetry.counter(counter).value
    faults.reset(spec)
    eng = Engine(llama_model, eos_id=EOS, **ENGINE_KW)
    prompts = [np.arange(1, 7, dtype=np.int32) + i for i in range(3)]
    handles = [eng.submit(p, max_new_tokens=9, key=i) for i, p in enumerate(prompts)]
    eng.drain()
    for i, (p, h) in enumerate(zip(prompts, handles)):
        assert h.result() == solo(llama_model, p, i, 9, eos=EOS)
    assert telemetry.counter(counter).value == before + delta
    assert eng.allocator.num_in_use == 0


@pytest.mark.parametrize("site", ["serve.step", "serve.prefill"])
def test_fault_fatal_propagates(llama_model, site):
    faults.reset(f"{site}:1:fatal")
    eng = Engine(llama_model, **ENGINE_KW)
    eng.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=4, key=0)
    with pytest.raises(faults.FatalInjectedFault):
        eng.drain()


def test_failed_prefill_frees_reservation_and_retries(llama_model, monkeypatch):
    eng = Engine(llama_model, **ENGINE_KW)
    real = eng_mod.Engine._run_chunk

    def boom(self, *a, **k):
        raise RuntimeError("injected prefill failure")

    monkeypatch.setattr(eng_mod.Engine, "_run_chunk", boom)
    h = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8, key=0)
    for _ in range(3):
        eng.step()
        assert eng.allocator.num_in_use == 0, "a failed prefill leaked pages"
    assert h.done and isinstance(h.error, RecoveryFailed)
    with pytest.raises(RecoveryFailed):
        h.result()
    flaky = {"left": 1}

    def boom_once(self, *a, **k):
        if flaky["left"]:
            flaky["left"] -= 1
            raise RuntimeError("injected prefill failure")
        return real(self, *a, **k)

    monkeypatch.setattr(eng_mod.Engine, "_run_chunk", boom_once)
    h2 = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8, key=7)
    eng.drain()
    assert h2.result() == solo(llama_model, np.arange(1, 9), 7, 8)
    assert eng.allocator.num_in_use == 0


def _garbage_dispatch(failures, error):
    """A decode dispatch that overwrites every live page with garbage and
    raises, ``failures`` times; then the real one."""
    real = eng_mod.DecodeChunk.__call__
    state = {"left": failures}

    def dispatch(self, *a, **k):
        if state["left"]:
            state["left"] -= 1
            for pool in self.cache.values():
                pool[:, 1:].normal_(0.0, 50.0)
            raise error
        return real(self, *a, **k)

    return dispatch


@pytest.mark.parametrize("failures, error", [
    (1, RuntimeError("CUDA error: an illegal memory access was encountered")),
    (2, RuntimeError("injected dispatch failure")),
], ids=["cuda_error", "twice"])
def test_supervisor_replays_after_pages_overwritten(llama_model, monkeypatch, failures, error):
    """A dispatch that scribbles on live pages: a CUDA error (or a second
    consecutive failure) goes to the supervisor, which zeroes the pool in
    place and replays; every stream (sampled) finishes token-identical."""
    before = telemetry.counter("serve.recoveries").value
    eng = Engine(llama_model, **SAMPLED, **ENGINE_KW)
    h1 = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=16, key=0)
    h2 = eng.submit(np.arange(2, 8, dtype=np.int32), max_new_tokens=9, key=1)
    eng.step()
    eng.step()
    assert not h1.done and len(h1._tokens) > 1
    pool_k = eng._cache["k"]
    monkeypatch.setattr(eng_mod.DecodeChunk, "__call__", _garbage_dispatch(failures, error))
    eng.drain()
    assert eng._cache["k"] is pool_k  # zeroed in place, never replaced
    assert h1.result() == solo(llama_model, np.arange(1, 9), 0, 16, **SAMPLED)
    assert h2.result() == solo(llama_model, np.arange(2, 8), 1, 9, **SAMPLED)
    assert telemetry.counter("serve.recoveries").value == before + 1
    assert eng.allocator.num_in_use == 0
    assert eng.health() is Health.READY


def test_recovery_budget_exhausts_typed(llama_model, monkeypatch):
    eng = Engine(llama_model, max_recoveries=1, **ENGINE_KW)
    h = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8, key=0)
    eng.step()
    assert not h.done

    def die(self, *a, **k):
        raise RuntimeError("persistent device failure")

    monkeypatch.setattr(eng_mod.DecodeChunk, "__call__", die)
    for _ in range(8):
        if h.done:
            break
        eng.step()
    assert h.done and isinstance(h.error, RecoveryFailed) and h.error.retryable
    assert eng.allocator.num_in_use == 0


def test_replay_digest_check_fails_corrupted_stream(llama_model, monkeypatch):
    """A committed buffer corrupted before a replay fails its request typed
    (DeterminismDiverged) and latches the engine; the other stream replays
    token-identically."""
    before = telemetry.counter("audit.divergences").value
    eng = Engine(llama_model, **ENGINE_KW)
    bad = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=16, key=0)
    good = eng.submit(np.arange(2, 8, dtype=np.int32), max_new_tokens=9, key=1)
    eng.step()
    eng.step()
    bad._tokens[0] ^= 1  # the host buffer no longer matches the digest
    monkeypatch.setattr(eng_mod.DecodeChunk, "__call__", _garbage_dispatch(
        1, RuntimeError("CUDA error: an illegal memory access was encountered")))
    eng.drain()
    assert isinstance(bad.error, DeterminismDiverged) and not bad.error.retryable
    assert good.result() == solo(llama_model, np.arange(2, 8), 1, 9)
    assert telemetry.counter("audit.divergences").value == before + 1
    assert eng.stats()["diverging"] and eng.health() is Health.OVERLOADED
    eng.clear_divergence()
    eng.step()
    assert eng.health() is Health.READY
    assert eng.allocator.num_in_use == 0


def test_corrupt_fault_changes_digest_only(llama_model):
    """``serve.step:k:corrupt`` flips one committed token on the host: the
    stream's digest then differs from a clean run's."""
    prompt = np.arange(1, 9, dtype=np.int32)
    clean = Engine(llama_model, **ENGINE_KW).submit(prompt, max_new_tokens=8, key=0)
    clean.result()
    faults.reset("serve.step:1:corrupt")
    h = Engine(llama_model, **ENGINE_KW).submit(prompt, max_new_tokens=8, key=0)
    toks = h.result()
    assert toks[1] == clean.result()[1] ^ 1 and h.digest != clean.digest


# ---------------------------------------------------------------------------
# The shared decode copy


def test_decode_copy_shared_while_weights_unchanged(llama_model):
    """Two live engines over one model hold one decode copy and one ledger
    row for it; both leave with the last engine, and a drained engine that
    is dropped without ``close()`` releases its copy when collected."""
    model = copy.deepcopy(llama_model)
    a, b = Engine(model, **ENGINE_KW), Engine(model, **ENGINE_KW)
    assert a._weights is b._weights
    owner = a._decode_copy.owner
    assert ("weights", owner) in perf.ledger.owners("weights")
    a.close()
    assert ("weights", owner) in perf.ledger.owners("weights")
    b.close()
    assert ("weights", owner) not in perf.ledger.owners("weights")
    assert eng_mod._DECODE_COPIES[model]() is None

    c = Engine(model, **ENGINE_KW)
    c.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=5, key=0)
    c.drain()
    del c
    gc.collect()
    assert eng_mod._DECODE_COPIES[model]() is None


def test_decode_copy_refused_after_weights_change(llama_model):
    """An engine drained but not closed, then ``load_state_dict`` of other
    weights into its model: a new engine over the model fuses the new
    weights, and its greedy stream equals solo ``generate`` on them."""
    jmod, jcfg_fn, tcfg_fn, convert = FAMILIES["llama"]
    params = jmod.init_params(jax.random.PRNGKey(1), jcfg_fn())
    other = convert(jax.tree.map(np.asarray, params), tcfg_fn(), device="cpu")
    model = copy.deepcopy(llama_model)
    prompt = np.arange(1, 9, dtype=np.int32)
    old = Engine(model, **ENGINE_KW)
    h_old = old.submit(prompt, max_new_tokens=12, key=0)
    old.drain()
    assert h_old.result() == solo(llama_model, prompt, 0, 12)

    model.load_state_dict(other.state_dict())
    new = Engine(model, **ENGINE_KW)
    assert new._weights is not old._weights
    h_new = new.submit(prompt, max_new_tokens=12, key=0)
    new.drain()
    assert h_new.result() == solo(other, prompt, 0, 12) == solo(model, prompt, 0, 12)
    assert h_new.result() != h_old.result()
    new.close()
    old.close()
