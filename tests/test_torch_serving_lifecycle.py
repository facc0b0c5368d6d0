"""The port's serving request lifecycle on the CPU, mirroring
``tests/test_serving_lifecycle.py``: health, drain on preemption and its
deadline, deadlines, cancellation, shedding, the overload detector, the
slot-bound stall, FIFO order after a prefill failure, ``close`` and
``begin_drain``, and a seeded chaos mini-soak.  Every request either
finishes token-identical to the port's solo ``generate`` or fails with a
typed error, with zero pages leaked at every exit.  ``llama_test`` with
the JAX ``init_params`` weights (through ``llama_from_jax_params``); the
overload detector is held to the JAX one on the same readings.
"""

import jax
import numpy as np
import pytest
import torch

from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.serving import OverloadDetector as JaxOverloadDetector
from torchdistx_tpu_torch import telemetry
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import llama_from_jax_params
from torchdistx_tpu_torch.models.generate import generate
from torchdistx_tpu_torch.resilience import faults, preemption
from torchdistx_tpu_torch.serving import (
    DeadlineExceeded,
    Engine,
    EngineDraining,
    EngineOverloaded,
    Health,
    OverloadDetector,
    RequestCancelled,
    RequestError,
    RequestPreempted,
)
from torchdistx_tpu_torch.serving import engine as eng_mod

EOS = 5
ENGINE_KW = dict(num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 prefix_cache=False, device="cpu")


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    yield
    preemption.clear()
    faults.reset("")


@pytest.fixture(scope="module")
def model():
    cfg = jllama.llama_test()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    return llama_from_jax_params(jax.tree.map(np.asarray, params), tllama.llama_test(),
                                 device="cpu")


def solo(model, prompt, key, max_new, *, eos=None):
    toks = generate(model, torch.as_tensor(np.asarray(prompt, np.int64))[None],
                    max_new_tokens=max_new, eos_id=eos, key=key)[0].tolist()
    if eos is not None and eos in toks:
        toks = toks[: toks.index(eos) + 1]
    return toks


def prompt_of(n, base=1):
    return np.arange(base, base + n, dtype=np.int32)


def test_health_starting_ready(model):
    eng = Engine(model, **ENGINE_KW)
    assert eng.health() is Health.STARTING
    assert eng.stats()["health"] == "starting"
    eng.submit(prompt_of(4), max_new_tokens=2, key=0)
    eng.drain()
    assert eng.health() is Health.READY


def test_drain_on_preemption_finishes_inflight(model):
    eng = Engine(model, drain_deadline_s=60.0, **ENGINE_KW)
    running = [eng.submit(prompt_of(6, base=i + 1), max_new_tokens=6, key=i) for i in range(2)]
    eng.step()
    eng.step()
    waiting = eng.submit(prompt_of(5), max_new_tokens=4, key=9)
    preemption.request()
    while eng.health() is not Health.STOPPED:
        eng.step()
    for i, h in enumerate(running):
        assert h.result() == solo(model, prompt_of(6, base=i + 1), i, 6)
    assert isinstance(waiting.error, RequestPreempted) and waiting.error.retryable
    assert waiting.error.resumable
    with pytest.raises(RequestPreempted):
        waiting.result()
    assert eng.allocator.num_in_use == 0
    with pytest.raises(EngineDraining):
        eng.submit(prompt_of(4), max_new_tokens=2, key=3)
    with pytest.raises(EngineDraining):
        eng.step()


def test_drain_deadline_fails_remainder_retryable(model):
    eng = Engine(model, drain_deadline_s=0.0, **ENGINE_KW)
    h = eng.submit(prompt_of(6), max_new_tokens=30, key=0)
    eng.step()
    assert not h.done
    preemption.request()
    eng.step()
    assert eng.health() is Health.STOPPED
    assert isinstance(h.error, RequestPreempted) and h.error.retryable
    assert not h.error.resumable  # cut mid-stream
    assert eng.allocator.num_in_use == 0


def test_drain_emits_span_and_clears_gauges(model):
    prev = telemetry.configure(collect=True)
    try:
        eng = Engine(model, max_queue=64, **ENGINE_KW)
        eng.submit(prompt_of(4), max_new_tokens=4, key=0)
        eng.step()
        assert telemetry.gauge("serve.health").value == "ready"
        assert telemetry.gauge("serve.est_ttft_s").value is not None
        preemption.request()
        while eng.health() is not Health.STOPPED:
            eng.step()
        assert "serve.drain" in {s["name"] for s in telemetry.snapshot()["spans"]}
        assert telemetry.gauge("serve.health").value is None
        assert telemetry.gauge("serve.est_ttft_s").value is None
    finally:
        telemetry.configure(**prev)


def test_deadline_expires_queued_request(model):
    eng = Engine(model, **ENGINE_KW)
    before = telemetry.counter("serve.expired").value
    keep = [eng.submit(prompt_of(6, base=i + 1), max_new_tokens=6, key=i) for i in range(2)]
    doomed = eng.submit(prompt_of(5), max_new_tokens=4, key=9, deadline_s=1e-6)
    eng.drain()
    assert isinstance(doomed.error, DeadlineExceeded)
    for i, h in enumerate(keep):
        assert h.result() == solo(model, prompt_of(6, base=i + 1), i, 6)
    assert telemetry.counter("serve.expired").value > before
    assert eng.allocator.num_in_use == 0


def test_deadline_expires_running_request_releases_pages(model):
    eng = Engine(model, **ENGINE_KW)
    h = eng.submit(prompt_of(6), max_new_tokens=40, key=0, deadline_s=60.0)
    eng.step()
    assert not h.done and eng.allocator.num_in_use > 0
    eng._slot_req[0].deadline = 0.0  # force the expiry deterministically
    eng.step()
    assert isinstance(h.error, DeadlineExceeded)
    assert eng.allocator.num_in_use == 0 and eng.health() is Health.READY
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(prompt_of(4), max_new_tokens=2, key=0, deadline_s=0)


def test_cancel_queued_and_running(model):
    eng = Engine(model, **ENGINE_KW)
    before = telemetry.counter("serve.cancelled").value
    run = eng.submit(prompt_of(6), max_new_tokens=30, key=0)
    eng.step()
    queued = eng.submit(prompt_of(5), max_new_tokens=4, key=1)
    assert run.cancel() and queued.cancel()
    eng.step()
    assert isinstance(run.error, RequestCancelled)
    assert isinstance(queued.error, RequestCancelled)
    assert eng.allocator.num_in_use == 0
    assert telemetry.counter("serve.cancelled").value == before + 2
    done = eng.submit(prompt_of(4), max_new_tokens=2, key=2)
    eng.drain()
    assert done.result() == solo(model, prompt_of(4), 2, 2)
    assert not done.cancel()


def test_shed_reject_new(model):
    eng = Engine(model, max_queue=2, **ENGINE_KW)
    before = telemetry.counter("serve.shed").value
    handles = [eng.submit(prompt_of(4, base=i + 1), max_new_tokens=4, key=i) for i in range(2)]
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(prompt_of(4), max_new_tokens=4, key=9)
    assert ei.value.retryable
    assert eng.health() is Health.OVERLOADED
    assert telemetry.counter("serve.shed").value == before + 1
    eng.drain()
    assert eng.health() is Health.READY
    for i, h in enumerate(handles):
        assert h.result() == solo(model, prompt_of(4, base=i + 1), i, 4)


def test_shed_drop_oldest(model):
    eng = Engine(model, max_queue=2, shed_policy="drop-oldest", **ENGINE_KW)
    oldest = eng.submit(prompt_of(4, base=1), max_new_tokens=4, key=0)
    second = eng.submit(prompt_of(4, base=2), max_new_tokens=4, key=1)
    newest = eng.submit(prompt_of(4, base=3), max_new_tokens=4, key=2)
    assert isinstance(oldest.error, EngineOverloaded) and oldest.error.retryable
    eng.drain()
    assert second.result() == solo(model, prompt_of(4, base=2), 1, 4)
    assert newest.result() == solo(model, prompt_of(4, base=3), 2, 4)
    assert eng.allocator.num_in_use == 0
    with pytest.raises(ValueError, match="shed_policy"):
        Engine(model, shed_policy="lru", **ENGINE_KW)


def test_overload_detector_matches_jax():
    """The same readings give the same estimates and verdicts as the JAX
    detector (the copy), chunked and unchunked."""
    for kw in (dict(max_queue=4, max_ttft_s=1.0), dict(max_ttft_s=1.0), {}):
        ours, theirs = OverloadDetector(**kw), JaxOverloadDetector(**kw)
        assert ours.enabled == theirs.enabled
        for tick in (0.5, 0.5, 0.01, 0.2, 0.9):
            ours.observe_tick(tick)
            theirs.observe_tick(tick)
            for depth, per_tick, chunks in ((3, 1, None), (1, 1, 32), (0, 1, None), (4, 8, 32)):
                assert ours.est_ttft_s(chunks or depth, per_tick) == theirs.est_ttft_s(
                    chunks or depth, per_tick)
                assert ours.overloaded(depth, per_tick, chunks) == theirs.overloaded(
                    depth, per_tick, chunks)
    with pytest.raises(ValueError):
        OverloadDetector(max_queue=0)


def test_overload_detector_chunked_engine_estimates(model):
    for chunk, want_chunks in ((512, 1), (8, 5)):
        eng = Engine(model, max_queue=64, prefill_chunk=chunk, num_slots=1, block_size=8,
                     max_model_len=64, decode_chunk=4, handle_preemption=False,
                     prefix_cache=False, device="cpu")
        blocker = eng.submit(prompt_of(6), max_new_tokens=30, key=0)
        eng.step()
        eng.detector._tick_ewma_s = 0.5
        eng.submit(prompt_of(33), max_new_tokens=8, key=1)
        assert eng._pending_prefill_chunks() == want_chunks
        assert eng.est_ttft_s() == pytest.approx(0.5 * (want_chunks + 1))
        blocker.cancel()
        eng.drain()
        assert eng.allocator.num_in_use == 0
    eng = Engine(model, max_ttft_s=1.0, prefill_chunk=8, num_slots=1, block_size=8,
                 max_model_len=64, decode_chunk=4, handle_preemption=False, device="cpu")
    eng.detector._tick_ewma_s = 0.5
    with pytest.raises(EngineOverloaded):
        eng.submit(prompt_of(33), max_new_tokens=8, key=0)
    h = eng.submit(prompt_of(6), max_new_tokens=2, key=1)
    eng.drain()
    assert len(h.result()) == 2


def test_slot_bound_stall_counts_backpressure(model):
    eng = Engine(model, num_slots=1, block_size=8, max_model_len=64, decode_chunk=4,
                 device="cpu")
    eng.submit(prompt_of(6), max_new_tokens=12, key=0)
    eng.step()
    eng.submit(prompt_of(6), max_new_tokens=4, key=1)
    before = telemetry.counter("serve.backpressure").value
    eng.step()
    assert telemetry.counter("serve.backpressure").value > before
    eng.drain()
    with pytest.raises(ValueError, match="num_slots"):
        Engine(model, num_slots=0, device="cpu")


def test_prefill_failure_keeps_fifo_order(model, monkeypatch):
    eng = Engine(model, num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 max_prefills_per_tick=2, device="cpu")
    real = eng_mod.Engine._run_chunk
    state = {"fail": True}

    def boom_first(self, *a, **k):
        if state["fail"]:
            state["fail"] = False
            raise RuntimeError("boom")
        return real(self, *a, **k)

    monkeypatch.setattr(eng_mod.Engine, "_run_chunk", boom_first)
    ha = eng.submit(prompt_of(4, base=1), max_new_tokens=4, key=0)
    hb = eng.submit(prompt_of(4, base=2), max_new_tokens=4, key=1)
    eng.step()
    assert [r.rid for r in eng.scheduler._waiting] == [ha.rid, hb.rid]
    eng.drain()
    assert ha.result() == solo(model, prompt_of(4, base=1), 0, 4)
    assert hb.result() == solo(model, prompt_of(4, base=2), 1, 4)
    assert eng.allocator.num_in_use == 0


def test_est_ttft_hook_matches_detector(model):
    eng = Engine(model, max_queue=64, **ENGINE_KW)
    assert eng.est_ttft_s() == 0.0
    eng.detector.observe_tick(0.5)
    assert eng.est_ttft_s() == pytest.approx(0.5)
    eng.submit(prompt_of(4), max_new_tokens=2, key=0)
    eng.submit(prompt_of(4), max_new_tokens=2, key=1)
    assert eng.est_ttft_s() == pytest.approx(
        eng.detector.est_ttft_s(2, eng.max_prefills_per_tick))
    eng.drain()


def test_close_is_idempotent_and_post_stopped_rejects_typed(model):
    eng = Engine(model, **ENGINE_KW)
    running = eng.submit(prompt_of(6), max_new_tokens=30, key=0)
    eng.step()
    queued = eng.submit(prompt_of(5), max_new_tokens=4, key=1)
    before = telemetry.counter("serve.preempted").value
    eng.close()
    assert eng.health() is Health.STOPPED
    assert isinstance(running.error, RequestPreempted) and running.error.retryable
    assert isinstance(queued.error, EngineDraining) and queued.error.retryable
    after = telemetry.counter("serve.preempted").value
    assert after == before + 2
    eng.close()
    assert telemetry.counter("serve.preempted").value == after
    assert eng.stats()["preempted"] == 2
    with pytest.raises(EngineDraining):
        eng.submit(prompt_of(4), max_new_tokens=2, key=2)
    with pytest.raises(EngineDraining):
        eng.step()
    assert eng.allocator.num_in_use == 0


def test_begin_drain_without_signal(model):
    eng = Engine(model, drain_deadline_s=60.0, **ENGINE_KW)
    running = eng.submit(prompt_of(6), max_new_tokens=6, key=0)
    eng.step()
    waiting = eng.submit(prompt_of(5), max_new_tokens=4, key=1)
    eng.begin_drain()
    assert eng.health() is Health.DRAINING
    eng.begin_drain()
    while eng.health() is not Health.STOPPED:
        eng.step()
    assert running.result() == solo(model, prompt_of(6), 0, 6)
    assert isinstance(waiting.error, RequestPreempted) and waiting.error.retryable
    assert eng.allocator.num_in_use == 0


def test_chaos_mini_soak(model, monkeypatch):
    """Seeded faults at every site, two device failures that scribble on
    the pool, deadlines and cancellations over 12 mixed requests: each
    finishes token-identical to solo generate or fails typed; no hang, no
    leaked page, the engine READY."""
    rng = np.random.default_rng(1234)
    specs = []
    for site, lo, hi in [("serve.admit", 2, 8), ("serve.prefill", 2, 8),
                         ("serve.step", 2, 12), ("serve.recover", 1, 3)]:
        for step in rng.integers(lo, hi, size=2):
            kind = rng.choice(["io", "nan"]) if site != "serve.recover" else "io"
            specs.append(f"{site}:{int(step)}:{kind}")
    faults.reset(",".join(sorted(set(specs))))
    eng = Engine(model, eos_id=EOS, num_slots=2, block_size=8, num_blocks=17,
                 max_model_len=64, decode_chunk=4, prefix_cache=False, device="cpu")
    real = eng_mod.DecodeChunk.__call__
    chaos = {"chunks": 0}

    def flaky(self, *a, **k):
        chaos["chunks"] += 1
        if chaos["chunks"] in (5, 9):
            for pool in self.cache.values():
                pool[:, 1:].normal_()
            raise RuntimeError("CUDA error: chaos device failure")
        return real(self, *a, **k)

    monkeypatch.setattr(eng_mod.DecodeChunk, "__call__", flaky)
    reqs = []
    for i in range(12):
        prompt = rng.integers(0, 256, size=int(rng.integers(3, 14))).astype(np.int32)
        mnt = int(rng.choice([4, 8, 12]))
        h = eng.submit(prompt, max_new_tokens=mnt, key=i,
                       deadline_s=30.0 if rng.random() > 0.1 else 1e-6)
        if rng.random() < 0.1:
            h.cancel()
        reqs.append((prompt, mnt, i, h))
    for _ in range(3000):
        if not (len(eng.scheduler) or eng._n_running()):
            break
        eng.step()
    else:
        pytest.fail("the chaos soak did not drain within the step bound")
    n_ok = 0
    for prompt, mnt, key, h in reqs:
        assert h.done, f"request {key} neither finished nor failed"
        if h.error is not None:
            assert isinstance(h.error, RequestError), h.error
        else:
            assert h.result() == solo(model, prompt, key, mnt, eos=EOS), key
            n_ok += 1
    assert n_ok >= 6
    assert chaos["chunks"] >= 9 and eng.stats()["recoveries"] >= 2
    assert eng.allocator.num_in_use == 0
    assert eng.health() is Health.READY
