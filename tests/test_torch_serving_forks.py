"""The port's ``submit(n>1)`` forks against JAX's on the CPU, after the
fork tests of ``tests/test_modelpool.py``.

Greedy siblings equal JAX's token for token (``llama_test`` and
``gpt2_test`` in f32), with JAX's page accounting after every tick (the
parent's prompt pages are shared, each sibling re-runs the last prompt
token into a copy-on-write copy of the last page) and far below four solo
requests' pages.  Sampled sibling ``i`` equals the port's solo
``submit(key=fold_key(key, i))`` and solo ``generate``: JAX keys siblings
by threefry's ``fold_in``, which the port does not reproduce.  Every page
is free after ``drain()``.  Tolerance: none (exact).
"""

import numpy as np
import pytest

from torchdistx_tpu_torch.models.generate import fold_key
from torchdistx_tpu_torch.resilience import faults, preemption
from torchdistx_tpu_torch.serving import Engine, RequestCancelled
from torchdistx_tpu_torch.telemetry.audit import DeterminismDigest

from _torch_serving_planes import SAMPLED, engines, load, prompt_of, run_script, solo

EOS = 5
FORK_KW = dict(num_slots=4, block_size=8, num_blocks=41, max_model_len=64, decode_chunk=4)


@pytest.fixture(autouse=True)
def _clean():
    preemption.clear()
    faults.reset("")
    yield
    preemption.clear()
    faults.reset("")


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def fam(request):
    return load(request.param)


@pytest.fixture(scope="module")
def llama_fam():
    return load("llama")


@pytest.mark.parametrize("cache_on", [False, True], ids=["cache_off", "cache_on"])
def test_greedy_siblings_and_pages_match_jax(fam, cache_on):
    script = [("submit", dict(prompt=prompt_of(29, base=10), max_new_tokens=10, key=7, n=4)),
              ("step",),
              ("submit", dict(prompt=prompt_of(12, base=3), max_new_tokens=6, key=8, n=2))]
    traces, streams = [], []
    for eng in engines(fam, prefix_cache=cache_on, **FORK_KW):
        handles, trace = run_script(eng, script)
        streams.append([[s.result() for s in h.siblings] for h in handles])
        traces.append(trace)
        assert eng.stats()["forks"] == 4
        assert eng.allocator.num_in_use == (len(eng.prefix) if cache_on else 0)
        assert not eng._fork_donors and not eng._fork_groups
        eng.close()
    assert streams[1] == streams[0]
    assert traces[1] == traces[0]  # pages in use / free / cached, tick by tick


def test_fork_pages_far_below_four_solo(llama_fam):
    """n=4 over a 4-page prompt: the group's peak footprint stays under
    half of 4x a solo request's, with copy-on-write exercised; JAX's peak
    is the same."""
    peaks = []
    for eng in engines(llama_fam, prefix_cache=False, **FORK_KW):
        solo_h = eng.submit(prompt_of(32, base=10), max_new_tokens=8, key=1)
        solo_peak = 0
        while not solo_h.done:
            eng.step()
            solo_peak = max(solo_peak, eng.allocator.num_in_use)
        h = eng.submit(prompt_of(32, base=10), max_new_tokens=8, key=7, n=4)
        fork_peak = 0
        while not all(s.done for s in h.siblings):
            eng.step()
            fork_peak = max(fork_peak, eng.allocator.num_in_use)
        assert eng.allocator.num_in_use == 0  # the donor swept the tick the group ended
        assert fork_peak < 2 * solo_peak and eng._n_cow >= 1, (fork_peak, solo_peak)
        peaks.append((solo_peak, fork_peak, eng._n_cow))
        eng.close()
    assert peaks[1] == peaks[0]


def test_sampled_siblings_equal_solo_under_fold_key(llama_fam):
    model = llama_fam[3]
    eng = Engine(model, device="cpu", handle_preemption=False, **SAMPLED, **FORK_KW)
    h = eng.submit(prompt_of(32, base=10), max_new_tokens=8, key=7, n=4)
    assert len(h.siblings) == 4 and h.siblings[0] is h
    res = [s.result() for s in h.siblings]
    assert len({tuple(r) for r in res}) > 1  # sampled: they diverge
    for i, toks in enumerate(res):
        k = fold_key(7, i)
        assert eng.submit(prompt_of(32, base=10), max_new_tokens=8, key=k).result() == toks
        assert solo(model, prompt_of(32, base=10), k, 8, **SAMPLED) == toks
        # The digest is built from the folded key.
        assert h.siblings[i].digest == DeterminismDigest.of_stream(
            prompt_of(32, base=10), k, toks).hexdigest()
    eng.drain()
    assert eng.allocator.num_in_use == len(eng.prefix)


def test_n_one_leaves_the_key_untouched(llama_fam):
    model = llama_fam[3]
    eng = Engine(model, device="cpu", handle_preemption=False, **SAMPLED, **FORK_KW)
    got = eng.submit(prompt_of(9), max_new_tokens=6, key=11, n=1).result()
    assert got == solo(model, prompt_of(9), 11, 6, **SAMPLED)
    with pytest.raises(ValueError, match="n must be"):
        eng.submit(prompt_of(9), max_new_tokens=6, key=11, n=0)
    eng.close()


def test_cancelled_siblings_settle_every_page(llama_fam):
    model = llama_fam[3]
    eng = Engine(model, device="cpu", handle_preemption=False, prefix_cache=False,
                 eos_id=EOS, **FORK_KW)
    h = eng.submit(prompt_of(32, base=10), max_new_tokens=16, key=9, n=4)
    for _ in range(3):
        eng.step()
    h.siblings[2].cancel()
    h.siblings[3].cancel()
    eng.drain()
    assert isinstance(h.siblings[2].error, RequestCancelled)
    assert h.siblings[0].result() and h.siblings[1].result()
    assert eng.allocator.num_in_use == 0 and eng.stats()["cancelled"] == 2
    eng.close()


def test_fold_key_words():
    """``fold_key`` is deterministic, index-sensitive, and a function of
    the canonical key (an int seed and its two words agree)."""
    a = fold_key(7, 0)
    assert a.dtype == np.uint32 and a.shape == (2,)
    assert np.array_equal(a, fold_key(7, 0))
    assert np.array_equal(fold_key(7, 3), fold_key(np.array([0, 7], np.uint32), 3))
    keys = {tuple(fold_key(7, i)) for i in range(64)} | {tuple(fold_key(8, i)) for i in range(64)}
    assert len(keys) == 128
