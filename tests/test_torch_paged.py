"""The port's paged KV cache against the JAX package on the CPU.

``paged_write_index`` is held exactly (the trash page included),
``paged_attention`` and both families' ``forward_paged`` at 1e-5 (f32,
logits and the pages written), ``write_prompt`` / ``copy_pages`` /
``page_hashes`` exactly, and ``canonical_key`` / ``DeterminismDigest``
bit for bit.  Inputs come from numpy seeds; weights from the JAX
``init_params`` through ``*_from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.models import gpt2 as jgpt2
from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.ops import attention as jattn
from torchdistx_tpu.serving import cache as jcache
from torchdistx_tpu.serving.prefix import page_hashes as jax_page_hashes
from torchdistx_tpu.telemetry import audit as jaudit
from torchdistx_tpu_torch.models import gpt2 as tgpt2
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import gpt2_from_jax_params, llama_from_jax_params
from torchdistx_tpu_torch.ops import attention as tattn
from torchdistx_tpu_torch.serving import cache as tcache
from torchdistx_tpu_torch.serving.prefix import page_hashes
from torchdistx_tpu_torch.telemetry import audit as taudit

ATOL = 1e-5  # f32 forward_paged / paged_attention against JAX


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("shape", [(5,), (3, 7)], ids=["decode", "block"])
def test_paged_write_index_exact(shape):
    rng = np.random.default_rng(0)
    b, m, bs = shape[0], 4, 8
    tables = rng.integers(1, 40, size=(b, m)).astype(np.int32)
    # Positions up to twice the table's span: every one past it must steer
    # into the trash page.
    positions = rng.integers(0, 2 * m * bs, size=shape).astype(np.int32)
    positions.flat[0] = m * bs  # the first position past the table
    want_blk, want_off = jattn.paged_write_index(jnp.asarray(tables), jnp.asarray(positions), bs)
    blk, off = tattn.paged_write_index(torch.from_numpy(tables), torch.from_numpy(positions), bs)
    np.testing.assert_array_equal(blk.numpy(), _np(want_blk))
    np.testing.assert_array_equal(off.numpy(), _np(want_off))
    assert (blk.numpy()[positions // bs >= m] == 0).all()
    assert blk.numpy().flat[0] == 0


def _pages(rng, b, m, bs, hkv, d):
    """A contiguous history laid out as pages: slot i's block j is page
    1 + i*m + j; page 0 (trash) holds junk that the mask must hide."""
    k = rng.standard_normal((b, m * bs, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, m * bs, hkv, d)).astype(np.float32)
    k_pages = np.concatenate([np.full((1, bs, hkv, d), 7.7, np.float32),
                              k.reshape(b * m, bs, hkv, d)])
    v_pages = np.concatenate([np.full((1, bs, hkv, d), -3.3, np.float32),
                              v.reshape(b * m, bs, hkv, d)])
    tables = (1 + np.arange(b * m).reshape(b, m)).astype(np.int32)
    return k, v, k_pages, v_pages, tables


@pytest.mark.parametrize("t", [1, 4])
def test_paged_attention_against_jax_and_cached(t):
    rng = np.random.default_rng(1)
    b, hq, hkv, d, bs, m = 3, 4, 2, 8, 4, 4
    k, v, k_pages, v_pages, tables = _pages(rng, b, m, bs, hkv, d)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    positions = np.asarray([5, 11, 2], np.int32)
    want = _np(jattn.paged_attention(jnp.asarray(q), jnp.asarray(k_pages), jnp.asarray(v_pages),
                                     jnp.asarray(tables), jnp.asarray(positions)))
    got = tattn.paged_attention(*map(torch.from_numpy, (q, k_pages, v_pages, tables)),
                                torch.from_numpy(positions).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # The same history through the contiguous cache: the trash page and
    # the pages past each slot's history get exactly zero probability.
    for i in range(b):
        ref = tattn.cached_attention(torch.from_numpy(q[i:i + 1]), torch.from_numpy(k[i:i + 1]),
                                     torch.from_numpy(v[i:i + 1]), int(positions[i])).numpy()
        np.testing.assert_allclose(got[i:i + 1], ref, atol=1e-6, rtol=0, err_msg=f"slot {i}")


FAMILIES = {
    "llama": (jllama, jllama.llama_test, tllama.llama_test, llama_from_jax_params),
    "gpt2": (jgpt2, jgpt2.gpt2_test, tgpt2.gpt2_test, gpt2_from_jax_params),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jmod, jcfg_fn, tcfg_fn, convert = FAMILIES[request.param]
    cfg = jcfg_fn()
    params = jmod.init_params(jax.random.PRNGKey(0), cfg)
    model = convert(jax.tree.map(np.asarray, params), tcfg_fn(), device="cpu")
    return jmod, cfg, params, model


def _pool(rng, jmod, cfg, nb, bs):
    """A page pool of random history in JAX's layout and a copy for the
    port (both update it: JAX returns a new one, the port writes in
    place)."""
    proto = jmod.init_cache(cfg, 1, 1)
    shape = (proto["k"].shape[0], nb, bs) + proto["k"].shape[3:]
    return {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}


@pytest.mark.parametrize("case", ["decode", "prefill_block"])
def test_forward_paged_against_jax(family, case):
    jmod, cfg, params, model = family
    rng = np.random.default_rng(2)
    nb, bs, m = 12, 4, 4
    pool = _pool(rng, jmod, cfg, nb, bs)
    if case == "decode":
        # Three slots, one retired (table 0: its write lands in trash).
        tables = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
        positions = np.asarray([9, 6, 0], np.int32)
        tokens = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    else:
        # Two slots sharing pages 1-2 (a cached prefix), each prefilling a
        # 6-token block from position 8 into its own pages; the second's
        # padding runs past its table into the trash page.
        tables = np.asarray([[1, 2, 6, 7], [1, 2, 8, 0]], np.int32)
        positions = np.asarray([8, 8], np.int32)
        tokens = rng.integers(0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    jcache_in = {n: jnp.asarray(a) for n, a in pool.items()}
    want_logits, want_cache = jmod.forward_paged(
        params, jnp.asarray(tokens), cfg, jcache_in, jnp.asarray(tables), jnp.asarray(positions))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    with torch.no_grad():
        logits, out = model.forward_paged(torch.from_numpy(tokens).long(), tpool,
                                          torch.from_numpy(tables).long(),
                                          torch.from_numpy(positions).long())
    assert out is tpool
    assert logits.dtype == torch.float32 and logits.shape == tokens.shape + (cfg.vocab_size,)
    np.testing.assert_allclose(logits.numpy(), _np(want_logits), atol=ATOL, rtol=0)
    for n in ("k", "v"):
        # Every page but the trash page (whose duplicate writes land in
        # an unspecified order on both sides).
        np.testing.assert_allclose(tpool[n].numpy()[:, 1:], _np(want_cache[n])[:, 1:],
                                   atol=ATOL, rtol=0)


def test_write_prompt_and_copy_pages_exact(family):
    jmod, cfg, params, model = family
    bs, nb, length, p_pad = 4, 9, 6, 16
    scratch = jmod.init_cache(cfg, 1, p_pad)
    tokens = jnp.arange(1, p_pad + 1, dtype=jnp.int32)[None] % cfg.vocab_size
    _, scratch = jmod.forward_cached(params, tokens, cfg, scratch, 0)
    table = np.zeros((4,), np.int32)
    table[:2] = [3, 7]
    want = jcache.write_prompt(jcache.init_paged_cache(jmod, cfg, nb, bs), scratch,
                               jnp.asarray(table), length, block_size=bs)
    pool = tcache.init_paged_cache(model, nb, bs, device="cpu")
    assert pool["k"].shape == want["k"].shape and pool["k"].dtype == torch.float32
    cont = {n: torch.from_numpy(np.array(a)) for n, a in scratch.items()}
    assert tcache.write_prompt(pool, cont, table, length, block_size=bs) is pool
    for n in ("k", "v"):
        np.testing.assert_array_equal(pool[n].numpy()[:, 1:], _np(want[n])[:, 1:])
    want = jcache.copy_pages(want, np.int32(3), np.int32(5))
    assert tcache.copy_pages(pool, 3, 5) is pool
    for n in ("k", "v"):
        np.testing.assert_array_equal(pool[n].numpy()[:, 1:], _np(want[n])[:, 1:])
    assert tcache.pool_geometry(pool) == tcache.pool_geometry(
        tcache.init_paged_cache(model, 3, bs, device="cpu"))
    assert tcache.fresh_pool(pool) is pool and not pool["k"].any()


@pytest.mark.parametrize("n", [0, 7, 8, 33])
def test_page_hashes_exact(n):
    tokens = np.random.default_rng(n).integers(0, 32000, size=n).astype(np.int32)
    assert page_hashes(tokens, 8) == jax_page_hashes(tokens, 8)
    assert page_hashes(tokens, 8, b"tag") == jax_page_hashes(tokens, 8, b"tag")


@pytest.mark.parametrize("seed", [0, 5, -1, 2**31, 2**33 + 7])
def test_canonical_key_matches_prng_key(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.uint32)
    got = taudit.canonical_key(seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(taudit.canonical_key(jaudit.canonical_key(seed)), want)
    np.testing.assert_array_equal(taudit.canonical_key(torch.tensor(want.astype(np.int64))), want)


def test_canonical_key_pinned_words():
    assert taudit.canonical_key(5).tolist() == [0, 5]
    assert taudit.canonical_key(-1).tolist() == [0, 4294967295]
    assert taudit.canonical_key(2**33 + 7).tolist() == [0, 7]


def test_determinism_digest_matches_jax():
    prompt = np.arange(3, 20, dtype=np.int32)
    tokens = [5, 900, 31999, 0, 7]
    for key in (0, 123, [17, 4]):
        want = jaudit.DeterminismDigest.of_stream(prompt, jaudit.canonical_key(key), tokens,
                                                  "v3")
        got = taudit.DeterminismDigest(prompt, taudit.canonical_key(key))
        got.update(tokens[:2], "v3")
        got.update(tokens[2:], "v3")
        assert got.hexdigest() == want.hexdigest()
        assert got.matches_stream(prompt, taudit.canonical_key(key), tokens, "v3")
        assert not got.matches_stream(prompt, taudit.canonical_key(key), tokens[:-1], "v3")
    assert taudit.first_divergence([1, 2, 3], [1, 9, 3]) == jaudit.first_divergence(
        [1, 2, 3], [1, 9, 3]) == 1
    assert taudit.first_divergence([1, 2], [1, 2, 3]) == 2
