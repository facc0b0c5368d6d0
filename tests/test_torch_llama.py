"""The port's Llama against the JAX Llama on ``llama_test`` (2 layers, dim
64, 4/2 heads, float32): the JAX ``init_params`` weights go through numpy
into :func:`llama_from_jax_params`, token ids are made with numpy.

Tolerance: atol 1e-5 on float32 logits (same arithmetic, different
summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import llama_from_jax_params

ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    cfg = jllama.llama_test()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    params_np = jax.tree.map(np.asarray, params)
    model = llama_from_jax_params(params_np, tllama.llama_test(), device="cpu")
    return cfg, params, model


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


def test_config_fields_match():
    j, t = jllama.llama_test(), tllama.llama_test()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "ffn_dim", "max_seq_len", "rope_theta", "norm_eps", "head_dim",
              "remat"):
        assert getattr(j, f) == getattr(t, f), f
    for name in ("llama_tiny", "llama_7b", "llama_70b"):
        jc, tc = getattr(jllama, name)(), getattr(tllama, name)()
        assert tllama.num_params(tc) == jllama.num_params(jc), name
        assert tc.dtype == torch.bfloat16
        assert tc.remat == jc.remat, name


@pytest.mark.parametrize("jax_impl", ["jnp", "pallas"])
def test_forward_matches_jax(pair, jax_impl):
    cfg, params, model = pair
    tokens = _tokens((2, 24), seed=1)
    want = np.asarray(
        jllama.forward(params, jnp.asarray(tokens), cfg, attn_impl=jax_impl)
    )
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_forward_cached_prefill_and_decode_match_jax(pair):
    cfg, params, model = pair
    tokens = _tokens((2, 12), seed=2)
    j_cache = jllama.init_cache(cfg, 2, 16)
    t_cache = model.init_cache(2, 16)
    # Prefill of 8 tokens, then 4 single-token steps.
    j_logits, j_cache = jllama.forward_cached(
        params, jnp.asarray(tokens[:, :8]), cfg, j_cache, 0
    )
    with torch.no_grad():
        t_logits, t_cache = model.forward_cached(
            torch.from_numpy(tokens[:, :8]), t_cache, 0
        )
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=ATOL, rtol=0)
    weights = model.prep_decode()
    for pos in range(8, 12):
        j_logits, j_cache = jllama.forward_cached(
            params, jnp.asarray(tokens[:, pos:pos + 1]), cfg, j_cache, pos
        )
        with torch.no_grad():
            t_logits, t_cache = model.forward_cached(
                torch.from_numpy(tokens[:, pos:pos + 1]), t_cache, pos, weights
            )
        np.testing.assert_allclose(
            t_logits.numpy(), np.asarray(j_logits), atol=ATOL, rtol=0
        )
    for key in ("k", "v"):
        np.testing.assert_allclose(
            t_cache[key].numpy(), np.asarray(j_cache[key]), atol=ATOL, rtol=0
        )


def test_forward_cached_matches_forward(pair):
    _, _, model = pair
    tokens = torch.from_numpy(_tokens((2, 10), seed=3))
    with torch.no_grad():
        full = model(tokens)
        cached, _ = model.forward_cached(tokens, model.init_cache(2, 10), 0)
    torch.testing.assert_close(cached, full, atol=ATOL, rtol=0)


def test_prep_decode_fuses_projections(pair):
    _, _, model = pair
    w = model.prep_decode()
    blk = model.layers[0]
    assert torch.equal(
        w["wqkv"][0], torch.cat([blk.wq.weight, blk.wk.weight, blk.wv.weight])
    )
    assert torch.equal(w["wgu"][0], torch.cat([blk.w_gate.weight, blk.w_up.weight]))
    assert len(w["wqkv"]) == len(w["wgu"]) == model.cfg.n_layers


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0)
    want = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    cos, sin = tllama._rope_tables(torch.from_numpy(pos), 10000.0, 8, torch.float32)
    got = tllama._rope_apply(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    w = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jllama._rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tllama._rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
