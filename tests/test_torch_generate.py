"""Greedy generation in the port is token-identical to the JAX ``generate``
on ``llama_test`` (B=2, an 8-token prompt, 16 new tokens), with the JAX
``init_params`` weights moved through numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu.models.generate import generate as jax_generate
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.models.convert import llama_from_jax_params
from torchdistx_tpu_torch.models.generate import generate

NEW = 16


@pytest.fixture(scope="module")
def setup():
    cfg = jllama.llama_test()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    model = llama_from_jax_params(
        jax.tree.map(np.asarray, params), tllama.llama_test(), device="cpu"
    )
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8))
    return cfg, params, model, prompt


def _jax(setup, eos_id):
    cfg, params, _, prompt = setup
    return np.asarray(
        jax_generate(
            params, jnp.asarray(prompt), jax.random.PRNGKey(0), model=jllama,
            cfg=cfg, max_new_tokens=NEW, eos_id=eos_id,
        )
    )


def _port(setup, eos_id):
    _, _, model, prompt = setup
    return generate(
        model, torch.from_numpy(prompt), max_new_tokens=NEW, eos_id=eos_id
    ).numpy()


def test_greedy_token_identical(setup):
    want = _jax(setup, None)
    got = _port(setup, None)
    assert got.shape == (2, NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("row, step", [(0, 3), (1, 0)])
def test_greedy_with_eos_token_identical(setup, row, step):
    eos = int(_jax(setup, None)[row, step])  # a token that fires
    want = _jax(setup, eos)
    got = _port(setup, eos)
    np.testing.assert_array_equal(got, want)
    assert (got[row, step:] == eos).all()


def test_all_done_early_exit_fills_eos(setup, monkeypatch):
    _, _, model, prompt = setup
    # Two equal rows emit the same first token; as eos it ends both at once.
    prompt = torch.from_numpy(np.repeat(prompt[:1], 2, axis=0))
    eos = int(generate(model, prompt, max_new_tokens=1)[0, 0])
    calls = []
    inner = model.forward_cached

    def counted(*args, **kwargs):
        calls.append(args[2])
        return inner(*args, **kwargs)

    monkeypatch.setattr(model, "forward_cached", counted)
    got = generate(model, prompt, max_new_tokens=NEW, eos_id=eos)
    assert (got == eos).all()
    assert calls == [0]  # the prefill only: every decode step was skipped


def test_sampling_reproducible_with_generator(setup):
    _, _, model, prompt = setup

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(
            model, torch.from_numpy(prompt), max_new_tokens=8,
            temperature=0.8, top_k=20, generator=g,
        )

    a, b = run(3), run(3)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < 256)).all()


def test_too_long_raises(setup):
    _, _, model, prompt = setup
    with pytest.raises(ValueError, match="max_seq_len"):
        generate(model, torch.from_numpy(prompt), max_new_tokens=200)
