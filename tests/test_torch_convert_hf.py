"""The port's Hugging Face bridge (``models/convert.py``) against the JAX
package's and against ``transformers`` itself, on small random HF GPT-2 and
Llama models (float32, eval mode).

The port's ``*_params_from_hf`` must give the JAX converters' pytree array
for array, and a port model built from it the same logits as the JAX
forward on the JAX converters' output (atol 1e-5) and as the HF model
(2e-3, as ``tests/test_convert.py`` holds the JAX bridge).  Then the
load-bearing flow: the port's ``deferred_init`` of an HF GPT-2, its
``materialize_module_torch``, the converter and a port forward.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

from torchdistx_tpu.models import convert as jconvert  # noqa: E402
from torchdistx_tpu.models import gpt2 as jgpt2  # noqa: E402
from torchdistx_tpu.models import llama as jllama  # noqa: E402
from torchdistx_tpu_torch import deferred_init as tdi  # noqa: E402
from torchdistx_tpu_torch.materialize import materialize_module_torch  # noqa: E402
from torchdistx_tpu_torch.models import convert  # noqa: E402
from torchdistx_tpu_torch.models.generate import generate  # noqa: E402

ATOL = 1e-5
HF_ATOL = 2e-3
F32 = dict(dtype=torch.float32, remat=False)


def _tokens(vocab, seed):
    return torch.randint(0, vocab, (2, 16), generator=torch.Generator().manual_seed(seed))


def _assert_same_tree(got, want):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, g), w in zip(flat_got, flat_want):
        assert isinstance(g, np.ndarray), jax.tree_util.keystr(path)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def hf_gpt2():
    torch.manual_seed(0)
    config = transformers.GPT2Config(vocab_size=128, n_positions=64, n_embd=32, n_layer=2,
                                     n_head=4)
    return transformers.GPT2LMHeadModel(config).eval(), config


@pytest.fixture(scope="module", params=["untied", "tied"])
def hf_llama(request):
    torch.manual_seed(0)
    config = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        attn_implementation="eager", tie_word_embeddings=request.param == "tied")
    return transformers.LlamaForCausalLM(config).eval(), config, request.param


def test_gpt2_config_matches_jax(hf_gpt2):
    _, config = hf_gpt2
    got = convert.gpt2_config_from_hf(config, **F32)
    want = jconvert.gpt2_config_from_hf(config, dtype=jnp.float32, remat=False)
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "max_seq_len", "norm_eps"):
        assert getattr(got, f) == getattr(want, f), f


def test_gpt2_from_hf_matches_jax_and_hf(hf_gpt2):
    model, config = hf_gpt2
    state = model.state_dict()
    tree = convert.gpt2_params_from_hf(state)  # layer count from the names
    _assert_same_tree(tree, jconvert.gpt2_params_from_hf(
        {k: v.numpy() for k, v in state.items()}))
    cfg = convert.gpt2_config_from_hf(config, **F32)
    port = convert.gpt2_from_jax_params(tree, cfg, device="cpu")
    tokens = _tokens(128, 1)
    jcfg = jconvert.gpt2_config_from_hf(config, dtype=jnp.float32, remat=False)
    jparams = jconvert.gpt2_params_from_hf({k: v.numpy() for k, v in state.items()}, jcfg)
    want = np.asarray(jgpt2.forward(jparams, jnp.asarray(tokens.numpy()), jcfg,
                                    attn_impl="jnp"))
    with torch.no_grad():
        got = port(tokens).numpy()
        ref = model(tokens).logits.numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got - ref).max() < HF_ATOL


def test_llama_from_hf_matches_jax_and_hf(hf_llama):
    model, config, tie = hf_llama
    state = model.state_dict()
    if tie == "tied":
        state = {k: v for k, v in state.items() if k != "lm_head.weight"}
    numpy_state = {k: v.numpy() for k, v in state.items()}
    cfg = convert.llama_config_from_hf(config, **F32)
    jcfg = jconvert.llama_config_from_hf(config, dtype=jnp.float32, remat=False)
    tree = convert.llama_params_from_hf(state, cfg)
    _assert_same_tree(tree, jconvert.llama_params_from_hf(numpy_state))
    if tie == "tied":
        np.testing.assert_array_equal(tree["lm_head"]["weight"], tree["embed"]["weight"].T)
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim",
              "max_seq_len", "rope_theta", "norm_eps"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    port = convert.llama_from_jax_params(tree, cfg, device="cpu")
    tokens = _tokens(128, 2)
    jparams = jconvert.llama_params_from_hf(numpy_state, jcfg)
    want = np.asarray(jllama.forward(jparams, jnp.asarray(tokens.numpy()), jcfg,
                                     attn_impl="jnp"))
    with torch.no_grad():
        got = port(tokens).numpy()
        ref = model(tokens).logits.numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got - ref).max() < HF_ATOL
    # Greedy decoding with the converted weights follows HF's.
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        hf_out = model.generate(prompt, max_new_tokens=4, do_sample=False)[0, 4:]
    assert torch.equal(generate(port, prompt, max_new_tokens=4)[0], hf_out)


def test_missing_parameter_names_the_prefixes():
    with pytest.raises(KeyError, match="tried prefixes"):
        convert.gpt2_params_from_hf({"transformer.h.0.ln_1.weight": np.zeros(2)})


def test_deferred_hf_gpt2_through_the_port():
    # deferred_init(GPT2LMHeadModel) with the port, its seeded
    # materialization (the tied head listed once), the converter, a port
    # GPT-2 forward: finite logits of the right shape.
    config = transformers.GPT2Config(vocab_size=128, n_positions=64, n_embd=32, n_layer=2,
                                     n_head=4)
    fake = tdi.deferred_init(transformers.GPT2LMHeadModel, config)
    assert all(tdi.is_deferred(p) for p in fake.parameters())
    values = materialize_module_torch(fake, seed=0, device="cpu")
    assert "lm_head.weight" not in values and "transformer.wte.weight" in values
    cfg = convert.gpt2_config_from_hf(config, **F32)
    port = convert.gpt2_from_jax_params(convert.gpt2_params_from_hf(values, cfg), cfg,
                                        device="cpu")
    assert torch.equal(port.wte.weight, values["transformer.wte.weight"])
    with torch.no_grad():
        logits = port(torch.zeros((1, 8), dtype=torch.long))
    assert logits.shape == (1, 8, 128) and bool(torch.isfinite(logits).all())
