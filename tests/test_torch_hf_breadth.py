"""Architecture breadth on the port: Hugging Face model families recorded
under the port's ``deferred_init`` and materialized by
``materialize_module_torch`` (the reference's ``tests/test_hf_breadth.py``
on the port; the seven inline configs, nothing downloaded).

For every family (gpt2, mistral-gqa, gpt-neox, bert, t5, vit, hf-llama):
every parameter is fake after recording; the seeded materialize gives
every deferred parameter and buffer, as many elements as the eager model
holds but for the buffers that were real at construction, all finite; and
each value is held against the eager model's: exactly where its tape draws
from no random stream (norms, biases, position ids, masks), by statistics
where it does.  For the four decoder families (the reference's fast lane)
the deterministic values are also held against ``materialize_module_jax``
on the JAX package's recording: exactly, but the float values of
transcendental ops (XLA's ``pow`` in the rotary ``inv_freq`` rounds one
ulp away from torch's), held at two float32 ulps.
"""

import os
import sys

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

import torchdistx_tpu.deferred_init as jdi  # noqa: E402
from torchdistx_tpu.materialize import materialize_module_jax  # noqa: E402
from torchdistx_tpu_torch.deferred_init import deferred_init  # noqa: E402
from torchdistx_tpu_torch.fake import is_fake  # noqa: E402
from torchdistx_tpu_torch.materialize import materialize_module_torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_deferred_helpers import assert_like, is_random, recorded  # noqa: E402

DECODERS = {"gpt2", "mistral-gqa", "gpt-neox", "hf-llama"}
JAX_FLOAT_RTOL = 2.5e-7  # two float32 ulps


def _cases():
    from transformers import (
        BertConfig,
        BertModel,
        GPT2Config,
        GPT2LMHeadModel,
        GPTNeoXConfig,
        GPTNeoXForCausalLM,
        LlamaConfig,
        LlamaForCausalLM,
        MistralConfig,
        MistralForCausalLM,
        T5Config,
        T5ForConditionalGeneration,
        ViTConfig,
        ViTModel,
    )

    return [
        ("gpt2", lambda: GPT2LMHeadModel(
            GPT2Config(n_layer=2, n_embd=64, n_head=4, vocab_size=256))),
        ("mistral-gqa", lambda: MistralForCausalLM(
            MistralConfig(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                          num_key_value_heads=2, intermediate_size=128, vocab_size=256))),
        ("gpt-neox", lambda: GPTNeoXForCausalLM(
            GPTNeoXConfig(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                          intermediate_size=128, vocab_size=256))),
        ("bert", lambda: BertModel(
            BertConfig(num_hidden_layers=2, hidden_size=128, num_attention_heads=4,
                       intermediate_size=256))),
        ("t5", lambda: T5ForConditionalGeneration(
            T5Config(num_layers=2, num_decoder_layers=2, d_model=64, num_heads=4, d_ff=128))),
        ("vit", lambda: ViTModel(
            ViTConfig(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                      intermediate_size=128, image_size=32, patch_size=8))),
        ("hf-llama", lambda: LlamaForCausalLM(
            LlamaConfig(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                        intermediate_size=128, vocab_size=256))),
    ]


CASES = _cases()


def _state(model):
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return out


@pytest.mark.parametrize("name,fn", CASES, ids=[n for n, _ in CASES])
def test_hf_family_materializes_seeded(name, fn):
    model = deferred_init(fn)
    assert all(is_fake(p) for p in model.parameters()), name
    values = materialize_module_torch(model, device="cpu", seed=0)
    fakes = recorded(model)
    assert values and sorted(values) == sorted(fakes), name
    torch.manual_seed(0)
    eager = fn()
    n_eager = sum(p.numel() for p in eager.parameters()) + sum(
        b.numel() for b in eager.buffers())
    n_real_bufs = sum(b.numel() for _, b in model.named_buffers() if not is_fake(b))
    assert sum(v.numel() for v in values.values()) == n_eager - n_real_bufs, name
    want = _state(eager)
    for key, fake in fakes.items():
        assert_like(values[key], want[key], is_random(fake), f"{name} {key}")


@pytest.mark.parametrize("name,fn", [c for c in CASES if c[0] in DECODERS],
                         ids=[n for n, _ in CASES if n in DECODERS])
def test_hf_deterministic_values_equal_jax(name, fn):
    model = deferred_init(fn)
    fakes = recorded(model)
    exact = [k for k, f in fakes.items() if not is_random(f)]
    assert exact, name
    ours = materialize_module_torch(model, device="cpu", seed=0)
    theirs = materialize_module_jax(jdi.deferred_init(fn), _fallback_torch=False)
    for key in exact:
        got, want = ours[key].numpy(), np.asarray(theirs[key])
        if np.issubdtype(want.dtype, np.floating):
            # XLA's pow rounds the rotary inv_freq 1 ulp away from torch's
            # (1.2e-7 relative) in the JAX package's replay; the port's
            # value is eager torch's bit for bit (the test above).
            np.testing.assert_allclose(got, want, rtol=JAX_FLOAT_RTOL, atol=0,
                                       err_msg=f"{name} {key}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {key}")
