"""The port's flash-attention forward (plain version, on the CPU) against the
JAX Pallas kernel run through the Pallas interpreter and against the JAX
``mha_reference``.  Inputs are float32, made with numpy from a seed.

Tolerance: atol 1e-5 (float32; the two sides sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.ops.attention import mha_reference as jax_mha
from torchdistx_tpu.ops.pallas.flash_attention import _fa_forward_padded, _pad_len
from torchdistx_tpu_torch.ops import attention as tattn
from torchdistx_tpu_torch.ops.cuda import flash_attention as tfa

ATOL = 1e-5


def _inputs(s, hq, hkv, d=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _jax_kernel(q, k, v, causal):
    """(out (B,S,H,D), lse (B,H,S)) of the Pallas forward, interpreted."""
    s = q.shape[1]
    s_pad = _pad_len(s)

    def pad(x):
        x = jnp.asarray(x).transpose(0, 2, 1, 3)
        return jnp.pad(x, ((0, 0), (0, 0), (0, s_pad - s), (0, 0)))

    out, lse = _fa_forward_padded(
        pad(q), pad(k), pad(v), s, causal=causal, interpret=True
    )
    out = np.asarray(out)[:, :, :s].transpose(0, 2, 1, 3)
    return out, np.asarray(lse)[:, :, :s, 0]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("s", [1, 37, 200])
def test_reference_matches_jax_kernel(causal, heads, s):
    q, k, v = _inputs(s, *heads)
    j_out, j_lse = _jax_kernel(q, k, v, causal)
    t_out, t_lse = tfa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
    )
    assert t_out.shape == q.shape and t_lse.shape == (2, heads[0], s)
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, atol=ATOL, rtol=0)
    # The JAX plain attention computes the same function.
    j_ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(t_out.numpy(), j_ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_port_mha_reference_matches_jax(causal):
    q, k, v = _inputs(23, 4, 2, seed=3)
    j = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    t = tattn.mha_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    np.testing.assert_allclose(t.numpy(), j, atol=ATOL, rtol=0)


def test_cpu_path_does_not_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(37, 4, 2, seed=1))
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, causal=True)
    out2, lse = tfa.flash_attention_fwd_with_lse(q, k, v, causal=True)
    assert tfa.launches == before
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, ref_out) and torch.equal(out2, ref_out)
    assert torch.equal(lse, ref_lse)


def test_explicit_kernel_request_on_cpu_raises():
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 4, 2))
    with pytest.raises(ValueError, match="needs CUDA"):
        tattn.attention(q, k, v, impl="flash")
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(q, k, v, impl="pallas")


def test_auto_on_cpu_is_plain():
    q, k, v = (torch.from_numpy(a) for a in _inputs(19, 4, 2, seed=2))
    assert torch.equal(
        tattn.attention(q, k, v, impl="auto"), tattn.mha_reference(q, k, v)
    )


@pytest.mark.parametrize(
    "shapes, match",
    [
        (((1, 8, 4, 16), (1, 8, 3, 16)), "multiple"),
        (((1, 8, 4, 16), (1, 9, 2, 16)), "do not match"),
    ],
    ids=["heads", "seq"],
)
def test_wrapper_rejects_bad_shapes(shapes, match):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_fwd_with_lse(q, k, k.clone())
