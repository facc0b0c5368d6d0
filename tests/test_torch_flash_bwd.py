"""The port's flash-attention backward (plain versions and the autograd
Function, on the CPU) against the JAX Pallas backward kernels run through
the Pallas interpreter, and against ``jax.grad`` of the JAX
``flash_attention``.  Inputs are float32, made with numpy from a seed.

Tolerance: atol 1e-5 (float32; the two sides sum in different orders).
It holds for dk and dv too, which sum over up to 200 q rows and the GQA
group: their largest errors here are about 2e-6, on values up to 5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdistx_tpu.ops.pallas import flash_attention as jfa
from torchdistx_tpu_torch.ops.cuda import flash_attention as tfa

ATOL = 1e-5


def _inputs(s, hq, hkv, d=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    return q, k, v, do


def _pad(x, s_pad):
    """(B, S, H, D) numpy -> (B, H, S_pad, D) jnp, zero-padded."""
    x = jnp.asarray(x).transpose(0, 2, 1, 3)
    return jnp.pad(x, ((0, 0), (0, 0), (0, s_pad - x.shape[2]), (0, 0)))


def _jax_backward(q, k, v, do, causal, streamed):
    """(out, lse, dq, dk, dv) of the Pallas forward and backward kernels,
    interpreted, back in the port's layout: (B, S, H, D), lse (B, H, S)."""
    s = q.shape[1]
    s_pad = jfa._pad_len(s)
    qp, kp, vp, dop = (_pad(x, s_pad) for x in (q, k, v, do))
    out, lse = jfa._fa_forward_padded(qp, kp, vp, s, causal=causal, interpret=True)
    if streamed:
        grads = jfa._fa_backward_streamed(
            qp, kp, vp, out, lse, dop, s, causal=causal, interpret=True,
            bq=128, bkv=128,
        )
    else:
        grads = jfa._fa_backward_fused_nk1(
            qp, kp, vp, out, lse, dop, s, causal=causal, interpret=True
        )

    def unpad(x):
        return np.asarray(x)[:, :, :s].transpose(0, 2, 1, 3)

    return (unpad(out), np.asarray(lse)[:, :, :s, 0], *(unpad(g) for g in grads))


def _check_grads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
# (8, 1): a GQA group of 8, which the f32 kernels' cluster split walks
# head-major.
@pytest.mark.parametrize("heads", [(4, 2), (4, 4), (8, 1)], ids=["gqa", "mha", "gqa8"])
@pytest.mark.parametrize("s", [1, 37, 200])
def test_reference_matches_jax_fused_kernel(causal, heads, s):
    q, k, v, do = _inputs(s, *heads)
    out, lse, *want = _jax_backward(q, k, v, do, causal, streamed=False)
    got = tfa.flash_attention_backward_reference(
        *(torch.tensor(x) for x in (q, k, v, out, lse, do)), causal=causal
    )
    _check_grads(got, want)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4), (8, 1)], ids=["gqa", "mha", "gqa8"])
def test_reference_matches_jax_streamed_kernels(causal, heads):
    # S = 200 pads to 256: two q blocks and two kv blocks of 128.
    q, k, v, do = _inputs(200, *heads, seed=1)
    out, lse, *want = _jax_backward(q, k, v, do, causal, streamed=True)
    got = tfa.flash_attention_backward_reference(
        *(torch.tensor(x) for x in (q, k, v, out, lse, do)), causal=causal
    )
    _check_grads(got, want)


@pytest.mark.parametrize("route", ["fused", "streamed"])
def test_kernel_wrappers_on_cpu_are_the_plain_version(route):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(37, 4, 2, seed=2))
    out, lse = tfa.flash_attention_fwd_with_lse(q, k, v, causal=True)
    counts = (tfa.launches_bwd_fused, tfa.launches_bwd_dq, tfa.launches_bwd_dkv)
    got = tfa.flash_attention_backward(q, k, v, out, lse, do, causal=True, route=route)
    assert (tfa.launches_bwd_fused, tfa.launches_bwd_dq, tfa.launches_bwd_dkv) == counts
    want = tfa.flash_attention_backward_reference(q, k, v, out, lse, do, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("s", [1, 37, 200])
def test_function_grads_match_jax_grad(causal, heads, s):
    q, k, v, do = _inputs(s, *heads, seed=3)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, causal=causal, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (tq, tk, tv))
    _check_grads(got, [np.asarray(w) for w in want])


@pytest.mark.parametrize("s", [1, 2047, 2048, 2049, 4096])
def test_route_rule_matches_jax(monkeypatch, s):
    monkeypatch.setattr(jfa, "_fa_backward_fused_nk1", lambda *a, **kw: "fused")
    monkeypatch.setattr(jfa, "_fa_backward_streamed", lambda *a, **kw: "streamed")
    x = jnp.zeros((1, 1, jfa._pad_len(s), 16), jnp.float32)
    jax_route = jfa._fa_backward(x, x, x, x, x, x, s, causal=True, interpret=True)
    assert tfa.backward_route(s) == jax_route
    assert jax_route == ("fused" if jfa._pad_len(s) <= jfa._FUSED_BWD_MAX_KV else "streamed")


def test_backward_rejects_bad_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(8, 4, 2))
    out, lse = tfa.flash_attention_fwd_with_lse(q, k, v)
    with pytest.raises(ValueError, match="unknown flash backward route"):
        tfa.flash_attention_backward(q, k, v, out, lse, do, route="ring")
    with pytest.raises(ValueError, match="lse must be"):
        tfa.flash_bwd_fused(q, k, v, do, lse[:, :2], lse)
    with pytest.raises(ValueError, match="does not match q"):
        tfa.flash_bwd_dq(q, k, v, do[:, :4], lse, lse)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [192, 256, 320, 512])
def test_wide_head_dims_match_jax_flash_attention(causal, d):
    # Head dims above 128: the JAX flash_attention (interpreted) computes
    # them; the port's autograd Function pads 192 to its 256 instance and
    # 320 to its 512 instance, and runs 256 and 512 as they are.  Output and
    # gradients at 1e-5.
    q, k, v, do = _inputs(40, 2, 2, d=d, b=1, seed=d)
    j_out, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, causal=causal, interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)),
    )
    j_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=ATOL, rtol=0)
    _check_grads((tq.grad, tk.grad, tv.grad), [np.asarray(g) for g in j_grads])


# bf16 at head dims 256 and 512: the plain versions that the card holds
# the TMA + wgmma kernels against (flash_attention_reference,
# flash_bwd_plain), against the Pallas kernels (interpreted) on the same
# bf16 inputs.  At 256, the wgmma kernels' 64-row tile edges (1, 63, 64, 65,
# 127) and past them (129, 200: more than one 64-row tile, and the dq
# kernel's 128-row block) with GQA groups of 1, 2 and 4; at 512 (a case
# takes seconds in interpret mode), the edges of its 32-row tiles (33, 65,
# 129: the forward's kv tiles and dk/dv's q steps, and more than one 64-row
# q or kv tile) and S = 1, with the same groups: the fused Pallas backward
# at each, the streamed pair (blocks of 128, as _jax_backward runs it)
# where S pads to 128 or more.  Tolerances as on the card (chip_smoke.py's
# TOL and BWD_TOL): out within 2e-2 and lse within 1e-3 (bf16 rounds p and
# out to 2^-8 relative, p against a running max in Pallas and the row max in
# the plain version); dq, dk and dv within 2e-2 of max(1, their largest
# value) (p and ds rounded to bf16 before the products).
BF16_OUT_ATOL, BF16_LSE_ATOL, BF16_GRAD_TOL = 2e-2, 1e-3, 2e-2


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize(
    "d, s, hq, hkv",
    [pytest.param(256, *shape, id="-".join(map(str, shape)))
     for shape in [(1, 2, 2), (63, 2, 1), (64, 2, 2), (65, 2, 1), (127, 2, 2), (129, 4, 2),
                   (200, 4, 1)]]
    + [pytest.param(512, *shape, id="d512-" + "-".join(map(str, shape)))
       for shape in [(1, 2, 2), (33, 2, 1), (65, 4, 1), (129, 4, 2)]])
def test_bf16_d256_plain_versions_match_jax_kernels(causal, d, s, hq, hkv):
    q, k, v, do = (jnp.asarray(x, jnp.bfloat16)
                   for x in _inputs(s, hq, hkv, d=d, b=1, seed=s + d))
    tq, tk, tv, tdo = (torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
                       for x in (q, k, v, do))
    for streamed in (False, True)[:1 + (jfa._pad_len(s) >= 128)]:
        out, lse, *want = _jax_backward(q, k, v, do, causal, streamed=streamed)
        if not streamed:
            got_out, got_lse = tfa.flash_attention_reference(tq, tk, tv, causal=causal)
            np.testing.assert_allclose(got_out.float().numpy(), np.asarray(out, np.float32),
                                       atol=BF16_OUT_ATOL, rtol=0)
            np.testing.assert_allclose(got_lse.numpy(), lse, atol=BF16_LSE_ATOL, rtol=0)
        t_out = torch.tensor(np.asarray(out, np.float32)).to(torch.bfloat16)
        t_lse = torch.tensor(np.asarray(lse, np.float32))
        got = tfa.flash_bwd_plain(tq, tk, tv, tdo, t_lse, tfa.attention_delta(tdo, t_out),
                                  causal=causal)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            w = np.asarray(w, np.float32)
            assert g.dtype == torch.bfloat16, name
            err = np.abs(g.float().numpy() - w).max() / max(1.0, np.abs(w).max())
            assert err <= BF16_GRAD_TOL, (streamed, name, err)
