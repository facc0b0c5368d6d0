"""Head dims that the flash kernels have no instance for (all up to 512 but
64, 128, 256 and 512): the wrappers zero-pad q, k, v and ``do`` to the next
instance, run at the true head dim's scale and cut out, dq, dk and dv back.

The identity behind it is checked here on the plain versions, and the
wrappers (which pad on the CPU as on the card) are held against the unpadded
plain result.  float32, made with torch from a seed; tolerance atol 1e-6
(the padded columns are exact zeros, so only summation order can differ).
"""

import math

import pytest
import torch
import torch.nn.functional as F

from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

ATOL = 1e-6
HEAD_DIMS = [16, 32, 48, 80, 96, 160, 192, 256]


def _inputs(d, seed, b=2, s=37, hq=4, hkv=2):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, hq, d), generator=g)
    k = torch.randn((b, s, hkv, d), generator=g)
    v = torch.randn((b, s, hkv, d), generator=g)
    do = torch.randn((b, s, hq, d), generator=g)
    return q, k, v, do


def _close(got, want):
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("d, kernel_d", [(16, 64), (32, 64), (48, 64), (64, 64),
                                         (80, 128), (96, 128), (128, 128), (192, 256),
                                         (256, 256), (320, 512), (512, 512), (640, 640)])
def test_kernel_head_dim(d, kernel_d):
    # The least instance that holds d; above 512 the launch refuses d itself.
    assert fa._kernel_head_dim(d) == kernel_d


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padded_plain_versions_equal_unpadded(d, causal):
    q, k, v, do = _inputs(d, seed=d)
    pad = fa._kernel_head_dim(d) - d
    qp, kp, vp, dop = (F.pad(t, (0, pad)) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)

    out, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    out_p, lse_p = fa.flash_attention_reference(qp, kp, vp, causal=causal, scale=scale)
    _close(out_p[..., :d], out)
    assert not out_p[..., d:].any()
    _close(lse_p, lse)

    delta = fa.attention_delta(do, out)
    _close(fa.attention_delta(dop, out_p), delta)
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal=causal)
    got = fa.flash_bwd_plain(qp, kp, vp, dop, lse_p, delta, causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g[..., :d], w)
        assert not g[..., d:].any(), name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_wrappers_pad_and_cut(d, causal):
    q, k, v, do = _inputs(d, seed=100 + d)
    out, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    delta = fa.attention_delta(do, out)
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal=causal)

    got_out, got_lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    _close(got_out, out)
    _close(got_lse, lse)
    for route in ("fused", "streamed"):
        got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal, route=route)
        for g, w in zip(got, want):
            _close(g, w)

    # Through autograd: the Function runs on the padded tensors and autograd
    # cuts the gradients back to d.
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    res = fa.flash_attention(qr, kr, vr, causal=causal)
    _close(res, out)
    res.backward(do)
    for g, w in zip((qr.grad, kr.grad, vr.grad), want):
        _close(g, w)
