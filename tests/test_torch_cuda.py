"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips with a reason on a host without CUDA.
Imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.cuda

# (out, lse) tolerances against the plain version: bf16 rounds out and p
# to bf16 (p against a running max in the kernel, the row max in the plain
# version); float32 differs by summation order only.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
# 127, 128 and 129: one q tile of the bf16 kernel minus one, exactly one,
# and plus one; 1000 with 8 q heads on one kv head: a long ragged GQA case.
@pytest.mark.parametrize(
    "s, hq, hkv",
    [(1, 4, 4), (77, 8, 2), (300, 4, 1), (127, 4, 4), (128, 8, 2), (129, 8, 8), (1000, 8, 1)],
)
def test_flash_fwd_matches_plain(cuda, dtype, d, causal, s, hq, hkv):
    g = torch.Generator(device=cuda).manual_seed(s * d)
    q = torch.randn((2, s, hq, d), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((2, s, hkv, d), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((2, s, hkv, d), generator=g, device=cuda, dtype=dtype)
    n0 = fa.launches
    out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    tol_out, tol_lse = TOL[dtype]
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_out
    assert (lse - ref_lse).abs().max().item() <= tol_lse


def test_flash_fwd_is_deterministic(cuda):
    # The forward sums in a fixed order and uses no atomics: two calls on
    # the same inputs give the same bits (the Llama-7B training shape).
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (
        torch.randn((4, 512, 32, 128), generator=g, device=cuda, dtype=torch.bfloat16)
        for _ in range(3)
    )
    out1, lse1 = fa.flash_attention_fwd_with_lse(q, k, v, causal=True)
    out2, lse2 = fa.flash_attention_fwd_with_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)


def test_flash_rejects_unsupported_head_dim(cuda):
    q = torch.zeros((1, 8, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)


# (dq, dk, dv) tolerance against the plain version, on the largest error
# relative to max(1, the largest |plain| value): bf16 rounds p, ds and the
# outputs to bf16 (2^-8 relative), and a pair whose p or ds lands on the
# other side of a rounding step moves its products by that much; f32 differs
# by summation order only (the fused dq also by the order, varying from run
# to run, in which blocks add to it).
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _bwd_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item() / max(
        1.0, want.float().abs().max().item()
    )


def _bwd_inputs(g, b, s, hq, hkv, d, dtype, causal, device):
    q = torch.randn((b, s, hq, d), generator=g, device=device, dtype=dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device=device, dtype=dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device=device, dtype=dtype)
    do = torch.randn((b, s, hq, d), generator=g, device=device, dtype=dtype)
    out, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    return q, k, v, do, out, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
# 63, 64, 65 and 127, 128, 129 with 8 q heads on one kv head: the bf16
# streamed kernels' tile edges (dk/dv: kv and q tiles of 64; dq: q tiles of
# 128, kv tiles of 64).
@pytest.mark.parametrize(
    "s, hq, hkv",
    [(1, 4, 4), (77, 8, 2), (300, 4, 1), (2049, 4, 4), (63, 8, 1), (64, 8, 1), (65, 8, 1),
     (127, 8, 1), (128, 8, 1), (129, 8, 1)],
)
@pytest.mark.parametrize("route", ["fused", "streamed"])
def test_flash_bwd_matches_plain(cuda, dtype, d, causal, s, hq, hkv, route):
    g = torch.Generator(device=cuda).manual_seed(s * d + 1)
    q, k, v, do, out, lse = _bwd_inputs(g, 2, s, hq, hkv, d, dtype, causal, cuda)
    counts = (fa.launches_bwd_fused, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal, route=route)
    torch.cuda.synchronize()
    fused = route == "fused"
    assert (fa.launches_bwd_fused, fa.launches_bwd_dq, fa.launches_bwd_dkv) == (
        counts[0] + fused, counts[1] + (not fused), counts[2] + (not fused)
    )
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert bool(torch.isfinite(a).all()), name
        assert _bwd_err(a, b) <= BWD_TOL[dtype], (name, _bwd_err(a, b))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_bwd_streamed_is_deterministic(cuda, causal):
    # The streamed pair sums in a fixed order and uses no atomics: two calls
    # on the same inputs give the same bits, and no launch writes its
    # inputs (a ragged GQA shape across several tiles).
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v, do, out, lse = _bwd_inputs(g, 1, 1000, 8, 2, 128, torch.bfloat16, causal, cuda)
    delta = fa.attention_delta(do, out)
    args = (q, k, v, do, lse, delta)
    before = [t.clone() for t in args]
    dq1 = fa.flash_bwd_dq(*args, causal=causal)
    dk1, dv1 = fa.flash_bwd_dkv(*args, causal=causal)
    dq2 = fa.flash_bwd_dq(*args, causal=causal)
    dk2, dv2 = fa.flash_bwd_dkv(*args, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2) and torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    assert all(torch.equal(a, b) for a, b in zip(args, before))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_fused_dkv_is_deterministic(cuda, causal, d):
    # The fused kernel's blocks own their dk and dv rows and sum them in a
    # fixed order: two calls give the same dk and dv bits.  dq is summed
    # across blocks by TMA reductions in an order that varies, so only its
    # last bits may differ; no launch writes its inputs (a ragged GQA shape
    # over several works).
    g = torch.Generator(device=cuda).manual_seed(17)
    q, k, v, do, out, lse = _bwd_inputs(g, 2, 1000, 8, 2, d, torch.bfloat16, causal, cuda)
    delta = fa.attention_delta(do, out)
    args = (q, k, v, do, lse, delta)
    before = [t.clone() for t in args]
    dq1, dk1, dv1 = fa.flash_bwd_fused(*args, causal=causal)
    dq2, dk2, dv2 = fa.flash_bwd_fused(*args, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    assert _bwd_err(dq1, dq2) <= BWD_TOL[torch.bfloat16]
    assert all(torch.equal(a, b) for a, b in zip(args, before))


def test_flash_function_gradcheck(cuda):
    # float32 against finite differences of the forward kernel, at a small
    # shape with GQA and a ragged tile.  float32 (the kernels take no
    # float64) needs a wide step and tolerance; nondet_tol admits the fused
    # dq's atomics.
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (
        torch.randn((1, 19, h, 64), generator=g, device=cuda, dtype=torch.float32)
        .requires_grad_()
        for h in (4, 2, 2)
    )
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, causal=True),
        (q, k, v), eps=1e-3, atol=5e-3, rtol=5e-3, nondet_tol=1e-5, fast_mode=True,
    )


def test_flash_backward_default_route_and_launches(cuda):
    n0 = (fa.launches, fa.launches_bwd_fused, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    for s in (512, 2049):
        q = torch.randn((1, s, 2, 64), device=cuda, dtype=torch.bfloat16, requires_grad=True)
        fa.flash_attention(q, q.detach(), q.detach()).sum().backward()
    torch.cuda.synchronize()
    n1 = (fa.launches, fa.launches_bwd_fused, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    assert [b - a for a, b in zip(n0, n1)] == [2, 1, 1, 1]
    assert fa.backward_route(512) == "fused" and fa.backward_route(2049) == "streamed"
