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
    # Head dims up to 512 are padded to an instance; above it the launch refuses.
    q = torch.zeros((1, 8, 2, 640), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim up to 512"):
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


# Head dims without a kernel instance: zero-padded to 64, 128 or 256 and cut
# back.
PADDED_HEAD_DIMS = [16, 32, 48, 80, 96, 160, 192]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", PADDED_HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_padded_head_dims_match_plain(cuda, dtype, d, causal):
    g = torch.Generator(device=cuda).manual_seed(d + 3)
    q, k, v, do, ref_out, ref_lse = _bwd_inputs(g, 2, 300, 8, 2, d, dtype, causal, cuda)
    n0 = fa.launches
    out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1 and out.shape == q.shape
    tol_out, tol_lse = TOL[dtype]
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_out
    assert (lse - ref_lse).abs().max().item() <= tol_lse
    want = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse, do, causal=causal)
    for route in ("fused", "streamed"):
        got = fa.flash_attention_backward(q, k, v, ref_out, ref_lse, do, causal=causal,
                                          route=route)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, (route, name)
            assert _bwd_err(a, b) <= BWD_TOL[dtype], (route, name, _bwd_err(a, b))


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
# The D = 256 instances: bf16's on TMA + wgmma (tiles of 64 q and 64 kv
# rows; the dq kernel's blocks of 128 q rows), f32's on the CUDA cores (q
# tiles of 16, kv tiles of 32).  The CUDA-core tiles' edges (15, 16, 17,
# 33), then the wgmma tiles' (63, 64, 65, 127) and longer ragged sequences
# (1000, 2112: the D = 256 path's bf16 step, 4095) at GQA groups of 1, 2
# and 8, past the fused route's 2048 too.
@pytest.mark.parametrize("s, hq, hkv", [(1, 2, 2), (15, 4, 1), (16, 4, 2), (17, 4, 4),
                                        (33, 8, 2), (300, 4, 1), (2049, 2, 2),
                                        (63, 4, 4), (64, 4, 2), (65, 8, 1), (127, 8, 8),
                                        (1000, 8, 1), (2112, 4, 2), (4095, 8, 1)])
def test_flash_d256_matches_plain(cuda, dtype, causal, s, hq, hkv):
    g = torch.Generator(device=cuda).manual_seed(s + 256)
    q, k, v, do, ref_out, ref_lse = _bwd_inputs(g, 2, s, hq, hkv, 256, dtype, causal, cuda)
    n0 = fa.launches
    out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    tol_out, tol_lse = TOL[dtype]
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_out
    assert (lse - ref_lse).abs().max().item() <= tol_lse
    want = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse, do, causal=causal)
    for route in ("fused", "streamed"):
        got = fa.flash_attention_backward(q, k, v, ref_out, ref_lse, do, causal=causal,
                                          route=route)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, (route, name)
            assert bool(torch.isfinite(a).all()), (route, name)
            assert _bwd_err(a, b) <= BWD_TOL[dtype], (route, name, _bwd_err(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [320, 512])
# The D = 512 instances (bf16 and f32), and 320 padded to them: the shapes
# of the D = 256 test (the f32 CUDA-core kv-tile body's tiles are 16 rows
# here), then the edges of the bf16 TMA + wgmma tiles (the forward's and
# dq's 32-row kv tiles and 64-row q tiles, dk/dv's and the fused kernel's
# 32-row q steps and 64 kv rows: 31, 32, 33, 63, 65, 129) at GQA groups of
# 1, 2, 4 and 8.
@pytest.mark.parametrize("s, hq, hkv", [(1, 2, 2), (15, 4, 1), (16, 4, 2), (17, 4, 4),
                                        (33, 8, 2), (300, 4, 1), (2049, 2, 2),
                                        (31, 2, 2), (32, 4, 2), (33, 4, 4), (63, 4, 1),
                                        (65, 4, 2), (129, 8, 2), (32, 8, 1), (65, 8, 1)])
def test_flash_d512_matches_plain(cuda, dtype, causal, d, s, hq, hkv):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v, do, ref_out, ref_lse = _bwd_inputs(g, 2, s, hq, hkv, d, dtype, causal, cuda)
    n0 = fa.launches
    out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1 and out.shape == q.shape
    tol_out, tol_lse = TOL[dtype]
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_out
    assert (lse - ref_lse).abs().max().item() <= tol_lse
    want = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse, do, causal=causal)
    for route in ("fused", "streamed"):
        got = fa.flash_attention_backward(q, k, v, ref_out, ref_lse, do, causal=causal,
                                          route=route)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, (route, name)
            assert bool(torch.isfinite(a).all()), (route, name)
            assert _bwd_err(a, b) <= BWD_TOL[dtype], (route, name, _bwd_err(a, b))


def test_flash_d256_gradients_through_autograd(cuda):
    # A head dim of 200 runs the D = 256 instances through the autograd
    # Function (padded, then cut back) and matches the plain gradients.
    g = torch.Generator(device=cuda).manual_seed(200)
    q, k, v, do, ref_out, ref_lse = _bwd_inputs(g, 2, 100, 4, 2, 200, torch.float32, True,
                                                cuda)
    want = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse, do, causal=True)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qr, kr, vr, causal=True)
    out.backward(do)
    assert out.shape == q.shape
    assert (out - ref_out).abs().max().item() <= TOL[torch.float32][0]
    for name, a, b in zip(("dq", "dk", "dv"), (qr.grad, kr.grad, vr.grad), want):
        assert a.shape == b.shape, name
        assert _bwd_err(a, b) <= BWD_TOL[torch.float32], (name, _bwd_err(a, b))


def test_flash_d192_bf16_takes_the_wgmma_d256_kernels_through_autograd(cuda):
    # Head dim 192 pads to the 256 instances; in bf16 past the fused
    # route's 2048 (the D = 256 path's 1 x 2112, 4/2 heads) the autograd
    # Function runs the TMA + wgmma forward, dq and dk/dv, and matches the
    # plain gradients.
    assert fa._kernel_head_dim(192) == 256
    g = torch.Generator(device=cuda).manual_seed(192)
    q, k, v, do, ref_out, ref_lse = _bwd_inputs(g, 1, 2112, 4, 2, 192, torch.bfloat16, True,
                                                cuda)
    want = fa.flash_attention_backward_reference(q, k, v, ref_out, ref_lse, do, causal=True)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    n0 = (fa.launches, fa.launches_bwd_fused, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    out = fa.flash_attention(qr, kr, vr, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    n1 = (fa.launches, fa.launches_bwd_fused, fa.launches_bwd_dq, fa.launches_bwd_dkv)
    assert [b - a for a, b in zip(n0, n1)] == [1, 0, 1, 1]
    assert out.shape == q.shape
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL[torch.bfloat16][0]
    for name, a, b in zip(("dq", "dk", "dv"), (qr.grad, kr.grad, vr.grad), want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _bwd_err(a, b) <= BWD_TOL[torch.bfloat16], (name, _bwd_err(a, b))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_d256_bf16_dkv_and_forward_are_deterministic(cuda, causal):
    # The D = 256 bf16 dk/dv and dq kernels own their output rows and sum
    # them in a fixed order (no atomics), as the forward does its out and
    # lse, and the fused kernel does its dk and dv (its dq is summed across
    # blocks): a second call gives the same bits, and no launch writes its
    # inputs (a ragged GQA shape over several tiles of 64).
    g = torch.Generator(device=cuda).manual_seed(256 + causal)
    q, k, v, do, out, lse = _bwd_inputs(g, 2, 1000, 8, 2, 256, torch.bfloat16, causal, cuda)
    delta = fa.attention_delta(do, out)
    args = (q, k, v, do, lse, delta)
    before = [t.clone() for t in args]
    dk1, dv1 = fa.flash_bwd_dkv(*args, causal=causal)
    dk2, dv2 = fa.flash_bwd_dkv(*args, causal=causal)
    dq1 = fa.flash_bwd_dq(*args, causal=causal)
    dq2 = fa.flash_bwd_dq(*args, causal=causal)
    _, fdk1, fdv1 = fa.flash_bwd_fused(*args, causal=causal)
    _, fdk2, fdv2 = fa.flash_bwd_fused(*args, causal=causal)
    out1, lse1 = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    out2, lse2 = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    assert torch.equal(dq1, dq2)
    assert torch.equal(fdk1, fdk2) and torch.equal(fdv1, fdv2)
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
    assert all(torch.equal(a, b) for a, b in zip(args, before))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_d512_bf16_dkv_and_forward_are_deterministic(cuda, causal):
    # The D = 512 dk/dv, fused and dq kernels sum each step's partial
    # products from the two blocks of a cluster in the same order in both,
    # and each block owns its columns of dk and dv (dk/dv, fused) or dq (dq,
    # whose two warpgroups' sums it adds in a fixed order): a second call
    # gives the same bits, as the forward does (the fused kernel's dq is
    # summed across blocks, so only its dk and dv), and no launch writes its
    # inputs (a ragged GQA shape over several kv tiles and q steps).
    g = torch.Generator(device=cuda).manual_seed(512 + causal)
    q, k, v, do, out, lse = _bwd_inputs(g, 2, 333, 8, 2, 512, torch.bfloat16, causal, cuda)
    delta = fa.attention_delta(do, out)
    args = (q, k, v, do, lse, delta)
    before = [t.clone() for t in args]
    n0 = (fa.launches_bwd_dkv, fa.launches_bwd_fused, fa.launches_bwd_dq)
    dk1, dv1 = fa.flash_bwd_dkv(*args, causal=causal)
    dk2, dv2 = fa.flash_bwd_dkv(*args, causal=causal)
    _, fdk1, fdv1 = fa.flash_bwd_fused(*args, causal=causal)
    _, fdk2, fdv2 = fa.flash_bwd_fused(*args, causal=causal)
    dq1 = fa.flash_bwd_dq(*args, causal=causal)
    dq2 = fa.flash_bwd_dq(*args, causal=causal)
    out1, lse1 = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    out2, lse2 = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dkv, fa.launches_bwd_fused, fa.launches_bwd_dq) == tuple(
        n + 2 for n in n0)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    assert torch.equal(fdk1, fdk2) and torch.equal(fdv1, fdv2)
    assert torch.equal(dq1, dq2)
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
    assert all(torch.equal(a, b) for a, b in zip(args, before))


def test_flash_d512_dkv_cluster_launch_error_is_raised(cuda):
    # A grid the card refuses: 65,536 tiles of 64 kv rows put 65,536
    # clusters on the grid's y axis, one more than it takes.  The cluster
    # launch's own error reaches the wrapper, which raises and counts no
    # launch; the card is left without a pending error, so the next launch
    # runs.  (About 26 GB of uninitialised inputs and outputs, never read.)
    s = 64 * 65535 + 1
    q, k, v, do = (torch.empty((1, s, 1, 512), device=cuda, dtype=torch.bfloat16)
                   for _ in range(4))
    lse, delta = (torch.empty((1, 1, s), device=cuda) for _ in range(2))
    n0 = fa.launches_bwd_dkv
    with pytest.raises(RuntimeError, match="flash_bwd_dkv launch failed: CUDA error"):
        fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    assert fa.launches_bwd_dkv == n0
    del q, k, v, do, lse, delta
    torch.cuda.synchronize()
    g = torch.Generator(device=cuda).manual_seed(65)
    q, k, v, do, out, lse = _bwd_inputs(g, 1, 65, 2, 2, 512, torch.bfloat16, True, cuda)
    delta = fa.attention_delta(do, out)
    got = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal=True, dq=False)[1:]
    torch.cuda.synchronize()
    assert fa.launches_bwd_dkv == n0 + 1
    for a, b in zip(got, want):
        assert _bwd_err(a, b) <= BWD_TOL[torch.bfloat16]


# The D = 512 fused and dq kernels' cluster launches: each wrapper's launch
# counter and the plain version's (dq, dk, dv) that holds what it returns.
D512_CLUSTER_LAUNCHES = {
    "flash_bwd_fused": ("launches_bwd_fused", {}),
    "flash_bwd_dq": ("launches_bwd_dq", {"dkv": False}),
}


@pytest.mark.parametrize("kernel", sorted(D512_CLUSTER_LAUNCHES))
def test_flash_d512_fused_and_dq_cluster_launch_errors_are_raised(cuda, kernel):
    # As for dk/dv: 65,536 tiles of 64 rows (the fused kernel's kv tiles,
    # dq's q tiles) put 65,536 clusters on the grid's y axis, one more than
    # it takes.  The wrapper raises with the launch's own error and counts
    # no launch, and the next launch runs.  (Up to 34 GB of uninitialised
    # inputs and outputs, never read; the fused kernel's f32 dq is zeroed.)
    counter, plain_kw = D512_CLUSTER_LAUNCHES[kernel]
    launch = getattr(fa, kernel)
    s = 64 * 65535 + 1
    q, k, v, do = (torch.empty((1, s, 1, 512), device=cuda, dtype=torch.bfloat16)
                   for _ in range(4))
    lse, delta = (torch.empty((1, 1, s), device=cuda) for _ in range(2))
    n0 = getattr(fa, counter)
    with pytest.raises(RuntimeError, match=f"{kernel} launch failed: CUDA error"):
        launch(q, k, v, do, lse, delta, causal=True)
    assert getattr(fa, counter) == n0
    del q, k, v, do, lse, delta
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    g = torch.Generator(device=cuda).manual_seed(65)
    q, k, v, do, out, lse = _bwd_inputs(g, 1, 65, 2, 2, 512, torch.bfloat16, True, cuda)
    delta = fa.attention_delta(do, out)
    got = launch(q, k, v, do, lse, delta, causal=True)
    got = got if isinstance(got, tuple) else (got,)
    want = [w for w in fa.flash_bwd_plain(q, k, v, do, lse, delta, causal=True, **plain_kw)
            if w is not None]
    torch.cuda.synchronize()
    assert getattr(fa, counter) == n0 + 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _bwd_err(a, b) <= BWD_TOL[torch.bfloat16]


def test_d512_wgmma_instances_compile_without_spills(cuda, tmp_path):
    # ptxas's report of the bf16 D = 512 forward, fused backward, dq and
    # dk/dv (TMA + wgmma), compiled as the build compiles them: all present,
    # no spills, and the CUDA-core bodies they replaced no longer
    # instantiated.
    import subprocess

    import chip_smoke
    from torchdistx_tpu_torch.ops.cuda import _build

    logs = {}
    for name in chip_smoke.D512_WGMMA:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(tmp_path / f"lib{name}.so"), str(_build.SRC_DIR / f"{name}.cu")],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        logs[name] = proc.stdout + proc.stderr
    report = chip_smoke._ptxas_report(logs)
    for instance in chip_smoke.D512_WGMMA.values():
        entry = chip_smoke._in_report(report, instance)
        assert entry is not None, (instance, sorted(report))
        assert entry["spill_stores"] == entry["spill_loads"] == 0, (instance, entry)
    for gone in ("flash_fwd_f32<__nv_bfloat16, (int)512>",
                 "bwd_kv_f32<__nv_bfloat16, (int)512, (bool)0>",
                 "bwd_kv_f32<__nv_bfloat16, (int)512, (bool)1>",
                 "bwd_dq_f32<__nv_bfloat16, (int)512>"):
        assert chip_smoke._in_report(report, gone) is None, gone


def test_d256_wgmma_instances_compile_without_spills(cuda, tmp_path):
    # ptxas's report of the bf16 D = 256 instances (TMA + wgmma), compiled
    # as the build compiles them: all four present, no spills, and no
    # CUDA-core bf16 instance left in any source at D = 256.
    import subprocess

    import chip_smoke
    from torchdistx_tpu_torch.ops.cuda import _build

    logs = {}
    for name in chip_smoke.D256_WGMMA:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(tmp_path / f"lib{name}.so"), str(_build.SRC_DIR / f"{name}.cu")],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        logs[name] = proc.stdout + proc.stderr
    report = chip_smoke._ptxas_report(logs)
    for instance in chip_smoke.D256_WGMMA.values():
        entry = chip_smoke._in_report(report, instance)
        assert entry is not None, (instance, sorted(report))
        assert entry["spill_stores"] == entry["spill_loads"] == 0, (instance, entry)
    for gone in ("flash_fwd_f32<__nv_bfloat16, (int)256>",
                 "bwd_kv_f32<__nv_bfloat16, (int)256, (bool)0>",
                 "bwd_kv_f32<__nv_bfloat16, (int)256, (bool)1>",
                 "bwd_dq_f32<__nv_bfloat16, (int)256>"):
        assert chip_smoke._in_report(report, gone) is None, gone


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 128, 256, 512])
# The f32 dk/dv and fused body (bwd_kv_f32_tiled): kv tiles of 32 rows and
# q tiles of 16 (64 x 32 at D 64, 16 x 16 at D 512), a kv tile's steps
# split over a cluster of up to 4 blocks where the tiles give the card
# fewer blocks than SMs.  S = 1, the tiles' edges (15, 17, 31, 33, 63, 65)
# and ragged sequences, at GQA groups of 1, 2, 4 and 8; 2 x 1000, 8/8 heads
# launches without a split.
@pytest.mark.parametrize("s, hq, hkv", [(1, 8, 1), (15, 4, 1), (17, 4, 2), (31, 2, 2),
                                        (33, 8, 1), (63, 4, 2), (65, 2, 1), (300, 8, 2),
                                        (77, 4, 4), (1000, 8, 8)])
def test_flash_f32_kv_kernels_match_plain(cuda, causal, d, s, hq, hkv):
    g = torch.Generator(device=cuda).manual_seed(s * 7 + d)
    q, k, v, do, out, lse = _bwd_inputs(g, 2, s, hq, hkv, d, torch.float32, causal, cuda)
    delta = fa.attention_delta(do, out)
    args = (q, k, v, do, lse, delta)
    before = [t.clone() for t in args]
    want = fa.flash_bwd_plain(*args, causal=causal)
    n_fused, n_dkv = fa.launches_bwd_fused, fa.launches_bwd_dkv
    fused = [fa.flash_bwd_fused(*args, causal=causal) for _ in range(2)]
    dkv = [fa.flash_bwd_dkv(*args, causal=causal) for _ in range(2)]
    torch.cuda.synchronize()
    assert (fa.launches_bwd_fused, fa.launches_bwd_dkv) == (n_fused + 2, n_dkv + 2)
    assert all(torch.equal(a, b) for a, b in zip(args, before))
    for name, a, b in zip(("dq", "dk", "dv"), fused[0], want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _bwd_err(a, b) <= BWD_TOL[torch.float32], ("fused", name, _bwd_err(a, b))
    for name, a, b in zip(("dk", "dv"), dkv[0], want[1:]):
        assert _bwd_err(a, b) <= BWD_TOL[torch.float32], ("dkv", name, _bwd_err(a, b))
    # dk and dv are summed in a fixed order (the cluster's partials in rank
    # order): the same bits on every call, in both kernels.
    assert torch.equal(fused[0][1], fused[1][1]) and torch.equal(fused[0][2], fused[1][2])
    assert torch.equal(dkv[0][0], dkv[1][0]) and torch.equal(dkv[0][1], dkv[1][1])
    assert torch.equal(fused[0][1], dkv[0][0]) and torch.equal(fused[0][2], dkv[0][1])


def test_f32_kv_instances_compile_without_spills(cuda, tmp_path):
    # ptxas's report of the f32 dk/dv and fused instances (bwd_kv_f32_tiled at
    # D 64, 128, 256 and 512), compiled as the build compiles them: each
    # present, at most 255 registers, no spills; the f32 instances of the
    # CUDA-core body they replaced no longer instantiated.
    import subprocess

    import chip_smoke
    from torchdistx_tpu_torch.ops.cuda import _build

    logs = {}
    for name in ("flash_bwd_dkv", "flash_bwd_fused"):
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(tmp_path / f"lib{name}.so"), str(_build.SRC_DIR / f"{name}.cu")],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        logs[name] = proc.stdout + proc.stderr
    report = chip_smoke._ptxas_report(logs)
    for (kernel, d), instance in chip_smoke.F32_KV.items():
        entry = chip_smoke._in_report(report, instance)
        assert entry is not None, (instance, sorted(report))
        assert entry["spill_stores"] == entry["spill_loads"] == 0, (instance, entry)
        assert entry["registers"] <= 255, (instance, entry)
        gone = f"bwd_kv_f32<float, (int){d}, (bool){int(kernel == 'flash_bwd_fused')}>"
        assert chip_smoke._in_report(report, gone) is None, gone


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


def test_llama_test_trains_on_cuda_like_the_cpu_port(cuda):
    # llama_test has head_dim 16: the forward and 3 SGD steps on the card
    # (padded flash kernels, f32, TF32 off) against the CPU port (plain
    # attention) from the same weights, losses within 1e-5.
    from torchdistx_tpu_torch.models.llama import llama_test
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.1)

    cpu_init, cpu_step = make_train_step(llama_test(), sgd, device="cpu")
    gpu_init, gpu_step = make_train_step(llama_test(), sgd, device=cuda)
    cpu_state, gpu_state = cpu_init(0), gpu_init(1)
    gpu_state.model.load_state_dict(cpu_state.model.state_dict())
    g = torch.Generator().manual_seed(9)
    tokens = torch.randint(0, 256, (2, 33), generator=g)
    n0 = fa.launches
    with torch.no_grad():
        logits = gpu_state.model(tokens.to(cuda))
        want = cpu_state.model(tokens)
    assert fa.launches - n0 == llama_test().n_layers
    torch.testing.assert_close(logits.cpu(), want, atol=1e-5, rtol=0)
    for i in range(3):
        seq = torch.randint(0, 256, (2, 33), generator=g)
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        cpu_state, cpu_m = cpu_step(cpu_state, batch)
        gpu_state, gpu_m = gpu_step(gpu_state, batch)
        assert abs(gpu_m["loss"].item() - cpu_m["loss"].item()) <= 1e-5, i
        assert gpu_m["step"] == cpu_m["step"] == i + 1


def test_fit_and_checkpointer_keep_a_cuda_state_on_the_card(cuda, tmp_path):
    # fit and Checkpointer take no device: a state on the card is saved,
    # restored into init_fn's state in place and trained on, all on the card.
    from torchdistx_tpu_torch.models.llama import llama_test
    from torchdistx_tpu_torch.parallel.fit import fit
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    init_fn, step_fn = make_train_step(llama_test(), lambda ps: torch.optim.AdamW(ps, lr=1e-3))

    def batches():
        g = torch.Generator(device=cuda).manual_seed(3)
        while True:
            t = torch.randint(0, 256, (2, 16), generator=g, device=cuda)
            yield {"tokens": t, "targets": t}

    run = str(tmp_path / "run")
    first, _ = fit(init_fn, step_fn, batches(), seed=0, n_steps=2, checkpoint_dir=run,
                   checkpoint_every=2)
    saved = {k: v.clone() for k, v in first.optimizer.state_dict()["state"][0].items()}
    seen = []

    def probe(state, batch):
        if not seen:
            seen.append(state)
            opt = state.optimizer.state_dict()["state"][0]
            assert all(torch.equal(opt[k], saved[k]) for k in ("exp_avg", "exp_avg_sq"))
        return step_fn(state, batch)

    state, _ = fit(init_fn, probe, batches(), seed=0, n_steps=3, checkpoint_dir=run)
    assert state.step == 3 and seen[0].step == 2
    assert all(p.is_cuda for p in state.model.parameters())
    for s in state.optimizer.state.values():
        assert s["exp_avg"].is_cuda and s["exp_avg_sq"].is_cuda


def test_slowmo_step_on_cuda_like_the_cpu_port(cuda):
    # make_slowmo_train_step on the card with one replica (no group):
    # llama_test through the padded flash kernels, SGD 0.1 averaged every 2
    # steps, against the CPU port from the same weights (losses and
    # parameters within 1e-5; f32, TF32 off); the parameters equal prev
    # after each averaging step.
    from torchdistx_tpu_torch.models.llama import llama_test
    from torchdistx_tpu_torch.parallel.slowmo import SlowMomentumOptimizer
    from torchdistx_tpu_torch.parallel.train_step import make_slowmo_train_step

    def opt(ps):
        return SlowMomentumOptimizer(torch.optim.SGD(ps, lr=0.1), base_lr=0.1, slowmo_freq=2)

    cpu_init, cpu_step = make_slowmo_train_step(llama_test(), None, opt, device="cpu")
    gpu_init, gpu_step = make_slowmo_train_step(llama_test(), None, opt, device=cuda)
    cpu_state, gpu_state = cpu_init(0), gpu_init(0)
    gpu_state.model.load_state_dict(cpu_state.model.state_dict())
    seq = torch.randint(0, 256, (1, 2, 33), generator=torch.Generator().manual_seed(4))
    batch = {"tokens": seq[..., :-1], "targets": seq[..., 1:]}
    n0 = (fa.launches, fa.launches_bwd_fused)
    for i in range(1, 5):
        cpu_state, cpu_m = cpu_step(cpu_state, batch)
        gpu_state, gpu_m = gpu_step(gpu_state, batch)
        assert abs(gpu_m["loss"].item() - cpu_m["loss"].item()) <= 1e-5, i
        for a, b in zip(gpu_state.model.parameters(), cpu_state.model.parameters()):
            assert (a.cpu() - b).abs().max().item() <= 1e-5, i
        if i % 2 == 0:
            view = gpu_state.optimizer.slowmo_state
            assert all(torch.equal(p, q) for p, q in zip(gpu_state.model.parameters(),
                                                          view.prev))
    assert (fa.launches - n0[0], fa.launches_bwd_fused - n0[1]) == (8, 8)


def _family_pair(cuda, family, cfg):
    """A model of ``family`` at ``cfg`` on the CPU and the same weights on
    the card, through ``make_train_step(model=family)``'s seeded init, with
    their SGD steps."""
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.1)

    cpu_init, cpu_step = make_train_step(cfg, sgd, model=family, device="cpu")
    gpu_init, gpu_step = make_train_step(cfg, sgd, model=family, device=cuda)
    cpu_state, gpu_state = cpu_init(0), gpu_init(1)
    gpu_state.model.load_state_dict(cpu_state.model.state_dict())
    return (cpu_state, cpu_step), (gpu_state, gpu_step)


@pytest.mark.parametrize("family_name", ["gpt2", "moe"])
def test_test_config_trains_on_cuda_like_the_cpu_port(cuda, family_name):
    # gpt2_test / moe_test (head_dim 16, f32, TF32 off) on the card through
    # the padded flash kernels against the CPU port from the same weights:
    # logits (and MoE's aux) within 1e-5 with one forward launch a layer,
    # MoE's routing exactly, then 3 SGD steps' losses within 1e-5.
    import importlib

    family = importlib.import_module(f"torchdistx_tpu_torch.models.{family_name}")
    cfg = family.gpt2_test() if family_name == "gpt2" else family.moe_test()
    (cpu_state, cpu_step), (gpu_state, gpu_step) = _family_pair(cuda, family, cfg)
    g = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    n0 = fa.launches
    with torch.no_grad():
        if family_name == "moe":
            got, aux = gpu_state.model(tokens.to(cuda), return_aux=True)
            want, want_aux = cpu_state.model(tokens, return_aux=True)
            assert abs(aux.item() - want_aux.item()) <= 1e-5
            for i, (cb, gb) in enumerate(zip(cpu_state.model.layers, gpu_state.model.layers)):
                h = torch.randn(2, 33, cfg.dim, generator=g)
                rc = family.route(h, cb.router.weight, cfg)
                rg = family.route(h.to(cuda), gb.router.weight, cfg)
                assert torch.equal(rg.experts.cpu(), rc.experts), i
                assert torch.equal(rg.keep.cpu(), rc.keep), i
        else:
            got, want = gpu_state.model(tokens.to(cuda)), cpu_state.model(tokens)
    assert fa.launches - n0 == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    for i in range(3):
        seq = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        cpu_state, cpu_m = cpu_step(cpu_state, batch)
        gpu_state, gpu_m = gpu_step(gpu_state, batch)
        assert abs(gpu_m["loss"].item() - cpu_m["loss"].item()) <= 1e-5, i


def test_moe_zero_router_ties_on_cuda(cuda):
    # Uniform router probabilities pick experts 0..k-1 on the card too (the
    # stable sort), with the CPU's drops.
    from torchdistx_tpu_torch.models import moe

    cfg = moe.moe_test()
    h = torch.randn(4, 64, cfg.dim)
    router = torch.zeros(cfg.n_experts, cfg.dim)
    rc, rg = moe.route(h, router, cfg), moe.route(h.to(cuda), router.to(cuda), cfg)
    assert bool((rg.experts.cpu() == torch.arange(cfg.experts_per_token)).all())
    assert torch.equal(rg.keep.cpu(), rc.keep) and bool((~rc.keep).any())


@pytest.mark.parametrize("family_name", ["gpt2", "moe"])
def test_narrow_bf16_model_on_cuda_like_the_cpu_port(cuda, family_name):
    # A narrow bf16 model with 64-wide heads (the kernels' own instance, no
    # padding) on the card against the same weights on the CPU in f32: the
    # card's logits no farther from them than the CPU's own bf16 logits
    # (mean |dlogits| within 1.5 x, plus 1e-4), and one SGD step's loss
    # within 2e-2 of the CPU's bf16 step.
    import dataclasses
    import importlib

    family = importlib.import_module(f"torchdistx_tpu_torch.models.{family_name}")
    if family_name == "gpt2":
        cfg = family.GPT2Config(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                                max_seq_len=256)
    else:
        cfg = dataclasses.replace(family.MoEConfig(), vocab_size=512, dim=256, n_layers=2,
                                  n_heads=4, n_kv_heads=2, ffn_dim=512, max_seq_len=256)
    assert cfg.dtype == torch.bfloat16 and cfg.head_dim == 64
    (cpu_state, cpu_step), (gpu_state, gpu_step) = _family_pair(cuda, family, cfg)
    ref = dataclasses.replace(cfg, dtype=torch.float32)
    f32 = type(cpu_state.model)(ref, device="cpu")
    f32.load_state_dict({k: v.float() for k, v in cpu_state.model.state_dict().items()})
    g = torch.Generator().manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
    with torch.no_grad():
        want = f32(tokens)
        cpu_err = (cpu_state.model(tokens) - want).abs().mean().item()
        got = gpu_state.model(tokens.to(cuda)).cpu()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().mean().item() <= 1.5 * cpu_err + 1e-4
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    n0 = (fa.launches, fa.launches_bwd_fused)
    gpu_state, gpu_m = gpu_step(gpu_state, batch)
    cpu_state, cpu_m = cpu_step(cpu_state, batch)
    assert (fa.launches - n0[0], fa.launches_bwd_fused - n0[1]) == (2 * cfg.n_layers,
                                                                    cfg.n_layers)
    assert abs(gpu_m["loss"].item() - cpu_m["loss"].item()) <= 2e-2


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_decode_chunk_graph_replay_equals_eager(cuda, sampled):
    """The serving engine's decode chunk captured as one CUDA graph: a
    replay from a saved state gives the tokens and pages that the eager
    chunk gives from the same state, and a second replay with new inputs
    reuses the one capture."""
    import numpy as np

    from torchdistx_tpu_torch.models import llama as tllama
    from torchdistx_tpu_torch.serving import Engine

    torch.manual_seed(0)
    model = tllama.Llama(tllama.llama_test(), device=cuda).float()
    sample = dict(temperature=0.8, top_k=20) if sampled else {}
    eng = Engine(model, num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 prefix_cache=False, **sample)
    for i in range(2):
        eng.submit(np.arange(1, 9, dtype=np.int32) + i, max_new_tokens=30, key=i)
    eng.step()
    eng.step()  # both admitted; the graph is captured and replayed
    dec = eng.decoder()
    assert dec.graph is not None and eng.stats()["decode_graphs"] == 1
    state = (eng._tokens.copy(), eng._positions.copy(), eng._n_gen.copy(),
             eng._done.copy(), eng._keys.copy(), eng._tables.copy())
    pages = {n: p.clone() for n, p in eng._cache.items()}
    dec.load(*state)
    dec.replay()
    replayed = dec.out.clone()
    replayed_pages = {n: p.clone() for n, p in eng._cache.items()}
    for n, p in eng._cache.items():
        p.copy_(pages[n])
    dec.load(*state)
    dec.run_eager()
    torch.testing.assert_close(dec.out, replayed, rtol=0, atol=0)
    for n, p in eng._cache.items():
        torch.testing.assert_close(p[:, 1:], replayed_pages[n][:, 1:], rtol=0, atol=0)
    eng.drain()
    assert eng.stats()["decode_graphs"] == 1


def test_decode_chunk_failed_capture_raises(cuda, monkeypatch):
    """A failed capture of the decode chunk raises GraphCaptureError out of
    step(): the engine never falls back to eager decode on the card."""
    import numpy as np

    from torchdistx_tpu_torch.models import llama as tllama
    from torchdistx_tpu_torch.serving import Engine, GraphCaptureError

    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")

    torch.manual_seed(0)
    model = tllama.Llama(tllama.llama_test(), device=cuda)
    eng = Engine(model, num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 prefix_cache=False)
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8, key=0)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    with pytest.raises(GraphCaptureError, match="capture refused"):
        eng.step()
    assert eng.decoder().graph is None


def test_swap_pages_pinned_round_trip(cuda):
    """``swap_out_pages`` on the card gives pinned host tensors holding the
    pages' bits; ``sync=False`` leaves the compute stream ordered after the
    copies, and ``swap_in_pages`` lands them in place before the compute
    stream's next read."""
    from torchdistx_tpu_torch.serving import cache

    g = torch.Generator(device=cuda).manual_seed(3)
    pool = {n: torch.randn((2, 12, 8, 2, 16), generator=g, device=cuda).bfloat16()
            for n in ("k", "v")}
    addr = {n: p.data_ptr() for n, p in pool.items()}
    pages, dst = [3, 7, 1], [2, 5, 11]
    want = {n: p[:, pages].clone() for n, p in pool.items()}
    host = cache.swap_out_pages(pool, pages, sync=False)
    for p in pool.values():
        p[:, pages] = 0  # the compute stream rewrites the freed pages
    cache.swap_in_pages(pool, host, dst)
    torch.cuda.synchronize()
    for n, p in pool.items():
        assert host[n].is_pinned() and host[n].device.type == "cpu"
        assert torch.equal(host[n], want[n].cpu())
        assert torch.equal(p[:, dst], want[n]) and p.data_ptr() == addr[n]


def test_model_pool_eviction_drops_its_graph_and_bytes(cuda):
    """A pool model's decode graph is captured on its first decode and
    dropped, with the weights, at eviction: allocated bytes fall by at
    least the model's parameters and its prep_decode copy, and a second
    demand recaptures."""
    import gc

    import numpy as np

    from torchdistx_tpu_torch import telemetry
    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.models import llama as tllama
    from torchdistx_tpu_torch.serving import Engine, ModelPool

    torch.manual_seed(0)
    model = tllama.Llama(tllama.llama_test(), device=cuda)
    pool = ModelPool()
    pool.register("tuna", module=deferred_init(tllama.Llama, tllama.llama_test(),
                                               device_="cuda"), seed=1)
    eng = Engine(model, num_slots=2, block_size=8, max_model_len=64, decode_chunk=4,
                 model_pool=pool)
    captures = telemetry.counter("serve.graph_captures").value
    first = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8, key=0,
                       model="tuna").result()
    assert any(g[-1] == "tuna" for g in eng._decoders)
    held = pool._entries["tuna"].params_nbytes
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert pool.evict("tuna")
    gc.collect()
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated() >= held
    assert not any(g[-1] == "tuna" for g in eng._decoders)
    again = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8, key=0,
                       model="tuna").result()
    assert again == first
    assert telemetry.counter("serve.graph_captures").value - captures == 2
    eng.close()
