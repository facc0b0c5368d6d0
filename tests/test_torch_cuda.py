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
# The D = 256 instances (CUDA cores, bf16 and f32): one forward q tile of 16
# minus one, exactly one and plus one, a kv tile of 32 plus one, GQA, and a
# sequence past the fused route's 2048.
@pytest.mark.parametrize("s, hq, hkv", [(1, 2, 2), (15, 4, 1), (16, 4, 2), (17, 4, 4),
                                        (33, 8, 2), (300, 4, 1), (2049, 2, 2)])
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
# The D = 512 instances (CUDA cores, bf16 and f32), and 320 padded to them:
# the shapes of the D = 256 test; the kv-tile body's tiles are 16 rows here.
@pytest.mark.parametrize("s, hq, hkv", [(1, 2, 2), (15, 4, 1), (16, 4, 2), (17, 4, 4),
                                        (33, 8, 2), (300, 4, 1), (2049, 2, 2)])
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
