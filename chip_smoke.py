#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``torchdistx_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line:

1. build every kernel in ``torchdistx_tpu_torch/ops/cuda/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and the other shapes below, and time the kernel, the
   plain version and the PyTorch library call that computes the same
   function (a yardstick only; the port never calls it): the flash forward
   against SDPA, the three backward kernels against SDPA's backward; every
   input of a kernel must be unchanged after its launch, and a second call
   of a backward kernel must give the same bits in every output that it
   sums in a fixed order (all but the fused kernel's dq);
3. ``deferred_init`` Llama-7B on ``cuda`` (no bytes allocated), then
   materialize it on the card (its bf16 parameters allocated);
4. the 4 x 512 forward with ``attn_impl="auto"``, which launches the flash
   kernel once per layer; after the forward path it is checked against a
   float32 forward of the same weights (see the tolerances below);
5. greedy ``generate`` of 32 tokens for 4 prompts of 512, once cold and
   three times steady;
6. train: ``make_train_step`` on Llama-7B (bf16, remat, AdamW), its
   ``init_fn`` recording and materializing a fresh model on the card, then
   3 steps on one repeated 4 x 512 batch (the fused backward kernel) and 3
   steps at 1 x 4096 (the streamed dq + dk/dv pair), each shape followed by
   one more step under the profiler (the steady step time is the median of
   the unprofiled steps after the first);
7. train gates: the gradients of a 2-layer model at Llama-7B's width,
   through the kernels and through the plain attention, in f32 and bf16,
   at both training shapes (see the tolerances below).

Two main paths are driven, each with every launch count set to 0 just
before it and read just after: the forward path (phases 3 to 5) and the
train path (phase 6).  Any failed check raises, so the script exits
non-zero and prints no result.  float32 matmuls run in full float32 (TF32
is switched off).  The last three lines are the kernels' summary, the
card's name and power limit, then the result object.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Yardsticks of one H100 SXM (NVIDIA's data sheet, dense rates).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain tolerances on (out, lse).  bf16: out is rounded to bf16
# (2^-8 relative) and p is rounded to bf16 against a running max in the
# kernel but the row max in the plain version; f32: summation order only.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}

# (name, B, S, Hq, Hkv, D, dtype, causal); the first is the main path's.
FLASH_SHAPES = [
    ("llama7b_main", 4, 512, 32, 32, 128, torch.bfloat16, True),
    ("gqa_70b_heads", 2, 1024, 64, 8, 128, torch.bfloat16, True),
    ("ragged_f32", 2, 1000, 8, 8, 64, torch.float32, False),
    ("decode_s1", 4, 1, 32, 32, 128, torch.bfloat16, True),
    ("train_1x4096", 1, 4096, 32, 32, 128, torch.bfloat16, True),
    ("ragged_bf16_d64", 2, 1000, 12, 12, 64, torch.bfloat16, False),
    ("gqa_ragged_bf16", 1, 4095, 32, 8, 128, torch.bfloat16, True),
]

BATCH, SEQ, NEW_TOKENS = 4, 512, 32
# Generate runs once cold, then this many times steady (the median is
# reported with every run, since the host's dispatch rate varies).
GENERATE_STEADY_RUNS = 3
# The forward's checks against a float32 forward of the same weights on the
# plain attention ("the f32 reference").  In float32 the flash path must
# match it: logits within F32_LOGITS_ATOL, top-1 agreement >= TOP1_MIN.  In
# bf16, rounding through 32 random layers leaves every implementation about
# as far from it as any other (top-1 near 0.87 for each), so the bf16 flash
# forward must be no farther from it than the bf16 plain forward: mean
# |dlogits| at most BF16_MEAN_SLACK times the plain one's, top-1 agreement
# at most BF16_TOP1_SLACK below it; and the two bf16 forwards may differ
# from each other by a mean |dlogits| no larger than the plain one's own
# mean error against the f32 reference.
F32_LOGITS_ATOL = 1e-3
TOP1_MIN = 0.99
BF16_MEAN_SLACK = 1.1
BF16_TOP1_SLACK = 0.02

# Backward kernels: (name, B, S, Hq, Hkv, D, dtype, causal, route); the
# first two are the train path's shapes.  route "fused" runs
# flash_bwd_fused, "streamed" runs flash_bwd_dq and flash_bwd_dkv.
BWD_SHAPES = [
    ("train_4x512", 4, 512, 32, 32, 128, torch.bfloat16, True, "fused"),
    ("train_1x4096", 1, 4096, 32, 32, 128, torch.bfloat16, True, "streamed"),
    ("gqa_70b_heads", 2, 1024, 64, 8, 128, torch.bfloat16, True, "fused"),
    ("ragged_f32", 2, 1000, 8, 8, 64, torch.float32, False, "fused"),
    ("ragged_f32", 2, 1000, 8, 8, 64, torch.float32, False, "streamed"),
    ("gqa_ragged_bf16", 1, 4095, 32, 8, 128, torch.bfloat16, True, "streamed"),
    ("ragged_bf16_d64", 2, 1000, 12, 12, 64, torch.bfloat16, False, "streamed"),
    ("ragged_bf16_d64", 2, 1000, 12, 12, 64, torch.bfloat16, False, "fused"),
]
# kernel -> (returns dq, returns dk/dv); per route.
BWD_KERNELS = {
    "fused": {"flash_bwd_fused": (True, True)},
    "streamed": {"flash_bwd_dq": (True, False), "flash_bwd_dkv": (False, True)},
}
# The outputs that each kernel sums in a fixed order: a second call on the
# same inputs must give them the same bits.  The fused kernel's dq is summed
# across blocks in an order that varies from run to run (TMA reductions in
# bf16, atomics in f32); its dk and dv are not.
BWD_DETERMINISTIC = {"flash_bwd_fused": ("dk", "dv"), "flash_bwd_dq": ("dq",),
                     "flash_bwd_dkv": ("dk", "dv")}
# Kernel vs plain on (dq, dk, dv): the largest |kernel - plain| over
# max(1, the largest |plain|).  bf16: p, ds and the outputs are rounded to
# bf16 (2^-8 relative), so a pair whose p or ds rounds the other way moves
# its products by that much; f32: summation order only (the fused dq also
# sums across blocks in an order that changes from run to run).
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# 2 D flops per causal pair for each product of the kernel.
BWD_PRODUCTS = {"flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}

# The train path: Llama-7B, bf16, remat on, AdamW (foreach=False: the
# default multi-tensor AdamW takes temporaries the size of the whole
# parameter set, 13.5 GB, on top of the 54 GB of parameters, gradients and
# two moments).  Per shape (B, S): steps on one repeated batch, and the
# backward route every layer must take.
TRAIN_SEED = 0
TRAIN_LR = 1e-4
TRAIN_SHAPES = [((4, 512), 3, "fused"), ((1, 4096), 3, "streamed")]
# Train gates on a 2-layer model at Llama-7B's width, each parameter's
# gradient g against the plain attention's, as ||g - g_ref|| / ||g_ref||:
# in f32 the kernels' gradients within GRAD_F32_RTOL of the plain ones (and
# the loss within LOSS_F32_ATOL); in bf16 the kernels' gradients no farther
# from the f32 plain ones than GRAD_BF16_SLACK times the bf16 plain ones.
GATE_LAYERS = 2
GATE_SEED = 5
LOSS_F32_ATOL = 1e-4
GRAD_F32_RTOL = 1e-3
GRAD_BF16_SLACK = 1.1


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _time_ms(fn, *, warmup: int = 3, reps: int = 21, calls: int = 10) -> float:
    """Time of one call by CUDA events: the median over ``reps`` of
    ``calls`` back-to-back calls between two events, divided by ``calls``.
    Back to back, the host queues the next launch while the card runs the
    last one, so a call that takes the card longer than the host's launch
    path reads its device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _device_ms(fn, *, calls: int = 10) -> float:
    """Device time of one call from torch.profiler: the card's kernel time
    summed over ``calls`` calls, divided by ``calls`` (host time left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.time_range.elapsed_us() for ev in _device_events(prof))
    return total_us / 1e3 / calls


def _device_events(prof, *, annotations: bool = False):
    """The profiler's device events: kernels and copies, or (with
    ``annotations``) the user annotations that the profiler also lists on
    the device, such as ``Optimizer.step#AdamW.step``, whose span covers
    kernels already counted."""
    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and bool(getattr(ev, "is_user_annotation", False)) == annotations]


def _flash_bound(b, s, hq, hkv, d, dtype, causal):
    """(bound_ms, bound_by): each input read once and each output written
    once, against the operations these shapes need (the causal triangle
    counts only its pairs)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * esize + b * hq * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4 * b * hq * d * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _bwd_bound(kernel, b, s, hq, hkv, d, dtype, causal):
    """(bound_ms, bound_by) of one backward kernel: q, k, v, do, lse and
    delta read once, its outputs (dq; dk, dv; or all three) written once,
    against its products' operations over the pairs these shapes need."""
    esize = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes = b * s * hq * d * esize, b * s * hkv * d * esize
    nbytes = 2 * q_bytes + 2 * kv_bytes + 2 * b * hq * s * 4
    if kernel != "flash_bwd_dkv":
        nbytes += q_bytes
    if kernel != "flash_bwd_dq":
        nbytes += 2 * kv_bytes
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = BWD_PRODUCTS[kernel] * 2 * b * hq * d * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build() -> None:
    from torchdistx_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    print(f"[build] {built} in {secs:.2f} s (sources: {_build.sources()})")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill",
                                       "Performance Loss")):
                print(f"[build] {name}: {line.strip()}")


def phase_kernels():
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, s, hq, hkv, d, dtype, causal in FLASH_SHAPES:
        def rand(h):
            return torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=dtype)

        q, k, v = rand(hq), rand(hkv), rand(hkv)
        before = [t.clone() for t in (q, k, v)]
        out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _check(all(torch.equal(t, c) for t, c in zip((q, k, v), before)),
               f"{name}: an input changed during the forward launch")
        del before
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = TOL[dtype]
        _check(bool(torch.isfinite(out).all()), f"{name}: non-finite out")
        _check(err_out <= tol_out, f"{name}: out err {err_out} > {tol_out}")
        _check(err_lse <= tol_lse, f"{name}: lse err {err_lse} > {tol_lse}")

        # The library call on (B, H, S, D) inputs with the kv heads
        # expanded to Hq (done once, outside the timed call).
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
        calls = {
            "": lambda: fa.flash_attention_fwd_with_lse(q, k, v, causal=causal),
            "plain_": lambda: fa.flash_attention_reference(q, k, v, causal=causal),
            "library_": lambda: sdpa(qt, kt, vt, is_causal=causal),
        }
        bound_ms, bound_by = _flash_bound(b, s, hq, hkv, d, dtype, causal)
        row = {
            "shape": name, "B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d,
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "max_abs_err": err_out, "lse_max_abs_err": err_lse, "inputs_unchanged": True,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        for prefix, fn in calls.items():
            row[prefix + "ms"] = _time_ms(fn)
            row[prefix + "device_ms"] = _device_ms(fn)
        print("[flash_fwd] " + json.dumps(row))
        rows.append(row)
        del q, k, v, out, lse, ref_out, ref_lse, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_bwd_kernels():
    """Each backward kernel against its plain version (flash_bwd_plain) on
    the same (q, k, v, do, lse, delta), with its time, the plain version's,
    SDPA's backward of the same (out, do) and its bound."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, b, s, hq, hkv, d, dtype, causal, route in BWD_SHAPES:
        def rand(h):
            return torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=dtype)

        q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)
        out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
        delta = fa.attention_delta(do, out)
        args = (q, k, v, do, lse, delta)

        # The library yardstick: SDPA's backward alone, on (B, H, S, D)
        # copies with the kv heads expanded; the graph is kept between calls.
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
        vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
        out_t = sdpa(qt, kt, vt, is_causal=causal)
        do_t = do.transpose(1, 2).contiguous()

        def library():
            return torch.autograd.grad(out_t, (qt, kt, vt), do_t, retain_graph=True)

        library_ms, library_device_ms = _time_ms(library), _device_ms(library)
        for kernel, (want_dq, want_dkv) in BWD_KERNELS[route].items():
            launch = getattr(fa, kernel)

            def run():
                return launch(*args, causal=causal)

            def plain():
                return fa.flash_bwd_plain(*args, causal=causal, dq=want_dq, dkv=want_dkv)

            before = [a.clone() for a in args]
            got = run()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            _check(all(torch.equal(a, c) for a, c in zip(args, before)),
                   f"{kernel} {name}: an input changed during the launch")
            again = run()
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            _check(all(torch.equal(a, c) for a, c in zip(args, before)),
                   f"{kernel} {name}: an input changed during the second launch")
            outs = [n for n, w in zip(("dq", "dk", "dv"), (want_dq, want_dkv, want_dkv)) if w]
            same = dict(zip(outs, (torch.equal(g, a) for g, a in zip(got, again))))
            _check(all(same[n] for n in BWD_DETERMINISTIC[kernel]),
                   f"{kernel} {name}: two calls gave different bits: {same}")
            del again, before
            want = [w for w in plain() if w is not None]
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            scale = max(1.0, max(w.float().abs().max().item() for w in want))
            _check(all(bool(torch.isfinite(g).all()) for g in got), f"{kernel} {name}: non-finite")
            _check(err / scale <= BWD_TOL[dtype],
                   f"{kernel} {name}: err {err} / {scale} > {BWD_TOL[dtype]}")
            bound_ms, bound_by = _bwd_bound(kernel, b, s, hq, hkv, d, dtype, causal)
            row = {
                "kernel": kernel, "shape": name, "B": b, "S": s, "Hq": hq, "Hkv": hkv,
                "D": d, "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                "max_abs_err": err, "max_abs_ref": scale, "inputs_unchanged": True,
                "same_bits_twice": same,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "ms": _time_ms(run), "device_ms": _device_ms(run),
                "plain_ms": _time_ms(plain, warmup=1, reps=3, calls=2),
                "plain_device_ms": _device_ms(plain, calls=2),
                "library_ms": library_ms, "library_device_ms": library_device_ms,
            }
            print("[flash_bwd] " + json.dumps(row))
            rows.append(row)
            del got, want
        del q, k, v, do, out, lse, delta, args, qt, kt, vt, out_t, do_t
        torch.cuda.empty_cache()
    return rows


def phase_deferred_init(cfg):
    from torchdistx_tpu_torch.deferred_init import (
        deferred_init,
        is_deferred,
        materialize_module,
    )
    from torchdistx_tpu_torch.models.llama import Llama, num_params

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = deferred_init(Llama, cfg, device_="cuda")
    record_s = time.perf_counter() - t0
    recorded = torch.cuda.memory_allocated()
    params = list(model.parameters())
    _check(recorded == before, f"deferred_init allocated {recorded - before} bytes")
    _check(all(is_deferred(p) for p in params), "a parameter is not deferred")
    n = num_params(cfg)
    _check(sum(p.numel() for p in params) == n, "parameter count")

    torch.manual_seed(0)
    t0 = time.perf_counter()
    materialize_module(model)
    torch.cuda.synchronize()
    mat_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated() - before
    want = n * 2
    _check(abs(allocated - want) <= 0.01 * want,
           f"materialized {allocated} bytes, expected about {want}")
    _check(all(p.is_cuda and not is_deferred(p) for p in model.parameters()),
           "a parameter was not materialized on the card")
    print(f"[deferred_init] llama_7b: {n} params, bytes after record "
          f"{recorded - before}, after materialize {allocated} (2 x params = "
          f"{want}); record {record_s:.3f} s, materialize {mat_s:.3f} s")
    return model, {"record_s": record_s, "materialize_s": mat_s,
                   "bytes_recorded": recorded - before, "bytes_materialized": allocated}


def phase_forward(model, tokens, fa):
    cfg = model.cfg
    n0 = fa.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = model(tokens, attn_impl="auto")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launched = fa.launches - n0
    _check(logits.shape == (BATCH, SEQ, cfg.vocab_size), f"logits shape {logits.shape}")
    _check(logits.dtype == torch.float32, "logits dtype")
    _check(bool(torch.isfinite(logits).all()), "non-finite logits")
    _check(launched == cfg.n_layers, f"{launched} flash launches, expected {cfg.n_layers}")
    print(f"[forward] logits {tuple(logits.shape)} f32 finite; flash launches "
          f"{launched}; first call {first_ms:.3f} ms")
    return logits, first_ms


def phase_generate(model, tokens):
    from torchdistx_tpu_torch.models.generate import generate

    outs, secs = [], []
    for _ in range(1 + GENERATE_STEADY_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, tokens, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    _check(outs[0].shape == (BATCH, NEW_TOKENS), f"generate shape {outs[0].shape}")
    _check(bool(((outs[0] >= 0) & (outs[0] < model.cfg.vocab_size)).all()),
           "generated token out of range")
    _check(all(torch.equal(outs[0], o) for o in outs[1:]),
           "greedy generate is not deterministic")
    tps = [BATCH * NEW_TOKENS / s for s in secs]
    steady_tps = statistics.median(tps[1:])
    with torch.inference_mode():
        weights = model.prep_decode()
        cache = model.init_cache(BATCH, SEQ + 2)
        model.forward_cached(tokens, cache, 0, weights)
        step = tokens[:, -1:]
        model.forward_cached(step, cache, SEQ, weights)  # warm-up step
        def decode_step():
            return model.forward_cached(step, cache, SEQ + 1, weights)

        decode = _profile("decode step", decode_step)
        # One step at a time, so the events read the host's dispatch of it.
        decode["event_ms"] = _time_ms(decode_step, warmup=1, reps=11, calls=1)
        print(f"[decode step] {decode['event_ms']:.3f} ms by events, "
              f"{decode['device_ms']:.3f} ms of it on the card")
        del weights, cache
    print(f"[generate] {BATCH} x {SEQ} prompts, {NEW_TOKENS} new tokens, "
          f"deterministic over {len(outs)} runs; cold {secs[0]:.3f} s "
          f"({tps[0]:.2f} tokens/s); steady {[round(s, 3) for s in secs[1:]]} s, "
          f"{[round(t, 2) for t in tps[1:]]} tokens/s, median {steady_tps:.2f}; "
          f"first tokens {outs[0][:, :8].tolist()}")
    return {"generate_s": secs, "tokens_per_s": tps,
            "steady_tokens_per_s_median": steady_tps, "decode_step_profile": decode}


# Profiler kernel-name fragments of cuBLAS's matrix products.
_GEMM_NAMES = ("nvjet", "gemm", "cutlass", "xmma")
# Profiler kernel-name patterns of the port's bf16 kernels (the train
# path's): a kernel's device time sums the kernels whose names hold every
# fragment of its pattern.
_KERNEL_NAMES = {
    "flash_fwd": ("flash_fwd_bf16",),
    "flash_bwd_fused": ("flash_bwd_fused_wgmma<",),
    "flash_bwd_dq": ("flash_bwd_dq_wgmma<",),
    "flash_bwd_dkv": ("flash_bwd_dkv_wgmma<",),
}


def _profile(label, fn):
    """Wall time and device time by kernel of one call of ``fn``, from
    torch.profiler (the wall time includes the profiler's own cost)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in _device_events(prof):
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    spans = {}
    for ev in _device_events(prof, annotations=True):
        spans[ev.name] = spans.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    out = {"wall_ms": wall_ms, "device_ms": sum(by_kernel.values()),
           "gemm_ms": sum(t for n, t in by_kernel.items()
                          if any(p in n for p in _GEMM_NAMES)),
           "annotation_spans_ms": spans, "top": [[n[:60], t] for n, t in top]}
    for kernel, parts in _KERNEL_NAMES.items():
        out[kernel + "_ms"] = sum(
            t for n, t in by_kernel.items() if all(p in n for p in parts)
        )
    print(f"[{label}] profile " + json.dumps(out))
    return out


def _compare(a, b):
    d = (a - b).abs()
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return d.max().item(), d.mean().item(), top1


def check_forward_against_f32(model, tokens, logits):
    """Steady timings of the bf16 forward on both attentions, then the
    checks against the f32 reference (the model is cast to float32 in place
    here, after the main path's counts were read)."""
    with torch.inference_mode():
        ms = _time_ms(lambda: model(tokens, attn_impl="auto"), warmup=1, reps=5, calls=3)
        plain_ms = _time_ms(lambda: model(tokens, attn_impl="plain"), warmup=1, reps=5,
                            calls=3)
        print(f"[forward] steady bf16: flash {ms:.3f} ms, plain attention {plain_ms:.3f} ms")
        profile = _profile("forward", lambda: model(tokens, attn_impl="auto"))
        plain = model(tokens, attn_impl="plain")
        model.float()
        ref = model(tokens, attn_impl="plain")
        flash32 = model(tokens, attn_impl="auto")
    stats = {"forward_ms": ms, "forward_plain_ms": plain_ms, "forward_profile": profile}
    for name, a, b in (("f32 flash vs f32 reference", flash32, ref),
                       ("bf16 flash vs f32 reference", logits, ref),
                       ("bf16 plain vs f32 reference", plain, ref),
                       ("bf16 flash vs bf16 plain", logits, plain)):
        mx, mean, top1 = _compare(a, b)
        stats[name] = {"max_abs": mx, "mean_abs": mean, "top1": top1}
        print(f"[forward] {name}: max abs {mx:.6f}, mean abs {mean:.6f}, "
              f"top-1 agreement {top1:.6f}")
    f32 = stats["f32 flash vs f32 reference"]
    _check(f32["max_abs"] <= F32_LOGITS_ATOL,
           f"f32 logits err {f32['max_abs']} > {F32_LOGITS_ATOL}")
    _check(f32["top1"] >= TOP1_MIN, f"f32 top-1 agreement {f32['top1']} < {TOP1_MIN}")
    flash, plain_s = stats["bf16 flash vs f32 reference"], stats["bf16 plain vs f32 reference"]
    _check(flash["mean_abs"] <= BF16_MEAN_SLACK * plain_s["mean_abs"],
           f"bf16 flash mean err {flash['mean_abs']} vs plain {plain_s['mean_abs']}")
    _check(flash["top1"] >= plain_s["top1"] - BF16_TOP1_SLACK,
           f"bf16 flash top-1 {flash['top1']} vs plain {plain_s['top1']}")
    pair = stats["bf16 flash vs bf16 plain"]
    _check(pair["mean_abs"] <= plain_s["mean_abs"],
           f"bf16 flash vs bf16 plain mean err {pair['mean_abs']} > plain's own "
           f"error {plain_s['mean_abs']}")
    return stats


def _counts(fa):
    return {"flash_fwd": fa.launches, "flash_bwd_fused": fa.launches_bwd_fused,
            "flash_bwd_dq": fa.launches_bwd_dq, "flash_bwd_dkv": fa.launches_bwd_dkv}


def _reset_counts(fa) -> None:
    fa.launches = fa.launches_bwd_fused = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(cfg, fa):
    """The train path: init_fn, then TRAIN_SHAPES' steps with their launch
    counts, losses and times, each shape followed by one profiled step."""
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    def tx(params):
        return torch.optim.AdamW(params, lr=TRAIN_LR, foreach=False)

    init_fn, step_fn = make_train_step(cfg, tx)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_fn(TRAIN_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = state.model
    _check(cfg.remat and all(p.is_cuda for p in model.parameters()),
           "init_fn did not build a remat model on the card")
    watched = {"layers.0.wq.weight": model.layers[0].wq.weight,
               "layers.31.w_down.weight": model.layers[-1].w_down.weight,
               "lm_head.weight": model.lm_head.weight}
    before = {n: p.detach().clone() for n, p in watched.items()}
    print(f"[train] init_fn(seed={TRAIN_SEED}): llama_7b on the card in {init_s:.3f} s; "
          f"AdamW(lr={TRAIN_LR}, foreach=False)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_layers = cfg.n_layers
    stats = {"init_s": init_s, "optimizer": f"AdamW(lr={TRAIN_LR}, foreach=False)"}
    for (b, s), n_steps, route in TRAIN_SHAPES:
        seq = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        want = {"flash_fwd": 2 * n_layers, "flash_bwd_fused": 0,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        for kernel in BWD_KERNELS[route]:
            want[kernel] = n_layers
        losses, step_ms = [], []
        for i in range(n_steps):
            c0 = _counts(fa)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step_fn(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            launched = {k: v - c0[k] for k, v in _counts(fa).items()}
            loss = metrics["loss"].item()
            losses.append(loss)
            _check(math.isfinite(loss) and not metrics["nonfinite"],
                   f"train {b}x{s} step {i + 1}: loss {loss}")
            _check(launched == want,
                   f"train {b}x{s} step {i + 1}: launches {launched}, expected {want}")
        held = {}

        def profiled_step():
            held["out"] = step_fn(state, batch)

        c0 = _counts(fa)
        profile = _profile(f"train {b}x{s} step", profiled_step)
        state, metrics = held["out"]
        _check(math.isfinite(metrics["loss"].item()), f"train {b}x{s}: profiled step loss")
        _check({k: v - c0[k] for k, v in _counts(fa).items()} == want,
               f"train {b}x{s}: profiled step launches")
        steady_ms = statistics.median(step_ms[1:])
        bwd_ms = sum(profile[k + "_ms"] for k in BWD_KERNELS[route])
        row = {
            "B": b, "S": s, "route": route, "losses": losses, "step_ms": step_ms,
            "steady_step_ms": steady_ms, "tokens_per_s": b * s / (steady_ms / 1e3),
            "launches_per_step": want, "profile": profile,
            "bwd_kernels_device_share": bwd_ms / profile["device_ms"],
            "flash_fwd_device_share": profile["flash_fwd_ms"] / profile["device_ms"],
            # The profiled step's kernel time over an unprofiled step's time.
            "device_busy_share": profile["device_ms"] / steady_ms,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        }
        print(f"[train] {b}x{s}: losses {losses}; step ms {step_ms}; steady "
              f"{steady_ms:.3f} ms, {row['tokens_per_s']:.1f} tokens/s; launches per "
              f"step {want}; backward kernels {100 * row['bwd_kernels_device_share']:.2f} % "
              f"of device time; peak allocated {row['peak_allocated_bytes']} bytes")
        stats[f"{b}x{s}"] = row
        if route == "fused":
            _check(losses[-1] < losses[0],
                   f"loss did not fall on the repeated batch: {losses}")
    changed = {n: not torch.equal(before[n], p) for n, p in watched.items()}
    _check(all(changed.values()), f"parameters unchanged: {changed}")
    stats["parameters_changed"] = changed
    del state, model, watched, before, held
    _free()
    return stats


def _grads(model, tokens, targets, impl):
    """(loss, {name: f32 gradient}) of ``model.loss`` with ``impl``."""
    loss = model.loss(tokens, targets, attn_impl=impl)
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        grads[name] = p.grad.float()
        p.grad = None
    return loss.item(), grads


def _rel_err(got, ref):
    return {n: (torch.linalg.vector_norm(got[n] - ref[n])
                / torch.linalg.vector_norm(ref[n])).item() for n in ref}


def phase_train_gates(cfg):
    """Gradients through the kernels against gradients through the plain
    attention, on a GATE_LAYERS-layer model at cfg's width (weights from
    GATE_SEED), at each training shape, in f32 and bf16."""
    from torchdistx_tpu_torch.models.llama import Llama

    small = dataclasses.replace(cfg, n_layers=GATE_LAYERS)
    torch.manual_seed(GATE_SEED)
    m16 = Llama(small, device="cuda")
    m32 = copy.deepcopy(m16).float()
    gen = torch.Generator(device="cuda").manual_seed(4)
    stats = {}
    for (b, s), _, route in TRAIN_SHAPES:
        seq = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
        tokens, targets = seq[:, :-1], seq[:, 1:]
        loss_k, g_k = _grads(m32, tokens, targets, "flash")
        loss_p, g_ref = _grads(m32, tokens, targets, "plain")
        f32_rel = _rel_err(g_k, g_ref)
        del g_k
        loss_k16, g = _grads(m16, tokens, targets, "flash")
        bf16_kernel = _rel_err(g, g_ref)
        del g
        loss_p16, g = _grads(m16, tokens, targets, "plain")
        bf16_plain = _rel_err(g, g_ref)
        del g, g_ref
        _free()
        worst = max(f32_rel, key=f32_rel.get)
        ratio = {n: bf16_kernel[n] / bf16_plain[n] for n in bf16_plain}
        worst16 = max(ratio, key=ratio.get)
        row = {
            "route": route, "loss_f32_kernel": loss_k, "loss_f32_plain": loss_p,
            "loss_bf16_kernel": loss_k16, "loss_bf16_plain": loss_p16,
            "f32_max_rel_err": f32_rel[worst], "f32_worst_param": worst,
            "bf16_kernel_rel_err": bf16_kernel, "bf16_plain_rel_err": bf16_plain,
            "bf16_max_ratio": ratio[worst16], "bf16_worst_param": worst16,
        }
        print(f"[train gates] {b}x{s} ({route}): f32 loss kernel {loss_k:.6f} vs plain "
              f"{loss_p:.6f}; f32 grads max rel err {f32_rel[worst]:.3e} ({worst}); "
              f"bf16 grads vs f32 plain: kernel/plain rel err ratio max "
              f"{ratio[worst16]:.4f} ({worst16}: {bf16_kernel[worst16]:.4e} vs "
              f"{bf16_plain[worst16]:.4e})")
        _check(abs(loss_k - loss_p) <= LOSS_F32_ATOL,
               f"{b}x{s}: f32 loss {loss_k} vs plain {loss_p}")
        _check(f32_rel[worst] <= GRAD_F32_RTOL,
               f"{b}x{s}: f32 grad rel err {f32_rel[worst]} ({worst}) > {GRAD_F32_RTOL}")
        _check(ratio[worst16] <= GRAD_BF16_SLACK,
               f"{b}x{s}: bf16 kernel grad err {bf16_kernel[worst16]} > {GRAD_BF16_SLACK} x "
               f"plain {bf16_plain[worst16]} ({worst16})")
        stats[f"{b}x{s}"] = row
    del m16, m32
    _free()
    return stats


def _kernel_entry(name, source, replaces, row, launches):
    return {
        "name": name, "route": "cuda",
        "source": f"torchdistx_tpu_torch/ops/cuda/csrc/{source}",
        "replaces": f"torchdistx_tpu/ops/pallas/flash_attention.py:{replaces}",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[env] TF32 off for matmuls and cuDNN; torch", torch.__version__,
          "cuda", torch.version.cuda, "python", sys.version.split()[0])
    t_start = time.perf_counter()

    from torchdistx_tpu_torch.models.llama import llama_7b
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    phase_build()
    rows = phase_kernels()
    bwd_rows = phase_bwd_kernels()

    cfg = llama_7b()
    _reset_counts(fa)  # the forward path starts here
    model, init_stats = phase_deferred_init(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device="cuda")
    logits, first_ms = phase_forward(model, tokens, fa)
    gen_stats = phase_generate(model, tokens)
    fwd_launches = _counts(fa)  # the forward path ends here
    _check(fwd_launches["flash_fwd"] > 0, "flash_fwd was not launched on the forward path")
    print(f"[forward path] launches: {json.dumps(fwd_launches)}")

    fwd_stats = check_forward_against_f32(model, tokens, logits)
    fwd_peak = torch.cuda.max_memory_allocated()
    del model, logits
    _free()

    _reset_counts(fa)  # the train path starts here
    train_stats = phase_train(cfg, fa)
    train_launches = _counts(fa)  # the train path ends here
    print(f"[train path] launches: {json.dumps(train_launches)}")
    for kernel, n in train_launches.items():
        _check(n > 0, f"{kernel} was not launched on the train path")

    gate_stats = phase_train_gates(cfg)
    print("[summary] " + json.dumps({
        **init_stats, **gen_stats, **fwd_stats, "forward_first_ms": first_ms,
        "forward_path_peak_allocated_bytes": fwd_peak, "train": train_stats,
        "train_gates": gate_stats, "script_s": time.perf_counter() - t_start,
    }))

    def launches(kernel):
        return {"forward": fwd_launches[kernel], "train": train_launches[kernel]}

    by_kernel = {r["kernel"]: r for r in reversed(bwd_rows)}  # first row of each
    print(json.dumps({"kernels": [
        _kernel_entry("flash_fwd", "flash_fwd.cu", 161, rows[0], launches("flash_fwd")),
        _kernel_entry("flash_bwd_fused", "flash_bwd_fused.cu", 492,
                      by_kernel["flash_bwd_fused"], launches("flash_bwd_fused")),
        _kernel_entry("flash_bwd_dq", "flash_bwd_dq.cu", 393,
                      by_kernel["flash_bwd_dq"], launches("flash_bwd_dq")),
        _kernel_entry("flash_bwd_dkv", "flash_bwd_dkv.cu", 438,
                      by_kernel["flash_bwd_dkv"], launches("flash_bwd_dkv")),
    ]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
