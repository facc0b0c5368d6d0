#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``torchdistx_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line:

1. build every kernel in ``torchdistx_tpu_torch/ops/cuda/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shape and the other shapes below, and time the kernel, the
   plain version and the PyTorch library call that computes the same
   function (a yardstick only; the port never calls it);
3. ``deferred_init`` Llama-7B on ``cuda`` (no bytes allocated), then
   materialize it on the card (its bf16 parameters allocated);
4. the 4 x 512 forward with ``attn_impl="auto"``, which launches the flash
   kernel once per layer; after the main path it is checked against a
   float32 forward of the same weights (see the tolerances below);
5. greedy ``generate`` of 32 tokens for 4 prompts of 512, once cold and
   three times steady.

Launch counts are set to 0 before phase 3 and read after phase 5.  Any
failed check raises, so the script exits non-zero and prints no result.
float32 matmuls run in full float32 (TF32 is switched off).  The last two
lines are the card's name and power limit, then the result object.
"""

from __future__ import annotations

import json
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
    total_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / calls


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


def phase_build() -> None:
    from torchdistx_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    print(f"[build] {built} in {secs:.2f} s (sources: {_build.sources()})")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
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
        out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
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
            "max_abs_err": err_out, "lse_max_abs_err": err_lse,
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
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms": wall_ms, "device_ms": sum(by_kernel.values()),
           "flash_fwd_ms": sum(t for n, t in by_kernel.items() if "flash_fwd" in n),
           "top": [[n[:60], t] for n, t in top]}
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


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[env] TF32 off for matmuls and cuDNN; torch", torch.__version__,
          "cuda", torch.version.cuda, "python", sys.version.split()[0])

    from torchdistx_tpu_torch.models.llama import llama_7b
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    phase_build()
    rows = phase_kernels()

    cfg = llama_7b()
    fa.launches = 0  # the main path starts here
    model, init_stats = phase_deferred_init(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device="cuda")
    logits, first_ms = phase_forward(model, tokens, fa)
    gen_stats = phase_generate(model, tokens)
    launches = {"flash_fwd": fa.launches}  # the main path ends here
    _check(launches["flash_fwd"] > 0, "flash_fwd was not launched on the main path")
    print(f"kernels: {json.dumps(list(launches))} launches: {json.dumps(launches)}")

    fwd_stats = check_forward_against_f32(model, tokens, logits)
    print("[summary] " + json.dumps({
        **init_stats, **gen_stats, **fwd_stats, "forward_first_ms": first_ms,
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
    }))

    main_row = rows[0]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "torchdistx_tpu_torch/ops/cuda/csrc/flash_fwd.cu",
        "replaces": "torchdistx_tpu/ops/pallas/flash_attention.py:161",
        "launches": launches["flash_fwd"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}))
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
