#!/usr/bin/env python3
"""Compare the port's bf16 flash kernels at one head dim (forward, fused
backward, dq and dk/dv), or its f32 ones, across checkouts, on one GPU.

    python3 scripts/torch_d256_ab.py [--d 64|128|256|512] [--fwd-only] ROOT [ROOT ...]
    python3 scripts/torch_d256_ab.py --dtype f32 [--d 64|128|256|512] ROOT [ROOT ...]

Each ROOT is a checkout holding ``torchdistx_tpu_torch/``.  For each ROOT,
in the order given, a child process imports the port from ROOT, builds its
four flash sources into ``ROOT/build/d<D>_ab`` (``f32_ab`` with ``--dtype
f32``) and prints one JSON line:

- ``ptxas``: registers, spill stores and loads of every instance at the
  head dim (every f32 instance with ``--dtype f32``), from nvcc's
  ``-Xptxas -v`` report (the launch's count: code after a ``setmaxnreg``
  may use more);
- ``sass``: for each bf16 forward instance at the head dim, from
  ``cuobjdump -sass`` of the built library, the local-memory stores and
  loads (``STL`` / ``LDL``: spills), the highest register the code names
  and its register reallocations (``USETMAXREG``);
- ``ms``: at each of the head dim's SHAPES (``chip_smoke.py``'s bf16 rows
  at that head dim; with ``--dtype f32`` its f32 rows of F32_SHAPES, at
  every head dim there unless ``--d`` names one), the forward's, the fused
  backward's, dq's and dk/dv's time through the port's wrappers (the
  median over 21 repeats of 10 back-to-back calls between CUDA events,
  divided by 10; 7 repeats of 3 calls for a kernel slower than 1 ms a
  call), beside SDPA's forward and its whole backward on the same inputs
  (the kv heads expanded), the library yardsticks; with ``--fwd-only`` the
  forward's and SDPA's forward only;
- ``device_ms``: the forward's and SDPA's forward's device time at each
  shape, from torch.profiler (the median over 30 calls), which leaves out
  the host's launch path that bounds ``ms`` at the smallest shapes;
- ``fwd``: at each shape, the forward's largest error in out and lse
  against its plain version, whether a second call gave the same bits, and
  a digest (SHA-256) of out's and lse's bytes, so that the roots' bits can
  be compared;
- ``err``: each backward kernel's largest error against its plain version
  (not with ``--fwd-only``).

With bf16 at D 64, 128 and 256 the table also gives each shape's work
rule (``schedule``): the forward's work order and grid on a 132-SM H100,
and its busiest block's kv tiles beside the mean.

``--d`` is the head dim, 256 unless given (bf16).

Give the roots as parent, change, change, parent to see the drift between
calls beside the difference.  The last lines are a table by shape, whether
each shape's forward bits agree across the roots, and the card's name and
power limit.  A root whose child fails (a build error, say) is reported,
left out of the table, and sets the exit code.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

# Head dim -> (name, B, S, Hq, Hkv, causal).  At 64 and 128: chip_smoke.py's
# bf16 rows at that head dim (FLASH_SHAPES, in its order): GPT-2 XL's heads,
# its pipeline block and a ragged full case at 64; Llama-7B's training and
# decode shapes, 70B's GQA heads, the 1 x 4096 step, a ragged GQA case and
# the mesh, pipeline and ep blocks at 128.  At 256: a 256-wide-head model's
# attention, and the D = 256 path's own bf16 step (1 x 2112, 4/2 heads).
# At 512: the same width in 512-wide heads (no model of the repo has them),
# and [head dims]' shape.
SHAPES = {64: [("ragged_bf16_d64", 2, 1000, 12, 12, False),
               ("gpt2_xl_heads", 4, 1024, 25, 25, True),
               ("pp_gpt2_block", 1, 512, 25, 25, True)],
          128: [("llama7b_main", 4, 512, 32, 32, True),
                ("gqa_70b_heads", 2, 1024, 64, 8, True),
                ("decode_s1", 4, 1, 32, 32, True),
                ("train_1x4096", 1, 4096, 32, 32, True),
                ("gqa_ragged_bf16", 1, 4095, 32, 8, True),
                ("mesh_rank_block", 2, 512, 16, 16, True),
                ("pp_micro_block", 1, 512, 32, 32, True),
                ("pp_tp_block", 1, 512, 16, 16, True),
                ("ep_fsdp_block", 2, 512, 32, 32, True)],
          256: [("wide_d256", 2, 1024, 16, 16, True),
                ("d256_path_bf16", 1, 2112, 4, 2, True)],
          512: [("wide_d512", 2, 1024, 8, 8, True),
                ("d512", 2, 300, 8, 2, True)]}
# --dtype f32: head dim -> chip_smoke.py's f32 rows there, (name, B, S, Hq,
# Hkv, causal): its ragged_f32 row at 64, its train_gate_f32 rows (the f32
# train gates' attention) at 128, and [head dims]' shape (PADDED_SHAPE,
# causal) at 256 and 512.
F32_SHAPES = {64: [("ragged_f32", 2, 1000, 8, 8, False)],
              128: [("train_gate_f32", 4, 512, 32, 32, True)],
              256: [("head_dims", 2, 300, 8, 2, True)],
              512: [("head_dims", 2, 300, 8, 2, True)]}
SOURCES = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def _ptxas(logs, d):
    """{demangled kernel at head dim d (every f32 instance if d is "f32"):
    {registers, spill_stores, spill_loads}}."""
    entries, current = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = m.group(1)
                entries[current] = {}
                continue
            if current is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                entries[current].update(spill_stores=int(m.group(1)),
                                        spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entries[current]["registers"] = int(m.group(1))
    names = subprocess.run([_cuda_tool("cu++filt")], input="\n".join(entries), text=True,
                           capture_output=True, check=True).stdout.splitlines()
    out = {}
    for mangled, name in zip(entries, names):
        name = name.removeprefix("void ")
        name = name[:name.index("(", name.rindex(">"))] if ">" in name else name
        f32 = "_f32" in name and "bfloat16" not in name
        if (f32 if d == "f32" else f"(int){d}" in name):
            out[name] = entries[mangled]
    return out


def _sass(lib, d):
    """{bf16 forward instance at head dim d: {stl, ldl, max_reg, setmaxnreg}}
    from ``cuobjdump -sass`` of the built library ``lib``."""
    text = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(lib)], text=True,
                          capture_output=True, check=True).stdout
    funcs, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            funcs[current] = []
        elif current is not None:
            funcs[current].append(line)
    names = subprocess.run([_cuda_tool("cu++filt")], input="\n".join(funcs), text=True,
                           capture_output=True, check=True).stdout.splitlines()
    out = {}
    for mangled, name in zip(funcs, names):
        if "flash_fwd_bf16_wgmma" not in name or f"(int){d}>" not in name:
            continue
        body = funcs[mangled]
        regs = [int(r) for line in body for r in re.findall(r"\bR(\d+)\b", line)]
        out[name.removeprefix("void ").split("(CUtensorMap")[0]] = {
            "stl": sum(1 for line in body if re.search(r"\bSTL\b", line)),
            "ldl": sum(1 for line in body if re.search(r"\bLDL\b", line)),
            "max_reg": max(regs, default=None),
            "setmaxnreg": sorted({m.group(0) for line in body
                                  for m in [re.search(r"USETMAXREG\S*\s+\S+", line)] if m}),
        }
    return out


def _digest(*tensors):
    """SHA-256 (its first 16 hex digits) of the tensors' bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


PAIRED, HEAD_MAJOR, TILE_MAJOR = 0, 1, 2  # hopper.cuh's ForwardWorks orders
ORDER_NAMES = {PAIRED: "pairs", HEAD_MAJOR: "head-major", TILE_MAJOR: "tile-major"}


def _works(n, n_hb, order, block, grid):
    """The (q tile, batch x head) works that block ``block`` of ``grid``
    takes, in turn: hopper.cuh's ForwardWorks, step for step."""
    n_pairs = (n + 1) // 2
    units = n_hb * (n_pairs if order == PAIRED else n)
    u, step = block, 0
    while u < units:
        if order == PAIRED:
            p = u % n_pairs
            yield (n - 1 - p if step == 0 else p), u // n_pairs
            if step == 0 and p != n - 1 - p:
                step = 1
            else:
                step, u = 0, u + grid
        else:
            tile_major = order == TILE_MAJOR
            yield n - 1 - (u // n_hb if tile_major else u % n), (u % n_hb if tile_major
                                                                   else u // n)
            step += 1
            u = step * grid + (grid - 1 - block if step % 2 else block)


def busiest_block(n, n_hb, order, grid, causal):
    """The kv tiles of the busiest block (hopper.cuh's busiest_block)."""
    return max(sum(t + 1 if causal else n for t, _ in _works(n, n_hb, order, b, grid))
               for b in range(grid))


def forward_order(n, n_hb, n_sm, causal):
    """(order, grid) as flash_fwd.cu's forward_order chooses them: pairs
    where no block is then busier than with single q tiles, else single
    tiles, tile-major where that balances better than head-major."""
    grid_pairs, grid_single = min(n_hb * ((n + 1) // 2), n_sm), min(n_hb * n, n_sm)
    pairs = busiest_block(n, n_hb, PAIRED, grid_pairs, causal)
    head = busiest_block(n, n_hb, HEAD_MAJOR, grid_single, causal)
    tile = busiest_block(n, n_hb, TILE_MAJOR, grid_single, causal) if causal else head
    if pairs <= min(head, tile):
        return PAIRED, grid_pairs
    return (TILE_MAJOR if tile < head else HEAD_MAJOR), grid_single


def schedule(b, s, hq, d, causal, n_sm=132):
    """The bf16 forward's work rule at D 64, 128 and 256 (flash_fwd.cu's
    launch_bf16): the order, its grid and its busiest block's kv tiles
    beside the mean over the grid; and, beside them, the pairs-only
    rule's grid and busiest block."""
    n = -(-s // (64 if d == 256 else 128))
    order, grid = forward_order(n, b * hq, n_sm, causal)
    tiles = b * hq * (n * (n + 1) // 2 if causal else n * n)
    paired_grid = min(b * hq * ((n + 1) // 2), n_sm)
    return {"order": ORDER_NAMES[order], "grid": grid,
            "busiest_kv_tiles": busiest_block(n, b * hq, order, grid, causal),
            "mean_kv_tiles": round(tiles / grid, 1), "paired_grid": paired_grid,
            "paired_busiest_kv_tiles": busiest_block(n, b * hq, PAIRED, paired_grid, causal)}


def _time_ms(fn, *, warmup=3, reps=21, calls=10):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) > 1.0:  # a slow kernel: fewer calls
        reps, calls = 7, 3
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


def _device_ms(fn, *, calls=30):
    """Device time of one call from torch.profiler: the median kernel time
    where each call ran one kernel, else the card's kernel time summed over
    ``calls`` calls, divided by ``calls`` (host time left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(ev, "is_user_annotation", False)]
    if len(times) == calls:
        return statistics.median(times)
    return sum(times) / calls


def _rows(dtype: str, d):
    """(label, head dim, shape) of each row timed."""
    if dtype == "bf16":
        return [(name, d, shape) for name, *shape in SHAPES[d]]
    dims = sorted(F32_SHAPES) if d is None else [d]
    return [(f"{name} D {dim}", dim, shape) for dim in dims for name, *shape in F32_SHAPES[dim]]


def child(root: Path, dtype: str, d, fwd_only: bool = False) -> None:
    os.environ["TDX_TORCH_BUILD_DIR"] = str(root / "build" / (
        f"d{d}_ab" if dtype == "bf16" else "f32_ab"))
    sys.path.insert(0, str(root))
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from torchdistx_tpu_torch.ops.cuda import _build
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    built = _build.build(SOURCES)
    row = {"root": str(root), "ptxas": (_ptxas(_build.build_logs, d if dtype == "bf16" else "f32")
                                        if built else None), "ms": {}}
    if dtype == "bf16":
        row["sass"] = _sass(_build.BUILD_DIR / "libflash_fwd.so", d)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, d, (b, s, hq, hkv, causal) in _rows(dtype, d):
        def rand(h):
            return torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)

        q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)
        out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
        delta = fa.attention_delta(do, out)
        qt, dot = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, do))
        kt, vt = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (k, v))
        again = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
        row.setdefault("fwd", {})[name] = {
            "out_err": (out.float() - ref_out.float()).abs().max().item(),
            "lse_err": (lse - ref_lse).abs().max().item(),
            "same_bits_twice": torch.equal(out, again[0]) and torch.equal(lse, again[1]),
            "digest": _digest(out, lse)}
        del again, ref_out, ref_lse
        row.setdefault("device_ms", {})[name] = {
            "flash_fwd": _device_ms(lambda: fa.flash_attention_fwd_with_lse(q, k, v,
                                                                           causal=causal)),
            "sdpa_fwd": _device_ms(lambda: sdpa(qt, kt, vt, is_causal=causal)),
        }
        if fwd_only:
            row["ms"][name] = {
                "flash_fwd": _time_ms(lambda: fa.flash_attention_fwd_with_lse(q, k, v,
                                                                             causal=causal)),
                "sdpa_fwd": _time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal)),
            }
            del q, k, v, do, out, lse, delta, qt, kt, vt, dot
            continue
        out_t = sdpa(qt, kt, vt, is_causal=causal)
        row["ms"][name] = {
            "flash_fwd": _time_ms(lambda: fa.flash_attention_fwd_with_lse(q, k, v,
                                                                         causal=causal)),
            "flash_bwd_fused": _time_ms(lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta,
                                                                   causal=causal)),
            "flash_bwd_dq": _time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                             causal=causal)),
            "flash_bwd_dkv": _time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                               causal=causal)),
            "sdpa_fwd": _time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal)),
            "sdpa_bwd": _time_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), dot,
                                                             retain_graph=True)),
        }
        # Each backward kernel's largest error against its plain version,
        # over max(1, the largest plain value), as chip_smoke.py holds them.
        want = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal=causal)
        got = {"flash_bwd_fused": fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=causal),
               "flash_bwd_dq": (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
                                None, None),
               "flash_bwd_dkv": (None, *fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                         causal=causal))}
        row.setdefault("err", {})[name] = {
            kernel: max((g.float() - w.float()).abs().max().item()
                        / max(1.0, w.float().abs().max().item())
                        for g, w in zip(outs, want) if g is not None)
            for kernel, outs in got.items()}
        del want, got
        del q, k, v, do, out, lse, delta, qt, kt, vt, dot, out_t
    print(json.dumps(row), flush=True)


def main(args) -> int:
    dtype, d, fwd_only = "bf16", None, False
    while args[:1] in (["--d"], ["--dtype"], ["--fwd-only"]):
        if args[0] == "--fwd-only":
            fwd_only, args = True, args[1:]
            continue
        if args[0] == "--d":
            d = int(args[1])
        else:
            dtype = args[1]
        args = args[2:]
    table = SHAPES if dtype == "bf16" else F32_SHAPES
    if dtype not in ("bf16", "f32") or (d is not None and d not in table):
        sys.stderr.write(f"--dtype takes bf16 or f32, --d one of {sorted(table)}\n")
        return 2
    if dtype == "bf16" and d is None:
        d = 256
    rows, failed = [], 0
    for root in args:
        proc = subprocess.run([sys.executable, __file__, "--child", dtype, str(d),
                               str(Path(root).resolve())] + (["--fwd-only"] if fwd_only else []),
                              capture_output=True, text=True)
        if proc.returncode != 0:  # reported, and left out of the table
            sys.stderr.write(proc.stdout + proc.stderr)
            print(json.dumps({"root": str(root), "failed": proc.returncode}), flush=True)
            failed = proc.returncode
            continue
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows.append(json.loads(line))
    if not rows:
        return failed
    print("shape | kernel | " + " | ".join(r["root"] for r in rows))
    for name, *_ in _rows(dtype, d):
        for kernel in rows[0]["ms"][name]:
            print(f"{name} | {kernel} | "
                  + " | ".join(f"{r['ms'][name][kernel]:.4f}" for r in rows))
    for name, *_ in _rows(dtype, d):
        for kernel in rows[0]["device_ms"][name]:
            print(f"{name} | {kernel} device | "
                  + " | ".join(f"{r['device_ms'][name][kernel]:.4f}" for r in rows))
    if dtype == "bf16" and d in (64, 128, 256):
        for name, b, s, hq, _, causal in SHAPES[d]:
            print(f"{name} | work rule | {json.dumps(schedule(b, s, hq, d, causal))}")
    for name, *_ in _rows(dtype, d):
        digests = [r["fwd"][name]["digest"] for r in rows]
        print(f"{name} | forward bits | "
              + ("the same at every root" if len(set(digests)) == 1 else " | ".join(digests)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return failed


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(Path(sys.argv[4]), sys.argv[2], None if sys.argv[3] == "None" else int(sys.argv[3]),
              fwd_only=sys.argv[5:6] == ["--fwd-only"])
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
