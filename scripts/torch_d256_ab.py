#!/usr/bin/env python3
"""Compare the port's bf16 D = 256 (or D = 512) flash kernels (forward,
fused backward, dq and dk/dv) across checkouts, on one GPU.

    python3 scripts/torch_d256_ab.py [--d 512] ROOT [ROOT ...]

Each ROOT is a checkout holding ``torchdistx_tpu_torch/``.  For each ROOT,
in the order given, a child process imports the port from ROOT, builds its
four flash sources into ``ROOT/build/d256_ab`` (``d512_ab`` at D = 512)
and prints one JSON line:

- ``ptxas``: registers, spill stores and loads of every instance at the
  head dim, from nvcc's ``-Xptxas -v`` report;
- ``ms``: at each of the head dim's SHAPES (``chip_smoke.py``'s bf16 rows
  at that head dim), the forward's, the fused backward's, dq's and
  dk/dv's time through the port's wrappers (the median over 21 repeats of
  10 back-to-back calls between CUDA events, divided by 10; 7 repeats of 3
  calls for a kernel slower than 1 ms a call), beside SDPA's forward and
  its whole backward on the same inputs (the kv heads expanded), the
  library yardsticks.

``--d`` is the head dim, 256 unless given.

Give the roots as parent, change, change, parent to see the drift between
calls beside the difference.  The last lines are a table by shape and the
card's name and power limit.
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

# Head dim -> (name, B, S, Hq, Hkv, causal).  At 256: a 256-wide-head
# model's attention, and the D = 256 path's own bf16 step (1 x 2112, 4/2
# heads).  At 512: the same width in 512-wide heads (no model of the repo
# has them), and [head dims]' shape.
SHAPES = {256: [("wide_d256", 2, 1024, 16, 16, True),
                ("d256_path_bf16", 1, 2112, 4, 2, True)],
          512: [("wide_d512", 2, 1024, 8, 8, True),
                ("d512", 2, 300, 8, 2, True)]}
SOURCES = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def _ptxas(logs, d):
    """{demangled kernel at head dim d: {registers, spill_stores, spill_loads}}."""
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
        if f"(int){d}" in name:
            out[name] = entries[mangled]
    return out


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


def child(root: Path, d: int) -> None:
    os.environ["TDX_TORCH_BUILD_DIR"] = str(root / "build" / f"d{d}_ab")
    sys.path.insert(0, str(root))
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from torchdistx_tpu_torch.ops.cuda import _build
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    built = _build.build(SOURCES)
    row = {"root": str(root), "ptxas": _ptxas(_build.build_logs, d) if built else None,
           "ms": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, s, hq, hkv, causal in SHAPES[d]:
        def rand(h):
            return torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16)

        q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)
        out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
        delta = fa.attention_delta(do, out)
        qt, dot = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, do))
        kt, vt = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
                  .requires_grad_() for x in (k, v))
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
        del q, k, v, do, out, lse, delta, qt, kt, vt, dot, out_t
    print(json.dumps(row), flush=True)


def main(args) -> int:
    d = 256
    if args[:1] == ["--d"]:
        d, args = int(args[1]), args[2:]
    if d not in SHAPES:
        sys.stderr.write(f"--d takes one of {sorted(SHAPES)}, not {d}\n")
        return 2
    rows = []
    for root in args:
        proc = subprocess.run([sys.executable, __file__, "--child", str(d),
                               str(Path(root).resolve())], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows.append(json.loads(line))
    print("shape | kernel | " + " | ".join(r["root"] for r in rows))
    for name, *_ in SHAPES[d]:
        for kernel in rows[0]["ms"][name]:
            print(f"{name} | {kernel} | "
                  + " | ".join(f"{r['ms'][name][kernel]:.4f}" for r in rows))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(Path(sys.argv[3]), int(sys.argv[2]))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
