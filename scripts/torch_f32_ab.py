#!/usr/bin/env python3
"""Compare the port's CUDA-core f32 flash kernels across checkouts, on one GPU.

    python3 scripts/torch_f32_ab.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``torchdistx_tpu_torch/``.  For each ROOT,
in the order given, a child process imports the port from ROOT, builds its
kernels into ``ROOT/build/f32_ab`` (once per ROOT) and prints one JSON line:

- ``ptxas``: registers, spill stores and loads and stack bytes of every
  f32 instance, from nvcc's ``-Xptxas -v`` report (when the child built);
- ``sass``: each f32 instance's instruction count and a digest of its SASS
  (``cuobjdump -sass``, addresses and encodings left out), so two
  checkouts that compile an instance to the same code give the same digest;
- ``ms``: each kernel's time at F32_SHAPES (the median over 21 repeats of
  10 back-to-back calls between CUDA events, divided by 10), and its plain
  PyTorch version's.

Instances are named by kernel and head dim (``flash_fwd_f32<64>``,
``bwd_kv_f32<64, true>``, ...), the storage type left out when it is
float, so instances of checkouts with and without a storage-type template
parameter line up.  Give the roots as parent, change, change, parent to see
the drift between calls beside the difference.  The last lines are a table
by instance and the card's name and power limit.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

# (name, B, S, Hq, Hkv, D, causal): full attention at 2 x 1000, 8/8 heads,
# at both f32 head dims.
F32_SHAPES = [("2x1000_d64", 2, 1000, 8, 8, 64, False),
              ("2x1000_d128", 2, 1000, 8, 8, 128, False)]
KERNELS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
_F32_BODIES = ("flash_fwd_f32", "bwd_kv_f32", "bwd_kv_f32_tiled", "bwd_dq_f32")


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def _demangle(names):
    out = subprocess.run([_cuda_tool("cu++filt")], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def _instance(demangled: str):
    """``body<args>`` of an f32 body's kernel, float storage left out; None
    for other kernels and for bf16 instances."""
    m = re.search(r"(" + "|".join(_F32_BODIES) + r")<([^>]*)>", demangled)
    if m is None or "bfloat16" in m.group(2):
        return None
    args = [a.strip() for a in m.group(2).split(",") if a.strip() != "float"]
    return f"{m.group(1)}<{', '.join(args)}>"


def _ptxas(logs):
    """{instance: {registers, spill_stores, spill_loads, stack}} from nvcc's
    -Xptxas -v output."""
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
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                entries[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                        spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entries[current]["registers"] = int(m.group(1))
    names = _demangle(list(entries))
    return {_instance(names[k]): v for k, v in entries.items() if _instance(names[k])}


def _sass(libs):
    """{instance: {"instructions": n, "sha": digest}} of every f32 instance."""
    functions = {}
    for lib in libs:
        dump = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(lib)], text=True,
                              capture_output=True, check=True).stdout
        current = None
        for line in dump.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                current = m.group(1)
                functions[current] = []
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if current is not None and m:
                functions[current].append(m.group(1))
    names = _demangle(list(functions))
    out = {}
    for mangled, code in functions.items():
        inst = _instance(names[mangled])
        if inst:
            out[inst] = {"instructions": len(code),
                         "sha": hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]}
    return out


def _time_ms(fn, *, warmup=3, reps=21, calls=10):
    import torch

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


def child(root: Path) -> None:
    build_dir = root / "build" / "f32_ab"
    os.environ["TDX_TORCH_BUILD_DIR"] = str(build_dir)
    sys.path.insert(0, str(root))
    import torch

    from torchdistx_tpu_torch.ops.cuda import _build
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    built = _build.build()
    row = {"root": str(root), "built": built,
           "ptxas": _ptxas(_build.build_logs) if built else None,
           "sass": _sass(sorted(build_dir.glob("lib*.so"))), "ms": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, s, hq, hkv, d, causal in F32_SHAPES:
        def rand(h):
            return torch.randn((b, s, h, d), generator=gen, device="cuda")

        q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)
        out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
        args = (q, k, v, do, lse, fa.attention_delta(do, out))
        calls = {
            "flash_fwd": (lambda: fa.flash_attention_fwd_with_lse(q, k, v, causal=causal),
                          lambda: fa.flash_attention_reference(q, k, v, causal=causal)),
        }
        for kernel, want in (("flash_bwd_fused", (True, True)), ("flash_bwd_dq", (True, False)),
                             ("flash_bwd_dkv", (False, True))):
            calls[kernel] = (
                lambda kernel=kernel: getattr(fa, kernel)(*args, causal=causal),
                lambda want=want: fa.flash_bwd_plain(*args, causal=causal, dq=want[0],
                                                     dkv=want[1]))
        row["ms"][name] = {kernel: {"ms": _time_ms(run),
                                    "plain_ms": _time_ms(plain, warmup=1, reps=5, calls=2)}
                           for kernel, (run, plain) in calls.items()}
    print(json.dumps(row), flush=True)


def main(roots) -> int:
    rows = []
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--child", str(Path(root).resolve())],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows.append(json.loads(line))
    ptxas = {}
    for r in rows:
        ptxas.setdefault(r["root"], r["ptxas"])
    print("instance | " + " | ".join(f"{r['root']}: sass (registers)" for r in rows))
    for inst in sorted(rows[0]["sass"]):
        cells = []
        for r in rows:
            sass = r["sass"].get(inst)
            regs = (ptxas[r["root"]] or {}).get(inst, {}).get("registers")
            cells.append("-" if sass is None else f"{sass['sha']} n={sass['instructions']} "
                                                 f"({regs})")
        same = len({c.split(" (")[0] for c in cells}) == 1
        print(f"{inst} | " + " | ".join(cells) + f" | same code: {same}")
    for shape, *_ in F32_SHAPES:
        for kernel in KERNELS:
            print(f"{shape} {kernel} ms: " + " | ".join(
                f"{r['ms'][shape][kernel]['ms']:.4f} (plain {r['ms'][shape][kernel]['plain_ms']:.4f})"
                for r in rows))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]))
        sys.exit(0)
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
