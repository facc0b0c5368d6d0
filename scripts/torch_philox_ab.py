#!/usr/bin/env python3
"""Compare the port's Philox fill (``csrc/philox.cu``) across checkouts and
knock-out variants, on one GPU.

    python3 scripts/torch_philox_ab.py [--materialize] SPEC [SPEC ...]

Each SPEC is ``ROOT`` or ``ROOT:VARIANT``.  ROOT is a checkout holding
``torchdistx_tpu_torch/`` (another commit unpacked with ``git archive``
under the git-ignored ``build/``).  A VARIANT is a knock-out of VARIANTS,
applied as text edits to a copy of ROOT's package under
``build/philox_ab/`` of this checkout; it computes other values, so it is
timed and not checked:

- ``notrig``: the cosine and sine of a pair replaced by their argument;
- ``nologsqrt``: the radius sqrt(-2 log u1) replaced by -2 u1;
- ``nostore``: the stores skipped unless the unit's bits hash to one value
  (the values are still computed: the stores' own cost; in the tiled loop
  unless a lane of the warp hits);
- ``hoist``: a row's start computed by one multiply, exact for boxes of up
  to two dims, which every row here is (the parent's per-dim 64-bit
  division loop gone);
- ``scalarstore``: every unit of the general loop stored lane by lane
  (the 16-byte stores gone; the same values);
- ``nostage``: the tiled loop's 4- and 8-byte units stored by their own
  thread, not through shared memory (the same values);
- ``widegrid``: a thread a unit (a grid of every unit, not a persistent
  one; the same values).

For each SPEC, in the order given, a child process imports the package,
builds ``philox.cu`` into its own directory and prints one JSON line:

- ``ptxas``: registers, stack frame and spills of each instance;
- ``sass``: each instance's static SASS counts (``cuobjdump -sass``): its
  instructions, those of its widest loop and that loop's opcodes, and the
  loop's instructions an element (over the elements a step of the loop
  computes: the source's ``kUnit``, 4 in the parent's one-block design);
- ``rows``: at each of ``chip_smoke.py``'s PHILOX_ROWS, the fill's time by
  CUDA events (the median over 21 repeats of 10 back-to-back calls,
  divided by 10) and its device time by torch.profiler, a digest
  (SHA-256) of its bytes, whether it is bit-equal to the plain version
  (not for a variant), its bound (``chip_smoke._philox_bound``), the issue
  time its SASS count implies at the card's highest SM clock, and the
  torch yardstick's time (``Tensor.normal_`` / ``uniform_``, ``random_``
  over the whole int32 range for the words);
- with ``--materialize``: phase 3's seeded materialize of llama_7b
  (``materialize_module_torch(seed=0)`` of a ``deferred_init`` recording on
  the card): its seconds, then, under torch.profiler, the philox launches'
  count and their summed device time, beside the device time of every
  kernel of the call.

Give the specs as parent, change, change, parent to see the drift between
calls beside the difference.  The last lines are a table by row, whether
each row's bits agree across the specs, and the card's name and power
limit.  A spec whose child fails is reported, left out of the table, and
sets the exit code.  Needs a CUDA device; about 20 s a spec (a minute with
``--materialize``).
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PARENT_G0 = """    long long rest = row, g0 = box.offset[box.ndim - 1];
    for (int d = box.ndim - 2; d >= 0; --d) {
      const long long idx = rest % box.size[d];
      rest /= box.size[d];
      g0 += (box.offset[d] + idx) * box.stride[d];
    }"""
_BITS = """__device__ __forceinline__ uint32_t tdx_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t tdx_bits(double x) {
  return static_cast<uint32_t>(__double_as_longlong(x) >> 20);
}
__device__ __forceinline__ uint32_t tdx_bits(uint32_t x) { return x; }

enum Kind {"""
# Each variant: edit sets of (old, new), one for each design of the
# source; the first set whose every ``old`` occurs exactly once applies.
VARIANTS = {
    "notrig": [
        [("mul_rn(r, cos_(theta))", "mul_rn(r, theta)"),
         ("mul_rn(r, sin_(theta))", "mul_rn(r, theta)")],
        [("sincosf(__fmul_rn(u2, 6.2831855f), s, c);", "*s = *c = __fmul_rn(u2, 6.2831855f);"),
         ("sincos(__dmul_rn(u2, 6.283185307179586), s, c);",
          "*s = *c = __dmul_rn(u2, 6.283185307179586);")],
    ],
    "nologsqrt": [
        [("const F r = sqrt_(mul_rn(static_cast<F>(-2), log_(u1)));",
          "const F r = mul_rn(static_cast<F>(-2), u1);")],
        [("return sqrtf(__fmul_rn(-2.0f, logf(u1)));", "return __fmul_rn(-2.0f, u1);"),
         ("return ::sqrt(__dmul_rn(-2.0, ::log(u1)));", "return __dmul_rn(-2.0, u1);")],
    ],
    "nostore": [
        [("enum Kind {", _BITS),
         ("      if constexpr (kChunks > 1) {\n",
          "      uint32_t tdx_acc = k1;\n#pragma unroll\n"
          "      for (int l = 0; l < kUnit; ++l) tdx_acc ^= tdx_bits(v[l]);\n"
          "      if (!__any_sync(0xffffffffu, live && tdx_acc == 0x2545F491u)) {\n"
          "      } else if constexpr (kChunks > 1) {\n"),
         ("      if (e0 >= g0 && e0 + kUnit <= g1 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {",
          "      uint32_t tdx_acc = k1;\n#pragma unroll\n"
          "      for (int l = 0; l < kUnit; ++l) tdx_acc ^= tdx_bits(v[l]);\n"
          "      if (tdx_acc != 0x2545F491u) {\n"
          "      } else if (e0 >= g0 && e0 + kUnit <= g1 &&\n"
          "                 (reinterpret_cast<uintptr_t>(p) & 15) == 0) {")],
        [("enum Kind {", _BITS),
         ("    const long long base = row * box.len - g0;\n",
          "    uint32_t tdx_acc = k1;\n#pragma unroll\n"
          "    for (int l = 0; l < 4; ++l) tdx_acc ^= tdx_bits(v[l]) ^ w[l];\n"
          "    if (tdx_acc != 0x2545F491u) continue;\n"
          "    const long long base = row * box.len - g0;\n")],
    ],
    "hoist": [
        [(_PARENT_G0, "    long long g0 = box.offset[box.ndim - 1] + (box.ndim > 1 ? "
                      "(box.offset[0] + row) * box.stride[0] : 0);")],
    ],
    "scalarstore": [
        [("      if (e0 >= g0 && e0 + kUnit <= g1 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {",
          "      if (false) {")],
    ],
    "nostage": [
        [("      if constexpr (kChunks > 1) {\n", "      if constexpr (false) {\n")],
    ],
    "widegrid": [
        [("  const long long grid = want < most ? want : most;",
          "  const long long grid = want;")],
    ],
}


def _chip_smoke():
    """This checkout's chip_smoke.py, as a module (its rows and helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variant_copy(root: Path, variant: str) -> Path:
    """A copy of ``root``'s package under build/philox_ab/ with the
    variant's edits applied to philox.cu; returns the copy's root."""
    dest = REPO / "build" / "philox_ab" / f"{root.name}_{variant}"
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(root / "torchdistx_tpu_torch", dest / "torchdistx_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dest / "torchdistx_tpu_torch" / "ops" / "cuda" / "csrc" / "philox.cu"
    src = cu.read_text()
    for edits in VARIANTS[variant]:
        if all(src.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                src = src.replace(old, new)
            cu.write_text(src)
            return dest
    raise SystemExit(f"variant {variant} matches no design of {cu}")


def _digest(t) -> str:
    import torch

    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def _materialize(cs):
    """Phase 3's seeded materialize of llama_7b: seconds, then the philox
    launches' count and summed device time under torch.profiler."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.materialize import materialize_module_torch
    from torchdistx_tpu_torch.models.llama import Llama, llama_7b

    out = {}
    for label in ("timed", "profiled"):
        model = deferred_init(Llama, llama_7b(), device_="cuda")
        torch.cuda.synchronize()
        if label == "timed":
            t0 = time.perf_counter()
            values = materialize_module_torch(model, seed=cs.MAT_SEED)
            torch.cuda.synchronize()
            out["seconds"] = time.perf_counter() - t0
        else:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                values = materialize_module_torch(model, seed=cs.MAT_SEED)
                torch.cuda.synchronize()
            events = cs._device_events(prof)
            fills = [ev for ev in events if "philox_fill" in ev.name]
            out.update(philox_launches=len(fills),
                       philox_device_ms=sum(ev.time_range.elapsed_us() for ev in fills) / 1e3,
                       all_device_ms=sum(ev.time_range.elapsed_us() for ev in events) / 1e3)
        out.setdefault("bytes", sum(v.numel() * v.element_size() for v in values.values()))
        del model, values
        cs._free()
    return out


def child(spec: str, materialize: bool) -> None:
    root, _, variant = spec.partition(":")
    root = Path(root).resolve()
    pkg_root = _variant_copy(root, variant) if variant else root
    tag = f"{root.name}_{variant}" if variant else root.name
    os.environ["TDX_TORCH_BUILD_DIR"] = str(REPO / "build" / "philox_ab" / f"lib_{tag}")
    sys.path.insert(0, str(pkg_root))
    import torch

    from torchdistx_tpu_torch.ops.cuda import _build, philox

    cs = _chip_smoke()
    src = (pkg_root / "torchdistx_tpu_torch" / "ops" / "cuda" / "csrc" / "philox.cu").read_text()
    m = re.search(r"constexpr int kUnit = (\d+);", src)
    unit = int(m.group(1)) if m else 4
    _build.build(["philox"])
    report = cs._ptxas_report(_build.build_logs) if _build.build_logs else {}
    funcs = cs._sass_functions(_build.BUILD_DIR / "libphilox.so")
    sass = {}
    for inst in cs.PHILOX_INSTANCES:
        body = next((b for name, b in funcs.items() if f"::{inst}(" in name), None)
        if body is not None:
            sass[inst] = cs._sass_loop(body, cs.PHILOX_SASS_MARK)
            sass[inst]["per_element"] = (sass[inst]["loop"] / unit if sass[inst]["loop"]
                                         else None)
    clock_hz = cs._sm_clock_hz()
    row = {"spec": spec, "unit": unit, "sm_clock_hz": clock_hz,
           "ptxas": {i: cs._in_report(report, i) for i in cs.PHILOX_INSTANCES},
           "sass": sass, "rows": {}}
    fills = {"normal": philox.normal_, "uniform": philox.uniform_,
             "words": lambda out, key, a, b, **box: philox.words_(out, key, **box)}
    for name, kind, dtype, full, offset, (a, b) in cs.PHILOX_ROWS:
        off, size = cs._philox_box(full, offset)
        out = torch.empty(size, dtype=dtype, device="cuda")

        def run(out=out, kind=kind, a=a, b=b, full=full, off=off):
            return fills[kind](out, cs.PHILOX_KEY, a, b, full_shape=full, offset=off)

        got = run().clone()
        torch.cuda.synchronize()
        inst = f"philox_fill<{cs.PHILOX_INSTANCE[dtype]}, (int){cs.PHILOX_KINDS[kind]}>"
        per_element = sass.get(inst, {}).get("per_element")
        r = {"instance": inst, "digest": _digest(got), **cs._philox_bound(kind, dtype, full,
                                                                            off, size),
             "issue_ms": (cs._issue_ms(per_element, got.numel(), clock_hz)
                          if per_element else None)}
        if not variant:
            want = philox.fill_plain(torch.empty_like(out), kind, cs.PHILOX_KEY, a, b,
                                     full_shape=full, offset=off)
            r["bit_equal_plain"] = torch.equal(got, want)
            del want
        lib = torch.empty(size, dtype=dtype, device="cuda")
        library = {"normal": lambda: lib.normal_(a, b), "uniform": lambda: lib.uniform_(a, b),
                   "words": lambda: lib.random_(-2 ** 31, 2 ** 31)}[kind]
        r.update(ms=cs._time_ms(run), device_ms=cs._device_ms(run, calls=20),
                 library_ms=cs._time_ms(library))
        row["rows"][name] = r
        del got, out, lib, library
        torch.cuda.empty_cache()
    if materialize:
        row["materialize"] = _materialize(cs)
    print(json.dumps(row), flush=True)


def main(args) -> int:
    materialize = args[:1] == ["--materialize"]
    specs = args[1:] if materialize else args
    rows, failed = [], 0
    for spec in specs:
        proc = subprocess.run([sys.executable, __file__, "--child", spec]
                              + (["--materialize"] if materialize else []),
                              capture_output=True, text=True)
        if proc.returncode != 0:  # reported, and left out of the table
            sys.stderr.write(proc.stdout + proc.stderr)
            print(json.dumps({"spec": spec, "failed": proc.returncode}), flush=True)
            failed = proc.returncode
            continue
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows.append(json.loads(line))
    if not rows:
        return failed
    print("row | ms (device ms) | " + " | ".join(r["spec"] for r in rows))
    for name in rows[0]["rows"]:
        first = rows[0]["rows"][name]
        print(f"{name} | bound {first['bound_ms']:.4f} ({first['bound_by']}) | "
              + " | ".join(f"{r['rows'][name]['ms']:.4f} ({r['rows'][name]['device_ms']:.4f})"
                           for r in rows)
              + f" | yardstick {first['library_ms']:.4f}")
    for name in rows[0]["rows"]:
        digests = {r["rows"][name]["digest"] for r in rows if ":" not in r["spec"]}
        print(f"{name} | bits | "
              + ("the same at every root" if len(digests) <= 1 else "DIFFER: " + str(digests)))
    if all("materialize" in r for r in rows):
        print("materialize | " + " | ".join(
            f"{r['materialize']['seconds']:.3f} s, {r['materialize']['philox_launches']} "
            f"philox launches, {r['materialize']['philox_device_ms']:.3f} ms of "
            f"{r['materialize']['all_device_ms']:.3f}" for r in rows))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return failed


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3:4] == ["--materialize"])
        sys.exit(0)
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
