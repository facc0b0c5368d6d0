#!/usr/bin/env python3
"""Shard-then-materialize of the full Llama-7B on 4 gloo ranks sharing one
GPU, for one or more trees of the port, in turns.

    python3 scripts/torch_init_sharded_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (its ``torchdistx_tpu_torch``
package is imported from there; unpack another commit with ``git archive``
under the git-ignored ``build/``).  For each root, in the order given, four
processes join a gloo group on ``MeshSpec(fsdp=2, tp=2)`` over the one card
and each materializes ``llama_7b()`` recorded by ``deferred_init`` through
``materialize_module_torch(mesh=, plan=param_specs(cfg), seed=7)`` (the body
of ``llama.init_sharded``, which older trees lack).  Each rank reports its
seconds, the bytes its values hold, the allocator's bytes, its peak and the
peak over its values (``max_memory_allocated`` after
``reset_peak_memory_stats``, less what the values take), and the
``materialize.*`` counters it moved.  Prints one JSON line per root and the
card's name and power limit.  Needs a CUDA device; about 30 s a root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 7
WORLD = 4


def rank_main(root: str, rank: int, store: str, out: str) -> None:
    sys.path.insert(0, root)
    import torch
    import torch.distributed as dist

    from torchdistx_tpu_torch import telemetry
    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.materialize import materialize_module_torch
    from torchdistx_tpu_torch.models.llama import Llama, llama_7b, param_specs
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_mesh(MeshSpec(fsdp=2, tp=2), device_type="cuda")
        cfg = llama_7b()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        counted = telemetry.counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = deferred_init(Llama, cfg, device="cuda")
        values = materialize_module_torch(model, mesh=mesh, plan=param_specs(cfg), seed=SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        allocated = torch.cuda.memory_allocated() - before
        peak = torch.cuda.max_memory_allocated() - before
        local = [v.to_local() for v in values.values()]
        held = sum(t.untyped_storage().nbytes() for t in local)
        report = {
            "rank": rank, "s": secs, "held_bytes": held, "allocated_bytes": allocated,
            "peak_bytes": peak, "peak_over_values": peak - allocated,
            "largest_shard_bytes": max(t.numel() * t.element_size() for t in local),
            "counters": {k: v - counted.get(k, 0) for k, v in telemetry.counters().items()
                         if k.startswith("materialize.") and v != counted.get(k, 0)},
        }
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(report, f)


def run_root(root: str) -> dict:
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    if os.path.exists(os.path.join(root, "torchdistx_tpu_torch/ops/cuda/csrc/philox.cu")):
        # Build once here, not in four ranks at once.
        subprocess.run([sys.executable, "-c", "from torchdistx_tpu_torch.ops.cuda import "
                        "_build; _build.build(['philox'])"], env=env, check=True)
    with tempfile.TemporaryDirectory(prefix="tdx_init_ab_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(WORLD)]
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", root, str(r),
                                   os.path.join(tmp, "store"), outs[r]], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(WORLD)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
                  if p.returncode]
        if failed:
            raise RuntimeError(f"{root}: ranks failed: {failed}")
        ranks = [json.load(open(out)) for out in outs]
    return {"root": root, "ranks": ranks}


def main(roots) -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    for root in roots:
        print(json.dumps(run_root(root)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        root, rank, store, out = sys.argv[2:6]
        rank_main(root, int(rank), store, out)
        sys.exit(0)
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
