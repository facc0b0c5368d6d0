#!/usr/bin/env python3
"""Where a serving decode step's device time goes, on the GPU.

    python3 scripts/torch_paged_step_profile.py [n_layers]

Builds a Llama at llama_7b's widths (bf16, ``n_layers`` layers, 4 by
default, random weights from seed 0) and a page pool of ``chip_smoke``'s
``[serve]`` geometry (8 slots, 16-token pages, 64 pages a slot), fills
each slot's table with its own pages at a mid-table position, and profiles
one ``forward_paged`` decode step.  Prints the step's device ms, then the
aten ops by their own device ms (each op's kernels), so the kernels of the
step's profile are read against the op that launched them: the paged
gather (``aten::index``), the index-put of the new K/V, the products of
the attention's einsums and their operands' layout copies, the softmax in
float32, the GEMMs.  Then the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's port

SLOTS, BLOCK, PAGES_PER_SLOT = 8, 16, 64


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    from torchdistx_tpu_torch.models.llama import Llama, llama_7b
    from torchdistx_tpu_torch.serving import init_paged_cache

    n_layers = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    cfg = dataclasses.replace(llama_7b(), n_layers=n_layers)
    torch.manual_seed(0)
    model = Llama(cfg, device="cuda")
    weights = model.prep_decode()
    pool = init_paged_cache(model, 1 + SLOTS * PAGES_PER_SLOT, BLOCK)
    tables = 1 + torch.arange(SLOTS * PAGES_PER_SLOT, device="cuda").reshape(SLOTS, -1)
    positions = torch.full((SLOTS,), PAGES_PER_SLOT * BLOCK // 2, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS, 1), device="cuda")

    def step():
        with torch.no_grad():
            model.forward_paged(tokens, pool, tables, positions, weights)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CPU and ev.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    print(f"llama_7b widths x {n_layers} layers, {SLOTS} slots x {PAGES_PER_SLOT * BLOCK} "
          f"positions: one decode step {total:.3f} ms on the device")
    for name, ms, count in sorted(rows, key=lambda r: -r[1]):
        print(f"  {name:40s} {ms:9.3f} ms  {ms / total:6.3f}  x{count}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
