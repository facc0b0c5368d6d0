#!/usr/bin/env python3
"""GPT-2 XL's first AdamW steps on one repeated batch, on the GPU.

    python3 scripts/torch_gpt2_adamw_rates.py

Materializes the full gpt2_xl from seed 0 (``materialize_module_torch``, as
``chip_smoke.py``'s ``[gpt2]`` path does), then trains copies of those
weights for 5 steps of AdamW(foreach=False) on one 4 x 1024 batch, for each
of: bf16 through the flash kernels, bf16 through the plain attention, and
float32 through the flash kernels, at two learning rates.  Prints each
run's losses, then the card's name and power limit.  It shows whether a
loss that climbs on a step comes from the port (the kernels, bf16) or from
the optimizer at that rate (every variant alike).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout's port

RATES = (1e-4, 3e-5)
STEPS = 5
VARIANTS = [(torch.bfloat16, "auto"), (torch.bfloat16, "plain"), (torch.float32, "auto")]


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("this script needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.materialize import materialize_module_torch
    from torchdistx_tpu_torch.models.gpt2 import GPT2, gpt2_xl

    cfg = gpt2_xl()
    values = materialize_module_torch(deferred_init(GPT2, cfg, device_="cuda"), seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    seq = torch.randint(0, cfg.vocab_size, (4, 1025), generator=gen, device="cuda")
    tokens, targets = seq[:, :-1], seq[:, 1:]
    for dtype, impl in VARIANTS:
        for lr in RATES:
            model = GPT2(dataclasses.replace(cfg, dtype=dtype), device="meta")
            model.load_state_dict({k: v.to(dtype).clone() for k, v in values.items()},
                                  assign=True)
            opt = torch.optim.AdamW(model.parameters(), lr=lr, foreach=False)
            losses = []
            for _ in range(STEPS):
                loss = model.loss(tokens, targets, attn_impl=impl)
                loss.backward()
                opt.step()
                opt.zero_grad(set_to_none=True)
                losses.append(round(loss.item(), 4))
            print(f"{str(dtype).replace('torch.', '')} attention={impl} lr={lr}: losses {losses}",
                  flush=True)
            del model, opt
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
