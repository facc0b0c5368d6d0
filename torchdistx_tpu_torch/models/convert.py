"""Load the JAX package's Llama parameters into the port's :class:`Llama`.

The JAX pytree (``torchdistx_tpu.models.llama._shapes``) stores weights
``(in, out)`` with the layers stacked on axis 0; :class:`Llama` keeps
``nn.Linear`` weights ``(out, in)``, one block per layer.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device
from .llama import Llama, LlamaConfig

__all__ = ["llama_from_jax_params"]

# JAX layer-pytree key -> (block attribute, transpose to (out, in)).
_LAYER_KEYS = {
    "attn_norm": ("attn_norm", False),
    "wq": ("wq", True),
    "wk": ("wk", True),
    "wv": ("wv", True),
    "wo": ("wo", True),
    "mlp_norm": ("mlp_norm", False),
    "w_gate": ("w_gate", True),
    "w_up": ("w_up", True),
    "w_down": ("w_down", True),
}


def llama_from_jax_params(
    params_np: dict, cfg: LlamaConfig, device: Optional[Any] = None
) -> Llama:
    """A :class:`Llama` on ``device`` computing the same function as the
    JAX parameters ``params_np`` (a pytree of numpy arrays; bf16 arrays
    may be passed as ``np.asarray(x, np.float32)``).  Values are cast to
    ``cfg.dtype``."""
    device = resolve_device(device)
    model = Llama(cfg, device="meta").to_empty(device=device)

    def put(dst: torch.Tensor, src, transpose: bool) -> None:
        t = torch.tensor(np.asarray(src, np.float32))
        if transpose:
            t = t.T
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.copy_(t)

    layers = params_np["layers"]
    with torch.no_grad():
        put(model.embed.weight, params_np["embed"]["weight"], False)
        put(model.norm.weight, params_np["norm"]["weight"], False)
        put(model.lm_head.weight, params_np["lm_head"]["weight"], True)
        for i, blk in enumerate(model.layers):
            for key, (attr, transpose) in _LAYER_KEYS.items():
                put(getattr(blk, attr).weight, layers[key][i], transpose)
    return model
