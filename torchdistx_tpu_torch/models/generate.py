"""Autoregressive generation: prefill, then a decode loop over the KV cache.

Counterpart of ``torchdistx_tpu/models/generate.py``.  The cache is
allocated at ``prompt_len + max_new_tokens`` up front and updated in place;
the decode weights are fused once per call.  Greedy decoding
(``temperature=0``) is token-identical to the JAX version; sampling draws
from ``generator`` (PyTorch's default one when ``None``).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["generate"]


def _sample(logits, temperature: float, top_k: Optional[int], generator):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(
    model,
    prompt: torch.Tensor,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt (B, S)``.

    ``model`` provides ``cfg``, ``init_cache``, ``prep_decode`` and
    ``forward_cached`` (:class:`~torchdistx_tpu_torch.models.llama.Llama`,
    :class:`~torchdistx_tpu_torch.models.gpt2.GPT2`).
    Returns ``(B, max_new_tokens)`` int64 tokens on the prompt's device.
    After ``eos_id`` (if given) a sequence keeps emitting ``eos_id``; once
    every sequence is done, the remaining steps skip the model and emit
    ``eos_id``.
    """
    cfg = model.cfg
    b, s = prompt.shape
    total = s + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds cfg.max_seq_len ({cfg.max_seq_len})"
        )
    cache = model.init_cache(b, total, device=prompt.device)
    weights = model.prep_decode()

    logits, cache = model.forward_cached(prompt, cache, 0, weights)
    tok = _sample(logits[:, -1], temperature, top_k, generator)
    done = tok == eos_id if eos_id is not None else None
    out = [tok]
    for i in range(max_new_tokens - 1):
        if done is not None and bool(done.all()):
            # All-done early exit: no model forward, just the eos fill.
            out.append(torch.full_like(tok, eos_id))
            continue
        logits, cache = model.forward_cached(tok[:, None], cache, s + i, weights)
        tok = _sample(logits[:, -1], temperature, top_k, generator)
        if done is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)
