"""Attention ops: the plain reference, decode-time cached attention, and the
implementation dispatcher.

Counterpart of ``torchdistx_tpu/ops/attention.py``.  Layout everywhere is
``(B, S, H, D)``; grouped-query attention (``Hq % Hkv == 0``) maps query
head ``h`` to kv head ``h // (Hq // Hkv)`` with no head expansion.
"""

from __future__ import annotations

import torch

__all__ = ["attention", "cached_attention", "mha_reference"]

_NEG = torch.finfo(torch.float32).min


def mha_reference(q, k, v, *, causal: bool = True):
    """Plain multi-head attention (GQA-aware), softmax in float32.

    q ``(B, Sq, Hq, D)``; k/v ``(B, Sk, Hkv, D)``.  Returns ``(B, Sq, Hq, D)``
    in q's dtype.  Masked logits take ``finfo(float32).min``.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    scale = 1.0 / (d**0.5)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if causal:
        mask = (
            torch.arange(sq, device=q.device)[:, None]
            >= torch.arange(sk, device=q.device)[None, :]
        )
        logits = torch.where(mask, logits, _NEG)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


def _attend_cached(q, k_cache, v_cache, valid):
    """GQA attention of ``q (B, T, Hq, D)`` over a cache ``(B, Sk, Hkv, D)``.

    ``valid`` broadcasts against the float32 logits ``(B, T, Hkv, G, Sk)``.
    """
    b, t, hq, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    scale = 1.0 / (d**0.5)
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, k_cache).float() * scale
    logits = torch.where(valid, logits, _NEG)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum(
        "bqhgk,bkhd->bqhgd", probs.to(v_cache.dtype), v_cache
    )
    return out.reshape(b, t, hq, d)


def cached_attention(q, k_cache, v_cache, pos: int):
    """Decode-time attention against a static-shape KV cache.

    q ``(B, T, Hq, D)`` holds the queries of positions ``pos .. pos+T-1``;
    the caches ``(B, Smax, Hkv, D)`` are valid up to ``pos+T``.  Key ``j``
    attends to query ``i`` iff ``j <= pos + i``.
    """
    t = q.shape[1]
    smax = k_cache.shape[1]
    dev = q.device
    valid = (
        torch.arange(smax, device=dev)[None, :]
        <= (pos + torch.arange(t, device=dev))[:, None]
    )
    return _attend_cached(q, k_cache, v_cache, valid[None, :, None, None, :])


def attention(q, k, v, *, causal: bool = True, impl: str = "auto"):
    """Dispatching attention entry point used by the model.

    ``impl``: ``"auto" | "plain" | "flash"``.  ``auto`` takes the
    hand-written flash kernel for CUDA tensors and :func:`mha_reference`
    for CPU tensors.  ``"flash"`` on a tensor that is not on CUDA raises.
    """
    if impl == "auto":
        impl = "flash" if q.is_cuda else "plain"
    if impl == "plain":
        return mha_reference(q, k, v, causal=causal)
    if impl == "flash":
        if not q.is_cuda:
            raise ValueError(
                f"attention impl='flash' needs CUDA tensors, got {q.device}"
            )
        from .cuda.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    raise ValueError(
        f"unknown attention impl: {impl!r} (expected auto|plain|flash)"
    )
