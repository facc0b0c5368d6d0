"""Attention ops: the plain reference, decode-time cached and paged attention,
and the implementation dispatcher.

Counterpart of ``torchdistx_tpu/ops/attention.py``.  Layout everywhere is
``(B, S, H, D)``; grouped-query attention (``Hq % Hkv == 0``) maps query
head ``h`` to kv head ``h // (Hq // Hkv)`` with no head expansion.

With a mesh, q, k and v are the global arrays as ``DTensor``s (or plain
tensors, each rank holding the whole array), as the JAX ``attention`` takes
global arrays under ``jit``: the flash kernel and the plain attention run
on each rank's block (batch over ``dp``/``fsdp``, heads over ``tp``, the
sequence whole), ring attention over ``seq_axis``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention", "cached_attention", "mha_reference", "paged_attention",
           "paged_write_index", "resolve_stage_attn_impl"]

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


def paged_write_index(block_tables, positions, block_size: int):
    """Page and offset each token writes to: ``(blk, off)``, shaped like
    ``positions``, in ``block_tables``' dtype.

    ``positions`` is ``(B,)`` (each slot's one decode token) or ``(B, T)``
    (a chunked-prefill block of ``T`` tokens a slot).  The one steering
    rule of the paged cache, shared by both families' ``forward_paged``
    and ``serving.cache.write_prompt``: a position past its table
    (``pos // bs >= M``) steers into page 0, the trash page the allocator
    never hands out, so a retired slot still in the batch, or a chunk's
    padding, never writes on a live slot's pages.
    """
    m = block_tables.shape[1]
    blk_no = torch.div(positions, block_size, rounding_mode="floor")
    idx = blk_no.clamp(0, m - 1).long()
    if positions.ndim == 1:
        blk = block_tables.gather(1, idx[:, None])[:, 0]
    else:  # (B, T): T gathers a slot from its own table row
        blk = block_tables.gather(1, idx)
    blk = torch.where(blk_no < m, blk, torch.zeros_like(blk))
    return blk, (positions % block_size).to(block_tables.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, positions):
    """Decode-time attention against a paged KV cache (the serving path).

    q ``(B, T, Hq, D)`` holds slot ``b``'s queries of positions
    ``positions[b] .. positions[b]+T-1``; ``k_pages`` / ``v_pages``
    ``(NB, bs, Hkv, D)`` are one layer's page pools; ``block_tables (B, M)``
    maps slot ``b``'s logical block ``j`` to its page.  Each slot's pages
    are gathered into a ``(B, M*bs, Hkv, D)`` view and attended through
    :func:`_attend_cached` with the mask ``key j <= positions[b] + i``:
    pages past a slot's history, and the trash page, get exactly zero
    probability.  The gather reads ``M*bs`` positions a slot whatever the
    history, so ``M`` (the engine's ``max_model_len``) sets the step's
    bytes.
    """
    b, t = q.shape[0], q.shape[1]
    _, bs, hkv, d = k_pages.shape
    m = block_tables.shape[1]
    tables = block_tables.long()
    k = k_pages[tables].reshape(b, m * bs, hkv, d)
    v = v_pages[tables].reshape(b, m * bs, hkv, d)
    dev = q.device
    valid = (
        torch.arange(m * bs, device=dev)[None, None, :]
        <= (positions[:, None] + torch.arange(t, device=dev)[None, :])[:, :, None]
    )
    return _attend_cached(q, k, v, valid[:, :, None, None, :])


_IMPLS = "auto|plain|flash|ring|ring_zigzag"


def _select_impl(impl, seq_axis, *, cuda: bool) -> str:
    """Resolve ``impl="auto"``: ring when ``seq_axis`` is set; else the
    plain attention off CUDA and the flash kernel on CUDA, under a mesh on
    each rank's block.  The JAX ``_select_impl`` takes XLA's attention
    under a mesh whose shapes do not divide, or that has an axis it does
    not know (such as a ``"data"`` / ``"model"`` mesh); here the kernel
    runs on whatever block divides, over the axes it is told are the batch
    and head axes, so CUDA tensors never take the plain version."""
    if impl != "auto":
        return impl
    if seq_axis is not None:
        return "ring"
    return "flash" if cuda else "plain"


def resolve_stage_attn_impl(attn_impl: str, *, cuda: bool,
                            seq_axis: Optional[str] = None) -> str:
    """The attention impl for code inside a pipeline stage (shared by every
    family's pipeline path).  ``"auto"`` is the flash kernel on CUDA
    tensors (``cuda``) and the plain attention otherwise; with a sequence
    axis (``seq_axis``, GPipe's sp x pp) it is the contiguous ring over
    that axis of the stage's mesh.  An explicit ``"flash"``, ``"plain"``
    or (with ``seq_axis``) ``"ring"`` stands.  The JAX function pins
    ``"auto"`` to XLA's full attention and refuses its Pallas kernel
    because the kernel's ``shard_map`` cannot nest in the pipeline's; here
    a stage is this rank's own computation, and under ``tp`` the kernel
    runs on the stage's mesh through ``on_blocks`` /
    ``flash_attention_sharded``, and under ``seq_axis`` the ring runs on
    its ``sp`` group (the same values as the full attention).  The zigzag
    ring, and the ring without a sequence axis, raise."""
    if attn_impl == "ring_zigzag" or (attn_impl == "ring" and seq_axis is None):
        raise ValueError(f"attn_impl={attn_impl!r} cannot run inside a pipeline stage "
                         "(the ring needs seq_axis, and the zigzag layout does not compose "
                         "with pp); use 'auto', 'flash' or 'plain'")
    if attn_impl == "auto":
        return "ring" if seq_axis is not None else "flash" if cuda else "plain"
    return attn_impl


def attention(q, k, v, *, causal: bool = True, impl: str = "auto", mesh=None,
              seq_axis: Optional[str] = None, pre_permuted: bool = False,
              batch_axes=("dp", "fsdp"), head_axis: Optional[str] = "tp"):
    """Dispatching attention entry point used by the model.

    ``impl``: ``"auto" | "plain" | "flash" | "ring" | "ring_zigzag"``.
    ``auto`` is ring attention when ``seq_axis`` is set; else the
    hand-written flash kernel for CUDA tensors and :func:`mha_reference`
    otherwise.  Under ``mesh`` either runs on each rank's block: the batch
    over ``batch_axes`` and the heads over ``head_axis`` (``None``: whole)
    as far as they divide
    (:func:`~torchdistx_tpu_torch.ops.cuda.flash_attention.
    flash_attention_sharded` when both do).  ``"flash"`` on a tensor that is not on
    CUDA raises.  ``ring_zigzag`` is the load-balanced causal ring
    schedule; ``pre_permuted`` (zigzag only) means the sequence is already
    in zigzag order (see
    :func:`~torchdistx_tpu_torch.parallel.ring_attention.ring_attention`).
    """
    cuda = q.device.type == "cuda"
    impl = _select_impl(impl, seq_axis, cuda=cuda)
    if impl in ("ring", "ring_zigzag"):
        if mesh is None or seq_axis is None:
            raise ValueError("ring attention needs mesh= and seq_axis=")
        from ..parallel.ring_attention import ring_attention

        return ring_attention(
            q, k, v, mesh=mesh, axis=seq_axis, causal=causal,
            schedule="zigzag" if impl == "ring_zigzag" else "contiguous",
            pre_permuted=pre_permuted, batch_axes=batch_axes,
            head_axes=() if head_axis is None else (head_axis,),
        )
    if pre_permuted:
        raise ValueError("pre_permuted is only meaningful with ring_zigzag")
    if impl == "plain":
        if mesh is None:
            return mha_reference(q, k, v, causal=causal)
        from .cuda.flash_attention import on_blocks

        return on_blocks(lambda a, b, c: mha_reference(a, b, c, causal=causal),
                         q, k, v, mesh=mesh, batch_axes=batch_axes, head_axis=head_axis)
    if impl == "flash":
        if not cuda:
            raise ValueError(
                f"attention impl='flash' needs CUDA tensors, got {q.device}"
            )
        from .cuda.flash_attention import (
            flash_attention,
            flash_attention_sharded,
            on_blocks,
            shardable,
        )

        if mesh is None:
            return flash_attention(q, k, v, causal=causal)
        axes = dict(batch_axes=batch_axes, head_axis=head_axis)
        if shardable(mesh, q.shape, k.shape, **axes):
            return flash_attention_sharded(q, k, v, causal=causal, mesh=mesh, **axes)
        # Shapes that do not divide over the mesh (an odd batch, kv heads
        # fewer than tp): the kernel on the block that does divide.
        return on_blocks(lambda a, b, c: flash_attention(a, b, c, causal=causal),
                         q, k, v, mesh=mesh, **axes)
    raise ValueError(f"unknown attention impl: {impl!r} (expected {_IMPLS})")
