"""Device-side paged KV cache: the page pool, the prompt scatter and the
page copy.

Counterpart of ``torchdistx_tpu/serving/cache.py``.  The pool is the
family's contiguous cache with the sequence axis cut into pages:
``{"k","v"}: (L, num_blocks, block_size, Hkv, Dh)`` in the parameters'
dtype.  Where the JAX functions donate the pool and return a new one,
these update it in place and return it: the pool's storage never moves,
so a CUDA graph captured over it stays valid (:func:`fresh_pool` zeroes it
in place for the same reason).

* :func:`init_paged_cache` — allocate the zeroed pool, its geometry probed
  from the family's own ``init_cache`` on the meta device.
* :func:`write_prompt` — scatter a contiguous prefill cache into a slot's
  pages; pad positions and positions past the table land in the trash
  page (:func:`~torchdistx_tpu_torch.ops.attention.paged_write_index`).
* :func:`copy_pages` — copy one page in every layer of both pools: the
  prefix cache's copy-on-write.
* :func:`pool_geometry` — a pool's page geometry, everything but its page
  count.

The swap-to-host pair (``swap_out_pages`` / ``swap_in_pages``) belongs to
QoS preemption and migration (ROADMAP A7).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .blocks import TRASH_BLOCK

__all__ = [
    "copy_pages",
    "fresh_pool",
    "init_paged_cache",
    "pool_geometry",
    "swap_in_pages",
    "swap_out_pages",
    "write_prompt",
]


def init_paged_cache(model, num_blocks: int, block_size: int, *,
                     device: Optional[Any] = None):
    """Zeroed page pool ``{"k","v"}: (L, NB, bs, Hkv, Dh)`` for ``model``
    (a :class:`~torchdistx_tpu_torch.models.llama.Llama` or
    :class:`~torchdistx_tpu_torch.models.gpt2.GPT2`), on ``device`` (the
    parameters' by default).  Shapes and dtype come from
    ``model.init_cache`` on the meta device: nothing is allocated by the
    probe."""
    proto = model.init_cache(1, 1, device="meta")
    if device is None:
        device = next(model.parameters()).device
    out = {}
    for name, leaf in proto.items():
        n_layers, _, _, heads, head_dim = leaf.shape
        out[name] = torch.zeros((n_layers, num_blocks, block_size, heads, head_dim),
                                dtype=leaf.dtype, device=device)
    return out


@torch.no_grad()
def fresh_pool(paged):
    """Zero ``paged`` in place and return it: the recovery supervisor's
    rebuild.  In place, so every captured graph's pool addresses stay
    valid; zeroed is the state the pool had at construction."""
    for pool in paged.values():
        pool.zero_()
    return paged


@torch.no_grad()
def write_prompt(paged, contiguous, table, length: int, *, block_size: int):
    """Scatter a slot's prefill KV into its pages, in place.

    ``contiguous``: ``{"k","v"}: (L, 1, P_pad, H, D)`` from the family's
    ``forward_cached``; ``table (M,)`` the slot's page table (padded with
    trash); ``length`` the real prompt length.  Positions ``>= length`` and
    past the table land in the trash page."""
    from ..ops.attention import paged_write_index

    p_pad = next(iter(contiguous.values())).shape[2]
    table = torch.as_tensor(table, device=next(iter(paged.values())).device).long()
    pos = torch.arange(p_pad, device=table.device)
    blk, off = paged_write_index(table[None].expand(p_pad, table.shape[0]), pos, block_size)
    blk = torch.where(pos < length, blk, torch.full_like(blk, TRASH_BLOCK))
    for name, pool in paged.items():
        pool[:, blk, off] = contiguous[name][:, 0].to(pool.dtype)
    return paged


def pool_geometry(paged) -> tuple:
    """Hashable page geometry of a pool: its names and each leaf's
    ``(L, block_size, Hkv, Dh, dtype)``, everything about a page but how
    many the pool holds."""
    return tuple(
        (name,) + (x.shape[0],) + tuple(x.shape[2:]) + (str(x.dtype),)
        for name, x in sorted(paged.items())
    )


@torch.no_grad()
def copy_pages(paged, src: int, dst: int):
    """Copy page ``src`` onto ``dst`` in every layer of both pools, in
    place (the prefix cache's copy-on-write)."""
    for pool in paged.values():
        pool[:, int(dst)] = pool[:, int(src)]
    return paged


def swap_out_pages(paged, pages):
    """Not ported: swap-to-host belongs to QoS preemption and migration."""
    raise NotImplementedError("swap_out_pages: QoS preemption and migration are "
                              "ROADMAP A7, not ported yet")


def swap_in_pages(paged, host, pages):
    """Not ported: swap-to-host belongs to QoS preemption and migration."""
    raise NotImplementedError("swap_in_pages: QoS preemption and migration are "
                              "ROADMAP A7, not ported yet")
