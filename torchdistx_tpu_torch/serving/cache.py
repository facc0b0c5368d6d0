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
* :func:`swap_out_pages` / :func:`swap_in_pages` — pages to host and back
  (QoS swap preemption, stream migration).  On CUDA the gather and the
  device-to-host copies run on a dedicated swap stream into **pinned**
  host tensors (``non_blocking``); the compute stream waits on the swap
  stream's event, so pages freed after a swap-out are not rewritten
  before the copy has read them, and a swap-in lands before anything the
  compute stream runs after it.  Swap-in scatters in place (the decode
  graph holds the pool by address).  JAX's page-count padding
  (``_page_bucket``) exists for XLA's compile cache and has no
  counterpart.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .blocks import TRASH_BLOCK
from .lifecycle import MigrationIncompatible

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


# One swap stream a device, made on first use (never at import).
_SWAP_STREAMS: dict = {}


def _swap_stream(device: torch.device):
    stream = _SWAP_STREAMS.get(device)
    if stream is None:
        stream = _SWAP_STREAMS[device] = torch.cuda.Stream(device)
    return stream


@torch.no_grad()
def swap_out_pages(paged, pages, *, sync: bool = True):
    """Copy physical ``pages`` (every layer, both pools) to host.

    Read-only: the pool is untouched, so a failure mid-copy leaves the
    device state undamaged (the engine falls back to drop-and-replay).
    Returns ``{"k","v"}: (L, len(pages), bs, Hkv, Dh)`` host tensors, rows
    in ``pages`` order; pinned on CUDA.  ``sync=False`` skips the host
    wait: the compute stream is still ordered after the copies, and a
    :func:`swap_in_pages` of the buffer runs after them on the same swap
    stream, but the host must not read the buffer before a sync."""
    pool0 = next(iter(paged.values()))
    device = pool0.device
    idx = torch.as_tensor(list(pages), dtype=torch.int64, device=device)
    if device.type != "cuda":
        return {name: pool.index_select(1, idx) for name, pool in paged.items()}
    cur = torch.cuda.current_stream(device)
    stream = _swap_stream(device)
    stream.wait_stream(cur)  # the gather reads every write issued before it
    out = {}
    with torch.cuda.stream(stream):
        for name, pool in paged.items():
            rows = pool.index_select(1, idx)
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            out[name] = host
        done = stream.record_event()
    cur.wait_event(done)
    if sync:
        done.synchronize()
    return out


@torch.no_grad()
def swap_in_pages(paged, host, pages):
    """Scatter a :func:`swap_out_pages` buffer into freshly allocated
    ``pages``, in place, and return the pool.  ``len(pages)`` must equal
    the buffer's page count.

    The buffer's page geometry is validated against the pool BEFORE the
    scatter: a cross-pool import (stream migration) with a different
    layer count, page size, head shape or dtype raises a typed, retryable
    :class:`.lifecycle.MigrationIncompatible`, never a silent cast."""
    if pool_geometry(paged) != pool_geometry(host):
        raise MigrationIncompatible(
            "page snapshot does not fit this pool: snapshot geometry "
            f"{pool_geometry(host)!r} != pool geometry "
            f"{pool_geometry(paged)!r}; fall back to a key-pinned replay")
    n = len(pages)
    n_rows = next(iter(host.values())).shape[1]
    if n != n_rows:
        raise MigrationIncompatible(
            f"page snapshot holds {n_rows} page(s) but {n} destination page(s) "
            "were allocated")
    pool0 = next(iter(paged.values()))
    device = pool0.device
    idx = torch.as_tensor(list(pages), dtype=torch.int64, device=device)
    if device.type != "cuda":
        for name, pool in paged.items():
            pool.index_copy_(1, idx, host[name].to(device))
        return paged
    cur = torch.cuda.current_stream(device)
    stream = _swap_stream(device)
    stream.wait_stream(cur)  # the pages' earlier users are done with them
    with torch.cuda.stream(stream):
        for name, pool in paged.items():
            rows = host[name].to(device, non_blocking=True)
            pool.index_copy_(1, idx, rows)
        done = stream.record_event()
    cur.wait_event(done)  # the slot's next decode reads the pages after this
    return paged
