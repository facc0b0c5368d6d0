"""Block allocator for the paged KV cache (vLLM-style, host-side).

Counterpart of ``torchdistx_tpu/serving/blocks.py``, copied onto the
port's telemetry.

The device-side cache is a pool of ``num_blocks`` fixed-size pages per
layer (see :mod:`.cache`); this module owns the *map*: which pages are
free, which belong to which request.  All bookkeeping is host-side Python
— allocation happens once per request admit/finish, never per token, so
there is nothing to compile.

Page 0 is the **trash page**: it is never handed out, and every masked
write (prompt padding, retired-but-still-batched slots, position
overshoot) is steered into it.  Scribbling on trash is safe by
construction — the attention mask zeroes any read of a page outside a
slot's own table (:func:`torchdistx_tpu_torch.ops.attention.paged_attention`).

Pages are **refcounted** (vLLM-style prefix sharing): ``alloc`` hands a
page out with one reference, ``share()`` adds references — the prefix
index and every request mapping a cached prefix hold one each — and
``free()`` removes one, returning the page to the free list only when
the last reference drops.  A page with more than one reference is
*shared*: writers must copy-on-write before touching it (the engine's
job; the allocator only exposes :meth:`refcount`).

Invariants (enforced, not assumed):

* ``alloc`` never hands out a page that still has references
  (double-assignment raises);
* ``free()``/``share()`` of a page with no references raises
  (double-free / stray free / stray share);
* exhaustion is a ``None`` return, not an exception — the scheduler turns
  it into backpressure (the request waits in the FIFO);
* ``utilization()``/``num_in_use`` count **physical** pages: a page
  shared by five requests is one page of HBM, not five.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import telemetry as _telemetry

__all__ = ["BlockAllocator", "TRASH_BLOCK", "blocks_needed"]

TRASH_BLOCK = 0

_G_UTIL = _telemetry.gauge("serve.block_util")
_G_SWAPPED = _telemetry.gauge("serve.swapped_pages")


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache slots."""
    return -(-n_tokens // block_size)


class BlockAllocator:
    """Free-list allocator over pages ``1 .. num_blocks-1`` (0 is trash)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (page 0 is the trash page)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: recently-freed (still-warm) pages are reused
        # first.  Deterministic: same admit/finish order → same tables.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}  # page -> live reference count
        # Logical pages whose KV currently lives in a HOST buffer (the
        # QoS swap-to-host preemption path).  The physical pages were
        # freed — utilization()/num_in_use stay honest about HBM — and
        # this count is what keeps the *logical* picture honest: the
        # serve.swapped_pages gauge reports host-resident pages that
        # will want physical pages back at swap-in.
        self._n_swapped = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (the trash page doesn't count)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        """PHYSICAL pages with at least one reference (shared pages count
        once — this is HBM occupancy, not the sum of refcounts)."""
        return len(self._ref)

    @property
    def num_swapped(self) -> int:
        """Logical pages currently swapped out to host buffers."""
        return self._n_swapped

    def refcount(self, blk: int) -> int:
        """Live references on ``blk`` (0 = free).  A result > 1 means the
        page is shared and a writer must copy-on-write first."""
        return self._ref.get(blk, 0)

    def utilization(self) -> float:
        """Fraction of allocatable pages currently owned (physical)."""
        return len(self._ref) / self.capacity

    def fragmentation(self) -> float:
        """Scatter of the free map in ``[0, 1]``: 0 when every free page
        sits in one contiguous id run (or nothing/everything is free),
        approaching 1 as the free pages splinter into single-page holes
        between allocations.  Paged attention itself is indifferent to
        contiguity — this is the *observability* estimate the HBM
        ledger exports (``mem.pool_fragmentation``): a pool that stays
        shattered under churn is a pool whose holes the allocator keeps
        cutting, the early signature of admission patterns that thrash
        pages.  Computed as ``1 - largest_free_run / num_free`` over
        sorted page ids — O(num_free), called per tick only with the
        ops plane attached."""
        n = len(self._free)
        if n <= 1:
            return 0.0
        ids = sorted(self._free)
        best = run = 1
        for a, b in zip(ids, ids[1:]):
            run = run + 1 if b == a + 1 else 1
            if run > best:
                best = run
        return 1.0 - best / n

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages, or ``None`` if fewer than ``n`` are free
        (backpressure — never a partial grant)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for blk in out:
            if blk in self._ref or blk == TRASH_BLOCK:
                raise RuntimeError(f"block allocator double-assigned page {blk}")
            self._ref[blk] = 1
        _G_UTIL.set(round(self.utilization(), 4))
        return out

    def share(self, blocks: List[int]) -> None:
        """Add one reference to each page (prefix-cache mapping: the page
        now also backs the sharer's block table).  Sharing a page with no
        live references raises — a cached page must already be owned by
        the index or a request."""
        for blk in blocks:
            if blk not in self._ref:
                raise RuntimeError(
                    f"sharing page {blk} that is not in use (stray share)"
                )
        for blk in blocks:
            self._ref[blk] += 1

    def reset(self) -> None:
        """Forget every grant and rebuild the full free list.

        The crash-recovery supervisor's primitive: when a failed device
        call may have damaged the page pool, every page's KV is treated as
        gone and the ownership map with it — the supervisor zeroes the pool
        and re-reserves pages per replayed request from a clean map.
        Page order matches a fresh allocator, so a deterministic replay
        produces deterministic tables."""
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = {}
        # Host swap buffers die with the pool they were cut from: the
        # engine's recovery path converts swapped slots to replays.
        self._n_swapped = 0
        _G_UTIL.set(0.0)
        _G_SWAPPED.set(0)

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per page; a page whose LAST reference drops
        returns to the free list.  Freeing a page with no references
        raises (double free / stray free) — BEFORE any reference moves,
        so a failed call never half-applies."""
        counts: Dict[int, int] = {}
        for blk in blocks:
            counts[blk] = counts.get(blk, 0) + 1
        for blk, n in counts.items():
            if self._ref.get(blk, 0) < n:
                raise RuntimeError(
                    f"freeing page {blk} that is not in use (double free?)"
                )
        for blk in blocks:
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                del self._ref[blk]
                self._free.append(blk)
        _G_UTIL.set(round(self.utilization(), 4))

    # ------------------------------------------------------------------
    # Swap-to-host accounting (the QoS preemption path; see engine.py)

    def swap_out(self, blocks: List[int]) -> None:
        """Release ``blocks`` whose KV was copied to a host buffer: one
        reference drops per page (shared pages survive on their other
        references, exactly like :meth:`free`) and the count of
        host-resident logical pages rises.  The caller owns the host
        buffer; :meth:`swap_in` or :meth:`drop_swapped` settles the
        account."""
        self.free(blocks)
        self._n_swapped += len(blocks)
        _G_SWAPPED.set(self._n_swapped)

    def swap_in(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` physical pages for a host buffer coming back;
        ``None`` (nothing changes) when fewer than ``n`` are free."""
        got = self.alloc(n)
        if got is not None:
            self._n_swapped -= n
            _G_SWAPPED.set(self._n_swapped)
        return got

    def drop_swapped(self, n: int) -> None:
        """Forget ``n`` host-resident pages without re-allocating them:
        the swapped request was preempted to drop-and-replay, failed,
        or cancelled, and its host buffer was discarded."""
        if n > self._n_swapped:
            raise RuntimeError(
                f"dropping {n} swapped pages but only {self._n_swapped} "
                "are accounted (double drop?)"
            )
        self._n_swapped -= n
        _G_SWAPPED.set(self._n_swapped)
