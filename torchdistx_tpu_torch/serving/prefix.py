"""Prefix cache: a refcounted index of full KV pages by token content.

Counterpart of ``torchdistx_tpu/serving/prefix.py``, copied: the page
hashes are the JAX package's bit for bit.

Real serving traffic is dominated by shared prefixes — the same system
prompt in front of millions of requests, the same long document quizzed
repeatedly.  The paged cache (:mod:`.cache`) already stores KV at page
granularity; this module adds the vLLM-style observation (Kwon et al.,
SOSP '23) that a page's KV content is a pure function of **every token
up to and including its own** — so a page can be named by the chained
hash of its token history and *shared* between requests instead of
recomputed.

The index maps ``chained page hash → physical page``:

* ``h_i = H(h_{i-1} || tokens[i*bs : (i+1)*bs])`` — chaining makes the
  hash cover the page's full history, so two prompts that diverge
  anywhere before a page can never collide into sharing it;
* only **full** pages are indexed — a partially-filled page's KV would
  change as more tokens arrive, invalidating its name;
* the index holds ONE allocator reference per indexed page
  (:meth:`~.blocks.BlockAllocator.share`); every request that maps a
  cached page holds its own.  A page whose only reference is the
  index's is an *unreferenced cached prefix* — reclaimable;
* eviction is **LRU under allocator pressure** (:meth:`PrefixIndex.evict`):
  the engine reclaims least-recently-matched pages only when an
  admission or copy-on-write needs pages the free list cannot supply,
  so a populated cache can never cause an admission stall that an empty
  cache would not.

Writes into shared pages are the engine's problem (copy-on-write before
the write — see ``Engine`` in :mod:`.engine`); the index only promises
that everything it maps is refcounted and content-addressed.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional

from .blocks import BlockAllocator

__all__ = ["PrefixIndex", "page_hashes"]


def page_hashes(
    tokens, block_size: int, namespace: bytes = b""
) -> List[bytes]:
    """Chained content hashes of every FULL page of ``tokens``.

    ``tokens`` is any int sequence; result ``i`` names the page holding
    ``tokens[i*bs:(i+1)*bs]`` *and* its entire history (the chain).  A
    trailing partial page gets no hash — its KV is still mutable.

    ``namespace`` seeds the chain.  A page's KV is a function of the
    tokens AND the model that computed it: on a multi-model engine
    (:mod:`.modelpool`) the same prompt under two models must never
    share pages, so the engine seeds the chain with the model tag and
    the first hash already diverges.  The default (empty) namespace is
    the engine's own model — single-model hashes are unchanged.
    """
    import numpy as np

    tok = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    out: List[bytes] = []
    prev = namespace
    for i in range(len(tok) // block_size):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(tok[i * block_size : (i + 1) * block_size].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


class PrefixIndex:
    """LRU map ``chained page hash → physical page``, refcounted through
    the :class:`~.blocks.BlockAllocator`.

    Host-side only; O(pages) per operation, no device work.  The engine
    owns the device side (mapping matched pages into block tables,
    copy-on-write, and the actual eviction trigger).
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        # hash -> page, in LRU order (least-recently-matched first).
        self._pages: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._pages)

    def match(self, hashes: List[bytes]) -> List[int]:
        """Pages of the longest indexed prefix of ``hashes`` (possibly
        empty).  Chained hashes make the walk prefix-closed: the first
        miss ends the match.  Matched entries are LRU-touched; the
        caller must :meth:`~.blocks.BlockAllocator.share` the result
        before relying on it."""
        out: List[int] = []
        for h in hashes:
            page = self._pages.get(h)
            if page is None:
                break
            self._pages.move_to_end(h)
            out.append(page)
        return out

    def probe(self, hashes: List[bytes]) -> int:
        """Length (in pages) of the longest indexed prefix — no LRU
        touch, no refcounts taken.  For estimates (admission TTFT)."""
        n = 0
        for h in hashes:
            if h not in self._pages:
                break
            n += 1
        return n

    def register(
        self, hashes: List[bytes], pages: List[int], allocator: BlockAllocator
    ) -> int:
        """Index ``pages[i]`` under ``hashes[i]``, taking one allocator
        reference per newly-indexed page.  A hash already present keeps
        its existing page (two requests racing the same prompt must
        converge on one copy, not leak two).  Returns pages added."""
        added = 0
        for h, page in zip(hashes, pages):
            if h in self._pages:
                self._pages.move_to_end(h)
                continue
            allocator.share([page])
            self._pages[h] = page
            added += 1
        return added

    def evict(self, n: int, allocator: BlockAllocator) -> int:
        """Free up to ``n`` *unreferenced* cached pages (refcount 1 — the
        index's own), least-recently-matched first.  Pages still mapped
        by live requests are skipped, not stalled on.  Returns pages
        actually freed."""
        if n <= 0:
            return 0
        freed = 0
        for h, page in list(self._pages.items()):
            if freed >= n:
                break
            if allocator.refcount(page) != 1:
                continue  # a live request still maps it
            allocator.free([page])
            del self._pages[h]
            freed += 1
        self.evictions += freed
        return freed

    def release(self, allocator: BlockAllocator) -> None:
        """Drop every index reference (engine close/drain): cached pages
        not mapped by a request return to the free list."""
        for page in self._pages.values():
            allocator.free([page])
        self._pages.clear()

    def clear(self) -> None:
        """Forget everything WITHOUT touching the allocator — the
        recovery path, where ``allocator.reset()`` already reclaimed the
        map and the pool content is gone."""
        self._pages.clear()

    def check(self, allocator: BlockAllocator) -> Optional[str]:
        """Refcount-drift check (chaos soak): every indexed page must be
        in use with at least the index's own reference.  Returns a
        description of the first violation, or None."""
        for h, page in self._pages.items():
            rc = allocator.refcount(page)
            if rc < 1:
                return f"indexed page {page} has refcount {rc} (stale index)"
        return None
