"""QoS scheduler: SLO-aware multi-tenant admission — priority classes,
weighted fair queueing, deadline-aware ordering.

Counterpart of ``torchdistx_tpu/serving/qos.py``, copied (pure host
code): the pop order is the JAX scheduler's for the same push/pop
sequence.

The FIFO scheduler (:mod:`.scheduler`) admits in arrival order: one
burst tenant or one long batch job starves everyone behind it, and
``deadline_s`` only *expires* requests, it never *orders* them.
:class:`QoSScheduler` is a drop-in replacement behind the same
interface (``push`` / ``pop_admissible`` / ``purge`` / ``requeue`` /
``flush`` / ``shed_oldest`` / ``pending_prefill_chunks``), selected via
``Engine(scheduler="qos")``, ordering admission by three nested rules:

1. **Priority classes are strict.**  A waiting request of a higher
   ``Request.priority`` admits before any lower one — and under page or
   slot pressure the engine *preempts* running lower-priority streams
   to make room (swap-to-host or drop-and-replay; see
   :class:`~.engine.Engine`).
2. **Within a class, tenants share by weighted fair queueing** over
   prefill-chunk cost (Demers et al., SIGCOMM '89), virtual-time
   based: each (class, tenant) pair carries a virtual time advanced by
   ``chunks / weight`` per admitted request, and among tenants with
   work in the class the smallest virtual time goes next.  Virtual
   time is scoped per class — service in one class never moves
   another class's clock, so a quiet class's pops cannot hand a
   newly-busy tenant a head start over a busy class's incumbents.  Chunks are
   the engine's native cost unit (chunked prefill) and **cache-aware**:
   ``Request.n_chunks`` weighs only the suffix a prefix-cache hit will
   actually prefill (``PrefixIndex.probe`` at submit), so a cached
   request charges its tenant what it will really cost.  The ordering
   path is a pure function of the push/pop sequence — no ``time.time``
   anywhere — so tests are deterministic.
3. **Within a (class, tenant) queue: earliest deadline first.**
   Requests carrying a ``deadline_s`` order by their absolute expiry
   (stamped once at submit; comparing stamps needs no clock),
   deadline-less requests after them, ties by submission order.

Starvation bounds are provable from rule 2: over any interval where a
tenant stays backlogged, it receives at least ``w / W`` of the class's
admitted chunk budget (``W`` = total weight of backlogged tenants), so
a weight-1 tenant under sustained weight-8 competition admits within
~``8 × cost`` chunks of competing work — pinned in
``tests/test_torch_serving_qos.py``.  An idle tenant's virtual time is
clamped up to its class's clock when it becomes busy again: sleeping
banks no credit (the classic virtual-time rule).

Two shedding hooks ride along: :meth:`shed_oldest` keeps the FIFO
``drop-oldest`` policy working unchanged, and :meth:`shed_lowest`
implements ``shed_policy="by-priority"`` — the victim is the **lowest
class, youngest first**, and an arrival that is itself the lowest
class is the one shed (the engine rejects it).

Transactional requeues (:meth:`requeue` — a transient prefill failure
returning its admission batch) re-enter at the *head of the line*,
ahead of the QoS order, and are **not** re-charged: the failure must
not cost the request its place or its tenant a second fare.  A
*preemption* requeue goes through :meth:`push` instead — the victim
re-enters QoS order behind the higher class that displaced it, and its
resume cost (the re-prefill of prompt + generated-so-far) is charged
like any other work.

Telemetry: the shared ``serve.queue_depth`` gauge plus a per-tenant
labeled ``serve.queue_depth{tenant=...}`` gauge family (rendered with
a proper ``tenant`` label on a ``/metrics`` scrape).

State is bounded: tenant counters, empty per-tenant heaps, and gauge
iteration all prune when a tenant's waiting count hits zero — the
pruned tenant's gauge leaves the process-wide registry too
(:func:`torchdistx_tpu_torch.telemetry.remove`), so the registry and every
``/metrics`` scrape track ACTIVE tenants, not tenants ever seen — and a
class whose last waiting request leaves drops its virtual clock and
every tenant virtual time — the classic busy-period reset (virtual
time restarts at zero when the system idles; with no one waiting,
relative debts are moot).  A long-lived engine serving free-form
per-user tenant ids therefore pays O(active tenants) per operation,
not O(tenants ever seen).
"""

from __future__ import annotations

import heapq
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .. import telemetry as _telemetry
from .blocks import BlockAllocator, blocks_needed
from .scheduler import Request

__all__ = ["QoSScheduler"]

_T_BACKPRESSURE = _telemetry.counter("serve.backpressure")
_G_QUEUE = _telemetry.gauge("serve.queue_depth")


class QoSScheduler:
    """Priority + weighted-fair-queueing + EDF admission (see module
    docstring).  Drop-in for :class:`~.scheduler.FIFOScheduler`.

    Parameters
    ----------
    max_prefills_per_tick : the prefill/decode interleave knob, in
        chunks per tick (identical to the FIFO scheduler's).
    tenant_weights : ``{tenant: weight}`` — relative shares of prefill
        chunk capacity within a priority class.  Unlisted tenants get
        ``default_weight``.  Weights must be > 0.
    default_weight : weight of tenants absent from ``tenant_weights``.
    """

    def __init__(
        self,
        max_prefills_per_tick: int = 1,
        tenant_weights: Optional[Dict[str, float]] = None,
        default_weight: float = 1.0,
    ):
        if max_prefills_per_tick < 1:
            raise ValueError("max_prefills_per_tick must be >= 1")
        self.max_prefills_per_tick = max_prefills_per_tick
        self._weights: Dict[str, float] = {}
        for tenant, w in (tenant_weights or {}).items():
            w = float(w)
            if w <= 0:
                raise ValueError(
                    f"tenant_weights[{tenant!r}] = {w}: weights must be > 0"
                )
            self._weights[str(tenant)] = w
        self.default_weight = float(default_weight)
        if self.default_weight <= 0:
            raise ValueError("default_weight must be > 0")
        # priority -> tenant -> heap of (deadline_key, seq, Request).
        self._queues: Dict[int, Dict[str, List[Tuple[float, int, Request]]]] = {}
        # Transactional head-of-line returns (failed prefill batches):
        # drained FIFO before any QoS selection, never re-charged.
        self._requeued: deque = deque()
        # Virtual time is scoped PER PRIORITY CLASS: fair queueing runs
        # among the tenants of one class, so a class's clock must only
        # advance on that class's service.  One global clock would let
        # a pop in a quiet low class regress the clock and hand a
        # newly-busy tenant of a busy class a huge head start over its
        # backlogged incumbents — breaking the w/W starvation bound.
        self._vt: Dict[Tuple[int, str], float] = {}  # (prio, tenant) -> finish
        self._vclock: Dict[int, float] = {}  # prio -> clock at last service
        self._n = 0
        self._tenant_n: Dict[str, int] = {}
        self._tenant_gauges: Dict[str, object] = {}
        self._engine_gauge = None  # serve.queue_depth{engine=}, see bind_engine

    # ------------------------------------------------------------------
    # Introspection

    def __len__(self) -> int:
        return self._n

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self.default_weight)

    def _iter(self):
        """Every waiting request (no particular order)."""
        for req in self._requeued:
            yield req
        for tmap in self._queues.values():
            for heap in tmap.values():
                for _, _, req in heap:
                    yield req

    def pending_prefill_chunks(self) -> int:
        """Total prefill cost of the waiting queues, in chunks (the
        same contract as the FIFO scheduler's)."""
        return sum(r.n_chunks for r in self._iter())

    # ------------------------------------------------------------------
    # Gauges

    def bind_engine(self, engine_id: str) -> None:
        """Mint the per-engine ``serve.queue_depth{engine=...}`` gauge
        (same contract as :meth:`FIFOScheduler.bind_engine
        <torchdistx_tpu_torch.serving.scheduler.FIFOScheduler.bind_engine>`):
        the unlabeled gauge is process-global and N replicas clobber it,
        so a fleet and the autoscaler's slope predictor read the labeled
        family; the owning engine prunes it at STOPPED."""
        self._engine_gauge = _telemetry.gauge(
            "serve.queue_depth", engine=engine_id
        )
        self._engine_gauge.set(self._n)

    def _set_gauges(self) -> None:
        _G_QUEUE.set(self._n)
        if self._engine_gauge is not None:
            self._engine_gauge.set(self._n)
        # Departed tenants (count pruned to zero) leave BOTH the
        # iteration set and the process-wide registry
        # (telemetry.remove): a long-lived engine serving free-form
        # per-user tenant ids must not grow the registry — and with it
        # every exported counters snapshot and /metrics scrape — by one
        # gauge per tenant ever seen.  The gauge family is labeled
        # (serve.queue_depth{tenant=...}), so a Prometheus scrape sees
        # the tenant as a proper label and idle tenants' series simply
        # end.
        for tenant in [
            t for t in self._tenant_gauges if t not in self._tenant_n
        ]:
            del self._tenant_gauges[tenant]
            _telemetry.remove("serve.queue_depth", tenant=tenant)
        for tenant, n in self._tenant_n.items():
            g = self._tenant_gauges.get(tenant)
            if g is None:
                g = _telemetry.gauge("serve.queue_depth", tenant=tenant)
                self._tenant_gauges[tenant] = g
            g.set(n)

    def _count(self, req: Request, delta: int) -> None:
        self._n += delta
        n = self._tenant_n.get(req.tenant, 0) + delta
        if n:
            self._tenant_n[req.tenant] = n
        else:
            self._tenant_n.pop(req.tenant, None)

    def _gc_class(self, prio: int) -> None:
        """Prune a class's empty tenant heaps; when its last waiting
        request left (requeued deque included), drop the class map and
        reset its virtual time wholesale — the classic busy-period
        rule.  Keeps scheduler state proportional to waiting work."""
        tmap = self._queues.get(prio)
        if tmap is not None:
            for tenant in [t for t, h in tmap.items() if not h]:
                del tmap[tenant]
            if not tmap:
                del self._queues[prio]
                tmap = None
        if tmap is None and not any(
            r.priority == prio for r in self._requeued
        ):
            self._vclock.pop(prio, None)
            for vk in [vk for vk in self._vt if vk[0] == prio]:
                del self._vt[vk]

    # ------------------------------------------------------------------
    # Push / selection / pop

    @staticmethod
    def _key(req: Request) -> Tuple[float, int, Request]:
        """EDF-within-(class, tenant) heap key: absolute deadline stamp
        (deadline-less requests last), ties by submission order."""
        dl = req.deadline if req.deadline is not None else math.inf
        return (dl, req.rid, req)

    def push(self, req: Request) -> None:
        heap = self._queues.setdefault(req.priority, {}).setdefault(
            req.tenant, []
        )
        if not heap:
            # Idle (class, tenant) queue going busy: clamp its virtual
            # time up to the class clock — sleeping banks no credit.
            vk = (req.priority, req.tenant)
            self._vt[vk] = max(
                self._vt.get(vk, 0.0),
                self._vclock.get(req.priority, 0.0),
            )
        heapq.heappush(heap, self._key(req))
        self._count(req, +1)
        self._set_gauges()

    def _select(self) -> Optional[Tuple[int, str]]:
        """The (priority, tenant) queue the next pop comes from, or
        None.  Highest class first; within it, smallest tenant virtual
        time (ties by tenant name — deterministic)."""
        best: Optional[Tuple[int, str]] = None
        for prio in sorted(self._queues, reverse=True):
            tenants = [t for t, h in self._queues[prio].items() if h]
            if tenants:
                best = (
                    prio,
                    min(
                        tenants,
                        key=lambda t: (self._vt.get((prio, t), 0.0), t),
                    ),
                )
                break
        return best

    def peek(self) -> Optional[Request]:
        """The request the next :meth:`pop_admissible` would admit
        first — no removal, no virtual-time charge.  The engine's
        preemption trigger reads the head's priority and page quota
        from here."""
        if self._requeued:
            return self._requeued[0]
        sel = self._select()
        if sel is None:
            return None
        prio, tenant = sel
        return self._queues[prio][tenant][0][2]

    def _pop_next(self) -> Request:
        if self._requeued:
            req = self._requeued.popleft()  # already charged — no re-fare
        else:
            prio, tenant = self._select()
            _, _, req = heapq.heappop(self._queues[prio][tenant])
            vk = (prio, tenant)
            self._vclock[prio] = self._vt.get(vk, 0.0)
            self._vt[vk] = self._vclock[prio] + max(
                1, req.n_chunks
            ) / self.weight(tenant)
        self._count(req, -1)
        self._gc_class(req.priority)
        return req

    # ------------------------------------------------------------------
    # The scheduler contract (FIFOScheduler-compatible)

    def pop_admissible(
        self,
        n_free_slots: int,
        allocator: BlockAllocator,
        block_size: int,
        reclaim: Optional[Callable[[int], int]] = None,
        need: Optional[Callable[[Request], int]] = None,
        ready: Optional[Callable[[Request], bool]] = None,
    ) -> List[Request]:
        """Pop up to ``max_prefills_per_tick`` requests in QoS order
        whose cumulative page reservations fit the free list.  Stops at
        the first head that doesn't fit — no skipping ahead to smaller
        requests (that would starve long prompts within a class, the
        same rule the FIFO scheduler enforces); the engine's preemption
        path is the legitimate way to make room for a blocked head.
        Backpressure accounting matches the FIFO scheduler's: any
        stalled tick with work waiting counts, slot- or page-bound.

        ``need``/``ready`` match the FIFO scheduler's contract (see
        :meth:`.scheduler.FIFOScheduler.pop_admissible`): ``need(req)``
        overrides the page reservation (fork siblings charge their true
        marginal pages — the WFQ fare already charged their marginal
        prefill, one chunk), ``ready(req)`` holds a cold-model head in
        place without popping it while the engine materializes its
        weights out-of-band."""
        out: List[Request] = []
        limit = min(self.max_prefills_per_tick, n_free_slots)
        if self._n and limit == 0:
            _T_BACKPRESSURE.add()
            return out
        reserved = 0
        while self._n and len(out) < limit:
            head = self.peek()
            if ready is not None and not ready(head):
                break  # cold model: the engine counts + materializes
            n_pages = (
                need(head) if need is not None
                else blocks_needed(head.cache_tokens, block_size)
            )
            avail = allocator.num_free - reserved
            if n_pages > avail and reclaim is not None:
                reclaim(n_pages - avail)
                avail = allocator.num_free - reserved
            if n_pages > avail:
                _T_BACKPRESSURE.add()
                break
            reserved += n_pages
            out.append(self._pop_next())
        self._set_gauges()
        return out

    def requeue(self, reqs: List[Request]) -> None:
        """Return ``reqs`` to the head of the line in order, ahead of
        the QoS order and without a second virtual-time charge — the
        transactional path for a transiently-failed admission batch
        (preemption victims re-enter via :meth:`push` instead)."""
        for req in reversed(reqs):
            self._requeued.appendleft(req)
            self._count(req, +1)
        self._set_gauges()

    def _remove(self, victim: Request) -> None:
        """Drop one specific waiting request (shed paths)."""
        try:
            self._requeued.remove(victim)
        except ValueError:
            heap = self._queues[victim.priority][victim.tenant]
            heap.remove(self._key(victim))
            heapq.heapify(heap)
        self._count(victim, -1)
        self._gc_class(victim.priority)
        self._set_gauges()

    def shed_oldest(self) -> Optional[Request]:
        """The globally oldest waiting request (``drop-oldest``
        compatibility), or None."""
        oldest = min(self._iter(), key=lambda r: r.rid, default=None)
        if oldest is not None:
            self._remove(oldest)
        return oldest

    def shed_lowest(
        self, below_priority: Optional[int] = None
    ) -> Optional[Request]:
        """The ``shed_policy="by-priority"`` victim: lowest class,
        youngest first.  With ``below_priority`` given, only a victim
        of a strictly lower class qualifies — None means the arrival is
        itself the lowest class and should be the one shed."""
        victim: Optional[Request] = None
        for req in self._iter():
            if victim is None or (req.priority, -req.rid) < (
                victim.priority,
                -victim.rid,
            ):
                victim = req
        if victim is None:
            return None
        if below_priority is not None and victim.priority >= below_priority:
            return None
        self._remove(victim)
        return victim

    def flush(self) -> List[Request]:
        """Empty every queue (drain start); returns the flushed
        requests in submission order."""
        out = sorted(self._iter(), key=lambda r: r.rid)
        self._queues.clear()
        self._requeued.clear()
        self._n = 0
        self._tenant_n = {}
        self._vt.clear()
        self._vclock.clear()
        self._set_gauges()
        return out

    def purge(self, now: float) -> Tuple[List[Request], List[Request]]:
        """Drop cancelled and deadline-expired requests from the
        waiting side; returns ``(expired, cancelled)`` exactly like the
        FIFO scheduler."""
        expired: List[Request] = []
        cancelled: List[Request] = []
        if not self._n:
            return expired, cancelled
        for req in list(self._iter()):
            if req.handle._cancel_requested:
                cancelled.append(req)
            elif req.expired(now):
                expired.append(req)
        for req in expired + cancelled:
            self._remove(req)
        return expired, cancelled
