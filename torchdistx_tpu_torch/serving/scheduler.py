"""Request scheduler: FIFO admission, backpressure, streaming handles.

Counterpart of ``torchdistx_tpu/serving/scheduler.py``, copied.

The scheduler owns the *waiting* side of the engine: a FIFO of submitted
requests, the prefill/decode interleave knob (``max_prefills_per_tick`` —
how many prompts may be prefilled per engine tick before the decode batch
runs; raising it favors TTFT, lowering it favors decode throughput), and
the backpressure rule: admission is head-of-line — if the head request's
page reservation does not fit the allocator's free list, nothing is
admitted this tick and the FIFO waits (no out-of-order admission, no
partial grants, no crash).  Both binding constraints are counted: a tick
stalled on pages AND a tick stalled on decode slots bump
``serve.backpressure`` (a slot-bound stall that telemetry cannot see is
indistinguishable from a healthy idle engine).

Lifecycle hooks (see :mod:`.lifecycle`): :meth:`FIFOScheduler.purge`
drops cancelled/deadline-expired requests from the waiting side at each
chunk boundary, :meth:`FIFOScheduler.requeue` puts requests back at the
FIFO *head* after a transient prefill failure (order preserved),
:meth:`FIFOScheduler.shed_oldest` implements the ``drop-oldest``
overload policy, and :meth:`FIFOScheduler.flush` empties the queue when
a drain begins.

:class:`RequestHandle` is the streaming API: ``handle.tokens()`` yields
tokens as the engine produces them, *driving* the engine while the caller
iterates — no background thread, so runs are deterministic and the engine
is single-threaded by construction (document, don't lock).  A request
that failed — cancelled, expired, shed, preempted by a drain, or beyond
its recovery budget — raises its typed :class:`.lifecycle.RequestError`
from ``tokens()``/``result()`` instead of truncating silently.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np

from .. import telemetry as _telemetry
from .blocks import BlockAllocator, blocks_needed
from .lifecycle import RecoveryFailed

__all__ = ["FIFOScheduler", "Request", "RequestHandle"]

_T_BACKPRESSURE = _telemetry.counter("serve.backpressure")
_G_QUEUE = _telemetry.gauge("serve.queue_depth")


@dataclasses.dataclass
class Request:
    """One admitted unit of work (host-side bookkeeping only)."""

    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    key: np.ndarray  # (2,) uint32 — the solo-generate-compatible PRNG key
    handle: "RequestHandle"
    deadline: Optional[float] = None  # absolute perf_counter() expiry
    submit_t: float = dataclasses.field(default_factory=time.perf_counter)
    blocks: Optional[List[int]] = None  # pages owned while running
    recoveries: int = 0  # replay budget consumed by the supervisor
    # Chunked-prefill state (owned by the engine while the request holds
    # a slot in the PREFILLING state):
    n_chunks: int = 1  # estimated prefill cost in chunks (TTFT estimate)
    table: Optional[np.ndarray] = None  # (M,) page table being filled
    prefill_pos: int = 0  # next prompt position to prefill
    n_cached: int = 0  # prompt tokens served from the prefix cache
    hashes: Optional[list] = None  # chained full-page hashes of the prompt
    hit_counted: bool = False  # prefix hit recorded (once per request)
    # QoS context (inert under the FIFO scheduler; see qos.py):
    tenant: str = "default"  # fair-queueing share owner
    priority: int = 0  # priority class — higher admits (and preempts) first
    # Model plane (see modelpool.py): which registered model serves this
    # request, and the version tag folded into its determinism digest —
    # per-model, so two models' digests of the same prompt can never
    # collide.
    model_tag: str = "default"
    model_version: str = "v0"
    # Parallel sampling (``submit(n=4)``): siblings share the parent's
    # prompt pages and diverge copy-on-write.  ``fork_of`` is the parent
    # rid (None for the parent itself / solo requests); ``fork_index``
    # is this request's position in the group — its sampling key is
    # ``fold_key(base_key, fork_index)``.
    fork_of: Optional[int] = None
    fork_index: int = 0
    # Trace context (see docs/observability.md, "Request tracing"): the
    # request-scoped id every req.* lifecycle event and serve.* span
    # carries.  A fleet submission pins one id across every failover hop
    # (hop counts re-submissions); a standalone engine mints
    # "{engine_id}-r{rid}" lazily, only once something is recording.
    trace_id: Optional[str] = None
    hop: int = 0
    # Phase-timing marks (engine-owned; feed the latency histograms):
    admit_t: Optional[float] = None  # first admission (queue-wait end)
    preempt_t: Optional[float] = None  # outage start (preempt/recovery)
    # The rolling determinism digest over (prompt, key schedule, model
    # version, committed tokens): created at submit, updated at every
    # token commit, verified before every replay.  ``audit_of`` marks a
    # shadow-auditor replay (the trace id of the request it re-executes):
    # replays are never themselves audited, nor journaled.
    digest: Optional[Any] = None
    audit_of: Optional[str] = None

    @property
    def cache_tokens(self) -> int:
        """KV slots this request reserves: every prompt + output position."""
        return len(self.prompt) + self.max_new_tokens

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def replay_len(self) -> int:
        """Length of :meth:`replay_seq` without building it."""
        return len(self.prompt) + max(0, len(self.handle._tokens) - 1)

    def replay_seq(self) -> np.ndarray:
        """The sequence a (re-)prefill of this request must run.

        A fresh request prefills its prompt.  A request with committed
        tokens (a drop-and-replay preemption victim, or a supervisor
        replay) re-prefills ``prompt + tokens[:-1]``: every committed
        token but the last was already *fed* to the model, and the last
        is the slot's pending input token.  ``fold_in(key, n_gen)``
        sampling makes the continuation token-identical either way."""
        toks = self.handle._tokens
        if not toks:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(toks[:-1], np.int32)]
        ).astype(np.int32)


class RequestHandle:
    """Streaming view of one request's output."""

    def __init__(self, engine, rid: int):
        self._engine = engine
        self.rid = rid
        self._req = None  # back-ref for lifecycle events (engine sets it)
        self._tokens: List[int] = []
        self._done = False
        self._cancel_requested = False
        self.ttft_s: Optional[float] = None
        self.error: Optional[BaseException] = None
        # Parallel sampling (``submit(n=4)``): every handle of the group
        # carries the SAME list of all n sibling handles (index order);
        # None for solo requests.
        self.siblings: Optional[List["RequestHandle"]] = None

    @property
    def done(self) -> bool:
        return self._done

    @property
    def digest(self) -> Optional[str]:
        """Hex snapshot of the request's rolling determinism digest
        (docs/observability.md, "Audit plane"); None before submission
        wiring completes."""
        req = self._req
        if req is None or req.digest is None:
            return None
        return req.digest.hexdigest()

    def cancel(self) -> bool:
        """Request cancellation.  Takes effect at the next chunk
        boundary (waiting requests leave the queue, running requests
        release their pages); the handle then raises
        :class:`.lifecycle.RequestCancelled`.  Returns False (no-op) if
        the request already finished."""
        if self._done:
            return False
        self._cancel_requested = True
        return True

    def _push(self, token: int) -> None:
        self._tokens.append(token)

    def _event(self, name: str, **attrs) -> None:
        """Emit a lifecycle event for this request — the ONE funnel for
        terminal events, so every failure path (shed, drain flush,
        expiry, cancel, recovery exhaustion) closes the timeline without
        each call site remembering to.  Free for untraced requests
        (``trace_id`` stays None when nothing was recording at submit)."""
        req = self._req
        if req is None or req.trace_id is None:
            return
        _telemetry.event(
            name,
            rid=req.trace_id,
            engine=getattr(self._engine, "engine_id", None),
            hop=req.hop,
            **attrs,
        )

    def _finish(self) -> None:
        self._done = True
        req = self._req
        # Durability funnel: a journaled stream's retirement is recorded
        # the moment its handle goes terminal — same one-funnel rule as
        # the lifecycle events below (no-op without a journal).
        jr = getattr(self._engine, "_journal_retire", None)
        if jr is not None and req is not None:
            jr(req)
        if req is not None and req.trace_id is not None and (
            req.digest is not None
        ):
            # The digest snapshot is stamped ONLY on traced requests —
            # the disabled path formats no hex strings.
            self._event(
                "req.finished",
                n_tokens=len(self._tokens),
                digest=req.digest.hexdigest(),
            )
        else:
            self._event("req.finished", n_tokens=len(self._tokens))

    def _fail(self, error: BaseException) -> None:
        """Abort the request with a typed error (see :mod:`.lifecycle`):
        consumers see the exception instead of a silently truncated
        stream.  Idempotent — the FIRST terminal error wins: a stream
        whose deadline expires mid-migration is failed once by whichever
        side observes it first (source fallback or destination reap),
        never surfaced as two terminal events."""
        if self._done:
            return
        self.error = error
        self._done = True
        jr = getattr(self._engine, "_journal_retire", None)
        if jr is not None and self._req is not None:
            jr(self._req, error=error)
        self._event(
            "req.failed",
            error=type(error).__name__,
            retryable=bool(getattr(error, "retryable", False)),
            n_tokens=len(self._tokens),
        )
        if isinstance(error, RecoveryFailed):
            # Recovery exhaustion is exactly the post-mortem the flight
            # recorder exists for: dump the recent-records ring.
            _telemetry.flight_dump(
                "RecoveryFailed", rid=self._req.trace_id if self._req else None
            )

    def tokens(self) -> Iterator[int]:
        """Yield tokens as they are produced, stepping the engine while
        none are buffered.  Safe to interleave across handles — every
        ``step()`` advances all running requests.  Raises the request's
        typed error if it was aborted."""
        i = 0
        while True:
            while i < len(self._tokens):
                yield self._tokens[i]
                i += 1
            if self._done:
                if self.error is not None:
                    raise self.error
                return
            self._engine.step()

    def result(self) -> List[int]:
        """Block (by stepping the engine) until done; return all tokens —
        up to and including the first EOS, or ``max_new_tokens`` if EOS
        never fires (solo ``generate()``'s output truncated the same way).
        """
        for _ in self.tokens():
            pass
        return list(self._tokens)


class FIFOScheduler:
    """FIFO admission with head-of-line backpressure."""

    def __init__(self, max_prefills_per_tick: int = 1):
        if max_prefills_per_tick < 1:
            raise ValueError("max_prefills_per_tick must be >= 1")
        self.max_prefills_per_tick = max_prefills_per_tick
        self._waiting: deque = deque()
        self._engine_gauge = None  # serve.queue_depth{engine=}, see bind_engine

    def bind_engine(self, engine_id: str) -> None:
        """Mint the per-engine ``serve.queue_depth{engine=...}`` gauge.

        The unlabeled gauge is process-global: N replicas in one process
        clobber it, so anything balancing over engines reads the
        labeled family instead.  The owning engine calls this right
        after constructing its scheduler and prunes the family from the
        registry at STOPPED; a standalone scheduler stays unlabeled."""
        self._engine_gauge = _telemetry.gauge(
            "serve.queue_depth", engine=engine_id
        )
        self._engine_gauge.set(len(self._waiting))

    def _set_queue_gauge(self, n: int) -> None:
        _G_QUEUE.set(n)
        if self._engine_gauge is not None:
            self._engine_gauge.set(n)

    def __len__(self) -> int:
        return len(self._waiting)

    def pending_prefill_chunks(self) -> int:
        """Total prefill cost of the waiting queue, in chunks — the unit
        the TTFT estimate drains at (``max_prefills_per_tick`` chunks per
        tick).  A short prompt is one chunk; a 16k prompt behind a small
        ``prefill_chunk`` is many."""
        return sum(r.n_chunks for r in self._waiting)

    def push(self, req: Request) -> None:
        self._waiting.append(req)
        self._set_queue_gauge(len(self._waiting))

    def requeue(self, reqs: List[Request]) -> None:
        """Return ``reqs`` to the FIFO *head*, preserving their order —
        a transient prefill failure must not cost a request its place."""
        for req in reversed(reqs):
            self._waiting.appendleft(req)
        self._set_queue_gauge(len(self._waiting))

    def shed_oldest(self) -> Optional[Request]:
        """Pop the oldest waiting request (the ``drop-oldest`` overload
        policy's victim), or None if the queue is empty."""
        if not self._waiting:
            return None
        req = self._waiting.popleft()
        self._set_queue_gauge(len(self._waiting))
        return req

    def flush(self) -> List[Request]:
        """Empty the queue (drain start); returns the flushed requests."""
        out = list(self._waiting)
        self._waiting.clear()
        self._set_queue_gauge(0)
        return out

    def purge(self, now: float) -> Tuple[List[Request], List[Request]]:
        """Drop cancelled and deadline-expired requests from the waiting
        side.  Returns ``(expired, cancelled)`` for the engine to fail
        with their typed errors."""
        expired: List[Request] = []
        cancelled: List[Request] = []
        if not self._waiting:
            return expired, cancelled
        keep: deque = deque()
        for req in self._waiting:
            if req.handle._cancel_requested:
                cancelled.append(req)
            elif req.expired(now):
                expired.append(req)
            else:
                keep.append(req)
        if expired or cancelled:
            self._waiting = keep
            self._set_queue_gauge(len(keep))
        return expired, cancelled

    def pop_admissible(
        self,
        n_free_slots: int,
        allocator: BlockAllocator,
        block_size: int,
        reclaim: Optional[Callable[[int], int]] = None,
        need: Optional[Callable[[Request], int]] = None,
        ready: Optional[Callable[[Request], bool]] = None,
    ) -> List[Request]:
        """Pop up to ``max_prefills_per_tick`` requests that fit the free
        slots AND whose cumulative page reservations fit the free list.
        Stops at the first head that doesn't fit (FIFO order is the
        fairness guarantee; skipping ahead would starve long prompts).
        Every stalled tick with work waiting counts — whether pages or
        slots are the binding constraint.

        ``reclaim(n)``, when given, is asked to free up to ``n`` more
        pages before a head is declared unadmittable — the engine wires
        it to prefix-cache LRU eviction, so cached-but-unreferenced
        pages never cause an admission stall that an empty cache would
        not.  The reservation check is conservative (the head's FULL
        page quota, ignoring any prefix it may share): a cache hit can
        only admit *no later* than a cache-off engine would.

        ``need(req)``, when given, overrides the reservation estimate —
        the engine wires the model plane's fork accounting through it
        (a sibling whose parent's prompt pages are live reserves only
        its marginal pages).  ``ready(req)``, when given, gates the
        head: a False head stalls admission WITHOUT being popped (a
        cold model whose weights are still materializing — the engine
        materializes out-of-band and the head admits next tick).  The
        head-of-line rule is deliberate: skipping past a cold head
        would reorder the FIFO, and the stall is one materialize long,
        not a starvation risk."""
        out: List[Request] = []
        limit = min(self.max_prefills_per_tick, n_free_slots)
        if self._waiting and limit == 0:
            _T_BACKPRESSURE.add()  # slot-bound stall, visible like a page-bound one
            return out
        reserved = 0
        while self._waiting and len(out) < limit:
            head = self._waiting[0]
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
            out.append(self._waiting.popleft())
        self._set_queue_gauge(len(self._waiting))
        return out
