"""Request-lifecycle robustness: typed errors, engine health, overload.

Counterpart of ``torchdistx_tpu/serving/lifecycle.py``, copied.

The serving engine's failure surface, made first-class (the serving
analog of what :mod:`torchdistx_tpu_torch.resilience` did for training).
Production continuous-batching systems (vLLM, Orca) treat admission
control and failure recovery as part of the scheduler contract, not as
exception noise — a caller must be able to tell, from the *type* of a
failure, whether to retry the request elsewhere (`retryable=True`:
overload shed, drain preemption), fix the request (validation errors
raise plain ``ValueError`` at ``submit``), or give up (deadline,
cancellation, exhausted recovery budget).

Three pieces live here:

* the **typed error taxonomy** — every way a submitted request can fail
  is a :class:`RequestError` subclass carrying ``retryable``; handles
  raise these from ``tokens()``/``result()`` instead of bare
  ``RuntimeError`` strings;
* the **health state machine** — :class:`Health`:
  ``STARTING → READY → DRAINING → STOPPED``, plus ``OVERLOADED`` as a
  READY-adjacent pressure state.  ``Engine.health()`` exposes it and the
  ``serve.health`` gauge tracks every transition;
* the **overload detector** — :class:`OverloadDetector`: queue depth
  against a bounded queue plus estimated time-to-first-token from an
  EWMA of tick duration.  The engine consults it at ``submit`` to drive
  the shedding policy (``reject-new`` | ``drop-oldest``).
"""

from __future__ import annotations

import enum
from typing import Optional

__all__ = [
    "DeadlineExceeded",
    "DeterminismDiverged",
    "EngineDraining",
    "EngineOverloaded",
    "Health",
    "JournalOwned",
    "MigrationIncompatible",
    "OverloadDetector",
    "RecoveryFailed",
    "RequestCancelled",
    "RequestError",
    "RequestPreempted",
]


class Health(enum.Enum):
    """Engine lifecycle states.

    ``STARTING`` — constructed, no tick executed yet (programs cold).
    ``READY`` — serving; admission open.
    ``OVERLOADED`` — serving, but the overload detector trips: new
    submissions are shed per the engine's policy until pressure drops.
    ``DRAINING`` — preemption observed: admission closed, in-flight work
    finishing under the drain deadline.
    ``STOPPED`` — drain complete; the engine no longer accepts work.
    """

    STARTING = "starting"
    READY = "ready"
    OVERLOADED = "overloaded"
    DRAINING = "draining"
    STOPPED = "stopped"


class RequestError(RuntimeError):
    """Base of every typed request/engine failure.

    ``retryable`` is the client contract: True means the request itself
    was fine and a retry (here after backoff, or against another
    replica) is the right move; False means retrying the identical
    request cannot help.
    """

    retryable: bool = False


class DeadlineExceeded(RequestError):
    """The request's ``deadline_s`` expired before completion.

    Raised from the handle at the chunk boundary where the expiry was
    observed; the request's pages were released there."""


class RequestCancelled(RequestError):
    """The client called :meth:`RequestHandle.cancel`."""


class EngineOverloaded(RequestError):
    """Shed by the overload policy (bounded queue / TTFT estimate)."""

    retryable = True


class EngineDraining(RequestError):
    """Submission refused: the engine is DRAINING or STOPPED."""

    retryable = True


class RequestPreempted(RequestError):
    """Failed by a drain or an engine close: either flushed from the
    queue before starting, or cut off in flight.  The stream is
    *explicitly* truncated — retry against another replica.

    ``resumable`` tells the client what a retry costs: ``True`` means
    the request had yielded **no tokens yet** (flushed from the queue,
    or preempted before its first token) — a plain re-submission
    resumes it losslessly.  ``False`` means it was cut mid-stream: a
    lossless resume needs a key-pinned, token-verified replay;
    naive re-submission would restart the stream from token 0."""

    retryable = True
    resumable: bool = False

    def __init__(self, *args, resumable: bool = False):
        super().__init__(*args)
        self.resumable = resumable


class RecoveryFailed(RequestError):
    """The crash-recovery supervisor exhausted the request's replay
    budget (``max_recoveries``) without completing it."""

    retryable = True


class MigrationIncompatible(RequestError):
    """A live-stream KV page migration could not land on the destination
    engine: pool geometry mismatch (layer count, page size, head shape,
    dtype), a different weights version, or a snapshot wider than the
    destination's block table.  The import is rejected BEFORE any page
    scatter — an incompatible snapshot must never silently corrupt the
    destination pool.  Retryable: the stream itself is fine, and a cold
    key-pinned replay (the pre-migration failover path) reproduces it
    token-identically on any replica."""

    retryable = True


class JournalOwned(RequestError):
    """A request journal's ownership claim was refused: another LIVE
    engine holds it (``owner.lock`` with an alive pid).  The
    double-resume guard — a journal offered to two engines is resumed
    by exactly one; the loser gets this typed refusal instead of a
    second copy of every stream.  Retryable in the fleet sense: offer
    the journal elsewhere, or wait for the holder to release it.  A
    *stale* lock (dead pid — the crash the journal exists for) never
    raises this; it is stolen atomically."""

    retryable = True


class DeterminismDiverged(RequestError):
    """A resume's committed-token buffer no longer matches the request's
    determinism digest (docs/observability.md, "Audit plane"): the
    stream was corrupted between commit and resume, and feeding it back
    to the model would silently poison the continuation.  NOT retryable
    — the engine latches ``serve.diverging`` and a human (or the
    incident-replay tooling) owns the next move; a blind retry cannot
    restore a broken determinism invariant."""


class OverloadDetector:
    """Admission-time overload signal: queue bound + TTFT estimate.

    ``max_queue`` bounds waiting requests outright.  ``max_ttft_s``
    bounds the *estimated* time a new arrival would wait for its
    prefill.  The unit of prefill work is the **chunk**, not the
    request: chunked prefill splits a long prompt's suffix into
    fixed-size chunks and the engine dispatches at most
    ``max_prefills_per_tick`` chunks per tick — so a queued 16k-token
    prompt costs ``ceil(suffix_chunks / max_prefills_per_tick)`` ticks,
    not 1, and the estimate is
    ``ceil((queued_chunks + 1) / max_prefills_per_tick) * ewma_tick_s``
    (the ``+1`` is the arriving request's own first chunk).  Callers
    that don't chunk (one prompt = one prefill) pass queue depth as the
    chunk count — the pre-chunking formula is the degenerate case.  The
    tick EWMA is seeded by the first observed tick and smoothed with
    factor ``alpha``; compile-heavy warm-up ticks inflate it briefly and
    decay out (the detector errs toward shedding while cold, which is
    the safe direction).  Both knobs ``None`` → never overloaded, the
    engine's default.
    """

    def __init__(
        self,
        max_queue: Optional[int] = None,
        max_ttft_s: Optional[float] = None,
        alpha: float = 0.2,
    ):
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if max_ttft_s is not None and max_ttft_s <= 0:
            raise ValueError("max_ttft_s must be > 0 (or None to disable)")
        self.max_queue = max_queue
        self.max_ttft_s = max_ttft_s
        self.alpha = alpha
        self._tick_ewma_s: Optional[float] = None

    def observe_tick(self, dur_s: float) -> None:
        """Feed one engine-tick duration into the EWMA."""
        if self._tick_ewma_s is None:
            self._tick_ewma_s = dur_s
        else:
            self._tick_ewma_s += self.alpha * (dur_s - self._tick_ewma_s)

    def est_ttft_s(
        self, queued_chunks: int, max_prefills_per_tick: int
    ) -> float:
        """Estimated wait-for-prefill of a request arriving now.

        ``queued_chunks`` is the total prefill work ahead of the arrival
        in CHUNKS (``Request.n_chunks`` summed over the queue plus any
        in-flight prefill's remainder) — an unchunked caller passes
        queue depth, one chunk per request."""
        if self._tick_ewma_s is None:
            return 0.0
        ticks = -(-(queued_chunks + 1) // max(1, max_prefills_per_tick))
        return ticks * self._tick_ewma_s

    def overloaded(
        self,
        queue_depth: int,
        max_prefills_per_tick: int,
        queued_chunks: Optional[int] = None,
    ) -> bool:
        """``max_queue`` bounds REQUESTS (depth); ``max_ttft_s`` bounds
        estimated prefill wait, which drains in CHUNKS — pass
        ``queued_chunks`` when they differ (chunked prefill), else depth
        doubles as the chunk count."""
        if self.max_queue is not None and queue_depth >= self.max_queue:
            return True
        if self.max_ttft_s is not None:
            chunks = queue_depth if queued_chunks is None else queued_chunks
            if self.est_ttft_s(chunks, max_prefills_per_tick) > self.max_ttft_s:
                return True
        return False

    @property
    def enabled(self) -> bool:
        return self.max_queue is not None or self.max_ttft_s is not None
