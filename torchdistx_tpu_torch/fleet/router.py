"""Health-aware multi-engine router with typed-error failover.

Counterpart of ``torchdistx_tpu/fleet/router.py``, with the same routing,
failover and migration rules.  One :class:`~torchdistx_tpu_torch.serving.engine.Engine` is a single point of
failure and a single admission queue.  :class:`FleetRouter` fronts N
engine replicas behind the same ``submit()/tokens()`` streaming API and
makes the typed-error taxonomy of :mod:`torchdistx_tpu_torch.serving.lifecycle`
*actionable*: a request that fails with ``retryable=True`` anywhere in
its life — shed by an overloaded replica, flushed by a drain, aborted by
a crashed/closed engine, beyond a recovery budget — is re-submitted to a
peer under a per-request **hop budget**, with
:class:`~torchdistx_tpu_torch.resilience.retry.RetryPolicy` backoff between
hops.  When no replica can take it, the failure is **typed**
(:class:`NoReplicaAvailable` / :class:`FailoverExhausted`) — never a
silent drop, never a hang.

**Routing policy** (least-estimated-TTFT): among replicas with open
admission, DRAINING/STOPPED are excluded outright, OVERLOADED replicas
are avoided (used only when nothing healthier exists — their shed is
retryable, so the failover path covers a wrong guess), and the rest are
ranked by ``(est_ttft_s, queued+running, replica id)`` — the per-engine
:meth:`~torchdistx_tpu_torch.serving.engine.Engine.est_ttft_s` hook, NOT the
process-global ``serve.est_ttft_s`` gauge, which N replicas in one
process would clobber.

**Failover token parity**: engine output is token-identical to solo
``generate()`` with the same key, so a replay on a peer reproduces the
stream from the start.  The fleet handle pins the request key at
submission, skips the already-yielded prefix of the replacement stream,
and the consumer's iterator continues mid-stream as if nothing
happened.  The prefix is verified against the handle's rolling
**determinism digest** (:class:`torchdistx_tpu_torch.telemetry.audit
.DeterminismDigest`): the replayed prefix re-hashes into one digest
and ONE compare at the skip point decides.  The serving engine's
``model_version`` folds into every token of the digest, so a
deliberately version-mixed replay is rejected even when the token ids
happen to agree; a plain token mismatch additionally short-circuits at
the first wrong token (the committed list ``result()`` retains anyway
doubles as an early exit, so a broken replay never decodes a long
prefix to its end).  Any mismatch fails typed as
:class:`FailoverDiverged`, never silently.  A stream that has already
yielded tokens is also version-pinned at routing time: it may only
fail over to a replica serving the SAME weights version, so tokens
from two model versions never interleave within one stream (see
:mod:`.hot_swap`).

**Replica supervision**: a crashed or :meth:`close`-d replica is
detected via its health state; :meth:`FleetRouter.poll` (called by every
:meth:`FleetRouter.step`) reaps STOPPED replicas.  Its queued and live
work was already failed with retryable typed errors by the engine's own
close/drain choreography, so each affected fleet handle re-routes itself
on its next pull.  A replacement can be respawned into the fleet with
:meth:`FleetRouter.add_replica` at any time.

**Stream migration & role disaggregation** (docs/fleet.md,
"Disaggregation & stream migration"): a live decoding stream can move
between same-version replicas WITHOUT recompute —
:meth:`FleetRouter.migrate_stream` drives the engine pair's
``migrate_out()``/``migrate_in()`` (pages gather to host, digest-verify
on arrival, scatter into the peer's pool; the same keyed sampling
schedule continues token-identically).  Graceful drains
(:meth:`FleetRouter.migrate_out_streams` — hot swap and autoscaler
scale-in call it) prefer migration over waiting streams out; a failed
import falls back to the cold key-pinned replay this module already
owns, counted on ``fleet.migration_fallbacks`` — cold replay also
remains the ONLY path when the source pool is gone (crash), since there
is nothing left to export.  Engines advertise a ``role``
(prefill/decode/mixed): routing steers long prompts to prefill-role
replicas, keeps short/chatty work off them, and
:meth:`FleetRouter.rebalance` (run by every :meth:`FleetRouter.step`)
ships decode-phase streams from prefill-role replicas to decode-role
peers mid-stream — the DistServe/vLLM-lineage prefill/decode split.

Telemetry: ``fleet.submitted`` / ``fleet.failovers`` /
``fleet.hops_exhausted`` / ``fleet.migrations`` /
``fleet.migration_fallbacks`` counters, the ``fleet.replicas_ready``
gauge, and the ``fleet.failover_added_s`` / ``fleet.migration_s``
histograms (docs/observability.md); the hot-swap machinery adds
``fleet.swaps`` and the ``fleet.swap`` span (:mod:`.hot_swap`).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .. import telemetry as _telemetry
from ..resilience.retry import RetryPolicy
from ..telemetry import audit as _audit
from ..telemetry import ops as _ops
from ..serving.lifecycle import (
    DeadlineExceeded,
    DeterminismDiverged,
    Health,
    JournalOwned,
    RecoveryFailed,
    RequestCancelled,
    RequestError,
    RequestPreempted,
)

__all__ = [
    "FailoverDiverged",
    "FailoverExhausted",
    "FleetHandle",
    "FleetRouter",
    "NoReplicaAvailable",
    "Replica",
]

_T_SUBMITTED = _telemetry.counter("fleet.submitted")
_T_FAILOVERS = _telemetry.counter("fleet.failovers")
_T_HOPS_EXHAUSTED = _telemetry.counter("fleet.hops_exhausted")
_G_REPLICAS_READY = _telemetry.gauge("fleet.replicas_ready")
# Wall-clock a failover adds to its stream: from catching the replica's
# typed failure to the successful re-submission on a peer (backoff
# sleeps included — they are part of what the consumer waits).
_H_FAILOVER_ADDED = _telemetry.histogram("fleet.failover_added_s")
# Warm stream migrations: completed page-level moves vs. imports that
# failed and fell back to the cold key-pinned replay.  The histogram is
# the full export→import wall clock — what a migrated stream's consumer
# waited, the number the bench compares against cold-replay added
# latency.
_T_MIGRATIONS = _telemetry.counter("fleet.migrations")
_T_MIGRATION_FALLBACKS = _telemetry.counter("fleet.migration_fallbacks")
_H_MIGRATION = _telemetry.histogram("fleet.migration_s")

# Migration destination preference by engine role: decode-role replicas
# exist to absorb mid-stream work, mixed take anything, prefill-role
# replicas are what migration is shipping work AWAY from (last resort).
_ROLE_DEST_ORDER = {"decode": 0, "mixed": 1, "prefill": 2}

# Fleet-wide trace-id mint ("fleet-r0", "fleet-r1", ...): ONE id pinned
# at fleet submission and forwarded on every failover hop, so every
# engine's spans/events for the request reconstruct into one timeline.
_TRACE_SEQ = itertools.count()

# Health states a replica may be routed to.  DRAINING/STOPPED are
# excluded outright; OVERLOADED is routable but avoided (last resort).
_ROUTABLE = (Health.STARTING, Health.READY, Health.OVERLOADED)
_PREFERRED = (Health.STARTING, Health.READY)


class NoReplicaAvailable(RequestError):
    """No replica can take the request: every candidate is draining,
    stopped, excluded by a failed hop, or (for a mid-stream failover)
    serves a different weights version.  Retryable — the fleet may heal
    (a respawn, a finished swap) and the identical request succeed."""

    retryable = True


class FailoverExhausted(RequestError):
    """The request burned through its per-request hop budget without
    completing; ``__cause__`` is the last underlying typed failure.
    Retryable at a higher level — the budget bounds THIS submission."""

    retryable = True


class FailoverDiverged(RequestError):
    """A failover replay's prefix did not match the tokens already
    yielded to the consumer — the token-parity invariant broke (wrong
    weights on a same-version peer, or a correctness bug).  NOT
    retryable: the stream cannot be continued without interleaving two
    different generations."""


@dataclasses.dataclass
class Replica:
    """One engine in the fleet (router-side bookkeeping)."""

    rid: int
    engine: Any
    version: str
    admitting: bool = True  # router-level admission gate (hot swap)

    def load(self) -> int:
        """Queued + running requests — the routing tiebreak."""
        eng = self.engine
        return len(eng.scheduler) + eng._n_running()


class FleetHandle:
    """Streaming view of one fleet request, across failovers.

    Mirrors :class:`~torchdistx_tpu_torch.serving.scheduler.RequestHandle`
    (``tokens()`` / ``result()`` / ``cancel()`` / ``done`` / ``error``)
    but survives the death of the engine serving it: a retryable typed
    failure re-binds the handle to a peer and the iterator continues
    where it left off.  ``done``/``error`` reflect what the *consumer*
    has observed — a handle is done once its stream was pulled to
    completion or failed terminally.
    """

    def __init__(
        self,
        router: "FleetRouter",
        prompt,
        max_new_tokens: int,
        key,
        deadline_s: Optional[float],
        max_hops: int,
        tenant: str = "default",
        priority: int = 0,
        model: Optional[str] = None,
        n: int = 1,
    ):
        self._router = router
        self._prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._max_new_tokens = int(max_new_tokens)
        self._key = key
        # QoS context: pinned at fleet submission and forwarded on
        # EVERY re-submission, so a preempted-then-failed-over stream
        # keeps its class, tenant share, and remaining deadline on the
        # peer (inert on FIFO-scheduled engines).
        self.tenant = str(tenant)
        self.priority = int(priority)
        # Model-plane context (docs/serving.md, "Model plane"): the
        # target pool model and the fork fan-out, pinned exactly like
        # tenant/priority and forwarded on EVERY re-submission.  This
        # handle streams sibling 0 (the parent); its key is
        # fold_key(base, 0) when n > 1 — deterministic on any replica,
        # so failover replay stays token-identical.  Siblings on a dead
        # replica die with it and are re-forked by the re-submission.
        self.model = model
        self.n = int(n)
        self._deadline = (
            time.perf_counter() + deadline_s if deadline_s is not None else None
        )
        self._max_hops = int(max_hops)
        self._committed: List[int] = []  # tokens yielded to the consumer
        self._inner = None  # current engine-side RequestHandle
        self._cancelled = False
        self._done = False
        self.error: Optional[BaseException] = None
        self.hops = 0  # re-submissions consumed (first binding is free)
        self.replica_id: Optional[int] = None
        self.version: Optional[str] = None
        # Trace context: minted at first bind (lazily — only once
        # something is recording) and forwarded on every hop.
        self.trace_id: Optional[str] = None
        # Determinism digest over the YIELDED stream (audit plane):
        # seeded lazily from the first bound engine's normalized key
        # (every engine normalizes identically, so any bind works),
        # updated per yielded token with the serving engine's
        # model_version.  Failover prefix verification compares ONE
        # digest instead of walking the committed list.
        self._digest = None
        self._model_version: str = "v0"

    @property
    def done(self) -> bool:
        return self._done

    @property
    def digest(self) -> Optional[str]:
        """Hex snapshot of the determinism digest over the tokens this
        handle has YIELDED (docs/observability.md, "Audit plane");
        None before the first token.  Equal to the serving engine's
        request digest for a stream that never failed over."""
        return None if self._digest is None else self._digest.hexdigest()

    def cancel(self) -> bool:
        """Request cancellation (forwarded to the bound engine).  A
        cancelled request never fails over — the resulting
        ``RequestCancelled`` is the client's own doing.  Returns False
        (no-op) once the stream already finished."""
        if self._done:
            return False
        self._cancelled = True
        if self._inner is not None:
            self._inner.cancel()
        return True

    # ------------------------------------------------------------------
    # Binding / failover

    def _fail(self, error: BaseException) -> None:
        if self._done:
            # Idempotent: a deadline that expires during placement is
            # failed by _remaining_deadline_s AND re-caught by the bind
            # loop — one terminal event, not two.
            return
        self.error = error
        self._done = True
        if self.trace_id is not None:
            _telemetry.event(
                "req.failed",
                rid=self.trace_id,
                engine="fleet",
                hop=self.hops,
                error=type(error).__name__,
                retryable=bool(getattr(error, "retryable", False)),
                n_tokens=len(self._committed),
            )
        if isinstance(error, (FailoverExhausted, FailoverDiverged,
                              NoReplicaAvailable)):
            # Fleet-terminal infrastructure failures are flight-recorder
            # moments: the ring holds the hops that led here.
            _telemetry.flight_dump(type(error).__name__, rid=self.trace_id)

    def _remaining_deadline_s(self) -> Optional[float]:
        if self._deadline is None:
            return None
        remaining = self._deadline - time.perf_counter()
        if remaining <= 0:
            err = DeadlineExceeded(
                "request deadline expired while re-routing "
                f"(after {self.hops} hop(s))"
            )
            self._fail(err)
            raise err
        return remaining

    def _bind(self, cause: Optional[BaseException] = None) -> None:
        """Pick a replica and submit there; synchronous typed-retryable
        rejections (shed, draining) try the next candidate.  Every
        re-submission — whether after a mid-stream failure (``cause``),
        a rejected hop, or a placement retry against a momentarily
        unroutable fleet — consumes the hop budget.  Raises typed
        (:class:`FailoverExhausted` / :class:`NoReplicaAvailable` /
        the non-retryable cause) when the request cannot be placed."""
        excluded = set() if self.replica_id is None else {self.replica_id}
        # A stream that already yielded tokens must finish on the SAME
        # weights version — never interleave two models in one stream.
        version = self.version if self._committed else None
        retry = self._router.retry
        t_fail = time.perf_counter() if cause is not None else None
        if self.trace_id is None and _telemetry.events_enabled():
            self.trace_id = f"fleet-r{next(_TRACE_SEQ)}"
        while True:
            if cause is not None:
                self.hops += 1
                if self.hops > self._max_hops:
                    _T_HOPS_EXHAUSTED.add()
                    err = FailoverExhausted(
                        f"hop budget ({self._max_hops}) exhausted; "
                        f"last failure: {cause!r}"
                    )
                    err.__cause__ = cause
                    self._fail(err)
                    raise err
                time.sleep(retry.delay(self.hops - 1))
                # A deadline can expire during the backoff sleeps of a
                # long placement wait — fail it as its own typed error,
                # not a generic NoReplicaAvailable at budget exhaustion.
                self._remaining_deadline_s()
            rep = self._router._pick(
                exclude=excluded, version=version,
                prompt_len=len(self._prompt),
            )
            if rep is None and excluded:
                # Every candidate was excluded by a failed attempt in
                # THIS binding.  Exclusion only means "not again without
                # backoff" — the backoff just slept, the replica may
                # have recovered (a shed queue drains, an overload
                # clears), and the hop budget still bounds the loop: so
                # stop shunning the pool and try it again rather than
                # failing a single-replica fleet on its first hiccup.
                excluded = set()
                rep = self._router._pick(
                    exclude=excluded, version=version,
                    prompt_len=len(self._prompt),
                )
            if rep is None:
                if self.hops < self._max_hops:
                    # A fleet with NO routable replica is routinely a
                    # momentary window, not a verdict: every replica
                    # draining mid-hot-swap, a killed engine reaped an
                    # instant before its respawn registers, a tiny fleet
                    # whose only peer is busy churning.  Chaos at small
                    # N hits these windows constantly.  Placement
                    # retries with backoff under the same hop budget —
                    # the loop head sleeps, re-checks the deadline, and
                    # re-picks — and only a fleet that STAYS unroutable
                    # for the whole budget fails typed below.
                    if cause is None:
                        cause = NoReplicaAvailable(
                            "no routable replica (momentary?); retrying "
                            f"placement (hop {self.hops + 1}/"
                            f"{self._max_hops})"
                        )
                    if t_fail is None:
                        # The binding's first obstacle was an unroutable
                        # fleet: the added-latency clock starts here.
                        t_fail = time.perf_counter()
                    continue
                err = NoReplicaAvailable(
                    "no replica can take the request"
                    + (f" (version-pinned to {version!r})" if version else "")
                    + f" after {self.hops} hop(s)"
                )
                if cause is not None and not isinstance(
                    cause, NoReplicaAvailable
                ):
                    err.__cause__ = cause
                self._fail(err)
                raise err
            try:
                self._inner = rep.engine.submit(
                    self._prompt,
                    max_new_tokens=self._max_new_tokens,
                    key=self._key,
                    deadline_s=self._remaining_deadline_s(),
                    tenant=self.tenant,
                    priority=self.priority,
                    model=self.model,
                    n=self.n,
                    trace_id=self.trace_id,
                    hop=self.hops,
                )
            except RequestError as err:
                if not retry.is_retryable(err):
                    self._fail(err)
                    raise
                excluded.add(rep.rid)
                cause = err
                if t_fail is None:
                    # The binding's FIRST failure was a synchronous
                    # rejection (not a mid-stream failure): the added-
                    # latency clock starts here.
                    t_fail = time.perf_counter()
                continue
            self.replica_id = rep.rid
            self.version = rep.version
            # The version folded into every digest token: the pool
            # entry's model_version for a pool model (the request
            # carries it), the engine's own otherwise.
            req = getattr(self._inner, "_req", None)
            self._model_version = (
                getattr(req, "model_version", None)
                or getattr(rep.engine, "model_version", "v0")
            )
            if self._digest is None:
                # Seed from the engine-normalized key so the fleet's
                # digest and the engine's request digests hash the same
                # bytes for the same submit(key=...) — including the
                # fold_key(base, 0) sibling-0 key when n > 1.
                self._digest = _audit.DeterminismDigest(
                    self._prompt,
                    req.key if req is not None
                    else _audit.canonical_key(self._key),
                )
            if cause is not None:
                _T_FAILOVERS.add()
                added = time.perf_counter() - t_fail
                _H_FAILOVER_ADDED.observe(added)
                if self.trace_id is not None:
                    _telemetry.event(
                        "req.failover_hop",
                        rid=self.trace_id,
                        engine=getattr(rep.engine, "engine_id", None),
                        hop=self.hops,
                        cause=type(cause).__name__,
                        added_s=round(added, 6),
                        n_tokens=len(self._committed),
                    )
            return

    # ------------------------------------------------------------------
    # Streaming

    def tokens(self) -> Iterator[int]:
        """Yield tokens as they are produced, driving the bound engine —
        and re-binding to a peer when it fails retryably.  The replay on
        the peer is token-identical (same key, same keyed
        sampling schedule), so the already-yielded prefix is verified and
        skipped; the iterator continues mid-stream.  Raises the
        request's typed error when it fails terminally."""
        while True:
            if self._done:
                if self.error is not None:
                    raise self.error
                return
            inner = self._inner
            inner_err = getattr(inner, "error", None)
            if (
                inner_err is not None
                and not self._cancelled
                and self._router.retry.is_retryable(inner_err)
            ):
                # The bound engine already failed this request before we
                # consumed its stream (killed mid-load, closed, drained)
                # — tokens it BUFFERED but never yielded to the consumer
                # are discarded, not drained: consuming them would
                # version-pin the stream to a replica set that may
                # already be gone (the small-N kill-then-hot-swap chaos
                # failure), while the replay is token-identical from the
                # pinned key anyway.  Tokens already yielded in earlier
                # pulls stay committed and are prefix-verified below.
                self._bind(cause=inner_err)
                continue
            n_skip = len(self._committed)
            # Digest-based prefix verification (audit plane): the
            # replayed prefix re-hashes into a fresh digest and ONE
            # compare at the skip point decides — the digest, not the
            # token list, is the verification contract, and because
            # model_version folds into every token a same-router-tag
            # peer serving differently-tagged weights is rejected even
            # when the token ids match.  The per-token compare against
            # _committed (which result() retains anyway) is an early
            # exit: a token mismatch cancels the replay at the first
            # wrong token — with its exact index — instead of decoding
            # the rest of a long prefix on a broken stream.
            verify = None
            if n_skip:
                req = getattr(inner, "_req", None)
                verify = _audit.DeterminismDigest(
                    self._prompt,
                    req.key if req is not None
                    else _audit.canonical_key(self._key),
                )
            i = 0
            try:
                for tok in inner.tokens():
                    i += 1
                    if i <= n_skip:
                        if tok != self._committed[i - 1]:
                            inner.cancel()
                            err = FailoverDiverged(
                                f"failover replay diverged at token {i}: "
                                f"replayed {tok}, committed "
                                f"{self._committed[i - 1]} (replica "
                                f"{self.replica_id}, version {self.version})"
                            )
                            self._fail(err)
                            raise err
                        verify.update((tok,), self._model_version)
                        if (
                            i == n_skip
                            and verify.hexdigest() != self._digest.hexdigest()
                        ):
                            inner.cancel()
                            err = FailoverDiverged(
                                "failover replay prefix matches token-wise "
                                "but its determinism digest does not — a "
                                "version-mixed stream: digest "
                                f"{verify.hexdigest()} != committed "
                                f"{self._digest.hexdigest()} (replica "
                                f"{self.replica_id}, version {self.version}, "
                                f"model_version {self._model_version})"
                            )
                            self._fail(err)
                            raise err
                        continue
                    self._digest.update((tok,), self._model_version)
                    self._committed.append(tok)
                    yield tok
                if i < n_skip:
                    # The replay finished SHORTER than the prefix already
                    # yielded (early EOS under different weights): as
                    # much a parity break as a mismatched token — a
                    # "clean" completion here would silently truncate.
                    err = FailoverDiverged(
                        f"failover replay ended after {i} token(s), "
                        f"shorter than the {n_skip} already yielded "
                        f"(replica {self.replica_id}, version "
                        f"{self.version})"
                    )
                    self._fail(err)
                    raise err
                self._done = True
                return
            except RequestError as err:
                if err is self.error:
                    raise  # our own terminal error (diverged / deadline)
                if self._cancelled:
                    # The client's cancel may race a drain/close on the
                    # bound engine: whichever typed error the engine
                    # reported, the stream ended because the CLIENT
                    # cancelled — surface that, and never fail over.
                    if not isinstance(err, RequestCancelled):
                        cancelled = RequestCancelled(
                            "request cancelled by the client (engine "
                            f"reported {type(err).__name__})"
                        )
                        cancelled.__cause__ = err
                        err = cancelled
                    self._fail(err)
                    raise err
                if not self._router.retry.is_retryable(err):
                    self._fail(err)
                    raise
                self._bind(cause=err)  # raises typed when impossible

    def result(self) -> List[int]:
        """Block (by streaming) until done; returns all tokens — across
        however many replicas it took."""
        for _ in self.tokens():
            pass
        return list(self._committed)


class FleetRouter:
    """Front N engine replicas with one streaming submit/tokens API.

    Parameters
    ----------
    engines : initial replicas, all registered under ``version``.
    version : weights-version tag of the initial replicas (hot swaps
        introduce new tags; mid-stream failover is version-pinned).
    max_hops : per-request re-submission budget (failovers + rejected
        placement attempts); exhaustion fails typed, never silently.
    retry : :class:`~torchdistx_tpu_torch.resilience.retry.RetryPolicy` whose
        ``is_retryable`` classifies failures (honoring the
        ``RequestError.retryable`` contract) and whose ``delay``
        schedule paces the hops.  Default: 5 ms base, 250 ms cap.
    long_prompt_tokens : prompt length (tokens) at which routing
        prefers a ``role="prefill"`` replica; shorter prompts prefer
        decode/mixed-role replicas.  Role preference is advisory — a
        role-less fleet routes exactly as before, and a role never
        makes a request unroutable (the non-preferred pool is the
        fallback).  Default 2048.
    ops_port : opt the whole fleet into the live ops plane
        (:mod:`torchdistx_tpu_torch.telemetry.ops`): the router get-or-creates
        the plane on the port and ``retain()``-s it so it outlives
        replica churn — every replica (current and future) is watched
        (``/healthz`` entry + stall watchdog + per-tick attribution),
        reaped/removed replicas unwatch, and :meth:`close` releases the
        retain, tearing the listener down once the last engine is gone.
        ``0`` binds an ephemeral port (read it back from
        ``router.ops_plane.port``).  Default: ``TDX_OPS_PORT`` when
        set, else off.
    ops_config : :class:`torchdistx_tpu_torch.telemetry.ops.OpsConfig`,
        applied when this router CREATES the plane; joiners share as-is.

    Single-threaded like the engines it fronts: handles drive their
    bound engine; :meth:`step` advances every live replica (and reaps
    stopped ones) for drain/idle progress.
    """

    def __init__(
        self,
        engines=(),
        *,
        version: str = "v0",
        max_hops: int = 3,
        retry: Optional[RetryPolicy] = None,
        long_prompt_tokens: int = 2048,
        ops_port: Optional[int] = None,
        ops_config: Optional[_ops.OpsConfig] = None,
    ):
        if max_hops < 0:
            raise ValueError("max_hops must be >= 0")
        if long_prompt_tokens < 1:
            raise ValueError("long_prompt_tokens must be >= 1")
        self.max_hops = max_hops
        self.long_prompt_tokens = int(long_prompt_tokens)
        self.retry = retry or RetryPolicy(
            max_attempts=max_hops + 1, base_delay_s=0.005, max_delay_s=0.25
        )
        self._replicas: Dict[int, Replica] = {}
        self._next_rid = 0
        self._next_key = 0
        # Supervision hooks (add_reap_listener): notified per replica
        # reaped by poll() — an autoscaler's control tick runs poll()
        # so STOPPED replicas leave the fleet (and their gauge families
        # leave the registry) without user code ever polling by hand.
        self._reap_listeners: List = []
        self.ops_plane: Optional[_ops.OpsPlane] = None
        if ops_port is None:
            ops_port = _ops.env_ops_port()
        if ops_port is not None:
            # Retained: the plane survives windows where every replica
            # is momentarily gone (kill + respawn, hot swap) — a scrape
            # mid-churn sees 503, not connection-refused.
            self.ops_plane = _ops.get_plane(
                int(ops_port), ops_config
            ).retain()
        for eng in engines:
            self.add_replica(eng, version=version)

    # ------------------------------------------------------------------
    # Fleet membership

    def add_replica(self, engine, *, version: str = "v0") -> int:
        """Register an engine (a fresh spawn, a respawn, or a hot-swap
        standby); returns its replica id."""
        rid = self._next_rid
        self._next_rid += 1
        self._replicas[rid] = Replica(rid, engine, version)
        if self.ops_plane is not None and not self.ops_plane.closed:
            self.ops_plane.watch(engine)
        self._update_ready_gauge()
        return rid

    def remove_replica(self, rid: int, *, close: bool = True) -> None:
        """Drop a replica from the fleet; by default also ``close()`` its
        engine (idempotent — a drained/crashed engine is already
        STOPPED, and close() fails any straggling work retryably so the
        affected handles re-route)."""
        rep = self._replicas.pop(rid, None)
        if rep is not None and close:
            rep.engine.close()
        if rep is not None and self.ops_plane is not None:
            # close()/STOPPED already unwatched via _finish_drain; this
            # covers the close=False reap of an engine that died without
            # running its own teardown.  Idempotent.
            self.ops_plane.unwatch(rep.engine)
        self._update_ready_gauge()

    def close_admission(self, rid: int) -> None:
        """Stop routing NEW work to a replica (hot swap: admission
        shifts to the standby before the old engine drains).  In-flight
        and queued work on the replica is untouched."""
        self._replicas[rid].admitting = False
        self._update_ready_gauge()

    def replicas(self) -> List[Replica]:
        """Snapshot of the fleet membership (routing order)."""
        return [self._replicas[rid] for rid in sorted(self._replicas)]

    def add_reap_listener(self, fn) -> None:
        """Register ``fn(rid, engine)``, called by :meth:`poll` for each
        replica it reaps — the router's supervision hook.  An attached
        :class:`~torchdistx_tpu_torch.fleet.autoscale.Autoscaler` calls
        ``poll()`` every control tick, so with one running, STOPPED
        replicas are reaped (and their per-engine gauge families pruned)
        with no manual ``poll()`` from user code."""
        if fn not in self._reap_listeners:
            self._reap_listeners.append(fn)

    def remove_reap_listener(self, fn) -> None:
        try:
            self._reap_listeners.remove(fn)
        except ValueError:
            pass

    def poll(self) -> List[int]:
        """Reap replicas whose engine reached STOPPED (crashed, closed,
        or drained out).  Their queued/live work already failed with
        retryable typed errors, so the affected handles re-route on
        their next pull.  Returns the reaped replica ids."""
        dead = [
            rid
            for rid, rep in self._replicas.items()
            if rep.engine.health() is Health.STOPPED
        ]
        reaped = [(rid, self._replicas[rid].engine) for rid in dead]
        for rid in dead:
            self.remove_replica(rid, close=False)
        for rid, eng in reaped:
            for fn in list(self._reap_listeners):
                try:
                    fn(rid, eng)
                except Exception:  # noqa: BLE001 — supervision never kills routing
                    pass
        return dead

    def close(self) -> None:
        """Retire the whole fleet NOW: every replica engine is closed
        (outstanding work fails retryable-typed) and dropped; the ops
        plane's retain is released, so a router-created plane with no
        other engines shuts its listener down."""
        for rid in list(self._replicas):
            self.remove_replica(rid, close=True)
        if self.ops_plane is not None:
            self.ops_plane.release()
            self.ops_plane = None

    # ------------------------------------------------------------------
    # Routing

    def _pick(
        self,
        exclude=frozenset(),
        version: Optional[str] = None,
        prompt_len: Optional[int] = None,
    ) -> Optional[Replica]:
        """Least-estimated-TTFT among routable replicas.  READY (and
        STARTING) replicas are preferred; OVERLOADED ones serve only as
        a last resort; DRAINING/STOPPED never route.  With
        ``prompt_len``, role steering applies within the health-
        preferred pool (see :meth:`_role_pool`)."""
        candidates = [
            rep
            for rep in self._replicas.values()
            if rep.admitting
            and rep.rid not in exclude
            and (version is None or rep.version == version)
            and rep.engine.health() in _ROUTABLE
        ]
        self._update_ready_gauge()
        if not candidates:
            return None
        preferred = [
            rep for rep in candidates if rep.engine.health() in _PREFERRED
        ]
        pool = self._role_pool(preferred or candidates, prompt_len)
        return min(
            pool, key=lambda r: (r.engine.est_ttft_s(), r.load(), r.rid)
        )

    def _role_pool(
        self, pool: List[Replica], prompt_len: Optional[int]
    ) -> List[Replica]:
        """Prefill/decode disaggregation steering (docs/fleet.md): long
        prompts (``>= long_prompt_tokens``) prefer prefill-role
        replicas — their pages ship to a decode-role peer mid-stream
        via :meth:`rebalance` — while short/chatty work stays OFF
        prefill-role replicas so a 16k-token prefill never sits in
        front of its decode chunks.  Advisory only: a role-less pool
        passes through untouched, and when no replica of the preferred
        role is routable the whole pool is the fallback."""
        if prompt_len is None:
            return pool
        roles = {getattr(r.engine, "role", "mixed") for r in pool}
        if roles <= {"mixed"}:
            return pool
        if prompt_len >= self.long_prompt_tokens:
            pref = [
                r for r in pool
                if getattr(r.engine, "role", "mixed") == "prefill"
            ]
        else:
            pref = [
                r for r in pool
                if getattr(r.engine, "role", "mixed") != "prefill"
            ]
        return pref or pool

    def _update_ready_gauge(self) -> None:
        _G_REPLICAS_READY.set(
            sum(
                rep.admitting and rep.engine.health() in _PREFERRED
                for rep in self._replicas.values()
            )
        )

    # ------------------------------------------------------------------
    # Stream migration (docs/fleet.md, "Disaggregation & stream
    # migration"): move live decoding streams between replicas at the
    # KV-page level — zero recompute, digest-verified on arrival.

    def _migration_dests(self, src_rid: int, version: str) -> List[Replica]:
        """Candidate import targets for a stream leaving ``src_rid``:
        same weights version (a migrated stream must never interleave
        two models — the same pin as mid-stream failover), routable,
        still admitting, ordered decode-role first, then mixed, then
        (last resort) prefill, with least-loaded tiebreak."""
        candidates = [
            rep
            for rep in self._replicas.values()
            if rep.rid != src_rid
            and rep.admitting
            and rep.version == version
            and rep.engine.health() in _ROUTABLE
        ]
        return sorted(
            candidates,
            key=lambda r: (
                _ROLE_DEST_ORDER.get(getattr(r.engine, "role", "mixed"), 1),
                0 if r.engine.health() in _PREFERRED else 1,
                r.engine.est_ttft_s(),
                r.load(),
                r.rid,
            ),
        )

    def migrate_stream(self, rid: int, slot: int) -> bool:
        """Warm-migrate ONE live stream off replica ``rid``'s engine
        slot to the best same-version peer.  Returns True when the
        stream continues on the peer (the consumer's handle keeps
        streaming, token-identically, with zero recomputed tokens).

        Returns False and leaves the stream UNTOUCHED on the source
        when there is no compatible destination, the stream's deadline
        already expired (the source engine's own reap surfaces
        ``DeadlineExceeded`` — exactly once), or the export itself
        declines (injected fault, pool lost): a failed export must
        never strand a running stream.  When the export succeeded but
        every candidate refuses the import (geometry/version mismatch,
        overload, injected import fault), the source slot is already
        gone — the engine-side handle is failed with a retryable
        ``RequestPreempted`` so the :class:`FleetHandle` falls back to
        the cold key-pinned replay on its next pull, counted on
        ``fleet.migration_fallbacks``.  A ``DeterminismDiverged`` on
        arrival is terminal (the engine already failed the handle
        typed): a corrupt stream is never replayed.

        The fleet handle's ``replica_id`` is a routing hint, not a
        liveness contract — it goes stale across a migration and is
        refreshed by the next (re-)bind, which excludes it anyway."""
        rep = self._replicas.get(rid)
        if rep is None:
            return False
        eng = rep.engine
        req = eng._slot_req[slot] if slot < len(eng._slot_req) else None
        if req is None:
            return False
        if req.deadline is not None and time.perf_counter() >= req.deadline:
            return False
        dests = self._migration_dests(rid, rep.version)
        if not dests:
            return False
        t0 = time.perf_counter()
        try:
            snapshot = eng.migrate_out(slot)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:  # noqa: BLE001 — export declined; stream untouched
            return False
        last_err: Optional[BaseException] = None
        for dest in dests:
            try:
                dest.engine.migrate_in(snapshot)
            except (KeyboardInterrupt, SystemExit):
                raise
            except DeterminismDiverged:
                # migrate_in already failed the handle typed and
                # flight-dumped; there is nothing to fall back to.
                return False
            except Exception as err:  # noqa: BLE001 — try the next candidate
                last_err = err
                continue
            _T_MIGRATIONS.add()
            _H_MIGRATION.observe(time.perf_counter() - t0)
            return True
        # Export succeeded but no candidate would take the import: the
        # page snapshot is dropped and the stream falls back to the
        # cold replay path — the FleetHandle catches the retryable
        # preemption on its next pull and replays from the pinned key.
        _T_MIGRATION_FALLBACKS.add()
        if req.trace_id is not None:
            _telemetry.event(
                "req.migration_fallback",
                rid=req.trace_id,
                engine=getattr(eng, "engine_id", None),
                error=type(last_err).__name__ if last_err else None,
                n_tokens=int(snapshot.get("n_tokens", 0)),
            )
        req.handle._fail(
            RequestPreempted(
                "stream migration failed mid-import ("
                + (
                    f"{type(last_err).__name__}: {last_err}"
                    if last_err is not None
                    else "no importable destination"
                )
                + "); falling back to a key-pinned replay",
                resumable=False,
            )
        )
        return False

    def migrate_out_streams(self, rid: int) -> Dict[str, int]:
        """Drain-by-migration: warm-migrate every migratable stream off
        replica ``rid`` (graceful drains — hot swap and autoscaler
        scale-in — call this BEFORE ``begin_drain()``, so in-flight
        streams finish on peers with zero recomputed prefill tokens
        instead of holding the drain open).  Streams with no compatible
        destination are left running for the normal drain to finish —
        skipping is strictly better than failing them.  Returns
        ``{"migrated", "fallbacks", "left"}`` counts."""
        out = {"migrated": 0, "fallbacks": 0, "left": 0}
        rep = self._replicas.get(rid)
        if rep is None:
            return out
        slots = getattr(rep.engine, "migratable_slots", None)
        if slots is None:
            # An engine without the migration API (a stub, an older
            # build) drains the normal way — nothing to move warm.
            return out
        before = _T_MIGRATION_FALLBACKS.value
        for slot in list(slots()):
            if self.migrate_stream(rid, slot):
                out["migrated"] += 1
        out["fallbacks"] = _T_MIGRATION_FALLBACKS.value - before
        out["left"] = rep.engine._n_running()
        return out

    def rebalance(self) -> int:
        """The prefill→decode handoff: ship decode-phase streams OFF
        prefill-role replicas onto decode/mixed-role same-version peers
        mid-stream.  Run by every :meth:`step`; a no-op in a role-less
        fleet.  Returns the number of streams moved.

        Capacity-gated: the handoff is an *optimization*, and an export
        whose import is then refused can only fall back to a cold
        replay — so a stream is shipped only while some candidate has a
        free slot to land it.  A saturated decode tier just means the
        prefill replica keeps decoding the stream itself."""
        moved = 0
        for rep in self.replicas():
            if getattr(rep.engine, "role", "mixed") != "prefill":
                continue
            if rep.engine.health() not in _ROUTABLE:
                continue
            for slot in list(rep.engine.migratable_slots()):
                if not any(
                    d.engine._n_running() < d.engine.num_slots
                    for d in self._migration_dests(rep.rid, rep.version)
                ):
                    break
                if self.migrate_stream(rep.rid, slot):
                    moved += 1
        return moved

    # ------------------------------------------------------------------
    # Cold-restart recovery (docs/resilience.md, "Durability")

    def recover(self, journal, *, version: Optional[str] = None) -> dict:
        """Fleet-level cold-restart resume: offer a dead process's
        request journal to the routable replicas (least-loaded first,
        optionally ``version``-pinned — a resumed stream must continue
        under the weights version it committed its tokens with) and
        resume every unfinished stream on the first replica that can
        take the claim.

        Exactly-once by construction: the winning replica holds the
        journal's ownership lock, so a second ``recover()`` call — or a
        peer router racing this one — gets the loser's typed
        :class:`~torchdistx_tpu_torch.serving.lifecycle.JournalOwned` instead
        of a duplicate of every stream.  A replica whose geometry
        cannot continue the streams token-identically (config
        mismatch) is skipped for the next candidate; if no replica
        qualifies, a typed retryable ``RecoveryFailed`` surfaces the
        last refusal.

        Returns ``(replica_id, {journal uid: RequestHandle})``."""
        candidates = [
            rep
            for rep in self.replicas()
            if rep.admitting
            and (version is None or rep.version == version)
            and rep.engine.health() in _ROUTABLE
        ]
        candidates.sort(key=lambda r: (r.load(), r.rid))
        last_refusal: Optional[BaseException] = None
        for rep in candidates:
            try:
                handles = rep.engine.resume_from_journal(journal)
            except JournalOwned:
                # The double-resume guard: someone live already owns
                # these streams — surface it, do not shop it around.
                raise
            except ValueError as err:
                # Geometry mismatch (or an engine already bound to a
                # different journal): this replica cannot continue the
                # streams token-identically; the next one may.
                last_refusal = err
                continue
            return rep.rid, handles
        raise RecoveryFailed(
            "no routable replica could resume the journal"
            + (f" (last refusal: {last_refusal})" if last_refusal else "")
        )

    # ------------------------------------------------------------------
    # The fleet API

    def submit(
        self,
        prompt,
        *,
        max_new_tokens: int,
        key: Any = None,
        deadline_s: Optional[float] = None,
        max_hops: Optional[int] = None,
        tenant: str = "default",
        priority: int = 0,
        model: Optional[str] = None,
        n: int = 1,
    ) -> FleetHandle:
        """Route a request to the best replica; returns its streaming
        :class:`FleetHandle`.

        ``key`` is pinned HERE (defaulting to a fleet-wide counter, not
        any engine's request id) so every failover replay of the request
        samples identically on any replica.  ``deadline_s`` is a fleet-
        level wall-clock budget: each hop re-submits with the remaining
        time.  ``tenant`` / ``priority`` are the request's QoS context
        (see :mod:`torchdistx_tpu_torch.serving.qos`), pinned on the handle
        and forwarded with every re-submission — a stream preempted on
        one replica and failed over to another keeps its class and its
        tenant's fair-queueing share.  ``model`` / ``n`` are the
        model-plane context (docs/serving.md, "Model plane"): the pool
        model to serve from and the parallel-sampling fan-out, pinned
        on the handle and forwarded on every re-submission exactly like
        tenant/priority — the handle streams the fork parent (sibling
        0), whose ``fold_key(base, 0)`` key replays identically on any
        peer.  Raises
        :class:`NoReplicaAvailable` (typed, retryable) when no replica
        can take it, and plain ``ValueError`` for requests that could
        never run anywhere (engine validation)."""
        if key is None:
            key = self._next_key
            self._next_key += 1
        handle = FleetHandle(
            self,
            prompt,
            max_new_tokens,
            key,
            deadline_s,
            self.max_hops if max_hops is None else max_hops,
            tenant=tenant,
            priority=priority,
            model=model,
            n=n,
        )
        if _telemetry.events_enabled():
            # The fleet-level submission opens the request's timeline —
            # even one that expires or fails before any engine accepts
            # it reconstructs complete (engine-side re-submissions emit
            # their own hop-scoped req.submitted as they land).
            handle.trace_id = f"fleet-r{next(_TRACE_SEQ)}"
            _telemetry.event(
                "req.submitted",
                rid=handle.trace_id,
                engine="fleet",
                hop=0,
                n_prompt=len(handle._prompt),
                max_new=int(max_new_tokens),
                tenant=handle.tenant,
                priority=handle.priority,
                model=handle.model,
                n=handle.n,
                deadline_s=deadline_s,
            )
        _T_SUBMITTED.add()
        try:
            handle._bind()
        except DeadlineExceeded as err:
            # The deadline expired before the request could even be
            # placed (the engine analog: expiring in queue).  The
            # handle carries the typed error; the pull raises it —
            # submit() itself only raises for requests that could
            # never run (ValueError) or a fleet that cannot take them.
            if err is not handle.error:
                raise
        return handle

    def step(self) -> None:
        """Advance every live replica one tick and reap stopped ones.
        Handles drive their own engine while streaming; step() exists
        for drain progress and idle upkeep (a draining replica with no
        consumer pulling it still has to finish its in-flight work)."""
        for rep in self.replicas():
            if rep.engine.health() is not Health.STOPPED:
                rep.engine.step()
        self.rebalance()
        self.poll()

    def stats(self) -> dict:
        """Fleet-level introspection: per-replica health/load plus the
        failover counters."""
        return {
            "replicas": [
                {
                    "rid": rep.rid,
                    "version": rep.version,
                    "admitting": rep.admitting,
                    "health": rep.engine.health().value,
                    "role": getattr(rep.engine, "role", "mixed"),
                    "est_ttft_s": round(rep.engine.est_ttft_s(), 4),
                    "load": rep.load(),
                }
                for rep in self.replicas()
            ],
            "submitted": _T_SUBMITTED.value,
            "failovers": _T_FAILOVERS.value,
            "hops_exhausted": _T_HOPS_EXHAUSTED.value,
            "migrations": _T_MIGRATIONS.value,
            "migration_fallbacks": _T_MIGRATION_FALLBACKS.value,
        }
