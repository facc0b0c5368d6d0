"""Audit plane: determinism digests, shadow auditing, divergence latching.

Counterpart of ``torchdistx_tpu/telemetry/audit.py``.  Every replay
guarantee of the serving engine (the recovery supervisor's replay, a
resume, fleet failover, hot swap) rests on one invariant: a replay under
the request's key schedule is token-identical to the uninterrupted run.

* :class:`DeterminismDigest` is a rolling blake2b over *(admitted prompt,
  sampling key, model version, committed token ids)*, updated per token
  (version bytes, then the token's little-endian bytes), so a digest from
  chunked commits and one recomputed from a flat token list agree bit for
  bit, and a greedy stream's hex digest equals the JAX engine's.
* :class:`ShadowAuditor` (``Engine(audit_sample=p)`` /
  ``TDX_AUDIT_SAMPLE``) re-executes a sampled fraction of completed
  requests through the engine's own ``submit`` path at the lowest QoS
  class, only on ticks where no user work waits, and compares digests
  exactly.  A mismatch bumps ``audit.divergences`` and latches the engine
  (``serve.diverging{engine=}``; it reads OVERLOADED until
  ``clear_divergence``).  Sampling is deterministic off the digest's
  leading 32 bits, so the port audits the requests JAX audits.
* :func:`record_divergence` is the one funnel every divergence goes
  through: counter, latch, flight dump.

Metrics: ``audit.checked``, ``audit.divergences``, ``audit.dropped``,
``audit.aborted``.
"""

from __future__ import annotations

import hashlib
import os
from collections import deque
from typing import Any, Dict, List, Optional

from . import _core as _telemetry

__all__ = [
    "AUDIT_PRIORITY",
    "DeterminismDigest",
    "ShadowAuditor",
    "canonical_key",
    "env_audit_sample",
    "first_divergence",
    "record_divergence",
    "token_chunk",
]

# The shadow auditor's QoS class: strictly below any sane user priority, so
# an audit replay never preempts (or outqueues) real work on a QoS engine.
AUDIT_PRIORITY = -(2**30)

_T_CHECKED = _telemetry.counter("audit.checked")
_T_DIVERGENCES = _telemetry.counter("audit.divergences")
_T_DROPPED = _telemetry.counter("audit.dropped")
_T_ABORTED = _telemetry.counter("audit.aborted")


def env_audit_sample() -> Optional[float]:
    """``TDX_AUDIT_SAMPLE`` as a float in [0, 1], or None when unset.  A
    malformed value raises: a mistyped rate silently auditing nothing would
    defeat the plane."""
    text = os.environ.get("TDX_AUDIT_SAMPLE", "")
    if not text:
        return None
    try:
        value = float(text)
    except ValueError:
        raise ValueError(f"TDX_AUDIT_SAMPLE={text!r}: expected a float in [0, 1]") from None
    if not 0.0 <= value <= 1.0:
        raise ValueError(f"TDX_AUDIT_SAMPLE={value}: expected a fraction in [0, 1]")
    return value


def canonical_key(key: Any):
    """The engine's key normalization: ``(2,) uint32`` words.  An int seed
    gives the words of ``jax.random.PRNGKey(seed)`` in JAX's default 32-bit
    mode, ``[0, seed mod 2**32]``, computed without JAX; anything
    array-like (a tensor included) is read as the two raw words."""
    import numpy as np

    if isinstance(key, (int, np.integer)):
        return np.asarray([0, int(key) & 0xFFFFFFFF], dtype=np.uint32)
    if hasattr(key, "detach"):
        key = key.detach().cpu().numpy()
    return np.asarray(key).astype(np.uint32).reshape(2)


def _prompt_bytes(prompt) -> bytes:
    import numpy as np

    return np.ascontiguousarray(prompt, dtype="<i4").tobytes()


def _key_bytes(key) -> bytes:
    import numpy as np

    return np.ascontiguousarray(key, dtype="<u4").tobytes()


class DeterminismDigest:
    """Rolling blake2b over one request's deterministic identity.

    Seeded with the admitted prompt's token bytes and the normalized
    sampling key; updated per committed token with the engine's
    ``model_version`` bytes followed by the token id.  Chunk-size
    invariant, O(1) state, and snapshot-able at any point (``hexdigest``
    copies the hash state)."""

    __slots__ = ("_h", "n")

    def __init__(self, prompt, key):
        h = hashlib.blake2b(digest_size=16)
        h.update(_prompt_bytes(prompt))
        h.update(_key_bytes(key))
        self._h = h
        self.n = 0  # committed tokens folded in so far

    def update(self, tokens, version: str = "v0") -> None:
        """Fold committed token ids in."""
        v = str(version).encode()
        h = self._h
        for tok in tokens:
            h.update(v)
            h.update(int(tok).to_bytes(8, "little", signed=True))
            self.n += 1

    def hexdigest(self) -> str:
        """Snapshot of the digest so far (the stream keeps rolling)."""
        return self._h.copy().hexdigest()

    @classmethod
    def of_stream(cls, prompt, key, tokens, version: str = "v0") -> "DeterminismDigest":
        """The digest a single-engine stream of ``tokens`` would carry."""
        d = cls(prompt, key)
        d.update(tokens, version)
        return d

    def matches_stream(self, prompt, key, tokens, version: str = "v0") -> bool:
        """O(1)-memory check that this digest covers exactly ``tokens``
        (the resume check: re-hash the committed buffer, compare one
        digest)."""
        return self.of_stream(prompt, key, tokens, version).hexdigest() == self.hexdigest()


def first_divergence(expected: List[int], got: List[int]) -> int:
    """Index of the first differing token between two streams (the shorter
    stream's end when one is a strict prefix of the other)."""
    n = min(len(expected), len(got))
    for i in range(n):
        if int(expected[i]) != int(got[i]):
            return i
    return n


def token_chunk(index: int, decode_chunk: int) -> int:
    """The chunk that committed a request's token ``index``: token 0 is the
    prefill's first sample (chunk 0); decode chunk ``j`` (1-based) commits
    tokens ``1 + (j-1)*decode_chunk .. j*decode_chunk``."""
    if index <= 0:
        return 0
    return 1 + (index - 1) // max(1, int(decode_chunk))


def record_divergence(engine, **detail) -> None:
    """The one divergence funnel: bump ``audit.divergences``, latch the
    engine (``serve.diverging{engine=}``; it reads OVERLOADED), and
    flight-dump ``reason="divergence"`` with the caller's forensics."""
    _T_DIVERGENCES.add()
    mark = getattr(engine, "_mark_diverging", None)
    if mark is not None:
        mark()
    _telemetry.flight_dump("divergence", engine=getattr(engine, "engine_id", None), **detail)


class _AuditRecord:
    """One completed request's identity, queued for shadow re-execution."""

    __slots__ = ("trace_id", "rid", "prompt", "key", "max_new", "digest", "tokens",
                 "model_tag", "prefill_start", "reprefilled")

    def __init__(self, req, engine_id: str):
        self.trace_id = req.trace_id or f"{engine_id}-r{req.rid}"
        self.rid = req.rid
        self.prompt = req.prompt
        self.key = req.key
        self.max_new = req.max_new_tokens
        self.digest = req.digest.hexdigest()
        self.tokens = list(req.handle._tokens)
        # A replay must run the same weights: the model version folds into
        # every digest token, so a wrong-model replay reads as a divergence.
        self.model_tag = getattr(req, "model_tag", "default")
        # The prefill schedule the replay repeats: where the original's
        # prefill started, and whether its committed tokens were ever
        # re-prefilled (a schedule one submit cannot repeat).
        self.prefill_start = getattr(req, "prefill_start", None)
        self.reprefilled = bool(getattr(req, "reprefilled", False))


class ShadowAuditor:
    """Re-execute a sampled fraction of completed requests and compare
    determinism digests.

    Owned by one engine.  ``on_finished`` (every retirement) enqueues a
    sampled user request, or settles an audit replay by comparing digests
    and routing a mismatch through :func:`record_divergence`.  ``pump``
    (once a tick, before admission) submits at most one pending audit, and
    only while the engine's queue is empty: shadow traffic never delays,
    sheds or preempts user work.  A replay goes through the ordinary
    ``submit`` path (same chunked prefill, same decode graph, same prefix
    cache), so auditing captures no new graph.  It replays in the
    original's prefill schedule: its prefix match stops where the original's
    prefill started, so every prefill chunk and bucket is the original's,
    and a bf16 replay runs the original's GEMM shapes.  Where that cannot
    hold (the index lost the original's pages, a fork sibling's one-token
    re-run off a partial page, committed tokens re-prefilled by a replay
    preemption or a recovery), the audit still runs; it counts in
    ``schedule_unmatched`` and a divergence's detail says
    ``schedule_matched: False``.

    The pending queue is bounded (``max_pending``): under saturation the
    oldest un-started audits drop (``audit.dropped``).  Replays killed by a
    drain, close or shed fail typed like any request and count as
    ``audit.aborted``, never as divergences."""

    def __init__(self, engine, sample: float, *, priority: int = AUDIT_PRIORITY,
                 max_pending: int = 32):
        sample = float(sample)
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"audit_sample {sample}: expected a fraction in [0, 1]")
        self.engine = engine
        self.sample = sample
        self.priority = int(priority)
        self.max_pending = int(max_pending)
        self._pending: deque = deque()
        self._inflight: Dict[int, tuple] = {}  # audit rid -> (record, handle)
        self.checked = 0
        self.divergences = 0
        self.dropped = 0
        self.aborted = 0
        self.schedule_unmatched = 0
        self.divergence_detail: List[Dict[str, Any]] = []

    # -- engine hooks -------------------------------------------------------

    def backlog(self) -> int:
        """Audits not yet submitted (in-flight ones sit in the engine's own
        queue and slots)."""
        return len(self._pending)

    def on_finished(self, req) -> None:
        """Every retirement lands here: enqueue sampled user requests,
        settle audit replays."""
        if req.audit_of is not None:
            self._compare(req)
            return
        if self.sample <= 0.0 or req.digest is None:
            return
        if not self._sampled(req):
            return
        if len(self._pending) >= self.max_pending:
            self._pending.popleft()
            self.dropped += 1
            _T_DROPPED.add()
        self._pending.append(_AuditRecord(req, self.engine.engine_id))

    def pump(self) -> None:
        """One tick of audit progress: reap failed replays, then submit at
        most one pending audit if the engine is quiet."""
        if self._inflight:
            self._reap_failed()
        if not self._pending:
            return
        eng = self.engine
        if eng.health().value not in ("starting", "ready", "overloaded"):
            self._pending.clear()  # draining or stopped: these never run
            return
        if len(eng.scheduler):
            return  # user work waiting: shadow traffic yields
        rec = self._pending[0]
        try:
            handle = eng.submit(
                rec.prompt, max_new_tokens=rec.max_new, key=rec.key, tenant="_audit",
                priority=self.priority,
                model=None if rec.model_tag == "default" else rec.model_tag,
                _audit_of=rec.trace_id, _prefill_start=rec.prefill_start)
        except Exception:  # noqa: BLE001 — overloaded/draining: retry later
            return
        self._pending.popleft()
        self._inflight[handle.rid] = (rec, handle)

    # -- internals ----------------------------------------------------------

    def _sampled(self, req) -> bool:
        if self.sample >= 1.0:
            return True
        # Deterministic per request: the digest's leading 32 bits as a
        # uniform draw, so a replayed trace audits the same requests.
        draw = int(req.digest.hexdigest()[:8], 16) / float(0xFFFFFFFF)
        return draw < self.sample

    def _reap_failed(self) -> None:
        for rid in [rid for rid, (_, handle) in self._inflight.items()
                    if handle.done and handle.error is not None]:
            self._inflight.pop(rid)
            self.aborted += 1
            _T_ABORTED.add()

    def _compare(self, req) -> None:
        entry = self._inflight.pop(req.rid, None)
        if entry is None:
            return
        rec, _ = entry
        self.checked += 1
        _T_CHECKED.add()
        matched = (not rec.reprefilled and not getattr(req, "reprefilled", False)
                   and getattr(req, "prefill_start", None) == rec.prefill_start)
        if not matched:
            self.schedule_unmatched += 1
        got = req.digest.hexdigest()
        if got == rec.digest:
            return
        self.divergences += 1
        replayed = list(req.handle._tokens)
        idx = first_divergence(rec.tokens, replayed)
        detail = {
            "rid": rec.trace_id,
            "audit_rid": req.trace_id,
            "expected_digest": rec.digest,
            "replayed_digest": got,
            "expected_tokens": rec.tokens,
            "replayed_tokens": replayed,
            "first_diverging_token": idx,
            "first_diverging_chunk": token_chunk(idx, getattr(self.engine, "decode_chunk", 1)),
            "schedule_matched": matched,
            "prefill_start": rec.prefill_start,
            "replay_prefill_start": getattr(req, "prefill_start", None),
        }
        self.divergence_detail.append(detail)
        record_divergence(self.engine, **detail)
