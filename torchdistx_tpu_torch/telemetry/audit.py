"""Audit plane, the digest part: determinism digests and the divergence
funnel.

Counterpart of the first half of ``torchdistx_tpu/telemetry/audit.py``
(``canonical_key``, ``DeterminismDigest``, ``first_divergence``,
``record_divergence``).  Every replay guarantee of the serving engine (the
recovery supervisor's replay, a resume) rests on one invariant: a replay
under the request's key schedule is token-identical to the uninterrupted
run.  :class:`DeterminismDigest` is a rolling blake2b over *(admitted
prompt, sampling key, model version, committed token ids)*, updated per
token (version bytes, then the token's little-endian bytes), so a digest
from chunked commits and one recomputed from a flat token list agree bit
for bit, and a greedy stream's hex digest equals the JAX engine's.

The shadow auditor (``ShadowAuditor``) is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import hashlib
from typing import Any, List

from . import _core as _telemetry

__all__ = [
    "DeterminismDigest",
    "canonical_key",
    "first_divergence",
    "record_divergence",
]

_T_DIVERGENCES = _telemetry.counter("audit.divergences")


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


def record_divergence(engine, **detail) -> None:
    """The one divergence funnel: bump ``audit.divergences``, latch the
    engine (``serve.diverging{engine=}``; it reads OVERLOADED), and
    flight-dump ``reason="divergence"`` with the caller's forensics."""
    _T_DIVERGENCES.add()
    mark = getattr(engine, "_mark_diverging", None)
    if mark is not None:
        mark()
    _telemetry.flight_dump("divergence", engine=getattr(engine, "engine_id", None), **detail)
