"""Crash-consistent request journal (WAL) + cold-restart resume.

Counterpart of ``torchdistx_tpu/serving/journal.py``, copied (pure host
code): the bytes on disk are the JAX package's format, so each package
reads the other's segments.

The serving stack already survives everything short of process death by
record-then-replay: ``fold_in(key, n_gen)`` sampling means a stream's
*identity* is just ``(prompt, normalized key, model version, committed
tokens)``, and every preempt/recovery/migration resume re-prefills that
identity token-identically under digest verification.  This module
makes the same identity survive ``kill -9``: an append-only **request
journal** records it durably as the engine runs, and
:meth:`Engine.resume_from_journal` re-admits every unfinished stream in
a fresh process through the existing replay machinery.

Record framing (torn-tail tolerant)
-----------------------------------

Every record is ``<u32 length> <u32 crc32(payload)> <payload>`` with a
compact-JSON payload.  A crash mid-append leaves a torn tail: a short
header, a short payload, or a checksum mismatch.  The reader treats all
three as end-of-segment — the truncated final record is *skipped*,
never misparsed — so recovery after power loss sees exactly the
prefix of records that were fully written.

Record types:

* ``config`` — the engine's sampling/chunk geometry, appended once per
  claim: a resume into a differently-configured engine would continue
  the stream with different tokens, so the mismatch must refuse loudly.
* ``admit``  — one request's replay identity (prompt ids, normalized
  key, model tag/version, tenant/priority, budget, wall-clock
  deadline), the same payload ``req.submitted`` carries.  A handoff
  admit (migration import, compaction checkpoint) additionally carries
  the committed tokens + digest snapshot.
* ``commit`` — one chunk boundary's newly committed tokens plus the
  rolling-digest snapshot after them.
* ``retire`` — terminal outcome (finished/failed/cancelled/expired/
  migrated); a retired uid is never resumed and compacts away.

Durability (``fsync=``)
-----------------------

* ``always`` — fsync after every append (each admission and chunk
  boundary is durable before the next device dispatch).
* ``tick``   — the default **group commit**: appends buffer in the OS;
  the engine calls :meth:`sync` once per tick, so one fsync covers the
  whole tick's records and the hot path never blocks per-record.
* ``async``  — never fsync explicitly; the OS flushes on its schedule.

An io failure at the ``journal.fsync`` fault site (or a real one)
**degrades the journal to async** and bumps ``journal.fsync_degraded``
— durability quietly weakens rather than the tick blocking or a
request failing on a disk hiccup.

Ownership (the double-resume guard)
-----------------------------------

A journal is resumed by exactly one engine: :meth:`claim` takes an
``owner.lock`` file (``O_CREAT | O_EXCL``) recording the claimant and
its pid.  A second live claimant gets a typed
:class:`.lifecycle.JournalOwned` refusal; a lock whose pid is dead is
stale (the crash this module exists for) and is stolen atomically.
Migration transfers ownership per-stream instead: the source journals
``retire(outcome="migrated")`` and the destination journals a handoff
admit into *its own* journal — a stream lives in exactly one journal.

Fault sites: ``journal.append`` (io fails one append — counted, the
request keeps running unjournaled), ``journal.fsync`` (degrades to
async, see above), ``journal.recover`` (io fails one recovery scan —
the caller sees the error, nothing is half-resumed).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from .. import telemetry as _telemetry
from ..resilience import faults
from .lifecycle import JournalOwned

__all__ = [
    "JournalEntry",
    "RequestJournal",
    "read_records",
    "read_segment",
]

_HEADER = struct.Struct("<II")
# A torn length field must not make the reader "wait" for gigabytes
# that were never written: anything above this is treated as a torn
# tail.  Generous — a 1M-token prompt is ~8 MB of JSON.
_MAX_RECORD = 64 << 20
_SEGMENT_FMT = "segment-%06d.wal"
_LOCK_NAME = "owner.lock"

_T_APPENDS = _telemetry.counter("journal.appends")
_T_BYTES = _telemetry.counter("journal.bytes")
_T_APPEND_ERRORS = _telemetry.counter("journal.append_errors")
_T_FSYNCS = _telemetry.counter("journal.fsyncs")
_T_FSYNC_DEGRADED = _telemetry.counter("journal.fsync_degraded")
_T_ROTATIONS = _telemetry.counter("journal.rotations")
_T_COMPACTED = _telemetry.counter("journal.compacted_entries")
_T_TORN = _telemetry.counter("journal.torn_tails")
_T_RECOVERED = _telemetry.counter("journal.recovered_streams")
_T_RESUMED = _telemetry.counter("journal.resumed")
_T_RESUME_EXPIRED = _telemetry.counter("journal.resume_expired")


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def _fsync_dir(path: str) -> None:
    """Durably record a directory entry (segment create/rename).  Best
    effort — not every platform allows fsync on a directory fd."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def read_segment(path: str) -> Tuple[List[dict], bool]:
    """Parse one segment; returns ``(records, torn)``.  A truncated or
    checksum-failing final record ends the scan cleanly (``torn=True``)
    — the records before it are exactly the durable prefix."""
    records: List[dict] = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    n = len(data)
    while off < n:
        if n - off < _HEADER.size:
            return records, True
        length, crc = _HEADER.unpack_from(data, off)
        if length > _MAX_RECORD or n - off - _HEADER.size < length:
            return records, True
        payload = data[off + _HEADER.size:off + _HEADER.size + length]
        if zlib.crc32(payload) != crc:
            return records, True
        try:
            rec = json.loads(payload)
        except ValueError:
            return records, True
        if isinstance(rec, dict):
            records.append(rec)
        off += _HEADER.size + length
    return records, False


def _segments(dirpath: str) -> List[str]:
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    segs = sorted(
        n for n in names if n.startswith("segment-") and n.endswith(".wal")
    )
    return [os.path.join(dirpath, n) for n in segs]


def read_records(dirpath: str) -> Iterator[dict]:
    """Every intact record across the journal's segments, in write
    order — the read-only scan recovery uses.  Torn tails are skipped (and counted) per segment."""
    for path in _segments(dirpath):
        records, torn = read_segment(path)
        if torn:
            _T_TORN.add()
        for rec in records:
            yield rec


@dataclass
class JournalEntry:
    """One request's journaled replay identity, folded over its
    admit/commit/retire records."""

    uid: int
    prompt: List[int] = field(default_factory=list)
    key: List[int] = field(default_factory=list)
    max_new_tokens: int = 0
    model_tag: str = "default"
    model_version: str = "v0"
    tenant: str = "default"
    priority: int = 0
    deadline_wall: Optional[float] = None
    trace_id: Optional[str] = None
    tokens: List[int] = field(default_factory=list)
    digest: Optional[str] = None
    retired: bool = False
    outcome: Optional[str] = None

    @property
    def n_gen(self) -> int:
        return len(self.tokens)


def fold_records(records) -> Tuple[Dict[int, JournalEntry], Optional[dict]]:
    """Fold a record stream into per-uid entries plus the LAST config
    record (a re-claimed journal appends one per claim; the newest
    engine geometry governs).  Order-tolerant: a retirement that lands
    one record before its chunk's trailing commit (a mid-chunk EOS)
    still folds to the full committed stream."""
    entries: Dict[int, JournalEntry] = {}
    config: Optional[dict] = None
    for rec in records:
        t = rec.get("t")
        if t == "config":
            config = rec
            continue
        uid = rec.get("u")
        if not isinstance(uid, int):
            continue
        if t == "admit":
            e = entries.setdefault(uid, JournalEntry(uid))
            e.prompt = [int(x) for x in rec.get("prompt", ())]
            e.key = [int(x) for x in rec.get("key", ())]
            e.max_new_tokens = int(rec.get("max_new", 0))
            e.model_tag = rec.get("model", "default")
            e.model_version = rec.get("version", "v0")
            e.tenant = rec.get("tenant", "default")
            e.priority = int(rec.get("priority", 0))
            e.deadline_wall = rec.get("deadline")
            e.trace_id = rec.get("trace")
            toks = rec.get("tokens")
            if toks:
                e.tokens = [int(x) for x in toks]
                e.digest = rec.get("d")
        elif t == "commit":
            e = entries.get(uid)
            if e is None:
                continue
            e.tokens.extend(int(x) for x in rec.get("toks", ()))
            e.digest = rec.get("d", e.digest)
        elif t == "retire":
            e = entries.get(uid)
            if e is None:
                continue
            e.retired = True
            e.outcome = rec.get("outcome")
            # The final uncommitted tail rides on the retire record
            # (retirement lands mid-chunk, before the trailing commit
            # would have run) — fold it so the entry holds the full
            # stream the client saw.
            e.tokens.extend(int(x) for x in rec.get("toks", ()))
            if rec.get("d"):
                e.digest = rec["d"]
    return entries, config


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM: alive, someone else's
    return True


class RequestJournal:
    """The crash-consistent request WAL one engine owns at a time.

    Construct it on a directory and pass it to ``Engine(journal=...)``;
    the engine claims ownership, appends a ``config`` record, and
    journals every admission, chunk commit, and retirement.  After a
    crash, construct a fresh engine on the same directory and call
    :meth:`Engine.resume_from_journal`."""

    def __init__(
        self,
        dirpath: str,
        *,
        fsync: str = "tick",
        rotate_bytes: int = 4 << 20,
    ):
        if fsync not in ("always", "tick", "async"):
            raise ValueError(
                f"fsync {fsync!r}: expected 'always', 'tick', or 'async'"
            )
        self.dir = str(dirpath)
        self.fsync = fsync
        self.degraded = False  # an io failure demoted fsync to 'async'
        self.rotate_bytes = int(rotate_bytes)
        if self.rotate_bytes < 4096:
            raise ValueError("rotate_bytes must be >= 4096")
        os.makedirs(self.dir, exist_ok=True)
        self._f = None  # active segment (open after claim)
        self._seg_no = 0
        self._dirty = False
        self._closed = False
        self._owner: Optional[str] = None
        # Live (unretired) entries, folded as we append: rotation
        # compacts the journal down to exactly these.
        self._live: Dict[int, JournalEntry] = {}
        self._config_rec: Optional[dict] = None
        self._next_uid = 1
        self._append_no = 0  # journal.append fault-site step
        self._fsync_no = 0  # journal.fsync fault-site step
        self._recover_no = 0  # journal.recover fault-site step
        self.n_segments_compacted = 0

    # -- ownership -----------------------------------------------------

    @property
    def _lock_path(self) -> str:
        return os.path.join(self.dir, _LOCK_NAME)

    def claim(self, owner: str) -> None:
        """Take exclusive ownership, or raise typed
        :class:`JournalOwned` if a LIVE claimant holds it.  A stale
        lock (dead pid — the crash this journal recovers from) is
        stolen atomically."""
        token = json.dumps({"owner": str(owner), "pid": os.getpid()})
        while True:
            try:
                fd = os.open(
                    self._lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY
                )
            except FileExistsError:
                holder = self._read_lock()
                if holder is not None and _pid_alive(holder.get("pid", -1)):
                    raise JournalOwned(
                        f"journal {self.dir!r} is owned by "
                        f"{holder.get('owner')!r} (pid {holder.get('pid')}, "
                        "alive); a stream is resumed by exactly one engine"
                    ) from None
                # Stale lock: steal by atomic replace so two stealers
                # cannot both think they won a torn write.
                tmp = self._lock_path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(token)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self._lock_path)
                break
            else:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    f.write(token)
                    f.flush()
                    os.fsync(f.fileno())
                break
        self._owner = str(owner)
        self._open_active_segment()

    def _read_lock(self) -> Optional[dict]:
        try:
            with open(self._lock_path, "r", encoding="utf-8") as f:
                data = json.loads(f.read())
            return data if isinstance(data, dict) else None
        except (OSError, ValueError):
            return None

    def release(self) -> None:
        """Drop ownership (close path).  Only the holder unlinks."""
        if self._owner is None:
            return
        holder = self._read_lock()
        if (
            holder is not None
            and holder.get("owner") == self._owner
            and holder.get("pid") == os.getpid()
        ):
            try:
                os.unlink(self._lock_path)
            except OSError:
                pass
        self._owner = None

    # -- the write path ------------------------------------------------

    def _seg_path(self, no: int) -> str:
        return os.path.join(self.dir, _SEGMENT_FMT % no)

    def _open_active_segment(self) -> None:
        segs = _segments(self.dir)
        if segs:
            last = os.path.basename(segs[-1])
            self._seg_no = int(last[len("segment-"):-len(".wal")])
            self._f = open(segs[-1], "ab")
        else:
            self._seg_no = 1
            # New segments are born durable: written under a tmp name,
            # fsynced, atomically renamed, directory entry fsynced —
            # a crash can leave a stray .tmp, never a torn segment.
            path = self._seg_path(self._seg_no)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(self.dir)
            self._f = open(path, "ab")

    def append(self, rec: dict) -> None:
        """Append one record (caller holds the claim).  Raises
        ``OSError`` on an io failure (injected or real) — the engine's
        wrappers count and carry on; durability is best-effort once the
        disk itself fails."""
        if self._closed or self._f is None:
            return
        self._append_no += 1
        faults.fire("journal.append", self._append_no)
        payload = json.dumps(rec, separators=(",", ":")).encode()
        framed = _frame(payload)
        self._f.write(framed)
        self._dirty = True
        _T_APPENDS.add()
        _T_BYTES.add(len(framed))
        self._fold_live(rec)
        if self.fsync == "always" and not self.degraded:
            self._do_fsync()
        if self._f.tell() >= self.rotate_bytes:
            self._rotate()

    def _fold_live(self, rec: dict) -> None:
        t = rec.get("t")
        uid = rec.get("u")
        if not isinstance(uid, int):
            return
        if t == "admit":
            entries, _ = fold_records((rec,))
            if uid in entries:
                self._live[uid] = entries[uid]
        elif t == "commit":
            live = self._live.get(uid)
            if live is not None:
                live.tokens.extend(int(x) for x in rec.get("toks", ()))
                live.digest = rec.get("d", live.digest)
        elif t == "retire":
            self._live.pop(uid, None)

    def committed_n(self, uid: int) -> int:
        """Committed-token count the WAL currently holds for ``uid`` —
        the retire path journals everything past this as the stream's
        final tail (retirement lands mid-chunk, before the chunk's
        trailing commit would have run)."""
        e = self._live.get(uid)
        return len(e.tokens) if e is not None else 0

    def _do_fsync(self) -> None:
        """One durability point.  An io failure — the ``journal.fsync``
        site or a real disk error — degrades the journal to async with
        a counter; it NEVER raises into the tick."""
        self._fsync_no += 1
        try:
            faults.fire("journal.fsync", self._fsync_no)
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError:
            self.degraded = True
            _T_FSYNC_DEGRADED.add()
            return
        self._dirty = False
        _T_FSYNCS.add()

    def sync(self) -> None:
        """The per-tick group commit (``fsync='tick'``): one fsync
        covers every record the tick appended.  No-op when clean,
        async, degraded, or closed."""
        if (
            self._closed
            or self._f is None
            or not self._dirty
            or self.degraded
            or self.fsync == "async"
        ):
            return
        self._do_fsync()

    def _rotate(self) -> None:
        """Seal the active segment and compact: the next segment opens
        with one checkpoint admit per LIVE entry (committed tokens +
        digest folded in), then every older segment unlinks — retired
        requests' records vanish.  The compacted segment is fully
        durable (tmp + fsync + rename) BEFORE anything is deleted."""
        old_segs = _segments(self.dir)
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        except OSError:
            pass
        self._f.close()
        self._seg_no += 1
        path = self._seg_path(self._seg_no)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            if self._config_rec is not None:
                f.write(_frame(json.dumps(
                    self._config_rec, separators=(",", ":")
                ).encode()))
            for uid in sorted(self._live):
                e = self._live[uid]
                rec = {
                    "t": "admit", "u": uid,
                    "prompt": e.prompt, "key": e.key,
                    "max_new": e.max_new_tokens,
                    "model": e.model_tag, "version": e.model_version,
                    "tenant": e.tenant, "priority": e.priority,
                    "deadline": e.deadline_wall, "trace": e.trace_id,
                }
                if e.tokens:
                    rec["tokens"] = e.tokens
                    rec["d"] = e.digest
                f.write(_frame(json.dumps(
                    rec, separators=(",", ":")
                ).encode()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.dir)
        self._f = open(path, "ab")
        self._dirty = False
        for seg in old_segs:
            try:
                os.unlink(seg)
            except OSError:
                pass
        _T_ROTATIONS.add()
        _T_COMPACTED.add(len(old_segs))
        self.n_segments_compacted += len(old_segs)

    def write_config(self, **attrs) -> None:
        """Append the claiming engine's geometry (sampling config,
        chunk sizes): resume refuses a mismatched engine loudly rather
        than continuing streams with different tokens."""
        self._config_rec = {"t": "config", **attrs}
        try:
            self.append(self._config_rec)
        except OSError:
            _T_APPEND_ERRORS.add()

    def peek_config(self) -> Optional[dict]:
        """The LAST config record on disk (read-only — safe before a
        claim): the geometry the journaled streams were committed
        under, which a resuming engine must match."""
        cfg = None
        for rec in read_records(self.dir):
            if rec.get("t") == "config":
                cfg = rec
        return cfg

    def next_uid(self) -> int:
        uid = self._next_uid
        self._next_uid += 1
        return uid

    # -- recovery ------------------------------------------------------

    def recover(self) -> Tuple[Dict[int, JournalEntry], Optional[dict]]:
        """Scan every segment and return ``(unfinished, config)`` —
        the entries a cold restart must resume, and the geometry record
        the claiming engine wrote.  Also primes the live map and the
        uid mint so this journal continues where the dead process
        stopped.  ``journal.recover`` io faults raise out of here:
        nothing is half-resumed."""
        self._recover_no += 1
        faults.fire("journal.recover", self._recover_no)
        sp = _telemetry.start_span("journal.recover", dir=self.dir)
        entries, config = fold_records(read_records(self.dir))
        unfinished = {
            uid: e for uid, e in entries.items() if not e.retired
        }
        self._live = {
            uid: JournalEntry(
                uid, list(e.prompt), list(e.key), e.max_new_tokens,
                e.model_tag, e.model_version, e.tenant, e.priority,
                e.deadline_wall, e.trace_id, list(e.tokens), e.digest,
            )
            for uid, e in unfinished.items()
        }
        if entries:
            self._next_uid = max(entries) + 1
        if config is not None:
            self._config_rec = config
        _T_RECOVERED.add(len(unfinished))
        sp.end(n_entries=len(entries), n_unfinished=len(unfinished))
        return unfinished, config

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Flush, fsync (best effort), release the claim.  Idempotent;
        the segments stay on disk — a closed journal is a complete,
        fully-retired record of the run."""
        if self._closed:
            return
        self._closed = True
        if self._f is not None:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except OSError:
                pass
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
        self.release()

    def stats(self) -> dict:
        return {
            "dir": self.dir,
            "fsync": self.fsync,
            "degraded": self.degraded,
            "live": len(self._live),
            "segments": len(_segments(self.dir)),
            "segments_compacted": self.n_segments_compacted,
            "next_uid": self._next_uid,
        }
