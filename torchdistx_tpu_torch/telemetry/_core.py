"""Telemetry core: spans, counters, gauges, and sinks.

Counterpart of ``torchdistx_tpu/telemetry/_core.py``, with the same names,
registries, record schema and semantics.  Dependency-free by design (stdlib
only at module level): modules bind counters at import time, so this module
must be importable before torch and must cost nothing when disabled.

Five primitives:

* :func:`span` / :func:`start_span` — nested, thread-aware timed regions.
  A span *always* measures (two ``perf_counter`` calls, so a caller can
  read its duration with telemetry off) but only
  *records* when a sink is active: no record dict, no string formatting,
  no JSON when disabled.  ``detached=True`` keeps a long-lived span off
  the thread's nesting stack (it times and records, but never becomes
  another span's parent — the serving engine's drain span, which stays
  open across arbitrary work, uses this).
* :func:`counter` / :func:`gauge` — named registries of monotonic counts
  and last-value gauges.  Counters always accumulate (they are the
  process-introspection layer);
  each carries its own lock so concurrent materialization build pools and
  multi-threaded recorders count exactly.
* :func:`histogram` — fixed-bucket latency/size distributions: exact
  counts per bucket under one cheap lock, exact count/sum/min/max, and
  p50/p95/p99 readback interpolated within a bucket.  Like counters,
  histograms always accumulate (``Engine.stats()`` reads its percentiles
  from them) — no per-observation allocation, sink or no sink.
* :func:`event` — request-scoped lifecycle points (``req.submitted``,
  ``req.first_token``, ``req.failed`` ...) carrying the trace context
  ``rid``/``engine``/``hop``.  Zero cost when no sink and no flight
  recorder is active: the function returns before building any record.
* sinks — the in-memory collector (bounded deque, queryable via
  :func:`snapshot`/:func:`drain`), a JSON-lines exporter
  (``TDX_TELEMETRY=/path/trace.jsonl`` or ``configure(jsonl=...)``),
  optional ``torch.profiler`` annotation pass-through
  (``TDX_TELEMETRY_PROFILER=1`` or ``configure(profiler_annotations=True)``)
  so spans appear as ``record_function`` ranges in ``torch.profiler``
  traces, and
  the **flight recorder** — a bounded ring of recent span/event records
  kept even when no sink is active, dumped to JSONL by
  :func:`flight_dump` when a failure fires, so a post-mortem doesn't
  depend on having had full tracing enabled.

Metric *labels*: ``counter``/``gauge``/``histogram`` accept keyword
labels (``gauge("serve.health", engine="eng0")``) that canonicalize into
the registry name as ``serve.health{engine=eng0}`` — how N fleet
replicas in one process keep per-engine readings without clobbering the
process-global gauge.

Environment (read once, at first telemetry use; :func:`configure` wins):

* ``TDX_TELEMETRY=/path/trace.jsonl`` — enable the JSONL exporter AND the
  in-memory collector.
* ``TDX_TELEMETRY_PROFILER=1`` — wrap spans in
  ``torch.profiler.record_function`` (a span's ``step`` attribute goes into
  the range's ``args``).  This takes the place of the JAX package's
  ``TDX_TELEMETRY_JAX`` (``jax.profiler`` annotations).  Off, it costs one
  attribute read per span.
* ``TDX_FLIGHT_RECORDER=1`` — keep the flight-recorder ring, dumping into
  the main JSONL sink; ``=/path/flight.jsonl`` dumps to a dedicated file
  (and needs no ``TDX_TELEMETRY``).
* ``TDX_FLIGHT_CAPACITY=N`` — ring size in records (default 512).
* ``TDX_NO_TELEMETRY=1`` — kill switch: no sink activates regardless of
  the above.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from bisect import bisect_left
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "Histogram",
    "Span",
    "add_listener",
    "on_reset",
    "configure",
    "counter",
    "counters",
    "drain",
    "emit_counters",
    "enabled",
    "event",
    "events_enabled",
    "flight_dump",
    "flight_records",
    "gauge",
    "gauges",
    "histogram",
    "histograms",
    "registry_view",
    "remove",
    "remove_listener",
    "reset",
    "snapshot",
    "span",
    "start_span",
    "tracing",
]

_logger = logging.getLogger(__name__)

_REG_LOCK = threading.Lock()
_tls = threading.local()

_DEFAULT_MAX_SPANS = 4096


class Counter:
    """Monotonic named count.  ``add`` is thread-exact (own lock) and, when
    no sink is ever read, costs one lock round-trip + an int add."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def __repr__(self):
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-value named gauge (floats or ints)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value: Any = None

    def set(self, value) -> None:
        self._value = value

    @property
    def value(self):
        return self._value

    def __repr__(self):
        return f"Gauge({self.name}={self._value})"


# Default bucket edges for latency histograms: 8 per decade, 100 µs to
# 100 s (50 buckets with the overflow).  Resolution is ~33% anywhere in
# the range — tight enough that a p99 readback is actionable, small
# enough that observe() is one bisect over a 49-tuple.
_LATENCY_BOUNDS = tuple(10.0 ** (-4 + i / 8.0) for i in range(49))


class Histogram:
    """Fixed-bucket distribution with exact counts and percentile readback.

    ``bounds`` are the bucket upper edges (strictly increasing); an
    observation lands in the first bucket whose edge is >= the value,
    values beyond the last edge in the overflow bucket.  ``observe`` is
    lock-cheap — one bisect over a tuple, then one lock round-trip for
    the count/sum/min/max updates — and allocates nothing, so it can sit
    on the serving hot path with every sink disabled (it is the
    always-on stats layer, like :class:`Counter`).

    Percentiles interpolate linearly inside the winning bucket and clamp
    to the exact observed min/max, so a readback is never outside the
    data; resolution is the bucket width (default ~33%).
    """

    __slots__ = (
        "name", "bounds", "_counts", "_count", "_sum", "_min", "_max",
        "_lock",
    )

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds = tuple(float(b) for b in (bounds or _LATENCY_BOUNDS))
        if any(
            b2 <= b1 for b1, b2 in zip(self.bounds, self.bounds[1:])
        ) or not self.bounds:
            raise ValueError("histogram bounds must be strictly increasing")
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value`` (``n`` times — one aggregated observation per
        decode chunk is how per-token time is fed without n calls)."""
        i = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += n
            self._count += n
            self._sum += value * n
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> Optional[float]:
        """The p-th percentile (0..100), or None while empty."""
        with self._lock:
            total = self._count
            if total == 0:
                return None
            counts = list(self._counts)
            lo_obs, hi_obs = self._min, self._max
        target = max(1.0, p / 100.0 * total)
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else min(lo_obs, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else hi_obs
                frac = (target - cum) / c
                v = lo + (hi - lo) * frac
                return min(max(v, lo_obs), hi_obs)
            cum += c
        return hi_obs  # pragma: no cover — unreachable (cum == total)

    def bucket_counts(self) -> tuple:
        """One consistent snapshot for exposition: ``(bounds, cumulative
        bucket counts, total count, sum)`` taken under the histogram's
        lock, so a concurrent ``observe`` can never tear the invariant
        the Prometheus format promises (the ``+Inf`` cumulative count
        equals ``_count``)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            s = self._sum
        cum = []
        running = 0
        for c in counts:
            running += c
            cum.append(running)
        return self.bounds, cum, total, s

    def summary(self) -> Dict[str, Any]:
        """``{count, sum, min, max, p50, p95, p99}`` (empty → count 0)."""
        if self._count == 0:
            return {"count": 0}
        return {
            "count": self._count,
            "sum": round(self._sum, 6),
            "min": self._min,
            "max": self._max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    def _zero(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def __repr__(self):
        return f"Histogram({self.name}, n={self._count})"


def _label_escape(v: Any) -> str:
    """Escape a label VALUE for the canonical registry name.  Label
    values are free-form (per-user tenant ids reach ``gauge(...,
    tenant=...)``), so the structural characters of the ``name{k=v,...}``
    encoding must not collide with them — a tenant ``"a,b"`` must not
    parse back as two labels.  Percent-encodes exactly the structural
    set; ordinary values round-trip unchanged."""
    return (
        str(v)
        .replace("%", "%25")
        .replace(",", "%2C")
        .replace("=", "%3D")
        .replace("{", "%7B")
        .replace("}", "%7D")
    )


def _label_unescape(v: str) -> str:
    """Inverse of :func:`_label_escape` (exporters split first, then
    unescape each value)."""
    return (
        v
        .replace("%7D", "}")
        .replace("%7B", "{")
        .replace("%3D", "=")
        .replace("%2C", ",")
        .replace("%25", "%")
    )


def _labeled(name: str, labels: Dict[str, Any]) -> str:
    """Canonical registry name for a labeled metric:
    ``name{k1=v1,k2=v2}`` with keys sorted (values escaped via
    :func:`_label_escape`) — the same (name, labels) always resolves to
    the same instrument."""
    if not labels:
        return name
    inner = ",".join(
        f"{k}={_label_escape(labels[k])}" for k in sorted(labels)
    )
    return f"{name}{{{inner}}}"


class _State:
    """Process-wide telemetry configuration + sinks (lazily env-seeded)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.collect = False
        self.jsonl_path: Optional[str] = None
        self.profiler_annotations = False
        self.max_spans = _DEFAULT_MAX_SPANS
        self.spans: deque = deque(maxlen=_DEFAULT_MAX_SPANS)
        self.jsonl_file = None
        self.jsonl_lock = threading.Lock()
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        # Flight recorder: a bounded ring of recent records, kept even
        # with every sink off, dumped on demand (flight_dump).  None =
        # disabled.  flight_path None = dump into the main JSONL sink.
        self.flight: Optional[deque] = None
        self.flight_path: Optional[str] = None
        self.flight_capacity = 512
        # In-process record listeners (the ops plane's SLO monitor):
        # each gets every record as it is emitted.  A registered
        # listener counts as a recording target — events must be built
        # for it even with every sink and the flight ring off.
        self.listeners: List[Any] = []

    # -- configuration ------------------------------------------------------

    def ensure_init(self) -> None:
        if self.initialized:
            return
        with self.lock:
            if self.initialized:
                return
            self.initialized = True
            if os.environ.get("TDX_NO_TELEMETRY"):
                return
            path = os.environ.get("TDX_TELEMETRY")
            if path:
                self.jsonl_path = path
                self.collect = True
            if os.environ.get("TDX_TELEMETRY_PROFILER"):
                self.profiler_annotations = True
            try:
                self.flight_capacity = int(
                    os.environ.get("TDX_FLIGHT_CAPACITY", self.flight_capacity)
                )
            except ValueError:
                pass
            flight = os.environ.get("TDX_FLIGHT_RECORDER", "")
            if flight and flight != "0":
                self.flight = deque(maxlen=self.flight_capacity)
                self.flight_path = None if flight == "1" else flight

    def jsonl_handle(self):
        """Lazily opened append-mode handle; a failed open disables the
        sink (telemetry must never fail the instrumented operation)."""
        if self.jsonl_path is None:
            return None
        if self.jsonl_file is None:
            with self.jsonl_lock:
                if self.jsonl_file is None and self.jsonl_path is not None:
                    try:
                        self.jsonl_file = open(  # noqa: SIM115 — held open
                            self.jsonl_path, "a", encoding="utf-8"
                        )
                    except OSError as e:
                        _logger.warning(
                            "telemetry: cannot open %s (%s); JSONL sink "
                            "disabled", self.jsonl_path, e,
                        )
                        self.jsonl_path = None
                        return None
        return self.jsonl_file

    def close_jsonl(self) -> None:
        with self.jsonl_lock:
            if self.jsonl_file is not None:
                try:
                    self.jsonl_file.close()
                except OSError:
                    pass
                self.jsonl_file = None

    # -- emission -----------------------------------------------------------

    def active(self) -> bool:
        return self.collect or self.jsonl_path is not None

    def recording(self) -> bool:
        """A record built now would land somewhere: a sink, the
        flight-recorder ring (which keeps collecting with every sink
        off — that is its whole point), or an in-process listener."""
        return (
            self.collect
            or self.jsonl_path is not None
            or self.flight is not None
            or bool(self.listeners)
        )

    def record(self, rec: Dict[str, Any]) -> None:
        if self.flight is not None:
            # Ring entries remember whether a main sink exported the
            # record as it happened: a dump into the main sink must
            # backfill the records captured while no sink was active
            # rather than assume the whole window already landed.
            self.flight.append((self.active(), rec))
        if self.collect:
            self.spans.append(rec)
        self.write_jsonl(rec)
        for fn in list(self.listeners):
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — telemetry never fails the op
                _logger.warning(
                    "telemetry: record listener %r raised", fn, exc_info=True
                )

    def write_jsonl(self, rec: Dict[str, Any]) -> None:
        f = self.jsonl_handle()
        if f is None:
            return
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError):
            line = json.dumps({k: str(v) for k, v in rec.items()})
        with self.jsonl_lock:
            try:
                f.write(line + "\n")
                f.flush()
            except (OSError, ValueError):
                # Closed/full file: drop the sink, keep the program.
                self.jsonl_path = None


_state = _State()


def _span_stack() -> List["Span"]:
    stack = getattr(_tls, "spans", None)
    if stack is None:
        stack = _tls.spans = []
    return stack


class Span:
    """One timed region.  Use as a context manager (``with span(...)``) or
    via :func:`start_span` + :meth:`end` when the region doesn't nest as a
    ``with`` block.

    ``end`` is idempotent — the first call fixes the duration; later calls
    return it unchanged.  The thread-local nesting stack is popped by
    identity and tolerates imbalance (an exception that skips an ``end``
    cannot corrupt later spans' parentage).

    **Thread ownership**: the nesting stack belongs to the thread that
    *started* the span, and only that thread ever mutates it — a span
    ended on another thread (an engine's drain span finalized by a
    reaper, a handle pulled from a worker) records normally but leaves
    the owner's stack alone; the owner prunes finished spans off its
    stack top at its next ``start``.  Two threads can therefore never
    race one list, and depth/parent accounting stays exact under
    concurrent load.

    ``detached=True`` keeps a long-lived span off the stack entirely: it
    times and records but never parents another span — for regions that
    stay open across arbitrary foreign work (the serving engine's drain
    span).
    """

    __slots__ = (
        "name", "attrs", "t0", "ts", "duration", "parent", "depth",
        "detached", "ctx", "_annotation", "_recorded", "_stack",
    )

    def __init__(
        self,
        name: str,
        attrs: Optional[Dict[str, Any]] = None,
        detached: bool = False,
    ):
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.ts = 0.0
        self.duration: Optional[float] = None
        self.parent: Optional[str] = None
        self.depth = 0
        self.detached = detached
        self.ctx: Optional[Dict[str, Any]] = None
        self._annotation = None
        self._recorded = False
        self._stack: Optional[List["Span"]] = None

    def start(self) -> "Span":
        self.ctx = _current_ctx()
        if not self.detached:
            stack = _span_stack()
            # Spans ended on ANOTHER thread could not pop this stack
            # (only the owner mutates it); they are finished, so they
            # must not become parents — prune them off the top now.
            while stack and stack[-1].duration is not None:
                stack.pop()
            if len(stack) > 128:
                # Safety valve: spans abandoned by exceptions (an
                # instrumented operation that raised between start and
                # end) accumulate here; genuine nesting never goes this
                # deep.  Reset rather than let parent attribution degrade
                # without bound.
                for sp in stack:
                    sp._close_annotation()
                stack.clear()
            if stack:
                self.parent = stack[-1].name
                self.depth = len(stack)
            stack.append(self)
            self._stack = stack
        if _state.profiler_annotations:
            self._enter_annotation()
        self.ts = time.time()
        self.t0 = time.perf_counter()
        return self

    def end(self, **attrs) -> float:
        if self.duration is None:
            self.duration = time.perf_counter() - self.t0
        if attrs:
            self.attrs = {**(self.attrs or {}), **attrs}
        stack = getattr(_tls, "spans", None)
        if stack is not None and stack is self._stack and self in stack:
            # We are on the OWNING thread (its stack is this span's
            # stack): identity pop, tolerating spans above us abandoned
            # by exceptions — but their profiler annotations must still
            # exit (innermost first, before ours) or the thread's TraceMe
            # stack goes permanently unbalanced.  On any other thread the
            # stack is left alone — the owner prunes us (duration is now
            # set) at its next start().
            while stack:
                top = stack.pop()
                if top is self:
                    break
                top._close_annotation()
        self._close_annotation()
        if not self._recorded and _state.recording():
            self._recorded = True
            rec = {
                "type": "span",
                "name": self.name,
                "ts": self.ts,
                "dur_s": self.duration,
                "thread": threading.get_ident(),
                "depth": self.depth,
            }
            if self.parent is not None:
                rec["parent"] = self.parent
            if self.ctx:
                rec.update(self.ctx)
            if self.attrs:
                rec["attrs"] = self.attrs
            _state.record(rec)
        return self.duration

    def cancel(self) -> None:
        """Close the span without recording it (a phase that turned out
        not to apply).  Timing state is finalized; sinks see nothing."""
        self._recorded = True
        self.end()

    def _close_annotation(self) -> None:
        if self._annotation is not None:
            try:
                self._annotation.__exit__(None, None, None)
            except Exception:  # noqa: BLE001 — profiler teardown best-effort
                pass
            self._annotation = None

    def _enter_annotation(self) -> None:
        # torch.profiler pass-through: spans show up as record_function
        # ranges in profiler traces.  A `step` attribute rides in the
        # range's args (torch has no step-level annotation).
        try:
            from torch.profiler import record_function

            attrs = self.attrs or {}
            args = str(attrs["step"]) if "step" in attrs else None
            self._annotation = record_function(self.name, args)
            self._annotation.__enter__()
        except Exception:  # noqa: BLE001 — profiler trouble: spans still time
            self._annotation = None

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


# ---------------------------------------------------------------------------
# Public API


def configure(
    *,
    jsonl: Optional[str] = "__unset__",
    collect: Optional[bool] = None,
    profiler_annotations: Optional[bool] = None,
    max_spans: Optional[int] = None,
    flight: Any = "__unset__",
    flight_capacity: Optional[int] = None,
) -> Dict[str, Any]:
    """Set telemetry sinks programmatically (overrides the env defaults).

    ``profiler_annotations`` turns the ``torch.profiler`` pass-through on or
    off (the JAX package's ``jax_annotations``).

    ``flight``: ``False``/``None`` disables the flight recorder, ``True``
    keeps the ring and dumps into the main JSONL sink, a path string
    dumps to that dedicated file.  ``flight_capacity`` resizes the ring
    (recent records kept).

    Returns the PREVIOUS settings as a kwargs dict, so a caller (tests,
    a bench scope) can restore them: ``prev = configure(collect=True)``
    ... ``configure(**prev)``.
    """
    _state.ensure_init()
    with _state.lock:
        prev = {
            "jsonl": _state.jsonl_path,
            "collect": _state.collect,
            "profiler_annotations": _state.profiler_annotations,
            "max_spans": _state.max_spans,
            "flight": (
                (_state.flight_path or True)
                if _state.flight is not None
                else None
            ),
            "flight_capacity": _state.flight_capacity,
        }
        if jsonl != "__unset__":
            if jsonl != _state.jsonl_path:
                _state.close_jsonl()
            _state.jsonl_path = jsonl
        if collect is not None:
            _state.collect = collect
        if profiler_annotations is not None:
            _state.profiler_annotations = profiler_annotations
        if max_spans is not None and max_spans != _state.max_spans:
            _state.max_spans = max_spans
            _state.spans = deque(_state.spans, maxlen=max_spans)
        if flight_capacity is not None:
            _state.flight_capacity = int(flight_capacity)
            if _state.flight is not None:
                _state.flight = deque(
                    _state.flight, maxlen=_state.flight_capacity
                )
        if flight != "__unset__":
            if not flight:
                _state.flight = None
                _state.flight_path = None
            else:
                if _state.flight is None:
                    _state.flight = deque(maxlen=_state.flight_capacity)
                _state.flight_path = (
                    None if flight is True else str(flight)
                )
    return prev


def enabled() -> bool:
    """True when any span sink (collector/JSONL) is active."""
    _state.ensure_init()
    return _state.active()


def events_enabled() -> bool:
    """True when a record built now would land somewhere — a sink or the
    flight-recorder ring.  The guard instrumented hot paths use before
    doing ANY per-record work (trace-id formatting included): with this
    False, :func:`event` is a no-op and the disabled path allocates
    nothing."""
    _state.ensure_init()
    return _state.recording()


def _current_ctx() -> Optional[Dict[str, Any]]:
    stack = getattr(_tls, "ctx", None)
    return stack[-1] if stack else None


@contextmanager
def tracing(rid=None, engine=None, hop=None):
    """Push a request trace context onto the calling thread: every span
    started and every :func:`event` emitted inside the ``with`` block
    carries ``rid``/``engine``/``hop`` top-level on its record.  Nests —
    inner scopes inherit and may override fields — and is thread-local,
    so concurrent requests cannot cross-tag each other's records."""
    stack = getattr(_tls, "ctx", None)
    if stack is None:
        stack = _tls.ctx = []
    ctx = dict(stack[-1]) if stack else {}
    if rid is not None:
        ctx["rid"] = rid
    if engine is not None:
        ctx["engine"] = engine
    if hop is not None:
        ctx["hop"] = hop
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


def event(name: str, *, rid=None, engine=None, hop=None, **attrs) -> None:
    """Emit one request-lifecycle event (``req.submitted``,
    ``req.first_token``, ``req.failed`` ...) carrying the trace context.

    ``rid``/``engine``/``hop`` default from the ambient :func:`tracing`
    scope.  Zero cost when nothing is recording (no sink, no flight
    ring): the function returns before building any record."""
    _state.ensure_init()
    if not _state.recording():
        return
    rec: Dict[str, Any] = {"type": "event", "name": name, "ts": time.time()}
    ctx = _current_ctx()
    if ctx:
        rec.update(ctx)
    if rid is not None:
        rec["rid"] = rid
    if engine is not None:
        rec["engine"] = engine
    if hop is not None:
        rec["hop"] = hop
    if attrs:
        rec["attrs"] = attrs
    _state.record(rec)


def flight_dump(reason: str, **attrs) -> int:
    """Dump the flight-recorder ring: the recent-records snapshot a
    post-mortem reads when full tracing wasn't on.  Returns the number
    of records dumped (0 with the recorder disabled or the ring empty).

    A header line ``{"type": "flight_dump", "reason", "n", ...}`` marks
    the dump.  With a dedicated flight file configured
    (``TDX_FLIGHT_RECORDER=/path``), header + records append there.
    With the recorder dumping into the main JSONL sink, records the sink
    already exported as they happened are not re-written — only the
    header (the marker CI and operators grep for) plus any records
    captured while no sink was active yet (``header["backfilled"]``
    counts those).  The ring clears only once the dump actually landed
    somewhere, so back-to-back failures dump disjoint windows but a
    dump that could not persist (dedicated file unwritable, or no sink
    configured at all) keeps its window for a later retry instead of
    silently destroying the post-mortem.

    Dedicated-file dumps are durable before they are reported: a fresh
    file is written via tmp + fsync + atomic rename, appends fsync
    before the ring clears — a crash right after the dump (the moment
    the file is for) can not leave a torn or empty forensics file."""
    _state.ensure_init()
    ring = _state.flight
    if ring is None or not ring:
        return 0
    records = [rec for _, rec in ring]
    header: Dict[str, Any] = {
        "type": "flight_dump",
        "ts": time.time(),
        "reason": reason,
        "n": len(records),
    }
    if attrs:
        header["attrs"] = attrs
    path = _state.flight_path
    if path is None:
        if not _state.active():
            # Ring-only mode with no main sink: there is nowhere to
            # persist the window — keep it (a sink configured later, or
            # a dedicated flight path, dumps it then) and say so.
            _logger.warning(
                "telemetry: flight dump (%s) has no sink — configure "
                "TDX_TELEMETRY or a dedicated TDX_FLIGHT_RECORDER path; "
                "keeping the %d-record window", reason, len(records),
            )
            return 0
        unexported = [rec for exported, rec in ring if not exported]
        if unexported:
            header["backfilled"] = len(unexported)
        _state.write_jsonl(header)
        if _state.collect:
            _state.spans.append(header)
        for rec in unexported:
            _state.write_jsonl(rec)
            if _state.collect:
                _state.spans.append(rec)
        ring.clear()
        return len(records)
    lines = []
    for rec in [header] + records:
        try:
            lines.append(json.dumps(rec, default=str))
        except (TypeError, ValueError):
            lines.append(json.dumps({k: str(v) for k, v in rec.items()}))
    text = "\n".join(lines) + "\n"
    try:
        # Durable before reported (the ring clears below on the strength
        # of this write): a crash right after a dump is exactly when the
        # forensics file is read, so it must never be torn or empty.  A
        # FIRST dump writes tmp + fsync + atomic rename (no window where
        # the file exists but is incomplete); later dumps append + fsync
        # before the ring clears.
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(text)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        else:
            with open(path, "a", encoding="utf-8") as f:
                f.write(text)
                f.flush()
                os.fsync(f.fileno())
    except OSError as e:  # telemetry never fails the operation
        _logger.warning(
            "telemetry: flight dump to %s failed (%s); keeping the "
            "%d-record window", path, e, len(records),
        )
        return 0
    ring.clear()
    return len(records)


def span(name: str, *, detached: bool = False, **attrs) -> Span:
    """Context-manager span: ``with span("train.step", step=3): ...``.

    Always times; records to the active sinks on exit.  With
    ``TDX_TELEMETRY_PROFILER=1`` the region is a ``torch.profiler``
    ``record_function`` range (``step=`` goes into its args).
    ``detached=True`` keeps the span off the thread's nesting stack (it
    never parents another span) — for long-lived regions crossing
    arbitrary work."""
    _state.ensure_init()
    return Span(name, attrs or None, detached=detached)


def start_span(name: str, *, detached: bool = False, **attrs) -> Span:
    """Manual-boundary span: ``sp = start_span(...); ...; sp.end()``."""
    _state.ensure_init()
    return Span(name, attrs or None, detached=detached).start()


def counter(name: str, **labels) -> Counter:
    """Get-or-create the named counter (bind once at module level on hot
    paths — the lookup takes the registry lock).  Keyword labels
    canonicalize into the name (``counter("serve.shed", engine="eng0")``
    → ``serve.shed{engine=eng0}``) so N engines in one process count
    separately."""
    if labels:
        name = _labeled(name, labels)
    c = _state.counters.get(name)
    if c is None:
        with _REG_LOCK:
            c = _state.counters.setdefault(name, Counter(name))
    return c


def gauge(name: str, **labels) -> Gauge:
    """Get-or-create the named gauge (labels as in :func:`counter`)."""
    if labels:
        name = _labeled(name, labels)
    g = _state.gauges.get(name)
    if g is None:
        with _REG_LOCK:
            g = _state.gauges.setdefault(name, Gauge(name))
    return g


def histogram(
    name: str, bounds: Optional[Sequence[float]] = None, **labels
) -> Histogram:
    """Get-or-create the named histogram (labels as in :func:`counter`).
    ``bounds`` applies only at creation; the default is the latency
    ladder (100 µs .. 100 s, ~33% resolution)."""
    if labels:
        name = _labeled(name, labels)
    h = _state.histograms.get(name)
    if h is None:
        with _REG_LOCK:
            h = _state.histograms.setdefault(name, Histogram(name, bounds))
    return h


def remove(name: str, **labels) -> bool:
    """Drop the named instrument (counter, gauge, or histogram — labels
    as in :func:`counter`) from the registry.  Returns True when
    something was removed.

    This is the bounded-cardinality valve for *dynamic label families*
    (``gauge("serve.queue_depth", tenant=...)``, the per-tenant SLO
    gauges): a long-lived engine serving free-form tenant ids prunes a
    tenant's instruments when it goes idle, so the registry — and every
    exported counters snapshot and ``/metrics`` scrape — tracks ACTIVE
    labels, not labels ever seen.

    Do NOT remove an instrument a module bound at import time (the
    reason :func:`reset` zeroes in place instead of clearing): the
    binder would keep counting into an object the registry can no
    longer see.  Removal is for instruments looked up fresh at each
    use."""
    if labels:
        name = _labeled(name, labels)
    with _REG_LOCK:
        found = _state.counters.pop(name, None) is not None
        found = (_state.gauges.pop(name, None) is not None) or found
        found = (_state.histograms.pop(name, None) is not None) or found
    return found


def add_listener(fn) -> None:
    """Register an in-process record listener: ``fn(rec)`` is called
    with every span/event record as it is emitted (exceptions are
    swallowed — telemetry never fails the instrumented operation).  A
    registered listener counts as a recording target
    (:func:`events_enabled` goes True), so lifecycle events are built
    for it even with every sink and the flight ring off — the ops
    plane's SLO monitor consumes the stream this way.  Listeners run
    on the emitting thread: keep them cheap."""
    _state.ensure_init()
    if fn not in _state.listeners:
        _state.listeners.append(fn)


def remove_listener(fn) -> None:
    """Unregister a record listener (no-op if absent)."""
    try:
        _state.listeners.remove(fn)
    except ValueError:
        pass


def flight_records() -> List[Dict[str, Any]]:
    """Snapshot of the flight-recorder ring's records, oldest first
    (empty with the recorder off).  Read-only: the ring is untouched —
    this is the live view the ops plane's ``/requests`` endpoint
    reconstructs timelines from, between (and without) dumps."""
    ring = _state.flight
    if ring is None:
        return []
    return [rec for _, rec in list(ring)]


def registry_view() -> tuple:
    """One consistent view of the live instrument registries for an
    exporter: ``(counters, gauges, histograms)`` as shallow dict copies
    (name → instrument OBJECT, not value) taken under the registry
    lock.  Values are read from the objects afterwards — each carries
    its own lock where torn reads could matter."""
    with _REG_LOCK:
        return (
            dict(_state.counters),
            dict(_state.gauges),
            dict(_state.histograms),
        )


def histograms() -> Dict[str, Dict[str, Any]]:
    """Current histogram summaries, name → ``{count, sum, min, max,
    p50, p95, p99}`` (empty histograms report ``{"count": 0}``)."""
    return {
        name: h.summary()
        for name, h in sorted(_state.histograms.items())
    }


def counters() -> Dict[str, int]:
    """Current counter values, name → count."""
    return {name: c.value for name, c in sorted(_state.counters.items())}


def gauges() -> Dict[str, Any]:
    """Current gauge values (unset gauges omitted)."""
    return {
        name: g.value
        for name, g in sorted(_state.gauges.items())
        if g.value is not None
    }


def snapshot() -> Dict[str, Any]:
    """The in-memory collector as a plain dict:
    ``{"counters": {...}, "gauges": {...}, "histograms": {...},
    "spans": [...]}`` (``spans`` holds every collected record — span
    AND event lines, in emission order)."""
    _state.ensure_init()
    return {
        "counters": counters(),
        "gauges": gauges(),
        "histograms": histograms(),
        "spans": list(_state.spans),
    }


def drain() -> List[Dict[str, Any]]:
    """Pop and return all collected span records (oldest first)."""
    _state.ensure_init()
    out = []
    try:
        while True:
            out.append(_state.spans.popleft())
    except IndexError:
        pass
    return out


def emit_counters() -> None:
    """Write one counters+gauges snapshot line to the JSONL sink (no-op
    without one).  Called at natural flush points — the end of each
    ``fit`` preempted and at interpreter exit."""
    _state.ensure_init()
    if _state.jsonl_path is None:
        return
    rec = {
        "type": "counters",
        "ts": time.time(),
        "values": counters(),
        "gauges": gauges(),
    }
    if _state.histograms:
        # Additive key: pre-histogram consumers of the counters schema
        # (type/ts/values/gauges) parse unchanged.
        rec["histograms"] = histograms()
    _state.write_jsonl(rec)


# Sibling modules holding derived telemetry state (the perf plane's
# storm windows and HBM ledger) register a hook here so reset() clears
# them with the registries — a storm latched by one test must not stay
# latched into the next.
_RESET_HOOKS: List[Any] = []


def on_reset(fn) -> None:
    """Register ``fn()`` to run at the end of every :func:`reset`
    (idempotent per function; exceptions are swallowed — reset is test
    plumbing, not a failure path)."""
    if fn not in _RESET_HOOKS:
        _RESET_HOOKS.append(fn)


def reset() -> None:
    """Zero all counters/gauges/histograms and clear collected spans and
    the flight ring (tests).

    Values are zeroed IN PLACE — instrumented modules bind their Counter
    (and Histogram) objects once at import, so dropping registry entries
    would leave them counting into objects :func:`counters` can no
    longer see.  Dynamic label families (per-tenant gauges, per-engine
    histograms) are looked up fresh at each use instead — those prune
    via :func:`remove` when their label goes idle, which is what keeps
    the registry bounded under free-form label values."""
    with _REG_LOCK:
        for c in _state.counters.values():
            with c._lock:
                c._value = 0
        for g in _state.gauges.values():
            g._value = None
        for h in _state.histograms.values():
            h._zero()
    _state.spans.clear()
    if _state.flight is not None:
        _state.flight.clear()
    # Listeners clear too: a monitor leaked by one test must not keep
    # events_enabled() True (and the disabled-path pins red) in the
    # next.  Live ops planes re-subscribe nothing — close them first.
    _state.listeners.clear()
    # The CALLING thread's nesting/trace stacks clear too: a span
    # abandoned by one test (started, never ended) must not become a
    # phantom parent in the next.
    for attr in ("spans", "ctx"):
        stack = getattr(_tls, attr, None)
        if stack:
            stack.clear()
    for fn in list(_RESET_HOOKS):
        try:
            fn()
        except Exception:  # noqa: BLE001 — reset is test plumbing
            pass


def _flush_at_exit() -> None:  # pragma: no cover — interpreter teardown
    try:
        if _state.jsonl_path is not None and _state.counters:
            emit_counters()
        _state.close_jsonl()
    except Exception:  # noqa: BLE001
        pass


import atexit  # noqa: E402

atexit.register(_flush_at_exit)
