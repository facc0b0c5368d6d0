"""Continuous-batching engine: fixed decode slots over a paged KV cache.

Counterpart of ``torchdistx_tpu/serving/engine.py``'s core: Orca-style
iteration-level scheduling (Yu et al., OSDI '22) over a vLLM-style paged
cache (Kwon et al., SOSP '23).  Two programs serve any traffic mix:

* a **prefill chunk**: up to ``prefill_chunk`` suffix tokens of one
  request through the family's ``forward_paged``, padded to a
  power-of-two bucket from ``min_prefill_bucket``; the chunk's K/V lands in
  the request's pages and its queries attend the cached prefix (shared
  pages included) plus the chunk.  The final chunk samples the first
  token.  A long prompt prefills across ticks, interleaved with decode
  (``max_prefills_per_tick`` budgets chunks a tick).  Prefill runs eagerly.
* the **decode chunk**: ``decode_chunk`` steps of ``forward_paged`` +
  sampling + the EOS update over all ``num_slots`` slots, with one host
  sync a chunk (the ``(decode_chunk, S)`` tokens read back).  On CUDA it
  is **one CUDA graph per engine geometry** ``(num_slots, table width,
  decode_chunk, temperature, top_k, eos_id)``, captured after a warm-up on
  a side stream and replayed once a tick; its inputs (tokens, positions,
  tokens sampled, done, keys, tables) are persistent device buffers
  refreshed by ``copy_`` before each replay, and the pool is captured by
  address.  A failed capture raises :class:`GraphCaptureError`: there is
  no quiet eager fallback on the card.  Off CUDA the same function runs
  eagerly.

**Prefix caching** (``prefix_cache=True``): full prompt pages are
content-addressed in a refcounted LRU index (:class:`.prefix.PrefixIndex`);
a request extending a cached prefix maps its pages and prefills only the
rest; a stream about to write into a shared page copies it first
(copy-on-write, :func:`.cache.copy_pages`); unreferenced prefixes evict LRU
under allocator pressure.

**Token parity with solo** :func:`~torchdistx_tpu_torch.models.generate.
generate`: the paged attention masks like the contiguous one, and slot
``s`` samples step ``n`` of its request by
:func:`~torchdistx_tpu_torch.models.generate.sample_keyed` on the
request's key and ``n`` alone, so a stream equals ``generate(key=k)`` on
the same device whatever the admission order, the slot and the chunking.
Greedy streams equal the JAX engine's.  Sampled ones cannot: threefry's
``fold_in`` is not reproduced (a designed difference).

**The pool is updated in place, never donated.**  A failed dispatch
leaves every slot's committed prefix intact: decode and prefill write
only at positions after a slot's committed tokens (or into the trash
page), and those positions are masked until they are rewritten.  So a
first failure is a free retry, as in JAX.  A second consecutive decode
failure, a device OOM or a CUDA error (which may have written anywhere)
goes to the **supervisor**, which zeroes the pool in place
(:func:`.cache.fresh_pool`), resets the allocator and replays each live
request over ``prompt + tokens-so-far`` under a per-request
``max_recoveries`` budget before a typed :class:`.lifecycle.
RecoveryFailed`.  The replay inputs are checked against each request's
:class:`~torchdistx_tpu_torch.telemetry.audit.DeterminismDigest` first.

Request lifecycle (:mod:`.lifecycle`): deadlines and cancellation act at
chunk boundaries; a bounded queue sheds ``reject-new`` or ``drop-oldest``
through :class:`.lifecycle.OverloadDetector`; SIGTERM (through
:mod:`torchdistx_tpu_torch.resilience.preemption`) drains the engine
through the :class:`.lifecycle.Health` states.

Fault sites (``TDX_FAULT``): ``serve.admit`` and ``serve.prefill`` —
``io``/``nan`` requeue at the FIFO head and the next tick retries;
``serve.step`` — ``nan`` skips the chunk before dispatch (decode is a
pure function of committed state), ``io`` counts as a failed dispatch
(the first a free retry, a second consecutive one goes to the
supervisor), ``corrupt`` flips one committed token on the host;
``serve.recover`` — fails one replay attempt, charging the budget.
``fatal`` propagates everywhere.

**QoS** (``scheduler="qos"``): admission moves to the
:class:`.qos.QoSScheduler` (strict priority classes, per-tenant weighted
fair queueing over prefill-chunk cost, EDF within a (class, tenant)
queue), and a waiting higher class preempts running lower ones: under
slot pressure by **drop-and-replay** (pages free, the request requeues
with its committed tokens and re-prefills ``prompt + tokens[:-1]``),
under page pressure by ``preempt_mechanism``: ``"swap"`` gathers the
victim's private pages into pinned host tensors on a swap stream
(:func:`.cache.swap_out_pages`) and parks the slot through its inputs
alone (table 0 → trash, ``done=True``: no recapture), or ``"replay"``.
Swap-in scatters the pages back in place before the slot re-enters the
decode batch.  Keyed sampling at ``n`` makes every resume
token-identical.

**Forks** (``submit(n>1)``): siblings ride the parent's prompt pages
copy-on-write (the prompt prefills once; each sibling re-runs the last
prompt token into a private copy of the last page); sibling ``i`` samples
under :func:`~torchdistx_tpu_torch.models.generate.fold_key` ``(key, i)``.

**Model plane** (``model_pool=``, ``submit(model=)``): deferred-init
skeletons materialized on demand between ticks, decoding into this one
page pool, one decode graph per ``(geometry, model tag)``; the prefix
index is namespaced by tag (:mod:`.modelpool`).

**Durability** (``journal=``): every admission, chunk commit and
retirement is journaled (:mod:`.journal`, JAX's on-disk format);
:meth:`Engine.resume_from_journal` re-admits a dead process's unfinished
streams through the replay path.  **Migration**: :meth:`Engine.
migrate_out` exports a live stream's pages as pinned host tensors,
:meth:`Engine.migrate_in` maps them into another engine's pool.

The HBM ledger (:mod:`torchdistx_tpu_torch.telemetry.perf`) carries the
engine's ``weights`` (the parameters and their ``prep_decode`` copy) and
``kv_pool`` rows.

Fault sites (``TDX_FAULT``) besides those above: ``serve.swap`` — fails
one swap-out before its gather (read-only), and the preemption falls back
to drop-and-replay; ``serve.migrate_out`` — fails one export before the
gather (the source keeps running); ``serve.migrate_in`` — fails one import
after the destination allocated pages, before the scatter (the pages
free); ``serve.materialize`` — fails one model-pool materialize attempt
(the skeleton is untouched, the next tick retries).  A real CUDA error or
OOM in a swap goes to the supervisor.

**Audit plane** (``audit_sample=`` / ``TDX_AUDIT_SAMPLE``): a
:class:`~torchdistx_tpu_torch.telemetry.audit.ShadowAuditor` replays a
sampled fraction of finished requests through :meth:`Engine.submit` on
quiet ticks and compares digests exactly; a mismatch latches the engine
OVERLOADED until :meth:`Engine.clear_divergence`.  **Ops plane**
(``ops_port=`` / ``ops_config=`` / ``TDX_OPS_PORT``): the engine joins an
:class:`~torchdistx_tpu_torch.telemetry.ops.OpsPlane` (``/metrics``,
``/healthz``, ``/requests``, ``/profile``, a stall watchdog) and its tick
publishes the utilization gauges and the time plane's phase split
(:mod:`~torchdistx_tpu_torch.telemetry.timeplane`; ``device_wait`` is the
decode chunk's read-back and the last prefill chunk's sampled token).
With neither, the tick takes no extra host time.  Health changes take the
engine's health lock: the watchdog thread marks a wedged engine through
it.

Every device tensor the engine owns (the page pool, its decode graphs and
their inputs) is released when it stops (:meth:`Engine.close` or the end
of a drain); live engines over one model share its ``prep_decode`` copy
while its parameters are unchanged, and the copy leaves with the last
engine holding it.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from contextlib import nullcontext
from typing import Any, Optional

import numpy as np
import torch

from .. import telemetry as _telemetry
from .._device import resolve_device
from ..models.generate import fold_key, sample_keyed
from ..resilience import faults
from ..resilience import preemption as _preemption
from ..telemetry import audit as _audit
from ..telemetry import ops as _ops
from ..telemetry import perf as _perf
from ..telemetry import timeplane as _timeplane
from . import journal as _journal_mod
from .blocks import BlockAllocator, blocks_needed
from .cache import (
    copy_pages,
    fresh_pool,
    init_paged_cache,
    pool_geometry,
    swap_in_pages,
    swap_out_pages,
)
from .journal import RequestJournal
from .lifecycle import (
    DeadlineExceeded,
    DeterminismDiverged,
    EngineDraining,
    EngineOverloaded,
    Health,
    MigrationIncompatible,
    OverloadDetector,
    RecoveryFailed,
    RequestCancelled,
    RequestPreempted,
)
from .modelpool import DEFAULT_MODEL, ModelPool, module_nbytes
from .prefix import PrefixIndex, page_hashes
from .qos import QoSScheduler
from .scheduler import FIFOScheduler, Request, RequestHandle

__all__ = ["DecodeChunk", "Engine", "GraphCaptureError"]

_T_REQUESTS = _telemetry.counter("serve.requests")
_T_FINISHED = _telemetry.counter("serve.finished")
_T_TOKENS = _telemetry.counter("serve.tokens_out")
_T_ADMIT_RETRIES = _telemetry.counter("serve.admit_retries")
_T_PREFILL_RETRIES = _telemetry.counter("serve.prefill_retries")
_T_STEP_RETRIES = _telemetry.counter("serve.step_retries")
_T_SKIPPED = _telemetry.counter("serve.skipped_steps")
_T_SHED = _telemetry.counter("serve.shed")
_T_EXPIRED = _telemetry.counter("serve.expired")
_T_CANCELLED = _telemetry.counter("serve.cancelled")
_T_RECOVERIES = _telemetry.counter("serve.recoveries")
_T_RECOVERY_FAILURES = _telemetry.counter("serve.recovery_failures")
_T_PREEMPTED = _telemetry.counter("serve.preempted")
_T_PREEMPT_SWAP = _telemetry.counter("serve.preemptions_swap")
_T_PREEMPT_REPLAY = _telemetry.counter("serve.preemptions_replay")
_T_PREFIX_HITS = _telemetry.counter("serve.prefix_hits")
_T_PREFIX_HIT_TOKENS = _telemetry.counter("serve.prefix_hit_tokens")
_T_COW = _telemetry.counter("serve.cow_copies")
_T_PREFIX_EVICTIONS = _telemetry.counter("serve.prefix_evictions")
_T_IDLE_TICKS = _telemetry.counter("serve.idle_ticks")
_T_CORRUPTIONS = _telemetry.counter("serve.corruptions")
_T_GRAPH_CAPTURES = _telemetry.counter("serve.graph_captures")
_T_MIGRATIONS_OUT = _telemetry.counter("serve.migrations_out")
_T_MIGRATIONS_IN = _telemetry.counter("serve.migrations_in")
_T_MIGRATED_PAGES = _telemetry.counter("serve.migrated_pages")
_T_FORKS = _telemetry.counter("serve.forks")
_G_RUNNING = _telemetry.gauge("serve.running_slots")
_G_DECODE_TPS = _telemetry.gauge("serve.decode_tok_s")
_G_TTFT = _telemetry.gauge("serve.ttft_s")
_G_EST_TTFT = _telemetry.gauge("serve.est_ttft_s")
_G_HEALTH = _telemetry.gauge("serve.health")

# Process-wide engine-id mint ("eng0", "eng1", ...) unless the caller
# names the engine.
_ENGINE_SEQ = itertools.count()

# Live engines per shared ``weights`` ledger row (a model's parameters,
# a shared decode copy): N engines register the row's bytes once, and it
# leaves the ledger when the LAST of them stops.  owner -> refcount.
_WEIGHTS_REFS: dict = {}
_WEIGHTS_LOCK = threading.Lock()

# model -> weakref to its shared _DecodeCopy.  Only engines hold a copy, so
# its memory leaves with the last engine holding it (closed or collected),
# and an entry leaves with its model.
_DECODE_COPIES = weakref.WeakKeyDictionary()
_DECODE_SEQ = itertools.count()


class _DecodeCopy:
    """A model's ``prep_decode()`` weights, the parameter stamp they were
    fused from, and their ledger owner."""

    __slots__ = ("weights", "stamp", "owner", "__weakref__")

    def __init__(self, weights, stamp):
        self.weights = weights
        self.stamp = stamp
        self.owner = f"decode:{next(_DECODE_SEQ)}"


def _param_stamp(model) -> Optional[tuple]:
    """Each parameter's identity, storage and version counter: an in-place
    write (``load_state_dict``, an optimizer step) or a rebound ``.data``
    changes it.  ``None`` where a parameter keeps no version counter (an
    inference tensor): such a model's copy is never shared."""
    try:
        return tuple((id(p), p.data_ptr(), p._version) for p in model.parameters())
    except RuntimeError:
        return None


def _shared_decode_copy(model) -> _DecodeCopy:
    """The model's fused decode weights, shared by every live engine over
    the model while its parameters are unchanged, and fused afresh once
    they have changed."""
    stamp = _param_stamp(model)
    with _WEIGHTS_LOCK:
        ref = _DECODE_COPIES.get(model)
        copy = ref() if ref is not None else None
        if copy is None or stamp is None or copy.stamp != stamp:
            copy = _DecodeCopy(model.prep_decode(), stamp)
            if stamp is not None:
                _DECODE_COPIES[model] = weakref.ref(copy)
        return copy


def _hold_weights_row(owner: str, nbytes: int) -> None:
    with _WEIGHTS_LOCK:
        _WEIGHTS_REFS[owner] = _WEIGHTS_REFS.get(owner, 0) + 1
    _perf.ledger.register("weights", nbytes, owner=owner)


def _release_weights_row(owner: str) -> None:
    with _WEIGHTS_LOCK:
        left = _WEIGHTS_REFS.get(owner, 1) - 1
        if left <= 0:
            _WEIGHTS_REFS.pop(owner, None)
        else:
            _WEIGHTS_REFS[owner] = left
    if left <= 0:
        _perf.ledger.unregister("weights", owner=owner)

# One warm-up stream a device, shared by every decode-graph capture: each
# new stream would take cuBLAS a workspace of its own, which is never
# returned (a model pool recaptures at every re-materialize).
_WARMUP_STREAMS: dict = {}

class GraphCaptureError(RuntimeError):
    """Capturing the decode chunk as a CUDA graph failed.  Raised out of
    ``step()``: the engine does not fall back to eager decode on the
    card."""


def _device_fault(err: BaseException) -> bool:
    """A device OOM or a CUDA error: the failed call may have written
    anywhere, so committed pages can no longer be trusted."""
    if isinstance(err, torch.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(err, accel):
        return True
    msg = str(err)
    return isinstance(err, RuntimeError) and any(
        s in msg for s in ("CUDA error", "CUBLAS_STATUS", "cuDNN error", "CUDA out of memory"))


class DecodeChunk:
    """``n_steps`` decode steps over every slot: ``forward_paged`` on each
    slot's token at its position, keyed sampling at its ``n``, post-EOS
    slots kept at EOS; retired slots (table 0) write on the trash page.

    Inputs live in persistent buffers (:attr:`inputs`), the output in
    :attr:`out` ``(n_steps, S)``; :meth:`__call__` copies host arrays in,
    runs, and reads the tokens back (the chunk's one host sync).  On CUDA
    the first call warms the function up on a side stream, captures it as
    one graph and replays it; every later call replays.  Off CUDA it runs
    eagerly.  :meth:`run_eager` runs the same function eagerly on the
    current buffers (for comparison on the card)."""

    def __init__(self, model, weights, cache, *, num_slots: int, table_width: int,
                 n_steps: int, temperature: float, top_k: Optional[int],
                 eos_id: Optional[int], device):
        self.model, self.weights, self.cache = model, weights, cache
        self.n_steps, self.temperature, self.top_k, self.eos_id = (
            n_steps, temperature, top_k, eos_id)
        self.device = torch.device(device)
        s, m = num_slots, table_width
        kw = dict(dtype=torch.int64, device=self.device)
        self.inputs = {
            "tokens": torch.zeros((s,), **kw),
            "positions": torch.zeros((s,), **kw),
            "n_gen": torch.zeros((s,), **kw),
            "done": torch.ones((s,), dtype=torch.bool, device=self.device),
            "keys": torch.zeros((s, 2), **kw),
            "tables": torch.zeros((s, m), **kw),
        }
        self.out = torch.zeros((n_steps, s), **kw)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0

    @torch.no_grad()
    def run_eager(self) -> None:
        """The chunk's function on the current input buffers, into
        :attr:`out`."""
        inp = self.inputs
        tok, pos, n, dn = inp["tokens"], inp["positions"], inp["n_gen"], inp["done"]
        for i in range(self.n_steps):
            logits, _ = self.model.forward_paged(tok[:, None], self.cache, inp["tables"], pos,
                                                 self.weights)
            nxt = sample_keyed(logits[:, -1], inp["keys"], n, self.temperature, self.top_k)
            if self.eos_id is not None:
                nxt = torch.where(dn, self.eos_id, nxt)
                dn = dn | (nxt == self.eos_id)
            self.out[i].copy_(nxt)
            tok, pos, n = nxt, pos + 1, n + 1

    def load(self, tokens, positions, n_gen, done, keys, tables) -> None:
        """Copy the host's slot arrays into the input buffers."""
        for name, arr in (("tokens", tokens), ("positions", positions), ("n_gen", n_gen),
                          ("done", done), ("keys", keys), ("tables", tables)):
            buf = self.inputs[name]
            buf.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(buf.dtype))

    def capture(self) -> None:
        """Warm up on a side stream, then capture :meth:`run_eager` as one
        CUDA graph over the current buffers and pool."""
        cur = torch.cuda.current_stream(self.device)
        side = _WARMUP_STREAMS.get(self.device)
        if side is None:
            side = _WARMUP_STREAMS[self.device] = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        try:
            with torch.cuda.stream(side):
                self.run_eager()
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.run_eager()
        except Exception as err:
            raise GraphCaptureError(f"capturing the decode chunk failed: {err!r}") from err
        self.graph = graph
        _T_GRAPH_CAPTURES.add()

    def replay(self) -> None:
        """One launch of the captured chunk (capturing it first)."""
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1

    def __call__(self, tokens, positions, n_gen, done, keys, tables,
                 timer=None) -> np.ndarray:
        """Load, launch, read back.  ``timer`` (the engine's tick timer)
        marks the read-back, the chunk's one host sync, as
        ``device_wait``."""
        self.load(tokens, positions, n_gen, done, keys, tables)
        if self.device.type == "cuda":
            self.replay()
        else:
            self.run_eager()
        if timer is not None:
            timer.begin("device_wait")
        return self.out.cpu().numpy()


class Engine:
    """Continuous-batching serving engine over one model.

    Single-host, single-threaded: drive it from ``handle.tokens()`` /
    ``handle.result()`` / :meth:`drain`, or call :meth:`step` yourself.

    Parameters (the JAX engine's names and defaults):

    model : a :class:`~torchdistx_tpu_torch.models.llama.Llama` or
        :class:`~torchdistx_tpu_torch.models.gpt2.GPT2`, which carries its
        ``cfg``; its parameters must be on ``device``.
    device : where the engine runs; ``None`` is CUDA (the port's rule:
        raises without CUDA), ``"cpu"`` runs the same code eagerly.
    num_slots : decode batch width (concurrent running requests).
    block_size : KV page size in tokens.
    num_blocks : page-pool size; default the trash page plus ``num_slots``
        times the widest request's pages, so nothing backpressures unless
        sized down.
    max_model_len : longest admissible ``prompt + max_new_tokens``; also
        the block-table width, i.e. the decode attention span.
    temperature / top_k / eos_id : engine-static sampling config.
    decode_chunk : decode steps a host sync (and a graph replay).
    max_prefills_per_tick : prefill chunks dispatched a tick.
    prefill_chunk : prefill tokens a chunk.
    prefix_cache : content-address full prompt pages (see module doc).
    min_prefill_bucket : the smallest prefill bucket.
    scheduler : ``"fifo"`` (default) or ``"qos"`` (:class:`.qos.QoSScheduler`
        plus preemption of running lower-class streams).
    tenant_weights : ``{tenant: weight}`` fair-queueing shares (QoS only).
    preempt_mechanism : how page pressure preempts under QoS: ``"swap"``
        (pages to pinned host tensors, slot parked, swapped back in when
        pressure drops) or ``"replay"``.  Slot pressure always replays.
    max_queue / max_ttft_s / shed_policy : the overload detector's bounds
        and what happens when it trips (``"reject-new"``, ``"drop-oldest"``,
        or, under QoS, ``"by-priority"``: the lowest class, youngest first).
    max_recoveries : per-request replay budget of the supervisor.
    drain_deadline_s : wall-clock budget for in-flight work once a drain
        begins; the remainder fails with :class:`.lifecycle.RequestPreempted`.
    handle_preemption : install the SIGTERM/SIGINT flag handlers.
    engine_id : the label of the per-engine metrics.
    role : ``"mixed"``, ``"prefill"`` or ``"decode"``, a routing hint
        exported as ``serve.role{engine=}``.
    model_version : the version tag folded into every request's digest.
    model_pool : a :class:`.modelpool.ModelPool` of deferred-init skeletons
        served beside the engine's own model, into this page pool.
    journal : a :class:`.journal.RequestJournal` this engine claims and
        writes (see :meth:`resume_from_journal`).
    ops_port : join the live ops plane on this port (``0``: a fresh plane
        on an ephemeral port); default ``TDX_OPS_PORT`` when set, else off.
    ops_config : :class:`~torchdistx_tpu_torch.telemetry.ops.OpsConfig`,
        applied when this engine creates the plane.
    audit_sample : the fraction of finished requests the shadow auditor
        replays (``[0, 1]``); default ``TDX_AUDIT_SAMPLE`` when set, else
        off.
    """

    def __init__(
        self,
        model,
        *,
        device: Optional[Any] = None,
        num_slots: int = 8,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        max_model_len: Optional[int] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        eos_id: Optional[int] = None,
        decode_chunk: int = 8,
        max_prefills_per_tick: int = 1,
        prefill_chunk: int = 512,
        prefix_cache: bool = True,
        min_prefill_bucket: int = 16,
        scheduler: str = "fifo",
        tenant_weights: Optional[dict] = None,
        preempt_mechanism: str = "swap",
        max_queue: Optional[int] = None,
        max_ttft_s: Optional[float] = None,
        shed_policy: str = "reject-new",
        max_recoveries: int = 2,
        drain_deadline_s: float = 30.0,
        handle_preemption: bool = True,
        engine_id: Optional[str] = None,
        ops_port: Optional[int] = None,
        ops_config: Any = None,
        role: str = "mixed",
        model_version: str = "v0",
        audit_sample: Optional[float] = None,
        model_pool: Any = None,
        journal: Any = None,
    ):
        self.device = resolve_device(device)
        param_device = next(model.parameters()).device
        if param_device != self.device and not (
                param_device.type == self.device.type == "cuda" and self.device.index is None):
            raise ValueError(f"the model's parameters are on {param_device}, "
                             f"the engine runs on {self.device}")
        self.device = param_device
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        self.model_version = str(model_version)
        self.engine_id = (str(engine_id) if engine_id is not None
                          else f"eng{next(_ENGINE_SEQ)}")
        if num_slots < 1:
            # Zero slots would park every request at the FIFO head with
            # no slot ever freeing — tokens() would spin step() forever.
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_model_len = int(max_model_len or cfg.max_seq_len)
        if self.max_model_len > cfg.max_seq_len:
            raise ValueError(f"max_model_len ({self.max_model_len}) exceeds "
                             f"cfg.max_seq_len ({cfg.max_seq_len})")
        self.temperature = float(temperature)
        self.top_k = top_k
        self.eos_id = eos_id
        self.decode_chunk = int(decode_chunk)
        if self.decode_chunk < 1:
            raise ValueError("decode_chunk must be >= 1")
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.min_prefill_bucket = int(min_prefill_bucket)
        if self.min_prefill_bucket < 1:
            # _chunk_bucket doubles up from this value; <= 0 would never
            # terminate.
            raise ValueError("min_prefill_bucket must be >= 1")
        if scheduler not in ("fifo", "qos"):
            raise ValueError(f"scheduler {scheduler!r}: expected 'fifo' or 'qos'")
        self._qos = scheduler == "qos"
        if tenant_weights is not None and not self._qos:
            raise ValueError("tenant_weights needs scheduler='qos' (the FIFO scheduler "
                             "ignores tenancy — a silently-dropped weight map would "
                             "masquerade as fairness)")
        if preempt_mechanism not in ("swap", "replay"):
            raise ValueError(f"preempt_mechanism {preempt_mechanism!r}: expected "
                             "'swap' or 'replay'")
        self.preempt_mechanism = preempt_mechanism  # inert under FIFO, as in JAX
        if shed_policy not in ("reject-new", "drop-oldest", "by-priority"):
            raise ValueError(f"shed_policy {shed_policy!r}: expected 'reject-new', "
                             "'drop-oldest', or 'by-priority'")
        if shed_policy == "by-priority" and not self._qos:
            raise ValueError("shed_policy='by-priority' needs scheduler='qos' (the FIFO "
                             "scheduler has no priority classes to shed by)")
        self.shed_policy = shed_policy
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"role {role!r}: expected 'prefill', 'decode', or 'mixed'")
        self.role = role
        self.max_recoveries = int(max_recoveries)
        if self.max_recoveries < 0:
            raise ValueError("max_recoveries must be >= 0")
        self.drain_deadline_s = float(drain_deadline_s)
        self.max_prefills_per_tick = max_prefills_per_tick

        self._table_width = blocks_needed(self.max_model_len, block_size)
        if num_blocks is None:
            num_blocks = 1 + num_slots * self._table_width
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.scheduler = (QoSScheduler(max_prefills_per_tick, tenant_weights) if self._qos
                          else FIFOScheduler(max_prefills_per_tick))
        self.scheduler.bind_engine(self.engine_id)
        self.detector = OverloadDetector(max_queue, max_ttft_s)
        self.prefix: Optional[PrefixIndex] = PrefixIndex(block_size) if prefix_cache else None

        # Engines over one model count its parameters once on the ledger
        # and share its prep_decode copy while the parameters are unchanged
        # (each row refcounted, released by the last engine at STOPPED).
        self._weights_key = f"params:{id(model)}"
        self._decode_copy: Optional[_DecodeCopy] = _shared_decode_copy(model)
        self._weights = self._decode_copy.weights
        self._cache = init_paged_cache(model, num_blocks, block_size, device=self.device)
        self._pool_nbytes = _perf.pytree_nbytes(self._cache)
        self._page_nbytes = self._pool_nbytes // max(1, num_blocks)
        self._swap_host_bytes = 0
        # (geometry, model tag) -> DecodeChunk (one graph each on CUDA).
        self._decoders: dict = {}

        s = num_slots
        self._slot_req: list = [None] * s
        self._tokens = np.zeros((s,), np.int64)  # each slot's current token
        self._positions = np.zeros((s,), np.int64)  # its next cache slot
        self._n_gen = np.zeros((s,), np.int64)  # tokens sampled so far
        self._done = np.ones((s,), bool)  # idle slots read as done
        self._keys = np.zeros((s, 2), np.int64)
        self._tables = np.zeros((s, self._table_width), np.int64)
        self._emitted = np.zeros((s,), np.int64)  # tokens pushed to handles
        # Slots mid-prefill, in admission order: they hold pages and a
        # slot but are NOT in the decode batch (their device-visible
        # table stays 0 → trash) until their last chunk samples the
        # first token.  Strict FIFO: the head gets every chunk of the
        # tick's budget until it completes.
        self._prefill_q: list = []
        # Slots swapped to host (QoS preemption): they park in their slot,
        # out of the decode batch like PREFILLING slots (table 0 → trash,
        # done=True: the decode graph is untouched).  Only PRIVATE pages
        # (refcount 1) go to host and free; shared pages stay mapped on
        # the refs the request keeps.  slot -> (host pages or None,
        # layout), layout[i] the kept page id or None for the i-th table
        # position (None rows in host-buffer order).
        self._swapped: dict = {}
        # Parallel sampling: per fork group, the ENGINE-held share
        # references on the parent's prompt-covering pages, created when
        # the parent's prefill completes, swept once every sibling is
        # terminal.  parent rid -> [page ids].
        self._fork_donors: dict = {}
        # parent rid -> the sibling Requests of the group (parent excluded).
        self._fork_groups: dict = {}
        # Cold pool models with demand, in demand order (an ordered set):
        # the materialize phase serves ONE per tick, after the decode
        # dispatch.
        self._materialize_wanted: dict = {}

        self._next_rid = 0
        self._admit_no = 0  # admission attempts (serve.admit fault site)
        self._prefill_no = 0  # prefill dispatches (serve.prefill site)
        self._decode_no = 0  # decode chunks attempted (serve.step site)
        self._recover_no = 0  # supervisor replay attempts (serve.recover)
        self._swap_no = 0  # swap-out attempts (serve.swap fault site)
        self._migrate_out_no = 0  # stream exports (serve.migrate_out site)
        self._migrate_in_no = 0  # stream imports (serve.migrate_in site)
        self._preempted_this_tick = False  # swap-in back-off after a preempt
        self._decode_s = 0.0
        self._decode_tokens = 0
        self._consec_decode_failures = 0
        self._n_shed = 0
        self._n_expired = 0
        self._n_cancelled = 0
        self._n_recoveries = 0
        self._n_preempted = 0
        self._n_preempt_swap = 0
        self._n_preempt_replay = 0
        self._n_migrated_out = 0
        self._n_migrated_in = 0
        self._n_cow = 0
        self._n_forks = 0
        self._tick_no = 0
        self._diverging = False
        # Health is written from the tick and from the stall watchdog's
        # thread: every change takes this lock.
        self._health_lock = threading.RLock()

        eid = self.engine_id
        self._lg_health = _telemetry.gauge("serve.health", engine=eid)
        self._lg_est_ttft = _telemetry.gauge("serve.est_ttft_s", engine=eid)
        self._lg_running = _telemetry.gauge("serve.running_slots", engine=eid)
        self._h_queue_wait = _telemetry.histogram("serve.queue_wait_s", engine=eid)
        self._h_prefill = _telemetry.histogram("serve.prefill_s", engine=eid)
        self._h_ttft = _telemetry.histogram("serve.ttft_s", engine=eid)
        self._h_tpot = _telemetry.histogram("serve.tpot_s", engine=eid)
        self._h_outage = _telemetry.histogram("serve.preempt_outage_s", engine=eid)
        self._lg_role = _telemetry.gauge("serve.role", engine=eid)
        self._lg_role.set(self.role)

        self._drain_t0: Optional[float] = None
        self._drain_sp = None
        self._handle_preemption = handle_preemption
        self._handlers_preexisting = _preemption.installed()
        if handle_preemption:
            _preemption.install()
        self._health = Health.STARTING
        _G_HEALTH.set(self._health.value)
        self._lg_health.set(self._health.value)

        # Audit plane, validated before anything below registers the engine
        # with a plane that only _finish_drain would release.
        if audit_sample is None:
            audit_sample = _audit.env_audit_sample()
        self._auditor: Optional[_audit.ShadowAuditor] = (
            _audit.ShadowAuditor(self, audit_sample) if audit_sample else None)

        # Model plane: bind the pool — every registered skeleton's page
        # geometry is validated against the live pool here, so an
        # incompatible model rejects the constructor.
        self.model_pool: Optional[ModelPool] = model_pool
        # Durability plane: claim the journal (geometry check, ownership
        # lock, config record) — a refused claim rejects the constructor.
        self._journal: Optional[RequestJournal] = None
        try:
            if model_pool is not None:
                model_pool._bind(self)
            if journal is not None:
                self._bind_journal(journal)
        except BaseException:
            if handle_preemption and not self._handlers_preexisting:
                _preemption.uninstall()
            raise
        # Ops plane: the per-tick attribution below (gauges, the time
        # plane's phase timer) runs only with a plane attached or
        # attribution forced on, so the default tick pays nothing.
        self._was_idle = False  # last tick's idleness (gauge-zeroing edge)
        self._g_occupancy = None  # per-tick gauges, minted on first use
        self._tick_timer: Optional[_timeplane.TickTimer] = None
        self._tp_state = None
        self._ops_plane: Optional[_ops.OpsPlane] = None
        if ops_port is None:
            ops_port = _ops.env_ops_port()
        if ops_port is not None:
            self._ops_plane = _ops.attach_engine(self, port=int(ops_port), config=ops_config)
        if _telemetry.events_enabled():
            _telemetry.event(
                "serve.engine_config", engine=self.engine_id, num_slots=num_slots,
                block_size=block_size, num_blocks=int(num_blocks),
                max_model_len=self.max_model_len, temperature=self.temperature,
                top_k=top_k, eos_id=eos_id, decode_chunk=self.decode_chunk,
                prefill_chunk=self.prefill_chunk,
                max_prefills_per_tick=max_prefills_per_tick, scheduler=scheduler,
                role=self.role, model_version=self.model_version,
            )
        # The HBM ledger, last (nothing after this raises, so every row is
        # balanced by _finish_drain): the model's parameters (once however
        # many engines share them), the decode copy (likewise), and this
        # engine's pool.
        _hold_weights_row(self._weights_key, module_nbytes(model))
        _hold_weights_row(self._decode_copy.owner, _perf.pytree_nbytes(self._weights))
        _perf.ledger.register("kv_pool", self._pool_nbytes, owner=self.engine_id)

    # ------------------------------------------------------------------
    # Request tracing

    def _event(self, name: str, req: Request, **attrs) -> None:
        """Emit one request-lifecycle event carrying the trace context;
        free for untraced requests."""
        if req.trace_id is None:
            return
        _telemetry.event(name, rid=req.trace_id, engine=self.engine_id, hop=req.hop, **attrs)

    def _trace_ctx(self, req: Request):
        if req.trace_id is None:
            return nullcontext()
        return _telemetry.tracing(rid=req.trace_id, engine=self.engine_id, hop=req.hop)

    # ------------------------------------------------------------------
    # Submission / draining

    def submit(
        self,
        prompt,
        *,
        max_new_tokens: int,
        key: Any = None,
        deadline_s: Optional[float] = None,
        tenant: str = "default",
        priority: int = 0,
        model: Optional[str] = None,
        n: int = 1,
        trace_id: Optional[str] = None,
        hop: int = 0,
        _audit_of: Optional[str] = None,
    ) -> RequestHandle:
        """Queue a request; returns its streaming handle.

        ``key``: an int seed or two 32-bit words — the key a solo
        ``generate(model, prompt[None], key=...)`` takes, for token
        parity.  Default: the request id.  ``deadline_s``: wall-clock
        budget from submission, observed at chunk boundaries (and, under
        QoS, earliest-deadline-first within a (class, tenant) queue).
        ``tenant`` / ``priority``: the QoS context, carried (inert) under
        FIFO.

        ``model``: a tag registered on this engine's
        :class:`.modelpool.ModelPool`; the request decodes under that
        model's weights (materialized on demand), its ``model_version``
        seeding the digest and its tag namespacing the prefix hashes.
        None: the engine's own model.

        ``n``: parallel samples of one prompt.  Siblings share the
        parent's prompt pages (the prompt prefills once) and sibling
        ``i`` samples under :func:`~torchdistx_tpu_torch.models.generate.
        fold_key` ``(key, i)``, so it equals a solo submit with that key;
        ``n == 1`` leaves the key untouched.  The returned handle is
        sibling 0; ``handle.siblings`` lists all ``n`` in index order.

        A request that could never run (oversized for ``max_model_len``,
        or needing more pages than the engine owns) raises ``ValueError``
        here.  Raises :class:`.lifecycle.EngineDraining` when draining or
        stopped, and sheds per ``shed_policy`` when overloaded.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt) + max_new_tokens
        if total > self.max_model_len:
            raise ValueError(f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                             f" = {total} exceeds max_model_len ({self.max_model_len})")
        if blocks_needed(total, self.block_size) > self.allocator.capacity:
            raise ValueError("request needs more pages than the engine owns "
                             f"({blocks_needed(total, self.block_size)} > "
                             f"{self.allocator.capacity}); raise num_blocks")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")
        tenant = str(tenant)
        if not tenant:
            raise ValueError("tenant must be a non-empty string")
        priority = int(priority)
        n = int(n)
        if n < 1:
            raise ValueError("n must be >= 1")
        # Model and key resolution BEFORE any shedding side effect: a bad
        # tag or a malformed key must raise without having killed a
        # drop-oldest victim.
        model = DEFAULT_MODEL if model is None else str(model)
        pool_entry = None
        if model != DEFAULT_MODEL:
            if self.model_pool is None:
                raise ValueError(f"submit(model={model!r}) needs an Engine constructed "
                                 "with model_pool=ModelPool(...)")
            if model not in self.model_pool:
                raise ValueError(f"model {model!r} is not registered on this engine's "
                                 f"pool; known tags: {self.model_pool.tags()}")
            pool_entry = self.model_pool._entries[model]
        model_version = (pool_entry.model_version if pool_entry is not None
                         else self.model_version)
        key = _audit.canonical_key(self._next_rid if key is None else key)
        if self._health in (Health.DRAINING, Health.STOPPED):
            raise EngineDraining(f"engine is {self._health.value}; submit to another replica")
        if pool_entry is not None:
            # Demand noted now: the weights can load while the request
            # waits its turn.
            self.model_pool._touch(model)
            if not pool_entry.ready:
                self._materialize_wanted[model] = None
        # Prefill cost in chunks (a prefix-cache hit shrinks the suffix;
        # probe only, the authoritative match happens at admission).
        suffix = len(prompt)
        hashes = None
        if self.prefix is not None:
            hashes = page_hashes(prompt, self.block_size,
                                 pool_entry.namespace if pool_entry is not None else b"")
            suffix = max(1, len(prompt) - self.prefix.probe(hashes) * self.block_size)
        n_chunks = -(-suffix // self.prefill_chunk)
        if self.detector.overloaded(
            len(self.scheduler), self.max_prefills_per_tick,
            queued_chunks=self._pending_prefill_chunks() + n_chunks - 1,
        ):
            self._set_health(Health.OVERLOADED)
            if self.shed_policy == "reject-new":
                _T_SHED.add()
                self._n_shed += 1
                raise EngineOverloaded(
                    f"engine overloaded (queue={len(self.scheduler)}, est_ttft="
                    f"{self.est_ttft_s():.3f}s); retry with backoff")
            if self.shed_policy == "by-priority":
                # Victim = lowest class, youngest first, strictly below the
                # arrival's; an arrival that is itself the lowest waiting
                # class is the one shed.  An empty queue admits it.
                victim = self.scheduler.shed_lowest(below_priority=priority)
                if victim is not None:
                    _T_SHED.add()
                    self._n_shed += 1
                    victim.handle._fail(EngineOverloaded(
                        f"request {victim.rid} (priority={victim.priority}) shed under "
                        "load (by-priority)"))
                elif len(self.scheduler):
                    raise EngineOverloaded(
                        "engine overloaded and the arriving request is the lowest "
                        f"waiting class (priority={priority}); retry with backoff")
            else:
                victim = self.scheduler.shed_oldest()
                if victim is not None:
                    _T_SHED.add()
                    self._n_shed += 1
                    victim.handle._fail(EngineOverloaded(
                        f"request {victim.rid} shed under load (drop-oldest)"))

        deadline = time.perf_counter() + deadline_s if deadline_s is not None else None
        handles: list = []
        reqs: list = []
        parent_rid = self._next_rid
        for i in range(n):
            rid = self._next_rid
            self._next_rid += 1
            # Sibling key schedule: fold_key(base, i) for every group
            # member, and the digest is built from the folded key; n == 1
            # keeps the caller's key.
            k = key if n == 1 else fold_key(key, i)
            handle = RequestHandle(self, rid)
            tid = trace_id
            if tid is None:
                if _telemetry.events_enabled():
                    tid = f"{self.engine_id}-r{rid}"
            elif i > 0:
                tid = f"{trace_id}.f{i}"
            req = Request(
                rid, prompt, int(max_new_tokens), k, handle, deadline=deadline,
                # Siblings ride the parent's prompt pages: their marginal
                # prefill is one last-token chunk.
                n_chunks=n_chunks if i == 0 else 1, hashes=hashes, tenant=tenant,
                priority=priority, trace_id=tid, hop=int(hop),
                digest=_audit.DeterminismDigest(prompt, k), audit_of=_audit_of,
                model_tag=model, model_version=model_version,
                fork_of=None if i == 0 else parent_rid, fork_index=i,
            )
            handle._req = req
            extra = {}
            if tid is not None:
                extra["prompt"] = [int(t) for t in prompt]
                extra["key"] = [int(kk) for kk in k]
                if _audit_of is not None:
                    extra["audit_of"] = _audit_of
            if model != DEFAULT_MODEL:
                extra["model"] = model
            if n > 1:
                extra["n"] = n
                extra["fork_index"] = i
            self._event("req.submitted", req, n_prompt=len(prompt),
                        max_new=int(max_new_tokens), tenant=tenant, priority=priority,
                        deadline_s=deadline_s, n_chunks=req.n_chunks, **extra)
            handles.append(handle)
            reqs.append(req)
        if n > 1:
            self._n_forks += n - 1
            _T_FORKS.add(n - 1)
            self._fork_groups[parent_rid] = reqs[1:]
            for h in handles:
                h.siblings = list(handles)
        for req in reqs:
            if self._journal is not None and req.audit_of is None:
                # Audit replays are shadow traffic: resuming one cold would
                # re-audit a stream that no longer exists.
                self._journal_admit(req)
            self.scheduler.push(req)
            self._event("req.queued", req, queue_depth=len(self.scheduler))
            _T_REQUESTS.add()
            if pool_entry is not None:
                self.model_pool._note_request(model)
        return handles[0]

    def drain(self) -> None:
        """Step until every submitted request has finished, shadow audits
        included."""
        while len(self.scheduler) or self._n_running() or self.audit_backlog():
            self.step()

    def audit_backlog(self) -> int:
        """Shadow audits sampled but not yet submitted (0 with auditing
        off); in-flight ones sit in the queue and slots."""
        return 0 if self._auditor is None else self._auditor.backlog()

    def health(self) -> Health:
        """Current :class:`.lifecycle.Health` state."""
        return self._health

    def est_ttft_s(self) -> float:
        """Estimated wait-for-prefill of a request arriving now (the
        per-engine value behind the process-global gauge)."""
        return self.detector.est_ttft_s(self._pending_prefill_chunks(),
                                        self.max_prefills_per_tick)

    def _pending_prefill_chunks(self) -> int:
        """Prefill work ahead of a new arrival, in chunks: the waiting
        queue's estimates plus every mid-prefill slot's remainder."""
        pending = self.scheduler.pending_prefill_chunks()
        for slot in self._prefill_q:
            req = self._slot_req[slot]
            if req is not None:
                left = max(1, req.replay_len() - req.prefill_pos)
                pending += -(-left // self.prefill_chunk)
        return pending

    # ------------------------------------------------------------------
    # Model plane

    def _model_ready(self, req: Request) -> bool:
        """Admission gate: can ``req``'s model serve right now?  A cold
        pool model holds the queue head WITHOUT popping it, and notes the
        demand, so the materialize phase loads the weights out-of-band."""
        if req.model_tag == DEFAULT_MODEL:
            return True
        entry = self.model_pool._entries.get(req.model_tag)
        if entry is None or entry.ready:
            return True
        self._materialize_wanted.setdefault(req.model_tag, None)
        self.model_pool._note_stall(req.model_tag)
        return False

    def _page_need(self, req: Request) -> int:
        """Admission page reservation for ``req``: a fork sibling with a
        live donor charges only its marginal pages; everything else the
        full quota."""
        n_total = blocks_needed(req.cache_tokens, self.block_size)
        if req.fork_of is not None and not req.handle._tokens:
            donor = self._fork_donors.get(req.fork_of)
            if donor is not None:
                return max(0, n_total - len(donor))
        return n_total

    def _model_ctx(self, tag: str) -> tuple:
        """``(module, decode weights)`` a dispatch for ``tag`` runs under.
        Pool models must be resident: admission gates on residency and
        eviction refuses models with live slots, so a miss here means
        external interference — fail loudly."""
        if tag == DEFAULT_MODEL:
            return self.model, self._weights
        entry = self.model_pool._entries[tag]
        if entry.model is None:
            raise RuntimeError(f"model {tag!r} lost its weights with live work on the "
                               "engine (evicted externally mid-flight?)")
        return entry.model, entry.weights

    def _model_in_use(self, tag: str) -> bool:
        """True while any slot — running, prefilling, or swapped out —
        serves ``tag``: the model-pool eviction pin."""
        return any(req is not None and req.model_tag == tag for req in self._slot_req)

    def _materialize_phase(self) -> None:
        """Materialize the oldest demanded cold model, ONE per tick.  A
        transient failure (``serve.materialize`` ``io``/``nan``) leaves
        the skeleton untouched and the demand queued: the next tick
        retries.  Anything else propagates out of ``step()``."""
        tag = next(iter(self._materialize_wanted))
        try:
            self.model_pool.ensure(tag)
        except (KeyboardInterrupt, SystemExit, faults.FatalInjectedFault):
            raise
        except OSError:
            self.model_pool.materialize_retries += 1
            return
        self._materialize_wanted.pop(tag, None)

    def _sweep_fork_donors(self) -> None:
        """Release a fork group's donor pages once every sibling is
        terminal — nothing will map them again."""
        if not self._fork_groups:
            return
        for gid in list(self._fork_groups):
            if all(req.handle._done for req in self._fork_groups[gid]):
                donor = self._fork_donors.pop(gid, None)
                if donor:
                    self.allocator.free(donor)
                del self._fork_groups[gid]

    def begin_drain(self) -> None:
        """Start a graceful drain now, without a preemption signal: the
        path a SIGTERM takes.  No-op when already DRAINING or STOPPED."""
        if self._health not in (Health.DRAINING, Health.STOPPED):
            self._begin_drain()

    def _set_health(self, health: Health) -> None:
        with self._health_lock:
            if health is not self._health:
                self._health = health
                _G_HEALTH.set(health.value)
                self._lg_health.set(health.value)

    def _n_running(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _n_decoding(self) -> int:
        """Slots in the decode batch (occupied, past their prefill, and
        not swapped out to host)."""
        return sum(r is not None for i, r in enumerate(self._slot_req)
                   if i not in self._prefill_q and i not in self._swapped)

    # ------------------------------------------------------------------
    # The engine tick

    @torch.no_grad()
    def step(self) -> None:
        """One tick: act on preemption, reap expired/cancelled requests,
        admit, advance prefills (up to ``max_prefills_per_tick`` chunks),
        then one decode chunk over the running slots."""
        if self._health is Health.STOPPED:
            # Raising keeps a stray handle.tokens() loop from spinning a
            # dead engine forever.
            raise EngineDraining("engine is stopped")
        t0 = time.perf_counter()
        # The ops-plane gate, read once a tick: one attribute read and one
        # module-global read are the whole cost of the disabled path.
        ops_on = self._ops_plane is not None or _ops._TICK_ATTRIBUTION
        timer = self._tick_timer = _timeplane.TickTimer(t0) if ops_on else None
        churn0 = (self._n_preempt_swap + self._n_preempt_replay + self._n_recoveries
                  if ops_on else 0)
        if timer is not None:
            timer.begin("schedule")
        if self._health is not Health.DRAINING and _preemption.requested():
            self._begin_drain()
        self._preempted_this_tick = False
        self._reap_phase()
        if self._auditor is not None:
            # Before admission, so an audit submitted on an idle engine
            # admits this same tick; the pump yields to waiting user work.
            if timer is not None:
                timer.begin("audit_pump")
            self._auditor.pump()
            if timer is not None:
                timer.begin("schedule")
        if self._health is not Health.DRAINING:
            self._admit_phase()
        # Swapped slots resume even while DRAINING (in-flight work), but
        # never on a tick that just preempted.
        if self._swapped:
            self._swap_in_phase()
        # Chunks advance even while DRAINING: a slot mid-prefill is
        # in-flight work the drain contract promises to finish.
        if timer is not None:
            timer.begin("prefill_dispatch")
        chunks = self._advance_prefills()
        committed = self._decode_phase()
        if timer is not None:
            timer.begin("schedule")
        if self._fork_groups:
            # A group whose last sibling retired in this tick's decode
            # frees its donor now: drain() settles to zero pages the tick
            # the work completes.
            self._sweep_fork_donors()
        if self._materialize_wanted and self._health is not Health.DRAINING:
            # One cold model's weight demand, strictly AFTER this tick's
            # decode dispatch: the stall lands between ticks.
            self._materialize_phase()
        if self._health is Health.DRAINING:
            self._drain_tick()
        elif self._health is Health.STARTING:
            self._set_health(Health.READY)
        elif (
            self._health is Health.OVERLOADED
            and not self._diverging
            and not self.detector.overloaded(
                len(self.scheduler), self.max_prefills_per_tick,
                queued_chunks=self._pending_prefill_chunks(),
            )
        ):
            self._set_health(Health.READY)
        if self._journal is not None:
            # Group commit (fsync='tick'): one durability point covers
            # every record this tick appended; never raises.
            self._journal.sync()
        tick_s = time.perf_counter() - t0
        self.detector.observe_tick(tick_s)
        self._tick_no += 1
        # A fully idle tick publishes no attribution (idle readings would
        # dilute occupancy and goodput); the first idle tick zeroes the
        # per-tick rate gauges once.
        idle = (committed == 0 and chunks == 0 and not self._swapped
                and not len(self.scheduler) and self._n_running() == 0
                and self._health is not Health.STOPPED)
        if idle:
            _T_IDLE_TICKS.add()
            if ops_on and not self._was_idle and self._g_occupancy is not None:
                self._g_occupancy.set(0)
                self._g_prefill_budget.set(0)
                self._g_churn.set(0)
                self._g_goodput.set(0)
        elif ops_on:
            self._tick_telemetry(tick_s, chunks, committed, churn0)
        if timer is not None:
            timer.end()
            self._tick_timer = None
            # A drain-completing tick must not re-mint the rows
            # _finish_drain just pruned.
            if self._health is not Health.STOPPED:
                _timeplane.publish_tick(self, timer, tick_s, idle=idle)
        self._was_idle = idle
        # A tick that completed the drain must not re-write the routing
        # gauges _finish_drain just cleared.
        if self._health is not Health.STOPPED:
            _G_HEALTH.set(self._health.value)
            if self.detector.enabled:
                est = round(self.est_ttft_s(), 4)
                _G_EST_TTFT.set(est)
                self._lg_est_ttft.set(est)
        n_run = self._n_running()
        _G_RUNNING.set(n_run)
        self._lg_running.set(n_run)

    # ------------------------------------------------------------------
    # Ops plane: per-tick attribution and the watchdog hook

    def _tick_telemetry(self, tick_s: float, chunks: int, committed: int,
                        churn0: int) -> None:
        """Per-tick utilization attribution, only with the ops plane
        attached or attribution forced on; one ``{engine=}``-labelled
        reading a signal a tick: ``serve.occupancy`` (decode slots in use /
        total), ``serve.prefill_budget`` (chunks dispatched / the tick's
        budget), ``serve.page_util``, ``serve.churn`` (preemptions, swaps and
        recoveries this tick), ``serve.goodput`` (committed tokens a
        tick-second), the ``serve.tick_s`` histogram, and
        ``mem.pool_fragmentation`` (every 16th tick) with a ledger sync."""
        if self._g_occupancy is None:
            eid = self.engine_id
            self._g_occupancy = _telemetry.gauge("serve.occupancy", engine=eid)
            self._g_prefill_budget = _telemetry.gauge("serve.prefill_budget", engine=eid)
            self._g_page_util = _telemetry.gauge("serve.page_util", engine=eid)
            self._g_churn = _telemetry.gauge("serve.churn", engine=eid)
            self._g_goodput = _telemetry.gauge("serve.goodput", engine=eid)
            self._h_tick = _telemetry.histogram("serve.tick_s", engine=eid)
            self._g_frag = _telemetry.gauge("mem.pool_fragmentation", engine=eid)
        if self._tick_no % 16 == 1:  # tick_no pre-incremented: the first tick writes
            self._g_frag.set(round(self.allocator.fragmentation(), 4))
        self._ledger_sync()
        self._g_occupancy.set(round(self._n_decoding() / self.num_slots, 4))
        self._g_prefill_budget.set(round(chunks / self.max_prefills_per_tick, 4))
        self._g_page_util.set(round(self.allocator.utilization(), 4))
        self._g_churn.set(self._n_preempt_swap + self._n_preempt_replay + self._n_recoveries
                          - churn0)
        self._g_goodput.set(round(committed / tick_s, 1) if tick_s > 0 and committed else 0)
        self._h_tick.observe(tick_s)

    def _mark_stalled(self) -> None:
        """Stall-watchdog hook (:class:`~torchdistx_tpu_torch.telemetry.ops.
        StallWatchdog`, on its own thread): a wedged engine reads
        OVERLOADED so a router routes around it; its own next tick restores
        READY through the overload re-check.  Host state only, under the
        health lock."""
        with self._health_lock:
            if self._health in (Health.STARTING, Health.READY):
                self._set_health(Health.OVERLOADED)

    def _mark_diverging(self) -> None:
        """Divergence hook (:func:`~torchdistx_tpu_torch.telemetry.audit.
        record_divergence`): latch ``serve.diverging{engine=}`` and read
        OVERLOADED until :meth:`clear_divergence`."""
        self._diverging = True
        _telemetry.gauge("serve.diverging", engine=self.engine_id).set(1)
        with self._health_lock:
            if self._health in (Health.STARTING, Health.READY):
                self._set_health(Health.OVERLOADED)

    def clear_divergence(self) -> None:
        """Operator acknowledgement: drop the divergence latch."""
        self._diverging = False
        _telemetry.gauge("serve.diverging", engine=self.engine_id).set(0)

    # ------------------------------------------------------------------
    # The HBM ledger: sync + OOM forensics

    def _ledger_sync(self) -> None:
        """Refresh this engine's live ledger accounts: host-resident swap
        staging and the pages the prefix index holds (a view inside
        ``kv_pool`` — attribution, not additional device bytes)."""
        _perf.ledger.register("kv_swap_host", self._swap_host_bytes, owner=self.engine_id)
        if self.prefix is not None:
            _perf.ledger.register("prefix_cache_held", len(self.prefix) * self._page_nbytes,
                                  owner=self.engine_id)

    def _oom_check(self, err: BaseException, site: str) -> None:
        """When a failed device call is a device OOM, snapshot the ledger
        into the flight record: the post-mortem reads what held the
        memory (weights vs pool vs swap vs cached prefixes)."""
        if _perf.is_oom(err):
            self._ledger_sync()
            _perf.oom_dump("device_oom", engine=self.engine_id, site=site,
                           error=f"{type(err).__name__}: {err}",
                           pool_fragmentation=round(self.allocator.fragmentation(), 4))

    def _pool_exhausted(self, site: str, need: int) -> None:
        """Page-pool exhaustion forensics: a reservation the admission
        quota promised could not be met.  The same ledger-carrying flight
        dump as a device OOM, under ``reason="pool_exhausted"``."""
        self._ledger_sync()
        _perf.oom_dump("pool_exhausted", engine=self.engine_id, site=site,
                       pages_needed=need, pages_free=self.allocator.num_free,
                       pages_in_use=self.allocator.num_in_use,
                       pool_fragmentation=round(self.allocator.fragmentation(), 4))

    # ------------------------------------------------------------------
    # Lifecycle: reap, drain

    def _reap_phase(self) -> None:
        """Chunk-boundary sweep: deadline expiries and cancellations,
        waiting and running both; pages release here."""
        now = time.perf_counter()
        expired, cancelled = self.scheduler.purge(now)
        for req in expired:
            self._n_expired += 1
            _T_EXPIRED.add()
            req.handle._fail(DeadlineExceeded(
                f"request {req.rid} expired in queue before prefill"))
        for req in cancelled:
            self._n_cancelled += 1
            _T_CANCELLED.add()
            req.handle._fail(RequestCancelled(f"request {req.rid} cancelled while queued"))
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            if req.handle._cancel_requested:
                self._n_cancelled += 1
                _T_CANCELLED.add()
                self._fail_running_slot(slot, RequestCancelled(f"request {req.rid} cancelled"))
            elif req.expired(now):
                self._n_expired += 1
                _T_EXPIRED.add()
                self._fail_running_slot(slot, DeadlineExceeded(
                    f"request {req.rid} exceeded its deadline after "
                    f"{self._emitted[slot]} tokens"))
        self._sweep_fork_donors()

    def _fail_running_slot(self, slot: int, error) -> None:
        """Abort a running slot: pages back, handle failed typed, slot
        cleared (reap, drain deadline and close all route here).  A
        swapped slot owns no pages: its host buffer is discarded and the
        allocator's swap account settled instead."""
        req = self._slot_req[slot]
        if slot in self._swapped:
            self._discard_swapped(slot)
        elif req.blocks:
            self.allocator.free(req.blocks)
        req.blocks = None
        req.handle._fail(error)
        self._clear_slot(slot)

    def _begin_drain(self) -> None:
        """Preemption observed: close admission, flush the queue with a
        retryable error, and give in-flight work ``drain_deadline_s``."""
        self._set_health(Health.DRAINING)
        self._drain_t0 = time.perf_counter()
        self._drain_sp = _telemetry.start_span(
            "serve.drain", detached=True, n_running=self._n_running(),
            n_waiting=len(self.scheduler))
        _preemption.clear()
        # Pending weight demand dies with the queue it served.
        self._materialize_wanted.clear()
        for req in self.scheduler.flush():
            self._n_preempted += 1
            _T_PREEMPTED.add()
            req.handle._fail(RequestPreempted(
                f"request {req.rid} flushed before prefill: engine "
                "draining; retry against another replica", resumable=True))

    def _drain_tick(self) -> None:
        if self._n_running() == 0:
            self._finish_drain(timed_out=False)
            return
        if time.perf_counter() - self._drain_t0 > self.drain_deadline_s:
            for slot, req in enumerate(self._slot_req):
                if req is None:
                    continue
                self._n_preempted += 1
                _T_PREEMPTED.add()
                self._fail_running_slot(slot, RequestPreempted(
                    f"request {req.rid} preempted mid-stream: drain deadline "
                    f"({self.drain_deadline_s}s) expired after {self._emitted[slot]} "
                    "tokens; retry against another replica",
                    resumable=self._emitted[slot] == 0))
            self._finish_drain(timed_out=True)

    def _finish_drain(self, *, timed_out: bool) -> None:
        if self._drain_sp is not None:
            self._drain_sp.end(timed_out=timed_out)
            self._drain_sp = None
        # Fork donors die with the engine, as cached prefixes do.
        for donor in self._fork_donors.values():
            self.allocator.free(donor)
        self._fork_donors.clear()
        self._fork_groups.clear()
        if self.prefix is not None:
            # Cached prefixes die with the engine: a stopped engine owns
            # no pages.
            self.prefix.release(self.allocator)
        self._set_health(Health.STOPPED)
        # The serving gauges are process-global: a stopped engine must
        # not leave its last readings behind for a router to act on.
        _G_HEALTH.set(None)
        _G_EST_TTFT.set(None)
        if self._handle_preemption and not self._handlers_preexisting:
            _preemption.uninstall()
        # Ops-plane teardown: the watchdog stops and the /healthz entry
        # goes; the plane's last engine (unretained) shuts the listener.
        if self._ops_plane is not None:
            self._ops_plane.unwatch(self)
            self._ops_plane = None
        for name in ("serve.diverging", "serve.queue_depth", "serve.role"):
            _telemetry.remove(name, engine=self.engine_id)
        # Time-plane teardown: no serve.tick_phase_s row survives the engine.
        self._tp_state = None
        _timeplane.prune_engine(self.engine_id)
        # Ledger teardown: the pool, swap, prefix and decode-weights rows
        # leave with the engine; the parameters' row when the LAST engine
        # over the model stops.
        for component in ("kv_pool", "kv_swap_host", "prefix_cache_held"):
            _perf.ledger.unregister(component, owner=self.engine_id)
        _release_weights_row(self._weights_key)
        _release_weights_row(self._decode_copy.owner)
        # Durability teardown: the close above journaled every in-flight
        # stream's typed retirement, so the sealed journal records a
        # fully retired run; close flushes, fsyncs and releases the lock.
        if self._journal is not None:
            self._journal.close()
        # Model-plane teardown: pool models' graphs, weights, ledger rows
        # and labeled families leave with the engine.
        if self.model_pool is not None:
            self.model_pool._close()
        # Device teardown: the decode graphs (with their private memory),
        # their input buffers and the page pool go now, so a retired
        # replica's bytes return to the allocator even while a handle still
        # references the engine.  The shared prep_decode copy goes with the
        # last engine holding it.
        for tag in {g[-1] for g in self._decoders}:
            self._drop_decoders(tag)
        self._cache = None
        self._weights = None
        self._decode_copy = None
        if self._auditor is not None:
            # Replays failed by the close settle now (no later pump will):
            # counted aborted, as JAX's docstring has it.
            self._auditor._reap_failed()

    def close(self) -> None:
        """Stop the engine now: fail queued and in-flight work with
        retryable typed errors, release every page, and restore the
        signal handlers this engine installed.  Idempotent."""
        if self._health is Health.STOPPED:
            return
        for req in self.scheduler.flush():
            self._n_preempted += 1
            _T_PREEMPTED.add()
            req.handle._fail(EngineDraining(
                f"request {req.rid} rejected: engine closed before prefill; "
                "retry against another replica"))
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._n_preempted += 1
            _T_PREEMPTED.add()
            self._fail_running_slot(slot, RequestPreempted(
                f"request {req.rid} aborted after {self._emitted[slot]} tokens: engine "
                "closed; retry against another replica",
                resumable=self._emitted[slot] == 0))
        self._finish_drain(timed_out=False)

    # ------------------------------------------------------------------
    # Admission

    def _admit_phase(self) -> None:
        if not len(self.scheduler):
            return
        if self._prefill_q:
            if self._qos:
                # A strictly-higher-class head must not wait out a lower
                # class's chunked prefill: abort-and-requeue those
                # prefills (no committed tokens: the cheap end of replay).
                self._preempt_prefills()
            if self._prefill_q:
                # Prefill-busy: popping more requests would only park
                # them on pages with zero progress (chunks drain strictly
                # FIFO).
                return
        if self._qos:
            # Before admission reads the free lists: a waiting request of
            # a strictly higher class may preempt running lower ones, the
            # same tick.
            self._qos_preempt()
        free_slots = [i for i, r in enumerate(self._slot_req) if r is None]
        if not free_slots:
            # Slot-bound stall with work waiting: counted by the
            # scheduler like a page-bound one.
            self.scheduler.pop_admissible(0, self.allocator, self.block_size)
            return
        self._admit_no += 1
        try:
            kind = faults.fire("serve.admit", self._admit_no)
        except OSError:
            # Transient: nothing was popped or allocated; the next tick
            # retries the same FIFO head.
            _T_ADMIT_RETRIES.add()
            return
        if kind is not None:  # a poisoned admission tick: skip it
            _T_ADMIT_RETRIES.add()
            return
        batch = self.scheduler.pop_admissible(
            len(free_slots), self.allocator, self.block_size, reclaim=self._reclaim_pages,
            need=self._page_need, ready=self._model_ready)
        for i, req in enumerate(batch):
            try:
                self._start_prefill(free_slots[i], req)
            except (KeyboardInterrupt, SystemExit):
                self.scheduler.requeue([req] + batch[i + 1:])
                raise
            except Exception:
                # Host-side reservation failure (rolled back): the request
                # and the rest of the batch return to the FIFO head.
                _T_PREFILL_RETRIES.add()
                self.scheduler.requeue([req] + batch[i + 1:])
                return

    # ------------------------------------------------------------------
    # QoS preemption: swap-to-host / drop-and-replay (scheduler="qos")

    def _preempt_prefills(self) -> None:
        """Abort mid-prefill slots when the waiting head outranks every
        one of them: their pages return, they re-enter the QoS queues
        (losing only the chunks already dispatched), and this tick's
        prefill budget goes to the higher class.  Nothing happens while
        any prefilling slot is the head's class or above."""
        head = self.scheduler.peek()
        if head is None or not self._model_ready(head):
            return
        if not all(self._slot_req[slot].priority < head.priority for slot in self._prefill_q):
            return
        for slot in list(self._prefill_q):
            req = self._abort_prefill(slot)
            req.n_chunks = self._replay_chunks(req)
            req.preempt_t = time.perf_counter()
            self._event("req.preempted", req, mechanism="replay", reason="prefill_requeue",
                        n_tokens=0)
            self.scheduler.push(req)
            self._n_preempt_replay += 1
            _T_PREEMPT_REPLAY.add()
        self._preempted_this_tick = True

    def _replay_chunks(self, req: Request) -> int:
        """A preemption victim's resume cost in chunks: what the
        re-prefill of prompt + generated-so-far will dispatch, minus the
        prefix the index still holds."""
        seq_len = req.replay_len()
        cached = 0
        if self.prefix is not None and req.hashes:
            cached = self.prefix.probe(req.hashes) * self.block_size
        return -(-max(1, seq_len - cached) // self.prefill_chunk)

    def _qos_preempt(self) -> None:
        """Make room for a waiting higher-class request by preempting
        running strictly-lower-class streams, lowest class first, youngest
        first.  Slot pressure (every slot occupied): drop-and-replay on
        one victim.  Page pressure (the head's reservation exceeds the
        free list): ``preempt_mechanism`` per victim until it fits."""
        head = self.scheduler.peek()
        if head is None or not self._model_ready(head):
            return
        victims = sorted(
            (slot for slot, req in enumerate(self._slot_req)
             if req is not None and req.priority < head.priority),
            key=lambda s: (self._slot_req[s].priority, -self._slot_req[s].rid))
        if not victims:
            return
        if all(r is not None for r in self._slot_req):
            # Only replay frees a slot (a swapped slot stays parked).
            if not self._preempt_slot(victims.pop(0), mechanism="replay"):
                return
        need = blocks_needed(head.cache_tokens, self.block_size)
        if need > self.allocator.num_free:
            self._reclaim_pages(need - self.allocator.num_free)
        while need > self.allocator.num_free and victims:
            slot = victims.pop(0)
            if slot in self._swapped:
                continue  # its private pages are already on host
            if not self._preempt_slot(slot, mechanism=self.preempt_mechanism):
                return

    def _preempt_slot(self, slot: int, mechanism: str) -> bool:
        """Preempt one running slot.  ``"swap"``: its private pages go to
        pinned host tensors and free; the slot parks through its decode
        inputs alone (table 0 → the trash page, ``done=True``), so the
        decode graph is neither touched nor recaptured.  ``"replay"``:
        pages release and the request re-enters the QoS queues carrying
        its committed tokens.  A failed swap-out falls back to replay
        (the gather is read-only), except a device fault, which goes to
        the supervisor; False then (the slot map was rebuilt)."""
        req = self._slot_req[slot]
        self._preempted_this_tick = True
        if mechanism == "swap" and slot not in self._swapped:
            # Only PRIVATE pages (refcount 1) go to host: a shared page
            # stays resident on its other references, and the request
            # keeps its own, so sharing survives the preemption.
            layout = [blk if self.allocator.refcount(blk) > 1 else None for blk in req.blocks]
            priv = [blk for blk, kept in zip(req.blocks, layout) if kept is None]
            self._swap_no += 1
            try:
                kind = faults.fire("serve.swap", self._swap_no)
                if kind is not None:
                    raise faults.InjectedFault(f"poisoned swap attempt ({kind})")
                host = swap_out_pages(self._cache, priv, sync=False) if priv else None
            except (KeyboardInterrupt, SystemExit, faults.FatalInjectedFault):
                raise
            except Exception as err:
                self._oom_check(err, "serve.swap_out")
                if _device_fault(err):
                    self._supervise_recovery(err)
                    return False
                # Read-only gather: drop-and-replay below is safe.
            else:
                self.allocator.swap_out(priv)
                self._swapped[slot] = (host, layout)
                if host is not None:
                    self._swap_host_bytes += _perf.pytree_nbytes(host)
                req.blocks = None
                self._tables[slot] = 0
                self._done[slot] = True
                self._n_preempt_swap += 1
                _T_PREEMPT_SWAP.add()
                req.preempt_t = time.perf_counter()
                self._event("req.swapped", req, n_private=len(priv),
                            n_shared=len(layout) - len(priv),
                            n_tokens=len(req.handle._tokens))
                return True
        # Drop-and-replay (the swap fallback lands here too).
        if slot in self._swapped:
            self._discard_swapped(slot)
        elif req.blocks:
            self.allocator.free(req.blocks)
        self._reset_prefill_state(req)
        req.n_chunks = self._replay_chunks(req)
        self._clear_slot(slot)
        req.preempt_t = time.perf_counter()
        self._event("req.preempted", req, mechanism="replay", reason="pressure",
                    n_tokens=len(req.handle._tokens))
        self.scheduler.push(req)
        self._n_preempt_replay += 1
        _T_PREEMPT_REPLAY.add()
        return True

    def _discard_swapped(self, slot: int) -> None:
        """Settle a swapped slot's accounts without resuming it (cancelled,
        failed, or re-preempted to replay): the kept shared pages'
        references release, the host buffer is dropped, and the allocator
        forgets the host-resident rows."""
        host, layout = self._swapped.pop(slot)
        if host is not None:
            self._swap_host_bytes -= _perf.pytree_nbytes(host)
        kept = [blk for blk in layout if blk is not None]
        if kept:
            self.allocator.free(kept)
        self.allocator.drop_swapped(sum(1 for blk in layout if blk is None))

    def _swap_in_phase(self) -> None:
        """Bring swapped slots back when pressure subsides: highest class
        first, oldest first.  A swapped slot never jumps a waiting
        higher-class head and never resumes on the tick that just
        preempted.  The pages land (in place, ordered before the next
        decode on the compute stream) before the slot's inputs put it back
        in the decode batch."""
        if self._preempted_this_tick:
            return
        head = self.scheduler.peek() if self._qos else None
        for slot in sorted(self._swapped,
                           key=lambda s: (-self._slot_req[s].priority, self._slot_req[s].rid)):
            req = self._slot_req[slot]
            toks = req.handle._tokens
            if toks and not req.digest.matches_stream(req.prompt, req.key, toks,
                                                      req.model_version):
                # A corrupted committed buffer fails typed before the
                # pages come back.
                self._resume_diverged(slot, req, "swap-resume")
                continue
            host, layout = self._swapped[slot]
            n_priv = sum(1 for kept in layout if kept is None)
            reserve = 0
            if head is not None and head.priority > req.priority:
                reserve = blocks_needed(head.cache_tokens, self.block_size)
            short = n_priv + reserve - self.allocator.num_free
            if short > 0:
                self._reclaim_pages(short)
            if self.allocator.num_free - reserve < n_priv:
                continue
            pages = self.allocator.swap_in(n_priv)
            if pages is None:
                continue
            if n_priv:
                try:
                    swap_in_pages(self._cache, host, pages)
                except (KeyboardInterrupt, SystemExit, faults.FatalInjectedFault):
                    raise
                except Exception as err:
                    # The scatter writes the pool: the supervisor rebuilds
                    # it and replays everything, swapped slots included.
                    self._oom_check(err, "serve.swap_in")
                    self._swapped.pop(slot, None)
                    if host is not None:
                        self._swap_host_bytes -= _perf.pytree_nbytes(host)
                    self._supervise_recovery(err)
                    return
            del self._swapped[slot]
            if host is not None:
                self._swap_host_bytes -= _perf.pytree_nbytes(host)
            fresh = iter(pages)
            blocks = [kept if kept is not None else next(fresh) for kept in layout]
            req.blocks = blocks
            table = np.zeros((self._table_width,), np.int64)
            table[: len(blocks)] = blocks
            req.table = table
            self._tables[slot] = table
            self._done[slot] = False
            if req.preempt_t is not None:
                self._h_outage.observe(time.perf_counter() - req.preempt_t)
                req.preempt_t = None
            self._event("req.resumed", req, mechanism="swap", n_tokens=len(req.handle._tokens))

    # ------------------------------------------------------------------
    # Cross-engine stream migration

    def migratable_slots(self) -> list:
        """Slots whose stream can :meth:`migrate_out` right now: occupied,
        past prefill (committed tokens exist), resident on the device (not
        swapped to host), and not already terminal."""
        return [slot for slot, req in enumerate(self._slot_req)
                if req is not None and slot not in self._prefill_q
                and slot not in self._swapped and req.handle._tokens
                and not req.handle._done]

    def migrate_out(self, slot: int) -> dict:
        """Export one live decoding stream as a self-contained host
        snapshot a peer's :meth:`migrate_in` maps into its own pool
        mid-stream.

        EVERY page of the stream's table transfers, private and shared:
        the destination has no prefix entry for this prompt, so shared
        pages resolve into the snapshot.  The snapshot holds the pages as
        pinned host tensors (``"host"``), the page geometry, the model tag
        and version, the digest and ``n_tokens``.  Only after the copy
        lands does the source release its references, clear the slot and
        retire the stream from its journal as ``migrated``; the handle
        stays live.  Raises (``serve.migrate_out`` fault, copy failure)
        strictly BEFORE any source mutation: a failed export leaves the
        stream running here."""
        req = self._slot_req[slot]
        if req is None:
            raise ValueError(f"slot {slot} is idle; nothing to migrate")
        if slot in self._prefill_q or slot in self._swapped:
            raise ValueError(f"slot {slot} is not decoding on-device (mid-prefill or "
                             "swapped out); migrate only resident decode streams")
        toks = req.handle._tokens
        if not toks or req.handle._done:
            raise ValueError(f"request {req.rid} has no live committed stream to migrate")
        self._migrate_out_no += 1
        kind = faults.fire("serve.migrate_out", self._migrate_out_no)
        if kind is not None:
            raise faults.InjectedFault(f"poisoned migration export ({kind})")
        sp = _telemetry.start_span("serve.migrate_out", slot=slot, n_pages=len(req.blocks),
                                   n_tokens=len(toks))
        try:
            host = swap_out_pages(self._cache, req.blocks)
        except BaseException:
            sp.cancel()
            raise
        n_pages = len(req.blocks)
        snapshot = {
            "req": req,
            "host": host,
            "n_pages": n_pages,
            "geometry": pool_geometry(self._cache),
            "block_size": self.block_size,
            "model_tag": req.model_tag,
            "model_version": req.model_version,
            "src_engine": self.engine_id,
            "digest": req.digest.hexdigest(),
            "n_tokens": len(toks),
        }
        # Handoff point: nothing below fails — from here the snapshot owns
        # the stream's KV and the source owns nothing.
        self.allocator.free(req.blocks)
        req.blocks = None
        req.table = None
        req.preempt_t = time.perf_counter()  # outage clock: out → in
        self._event("req.migrated_out", req, n_pages=n_pages, n_tokens=len(toks))
        # Journal ownership transfer: the stream leaves THIS journal
        # retired (outcome=migrated) and enters the destination's as a
        # handoff admit — it lives in exactly one journal.
        self._journal_retire(req, outcome="migrated")
        self._clear_slot(slot)
        self._n_migrated_out += 1
        _T_MIGRATIONS_OUT.add()
        _T_MIGRATED_PAGES.add(n_pages)
        sp.end(n_pages=n_pages, n_tokens=len(toks))
        return snapshot

    def migrate_in(self, snapshot: dict) -> RequestHandle:
        """Map a :meth:`migrate_out` snapshot into this engine's pool and
        resume the stream mid-flight — zero recompute: the pages scatter
        in, the slot restores where the source left it, and the next
        decode step samples at the uninterrupted run's ``n``.

        Ordered so nothing can corrupt this pool or leak a page:
        (1) compatibility — weights version, page geometry and table fit
        are checked before anything allocates; a mismatch raises typed,
        retryable :class:`.lifecycle.MigrationIncompatible`; (2) the
        committed tokens re-hash against the digest (a mismatch is
        :class:`.lifecycle.DeterminismDiverged`); (3) capacity — a free
        slot and ``n_pages`` pages, else retryable
        :class:`.lifecycle.EngineOverloaded`; (4) the import — the
        ``serve.migrate_in`` fault site fires between allocation and
        scatter, and any failure frees the pages (a device fault goes to
        the supervisor) and re-raises.  Returns the handle, re-bound to
        this engine."""
        req = snapshot["req"]
        toks = list(req.handle._tokens)
        if req.handle._done:
            raise ValueError(f"request {req.rid} is already terminal; nothing to import")
        if self._health in (Health.DRAINING, Health.STOPPED):
            raise EngineDraining(f"engine is {self._health.value}; migrate to another replica")
        tag = snapshot.get("model_tag", DEFAULT_MODEL)
        if tag == DEFAULT_MODEL:
            local_version = self.model_version
        else:
            if self.model_pool is None or tag not in self.model_pool:
                raise MigrationIncompatible(
                    f"stream is on model {tag!r} but this engine's pool does not register "
                    "it; migrate to a replica that does")
            dst_entry = self.model_pool._entries[tag]
            if not dst_entry.ready:
                raise MigrationIncompatible(
                    f"model {tag!r} is registered here but not materialized; warm it "
                    "(ModelPool.ensure) before importing its streams")
            local_version = dst_entry.model_version
        if snapshot.get("model_version") != local_version:
            raise MigrationIncompatible(
                f"weights version mismatch: snapshot {snapshot.get('model_version')!r} != "
                f"engine {local_version!r} — a cross-version migration would interleave "
                "two models in one stream")
        if snapshot.get("block_size") != self.block_size:
            raise MigrationIncompatible(
                f"page size mismatch: snapshot block_size={snapshot.get('block_size')} != "
                f"engine block_size={self.block_size}")
        if snapshot.get("geometry") != pool_geometry(self._cache):
            raise MigrationIncompatible(
                "pool geometry mismatch (layers / page size / heads / head_dim / dtype); "
                "fall back to a key-pinned replay")
        n_pages = int(snapshot["n_pages"])
        if n_pages > self._table_width or req.cache_tokens > self.max_model_len:
            raise MigrationIncompatible(
                f"stream needs {n_pages} pages / {req.cache_tokens} positions but this "
                f"engine's table holds {self._table_width} pages ({self.max_model_len} "
                "positions)")
        if n_pages > self.allocator.capacity:
            raise MigrationIncompatible(f"stream needs {n_pages} pages but this engine owns "
                                        f"{self.allocator.capacity}")
        if toks and not req.digest.matches_stream(req.prompt, req.key, toks,
                                                  req.model_version):
            _audit.record_divergence(
                self, rid=req.trace_id, where="migrate-in",
                expected_digest=req.digest.hexdigest(),
                replayed_digest=_audit.DeterminismDigest.of_stream(
                    req.prompt, req.key, toks, req.model_version).hexdigest(),
                n_tokens=len(toks))
            err = DeterminismDiverged(
                f"request {req.rid} arrived with a committed stream that no longer matches "
                f"its determinism digest after {len(toks)} tokens")
            req.handle._fail(err)
            raise err
        slot = next((i for i, r in enumerate(self._slot_req) if r is None), None)
        if slot is None:
            raise EngineOverloaded("no free slot for the migrated stream; retry elsewhere")
        pages = self._alloc_pages(n_pages)
        if pages is None:
            self._pool_exhausted("serve.migrate_in", n_pages)
            raise EngineOverloaded(f"could not reserve {n_pages} pages for the migrated "
                                   "stream; retry elsewhere")
        self._migrate_in_no += 1
        sp = _telemetry.start_span("serve.migrate_in", slot=slot, n_pages=n_pages,
                                   n_tokens=len(toks), src=snapshot.get("src_engine"))
        try:
            kind = faults.fire("serve.migrate_in", self._migrate_in_no)
            if kind is not None:
                raise faults.InjectedFault(f"poisoned migration import ({kind})")
            swap_in_pages(self._cache, snapshot["host"], pages)
        except (KeyboardInterrupt, SystemExit, faults.FatalInjectedFault):
            sp.cancel()
            self.allocator.free(pages)
            raise
        except Exception as err:
            sp.cancel()
            if _device_fault(err):
                # The scatter may have written anywhere: the supervisor
                # rebuilds the pool and replays this engine's streams; the
                # arriving stream was never installed (its pages die with
                # the allocator reset) and the caller's fallback owns it.
                self._oom_check(err, "serve.migrate_in")
                self._supervise_recovery(err)
            else:
                self.allocator.free(pages)
            raise
        n_gen = len(toks)
        table = np.zeros((self._table_width,), np.int64)
        table[:n_pages] = pages
        req.blocks = list(pages)
        req.table = table
        req.handle._engine = self
        req.hop += 1  # a migration is a placement hop in the timeline
        self._install_slot(slot, req, toks[-1], len(req.prompt) + n_gen - 1, table,
                           n_gen=n_gen, emitted=n_gen)
        if req.preempt_t is not None:
            self._h_outage.observe(time.perf_counter() - req.preempt_t)
            req.preempt_t = None
        self._n_migrated_in += 1
        _T_MIGRATIONS_IN.add()
        self._event("req.migrated_in", req, n_pages=n_pages, n_tokens=n_gen,
                    src=snapshot.get("src_engine"))
        if self._journal is not None and req.audit_of is None:
            # The receiving half of the ownership transfer: a handoff admit
            # carrying the committed prefix and digest.
            self._journal_admit(req, tokens=toks)
        sp.end(n_pages=n_pages, n_tokens=n_gen)
        return req.handle

    # ------------------------------------------------------------------
    # Chunked prefill + the prefix cache

    def _reclaim_pages(self, n: int) -> int:
        """Evict up to ``n`` unreferenced cached-prefix pages (LRU)."""
        if self.prefix is None:
            return 0
        freed = self.prefix.evict(n, self.allocator)
        if freed:
            _T_PREFIX_EVICTIONS.add(freed)
        return freed

    def _alloc_pages(self, n: int) -> Optional[list]:
        """``allocator.alloc`` with the prefix cache as the fallback
        reserve."""
        if n == 0:
            return []
        got = self.allocator.alloc(n)
        if got is None and self.prefix is not None:
            self._reclaim_pages(n - self.allocator.num_free)
            got = self.allocator.alloc(n)
        return got

    def _start_prefill(self, slot: int, req: Request) -> None:
        """Host-side admission of one request into the PREFILLING state:
        map the longest cached prefix, reserve private pages for the rest
        of the table, queue the slot for chunk dispatch.  On any failure
        the reservation rolls back completely.

        A drop-and-replay victim (or a journal resume) re-admits through
        this same path: its prefill runs over ``prompt + tokens[:-1]`` and
        :meth:`_complete_prefill` restores the slot mid-stream."""
        seq_len = req.replay_len()
        n_total = blocks_needed(req.cache_tokens, self.block_size)
        shared: list = []
        cached_len = 0
        donor = (self._fork_donors.get(req.fork_of)
                 if req.fork_of is not None and not req.handle._tokens else None)
        if donor is not None:
            # Fork sibling: map ALL the parent's prompt-covering pages, the
            # partial last page included; the sibling re-runs just the
            # last prompt token, whose write copies the last shared page
            # first.
            self.allocator.share(donor)
            shared = list(donor)
            cached_len = len(req.prompt)
        elif self.prefix is not None:
            if req.hashes is None:
                req.hashes = page_hashes(req.prompt, self.block_size)
            shared = self.prefix.match(req.hashes)
            if shared:
                self.allocator.share(shared)
                cached_len = len(shared) * self.block_size
        priv = self._alloc_pages(n_total - len(shared))
        if priv is None:
            if shared:
                self.allocator.free(shared)
            self._pool_exhausted("serve.start_prefill", n_total - len(shared))
            raise RuntimeError("prefill could not reserve its promised pages")
        if donor is None and cached_len and not req.hit_counted:
            # Counted once a request, not per admission attempt.
            req.hit_counted = True
            self.prefix.hits += 1
            self.prefix.hit_tokens += cached_len
            _T_PREFIX_HITS.add()
            _T_PREFIX_HIT_TOKENS.add(cached_len)
        req.blocks = shared + priv
        table = np.zeros((self._table_width,), np.int64)
        table[: len(req.blocks)] = req.blocks
        req.table = table
        req.n_cached = cached_len
        # Full-sequence hit: the first sample still needs the last token's
        # logits, so that token is recomputed; its write lands in the
        # final shared page, which copy-on-write privatizes first.
        req.prefill_pos = min(cached_len, seq_len - 1)
        self._slot_req[slot] = req
        self._prefill_q.append(slot)
        if req.admit_t is None:
            req.admit_t = time.perf_counter()
            self._h_queue_wait.observe(req.admit_t - req.submit_t)
        self._event("req.admitted", req, slot=slot, cached_tokens=cached_len,
                    n_blocks=len(req.blocks))

    def _advance_prefills(self) -> int:
        """Dispatch up to ``max_prefills_per_tick`` prefill chunks,
        strictly FIFO.  Returns the number of chunks dispatched."""
        budget = self.max_prefills_per_tick
        while budget > 0 and self._prefill_q:
            slot = self._prefill_q[0]
            req = self._slot_req[slot]
            seq = req.replay_seq()
            start = req.prefill_pos
            end = min(start + self.prefill_chunk, len(seq))
            self._prefill_no += 1
            try:
                kind = faults.fire("serve.prefill", self._prefill_no)
            except OSError:
                # Transient: nothing dispatched; the next tick retries.
                _T_PREFILL_RETRIES.add()
                break
            if kind is not None:  # nan: a poisoned prefill tick — skip it
                _T_PREFILL_RETRIES.add()
                break
            try:
                first = self._dispatch_chunk(slot, req, seq, start, end)
            except (KeyboardInterrupt, SystemExit):
                raise
            except faults.FatalInjectedFault:
                raise
            except Exception as err:
                self._on_prefill_failure(req, err)
                break
            req.prefill_pos = end
            budget -= 1
            if first is not None:
                self._prefill_q.pop(0)
                self._complete_prefill(slot, req, first)
        return self.max_prefills_per_tick - budget

    def _chunk_bucket(self, n: int) -> int:
        """Chunk pad length: the next power of two from
        ``min_prefill_bucket``, capped at ``prefill_chunk``."""
        b = self.min_prefill_bucket
        while b < n:
            b *= 2
        return min(b, max(self.prefill_chunk, n))

    def _cow_shared_pages(self, req: Request, lo: int, hi: int) -> None:
        """Copy-on-write every shared page the positions ``[lo, hi)`` would
        write: the writer gets a private copy and its table entry swaps to
        it.  Never page 0 (those rows steer to trash by construction)."""
        bs = self.block_size
        for idx in range(lo // bs, min(-(-hi // bs), self._table_width)):
            page = int(req.table[idx])
            if page == 0 or self.allocator.refcount(page) <= 1:
                continue
            fresh = self._alloc_pages(1)
            if fresh is None:
                self._pool_exhausted("serve.cow", 1)
                raise RuntimeError("copy-on-write could not reserve a page")
            copy_pages(self._cache, page, fresh[0])
            req.table[idx] = fresh[0]
            req.blocks[req.blocks.index(page)] = fresh[0]
            self.allocator.free([page])  # drop OUR reference on the shared one
            self._n_cow += 1
            _T_COW.add()

    def _run_chunk(self, seq, table, start: int, end: int, key,
                   model_tag: str = DEFAULT_MODEL):
        """One prefill chunk of ``seq[start:end]`` against ``table`` under
        ``model_tag``'s weights, padded to its bucket.  Returns the sampled first token on the
        final chunk (``end == len(seq)``), else None.  Padding positions
        land in the request's own not-yet-decoded tail or the trash page;
        their logits are ignored."""
        n = end - start
        bucket = self._chunk_bucket(n)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = seq[start:end]
        dev = self.device
        model, weights = self._model_ctx(model_tag)
        logits, _ = model.forward_paged(
            torch.from_numpy(tokens).to(dev), self._cache,
            torch.from_numpy(np.asarray(table, np.int64)[None]).to(dev),
            torch.full((1,), start, dtype=torch.int64, device=dev), weights)
        if end < len(seq):
            return None
        last = logits[:, n - 1]
        words = torch.from_numpy(np.asarray(key, np.int64)[None]).to(dev)
        first = sample_keyed(last, words, torch.zeros((1,), dtype=torch.int64, device=dev),
                             self.temperature, self.top_k)
        tt = self._tick_timer
        if tt is None:
            return int(first[0])
        # The int() is the prefill's host sync (the sampled token lands
        # here): device_wait, or a prefill-bound tick reads host-bound.
        tt.begin("device_wait")
        first = int(first[0])
        tt.begin("prefill_dispatch")
        return first

    def _dispatch_chunk(self, slot: int, req: Request, seq, start: int, end: int):
        """One admission-path chunk: copy-on-write anything the chunk
        (padding included) would write, then run it."""
        bucket = self._chunk_bucket(end - start)
        self._cow_shared_pages(req, start, start + bucket)
        self._event("req.prefill_chunk", req, start=start, n=end - start,
                    last=end >= len(seq))
        with self._trace_ctx(req), _telemetry.span(
            "serve.prefill", slot=slot, start=start, n=end - start, bucket=bucket,
            cached=req.n_cached,
        ):
            return self._run_chunk(seq, req.table, start, end, req.key, req.model_tag)

    def _complete_prefill(self, slot: int, req: Request, first: int) -> None:
        """Last chunk done: register the prompt's full pages in the prefix
        index and install the slot into the decode batch."""
        if req.rid in self._fork_groups and req.rid not in self._fork_donors:
            # Fork parent: pin the prompt-covering pages for the siblings
            # with ENGINE-held references (the donor survives the parent
            # retiring, even on its first token).
            n_prompt_pages = min(blocks_needed(len(req.prompt), self.block_size),
                                 len(req.blocks))
            donor = [int(req.table[i]) for i in range(n_prompt_pages)]
            self.allocator.share(donor)
            self._fork_donors[req.rid] = donor
        if self.prefix is not None and req.hashes:
            self.prefix.register(req.hashes, [int(req.table[i]) for i in range(len(req.hashes))],
                                 self.allocator)
        toks = req.handle._tokens
        now = time.perf_counter()
        if toks:
            # A drop-and-replay victim (or a journal resume): the sampled
            # token recomputes an already-committed one and is discarded;
            # the pending input is the last committed token.  The
            # committed buffer is checked against the digest first.
            if not req.digest.matches_stream(req.prompt, req.key, toks, req.model_version):
                self._resume_diverged(slot, req, "preempt-replay-resume")
                return
            self._install_slot(slot, req, toks[-1], req.replay_len(), req.table,
                               n_gen=len(toks), emitted=len(toks))
            if req.preempt_t is not None:
                self._h_outage.observe(now - req.preempt_t)
                req.preempt_t = None
            self._event("req.resumed", req, mechanism="replay", n_tokens=len(toks))
            return
        req.handle.ttft_s = now - req.submit_t
        self._h_ttft.observe(req.handle.ttft_s)
        if req.preempt_t is not None:
            # Recovery-requeued before its first token: outage, not prefill.
            self._h_outage.observe(now - req.preempt_t)
            req.preempt_t = None
        elif req.admit_t is not None:
            self._h_prefill.observe(now - req.admit_t)
        if req.trace_id is not None:
            self._event("req.first_token", req, ttft_s=round(req.handle.ttft_s, 6),
                        digest=req.digest.hexdigest())
        _G_TTFT.set(round(req.handle.ttft_s, 4))
        self._install_slot(slot, req, first, len(req.prompt), req.table, n_gen=1, emitted=0)
        # _push_token retires at once on a first-token EOS or a budget of
        # one: the slot never enters the decode batch.
        self._push_token(slot, first)
        if self._journal is not None:
            # The first token is a commit point like any chunk boundary (a
            # first-token retirement journals through the funnel instead).
            self._journal_commit(req, len(req.handle._tokens) - 1)

    def _install_slot(self, slot, req, token, position, table, *, n_gen, emitted) -> None:
        self._slot_req[slot] = req
        self._tokens[slot] = token
        self._positions[slot] = position
        self._n_gen[slot] = n_gen
        self._done[slot] = False
        self._keys[slot] = req.key
        self._tables[slot] = table
        self._emitted[slot] = emitted

    @staticmethod
    def _reset_prefill_state(req: Request) -> None:
        """Forget a request's in-progress prefill so a re-admission starts
        clean (``hit_counted`` survives: the hit rate counts requests)."""
        req.blocks = None
        req.table = None
        req.prefill_pos = 0
        req.n_cached = 0

    def _resume_diverged(self, slot: int, req: Request, where: str) -> None:
        """A replay's digest check failed: the committed-token buffer was
        corrupted.  Latch the engine and fail the request typed — never
        feed a poisoned buffer back to the model."""
        toks = list(req.handle._tokens)
        _audit.record_divergence(
            self, rid=req.trace_id, where=where, expected_digest=req.digest.hexdigest(),
            replayed_digest=_audit.DeterminismDigest.of_stream(
                req.prompt, req.key, toks, req.model_version).hexdigest(),
            n_tokens=len(toks))
        self._fail_running_slot(slot, DeterminismDiverged(
            f"request {req.rid} resume ({where}): committed tokens no longer match the "
            f"determinism digest after {len(toks)} tokens"))

    def _abort_prefill(self, slot: int) -> Request:
        """Back a PREFILLING slot fully out: pages returned, chunk state
        reset, slot idle."""
        req = self._slot_req[slot]
        if req.blocks:
            self.allocator.free(req.blocks)
        self._reset_prefill_state(req)
        self._clear_slot(slot)
        return req

    def _on_prefill_failure(self, req: Request, err: BaseException) -> None:
        """A chunk dispatch raised.  After a device fault the supervisor
        owns everything.  Otherwise charge the failing request's budget
        and restart its prefill from the FIFO head, together with every
        prefill admitted behind it."""
        if _device_fault(err):
            self._supervise_recovery(err)
            return
        reqs = [self._abort_prefill(slot) for slot in list(self._prefill_q)]
        req.recoveries += 1
        if req.recoveries > self.max_recoveries:
            _T_RECOVERY_FAILURES.add()
            req.handle._fail(RecoveryFailed(
                f"request {req.rid} aborted: prefill failed {req.recoveries} times ({err!r})"))
            self.scheduler.requeue([r for r in reqs if r is not req])
        else:
            _T_PREFILL_RETRIES.add()
            # ONE requeue call: the failed request lands at the head,
            # ahead of the prefills admitted behind it.
            self.scheduler.requeue(reqs)

    def _prefill_dispatch(self, req: Request, seq: np.ndarray):
        """Synchronous full-sequence prefill — the recovery replay path:
        reserve the request's full page quota, run every chunk back to
        back, and free the reservation before any error surfaces.
        Returns ``(sampled_token, table)``."""
        need = blocks_needed(req.cache_tokens, self.block_size)
        blocks = self._alloc_pages(need)
        if blocks is None:
            self._pool_exhausted("serve.replay_prefill", need)
            raise RuntimeError("prefill could not reserve its promised pages")
        req.blocks = blocks
        table = np.zeros((self._table_width,), np.int64)
        table[: len(blocks)] = blocks
        try:
            first = None
            for start in range(0, len(seq), self.prefill_chunk):
                end = min(start + self.prefill_chunk, len(seq))
                first = self._run_chunk(seq, table, start, end, req.key, req.model_tag)
        except BaseException:
            self.allocator.free(blocks)
            req.blocks = None
            raise
        return first, table

    # ------------------------------------------------------------------
    # Decode + the recovery supervisor

    def decoder(self, tag: str = DEFAULT_MODEL) -> DecodeChunk:
        """The decode chunk of this engine's geometry under ``tag``'s
        weights (built on first use; on CUDA its graph is captured at its
        first call).  One a ``(geometry, model tag)``: a graph holds its
        model's weights by address."""
        geometry = (self.num_slots, self._table_width, self.decode_chunk, self.temperature,
                    self.top_k, self.eos_id, tag)
        dec = self._decoders.get(geometry)
        if dec is None:
            model, weights = self._model_ctx(tag)
            dec = self._decoders[geometry] = DecodeChunk(
                model, weights, self._cache, num_slots=self.num_slots,
                table_width=self._table_width, n_steps=self.decode_chunk,
                temperature=self.temperature, top_k=self.top_k, eos_id=self.eos_id,
                device=self.device)
        return dec

    def _drop_decoders(self, tag: str) -> None:
        """Drop ``tag``'s decode chunks and release their graphs (and the
        graphs' private memory): the model pool calls this BEFORE freeing
        the model's weights, which the graphs read by address."""
        for geometry in [g for g in self._decoders if g[-1] == tag]:
            dec = self._decoders.pop(geometry)
            if dec.graph is not None:
                dec.graph.reset()
                dec.graph = None
            dec.model = dec.weights = None

    def _decode_phase(self) -> int:
        """One decode chunk over the running slots, a chunk a model;
        returns the number of tokens committed."""
        if not self._n_decoding():
            return 0
        self._decode_no += 1
        try:
            kind = faults.fire("serve.step", self._decode_no)
        except OSError as err:
            # An injected io fault is a failed dispatch: the first is a
            # free retry, a second consecutive one goes to the supervisor.
            self._dispatch_failed(err)
            return 0
        if kind == "nan":
            # Poisoned step: skip BEFORE dispatch (committed state is the
            # prior state bit for bit), count it, keep going.
            _T_SKIPPED.add()
            return 0
        corrupt = kind == "corrupt"
        # Group the decode batch by model.  The common case is ONE group
        # on the engine's own model and passes the slot arrays unmasked.
        # With pool models decoding, each group replays its own chunk over
        # masked inputs: other slots read done=True and table 0 (writes on
        # the trash page, outputs discarded), so the passes commute.
        groups: dict = {}
        for slot, req in enumerate(self._slot_req):
            if req is None or slot in self._prefill_q or slot in self._swapped:
                continue
            groups.setdefault(req.model_tag, []).append(slot)
        committed = 0
        for tag, slots in groups.items():
            got = self._decode_group(tag, slots, solo=len(groups) == 1, corrupt=corrupt)
            corrupt = False  # one flipped token per poisoned chunk
            if got is None:  # dispatch failed; handled (retry/recovery)
                break
            committed += got
        self._decode_tokens += committed
        if self._decode_s > 0:
            _G_DECODE_TPS.set(round(self._decode_tokens / self._decode_s, 1))
        return committed

    def _decode_group(self, tag: str, slots: list, *, solo: bool,
                      corrupt: bool) -> Optional[int]:
        """One decode chunk over the slots of ONE model.  Returns tokens
        committed, or None when the dispatch failed and the failure was
        handled (free retry next tick, or the supervisor ran)."""
        if solo:
            done, tables = self._done, self._tables
        else:
            done = np.ones_like(self._done)
            done[slots] = self._done[slots]
            tables = np.zeros_like(self._tables)
            tables[slots] = self._tables[slots]
        tt = self._tick_timer
        if tt is not None:
            tt.begin("decode_dispatch")
        attrs = {"n_active": len(slots), "chunk": self.decode_chunk}
        if tag != DEFAULT_MODEL:
            attrs["model"] = tag
        sp = _telemetry.start_span("serve.step", **attrs)
        t0 = time.perf_counter()
        try:
            args = (self._tokens, self._positions, self._n_gen, done, self._keys, tables)
            # The timer marks the chunk's read-back as device_wait.
            out = (self.decoder(tag)(*args) if tt is None
                   else self.decoder(tag)(*args, timer=tt))
        except (KeyboardInterrupt, SystemExit, GraphCaptureError, faults.FatalInjectedFault):
            sp.cancel()
            raise
        except Exception as err:
            sp.cancel()
            self._oom_check(err, "serve.step")
            self._dispatch_failed(err)
            return None
        if tt is not None:
            tt.begin("commit")
        if corrupt and slots:
            # The audit plane's fault: one committed token flipped on the
            # host, a silent determinism break only a digest can catch.
            out = out.copy()
            out[0, slots[0]] = int(out[0, slots[0]]) ^ 1
            _T_CORRUPTIONS.add()
        self._consec_decode_failures = 0
        dt = time.perf_counter() - t0
        self._decode_s += dt
        committed = 0
        jstate = None
        if self._journal is not None:
            # Chunk-boundary journal commits: (request, tokens committed
            # before) captured BEFORE the commit loop — a slot retiring
            # mid-chunk journals through the retirement funnel instead.
            jstate = [(self._slot_req[slot], len(self._slot_req[slot].handle._tokens))
                      for slot in slots]
        for slot in slots:
            for tok in out[:, slot]:
                self._push_token(slot, int(tok))
                committed += 1
                if self._slot_req[slot] is None:  # retired mid-chunk
                    break
            else:
                # Still running: roll the slot forward by the whole chunk
                # (post-EOS/budget overshoot stays inside its own pages).
                self._tokens[slot] = out[-1, slot]
                self._positions[slot] += self.decode_chunk
                self._n_gen[slot] += self.decode_chunk
        if jstate is not None:
            for jreq, jn0 in jstate:
                self._journal_commit(jreq, jn0)
        if committed:
            self._h_tpot.observe(dt / self.decode_chunk, n=committed)
        if tag != DEFAULT_MODEL:
            self.model_pool._note_tokens(tag, committed)
        sp.end(tokens=committed)
        return committed

    def _dispatch_failed(self, err: BaseException) -> None:
        """A decode dispatch failed.  Nothing committed, and (see the
        module doc) committed pages are intact unless the device faulted:
        the first failure is a free, token-identical retry next tick; a
        second consecutive one, or a device fault, goes to the
        supervisor."""
        self._consec_decode_failures += 1
        if not _device_fault(err) and self._consec_decode_failures <= 1:
            _T_STEP_RETRIES.add()
            return
        self._consec_decode_failures = 0
        self._supervise_recovery(err)

    def _supervise_recovery(self, error: BaseException) -> None:
        """Restore servability after a failed device call, replaying the
        live requests instead of failing them.

        The pool is zeroed in place, the allocator map reset, and each
        live request re-prefilled over ``prompt + generated-so-far``;
        keyed sampling at ``n_gen`` makes the continuation
        token-identical.  Each recovery event (and each failed replay)
        charges the request's ``max_recoveries`` budget; exhaustion is a
        typed, retryable :class:`.lifecycle.RecoveryFailed`.  A failed
        replay restarts the whole pass (budgets keep it finite)."""
        self._n_recoveries += 1
        _T_RECOVERIES.add()
        _telemetry.flight_dump("serve.recover", engine=self.engine_id,
                               error=type(error).__name__)
        sp = _telemetry.start_span("serve.recover", n_live=self._n_running(),
                                   error=type(error).__name__)
        now = time.perf_counter()
        for req in self._slot_req:
            if req is not None:
                req.recoveries += 1
                if req.preempt_t is None:
                    req.preempt_t = now
                self._event("req.preempted", req, mechanism="replay", reason="recovery",
                            n_tokens=len(req.handle._tokens))
        # Slots still PREFILLING have no committed tokens to replay: they
        # restart from the FIFO head, in admission order.  The prefix
        # index dies with the pool.
        requeue = []
        for slot in list(self._prefill_q):
            req = self._slot_req[slot]
            self._reset_prefill_state(req)
            if req.recoveries > self.max_recoveries:
                _T_RECOVERY_FAILURES.add()
                req.handle._fail(RecoveryFailed(
                    f"request {req.rid} aborted: recovery budget ({self.max_recoveries}) "
                    f"exhausted before its prefill completed ({error!r})"))
            else:
                requeue.append(req)
            self._clear_slot(slot)
        self.scheduler.requeue(requeue)
        # Swapped slots: the committed tokens on the handle are all a
        # replay needs — discard the host buffers and replay them like any
        # decoding slot (the allocator reset below re-zeroes the swap
        # account).
        self._swapped.clear()
        self._swap_host_bytes = 0
        # Fork donors die with the pool (the reset reclaims every page);
        # the groups stay: a replaying parent re-creates its donor.
        self._fork_donors.clear()
        if self.prefix is not None:
            self.prefix.clear()
        # Replay inputs are checked against the determinism digest BEFORE
        # anything is re-prefilled.
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            toks = req.handle._tokens
            if toks and not req.digest.matches_stream(req.prompt, req.key, toks,
                                                      req.model_version):
                req.blocks = None  # the allocator reset below reclaims them
                self._resume_diverged(slot, req, "recovery-replay")
        pending = [(slot, req) for slot, req in enumerate(self._slot_req) if req is not None]
        while True:
            replayed = 0
            self.allocator.reset()
            fresh_pool(self._cache)
            still = []
            for slot, req in pending:
                if req.recoveries > self.max_recoveries:
                    req.blocks = None
                    _T_RECOVERY_FAILURES.add()
                    req.handle._fail(RecoveryFailed(
                        f"request {req.rid} aborted: recovery budget ({self.max_recoveries}) "
                        f"exhausted after {self._emitted[slot]} tokens ({error!r})"))
                    self._clear_slot(slot)
                else:
                    still.append((slot, req))
            pending = still
            if not pending:
                break
            failed = False
            for slot, req in pending:
                self._recover_no += 1
                try:
                    kind = faults.fire("serve.recover", self._recover_no)
                    if kind is not None:
                        raise faults.InjectedFault(f"poisoned replay attempt ({kind})")
                    self._replay_into(slot, req)
                    replayed += 1
                except (KeyboardInterrupt, SystemExit, faults.FatalInjectedFault):
                    sp.cancel()
                    raise
                except Exception:
                    # Charge the failing request and restart the whole
                    # pass from a clean map.
                    req.recoveries += 1
                    failed = True
                    break
            if not failed:
                break
        sp.end(n_replayed=replayed)

    def _replay_into(self, slot: int, req: Request) -> None:
        """Re-prefill a live request's ``prompt + tokens[:-1]`` into fresh
        pages and restore the slot where it was; the recomputed sample is
        discarded (the last committed token is the pending input)."""
        toks = req.handle._tokens
        seq = req.replay_seq()
        _, table = self._prefill_dispatch(req, seq)
        self._install_slot(slot, req, toks[-1], len(seq), table, n_gen=len(toks),
                           emitted=len(toks))
        if req.preempt_t is not None:
            self._h_outage.observe(time.perf_counter() - req.preempt_t)
            req.preempt_t = None
        self._event("req.resumed", req, mechanism="replay", reason="recovery",
                    n_tokens=len(toks))

    # ------------------------------------------------------------------
    # Token commit / retirement

    def _push_token(self, slot: int, token: int) -> None:
        """Commit one token to the slot's handle (and its digest); retire
        on EOS or budget."""
        req = self._slot_req[slot]
        req.handle._push(token)
        req.digest.update((token,), req.model_version)
        self._emitted[slot] += 1
        _T_TOKENS.add()
        if self._emitted[slot] >= req.max_new_tokens or (
                self.eos_id is not None and token == self.eos_id):
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        self.allocator.free(req.blocks)
        req.blocks = None
        req.handle._finish()
        _T_FINISHED.add()
        self._clear_slot(slot)
        if self._auditor is not None:
            # Finished requests feed the auditor; audit replays settle
            # their digest comparison through the same hook.
            self._auditor.on_finished(req)

    def _clear_slot(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._tokens[slot] = 0
        self._positions[slot] = 0
        self._n_gen[slot] = 0
        self._done[slot] = True
        self._tables[slot] = 0  # idle slots scribble on the trash page
        if slot in self._prefill_q:  # reaped/aborted mid-prefill
            self._prefill_q.remove(slot)

    # ------------------------------------------------------------------
    # Durability plane: the request journal + cold-restart resume

    def _bind_journal(self, journal: RequestJournal) -> None:
        """Adopt a journal: geometry check (read-only, BEFORE the claim —
        a mismatched engine must not steal the lock from the replica that
        could resume the streams), ownership claim (typed
        :class:`.lifecycle.JournalOwned` when a live engine holds it),
        then this engine's config record."""
        prior = journal.peek_config()
        if prior is not None:
            mine = self._journal_config()
            bad = [k for k in mine if k in prior and prior[k] != mine[k]]
            if bad:
                raise ValueError(
                    f"journal geometry mismatch on {bad}: journal has "
                    f"{ {k: prior[k] for k in bad} }, engine has "
                    f"{ {k: mine[k] for k in bad} } — resuming here would continue the "
                    "streams with different tokens")
        journal.claim(self.engine_id)
        journal.write_config(engine=self.engine_id, **self._journal_config())
        self._journal = journal

    def _journal_config(self) -> dict:
        """What a resume must agree on: everything that changes WHICH
        tokens a stream commits."""
        return {
            "temperature": self.temperature,
            "top_k": self.top_k,
            "eos_id": self.eos_id,
            "decode_chunk": self.decode_chunk,
            "model_version": self.model_version,
        }

    def _journal_admit(self, req: Request, *, tokens=None) -> None:
        """Journal one request's replay identity.  ``tokens`` marks a
        handoff admit (migration import): the committed prefix and the
        digest snapshot ride along."""
        j = self._journal
        uid = j.next_uid()
        rec = {
            "t": "admit", "u": uid,
            "prompt": [int(t) for t in req.prompt],
            "key": [int(k) for k in req.key],
            "max_new": int(req.max_new_tokens),
            "model": req.model_tag, "version": req.model_version,
            "tenant": req.tenant, "priority": int(req.priority),
            # perf_counter deadlines die with the process: the journal
            # carries the wall-clock expiry, and resume converts back (or
            # fails the stream typed if the outage outlived it).
            "deadline": (None if req.deadline is None
                         else time.time() + (req.deadline - time.perf_counter())),
            "trace": req.trace_id,
        }
        if tokens:
            rec["tokens"] = [int(t) for t in tokens]
            rec["d"] = req.digest.hexdigest()
        try:
            j.append(rec)
        except OSError:
            _journal_mod._T_APPEND_ERRORS.add()
            return  # no uid: this stream rides unjournaled
        req._journal_uid = uid

    def _journal_commit(self, req: Request, n0: int) -> None:
        """Journal a chunk boundary's newly committed tokens (from index
        ``n0``) plus the rolling-digest snapshot after them."""
        uid = getattr(req, "_journal_uid", None)
        if uid is None:
            return
        delta = req.handle._tokens[n0:]
        if not delta:
            return
        try:
            self._journal.append({"t": "commit", "u": uid, "toks": [int(t) for t in delta],
                                  "n": len(req.handle._tokens), "d": req.digest.hexdigest()})
        except OSError:
            _journal_mod._T_APPEND_ERRORS.add()

    def _journal_retire(self, req, error=None, outcome: Optional[str] = None) -> None:
        """The retirement funnel: every terminal path (finish, fail,
        cancel, expiry, migration handoff) lands here, so a journaled
        stream is never resurrected after its client saw a terminal."""
        j = self._journal
        if j is None or req is None:
            return
        uid = getattr(req, "_journal_uid", None)
        if uid is None:
            return
        req._journal_uid = None
        if outcome is None:
            if error is None:
                outcome = "finished"
            elif isinstance(error, RequestCancelled):
                outcome = "cancelled"
            elif isinstance(error, DeadlineExceeded):
                outcome = "expired"
            else:
                outcome = "failed"
        rec = {"t": "retire", "u": uid, "outcome": outcome, "n": len(req.handle._tokens)}
        # Retirement usually lands mid-chunk, before the chunk's trailing
        # commit: the uncommitted tail rides here.
        tail = req.handle._tokens[j.committed_n(uid):]
        if tail:
            rec["toks"] = [int(t) for t in tail]
        if error is not None:
            rec["error"] = type(error).__name__
        if req.digest is not None:
            rec["d"] = req.digest.hexdigest()
        try:
            j.append(rec)
        except OSError:
            _journal_mod._T_APPEND_ERRORS.add()

    def resume_from_journal(self, journal: Optional[RequestJournal] = None) -> dict:
        """Cold-restart resume: re-admit every unfinished journaled stream
        through the replay path.

        Each stream re-prefills ``prompt + committed tokens[:-1]`` and
        continues at the uninterrupted run's sampling step — token-identical,
        greedy and sampled.  Before anything is admitted, per stream:
        (1) the journaled tokens re-hash against the journaled digest (a
        mismatch is a typed :class:`.lifecycle.DeterminismDiverged`);
        (2) an expired wall-clock deadline fails typed
        :class:`.lifecycle.DeadlineExceeded`; (3) a pool-model stream
        demand-materializes its model (an evicted one is re-loaded, an
        unregistered one fails typed).

        Pass ``journal`` to adopt one after construction; the claim is the
        double-resume guard.  Returns ``{journal uid: RequestHandle}``."""
        if journal is not None:
            if self._journal is None:
                self._bind_journal(journal)
            elif journal is not self._journal:
                raise ValueError("engine already owns a different journal; resume this one "
                                 "on a fresh engine")
        j = self._journal
        if j is None:
            raise ValueError("resume_from_journal needs a journal: construct with "
                             "Engine(journal=RequestJournal(dir)) or pass one here")
        if self._health in (Health.DRAINING, Health.STOPPED):
            raise EngineDraining(f"engine is {self._health.value}; resume on a live replica")
        entries, _config = j.recover()
        sp = _telemetry.start_span("serve.resume_cold", n_streams=len(entries))
        now_wall = time.time()
        now_perf = time.perf_counter()
        handles: dict = {}
        for uid in sorted(entries):
            handles[uid] = self._resume_entry(entries[uid], now_wall, now_perf)
        n_live = sum(1 for h in handles.values() if not h._done)
        sp.end(n_resumed=n_live, n_failed=len(handles) - n_live)
        return handles

    def _resume_entry(self, e, now_wall: float, now_perf: float):
        """Re-admit ONE journaled stream (see :meth:`resume_from_journal`)."""
        rid = self._next_rid
        self._next_rid += 1
        handle = RequestHandle(self, rid)
        prompt = np.asarray(e.prompt, np.int32)
        key = np.asarray(e.key, np.uint32).reshape(-1)
        digest = _audit.DeterminismDigest(prompt, key)
        if e.tokens:
            digest.update(e.tokens, e.model_version)
        tid = e.trace_id
        if tid is None and _telemetry.events_enabled():
            tid = f"{self.engine_id}-r{rid}"
        deadline = (None if e.deadline_wall is None
                    else now_perf + (e.deadline_wall - now_wall))
        replay_len = len(e.prompt) + max(0, len(e.tokens) - 1)
        n_chunks = -(-max(1, replay_len) // self.prefill_chunk)
        pool_entry = None
        if (e.model_tag != DEFAULT_MODEL and self.model_pool is not None
                and e.model_tag in self.model_pool):
            pool_entry = self.model_pool._entries[e.model_tag]
        hashes = None
        if self.prefix is not None and len(prompt):
            hashes = page_hashes(prompt, self.block_size,
                                 pool_entry.namespace if pool_entry is not None else b"")
        req = Request(rid, prompt, int(e.max_new_tokens), key, handle, deadline=deadline,
                      n_chunks=n_chunks, hashes=hashes, tenant=e.tenant, priority=e.priority,
                      trace_id=tid, digest=digest, model_tag=e.model_tag,
                      model_version=e.model_version)
        handle._req = req
        handle._tokens = list(e.tokens)
        req._journal_uid = e.uid
        if not len(prompt) or key.shape != (2,):
            handle._fail(RecoveryFailed(f"journaled stream {e.uid} has no replayable "
                                        "identity (empty prompt or malformed key)"))
            return handle
        # 1. Journal integrity: the committed tokens must still hash to the
        # journaled digest snapshot.
        if e.tokens and e.digest is not None:
            got = digest.hexdigest()
            if got != e.digest:
                _audit.record_divergence(self, rid=tid, where="journal-resume",
                                         expected_digest=e.digest, replayed_digest=got,
                                         n_tokens=len(e.tokens))
                handle._fail(DeterminismDiverged(
                    f"journaled stream {e.uid}: committed tokens no longer match the "
                    f"journaled digest after {len(e.tokens)} tokens"))
                return handle
        # 2. The outage may have outlived the deadline: typed, counted.
        if e.deadline_wall is not None and now_wall > e.deadline_wall:
            _journal_mod._T_RESUME_EXPIRED.add()
            handle._fail(DeadlineExceeded(
                f"journaled stream {e.uid} expired {now_wall - e.deadline_wall:.1f}s "
                "before the restart"))
            return handle
        # 3. Model plane: re-materialize an evicted pool model on demand
        # before replay; an unregistered or re-versioned one fails typed.
        if e.model_tag != DEFAULT_MODEL:
            if pool_entry is None:
                handle._fail(RecoveryFailed(
                    f"journaled stream {e.uid} is on model {e.model_tag!r}, which this "
                    "engine's pool does not register"))
                return handle
            if pool_entry.model_version != e.model_version:
                handle._fail(MigrationIncompatible(
                    f"journaled stream {e.uid} ran model {e.model_tag!r} version "
                    f"{e.model_version!r}; this pool registers "
                    f"{pool_entry.model_version!r}"))
                return handle
            self.model_pool._touch(e.model_tag)
            if not pool_entry.ready:
                self._materialize_wanted[e.model_tag] = None
        self.scheduler.push(req)
        _T_REQUESTS.add()
        _journal_mod._T_RESUMED.add()
        self._event("serve.resumed_cold", req, uid=e.uid, n_tokens=len(e.tokens),
                    n_prompt=len(e.prompt), model=e.model_tag)
        return handle

    # ------------------------------------------------------------------
    # Introspection

    def stats(self) -> dict:
        """Host-side serving stats: TTFT percentiles, sustained decode,
        lifecycle counts, preemptions, migrations, prefix-cache
        effectiveness, graph captures, the model pool and the journal."""
        out = {
            "health": self._health.value,
            "requests": self._next_rid,
            "running": self._n_running(),
            "waiting": len(self.scheduler),
            "ticks": self._tick_no,
            "decode_tokens": self._decode_tokens,
            "decode_s": round(self._decode_s, 4),
            "block_utilization": round(self.allocator.utilization(), 4),
            "shed": self._n_shed,
            "expired": self._n_expired,
            "cancelled": self._n_cancelled,
            "recoveries": self._n_recoveries,
            "preempted": self._n_preempted,
            "preemptions_swap": self._n_preempt_swap,
            "preemptions_replay": self._n_preempt_replay,
            "swapped_pages": self.allocator.num_swapped,
            "role": self.role,
            "migrations_out": self._n_migrated_out,
            "migrations_in": self._n_migrated_in,
            "decode_graphs": sum(d.graph is not None for d in self._decoders.values()),
            "decode_replays": sum(d.replays for d in self._decoders.values()),
        }
        if self.prefix is not None:
            out["prefix_cached_pages"] = len(self.prefix)
            out["prefix_hits"] = self.prefix.hits
            out["prefix_hit_tokens"] = self.prefix.hit_tokens
            out["prefix_evictions"] = self.prefix.evictions
            out["cow_copies"] = self._n_cow
        if self._auditor is not None:
            out["audit_checked"] = self._auditor.checked
            out["audit_divergences"] = self._auditor.divergences
            out["audit_pending"] = self._auditor.backlog()
            out["audit_dropped"] = self._auditor.dropped
            out["audit_aborted"] = self._auditor.aborted
        if self._diverging:
            out["diverging"] = True
        if self.model_pool is not None:
            out["models"] = self.model_pool.stats()
            out["forks"] = self._n_forks
        elif self._n_forks:
            out["forks"] = self._n_forks
        if self._journal is not None:
            out["journal"] = self._journal.stats()
        if self._decode_s > 0:
            out["decode_tokens_per_s"] = round(self._decode_tokens / self._decode_s, 1)
        if self._h_ttft.count:
            out["ttft_p50_s"] = round(self._h_ttft.percentile(50), 4)
            out["ttft_p95_s"] = round(self._h_ttft.percentile(95), 4)
        if self._h_tpot.count:
            out["tpot_p50_s"] = round(self._h_tpot.percentile(50), 6)
            out["tpot_p95_s"] = round(self._h_tpot.percentile(95), 6)
        if self._h_queue_wait.count:
            out["queue_wait_p95_s"] = round(self._h_queue_wait.percentile(95), 4)
        if self._h_outage.count:
            out["preempt_outage_p95_s"] = round(self._h_outage.percentile(95), 4)
        return out
