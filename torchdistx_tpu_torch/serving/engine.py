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

Left out until ROADMAP A7, each raising ``NotImplementedError``: the QoS
scheduler (``scheduler="qos"``, ``tenant_weights``,
``shed_policy="by-priority"``) with its swap and replay preemption,
``submit(n>1)`` forks, ``model_pool=`` / ``submit(model=)``,
``journal=`` and its resume, migration, the shadow auditor
(``audit_sample`` / ``TDX_AUDIT_SAMPLE``) and the ops plane (``ops_port``
/ ``ops_config`` / ``TDX_OPS_PORT``).  The time plane, the compile
observatory and the HBM ledger belong to A8.
"""

from __future__ import annotations

import itertools
import os
import time
from contextlib import nullcontext
from typing import Any, Optional

import numpy as np
import torch

from .. import telemetry as _telemetry
from .._device import resolve_device
from ..models.generate import sample_keyed
from ..resilience import faults
from ..resilience import preemption as _preemption
from ..telemetry import audit as _audit
from .blocks import BlockAllocator, blocks_needed
from .cache import copy_pages, fresh_pool, init_paged_cache
from .lifecycle import (
    DeadlineExceeded,
    DeterminismDiverged,
    EngineDraining,
    EngineOverloaded,
    Health,
    OverloadDetector,
    RecoveryFailed,
    RequestCancelled,
    RequestPreempted,
)
from .prefix import PrefixIndex, page_hashes
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
_T_PREFIX_HITS = _telemetry.counter("serve.prefix_hits")
_T_PREFIX_HIT_TOKENS = _telemetry.counter("serve.prefix_hit_tokens")
_T_COW = _telemetry.counter("serve.cow_copies")
_T_PREFIX_EVICTIONS = _telemetry.counter("serve.prefix_evictions")
_T_IDLE_TICKS = _telemetry.counter("serve.idle_ticks")
_T_CORRUPTIONS = _telemetry.counter("serve.corruptions")
_T_GRAPH_CAPTURES = _telemetry.counter("serve.graph_captures")
_G_RUNNING = _telemetry.gauge("serve.running_slots")
_G_DECODE_TPS = _telemetry.gauge("serve.decode_tok_s")
_G_TTFT = _telemetry.gauge("serve.ttft_s")
_G_EST_TTFT = _telemetry.gauge("serve.est_ttft_s")
_G_HEALTH = _telemetry.gauge("serve.health")

# Process-wide engine-id mint ("eng0", "eng1", ...) unless the caller
# names the engine.
_ENGINE_SEQ = itertools.count()

_A7 = "is ROADMAP A7, not ported yet"


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} {_A7}")


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
        side = torch.cuda.Stream(self.device)
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

    def __call__(self, tokens, positions, n_gen, done, keys, tables) -> np.ndarray:
        self.load(tokens, positions, n_gen, done, keys, tables)
        if self.device.type == "cuda":
            self.replay()
        else:
            self.run_eager()
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
    max_queue / max_ttft_s / shed_policy : the overload detector's bounds
        and what happens when it trips (``"reject-new"``, ``"drop-oldest"``).
    max_recoveries : per-request replay budget of the supervisor.
    drain_deadline_s : wall-clock budget for in-flight work once a drain
        begins; the remainder fails with :class:`.lifecycle.RequestPreempted`.
    handle_preemption : install the SIGTERM/SIGINT flag handlers.
    engine_id : the label of the per-engine metrics.
    role : ``"mixed"``, ``"prefill"`` or ``"decode"``, a routing hint
        exported as ``serve.role{engine=}``.
    model_version : the version tag folded into every request's digest.
    scheduler, tenant_weights, preempt_mechanism, ops_port, ops_config,
    audit_sample, model_pool, journal : ROADMAP A7; anything but the
        default raises ``NotImplementedError``.
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
        self._check_unported(scheduler, tenant_weights, shed_policy, ops_port, ops_config,
                             audit_sample, model_pool, journal)
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
        if preempt_mechanism not in ("swap", "replay"):
            raise ValueError(f"preempt_mechanism {preempt_mechanism!r}: expected "
                             "'swap' or 'replay'")
        self.preempt_mechanism = preempt_mechanism  # inert under FIFO, as in JAX
        if shed_policy not in ("reject-new", "drop-oldest"):
            raise ValueError(f"shed_policy {shed_policy!r}: expected 'reject-new', "
                             "'drop-oldest', or 'by-priority'")
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
        self.scheduler = FIFOScheduler(max_prefills_per_tick)
        self.scheduler.bind_engine(self.engine_id)
        self.detector = OverloadDetector(max_queue, max_ttft_s)
        self.prefix: Optional[PrefixIndex] = PrefixIndex(block_size) if prefix_cache else None

        self._weights = model.prep_decode()
        self._cache = init_paged_cache(model, num_blocks, block_size, device=self.device)
        self._decoders: dict = {}  # geometry -> DecodeChunk (one graph each on CUDA)

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

        self._next_rid = 0
        self._admit_no = 0  # admission attempts (serve.admit fault site)
        self._prefill_no = 0  # prefill dispatches (serve.prefill site)
        self._decode_no = 0  # decode chunks attempted (serve.step site)
        self._recover_no = 0  # supervisor replay attempts (serve.recover)
        self._decode_s = 0.0
        self._decode_tokens = 0
        self._consec_decode_failures = 0
        self._n_shed = 0
        self._n_expired = 0
        self._n_cancelled = 0
        self._n_recoveries = 0
        self._n_preempted = 0
        self._n_cow = 0
        self._tick_no = 0
        self._diverging = False

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

    @staticmethod
    def _check_unported(scheduler, tenant_weights, shed_policy, ops_port, ops_config,
                        audit_sample, model_pool, journal) -> None:
        """The ROADMAP A7 arguments: each raises, none is ignored."""
        if scheduler not in ("fifo", "qos"):
            raise ValueError(f"scheduler {scheduler!r}: expected 'fifo' or 'qos'")
        if scheduler == "qos":
            raise _unported("scheduler='qos' (the QoS scheduler and its preemption)")
        if tenant_weights is not None:
            raise _unported("tenant_weights (the QoS scheduler)")
        if shed_policy == "by-priority":
            raise _unported("shed_policy='by-priority' (the QoS scheduler)")
        env_port = os.environ.get("TDX_OPS_PORT", "")
        if ops_port is not None or ops_config is not None or env_port:
            raise _unported("the ops plane (ops_port / ops_config / TDX_OPS_PORT)")
        if audit_sample is None:
            text = os.environ.get("TDX_AUDIT_SAMPLE", "")
            audit_sample = float(text) if text else None
        if audit_sample:
            raise _unported("the shadow auditor (audit_sample / TDX_AUDIT_SAMPLE)")
        if model_pool is not None:
            raise _unported("model_pool= (the model plane)")
        if journal is not None:
            raise _unported("journal= (the request journal)")

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
    ) -> RequestHandle:
        """Queue a request; returns its streaming handle.

        ``key``: an int seed or two 32-bit words — the key a solo
        ``generate(model, prompt[None], key=...)`` takes, for token
        parity.  Default: the request id.  ``deadline_s``: wall-clock
        budget from submission, observed at chunk boundaries.
        ``tenant`` / ``priority`` are carried, inert under FIFO.
        ``n > 1`` and ``model=`` are ROADMAP A7 and raise.

        A request that could never run (oversized for ``max_model_len``,
        or needing more pages than the engine owns) raises ``ValueError``
        here.  Raises :class:`.lifecycle.EngineDraining` when draining or
        stopped, and sheds per ``shed_policy`` when overloaded.
        """
        if int(n) != 1:
            if int(n) < 1:
                raise ValueError("n must be >= 1")
            raise _unported("submit(n>1) (parallel-sampling forks)")
        if model is not None:
            raise _unported("submit(model=) (the model plane)")
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
        # Normalize the key BEFORE any shedding side effect: a malformed
        # key must raise without having killed a drop-oldest victim.
        key = _audit.canonical_key(self._next_rid if key is None else key)
        if self._health in (Health.DRAINING, Health.STOPPED):
            raise EngineDraining(f"engine is {self._health.value}; submit to another replica")
        # Prefill cost in chunks (a prefix-cache hit shrinks the suffix;
        # probe only, the authoritative match happens at admission).
        suffix = len(prompt)
        hashes = None
        if self.prefix is not None:
            hashes = page_hashes(prompt, self.block_size)
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
            victim = self.scheduler.shed_oldest()
            if victim is not None:
                _T_SHED.add()
                self._n_shed += 1
                victim.handle._fail(EngineOverloaded(
                    f"request {victim.rid} shed under load (drop-oldest)"))

        deadline = time.perf_counter() + deadline_s if deadline_s is not None else None
        rid = self._next_rid
        self._next_rid += 1
        handle = RequestHandle(self, rid)
        tid = trace_id
        if tid is None and _telemetry.events_enabled():
            tid = f"{self.engine_id}-r{rid}"
        req = Request(
            rid, prompt, int(max_new_tokens), key, handle, deadline=deadline,
            n_chunks=n_chunks, hashes=hashes, tenant=tenant, priority=priority,
            trace_id=tid, hop=int(hop), model_version=self.model_version,
            digest=_audit.DeterminismDigest(prompt, key),
        )
        handle._req = req
        extra = {}
        if tid is not None:
            extra["prompt"] = [int(t) for t in prompt]
            extra["key"] = [int(kk) for kk in key]
        self._event("req.submitted", req, n_prompt=len(prompt), max_new=int(max_new_tokens),
                    tenant=tenant, priority=priority, deadline_s=deadline_s,
                    n_chunks=req.n_chunks, **extra)
        self.scheduler.push(req)
        self._event("req.queued", req, queue_depth=len(self.scheduler))
        _T_REQUESTS.add()
        return handle

    def drain(self) -> None:
        """Step until every submitted request has finished."""
        while len(self.scheduler) or self._n_running():
            self.step()

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

    def begin_drain(self) -> None:
        """Start a graceful drain now, without a preemption signal: the
        path a SIGTERM takes.  No-op when already DRAINING or STOPPED."""
        if self._health not in (Health.DRAINING, Health.STOPPED):
            self._begin_drain()

    def _set_health(self, health: Health) -> None:
        if health is not self._health:
            self._health = health
            _G_HEALTH.set(health.value)
            self._lg_health.set(health.value)

    def _n_running(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _n_decoding(self) -> int:
        """Slots in the decode batch (occupied and past their prefill)."""
        return sum(r is not None for i, r in enumerate(self._slot_req)
                   if i not in self._prefill_q)

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
        if self._health is not Health.DRAINING and _preemption.requested():
            self._begin_drain()
        self._reap_phase()
        if self._health is not Health.DRAINING:
            self._admit_phase()
        # Chunks advance even while DRAINING: a slot mid-prefill is
        # in-flight work the drain contract promises to finish.
        chunks = self._advance_prefills()
        committed = self._decode_phase()
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
        tick_s = time.perf_counter() - t0
        self.detector.observe_tick(tick_s)
        self._tick_no += 1
        if (committed == 0 and chunks == 0 and not len(self.scheduler)
                and self._n_running() == 0 and self._health is not Health.STOPPED):
            _T_IDLE_TICKS.add()
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

    def _mark_diverging(self) -> None:
        """Divergence hook (:func:`~torchdistx_tpu_torch.telemetry.audit.
        record_divergence`): latch ``serve.diverging{engine=}`` and read
        OVERLOADED until :meth:`clear_divergence`."""
        self._diverging = True
        _telemetry.gauge("serve.diverging", engine=self.engine_id).set(1)
        if self._health in (Health.STARTING, Health.READY):
            self._set_health(Health.OVERLOADED)

    def clear_divergence(self) -> None:
        """Operator acknowledgement: drop the divergence latch."""
        self._diverging = False
        _telemetry.gauge("serve.diverging", engine=self.engine_id).set(0)

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

    def _fail_running_slot(self, slot: int, error) -> None:
        """Abort a running slot: pages back, handle failed typed, slot
        cleared (reap, drain deadline and close all route here)."""
        req = self._slot_req[slot]
        if req.blocks:
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
        for name in ("serve.diverging", "serve.queue_depth", "serve.role"):
            _telemetry.remove(name, engine=self.engine_id)

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
            # Prefill-busy: popping more requests would only park them on
            # pages with zero progress (chunks drain strictly FIFO).
            return
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
            len(free_slots), self.allocator, self.block_size, reclaim=self._reclaim_pages)
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
        the reservation rolls back completely."""
        seq_len = req.replay_len()
        n_total = blocks_needed(req.cache_tokens, self.block_size)
        shared: list = []
        cached_len = 0
        if self.prefix is not None:
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
            raise RuntimeError("prefill could not reserve its promised pages")
        if cached_len and not req.hit_counted:
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
                raise RuntimeError("copy-on-write could not reserve a page")
            copy_pages(self._cache, page, fresh[0])
            req.table[idx] = fresh[0]
            req.blocks[req.blocks.index(page)] = fresh[0]
            self.allocator.free([page])  # drop OUR reference on the shared one
            self._n_cow += 1
            _T_COW.add()

    def _run_chunk(self, seq, table, start: int, end: int, key):
        """One prefill chunk of ``seq[start:end]`` against ``table``,
        padded to its bucket.  Returns the sampled first token on the
        final chunk (``end == len(seq)``), else None.  Padding positions
        land in the request's own not-yet-decoded tail or the trash page;
        their logits are ignored."""
        n = end - start
        bucket = self._chunk_bucket(n)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = seq[start:end]
        dev = self.device
        logits, _ = self.model.forward_paged(
            torch.from_numpy(tokens).to(dev), self._cache,
            torch.from_numpy(np.asarray(table, np.int64)[None]).to(dev),
            torch.full((1,), start, dtype=torch.int64, device=dev), self._weights)
        if end < len(seq):
            return None
        last = logits[:, n - 1]
        words = torch.from_numpy(np.asarray(key, np.int64)[None]).to(dev)
        first = sample_keyed(last, words, torch.zeros((1,), dtype=torch.int64, device=dev),
                             self.temperature, self.top_k)
        return int(first[0])

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
            return self._run_chunk(seq, req.table, start, end, req.key)

    def _complete_prefill(self, slot: int, req: Request, first: int) -> None:
        """Last chunk done: register the prompt's full pages in the prefix
        index and install the slot into the decode batch."""
        if self.prefix is not None and req.hashes:
            self.prefix.register(req.hashes, [int(req.table[i]) for i in range(len(req.hashes))],
                                 self.allocator)
        now = time.perf_counter()
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
            raise RuntimeError("prefill could not reserve its promised pages")
        req.blocks = blocks
        table = np.zeros((self._table_width,), np.int64)
        table[: len(blocks)] = blocks
        try:
            first = None
            for start in range(0, len(seq), self.prefill_chunk):
                end = min(start + self.prefill_chunk, len(seq))
                first = self._run_chunk(seq, table, start, end, req.key)
        except BaseException:
            self.allocator.free(blocks)
            req.blocks = None
            raise
        return first, table

    # ------------------------------------------------------------------
    # Decode + the recovery supervisor

    def decoder(self) -> DecodeChunk:
        """The decode chunk of this engine's geometry (built on first use;
        on CUDA its graph is captured at its first call)."""
        geometry = (self.num_slots, self._table_width, self.decode_chunk, self.temperature,
                    self.top_k, self.eos_id)
        dec = self._decoders.get(geometry)
        if dec is None:
            dec = self._decoders[geometry] = DecodeChunk(
                self.model, self._weights, self._cache, num_slots=self.num_slots,
                table_width=self._table_width, n_steps=self.decode_chunk,
                temperature=self.temperature, top_k=self.top_k, eos_id=self.eos_id,
                device=self.device)
        return dec

    def _decode_phase(self) -> int:
        """One decode chunk over the running slots; returns the number of
        tokens committed."""
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
        slots = [slot for slot, req in enumerate(self._slot_req)
                 if req is not None and slot not in self._prefill_q]
        sp = _telemetry.start_span("serve.step", n_active=len(slots), chunk=self.decode_chunk)
        t0 = time.perf_counter()
        try:
            out = self.decoder()(self._tokens, self._positions, self._n_gen, self._done,
                                 self._keys, self._tables)
        except (KeyboardInterrupt, SystemExit, GraphCaptureError, faults.FatalInjectedFault):
            sp.cancel()
            raise
        except Exception as err:
            sp.cancel()
            self._dispatch_failed(err)
            return 0
        if kind == "corrupt" and slots:
            # The audit plane's fault: one committed token flipped on the
            # host, a silent determinism break only a digest can catch.
            out = out.copy()
            out[0, slots[0]] = int(out[0, slots[0]]) ^ 1
            _T_CORRUPTIONS.add()
        self._consec_decode_failures = 0
        dt = time.perf_counter() - t0
        self._decode_s += dt
        committed = 0
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
        if committed:
            self._h_tpot.observe(dt / self.decode_chunk, n=committed)
        sp.end(tokens=committed)
        self._decode_tokens += committed
        if self._decode_s > 0:
            _G_DECODE_TPS.set(round(self._decode_tokens / self._decode_s, 1))
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
    # The parts left for ROADMAP A7

    def migrate_out(self, slot: int) -> dict:
        raise _unported("migrate_out (stream migration)")

    def migrate_in(self, snapshot: dict):
        raise _unported("migrate_in (stream migration)")

    def resume_from_journal(self, *args, **kwargs):
        raise _unported("resume_from_journal (the request journal)")

    # ------------------------------------------------------------------
    # Introspection

    def stats(self) -> dict:
        """Host-side serving stats: TTFT percentiles, sustained decode,
        lifecycle counts, prefix-cache effectiveness, graph captures."""
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
            "role": self.role,
            "decode_graphs": sum(d.graph is not None for d in self._decoders.values()),
            "decode_replays": sum(d.replays for d in self._decoders.values()),
        }
        if self.prefix is not None:
            out["prefix_cached_pages"] = len(self.prefix)
            out["prefix_hits"] = self.prefix.hits
            out["prefix_hit_tokens"] = self.prefix.hit_tokens
            out["prefix_evictions"] = self.prefix.evictions
            out["cow_copies"] = self._n_cow
        if self._diverging:
            out["diverging"] = True
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
