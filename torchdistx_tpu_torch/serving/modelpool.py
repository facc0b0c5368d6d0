"""Model plane: many models on one engine, one page pool.

Counterpart of ``torchdistx_tpu/serving/modelpool.py``.  The paper's
load-bearing feature — record a model's construction at near-zero cost,
materialize on demand — applied to serving capacity.  An
:class:`~.engine.Engine` is married to one *pool geometry* (layers ×
block_size × kv-heads × head-dim × dtype — what a KV page looks like),
not to one set of weights: any model whose pages look the same can decode
into the same pool.  The :class:`ModelPool` holds N such models over one
engine:

* **register** — a model enters as a *skeleton*: the family module
  recorded by :func:`~torchdistx_tpu_torch.deferred_init.deferred_init`
  (``device_="cuda"``), its parameters fake — 0 device bytes, the geometry
  read from their shapes (:meth:`ModelPool.geometry`).  Registration
  validates the KV page geometry against the engine's pool (from the
  skeleton's ``init_cache`` on the meta device): an incompatible model is
  rejected at register time, not at first traffic.
* **materialize on demand** — the first ``submit(model=...)`` for a cold
  model queues it; the engine materializes the weights *between* ticks
  (one model per tick, after the decode dispatch).  By default a seeded
  :func:`~torchdistx_tpu_torch.materialize.materialize_module_torch` of
  the skeleton onto the engine's device, loaded by assignment into a fresh
  module of the skeleton's class, then ``prep_decode()``; a caller may
  pass ``materialize=`` a factory returning a module on the engine's
  device instead.  The skeleton itself is never touched.  The
  ``serve.materialize`` fault site fires per attempt; a transient
  (``io``) failure leaves the skeleton untouched and retries next tick.
* **evict under pressure** — materializing over ``hbm_budget_bytes`` (or
  ``max_resident``) first drops the least-recently-used *cold* models.  A
  model with any slot (running, prefilling or swapped out) is never
  evicted.  The policy reads the HBM ledger's per-owner rows
  (:meth:`~torchdistx_tpu_torch.telemetry.perf.Ledger.owners`), whose
  ``weights`` rows count each model's parameters and its ``prep_decode``
  copy.  Eviction drops the model's decode graphs first (a graph holds
  the weights by address), then the weights; KV pages, streams and the
  prefix index are untouched.

Determinism is per model: every registered model carries its own
``model_version``, folded into every request digest, and the prefix index
is namespaced by the model tag — two models never share a KV page or a
digest, even for identical prompts.

Telemetry: ``serve.models_resident{engine=}``,
``serve.model_state{engine=,model=}`` (0 skeleton / 1 materialized),
``serve.materializations`` / ``serve.model_evictions``,
``serve.materialize_s{engine=}`` (the stall histogram),
``mem.hbm_bytes{component=weights}`` rows per model owner, and
``model.registered`` / ``model.materialized`` / ``model.evicted`` events
under a ``serve.materialize`` span.  All per-engine families are pruned
when the engine stops.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import telemetry as _telemetry
from ..resilience import faults
from ..telemetry import perf as _perf

__all__ = ["DEFAULT_MODEL", "ModelPool"]

# The engine's own construction-time model: always materialized, never
# evictable, namespace b"" (single-model prefix hashes are unchanged).
DEFAULT_MODEL = "default"

_T_MATERIALIZATIONS = _telemetry.counter("serve.materializations")
_T_EVICTIONS = _telemetry.counter("serve.model_evictions")
_T_MODEL_STALLS = _telemetry.counter("serve.model_stalls")


class _ModelEntry:
    """One registered model: skeleton always, weights sometimes."""

    __slots__ = ("tag", "skeleton", "cfg", "model_version", "materialize", "seed",
                 "nbytes_estimate", "model", "weights", "params_nbytes", "last_used",
                 "materializations", "evictions", "last_stall_s")

    def __init__(self, tag, skeleton, model_version, materialize, seed, nbytes_estimate):
        self.tag = tag
        self.skeleton = skeleton
        self.cfg = skeleton.cfg
        self.model_version = model_version
        self.materialize = materialize
        self.seed = seed
        self.nbytes_estimate = nbytes_estimate
        self.model = None  # the materialized module while resident
        self.weights = None  # its prep_decode() while resident
        self.params_nbytes = 0
        self.last_used = 0  # LRU clock value of the latest demand
        self.materializations = 0
        self.evictions = 0
        self.last_stall_s: Optional[float] = None

    @property
    def ready(self) -> bool:
        return self.model is not None

    @property
    def namespace(self) -> bytes:
        """Prefix-chain seed: pages are content-addressed per model."""
        return self.tag.encode("utf-8")


def _tensors(module) -> list:
    """Every parameter and buffer of ``module``, tied ones once."""
    seen, out = set(), []
    for t in list(module.parameters()) + list(module.buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def module_nbytes(module) -> int:
    """Bytes of ``module``'s parameters and buffers from their shapes and
    dtypes alone — exact for a fake skeleton too (the inspectable half of
    deferred init: cost known before a byte is committed)."""
    return sum(t.numel() * t.element_size() for t in _tensors(module))


def page_geometry(module, block_size: int) -> tuple:
    """What :func:`~.cache.pool_geometry` would say of a pool built for
    ``module``, from its ``init_cache`` on the meta device (nothing is
    allocated; a fake skeleton works)."""
    proto = module.init_cache(1, 1, device="meta")
    return tuple(
        (name, leaf.shape[0], block_size) + tuple(leaf.shape[3:]) + (str(leaf.dtype),)
        for name, leaf in sorted(proto.items())
    )


def _seeded_module(skeleton, seed: int, device):
    """A module of the skeleton's class holding the seeded replay of its
    recording on ``device``; the skeleton is not touched."""
    from ..materialize import materialize_module_torch

    values = materialize_module_torch(skeleton, seed=seed, device=device)
    module = type(skeleton)(skeleton.cfg, device="meta")
    module.load_state_dict(values, assign=True)
    return module


class ModelPool:
    """Deferred-init skeleton registry + weight residency manager for one
    engine.

    Construct, register models, then hand to ``Engine(..., model_pool=pool)``;
    the engine binds the pool (validating every skeleton against its live
    pool geometry) and routes ``submit(model=tag)`` traffic through it.
    ``register`` also works after binding.

    ``hbm_budget_bytes`` caps the ledger total (weights + kv_pool +
    prefix_cache_held + everything else registered) the pool will
    materialize into: crossing it evicts LRU cold models first.  The
    budget is a pressure threshold, not a hard wall — if every other model
    is pinned by live streams the demanded model still materializes.
    ``max_resident`` is the count-based equivalent (N materialized pool
    models max); either, both, or neither may be set.
    """

    def __init__(self, *, hbm_budget_bytes: Optional[int] = None,
                 max_resident: Optional[int] = None):
        if hbm_budget_bytes is not None and hbm_budget_bytes <= 0:
            raise ValueError("hbm_budget_bytes must be positive")
        if max_resident is not None and max_resident < 1:
            raise ValueError("max_resident must be >= 1")
        self.hbm_budget_bytes = hbm_budget_bytes
        self.max_resident = max_resident
        self._entries: "OrderedDict[str, _ModelEntry]" = OrderedDict()
        self._engine = None
        self._clock = 0
        self._materialize_no = 0  # serve.materialize fault-site attempts
        self.materialize_retries = 0
        # Per-engine labeled families (minted at bind, pruned at close):
        self._g_resident = None
        self._h_materialize = None
        self._g_state: Dict[str, Any] = {}
        self._c_requests: Dict[str, Any] = {}
        self._c_tokens: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # Registry

    def register(self, tag: str, *, module, materialize: Optional[Callable[[], Any]] = None,
                 model_version: Optional[str] = None, seed: int = 0) -> None:
        """Admit ``module`` as a skeleton — 0 device bytes until demanded.

        ``module``: the family module (``Llama``, ``GPT2``) recorded by
        ``deferred_init(..., device_="cuda")``; its shapes give the
        geometry and the byte estimate.  ``materialize()``, when given,
        must return a module of the same architecture on the engine's
        device (a checkpoint load, say); by default the skeleton's seeded
        replay under ``seed``.  ``model_version`` defaults to the tag — it
        seeds every request digest, so two registered models can never
        produce colliding digests."""
        if not tag or tag == DEFAULT_MODEL:
            raise ValueError(f"model tag must be non-empty and not {DEFAULT_MODEL!r} "
                             "(the engine's own model)")
        if tag in self._entries:
            raise ValueError(f"model {tag!r} already registered")
        if not hasattr(module, "init_cache") or not hasattr(module, "cfg"):
            raise ValueError(f"model {tag!r}: expected a family module (cfg, init_cache, "
                             f"forward_paged, prep_decode), got {type(module).__name__}")
        entry = _ModelEntry(tag, module,
                            model_version if model_version is not None else tag,
                            materialize, int(seed), module_nbytes(module))
        if self._engine is not None:
            self._check_geometry(entry)
        self._entries[tag] = entry
        if self._engine is not None:
            self._mint_model_metrics(entry)
        _telemetry.event("model.registered", model=tag, version=entry.model_version,
                         nbytes=entry.nbytes_estimate, n_leaves=len(_tensors(module)),
                         engine=getattr(self._engine, "engine_id", None))

    def tags(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, tag: str) -> bool:
        return tag in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def ready(self, tag: str) -> bool:
        """True when ``tag``'s weights are resident (admissible now)."""
        return self._entries[tag].ready

    def geometry(self, tag: str) -> Dict[str, Any]:
        """The skeleton's inspectable geometry — what deferred init
        promises: full architecture knowledge at near-zero cost, before
        (or instead of) paying for the weights."""
        entry = self._entries[tag]
        tensors = _tensors(entry.skeleton)
        return {
            "tag": tag,
            "version": entry.model_version,
            "materialized": entry.ready,
            "n_leaves": len(tensors),
            "n_params": sum(t.numel() for t in tensors),
            "nbytes": entry.nbytes_estimate,
        }

    # ------------------------------------------------------------------
    # Engine binding

    def _bind(self, engine) -> None:
        """Called by ``Engine.__init__``: validate every skeleton against
        the live pool geometry and mint the per-engine labeled families."""
        if self._engine is not None:
            raise ValueError("ModelPool is already bound to an engine — one pool serves "
                             "one engine (its weights ledger rows and labeled metric "
                             "families are per-engine)")
        for entry in self._entries.values():
            self._check_geometry(entry, engine)
        self._engine = engine
        eid = engine.engine_id
        self._g_resident = _telemetry.gauge("serve.models_resident", engine=eid)
        self._g_resident.set(0)
        self._h_materialize = _telemetry.histogram("serve.materialize_s", engine=eid)
        for entry in self._entries.values():
            self._mint_model_metrics(entry)

    def _check_geometry(self, entry: _ModelEntry, engine=None) -> None:
        from .cache import pool_geometry

        eng = engine if engine is not None else self._engine
        want = pool_geometry(eng._cache)
        got = page_geometry(entry.skeleton, eng.block_size)
        if got != want:
            raise ValueError(
                f"model {entry.tag!r} cannot share engine {eng.engine_id}'s page pool: KV "
                f"page geometry {got} != pool geometry {want} (layers/heads/head-dim/dtype "
                "must match; block_size already does by construction)")

    def _mint_model_metrics(self, entry: _ModelEntry) -> None:
        eid = self._engine.engine_id
        tag = entry.tag
        self._g_state[tag] = _telemetry.gauge("serve.model_state", engine=eid, model=tag)
        self._g_state[tag].set(1 if entry.ready else 0)
        self._c_requests[tag] = _telemetry.counter("serve.model_requests", engine=eid,
                                                   model=tag)
        self._c_tokens[tag] = _telemetry.counter("serve.model_tokens", engine=eid, model=tag)

    # ------------------------------------------------------------------
    # Residency

    def _touch(self, tag: str) -> _ModelEntry:
        """Record demand (the LRU clock) and return the entry."""
        entry = self._entries[tag]
        self._clock += 1
        entry.last_used = self._clock
        return entry

    def _note_request(self, tag: str) -> None:
        c = self._c_requests.get(tag)
        if c is not None:
            c.add()

    def _note_tokens(self, tag: str, n: int) -> None:
        c = self._c_tokens.get(tag)
        if c is not None and n:
            c.add(n)

    def _note_stall(self, tag: str) -> None:
        """An admission tick held back by ``tag`` being cold."""
        _T_MODEL_STALLS.add()

    def resident(self) -> List[str]:
        return [t for t, e in self._entries.items() if e.ready]

    def _owner_key(self, tag: str) -> str:
        return f"model:{self._engine.engine_id}:{tag}"

    def _load(self, entry: _ModelEntry):
        device = self._engine.device
        if entry.materialize is None:
            module = _seeded_module(entry.skeleton, entry.seed, device)
        else:
            module = entry.materialize()
        got = next(module.parameters()).device
        if got != device and not (got.type == device.type == "cuda" and device.index is None):
            raise ValueError(f"model {entry.tag!r} materialized on {got}, the engine runs "
                             f"on {device}")
        return module

    def ensure(self, tag: str):
        """Materialize ``tag`` if cold (evicting under pressure first);
        return its entry.  The engine calls this from its materialize
        phase — after the tick's decode dispatch, one model per tick — but
        it is also the public warm-up hook: call it before opening traffic
        to take the stall off the first request.  The stall
        (``entry.last_stall_s``, ``serve.materialize_s``) is the seeded
        replay plus ``prep_decode``, synchronized on CUDA."""
        if self._engine is None:
            raise ValueError("ModelPool.ensure before binding an engine")
        entry = self._touch(tag)
        if entry.ready:
            return entry
        self._evict_for(entry)
        self._materialize_no += 1
        sp = _telemetry.start_span("serve.materialize", model=tag,
                                   engine=self._engine.engine_id)
        t0 = time.perf_counter()
        try:
            # The fault site fires inside the span with nothing allocated
            # and nothing registered: a kill here leaves only the skeleton.
            kind = faults.fire("serve.materialize", self._materialize_no)
            if kind is not None:  # nan/corrupt cooperation: attempt poisoned
                raise faults.InjectedFault(
                    f"injected {kind} fault at serve.materialize:{self._materialize_no}")
            with torch.no_grad():
                module = self._load(entry)
                weights = module.prep_decode()
            if self._engine.device.type == "cuda":
                torch.cuda.synchronize(self._engine.device)
        except BaseException:
            sp.cancel()
            raise
        stall_s = time.perf_counter() - t0
        entry.model, entry.weights = module, weights
        entry.params_nbytes = module_nbytes(module) + _perf.pytree_nbytes(weights)
        entry.materializations += 1
        entry.last_stall_s = stall_s
        _T_MATERIALIZATIONS.add()
        _perf.ledger.register("weights", entry.params_nbytes, owner=self._owner_key(tag))
        if self._h_materialize is not None:
            self._h_materialize.observe(stall_s)
        g = self._g_state.get(tag)
        if g is not None:
            g.set(1)
        if self._g_resident is not None:
            self._g_resident.set(len(self.resident()))
        _telemetry.event("model.materialized", model=tag, version=entry.model_version,
                         nbytes=entry.params_nbytes, stall_s=round(stall_s, 6),
                         engine=self._engine.engine_id)
        sp.end(nbytes=entry.params_nbytes, stall_s=round(stall_s, 6))
        return entry

    def _drop(self, entry: _ModelEntry) -> None:
        """The model's decode graphs first (they hold its weights by
        address), then the weights and the ledger row."""
        if self._engine is not None:
            self._engine._drop_decoders(entry.tag)
            _perf.ledger.unregister("weights", owner=self._owner_key(entry.tag))
        entry.model = entry.weights = None
        entry.params_nbytes = 0

    def evict(self, tag: str) -> bool:
        """Drop ``tag``'s weights back to the skeleton.  Refuses (False)
        while any live stream — running, prefilling, or swapped-out slot —
        is on the model; queued requests re-demand materialization at
        admission, so they never pin weights."""
        entry = self._entries[tag]
        if not entry.ready:
            return False
        if self._engine is not None and self._engine._model_in_use(tag):
            return False
        nbytes = entry.params_nbytes
        self._drop(entry)
        entry.evictions += 1
        _T_EVICTIONS.add()
        g = self._g_state.get(tag)
        if g is not None:
            g.set(0)
        if self._g_resident is not None:
            self._g_resident.set(len(self.resident()))
        _telemetry.event("model.evicted", model=tag, version=entry.model_version,
                         nbytes=nbytes, engine=getattr(self._engine, "engine_id", None))
        return True

    def _evict_for(self, incoming: _ModelEntry) -> int:
        """Make room for ``incoming`` under the residency knobs: evict LRU
        cold models until under budget (or nothing cold remains).  Returns
        models evicted."""
        evicted = 0
        while True:
            over = False
            if self.max_resident is not None:
                over = len(self.resident()) >= self.max_resident
            if not over and self.hbm_budget_bytes is not None:
                # Real ledger rows, per owner: pressure is against what is
                # actually held, not against a private estimate.
                held = sum(_perf.ledger.owners().values())
                over = held + incoming.nbytes_estimate > self.hbm_budget_bytes
            if not over:
                return evicted
            victim = None
            for entry in self._entries.values():
                if not entry.ready or entry is incoming:
                    continue
                if self._engine is not None and self._engine._model_in_use(entry.tag):
                    continue
                if victim is None or entry.last_used < victim.last_used:
                    victim = entry
            if victim is None:
                # Everything resident is pinned by live streams: serve the
                # demand anyway (the budget is pressure, not a wall).
                return evicted
            self.evict(victim.tag)
            evicted += 1

    # ------------------------------------------------------------------
    # Teardown / introspection

    def _close(self) -> None:
        """Engine stop: drop every weight, unregister every ledger row,
        prune every per-engine labeled family."""
        for entry in self._entries.values():
            if entry.ready:
                self._drop(entry)
        if self._engine is not None:
            eid = self._engine.engine_id
            _telemetry.remove("serve.models_resident", engine=eid)
            for tag in self._entries:
                _telemetry.remove("serve.model_state", engine=eid, model=tag)
                _telemetry.remove("serve.model_requests", engine=eid, model=tag)
                _telemetry.remove("serve.model_tokens", engine=eid, model=tag)
        self._g_resident = None
        self._h_materialize = None
        self._g_state.clear()
        self._c_requests.clear()
        self._c_tokens.clear()

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "n_registered": len(self._entries),
            "n_resident": len(self.resident()),
            "materialize_retries": self.materialize_retries,
            "models": {},
        }
        if self._h_materialize is not None and self._h_materialize.count:
            out["materialize_p95_s"] = round(self._h_materialize.percentile(95), 6)
        for tag, entry in self._entries.items():
            out["models"][tag] = {
                "materialized": entry.ready,
                "version": entry.model_version,
                "nbytes": entry.params_nbytes if entry.ready else entry.nbytes_estimate,
                "materializations": entry.materializations,
                "evictions": entry.evictions,
            }
        return out
