"""Serving: continuous batching over a paged KV cache, streaming handles.

Counterpart of ``torchdistx_tpu.serving``'s core:

* :mod:`.blocks` — the host-side page allocator (refcounted pages, page 0
  the trash page, backpressure on exhaustion);
* :mod:`.cache` — the device page pool, the prompt scatter and the
  copy-on-write page copy, all in place;
* :mod:`.prefix` — the refcounted prefix index (chained page hashes, LRU
  eviction under pressure);
* :mod:`.scheduler` — FIFO admission and the streaming
  :class:`~.scheduler.RequestHandle`;
* :mod:`.lifecycle` — typed errors, :class:`~.lifecycle.Health` and the
  :class:`~.lifecycle.OverloadDetector`;
* :mod:`.qos` — the :class:`~.qos.QoSScheduler` (priority classes,
  weighted fair queueing, EDF);
* :mod:`.modelpool` — the :class:`~.modelpool.ModelPool` of deferred-init
  skeletons materialized on demand;
* :mod:`.journal` — the crash-consistent :class:`~.journal.RequestJournal`
  (JAX's on-disk format) behind ``Engine.resume_from_journal``;
* :mod:`.engine` — the continuous-batching :class:`~.engine.Engine`
  (eager prefill chunks per bucket, the decode chunk as one CUDA graph a
  geometry and model on the card; QoS preemption by swap or replay,
  ``submit(n>1)`` forks, the model plane, the journal, migration).

Quick start::

    from torchdistx_tpu_torch.serving import Engine

    eng = Engine(model, num_slots=8, block_size=16, max_model_len=1024)
    h = eng.submit(prompt_ids, max_new_tokens=128, key=0, deadline_s=30)
    for tok in h.tokens():      # streams; drives the engine
        print(tok)

The shadow auditor and the ops plane are ROADMAP A7 and raise
``NotImplementedError``.
"""

from .blocks import TRASH_BLOCK, BlockAllocator, blocks_needed  # noqa: F401
from .cache import (  # noqa: F401
    copy_pages,
    fresh_pool,
    init_paged_cache,
    pool_geometry,
    swap_in_pages,
    swap_out_pages,
    write_prompt,
)
from .engine import DecodeChunk, Engine, GraphCaptureError  # noqa: F401
from .journal import JournalEntry, RequestJournal, read_records, read_segment  # noqa: F401
from .lifecycle import (  # noqa: F401
    DeadlineExceeded,
    DeterminismDiverged,
    EngineDraining,
    EngineOverloaded,
    Health,
    JournalOwned,
    MigrationIncompatible,
    OverloadDetector,
    RecoveryFailed,
    RequestCancelled,
    RequestError,
    RequestPreempted,
)
from .modelpool import DEFAULT_MODEL, ModelPool  # noqa: F401
from .prefix import PrefixIndex, page_hashes  # noqa: F401
from .qos import QoSScheduler  # noqa: F401
from .scheduler import FIFOScheduler, Request, RequestHandle  # noqa: F401

__all__ = [
    "DEFAULT_MODEL",
    "BlockAllocator",
    "DeadlineExceeded",
    "DecodeChunk",
    "DeterminismDiverged",
    "Engine",
    "EngineDraining",
    "EngineOverloaded",
    "FIFOScheduler",
    "GraphCaptureError",
    "Health",
    "JournalEntry",
    "JournalOwned",
    "MigrationIncompatible",
    "ModelPool",
    "OverloadDetector",
    "PrefixIndex",
    "QoSScheduler",
    "RecoveryFailed",
    "Request",
    "RequestCancelled",
    "RequestError",
    "RequestHandle",
    "RequestJournal",
    "RequestPreempted",
    "TRASH_BLOCK",
    "blocks_needed",
    "copy_pages",
    "fresh_pool",
    "init_paged_cache",
    "page_hashes",
    "pool_geometry",
    "read_records",
    "read_segment",
    "swap_in_pages",
    "swap_out_pages",
    "write_prompt",
]
