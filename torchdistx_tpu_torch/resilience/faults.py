"""Deterministic fault injection: ``TDX_FAULT="site:step:kind[,...]"``.

Counterpart of ``torchdistx_tpu/resilience/faults.py``: the same grammar,
sites and kinds, so a ``TDX_FAULT`` value parses (or is rejected) exactly
as there.  The serving and journal sites belong to modules not yet ported;
they parse all the same.

Proving crash/retry/skip paths with real process games (kill -9 at "about
the right time", flaky network mocks) makes resilience tests the least
reliable tests in a suite.  Instead, named *sites* in the training stack
ask this registry "do I fail now?" — the answer is a pure function of
the ``TDX_FAULT`` spec and the step number, so every CI run exercises
exactly the same failure at exactly the same step.

Grammar (comma-separated specs)::

    TDX_FAULT="site:step:kind[,site:step:kind...]"

Sites (where the stack asks):

* ``ckpt.save``  — inside ``Checkpointer.save``, before the state is
  snapshotted (so a
  retry re-enters the site and succeeds once the spec is consumed).
* ``data.next``  — in ``fit()`` before pulling the next batch.
* ``step.exec``  — in ``fit()`` before executing the step.
* ``serve.admit`` — in the serving engine's admission phase, before any
  request is popped or any page allocated (step = admission attempt;
  ``nan`` skips the admission tick).
* ``serve.prefill`` — before the engine dispatches one request's
  prefill (step = prefill attempt).  ``io``/``nan`` return the request
  (and the rest of the admission batch) to the FIFO head; the next tick
  retries in order.
* ``serve.step``  — before the serving engine dispatches a decode chunk
  (step = decode-chunk number).  ``nan`` here means "this chunk is
  poisoned": the engine skips it cleanly and re-runs next tick.
* ``serve.recover`` — before one replay attempt of the engine's
  crash-recovery supervisor (step = replay attempt).  ``io``/``nan``
  fail that replay, consuming the request's recovery budget — the path
  that proves budgets exhaust into typed errors instead of hangs.
* ``serve.swap`` — before one swap-to-host page gather of the QoS
  preemption path (step = swap attempt).  ``io``/``nan`` fail the swap
  — the gather is read-only, so device state is untouched and the
  preemption falls back to drop-and-replay, still token-identical.
* ``serve.migrate_out`` — before one cross-engine stream-migration
  export (step = export attempt).  ``io``/``nan`` fail the export
  BEFORE the page gather: the source stream keeps running untouched —
  a failed export must never strand or double-serve a live stream.
* ``serve.migrate_in`` — mid-import of a migrated stream, after the
  destination allocated its pages but before the scatter (step = import
  attempt).  ``io``/``nan`` fail the import: the partial page set is
  freed on the destination (no leak) and the stream falls back to a
  cold key-pinned replay — no double-serve, token-identical either way.
* ``serve.materialize`` — before the model pool materializes one
  registered model's weights (step = materialize attempt).  ``io``/
  ``nan`` fail that attempt: the model stays a skeleton (no partial
  weights, no ledger row) and the next tick with demand retries;
  ``crash`` is the kill-mid-materialize drill — the process dies with
  nothing registered, so recovery starts from the skeleton.
* ``journal.append`` — before one request-journal record append (step
  = append attempt).  ``io`` fails that append: the engine counts
  ``journal.append_errors`` and keeps serving — durability is
  best-effort once the disk itself fails; ``crash`` dies before the
  record lands (the torn-tail / lost-record drill).
* ``journal.fsync`` — before one journal fsync (step = fsync attempt).
  ``io`` degrades the journal to ``fsync=async`` with a
  ``journal.fsync_degraded`` counter — a slow or failing disk must
  never block the tick.
* ``journal.recover`` — before one cold-restart journal scan (step =
  recover attempt).  ``io`` fails that recovery loudly — nothing is
  half-resumed; the caller retries or escalates.

Kinds (what happens):

* ``io``      — raise :class:`InjectedFault` (an ``OSError``: retryable
  under the default :class:`~torchdistx_tpu_torch.resilience.retry.RetryPolicy`).
* ``fatal``   — raise :class:`FatalInjectedFault` (a ``RuntimeError``:
  NOT retryable; proves fatal errors propagate).
* ``crash``   — ``os._exit(CRASH_EXIT_CODE)``: a hard kill, no ``finally``
  blocks, no atexit — the SIGKILL/power-loss simulation.
* ``sigterm`` — ``os.kill(os.getpid(), SIGTERM)``: a real signal through
  the real handler — the preemption simulation.
* ``nan``     — needs caller cooperation (returned, not raised).  At
  ``step.exec``, ``fit()`` poisons the step's loss (via the reserved
  ``_tdx_nan`` batch key understood by ``make_train_step``) so the
  step's non-finite guard trips; at ``serve.step`` the serving engine
  treats the decode chunk as poisoned and skips it.
* ``corrupt`` — needs caller cooperation (returned, not raised).  At
  ``serve.step`` the engine runs the decode chunk normally, then flips
  ONE committed token (first decoding slot, first token of the chunk,
  XOR 1) on the host — a **silent** determinism break: nothing raises,
  nothing retries, the stream stays plausible.  The only thing that
  can catch it is the audit plane (the shadow auditor's digest
  comparison — docs/observability.md, "Audit plane"), which is exactly
  what this kind exists to prove.  At other cooperation-checking sites
  it is treated like ``nan`` (the attempt is poisoned and skipped).

``step`` is the 1-based global step number.  Each spec fires ONCE (the
first time its site+step matches), so a retried site succeeds on the
next attempt; every firing bumps the ``faults.fired`` counter — and,
when telemetry is recording, emits a ``fault.fired`` event carrying
``site``/``step``/``kind``, so a flight dump names the fault sites an
incident replay must re-arm to reproduce the run.
"""

from __future__ import annotations

import os
import signal
import threading
from dataclasses import dataclass, field
from typing import List, Optional

from .. import telemetry as _telemetry

__all__ = [
    "CRASH_EXIT_CODE",
    "FatalInjectedFault",
    "FaultSpec",
    "InjectedFault",
    "active",
    "fire",
    "parse_faults",
    "reset",
]

ENV_VAR = "TDX_FAULT"
CRASH_EXIT_CODE = 13
SITES = frozenset(
    {
        "ckpt.save",
        "data.next",
        "step.exec",
        "serve.admit",
        "serve.prefill",
        "serve.step",
        "serve.recover",
        "serve.swap",
        "serve.migrate_out",
        "serve.migrate_in",
        "serve.materialize",
        "journal.append",
        "journal.fsync",
        "journal.recover",
    }
)
KINDS = frozenset({"io", "fatal", "crash", "sigterm", "nan", "corrupt"})

_T_FIRED = _telemetry.counter("faults.fired")


class InjectedFault(OSError):
    """A transient injected failure (retryable by default policies)."""


class FatalInjectedFault(RuntimeError):
    """An injected failure no policy should retry."""


@dataclass
class FaultSpec:
    site: str
    step: int
    kind: str
    fired: bool = field(default=False, compare=False)


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse a ``TDX_FAULT`` value; raises ``ValueError`` on bad grammar
    (a mistyped injection silently doing nothing would "pass" CI)."""
    specs: List[FaultSpec] = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        pieces = part.split(":")
        if len(pieces) != 3:
            raise ValueError(
                f"TDX_FAULT spec {part!r}: expected 'site:step:kind'"
            )
        site, step_s, kind = (p.strip() for p in pieces)
        if site not in SITES:
            raise ValueError(
                f"TDX_FAULT spec {part!r}: unknown site {site!r} "
                f"(sites: {sorted(SITES)})"
            )
        if kind not in KINDS:
            raise ValueError(
                f"TDX_FAULT spec {part!r}: unknown kind {kind!r} "
                f"(kinds: {sorted(KINDS)})"
            )
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(
                f"TDX_FAULT spec {part!r}: step {step_s!r} is not an int"
            ) from None
        if step < 1:
            raise ValueError(
                f"TDX_FAULT spec {part!r}: step must be >= 1 (1-based)"
            )
        specs.append(FaultSpec(site, step, kind))
    return specs


class _Registry:
    """Process singleton, lazily seeded from ``TDX_FAULT``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: Optional[List[FaultSpec]] = None

    def _ensure(self) -> List[FaultSpec]:
        if self._specs is None:
            with self._lock:
                if self._specs is None:
                    text = os.environ.get(ENV_VAR, "")
                    self._specs = parse_faults(text) if text else []
        return self._specs

    def reset(self, text: Optional[str] = None) -> None:
        """Reload from ``text`` (tests) or from the environment."""
        with self._lock:
            self._specs = parse_faults(text) if text is not None else None

    def active(self) -> bool:
        return bool(self._ensure())

    def check(self, site: str, step: int) -> Optional[str]:
        """Consume and return the kind of the first unfired matching
        spec, or None.  Does not act on the kind."""
        specs = self._ensure()
        if not specs:  # fast path: registry empty in production
            return None
        with self._lock:
            for spec in specs:
                if not spec.fired and spec.site == site and spec.step == step:
                    spec.fired = True
                    _T_FIRED.add()
                    return spec.kind
        return None


_registry = _Registry()

reset = _registry.reset
active = _registry.active


def fire(site: str, step: int) -> Optional[str]:
    """Ask the registry whether to fail at ``site`` for ``step`` — and
    act: raise for ``io``/``fatal``, hard-exit for ``crash``, signal for
    ``sigterm``.  Kinds that need caller cooperation (``nan``) are
    returned; None means "no fault here".
    """
    kind = _registry.check(site, step)
    if kind is None:
        return None
    # Recorded BEFORE acting (a crash kind never returns): the trace —
    # and any flight dump cut from it — names the injected fault, so an
    # incident replay can re-arm the exact same schedule.
    _telemetry.event("fault.fired", site=site, step=step, kind=kind)
    if kind == "io":
        raise InjectedFault(f"injected io fault at {site}:{step}")
    if kind == "fatal":
        raise FatalInjectedFault(f"injected fatal fault at {site}:{step}")
    if kind == "crash":
        os._exit(CRASH_EXIT_CODE)
    if kind == "sigterm":
        # A REAL signal through the real handler chain: the preemption
        # path under test is the production path, not a mock of it.
        os.kill(os.getpid(), signal.SIGTERM)
        return None
    return kind
