"""Elastic training loop: periodic checkpointing + automatic resume.

Counterpart of ``torchdistx_tpu/parallel/fit.py``, with the same behaviour:
run ``n_steps``, checkpoint every ``checkpoint_every`` steps, and — after a
preemption or a crash — resume from the latest checkpoint.  ``seed`` takes
the place of the JAX ``key``, because the port's ``init_fn`` takes a seed.
The state ``init_fn`` returns is the restore target: the checkpoint is
loaded into it in place (see :mod:`~torchdistx_tpu_torch.utils.checkpoint`).

Resilience (see :mod:`torchdistx_tpu_torch.resilience`):

* **Preemption** — SIGTERM/SIGINT set a flag (handlers installed on
  entry); every step boundary agrees on it across processes
  (:func:`~torchdistx_tpu_torch.parallel.distributed.any_flags`), saves a
  final checkpoint at the last completed step, flushes telemetry counters
  to the trace, and returns — the next invocation resumes exactly there.
* **Retries** — checkpoint IO and the data iterator run under a
  :class:`~torchdistx_tpu_torch.resilience.retry.RetryPolicy`
  (``ckpt.retries`` / ``data.retries`` counters).
* **Non-finite guard** — steps built by :func:`make_train_step` report
  ``metrics["nonfinite"]``; the loop counts skips (``train.skipped_steps``)
  and raises :class:`~torchdistx_tpu_torch.resilience.guard.NonFiniteError`
  after ``max_consecutive_nonfinite`` in a row.  The port's flag is
  already a host bool, but it is read with the JAX package's lag all the
  same, so an escalation fires at the same step as there.
* **Fault injection** — the ``data.next`` and ``step.exec`` sites consult
  :mod:`~torchdistx_tpu_torch.resilience.faults` (``TDX_FAULT``).

Telemetry: every step runs under a ``train.step`` span (with
``TDX_TELEMETRY_PROFILER=1`` a ``torch.profiler`` range), and the loop
derives ``steps_per_s`` / ``tokens_per_s`` / ``mfu``, publishing them as
gauges AND merging them into the metrics dict handed to ``on_metrics``.
Throughput is wall time between successive ``step_fn`` returns (the first
step is skipped).
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Any, Callable, Iterable, Optional

from .. import telemetry as _telemetry
from ..resilience import faults as _faults
from ..resilience import guard as _guard
from ..resilience import preemption as _preemption
from ..resilience.retry import RetryPolicy
from .distributed import any_flags

__all__ = ["fit"]

_T_STEPS = _telemetry.counter("train.steps")
_T_STEPS_S = _telemetry.gauge("train.steps_per_s")
_T_TOKENS_S = _telemetry.gauge("train.tokens_per_s")
_T_MFU = _telemetry.gauge("train.mfu")
_T_DATA_RETRIES = _telemetry.counter("data.retries")
_T_PREEMPTIONS = _telemetry.counter("train.preemptions")

# Steps of lag before the host reads a step's `nonfinite` flag (the JAX
# package's value: there reading a device scalar blocks until that step
# finishes).  Kept so that an escalation fires at the same step.
_NONFINITE_LAG = 2


def _batch_tokens(batch) -> Optional[int]:
    """Token count of one batch: the ``tokens`` leaf's element count (the
    ``{"tokens", "targets"}`` convention of make_train_step)."""
    if not isinstance(batch, dict):
        return None
    shape = getattr(batch.get("tokens"), "shape", None)
    if not shape:
        return None
    return int(math.prod(shape))


def fit(
    init_fn: Callable,
    step_fn: Callable,
    batches: Iterable[Any],
    *,
    seed: int,
    n_steps: int,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    checkpoint_sync: bool = False,
    on_metrics: Optional[Callable[[int, Any], None]] = None,
    tokens_per_batch: Optional[int] = None,
    flops_per_step: Optional[float] = None,
    peak_flops: Optional[float] = None,
    retry: Optional[RetryPolicy] = RetryPolicy(),
    handle_preemption: bool = True,
    max_consecutive_nonfinite: int = 8,
    exit_sync_every: int = 1,
):
    """Run up to ``n_steps`` optimizer steps, resuming from checkpoints.

    ``init_fn(seed) -> state`` and ``step_fn(state, batch) -> (state,
    metrics)`` are the pair built by :func:`make_train_step`.  ``batches``
    yields one batch per step; steps already completed by a restored
    checkpoint are skipped by *advancing* the iterator, so a deterministic
    data stream stays aligned with the optimizer step count after resume
    (a stream that ends before the resume point raises ``ValueError``).

    Resilience knobs (module docstring has the semantics):

    * ``retry`` — policy for checkpoint IO and batch pulls (None
      disables; the default allows 3 attempts with ~0.1 s backoff).
    * ``handle_preemption`` — install SIGTERM/SIGINT handlers and drain
      gracefully at the next step boundary (checkpoint, flush, return).
    * ``checkpoint_sync`` — wait for each periodic save to commit before
      continuing (by default the write overlaps the next steps; the state
      is snapshotted before ``save`` returns either way).
    * ``max_consecutive_nonfinite`` — escalation threshold for the
      non-finite guard (``<= 0`` counts skips but never raises).
    * ``exit_sync_every`` — how often (in steps) the cross-process
      exit-flag collective runs; data exhaustion and pull failures still
      trigger it at once.

    Throughput telemetry: ``steps_per_s`` is always derived;
    ``tokens_per_s`` additionally needs the batch token count
    (``tokens_per_batch``, or auto-detected from a ``{"tokens": ...}``
    batch dict); ``mfu`` additionally needs ``flops_per_step`` (model
    FLOPs per optimizer step) and ``peak_flops`` (the card's peak, in
    FLOP/s).  When ``metrics`` is a dict, the derived values are merged in
    before ``on_metrics`` sees it.

    Returns ``(state, last_metrics)``.
    """
    state = init_fn(seed)
    start = 0
    ckptr = None
    if checkpoint_dir is not None:
        from ..utils.checkpoint import Checkpointer

        ckptr = Checkpointer(checkpoint_dir, retry=retry)
        step, restored = ckptr.restore_latest(target=state)
        if step is not None:
            state, start = restored, step

    metrics = None
    if start >= n_steps:
        return state, metrics

    handlers_preexisting = True
    if handle_preemption:
        handlers_preexisting = _preemption.installed()
        _preemption.install()

    it = iter(batches)

    def _pull(step):
        """Next batch for ``step``, through fault site + retry policy."""
        first_error = []

        def _next():
            _faults.fire("data.next", step)
            try:
                return next(it)
            except StopIteration:
                if first_error:
                    # A retryable failure already came out of this pull:
                    # a generator-based iterator is CLOSED by it, so this
                    # StopIteration is bogus — re-raise the real error
                    # rather than truncate the run silently.
                    raise first_error[0]
                raise
            except Exception as e:
                if not first_error:
                    first_error.append(e)
                raise

        if retry is None:
            return _next()
        return retry.call(
            _next, counter=_T_DATA_RETRIES, site=f"data.next[{step}]"
        )

    tracker = _guard.SkipTracker(max_consecutive_nonfinite)
    pending_flags: deque = deque()  # (step, nonfinite flag)
    completed = start  # last step whose state we hold
    saved_at = start  # last step with a dispatched checkpoint
    preempted = False
    pull_error: Optional[BaseException] = None
    t_prev = None
    step_no = 0  # last data-stream position consumed (1-based steps)

    try:
        # Fast-forward the data stream to the resume point: every process
        # resumed from the same checkpoint, so no per-batch collective.
        while step_no < start and step_no < n_steps:
            try:
                _pull(step_no + 1)
            except StopIteration:
                raise ValueError(
                    f"data stream exhausted at batch {step_no + 1} while "
                    f"replaying to the resume point (checkpoint step "
                    f"{start}): the stream is shorter than the run it is "
                    "supposed to realign with"
                ) from None
            step_no += 1

        while step_no < n_steps:
            pulling = step_no + 1
            batch = None
            exhausted = False
            pull_error = None
            try:
                batch = _pull(pulling)
            except StopIteration:
                exhausted = True
            except Exception as e:
                # Held, not raised: the error must travel through the exit
                # collective first, or this process would abandon it while
                # its peers wait.  It re-raises below, after the tail save.
                pull_error = e
            # Step boundary: ONE small collective agrees on every exit
            # cause across processes, so every process stops at (and
            # checkpoints) the SAME step.
            must_sync = exhausted or pull_error is not None
            if must_sync or pulling % max(1, exit_sync_every) == 0:
                preempted_any, exhausted_any, failed_any = any_flags(
                    (
                        handle_preemption and _preemption.requested(),
                        exhausted,
                        pull_error is not None,
                    )
                )
                if preempted_any:
                    preempted = True
                    break
                if failed_any or exhausted_any:
                    break
            step_no = pulling
            done = step_no
            kind = _faults.fire("step.exec", done)
            if kind == "nan" and isinstance(batch, dict):
                # Cooperative poison: make_train_step turns this reserved
                # key into a NaN loss, so the injected fault exercises the
                # REAL guard path.
                batch = {**batch, "_tdx_nan": True}
            with _telemetry.span("train.step", step=done):
                state, metrics = step_fn(state, batch)
            completed = done
            _T_STEPS.add()
            now = time.perf_counter()
            if t_prev is not None and now > t_prev:
                steps_per_s = 1.0 / (now - t_prev)
                _T_STEPS_S.set(steps_per_s)
                derived = {"steps_per_s": steps_per_s}
                n_tok = tokens_per_batch or _batch_tokens(batch)
                if n_tok:
                    tokens_per_s = n_tok * steps_per_s
                    _T_TOKENS_S.set(tokens_per_s)
                    derived["tokens_per_s"] = tokens_per_s
                if flops_per_step and peak_flops:
                    mfu = flops_per_step * steps_per_s / peak_flops
                    _T_MFU.set(mfu)
                    derived["mfu"] = mfu
                if isinstance(metrics, dict):
                    metrics = {**metrics, **derived}
            t_prev = now
            if isinstance(metrics, dict) and "nonfinite" in metrics:
                pending_flags.append((done, metrics["nonfinite"]))
                while (
                    pending_flags
                    and done - pending_flags[0][0] >= _NONFINITE_LAG
                ):
                    s, flag = pending_flags.popleft()
                    tracker.observe(bool(flag), s)
            if on_metrics is not None:
                on_metrics(done, metrics)
            if ckptr is not None and (
                done % checkpoint_every == 0 or done == n_steps
            ):
                # The finally below finalizes a save still in flight —
                # including when a later step raises.
                ckptr.save(done, state, wait=checkpoint_sync)
                saved_at = done

        # Drain the lagged guard flags so a poisoned tail still counts
        # (and can still escalate) before the loop returns.
        while pending_flags:
            s, flag = pending_flags.popleft()
            tracker.observe(bool(flag), s)

        # Always persist the final completed step: the loop may exit with
        # work done since the last periodic save (batches exhausted, or a
        # preemption), and losing it would rewind the resume point.
        if ckptr is not None and completed > saved_at:
            ckptr.save(completed, state, wait=False)
            saved_at = completed
        if preempted:
            _T_PREEMPTIONS.add()
            with _telemetry.span("train.preempt", step=completed):
                pass  # event span: the preemption is visible in traces
            # Acted on (state saved): clear it so a later fit() in the same
            # process can resume instead of instantly re-preempting.
            _preemption.clear()
    finally:
        if ckptr is not None:
            ckptr.wait_until_finished()
        if handle_preemption and not handlers_preexisting:
            # fit() must not permanently swallow the caller's Ctrl-C.
            _preemption.uninstall()
    if pull_error is not None:
        # The failure that stopped the loop, raised only now: progress up
        # to the agreed stop step is already checkpointed.
        raise pull_error
    if preempted:
        # Flush counters (retries, skips, the preemption itself) to the
        # JSONL trace before the process is torn down.
        _telemetry.emit_counters()
    return state, metrics
