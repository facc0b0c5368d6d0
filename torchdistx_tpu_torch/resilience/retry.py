"""Retry transient failures: exponential backoff + jitter, capped.

Counterpart of ``torchdistx_tpu/resilience/retry.py``, the same policy and
classification.  Checkpoint IO (shared file systems) and data loading fail
transiently all
the time on long runs; one hiccup must not kill hours of training.  A
:class:`RetryPolicy` classifies exceptions into retryable/fatal, sleeps
an exponentially growing, jittered delay between attempts, and gives up
after ``max_attempts`` tries or a wall-clock ``deadline_s`` — raising
:class:`RetriesExhausted` chained to the last underlying error so the
root cause stays in the traceback.

Classification is three-layered, most-specific first: an explicit
boolean ``retryable`` attribute on the exception is authoritative (the
serving ``RequestError`` contract of the JAX package — the
raiser knows better than any heuristic, so the serving fleet router,
checkpoint IO, and data IO all share this one classification path);
then an ``isinstance`` check against ``retryable`` (default ``OSError``,
which covers ``ConnectionError`` and ``TimeoutError``); then a *name*
match against ``retryable_names`` for backend exception types this
package must not import (grpc/GCS/orbax transport errors surface with
names like ``Unavailable`` or ``DeadlineExceeded`` but live in optional
dependencies).  The attribute layer is what keeps a serving
``DeadlineExceeded`` (``retryable=False``) from colliding with grpc's
transient status of the same name.

Every granted retry can bump a telemetry counter supplied by the call
site (``ckpt.retries``, ``data.retries``), so recovery is visible in
traces instead of silently absorbed.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, FrozenSet, Optional, Tuple, Type

__all__ = ["RetriesExhausted", "RetryPolicy", "DEFAULT_RETRYABLE_NAMES"]

# Transport-layer exception *names* treated as transient (grpc status
# classes, GCS/orbax wrappers) — matched when the type isn't importable
# here.  Deliberately conservative: nothing that can mean corrupt data.
DEFAULT_RETRYABLE_NAMES: FrozenSet[str] = frozenset(
    {
        "Aborted",
        "DeadlineExceeded",
        "InternalServerError",
        "ResourceExhausted",
        "RetryError",
        "ServiceUnavailable",
        "TooManyRequests",
        "Unavailable",
    }
)


class RetriesExhausted(RuntimeError):
    """All attempts failed; ``__cause__`` is the last underlying error."""


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter with attempt and deadline caps.

    ``delay(k)`` for the k-th granted retry (0-based) is
    ``min(max_delay_s, base_delay_s * 2**k)`` scaled by a uniform random
    factor in ``[1 - jitter, 1]`` (decorrelates clients hammering the
    same recovering endpoint).  ``deadline_s`` bounds the *total* wall
    clock across attempts: a retry whose sleep would cross the deadline
    is not granted.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 30.0
    deadline_s: Optional[float] = None
    jitter: float = 0.5
    retryable: Tuple[Type[BaseException], ...] = (OSError,)
    retryable_names: FrozenSet[str] = field(
        default=DEFAULT_RETRYABLE_NAMES
    )

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def is_retryable(self, exc: BaseException) -> bool:
        # An explicit boolean `retryable` attribute wins outright: the
        # raiser's own classification (the RequestError contract) must
        # not be overridden by an isinstance or name coincidence.
        flag = getattr(exc, "retryable", None)
        if isinstance(flag, bool):
            return flag
        if isinstance(exc, self.retryable):
            return True
        return type(exc).__name__ in self.retryable_names

    def delay(self, attempt: int) -> float:
        """Sleep before the ``attempt``-th retry (0-based), jittered."""
        base = min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        return base * (1.0 - self.jitter * random.random())

    def call(
        self,
        fn: Callable,
        *args,
        counter=None,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        site: str = "",
        **kwargs,
    ):
        """Run ``fn(*args, **kwargs)``, retrying retryable failures.

        ``counter`` (a ``telemetry.Counter``) is bumped once per granted
        retry; ``on_retry(attempt, exc)`` is called just before the
        sleep.  Non-retryable exceptions propagate unchanged on the
        first failure.
        """
        deadline = (
            time.monotonic() + self.deadline_s
            if self.deadline_s is not None
            else None
        )
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                if not self.is_retryable(exc):
                    raise
                attempt += 1
                if attempt >= self.max_attempts:
                    raise RetriesExhausted(
                        f"{site or getattr(fn, '__name__', 'call')}: "
                        f"{attempt} attempt(s) failed; last: {exc!r}"
                    ) from exc
                pause = self.delay(attempt - 1)
                if deadline is not None and (
                    time.monotonic() + pause > deadline
                ):
                    raise RetriesExhausted(
                        f"{site or getattr(fn, '__name__', 'call')}: "
                        f"deadline {self.deadline_s}s exceeded after "
                        f"{attempt} attempt(s); last: {exc!r}"
                    ) from exc
                if counter is not None:
                    counter.add()
                if on_retry is not None:
                    on_retry(attempt, exc)
                time.sleep(pause)
