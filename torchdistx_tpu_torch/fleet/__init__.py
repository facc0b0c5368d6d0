"""Fleet layer: health-aware routing, typed-error failover, hot swap,
autoscaling.

Counterpart of ``torchdistx_tpu.fleet``.  A :class:`~.router.FleetRouter`
fronts N :class:`~torchdistx_tpu_torch.serving.engine.Engine` replicas
behind the engine's own ``submit()/tokens()`` streaming API:

* :mod:`.router` — least-estimated-TTFT routing (OVERLOADED avoided,
  DRAINING/STOPPED excluded), failover of retryable typed errors to peers
  under a per-request hop budget with
  :class:`~torchdistx_tpu_torch.resilience.retry.RetryPolicy` backoff,
  digest-verified mid-stream replays pinned to the weights version, stream
  migration, journal recovery, and typed failure when no replica can take
  a request;
* :mod:`.hot_swap` — zero-downtime weight upgrade over a deferred-init
  standby (:func:`~.hot_swap.materialize_standby`);
* :mod:`.autoscale` — the observe-act loop: SLO burn, occupancy and a
  queue-slope predictor drive scale-out (an engine factory into
  ``add_replica``) and scale-in (``begin_drain`` then a reap).

Quick start::

    from torchdistx_tpu_torch.fleet import FleetRouter, hot_swap

    router = FleetRouter([make_engine(), make_engine()], version="v1")
    # make_engine = engine_factory(model): replicas over one shared module
    h = router.submit(prompt_ids, max_new_tokens=128, key=0)
    for tok in h.tokens():      # streams; fails over transparently
        print(tok)

    hot_swap(router, make_v2_engine, version="v2")  # zero requests dropped

Telemetry: ``fleet.*`` counters and gauges and the ``fleet.swap`` span.
"""

from .autoscale import Autoscaler, AutoscaleConfig, engine_factory  # noqa: F401
from .hot_swap import hot_swap, materialize_standby  # noqa: F401
from .router import (  # noqa: F401
    FailoverDiverged,
    FailoverExhausted,
    FleetHandle,
    FleetRouter,
    NoReplicaAvailable,
    Replica,
)

__all__ = [
    "AutoscaleConfig",
    "Autoscaler",
    "FailoverDiverged",
    "FailoverExhausted",
    "FleetHandle",
    "FleetRouter",
    "NoReplicaAvailable",
    "Replica",
    "engine_factory",
    "hot_swap",
    "materialize_standby",
]
