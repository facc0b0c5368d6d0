"""Zero-downtime weight hot swap: deferred-init standby, drain, retire.

Counterpart of ``torchdistx_tpu/fleet/hot_swap.py``.  The paper's feature
applied to a fleet: version v keeps serving while version v+1 is
*recorded* with zero allocation (:func:`~torchdistx_tpu_torch.
deferred_init.deferred_init`) and then *materialized* onto the device
(:func:`~torchdistx_tpu_torch.materialize.materialize_module_torch`, seeded)
for a standby engine.  The swap:

1. **Build** the standby: :func:`materialize_standby` (or any factory)
   gives the v+1 module, and an Engine over it.
2. **Admit** the standby into the router under the new version tag.
3. **Shift admission**: the router's gate closes on every v replica
   (:meth:`~.router.FleetRouter.close_admission`); new work routes to v+1.
4. **Migrate** what can move: in-flight v streams warm-migrate to any
   remaining same-version peer (:meth:`~.router.FleetRouter.
   migrate_out_streams`).  Migration is version-pinned, so when the swap
   retires the last v replica every stream is left in place for step 5.
5. **Drain** v (:meth:`~torchdistx_tpu_torch.serving.engine.Engine.
   begin_drain`): queued work flushes with retryable typed errors (the
   router re-routes it to v+1; it has yielded nothing), while in-flight
   streams finish on their own engine under the drain deadline.  Tokens
   from two versions never interleave within one stream.
6. **Retire**: each drained v engine is removed and ``close()``-d, its
   pages and decode graph released.

A v stream that outlives the drain deadline fails with a retryable
``RequestPreempted``; having yielded tokens it is version-pinned, and with
every v replica gone the router fails it typed
(:class:`~.router.NoReplicaAvailable`).

Telemetry: the ``fleet.swap`` span and the ``fleet.swaps`` counter.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from .. import telemetry as _telemetry
from ..serving.lifecycle import Health
from .router import FleetRouter

__all__ = ["hot_swap", "materialize_standby"]

_T_SWAPS = _telemetry.counter("fleet.swaps")


def materialize_standby(
    module_fn: Callable,
    *args,
    device: Optional[Any] = None,
    seed: int = 0,
    convert: Optional[Callable] = None,
    materialize_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Build the next version's module while the current one serves.

    ``module_fn(*args, **kwargs)`` is constructed under
    :func:`~torchdistx_tpu_torch.deferred_init.deferred_init` claiming CUDA
    (every parameter fake, every initializer recorded, zero bytes
    allocated), then replayed onto the resolved ``device`` by
    :func:`~torchdistx_tpu_torch.materialize.materialize_module_torch` under
    ``seed`` (``materialize_kwargs`` passes ``dtype`` or a mesh and plan
    through).  Returns the module with its values loaded, ready for
    ``prep_decode()`` (an ``Engine`` over it calls that).

    ``convert``, when given, receives the flat ``{qualified_name: tensor}``
    dict instead and its result is returned: for an HF module, for example
    ``lambda v: convert.llama_from_jax_params(convert.llama_params_from_hf(
    v), cfg)`` through :mod:`torchdistx_tpu_torch.models.convert`.

    ``device=None`` is CUDA (raises without it); pass ``"cpu"`` for the
    host."""
    import torch

    from .._device import resolve_device
    from ..deferred_init import deferred_init
    from ..materialize import materialize_module_torch

    dev = resolve_device(device)
    # The recording claims the serving device (CUDA, also on a host
    # without it), so a replay onto the CPU replays the card's recording.
    claim = dev if dev.type == "cuda" else torch.device("cuda")
    module = deferred_init(module_fn, *args, device_=claim, **kwargs)
    values = materialize_module_torch(module, device=dev, seed=seed,
                                      **(materialize_kwargs or {}))
    if convert is not None:
        return convert(values)
    module.load_state_dict(values, assign=True)
    return module


def hot_swap(
    router: FleetRouter,
    make_standby: Callable[[], object],
    *,
    version: str,
    retire: Optional[Iterable[int]] = None,
    max_steps: int = 200_000,
) -> int:
    """Upgrade the fleet to ``version`` with zero dropped requests.

    ``make_standby`` builds the v+1 engine (typically over parameters
    from :func:`materialize_standby`); ``retire`` names the replica ids
    to drain out (default: every replica whose version differs from
    ``version``).  Blocks (stepping the retiring engines) until they
    drain; ``max_steps`` bounds the wait — a stuck drain raises rather
    than spinning forever.  Returns the new replica's id.
    """
    sp = _telemetry.start_span("fleet.swap", version=version)
    try:
        standby = make_standby()
        if retire is None:
            old = [r for r in router.replicas() if r.version != version]
        else:
            retire = set(retire)
            old = [r for r in router.replicas() if r.rid in retire]
        new_rid = router.add_replica(standby, version=version)
        # Admission shifts to v+1 BEFORE the drain starts: from here no
        # new work lands on v, and the drain's queue flush re-routes
        # v's waiting requests (which have yielded nothing) to v+1.
        for rep in old:
            router.close_admission(rep.rid)
        # Warm-migrate in-flight v streams to surviving same-version
        # peers (a partial retire) before draining.  Version-pinned: a
        # full upgrade has no v peer left, migrate_out_streams skips
        # every stream, and the drain below finishes them in place.
        n_migrated = 0
        for rep in old:
            n_migrated += router.migrate_out_streams(rep.rid)["migrated"]
        for rep in old:
            rep.engine.begin_drain()
        steps = 0
        while any(
            rep.engine.health() is not Health.STOPPED for rep in old
        ):
            for rep in old:
                if rep.engine.health() is not Health.STOPPED:
                    rep.engine.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"hot swap to {version!r}: retiring engines did not "
                    f"drain within {max_steps} steps"
                )
        for rep in old:
            router.remove_replica(rep.rid)  # close() idempotent on STOPPED
        _T_SWAPS.add()
        sp.end(
            n_retired=len(old), new_replica=new_rid, steps=steps,
            n_migrated=n_migrated,
        )
        return new_rid
    except BaseException:
        sp.cancel()
        raise
