"""Seeded, optionally sharded materialization of a recorded module.

Counterpart of ``torchdistx_tpu/materialize.py`` (``materialize_tensor_jax``,
``materialize_module_jax``): take a module whose parameters and buffers are
fake and recorded by :func:`~torchdistx_tpu_torch.deferred_init.deferred_init`
and return its values, ``{qualified_name: tensor}``, on the device (CUDA by
default) or as ``DTensor`` shards over a ``DeviceMesh``.  The module is not
touched; :func:`~torchdistx_tpu_torch.deferred_init.materialize_module`
(replay in place, drawing from the device's global generator) stays as it
is.

Replay is eager and functional: each call keeps its own ``op_nr -> outputs``
environment and neither reads nor fills the tape's replay cache, so calls
with other seeds or dtypes cannot see each other.  Targets whose call stacks
share no node replay one at a time (a parameter's stack, its dtype cast or
its shard, then its environment is dropped), so the peak stays near the
results plus one parameter in its recorded dtype.  Targets whose stacks
share nodes (aliases, in-place writes through views) replay their union
once, in chronological order, so write-after-write and reads through
aliases resolve as recorded; a node's outputs are dropped once no remaining
target of the group needs them.

RNG: every op tagged ``nondeterministic_seeded`` draws from a generator of
its own on the replay device, seeded with a splitmix64 mix of ``(seed, tape
ordinal, op_nr - base_nr)``.  The tape ordinal numbers the tapes reachable
from the targets in first-appearance order; ``op_nr - base_nr`` is the op's
number within its tape.  So values do not depend on materialization order
or on the process (absolute op numbers never enter a seed), two recordings
of one architecture give the same values, and same-shaped parameters draw
distinct streams.  A random op with no overload that takes a generator
raises rather than draw from the global stream.  A generator given at
record time is replaced by the node's own.  The values differ from the JAX
package's (threefry there, Philox or mt19937 here) by design.

Each node replays with its own recorded arguments, so two same-shaped fills
with different scalars keep them (the JAX package's per-member fill
scalars).  ``dtype`` casts each target as soon as it is complete; replay
itself runs in the recorded dtypes.

The JAX function's ``strategy``, ``rng_impl``, executable cache and fill
fast path are XLA compile-time machinery; eager replay compiles nothing,
so they have no counterpart here.  With a mesh, every rank replays each
full tensor from the same rank-independent generators and keeps its own
shard, so a shard is bit-equal to the same slice of the unsharded result.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.utils._pytree as pytree

from . import _tape
from . import telemetry as _telemetry
from .telemetry import perf as _perf
from ._device import resolve_device
from ._tape import OpNode, OutputRef
from .deferred_init import _get_record, is_deferred
from .fake import FakeTensor
from .parallel.sharding import (
    PartitionSpec,
    StageSpec,
    fit_spec_to_mesh,
    replicate_indivisible,
    spec_placements,
    stage_mesh,
    stage_of,
)

__all__ = ["materialize_tensor_torch", "materialize_module_torch"]

_T_CALLS = _telemetry.counter("materialize.calls")

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, ordinal: int, rel_nr: int) -> int:
    """The 64-bit seed of the random stream of op ``rel_nr`` (its number
    within its tape) of the tape with ``ordinal``, under ``seed``."""
    return _splitmix64(_splitmix64(_splitmix64(seed & _MASK64) ^ ordinal) ^ rel_nr)


# func -> its overload that takes a generator
_SEEDED: Dict[Any, Any] = {}


def _seeded_overload(func):
    """``func`` itself if it takes a generator, else its overload with the
    same arguments plus a generator (``randn.default`` -> ``randn.generator``,
    ``randint.low`` -> ``randint.low_generator``); raises if there is none."""
    found = _SEEDED.get(func)
    if found is not None:
        return found
    want = {a.name for a in func._schema.arguments} | {"generator"}
    candidates = [func] + [
        getattr(func.overloadpacket, name)
        for name in func.overloadpacket.overloads()
    ]
    for cand in candidates:
        if {a.name for a in cand._schema.arguments} == want:
            _SEEDED[func] = cand
            return cand
    raise NotImplementedError(
        f"Cannot materialize with a seed: the random op {func} has no overload "
        "that takes a generator, and it must not draw from the global stream."
    )


def _put(func, args: list, kwargs: dict, name: str, value) -> None:
    """Bind schema argument ``name`` of ``func`` to ``value`` in place."""
    names = [a.name for a in func._schema.arguments]
    i = names.index(name)
    if i < len(args):
        args[i] = value
    else:
        kwargs[name] = value


class _Replay:
    """One call's functional replay environment: ``op_nr -> outputs``."""

    def __init__(self, seed: int, device: torch.device, ordinals: Dict[int, int]):
        self.seed = seed
        self.device = device
        self.ordinals = ordinals
        self.env: Dict[int, List[Any]] = {}

    def _resolve(self, a):
        if isinstance(a, OutputRef):
            return self.env[a.node.op_nr][a.index]
        if isinstance(a, torch.Tensor) and a.device != self.device:
            return a.to(self.device)  # an external tensor the tape captured
        return a

    def run(self, node: OpNode) -> None:
        op = node.op
        args, kwargs = pytree.tree_map(self._resolve, (op.args, op.kwargs))
        args, func = list(args), op.func
        schema_names = [a.name for a in func._schema.arguments]
        if "device" in schema_names:
            _put(func, args, kwargs, "device", self.device)
        if torch.Tag.nondeterministic_seeded in func.tags:
            func = _seeded_overload(func)
            gen = torch.Generator(device=self.device)
            ordinal = self.ordinals[node.base_nr]
            gen.manual_seed(stream_seed(self.seed, ordinal, node.op_nr - node.base_nr))
            _put(func, args, kwargs, "generator", gen)
        out = func(*args, **kwargs)
        self.env[node.op_nr] = list(out) if isinstance(out, (tuple, list)) else [out]


def _ordinals(stacks) -> Dict[int, int]:
    """Tape ordinals: the tapes of ``stacks`` numbered in first-appearance
    order (stacks in target order, each chronological)."""
    ordinals: Dict[int, int] = {}
    for stack in stacks:
        for n in stack:
            ordinals.setdefault(n.base_nr, len(ordinals))
    return ordinals


def _groups(stacks: List[List[OpNode]]) -> List[List[int]]:
    """Target indices grouped so that no two groups' stacks share a node,
    in first-appearance order."""
    parent = list(range(len(stacks)))

    def root(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    owner: Dict[int, int] = {}
    for i, stack in enumerate(stacks):
        for n in stack:
            j = owner.setdefault(n.op_nr, i)
            if j != i:
                parent[root(i)] = root(j)
    groups: Dict[int, List[int]] = {}
    for i in range(len(stacks)):
        groups.setdefault(root(i), []).append(i)
    return list(groups.values())


def _check_guards(stacks) -> None:
    for stack in stacks:
        for node in stack:
            for guard in node.op.guards:
                guard.check()


def _replay_targets(targets, stacks, seed, device, finish, ordinals=None) -> None:
    """Replay every target ``(node, index)`` and hand each value, as soon
    as its stack has run, to ``finish(i, value)``; ``ordinals`` (default:
    those of ``stacks``) number the tapes."""
    ordinals = _ordinals(stacks) if ordinals is None else ordinals
    with torch.utils._python_dispatch._disable_current_modes(), torch.no_grad():
        for group in _groups(stacks):
            nodes = {n.op_nr: n for i in group for n in stacks[i]}
            # The op_nr after which each target is complete, and after which
            # each node's outputs are needed no more.
            done_at = {i: stacks[i][-1].op_nr for i in group}
            last_use = {nr: nr for nr in nodes}
            for nr, node in nodes.items():
                for ref in pytree.tree_iter((node.op.args, node.op.kwargs)):
                    if isinstance(ref, OutputRef):
                        last_use[ref.node.op_nr] = max(last_use[ref.node.op_nr], nr)
            for i in group:
                tnr = targets[i][0].op_nr
                last_use[tnr] = max(last_use[tnr], done_at[i])
            complete: Dict[int, List[int]] = {}
            for i in group:
                complete.setdefault(done_at[i], []).append(i)
            drop: Dict[int, List[int]] = {}
            for nr, last in last_use.items():
                drop.setdefault(last, []).append(nr)
            replay = _Replay(seed, device, ordinals)
            for nr in sorted(nodes):
                replay.run(nodes[nr])
                for i in complete.get(nr, ()):
                    node, index = targets[i]
                    finish(i, replay.env[node.op_nr][index])
                for dead in drop.get(nr, ()):
                    del replay.env[dead]


def _own(value: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``value`` cast to ``dtype``, holding no storage beyond its own."""
    if dtype is not None and value.dtype != dtype:
        return value.to(dtype)
    if value.untyped_storage().nbytes() > value.numel() * value.element_size():
        return value.clone()
    return value


def _local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full``: tensor dim ``d`` split over the mesh
    dims that shard it, the earlier mesh dim the major one."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    sizes = list(mesh.shape)
    local = full
    for d in range(full.dim()):
        dims = [i for i, p in enumerate(placements) if isinstance(p, Shard) and p.dim == d]
        if not dims:
            continue
        parts, index = 1, 0
        for i in dims:
            parts *= sizes[i]
            index = index * sizes[i] + coord[i]
        if full.shape[d] % parts:
            raise ValueError(
                f"dim {d} of size {full.shape[d]} does not split into {parts} shards"
            )
        chunk = full.shape[d] // parts
        local = local.narrow(d, index * chunk, chunk)
    return _own(local.contiguous(), None)


def _finish(value, dtype, mesh, spec):
    """A target's result: cast, then (with a mesh) this rank's DTensor."""
    value = _own(value, dtype)
    if mesh is None:
        return value
    from torch.distributed.tensor import DTensor

    placements = spec_placements(spec, mesh, value.dim())
    local = _local_shard(value, mesh, placements)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=value.shape, stride=value.stride())


def _replay_device(device, mesh) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's {mesh.device_type}")
    return dev


def _named_fakes(module: nn.Module) -> List[Tuple[str, FakeTensor]]:
    out = []
    for name, p in module.named_parameters(remove_duplicate=True):
        if is_deferred(p):
            out.append((name, p))
    for name, b in module.named_buffers(remove_duplicate=True):
        if is_deferred(b):
            out.append((name, b))
    return out


def _plan_spec(plan, name: str, fake: FakeTensor) -> PartitionSpec:
    if plan is None:
        return PartitionSpec()
    spec = plan(name, tuple(fake.shape)) if callable(plan) else plan.get(name)
    return PartitionSpec() if spec is None else spec


def _fit_spec(spec, fake: FakeTensor, mesh) -> PartitionSpec:
    if mesh is None:
        return spec
    return replicate_indivisible(fit_spec_to_mesh(spec, mesh), tuple(fake.shape), mesh)


def _stage_filter(specs, mesh):
    """``(placement mesh, kept indices)`` of a plan's ``specs`` on ``mesh``:
    when a :class:`~torchdistx_tpu_torch.parallel.sharding.StageSpec` names
    a ``pp`` axis of ``mesh``, this rank keeps the layers of its own stage
    and every parameter that is not a layer's (held whole over ``pp``),
    placed on the mesh of its stage (``stage_mesh``; None: plain tensors);
    otherwise every parameter, on ``mesh``."""
    staged = [s for s in specs if isinstance(s, StageSpec)]
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    axes = {s.pp for s in staged if s.pp in names}
    if not axes:
        return mesh, list(range(len(specs)))
    if len(axes) > 1:
        raise ValueError(f"a plan's stages name two pipeline axes: {sorted(axes)}")
    (axis,) = axes
    n_stages = mesh.size(names.index(axis))
    mine = mesh.get_local_rank(axis)
    keep = [i for i, s in enumerate(specs)
            if not isinstance(s, StageSpec) or s.pp != axis
            or stage_of(s.layer, s.n_layers, n_stages) == mine]
    return stage_mesh(mesh, axis), keep


def materialize_tensor_torch(
    tensor: torch.Tensor,
    *,
    mesh=None,
    spec=None,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    device: Optional[Any] = None,
):
    """One fake tensor's value, replayed with per-node seeded generators
    (see the module docstring): a tensor on ``device`` (``None``: CUDA), or
    with ``mesh`` this rank's ``DTensor`` placed by ``spec`` (default
    replicated).  ``dtype`` casts the result."""
    record = _get_record(tensor) if isinstance(tensor, FakeTensor) else None
    if record is None:
        raise ValueError("`tensor` is not a deferred fake tensor.")
    replay_device = _replay_device(device, mesh)
    stack = _tape.build_call_stack(record.node)
    _check_guards([stack])
    out = {}

    def finish(_, value):
        out["value"] = _finish(value, dtype, mesh, spec or PartitionSpec())

    with _telemetry.span("materialize.tensor"), _perf.program("materialize"):
        _replay_targets([(record.node, record.index)], [stack], seed, replay_device, finish)
    return out["value"]


def materialize_module_torch(
    module: nn.Module,
    *,
    mesh=None,
    plan: Optional[Any] = None,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    device: Optional[Any] = None,
) -> Dict[str, Any]:
    """Every fake parameter and buffer of ``module`` (parameters, then
    buffers, duplicates removed), as ``{qualified_name: tensor}``.

    ``device``: where replay runs (``None``: CUDA; raises without it; pass
    ``"cpu"`` for the host).  With ``mesh`` (a ``DeviceMesh`` from
    :func:`~torchdistx_tpu_torch.parallel.mesh.make_mesh`) the values are
    ``DTensor``s on the mesh's device type, placed by ``plan``: ``None``
    (replicated), a dict ``{name: PartitionSpec}``, or a callable ``(name,
    shape) -> PartitionSpec | None`` (see
    :mod:`~torchdistx_tpu_torch.parallel.sharding`), fitted to the mesh and
    replicated on dims its axes do not divide.  A plan whose layers carry
    :class:`~torchdistx_tpu_torch.parallel.sharding.StageSpec` specs over a
    ``pp`` axis of the mesh (a family's ``param_specs(cfg, pp=)``) gives
    each rank its own pipeline stage only: the layers of the other stages
    are not replayed and not in the result, and every value is placed on
    the stage's mesh (the mesh without ``pp``; plain tensors when ``pp`` is
    its only axis).  Per-node streams make a stage's values equal to the
    same parameters of a full materialize.  ``dtype`` casts every value
    (for example ``torch.bfloat16`` for a model recorded in float32).
    ``seed`` keys the random streams.  The module is not changed; load the
    result with ``module.load_state_dict(result, assign=True)``.
    """
    _T_CALLS.add()
    span = _telemetry.start_span("materialize.module")
    try:
        replay_device = _replay_device(device, mesh)
        named = _named_fakes(module)
        targets = [(_get_record(f).node, _get_record(f).index) for _, f in named]
        stacks = [_tape.build_call_stack(node) for node, _ in targets]
        ordinals = _ordinals(stacks)  # of every target: a stage's values are the full run's
        specs = [_plan_spec(plan, name, fake) for name, fake in named]
        place, keep = _stage_filter(specs, mesh)
        named, targets, stacks = ([xs[i] for i in keep] for xs in (named, targets, stacks))
        specs = [_fit_spec(specs[i], fake, place) for i, (_, fake) in zip(keep, named)]
        _check_guards(stacks)
        results: Dict[str, Any] = {}

        def finish(i, value):
            results[named[i][0]] = _finish(value, dtype, place, specs[i])

        with _perf.program("materialize"):
            _replay_targets(targets, stacks, seed, replay_device, finish, ordinals)
        results = {name: results[name] for name, _ in named}
    except BaseException as e:
        span.end(error=type(e).__name__)
        raise
    span.end(n_params=len(results))
    return results
