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
with other seeds or dtypes cannot see each other.

RNG: every seeded ``normal_``, ``uniform_``, ``randn`` and ``rand`` of a
float32, bfloat16, float16 or float64 tensor draws from the counter-based
Philox generator of :mod:`~torchdistx_tpu_torch.ops.cuda.philox` (the
kernel on CUDA tensors, its plain version on CPU ones), keyed by a
splitmix64 mix of ``(seed, tape ordinal, op_nr - base_nr)``
(:func:`stream_seed`): element ``g`` of the op's output (its row-major
index in the whole tensor) is a function of that key and ``g`` alone.
Every other op tagged ``nondeterministic_seeded`` (``randint``,
``randperm``, ``bernoulli_``, ``exponential_``, ``random_``, ...) draws
from a ``torch.Generator`` of its own on the replay device, seeded with the
same key, through its overload that takes a generator; a random op with no
such overload raises rather than draw from the global stream, and a
generator given at record time is replaced.  The tape ordinal numbers the
tapes reachable from the targets in first-appearance order; ``op_nr -
base_nr`` is the op's number within its tape.  So values do not depend on
materialization order or on the process (absolute op numbers never enter a
key), two recordings of one architecture give the same values, same-shaped
parameters draw distinct streams, and a CPU and a CUDA replay give the same
values up to the last bits of ``log`` / ``sin`` / ``cos``.  The values
differ from the JAX package's (threefry there) by design.

Shard-local replay: a target whose call stack is a chain replays on its box
alone (this rank's shard with a mesh, else the whole tensor), and the full
tensor never exists.  A chain's first node creates the whole target
(``empty``, ``zeros``, ``ones``, ``full``, ``empty_strided``, ``randn``,
``rand``); each later node takes the one before it as its only tensor and
otherwise scalars, and is elementwise (``normal_``, ``uniform_``,
``fill_``, ``zero_``, ``mul_`` / ``add_`` / ``clamp_`` / ``erfinv_`` by
scalars, in place or not), a cast or an alias; and the target shares its
stack with no other target.  That is what ``nn.Linear``, ``nn.Embedding``
without ``padding_idx``, the ``nn.init`` fills and every parameter of the
port's Llama, GPT-2 and MoE record.  Each element of such a value depends
on that element alone, so a box is bit-equal to the same slice of the
whole value.  A fill that a later fill overwrites unread (``nn.Linear``'s
kaiming ``uniform_`` under the model's ``normal_``) is skipped.  Counted
in ``materialize.shard_local``.

Every other target replays whole, counted in
``materialize.full_replays{reason=...}``: ``shared_nodes`` (targets whose
stacks share nodes: aliases, in-place writes through views; their union
replays once, in chronological order, so write-after-write and reads
through aliases resolve as recorded, and a node's outputs are dropped once
no remaining target of the group needs them), ``view`` (a write through a
view of part of it, such as an embedding's ``padding_idx`` row),
``reads_tensor`` (an op that reads another tensor), ``random_op`` (another
random op), ``source`` (a first op that is not a whole-tensor create, such
as ``arange``), ``layout`` (a create that is not contiguous) or ``op``
(anything else).  With a mesh it is then cut to this rank's shard.  Either
way, targets replay one group at a time, so the peak stays near the
results plus one target (its shard, where it replays shard-local).

Each node replays with its own recorded arguments, so two same-shaped fills
with different scalars keep them (the JAX package's per-member fill
scalars).  ``dtype`` casts each target as soon as it is complete; replay
itself runs in the recorded dtypes.

The JAX function's ``strategy``, ``rng_impl``, executable cache and fill
fast path are XLA compile-time machinery; eager replay compiles nothing,
so they have no counterpart here.
"""

from __future__ import annotations

import math
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
_T_SHARD_LOCAL = _telemetry.counter("materialize.shard_local")

aten = torch.ops.aten

# Random ops drawn from the counter-based generator (ops/cuda/philox.py),
# by the kind of their draw; a fill on another dtype keeps a generator.
_PHILOX_FILLS = {aten.normal_.default: "normal", aten.uniform_.default: "uniform"}
_PHILOX_FACTORIES = {aten.randn.default: "normal", aten.randn.generator: "normal",
                     aten.rand.default: "uniform", aten.rand.generator: "uniform"}
_PHILOX_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
# A shard-local chain's ops (see _chain): those that create the whole
# target, elementwise ones that take nothing but it and scalars (in place,
# or out of place: a new tensor), and casts and aliases of it.
_CREATES = {aten.empty.memory_format, aten.empty_strided.default, aten.zeros.default,
            aten.ones.default, aten.full.default, *_PHILOX_FACTORIES}
_ELEMENTWISE_IN_PLACE = {
    aten.fill_.Scalar, aten.zero_.default, aten.mul_.Scalar, aten.mul_.Tensor,
    aten.add_.Scalar, aten.add_.Tensor, aten.sub_.Scalar, aten.sub_.Tensor,
    aten.div_.Scalar, aten.div_.Tensor, aten.clamp_.default, aten.clamp_min_.default,
    aten.clamp_max_.default, aten.neg_.default, aten.erfinv_.default, *_PHILOX_FILLS}
_ELEMENTWISE = {
    aten.mul.Scalar, aten.mul.Tensor, aten.add.Scalar, aten.add.Tensor, aten.sub.Scalar,
    aten.sub.Tensor, aten.div.Scalar, aten.div.Tensor, aten.clamp.default,
    aten.clamp_min.default, aten.clamp_max.default, aten.neg.default, aten.erfinv.default}
_ALIASES = {aten.detach.default, aten.alias.default}
# In-place ops that write every element without reading any.
_OVERWRITES = {aten.fill_.Scalar, aten.zero_.default, *_PHILOX_FILLS}
_CASTS = {aten._to_copy.default, aten.clone.default}
_CONTIGUOUS = (None, torch.contiguous_format, torch.preserve_format)

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


def _arg(func, args, kwargs, name: str):
    """Schema argument ``name`` of ``func`` as bound (or its default)."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            if i < len(args):
                return args[i]
            return kwargs.get(name, a.default_value if a.has_default_value() else None)
    raise KeyError(name)


def _draw(kind: str, out: torch.Tensor, func, args, kwargs, key: int, full_shape=None,
          offset=None) -> torch.Tensor:
    """``out`` filled by the counter-based generator as the random op
    ``func`` would fill it (its box at ``offset`` of ``full_shape``; default:
    ``out`` is the whole tensor)."""
    from .ops.cuda import philox

    if func in _PHILOX_FACTORIES:
        a, b = 0.0, 1.0
    elif kind == "normal":
        a, b = _arg(func, args, kwargs, "mean"), _arg(func, args, kwargs, "std")
    else:
        a, b = _arg(func, args, kwargs, "from"), _arg(func, args, kwargs, "to")
    fill = philox.normal_ if kind == "normal" else philox.uniform_
    if out.is_contiguous():
        return fill(out, key, a, b, full_shape=full_shape, offset=offset)
    # A view that is not contiguous: draw its logical order, then write it.
    out.copy_(fill(torch.empty(out.shape, dtype=out.dtype, device=out.device), key, a, b))
    return out


class _Replay:
    """One call's functional replay environment: ``op_nr -> outputs``."""

    def __init__(self, seed: int, device: torch.device, ordinals: Dict[int, int]):
        self.seed = seed
        self.device = device
        self.ordinals = ordinals
        self.env: Dict[int, List[Any]] = {}

    def key(self, node: OpNode) -> int:
        """The 64-bit key of ``node``'s random stream."""
        return stream_seed(self.seed, self.ordinals[node.base_nr], node.op_nr - node.base_nr)

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
        if func in _PHILOX_FACTORIES:
            dtype = kwargs.get("dtype") or torch.get_default_dtype()
            if dtype in _PHILOX_DTYPES:
                out = torch.empty(args[0], dtype=dtype, device=self.device)
                self.env[node.op_nr] = [_draw(_PHILOX_FACTORIES[func], out, func, args,
                                              kwargs, self.key(node))]
                return
        if func in _PHILOX_FILLS and args[0].dtype in _PHILOX_DTYPES:
            self.env[node.op_nr] = [_draw(_PHILOX_FILLS[func], args[0], func, args, kwargs,
                                          self.key(node))]
            return
        if torch.Tag.nondeterministic_seeded in func.tags:
            func = _seeded_overload(func)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.key(node))
            _put(func, args, kwargs, "generator", gen)
        out = func(*args, **kwargs)
        self.env[node.op_nr] = list(out) if isinstance(out, (tuple, list)) else [out]


class _Chain:
    """A target's stack that replays on any box of the target: its nodes in
    order, the target's full shape, and the nodes whose writes a later
    node overwrites before anything reads them (``dead``: skipped)."""

    __slots__ = ("nodes", "shape", "dead")

    def __init__(self, nodes: List[OpNode], shape: Tuple[int, ...]):
        self.nodes = nodes
        self.shape = shape
        # Llama's projections record nn.Linear's kaiming uniform_, then the
        # model's normal_: the uniform is never read.
        self.dead = set()
        for k in range(len(nodes) - 1, 0, -1):
            if nodes[k].op.func in _OVERWRITES and all(
                    n.op.func in _ELEMENTWISE_IN_PLACE or n.op.func in _ALIASES
                    for n in nodes[1:k]):
                self.dead = {n.op_nr for n in nodes[1:k] if n.op.func not in _ALIASES}
                break


def _scalars_only(leaves) -> bool:
    return not any(isinstance(a, (torch.Tensor, OutputRef)) for a in leaves)


def _chain(stack: List[OpNode], target) -> Tuple[Optional[_Chain], str]:
    """``(chain, "")`` when ``stack`` replays on a box of its target, else
    ``(None, reason)``.  It does when its first node creates the whole
    tensor (``empty``, ``zeros``, ``ones``, ``full``, ``empty_strided``,
    ``randn``, ``rand``; contiguous), every later node takes the value of
    the one before it as its only tensor and otherwise scalars, and is
    elementwise (in place or not: ``normal_``, ``uniform_``, ``fill_``,
    ``mul_`` / ``add_`` / ``clamp_`` / ``erfinv_`` by scalars, ...), a cast
    or an alias, and the target is the value of the last node (every node
    after it writes it in place or aliases it).  Each element of such a
    stack's value depends on that element alone (the random fills on its
    index in the full tensor), so any box of it replays by itself."""
    first, rest = stack[0], stack[1:]
    func = first.op.func
    if func not in _CREATES:
        seeded = torch.Tag.nondeterministic_seeded in func.tags
        return None, "random_op" if seeded else "source"
    if not _scalars_only(pytree.tree_iter((first.op.args, first.op.kwargs))):
        return None, "reads_tensor"
    shape = tuple(int(n) for n in first.op.args[0])
    fmt = first.op.kwargs.get("memory_format")
    if fmt not in _CONTIGUOUS or (
            func is aten.empty_strided.default
            and list(first.op.args[1]) != _contiguous_strides(shape)):
        return None, "layout"
    dtype = first.op.kwargs.get("dtype") or torch.get_default_dtype()
    if func in _PHILOX_FACTORIES and dtype not in _PHILOX_DTYPES:
        return None, "random_op"
    live = {first.op_nr}  # nodes whose output is the current value's storage
    for node in rest:
        func, args, kwargs = node.op.func, node.op.args, node.op.kwargs
        ref = args[0] if args else None
        if not (isinstance(ref, OutputRef) and ref.index == 0 and ref.node.op_nr in live
                and node.num_outputs == 1
                and _scalars_only(pytree.tree_iter((list(args[1:]), kwargs)))):
            return None, "reads_tensor"
        if func in _PHILOX_FILLS:
            if dtype not in _PHILOX_DTYPES:
                return None, "random_op"
        elif torch.Tag.nondeterministic_seeded in func.tags:
            return None, "random_op"
        if func in _ELEMENTWISE_IN_PLACE or func in _ALIASES:
            live.add(node.op_nr)
            continue
        if func in _ELEMENTWISE and dtype.is_floating_point:
            live = {node.op_nr}
            continue
        if func in _CASTS and kwargs.get("memory_format") in _CONTIGUOUS and (
                func is aten.clone.default or set(kwargs) <= {"dtype", "device"}):
            dtype = kwargs.get("dtype") or dtype
            live = {node.op_nr}
            continue
        if any(r.alias_info is not None for r in func._schema.returns):
            return None, "view"  # a view of part of it, or another in-place op
        return None, "op"
    if target[1] != 0 or target[0].op_nr not in live:
        return None, "op"
    return _Chain(stack, shape), ""


def _contiguous_strides(shape) -> List[int]:
    return [math.prod(shape[d + 1:]) for d in range(len(shape))]


def _run_chain(chain: _Chain, replay: _Replay, offset, size) -> torch.Tensor:
    """The value of ``chain``'s box at ``offset`` of size ``size``: each live
    node replayed on the box alone, the random fills drawn at the box's
    place in the full tensor."""
    value = None
    for node in chain.nodes:
        if node.op_nr in chain.dead:
            continue
        op = node.op
        args, kwargs = pytree.tree_map(
            lambda a: value if isinstance(a, OutputRef) else a, (op.args, op.kwargs))
        args, func = list(args), op.func
        if "device" in [a.name for a in func._schema.arguments]:
            _put(func, args, kwargs, "device", replay.device)
        if value is None:  # the first node: the box, created
            if func in _PHILOX_FACTORIES:
                dtype = kwargs.get("dtype") or torch.get_default_dtype()
                value = torch.empty(size, dtype=dtype, device=replay.device)
                value = _draw(_PHILOX_FACTORIES[func], value, func, args, kwargs,
                              replay.key(node), chain.shape, offset)
                continue
            args[0] = list(size)
            if func is aten.empty_strided.default:
                args[1] = _contiguous_strides(size)
            value = func(*args, **kwargs)
        elif func in _PHILOX_FILLS:
            value = _draw(_PHILOX_FILLS[func], value, func, args, kwargs, replay.key(node),
                          chain.shape, offset)
        else:
            value = func(*args, **kwargs)
    return value


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


def _replay_targets(targets, stacks, seed, device, finish, ordinals=None, box=None) -> None:
    """Replay every target ``(node, index)`` and hand each value, as soon
    as its stack has run, to ``finish(i, value, full_shape)``.  A target
    whose stack is a chain (:func:`_chain`) and shares no node with another
    target's replays on its box alone, ``box(i, full_shape) -> (offset,
    size)`` (default: the whole tensor), and ``full_shape`` says so; every
    other target replays whole (``full_shape`` None), counted under
    ``materialize.full_replays{reason=...}``.  ``ordinals`` (default: those
    of ``stacks``) number the tapes."""
    ordinals = _ordinals(stacks) if ordinals is None else ordinals
    with torch.utils._python_dispatch._disable_current_modes(), torch.no_grad():
        for group in _groups(stacks):
            replay = _Replay(seed, device, ordinals)
            reason = "shared_nodes"
            if len(group) == 1:
                (i,) = group
                chain, reason = _chain(stacks[i], targets[i])
                if chain is not None:
                    full = chain.shape
                    offset, size = box(i, full) if box else ([0] * len(full), list(full))
                    value = _run_chain(chain, replay, offset, size)
                    _T_SHARD_LOCAL.add()
                    finish(i, value, full)
                    continue
            for _ in group:
                _telemetry.counter("materialize.full_replays", reason=reason).add()
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
            for nr in sorted(nodes):
                replay.run(nodes[nr])
                for i in complete.get(nr, ()):
                    node, index = targets[i]
                    finish(i, replay.env[node.op_nr][index], None)
                for dead in drop.get(nr, ()):
                    del replay.env[dead]


def _own(value: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``value`` cast to ``dtype``, holding no storage beyond its own."""
    if dtype is not None and value.dtype != dtype:
        return value.to(dtype)
    if value.untyped_storage().nbytes() > value.numel() * value.element_size():
        return value.clone()
    return value


def _shard_box(shape, mesh, placements) -> Tuple[List[int], List[int]]:
    """``(offset, size)`` of this rank's shard of a tensor of ``shape``:
    tensor dim ``d`` split over the mesh dims that shard it, the earlier
    mesh dim the major one."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    sizes = list(mesh.shape)
    offset, size = [0] * len(shape), list(shape)
    for d in range(len(shape)):
        dims = [i for i, p in enumerate(placements) if isinstance(p, Shard) and p.dim == d]
        if not dims:
            continue
        parts, index = 1, 0
        for i in dims:
            parts *= sizes[i]
            index = index * sizes[i] + coord[i]
        if shape[d] % parts:
            raise ValueError(
                f"dim {d} of size {shape[d]} does not split into {parts} shards"
            )
        size[d] = shape[d] // parts
        offset[d] = index * size[d]
    return offset, size


def _local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` (see :func:`_shard_box`)."""
    offset, size = _shard_box(tuple(full.shape), mesh, placements)
    local = full
    for d, (start, n) in enumerate(zip(offset, size)):
        if n != full.shape[d]:
            local = local.narrow(d, start, n)
    return _own(local.contiguous(), None)


def _finish(value, dtype, mesh, spec, full_shape=None):
    """A target's result: cast, then (with a mesh) this rank's DTensor.
    ``value`` is the whole tensor, or with ``full_shape`` the rank's shard
    of a tensor of that shape already."""
    value = _own(value, dtype)
    if mesh is None:
        return value
    from torch.distributed.tensor import DTensor

    if full_shape is None:
        placements = spec_placements(spec, mesh, value.dim())
        return DTensor.from_local(_local_shard(value, mesh, placements), mesh, placements,
                                  run_check=False, shape=value.shape, stride=value.stride())
    placements = spec_placements(spec, mesh, len(full_shape))
    return DTensor.from_local(value, mesh, placements, run_check=False,
                              shape=torch.Size(full_shape),
                              stride=tuple(_contiguous_strides(full_shape)))


def _placed_box(mesh, spec):
    """``box(i, full_shape)`` for :func:`_replay_targets`: the rank's shard
    under ``spec(i)`` on ``mesh`` (None without a mesh: whole tensors)."""
    if mesh is None:
        return None
    return lambda i, shape: _shard_box(shape, mesh, spec_placements(spec(i), mesh, len(shape)))


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
    """One fake tensor's value, replayed with per-node seeded streams
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

    spec = spec or PartitionSpec()

    def finish(_, value, full_shape):
        out["value"] = _finish(value, dtype, mesh, spec, full_shape)

    with _telemetry.span("materialize.tensor"), _perf.program("materialize"):
        _replay_targets([(record.node, record.index)], [stack], seed, replay_device, finish,
                        box=_placed_box(mesh, lambda _: spec))
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

        def finish(i, value, full_shape):
            results[named[i][0]] = _finish(value, dtype, place, specs[i], full_shape)

        with _perf.program("materialize"):
            _replay_targets(targets, stacks, seed, replay_device, finish, ordinals,
                            box=_placed_box(place, specs.__getitem__))
        results = {name: results[name] for name, _ in named}
    except BaseException as e:
        span.end(error=type(e).__name__)
        raise
    span.end(n_params=len(results))
    return results
