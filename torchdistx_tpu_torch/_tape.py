"""The deferred-init op tape: a bidirectional op graph with mutation semantics.

The port's own copy of the JAX package's recorder, on its pure-Python graph
(the reference's documented path with the same semantics): ``Op`` (recorded
call + deep-copied args + grad mode), ``OpNode`` (chronological ``op_nr``,
dependency edges, output-storage sets for aliasing, external-tensor version
guards), ``TensorRecord`` (per-fake side data naming the producing
(node, index)), and the materializer's call-stack builder (last-in-place-op
horizon search + transitive-closure collection + chronological sort).

* Mutation tracking uses operator *schemas* (``alias_info.is_write``).
* Aliasing is tracked through the fakes' **meta shadow storages** (meta
  tensors have real storage identity but no data).
* Replay caching is per node: an op replays once and caches its outputs;
  in-place replays mutate the cached outputs, as the recording did.
"""

from __future__ import annotations

import copy
import itertools
import threading
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree

_tls = threading.local()

# Process-wide chronological op counter.  Global so that op_nr is unique
# across tapes: a module may be assembled from several deferred_init calls,
# and replay order is keyed by op_nr.  Random streams never key on it: the
# seeded materializer keys them on the tape-relative number
# ``op_nr - base_nr`` (and the tape's ordinal), which does not depend on how
# many tapes ran earlier in the process.
_op_counter = itertools.count()


class OutputRef:
    """Marker replacing a fake-tensor argument inside a recorded arg stack:
    names the producing node + output index, and holds the node strongly."""

    __slots__ = ("node", "index")

    def __init__(self, node: "OpNode", index: int):
        self.node = node
        self.index = index

    def __repr__(self):
        return f"OutputRef(op_nr={self.node.op_nr}, index={self.index})"


@dataclass
class ExternalTensorGuard:
    """Version guard for a real (non-fake) tensor captured by the tape:
    replaying an op whose external input has since been mutated would
    silently produce different values, so record its version and verify it
    at replay."""

    tensor: torch.Tensor
    version: int

    def check(self) -> None:
        if self.tensor.is_inference():
            raise RuntimeError(
                "Cannot materialize: a recorded operation captured an "
                "inference-mode tensor."
            )
        if self.tensor._version != self.version:
            raise RuntimeError(
                "Cannot materialize: an external tensor captured by a "
                "recorded operation was mutated after recording "
                f"(version {self.tensor._version} != {self.version})."
            )


@dataclass
class TensorRecord:
    """Per-fake-tensor side data: who produced it."""

    node: "OpNode"
    index: int


class Op:
    """A recorded operation: callable + deep-copied boxed arguments + the
    grad mode at record time.  Replay runs once and caches outputs."""

    __slots__ = (
        "name", "func", "args", "kwargs", "grad_enabled", "guards",
        "replayed", "outputs",
    )

    def __init__(self, name, func, args, kwargs, grad_enabled, guards):
        self.name = name
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.grad_enabled = grad_enabled
        self.guards: List[ExternalTensorGuard] = guards
        self.replayed = False
        self.outputs: Optional[List[Any]] = None


class OpNode:
    """Graph node.  Dependency edges live in ``op.args``/``op.kwargs`` as
    :class:`OutputRef` markers; ``dependents`` are back-edges to later ops
    that wrote any storage this node touches (strong refs: the GC collects
    cycles, and they keep in-place ops on dropped views reachable)."""

    __slots__ = (
        "op_nr", "op", "dependents", "out_storages", "write_storages",
        "pinned_storages", "num_outputs", "materialized_pyobjs", "base_nr",
        "__weakref__",
    )

    def __init__(self, op_nr: int, op: Op):
        self.op_nr = op_nr
        self.op = op
        self.dependents: List["OpNode"] = []
        self.out_storages: List[int] = []
        self.write_storages: List[int] = []
        # Keep the meta storage objects alive: storage keys are raw
        # StorageImpl addresses, and a freed address could be reused by an
        # unrelated tensor, creating false alias edges.
        self.pinned_storages: List[Any] = []
        self.num_outputs = 0
        # Python-identity cache: materializing the same output twice returns
        # the same object.
        self.materialized_pyobjs: Dict[int, Any] = {}
        # First op_nr of this node's tape, set at record time.
        self.base_nr = 0

    def __repr__(self):
        return f"OpNode({self.op_nr}: {self.op.name})"


class Tape:
    """The active recording: a storage→[(op_nr, node)] writer index used at
    record time to install the dependent back-edges.  Materialization then
    navigates the node graph alone, so it works long after the tape is
    gone."""

    def __init__(self):
        self.writers: Dict[int, List[Tuple[int, weakref.ref]]] = {}
        self.base_nr: Optional[int] = None  # op_nr of the first recorded op

    def note_write(self, storage_key: int, node: OpNode) -> None:
        entries = self.writers.setdefault(storage_key, [])
        # Link every earlier toucher of this storage to the new writer.
        for _, ref in entries:
            prev = ref()
            if prev is not None and prev is not node:
                prev.dependents.append(node)
        entries.append((node.op_nr, weakref.ref(node)))


def current_tape() -> Optional[Tape]:
    return getattr(_tls, "tape", None)


def push_tape() -> Tape:
    tape = Tape()
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(tape)
    _tls.tape = tape
    return tape


def pop_tape() -> None:
    stack = _tls.stack
    stack.pop()
    _tls.tape = stack[-1] if stack else None


def _storage_key(meta: torch.Tensor) -> int:
    return meta.untyped_storage()._cdata


def _mutated_arg_indices(func) -> Tuple[int, ...]:
    """Schema-arg indices the op writes to, from the schema alias info.

    Indices address ``schema.arguments`` — kwarg-only args (out-variant
    buffers) get indices past ``len(args)`` and are resolved by
    :func:`arg_at_schema_pos`.
    """
    try:
        schema = func._schema
    except AttributeError:
        return ()
    return tuple(
        i for i, arg in enumerate(schema.arguments)
        if arg.alias_info is not None and arg.alias_info.is_write
    )


def arg_at_schema_pos(func, args, kwargs, pos):
    """The value bound to schema argument ``pos``, positional or kwarg-only."""
    if pos < len(args):
        return args[pos]
    try:
        name = func._schema.arguments[pos].name
    except (AttributeError, IndexError):
        return None
    return kwargs.get(name)


# Per-func cache of (name string, mutated schema-arg indices): schemas are
# immutable, and recomputing them per op is measurable on large models.
_SCHEMA_CACHE: Dict[Any, Tuple[str, Tuple[int, ...]]] = {}


def _schema_info(func) -> Tuple[str, Tuple[int, ...]]:
    info = _SCHEMA_CACHE.get(func)
    if info is None:
        info = (str(func), _mutated_arg_indices(func))
        _SCHEMA_CACHE[func] = info
    return info


def record_op(
    tape: Tape,
    func,
    args: tuple,
    kwargs: dict,
    fake_outputs: list,
) -> OpNode:
    """Record one op.

    ``fake_outputs`` are the fake tensors the op produced (or mutated).
    Fake args become dependency edges and are *dropped* from the preserved
    stack (replaced by :class:`OutputRef`).  Real tensors are kept with
    version guards; all other leaves are deep-copied.
    """
    from .deferred_init import _SLOT
    from .fake import FakeTensor

    guards: List[ExternalTensorGuard] = []

    def preserve(a):
        if isinstance(a, FakeTensor):
            rec = a._slots.get(_SLOT)
            if rec is None:
                raise RuntimeError(
                    "Cannot record an operation on a fake tensor that was "
                    "created outside of a deferred-init context."
                )
            return OutputRef(rec.node, rec.index)
        if isinstance(a, torch.Tensor):
            guards.append(ExternalTensorGuard(a, a._version))
            return a
        if isinstance(a, (int, float, bool, str, bytes, complex, type(None),
                          torch.dtype, torch.device, torch.layout,
                          torch.memory_format, torch.Generator)):
            return a
        # Anything else must be deep-copyable (immutability of the
        # recorded stack).
        try:
            return copy.deepcopy(a)
        except Exception as e:  # pragma: no cover
            raise RuntimeError(
                f"Cannot record op '{func}': argument of type "
                f"{type(a).__name__} is not preservable."
            ) from e

    p_args, p_kwargs = pytree.tree_map(preserve, (tuple(args), dict(kwargs)))
    name, mutated = _schema_info(func)
    op = Op(
        name=name,
        func=func,
        args=p_args,
        kwargs=p_kwargs,
        grad_enabled=torch.is_grad_enabled(),
        guards=guards,
    )
    node = OpNode(next(_op_counter), op)
    if tape.base_nr is None:
        tape.base_nr = node.op_nr
    node.base_nr = tape.base_nr
    node.num_outputs = len(fake_outputs)

    # Output storages for aliasing checks, via the meta shadows.
    for out in fake_outputs:
        if out is not None:
            node.out_storages.append(_storage_key(out._meta))
            node.pinned_storages.append(out._meta.untyped_storage())

    # Storages the op WROTE: schema-mutated args + all outputs (an output
    # freshly created or aliasing a mutated arg both count as written).
    for i in mutated:
        a = arg_at_schema_pos(func, args, kwargs, i)
        if isinstance(a, FakeTensor):
            node.write_storages.append(_storage_key(a._meta))
            node.pinned_storages.append(a._meta.untyped_storage())
    node.write_storages.extend(node.out_storages)
    for key in set(node.write_storages):
        tape.note_write(key, node)

    # Point each fake output's record at this node.
    for idx, out in enumerate(fake_outputs):
        if out is not None:
            out._slots[_SLOT] = TensorRecord(node, idx)
    return node


def build_call_stack(target: OpNode) -> List[OpNode]:
    """Build the chronological replay schedule for ``target``.

    Find the last in-place op touching any storage aliased with the
    target's outputs (the *horizon*), then collect the transitive
    dependency closure plus in-place dependents within the horizon, sorted
    by ``op_nr``.  Self-contained on the node graph — no live tape needed.
    """
    horizon = target.op_nr
    for d in target.dependents:
        if d.op_nr > horizon:
            horizon = d.op_nr
    result: Dict[int, OpNode] = {}
    work: List[OpNode] = [target]
    while work:
        node = work.pop()
        if node.op_nr in result:
            continue
        result[node.op_nr] = node
        for ref in pytree.tree_iter((node.op.args, node.op.kwargs)):
            if isinstance(ref, OutputRef):
                work.append(ref.node)
        for d in node.dependents:
            if d.op_nr <= horizon:
                work.append(d)
    return [result[nr] for nr in sorted(result)]


def replay_node(node: OpNode) -> List[Any]:
    """Replay one node for real.  Idempotent: runs once and caches outputs.

    Factory ops replay on the device they recorded, unless a replay-time
    override is in force (``materialize_module(device=...)``).  There is no
    fallback to the CPU: a ``cuda`` claim replayed on a host without CUDA
    raises, and the caller passes ``device="cpu"`` to replay there.
    """
    op = node.op
    if op.replayed:
        return op.outputs  # type: ignore[return-value]
    for guard in op.guards:
        guard.check()

    def resolve(a):
        if isinstance(a, OutputRef):
            outs = replay_node(a.node)
            return outs[a.index]
        return a

    r_args, r_kwargs = pytree.tree_map(resolve, (op.args, op.kwargs))
    override = getattr(_tls, "device_override", None)
    if override is not None and r_kwargs.get("device") is not None:
        r_kwargs["device"] = override
    with torch.set_grad_enabled(op.grad_enabled):
        out = op.func(*r_args, **r_kwargs)
    outputs = list(out) if isinstance(out, (tuple, list)) else [out]
    op.outputs = outputs
    op.replayed = True
    return outputs
