"""Deferred module initialization: record construction, inspect, materialize.

``deferred_init(module_fn, *args, **kwargs)`` constructs a module whose
parameters/buffers are fake while recording every operation into the op
tape (:mod:`torchdistx_tpu_torch._tape`); ``materialize_tensor`` /
``materialize_module`` replay the tape to instantiate real tensors — on the
GPU, straight from the recording, with no host copy.

A ``TorchDispatchMode`` records every op through which a fake flows;
``nn.Parameter(fake)`` routes through ``aten::detach``, which is dispatched,
so parameter creation records like any other op.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import torch
import torch.nn as nn
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from . import _tape
from ._tape import OpNode, Tape, TensorRecord  # noqa: F401 (public graph types)
from .fake import FakeTensor, _fake_handler, _suppress_cuda_lazy_init
from .telemetry import perf as _perf

__all__ = [
    "deferred_init",
    "materialize_tensor",
    "materialize_module",
    "is_deferred",
]

_SLOT = "deferred_init"

# Terminal ops force materialization of their args and then run for real:
# `_local_scalar_dense` is what `.item()` lowers to at this seam;
# `aten::equal` and `aten::allclose` also need real data.
_TERMINAL_OPS = {
    "aten::item",
    "aten::_local_scalar_dense",
    "aten::equal",
    "aten::allclose",
}


def _get_record(fake: FakeTensor) -> Optional[TensorRecord]:
    return fake._slots.get(_SLOT)


def is_deferred(tensor: torch.Tensor) -> bool:
    """True if ``tensor`` is fake and carries a deferred-init record."""
    return isinstance(tensor, FakeTensor) and _get_record(tensor) is not None


class _DeferredInitMode(TorchDispatchMode):
    """Record/redispatch mode: run each op through the fake handler and
    record it iff a fake flows in or out."""

    def __init__(self, tape: Tape, default_device: Optional[torch.device]):
        super().__init__()
        self.tape = tape
        self.default_device = default_device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.name() in _TERMINAL_OPS:
            def mat(a):
                if isinstance(a, FakeTensor):
                    return materialize_tensor(a)
                return a

            r_args, r_kwargs = pytree.tree_map(mat, (tuple(args), dict(kwargs)))
            return func(*r_args, **r_kwargs)

        out = _fake_handler(
            func, args, kwargs, default_device=self.default_device
        )
        fake_outputs = [
            o for o in pytree.tree_leaves(out) if isinstance(o, FakeTensor)
        ]
        has_fake_arg = any(
            isinstance(a, FakeTensor) for a in pytree.tree_leaves((args, kwargs))
        )
        if has_fake_arg or fake_outputs:
            _tape.record_op(self.tape, func, args, kwargs, fake_outputs)
        return out


class _ClaimedLiteralMode(TorchFunctionMode):
    """``torch.tensor(data)`` under a claimed device other than the CPU:
    built on the CPU, then copied into an empty tensor of the claimed
    device, which the recording mode makes a fake (the copy recorded, the
    external CPU tensor guarded).  ``torch.tensor`` moves its data to the
    device inside one call that the dispatch mode does not see, so without
    this a literal such as a BatchNorm's ``num_batches_tracked`` would be
    allocated on the card while recording (and fail on a host without
    CUDA)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.tensor:
            device = torch.device(kwargs.get("device") or self.device)
            if device.type != "cpu":
                grad = kwargs.get("requires_grad", False)
                real = func(*args, **{**kwargs, "device": "cpu", "requires_grad": False})
                out = torch.empty(real.shape, dtype=real.dtype, device=device)
                # The op itself, not the method: the method's binding would
                # take a guard of the claimed device first.
                return torch.ops.aten.copy_.default(out, real).requires_grad_(grad)
        return func(*args, **kwargs)


@contextlib.contextmanager
def _deferred_init_context(device: Optional[Any] = None):
    """Enter/leave the deferred-init recording context."""
    if device is not None:
        device = torch.device(device)
    tape = _tape.push_tape()
    mode = _DeferredInitMode(tape, default_device=device)
    try:
        with contextlib.ExitStack() as stack:
            # Factory bindings would otherwise fail for claimed "cuda"
            # devices on hosts without CUDA before dispatch reaches the mode.
            stack.enter_context(_suppress_cuda_lazy_init())
            if device is not None:
                # Factories arrive already carrying the claimed device.
                stack.enter_context(torch.device(device))
                stack.enter_context(_ClaimedLiteralMode(device))
            stack.enter_context(mode)
            yield tape
    finally:
        _tape.pop_tape()


def deferred_init(module_fn: Callable[..., Any], *args, **kwargs):
    """Construct ``module_fn(*args, **kwargs)`` with fake, recorded tensors.

    The optional keyword-only ``device_`` sets the claimed device for the
    module's factory calls (``device_="cuda"`` fakes a model "on the GPU",
    also on a host without CUDA); by default factories claim the device
    they ask for, else the CPU.
    """
    device = kwargs.pop("device_", None)
    with _deferred_init_context(device=device):
        return module_fn(*args, **kwargs)


def _wrap_materialized(fake: FakeTensor, node: OpNode, index: int) -> torch.Tensor:
    """Materializing the same (node, output) twice returns the *same*
    Python object, and a fake ``nn.Parameter`` materializes as an
    ``nn.Parameter``."""
    cached = node.materialized_pyobjs.get(index)
    if cached is not None:
        return cached
    real = node.op.outputs[index]
    # `requires_grad_()` is not dispatcher-visible: restore it from the fake.
    if isinstance(real, torch.Tensor):
        if real.is_leaf and real.requires_grad != fake.requires_grad:
            real.requires_grad_(fake.requires_grad)
        if isinstance(fake, nn.Parameter) or getattr(fake, "_is_param", False):
            if not isinstance(real, nn.Parameter):
                real = nn.Parameter(real, requires_grad=fake.requires_grad)
    node.materialized_pyobjs[index] = real
    return real


@contextlib.contextmanager
def _replay_device_override(device: Optional[Any]):
    if device is None:
        yield
        return
    prev = getattr(_tape._tls, "device_override", None)
    _tape._tls.device_override = torch.device(device)
    try:
        yield
    finally:
        _tape._tls.device_override = prev


def _replay(nodes) -> None:
    # Replay with recording/fake modes disabled: materialization may run
    # inside the deferred-init context (terminal ops do) and must execute
    # for real.
    with torch.utils._python_dispatch._disable_current_modes():
        for node in nodes:
            _tape.replay_node(node)


def materialize_tensor(
    tensor: torch.Tensor, *, device: Optional[Any] = None
) -> torch.Tensor:
    """Materialize a fake tensor by replaying its recorded subgraph.

    No-op for real tensors and for fakes with no record.  Factory ops replay
    on the device they claimed; ``device`` redirects them (e.g. a ``cuda``
    claim replayed on the CPU).
    """
    if not isinstance(tensor, FakeTensor):
        return tensor
    record = _get_record(tensor)
    if record is None:
        return tensor
    with _replay_device_override(device), _perf.program("materialize"):
        _replay(_tape.build_call_stack(record.node))
    return _wrap_materialized(tensor, record.node, record.index)


def _collect_materialization_targets(
    module: nn.Module,
    buffers_only: bool,
    check_fn: Optional[Callable[[nn.Module], bool]],
    out: list,
) -> None:
    for child in module.children():
        _collect_materialization_targets(child, buffers_only, check_fn, out)
    if check_fn is not None and not check_fn(module):
        return
    if not buffers_only:
        for key, param in module._parameters.items():
            if param is not None and is_deferred(param):
                out.append((module._parameters, key, param))
    for key, buf in module._buffers.items():
        if buf is not None and is_deferred(buf):
            out.append((module._buffers, key, buf))


def materialize_module(
    module: nn.Module,
    *,
    buffers_only: bool = False,
    check_fn: Optional[Callable[[nn.Module], bool]] = None,
    device: Optional[Any] = None,
) -> nn.Module:
    """Materialize all fake parameters/buffers of ``module`` in place.

    Depth-first over ``module.children()``, rewriting ``module._parameters``
    and ``module._buffers``; ``buffers_only`` skips parameters; ``check_fn``
    gates whole submodules.  ``device`` redirects the replayed factory ops
    (``None``: each replays on the device it claimed).  Returns ``module``.

    All targets' call stacks are merged and replayed once in global
    chronological order, so results never depend on module traversal order
    and random ops draw from the default generator in construction order.
    """
    targets: list = []
    _collect_materialization_targets(module, buffers_only, check_fn, targets)
    nodes = {}
    for _, _, fake in targets:
        for node in _tape.build_call_stack(_get_record(fake).node):
            nodes[node.op_nr] = node
    with _replay_device_override(device), _perf.program("materialize"):
        _replay(nodes[nr] for nr in sorted(nodes))
    for container, key, fake in targets:
        record = _get_record(fake)
        container[key] = _wrap_materialized(fake, record.node, record.index)
    return module
