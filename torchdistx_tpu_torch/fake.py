"""Fake tensors: metadata-only tensors that claim a real (possibly absent) device.

The port's own copy of the JAX package's fake tensors, without the ``tpu``
device name.

* ``torch.Tensor._make_wrapper_subclass`` creates a storage-less tensor that
  *reports* an arbitrary device.  Each fake carries a shadow **meta** tensor
  used for all shape/stride/dtype dispatch.
* ``__torch_dispatch__`` (subclass + mode) is the interception seam: ops on
  fakes run on the meta shadows; factory ops under :func:`fake_mode` are
  redirected to the meta backend and their outputs wrapped as fakes claiming
  the requested device.
* Claiming ``cuda`` on a host without CUDA needs no device guard, because
  the wrapper subclass never touches a backend; only the factory bindings'
  eager ``torch.cuda._lazy_init`` is suppressed while a mode is active.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._mode_utils import no_dispatch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "FakeTensor",
    "fake_mode",
    "is_fake",
    "meta_like",
    "current_fake_mode",
]

_tls = threading.local()


@contextlib.contextmanager
def _suppress_cuda_lazy_init():
    """Suppress CUDA lazy initialization while a fake mode is active.

    Factory bindings call ``torch.cuda._lazy_init`` for ``device="cuda"``
    *before* dispatch reaches the interception seam, which fails on hosts
    without CUDA.  The op itself never touches CUDA — the mode diverts it to
    meta.
    """
    if torch.cuda.is_available():
        yield
        return
    prev = torch.cuda._lazy_init
    torch.cuda._lazy_init = lambda: None
    try:
        yield
    finally:
        torch.cuda._lazy_init = prev


class FakeTensor(torch.Tensor):
    """A tensor with no storage that claims to live on ``fake_device``.

    Holds a shadow meta tensor (``_meta``) used for dispatch, reports the
    claimed device, and carries a per-subsystem side-data dict ``_slots``
    that deferred init uses to attach its graph record.
    """

    _meta: torch.Tensor
    fake_device: torch.device
    _slots: Dict[str, Any]

    @staticmethod
    def __new__(cls, meta: torch.Tensor, fake_device: torch.device):
        if meta.device.type != "meta":
            raise ValueError("FakeTensor shadow must be a meta tensor")
        r = torch.Tensor._make_wrapper_subclass(  # type: ignore[attr-defined]
            cls,
            meta.shape,
            strides=meta.stride(),
            storage_offset=meta.storage_offset(),
            dtype=meta.dtype,
            layout=meta.layout,
            device=fake_device,
            requires_grad=meta.requires_grad,
        )
        r._meta = meta
        r.fake_device = fake_device
        r._slots = {}
        return r

    # `Tensor.data` reads flow through the wrapper subclass; only the
    # *setter* needs interception: it swaps the TensorImpl underneath the
    # Python object, which would orphan the fake's meta shadow and
    # deferred-init record.
    @property
    def data(self):
        return torch.Tensor.data.__get__(self)

    @data.setter
    def data(self, new):
        if not isinstance(new, FakeTensor):
            # A real tensor assigned into a fake param: lift it onto the
            # tape as `aten.clone(new)` (external-guarded).
            from . import _tape

            tape = _tape.current_tape()
            if tape is None:
                raise RuntimeError(
                    "Cannot assign a real tensor to `.data` of a fake "
                    "tensor outside of a deferred-init context: the "
                    "assignment could not be recorded for materialization."
                )
            with no_dispatch():
                meta = torch.empty_strided(
                    new.shape, new.stride(), dtype=new.dtype, device="meta"
                )
            lifted = FakeTensor(meta, self.fake_device)
            _tape.record_op(
                tape, torch.ops.aten.clone.default, (new,), {}, [lifted]
            )
            new = lifted
        torch.Tensor.data.__set__(self, new)
        self._meta = new._meta
        self._slots = dict(new._slots)
        self.fake_device = new.fake_device

    def __repr__(self, *, tensor_contents=None):  # noqa: D105
        grad = ", requires_grad=True" if self.requires_grad else ""
        return (
            f"tensor(..., device='{self.fake_device}', size={tuple(self.shape)}, "
            f"dtype={self.dtype}{grad}, fake=True)"
        )

    __str__ = __repr__

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        # Ops touching fake tensors outside of any active mode still hit
        # this seam: the interception lives on the tensor, not only in TLS.
        return _fake_handler(func, args, kwargs or {}, default_device=None)


class _FakeMode(TorchDispatchMode):
    """Catch-all interception while :func:`fake_mode` is active: *factory*
    ops (no tensor args) are also intercepted and produce fakes."""

    def __init__(self, default_device: Optional[torch.device] = None):
        super().__init__()
        self.default_device = default_device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return _fake_handler(
            func, args, kwargs or {}, default_device=self.default_device
        )


def _tensor_to_meta(t: torch.Tensor) -> torch.Tensor:
    # Real (non-fake) tensor mixed into a faked op: use its metadata only.
    with no_dispatch():
        return torch.empty_strided(
            t.shape, t.stride(), dtype=t.dtype, device="meta"
        ).requires_grad_(t.requires_grad and t.is_leaf)


def _map_tensors(obj, fn):
    """Map ``fn`` over every tensor leaf of ``obj``."""
    return pytree.tree_map(
        lambda a: fn(a) if isinstance(a, torch.Tensor) else a, obj
    )


def _fake_handler(func, args, kwargs, *, default_device: Optional[torch.device]):
    """The per-op handler.

    Device rules: an explicit ``device`` argument wins, else the first fake
    argument's claimed device, else the mode's default claimed device (for
    factories), else the op runs for real untouched.
    """
    flat_args = pytree.tree_leaves((args, kwargs))
    fakes = [a for a in flat_args if isinstance(a, FakeTensor)]
    has_tensor_args = any(isinstance(a, torch.Tensor) for a in flat_args)

    device_kwarg = kwargs.get("device")
    if device_kwarg is not None:
        out_device = torch.device(device_kwarg)
    elif fakes:
        out_device = fakes[0].fake_device
        for f in fakes[1:]:
            if f.fake_device != out_device:
                raise RuntimeError(
                    f"Cannot run '{func}' with fake tensors on mixed devices "
                    f"({out_device} and {f.fake_device})."
                )
    elif default_device is not None and not has_tensor_args:
        # The mode's default claimed device applies to *factories* only —
        # an op over real tensors must run for real, not be hijacked onto
        # meta with its data discarded.
        out_device = torch.device(default_device)
    else:
        out_device = None

    if out_device is None and not fakes:
        # Pure real-tensor op under the mode: forward untouched.
        return func(*args, **kwargs)
    if out_device is None:
        out_device = torch.device("cpu")
    if out_device.type == "meta":
        # Explicitly asked for meta — not ours to wrap.
        return func(*args, **kwargs)

    # Swap fake args for their meta shadows, keeping an identity map so
    # in-place ops hand back the original fake wrapper.
    meta_to_fake: Dict[int, FakeTensor] = {}

    def unwrap(a):
        if isinstance(a, FakeTensor):
            meta_to_fake[id(a._meta)] = a
            return a._meta
        if a.device.type != "meta":
            return _tensor_to_meta(a)
        return a

    u_args, u_kwargs = _map_tensors((tuple(args), dict(kwargs)), unwrap)
    if u_kwargs.get("device") is not None:
        # Redispatch the factory to the meta backend.
        u_kwargs["device"] = torch.device("meta")

    try:
        out = func(*u_args, **u_kwargs)
    except NotImplementedError as e:
        raise RuntimeError(
            f"The operator '{func}' has no meta-backend support, so it cannot "
            f"be run with fake tensors."
        ) from e

    def wrap(o):
        if o.device.type == "meta":
            existing = meta_to_fake.get(id(o))
            if existing is not None:
                return existing
            return FakeTensor(o, out_device)
        return o

    return _map_tensors(out, wrap)


@contextlib.contextmanager
def fake_mode(*, fake_cuda: bool = False, device: Optional[Any] = None):
    """Context manager within which newly constructed tensors are fake.

    ``fake_cuda`` is accepted for API parity with torchdistX (claiming
    ``device="cuda"`` is legal on hosts without CUDA either way).
    ``device`` optionally sets the claimed device for factory calls that do
    not pass one — e.g. ``fake_mode(device="cuda")`` builds a whole model
    "on the GPU" with zero allocation anywhere.
    """
    if device is not None:
        device = torch.device(device)
    mode = _FakeMode(default_device=device)
    mode_stack = getattr(_tls, "mode_stack", None)
    if mode_stack is None:
        mode_stack = _tls.mode_stack = []
    mode_stack.append(mode)
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(_suppress_cuda_lazy_init())
            if device is not None:
                # Route the claimed default through torch's DeviceContext so
                # factory calls arrive at the handler already carrying it.
                stack.enter_context(torch.device(device))
            stack.enter_context(mode)
            yield mode
    finally:
        mode_stack.pop()


def current_fake_mode() -> Optional[_FakeMode]:
    stack = getattr(_tls, "mode_stack", None)
    return stack[-1] if stack else None


def is_fake(tensor: torch.Tensor) -> bool:
    """True if ``tensor`` is fake."""
    return isinstance(tensor, FakeTensor)


def meta_like(fake: torch.Tensor) -> torch.Tensor:
    """Detached meta clone of a fake tensor."""
    if not is_fake(fake):
        raise ValueError("`fake` is not a fake tensor.")
    with no_dispatch():
        return fake._meta.detach().clone()
