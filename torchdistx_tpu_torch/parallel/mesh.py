"""Device meshes over ``torch.distributed``.

Counterpart of ``torchdistx_tpu/parallel/mesh.py``: the same named axes in
the same canonical order, built as a ``torch.distributed`` ``DeviceMesh``
(one rank per device) in place of a ``jax.sharding.Mesh``.

* ``"dp"``   — data parallel (outermost)
* ``"fsdp"`` — parameter/optimizer sharding (ZeRO-style)
* ``"tp"``   — tensor parallel (innermost of the model axes)
* ``"sp"``   — sequence/context parallel
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from .._device import resolve_device

__all__ = ["AXIS_ORDER", "MeshSpec", "make_mesh"]

# Canonical outer -> inner axis order, shared by every mesh builder.
AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "fsdp", "tp", "sp", "ep")


@dataclass(frozen=True)
class MeshSpec:
    """Named mesh shape, e.g. ``MeshSpec(dp=2, fsdp=2, tp=2)``."""

    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    def axes(self) -> Tuple[Tuple[str, int], ...]:
        return tuple(
            (name, size)
            for name, size in (
                (name, getattr(self, name)) for name in AXIS_ORDER
            )
            if size > 1
        ) or (("dp", 1),)

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.axes():
            n *= s
        return n


def make_mesh(
    spec: Optional[MeshSpec] = None,
    *,
    device_type: Optional[str] = None,
    axis_names: Optional[Sequence[str]] = None,
    shape: Optional[Sequence[int]] = None,
):
    """Build a ``DeviceMesh`` over the initialised default process group.

    With a :class:`MeshSpec`, axes are laid out in :data:`AXIS_ORDER` ("dp"
    outermost); otherwise ``axis_names`` (default ``("dp",)``) and ``shape``
    (default: the world size).  ``device_type=None`` means ``"cuda"`` and
    raises without CUDA; pass ``"cpu"`` for a gloo mesh on the host.  Raises
    when the mesh's size differs from the world size.  The caller
    initialises ``torch.distributed`` (address, world size and rank).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = resolve_device(device_type).type
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed initialised "
            "(torch.distributed.init_process_group)"
        )
    world = dist.get_world_size()
    if spec is not None:
        names = [n for n, _ in spec.axes()]
        sizes = [s for _, s in spec.axes()]
    else:
        names = list(axis_names or ("dp",))
        sizes = list(shape or (world,))
    n = 1
    for s in sizes:
        n *= s
    if n != world:
        raise ValueError(
            f"Mesh of shape {dict(zip(names, sizes))} needs {n} devices, "
            f"got {world}."
        )
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(names))
