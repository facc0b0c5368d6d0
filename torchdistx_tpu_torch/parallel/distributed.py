"""Multi-process runtime: process-group init, flag agreement and hybrid
(intra-host x inter-host) meshes.

Counterpart of ``torchdistx_tpu/parallel/distributed.py``.  There,
``initialize`` wraps ``jax.distributed.initialize`` and a mesh spans every
device of every process; here a process drives one device (one rank per
device) and the runtime is ``torch.distributed``:

* :func:`initialize` — ``init_process_group`` with NCCL on CUDA and gloo
  with ``device="cpu"``: ``env://`` with no arguments (``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as torchrun sets them),
  ``tcp://<coordinator_address>`` otherwise.  Idempotent, and it adopts a
  group that is already initialized.
* :func:`any_flag` / :func:`any_flags` — agreement on host-local flags
  (the preemption/exit protocol of ``fit``).
* :func:`make_hybrid_mesh` — a ``DeviceMesh`` whose axes are each split
  into an intra-host factor (the reference's ICI) and an inter-host factor
  (its DCN), DCN-major, so only the axes placed on ``dcn`` (SlowMo's ``dp``
  averaging axis, classically) cross hosts.  A granule (the reference's
  pod slice) is a host.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from .mesh import AXIS_ORDER, MeshSpec, make_mesh

__all__ = [
    "ProcessInfo",
    "any_flag",
    "any_flags",
    "initialize",
    "make_hybrid_mesh",
    "world_info",
]


@dataclass(frozen=True)
class ProcessInfo:
    """The JAX ``ProcessInfo``'s fields.  A process drives one device, so
    ``local_device_count`` is 1 and ``global_device_count`` is the world
    size."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_info() -> ProcessInfo:
    """This process's rank and the world size (0 and 1 with no group)."""
    if not _initialized():
        return ProcessInfo(0, 1, 1, 1)
    world = dist.get_world_size()
    return ProcessInfo(dist.get_rank(), world, 1, world)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Optional[Any] = None,
) -> ProcessInfo:
    """Join the process group (``init_process_group``).

    Call once per process before any collective.  With no arguments the
    rendezvous is ``env://``; ``initialize("10.0.0.1:8476", num_processes=4,
    process_id=rank)`` rendezvouses at ``tcp://10.0.0.1:8476``.
    ``device=None`` means CUDA (NCCL; the process takes the device
    ``LOCAL_RANK``, else its rank modulo the devices) and raises without
    CUDA; ``device="cpu"`` uses gloo.

    Idempotent: a second call, or a call in a process whose group an outer
    launcher already initialized, returns the current :class:`ProcessInfo`.
    """
    device = resolve_device(device)
    if not _initialized():
        kwargs = {}
        if coordinator_address is not None:
            kwargs["init_method"] = f"tcp://{coordinator_address}"
        else:
            kwargs["init_method"] = "env://"
        if num_processes is not None:
            kwargs["world_size"] = num_processes
        if process_id is not None:
            kwargs["rank"] = process_id
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, **kwargs)
        if device.type == "cuda":
            local = os.environ.get("LOCAL_RANK")
            index = int(local) if local is not None else (
                dist.get_rank() % torch.cuda.device_count())
            torch.cuda.set_device(index)
    return world_info()


def any_flag(local: bool) -> bool:
    """Agree on a process-local boolean across all processes: True anywhere
    → True everywhere.  Single-flag convenience over :func:`any_flags`."""
    return any_flags((local,))[0]


def any_flags(local: Sequence[bool]) -> tuple:
    """Agree on a vector of process-local booleans across all processes, in
    ONE collective: position i of the result is True iff any process passed
    True at position i.

    The preemption/exit protocol's collective (see
    :mod:`torchdistx_tpu_torch.resilience.preemption`): processes may be
    signalled at different instants and their data streams may end at
    different steps, but a resumable checkpoint needs every process to stop
    at the SAME step, so ``fit()`` folds its exit flags through this
    ``all_reduce(MAX)`` of a small int tensor at each step boundary.

    With one process, or no initialized ``torch.distributed`` group, the
    local flags are returned (no collective, no cost).  With a group, every
    process must call it at the same point, like any collective; the tensor
    lives on the group's device (the current CUDA device under NCCL, the CPU
    otherwise).
    """
    flags = tuple(bool(x) for x in local)
    if not _initialized() or dist.get_world_size() == 1:
        return flags
    device = (torch.device("cuda", torch.cuda.current_device())
              if "nccl" in str(dist.get_backend()) else torch.device("cpu"))
    t = torch.tensor(flags, dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return tuple(bool(x) for x in t.tolist())


def _host_keys(world: int) -> list:
    """One key per rank naming its host.  With ``LOCAL_WORLD_SIZE`` set (as
    torchrun sets it; ranks are placed host-major) the key is ``rank //
    LOCAL_WORLD_SIZE``; otherwise every rank's host name, all-gathered (a
    collective: every rank calls this at the same point)."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None:
        return [r // int(local) for r in range(world)]
    names: List[Any] = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return names


def _degenerate_cpu_slices(hosts: Sequence, device_type: str) -> bool:
    """True when every rank is on ONE host and the ranks run on the CPU:
    granule metadata that carries no inter-host structure (the test rig of
    gloo processes on one machine).  On CUDA one host is a genuine
    single-host topology and is NOT degenerate, so asking for more DCN
    granules than there are hosts fails loudly instead of relabeling an
    intra-host boundary as DCN."""
    return len(set(hosts)) == 1 and device_type == "cpu"


def _slice_granules(hosts: Sequence) -> List[List[int]]:
    """Group ranks into DCN granules, one per host, in sorted key order, so
    every rank builds the same mesh."""
    granules: dict = {}
    for rank, key in enumerate(hosts):
        granules.setdefault(key, []).append(rank)
    return [granules[k] for k in sorted(granules)]


def _axis_factors(ici: MeshSpec, dcn: MeshSpec) -> Tuple[list, list, list]:
    """``(names, ici_sizes, dcn_sizes)`` of the axes either spec splits, in
    :data:`AXIS_ORDER`."""
    names, ici_sizes, dcn_sizes = [], [], []
    for name in AXIS_ORDER:
        i, d = getattr(ici, name), getattr(dcn, name)
        if i > 1 or d > 1:
            names.append(name)
            ici_sizes.append(i)
            dcn_sizes.append(d)
    return names, ici_sizes, dcn_sizes


def _hybrid_ranks(ici: MeshSpec, dcn: MeshSpec, hosts: Sequence,
                  device_type: str) -> Tuple[Tuple[str, ...], np.ndarray]:
    """``(axis names, rank array)`` of the hybrid mesh of ``len(hosts)``
    ranks whose host keys are ``hosts``: a pure function, so it can be held
    against the JAX ``mesh.devices`` ids.

    Each axis's extent is ``dcn x ici``, DCN-major.  A trivial ``dcn`` is
    the plain mesh (ranks in order).  Otherwise the ranks form one granule
    per host (:func:`_slice_granules`); a degenerate CPU rig's single
    granule is split contiguously (no granule metadata: the test rig), and
    any other granule count that differs from the DCN extent raises.
    """
    n = len(hosts)
    if dcn.size == 1:
        names = tuple(name for name, _ in ici.axes())
        sizes = tuple(size for _, size in ici.axes())
        if ici.size != n:
            raise ValueError(
                f"Mesh of shape {dict(zip(names, sizes))} needs {ici.size} devices, "
                f"got {n}."
            )
        return names, np.arange(n).reshape(sizes)
    names, ici_sizes, dcn_sizes = _axis_factors(ici, dcn)
    n_slices, per_slice = int(np.prod(dcn_sizes)), int(np.prod(ici_sizes))
    if n_slices * per_slice != n:
        raise ValueError(
            f"Hybrid mesh ici={ici_sizes} × dcn={dcn_sizes} needs "
            f"{n_slices * per_slice} devices, got {n}."
        )
    granules = _slice_granules(hosts)
    if len(granules) == 1 and n_slices > 1 and _degenerate_cpu_slices(hosts, device_type):
        flat = granules[0]
        granules = [flat[i * per_slice:(i + 1) * per_slice] for i in range(n_slices)]
    elif len(granules) != n_slices:
        # Real host metadata that contradicts the requested DCN extent must
        # NOT degrade to a contiguous split: that would lay intra-host axes
        # across hosts.
        raise ValueError(
            f"Requested {n_slices} DCN granule(s) but the devices form "
            f"{len(granules)} (by host); adjust the dcn spec to match the "
            "topology."
        )
    if any(len(g) != per_slice for g in granules):
        raise ValueError(
            f"Each slice must contribute {per_slice} devices; got "
            f"{[len(g) for g in granules]}."
        )
    k = len(names)
    arr = np.array([np.reshape(g, ici_sizes) for g in granules]).reshape(
        tuple(dcn_sizes) + tuple(ici_sizes))
    # (dcn_0..dcn_k, ici_0..ici_k) -> per-axis (dcn_i, ici_i) pairs, then
    # merge each pair: DCN-major within every named axis.
    perm = [x for i in range(k) for x in (i, k + i)]
    arr = arr.transpose(perm).reshape(tuple(d * i for d, i in zip(dcn_sizes, ici_sizes)))
    return tuple(names), arr


def make_hybrid_mesh(ici: MeshSpec, dcn: MeshSpec, *, device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the initialized default group with each axis
    ``dcn_factor x ici_factor``: ``ici`` shapes each host's ranks, ``dcn``
    spans hosts, DCN-major (see :func:`_hybrid_ranks`), so a collective over
    an axis placed on ``dcn`` crosses hosts while the others stay inside
    one.  A trivial ``dcn`` is :func:`~torchdistx_tpu_torch.parallel.mesh.
    make_mesh` of ``ici``.  ``device_type=None`` means ``"cuda"`` and raises
    without CUDA; ``"cpu"`` builds a gloo mesh.  Every rank must call it
    (finding the hosts may take a collective)."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = resolve_device(device_type).type
    if dcn.size == 1:
        return make_mesh(ici, device_type=device_type)
    if not _initialized():
        raise RuntimeError(
            "make_hybrid_mesh needs torch.distributed initialised "
            "(torch.distributed.init_process_group)"
        )
    world = dist.get_world_size()
    names, ranks = _hybrid_ranks(ici, dcn, _host_keys(world), device_type)
    return DeviceMesh(device_type, torch.as_tensor(ranks), mesh_dim_names=names)
