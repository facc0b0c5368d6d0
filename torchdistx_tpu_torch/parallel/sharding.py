"""Sharding plans: parameter name/shape -> ``PartitionSpec``.

Counterpart of ``torchdistx_tpu/parallel/sharding.py``, with the same rules
on the same (Hugging Face) parameter names.  A *plan* is any
``(name, shape) -> PartitionSpec | None`` callable; the builders here
compose FSDP-style and Megatron-TP-style rules.  :class:`PartitionSpec` is
the port's own: one entry per tensor dim, each ``None`` (replicated), a mesh
axis name, or a tuple of names (the dim split over several axes).
:func:`~torchdistx_tpu_torch.materialize.materialize_module_torch` turns a
spec into ``DTensor`` placements on a ``DeviceMesh``.

The mesh rules take a ``DeviceMesh`` (its ``mesh_dim_names`` and shape) or a
:class:`~torchdistx_tpu_torch.parallel.mesh.MeshSpec`.  :func:`fit_shardings`
and :func:`spec_placements` turn specs into ``DTensor`` placements (the JAX
``fit_shardings`` gives ``NamedSharding``s); :func:`batch_sharding` gives a
rank its block of a global batch.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

from .mesh import MeshSpec

__all__ = [
    "PartitionSpec",
    "Plan",
    "StageSpec",
    "batch_sharding",
    "combine_plans",
    "fit_shardings",
    "fit_spec_to_mesh",
    "fsdp_over",
    "fsdp_plan",
    "replicate_indivisible",
    "replicated_plan",
    "spec_placements",
    "stage_mesh",
    "stage_of",
    "tp_plan_gpt2",
    "tp_plan_llama",
]


class PartitionSpec(tuple):
    """Per-tensor-dim mesh axes, as ``jax.sharding.PartitionSpec``: a spec
    shorter than the tensor's rank leaves the trailing dims replicated, and
    a one-name tuple entry is the name itself."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries
        ))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


Plan = Callable[[str, Tuple[int, ...]], Optional[PartitionSpec]]


class StageSpec(PartitionSpec):
    """The spec of one layer's parameter under pipeline parallelism: its
    entries place it over the mesh's other axes, and the ``pp`` axis gives
    the layer to one pipeline stage, the pp rank ``stage_of(layer,
    n_layers, mesh's pp size)``.  The JAX package stacks the layers and
    shards that stacked dim over ``pp`` (``P(pp, ...)``); here every layer
    has its own parameters, so the spec names its layer.  On a mesh
    without the ``pp`` axis it is its plain spec (every rank holds every
    layer, as fitting ``P(pp, ...)`` to such a mesh replicates the layer
    dim)."""

    def __new__(cls, *entries, pp: str = "pp", layer: int, n_layers: int):
        self = super().__new__(cls, *entries)
        self.pp, self.layer, self.n_layers = pp, layer, n_layers
        return self

    def __repr__(self):
        return (f"StageSpec{tuple.__repr__(self)}(pp={self.pp!r}, layer={self.layer}, "
                f"n_layers={self.n_layers})")


def stage_of(layer: int, n_layers: int, n_stages: int) -> int:
    """The pipeline stage that holds ``layer``: stage ``p`` holds the
    contiguous layers ``p * n_layers / n_stages`` up to the next stage's
    first (the JAX ``P(pp, ...)`` split of the stacked layer dim, which
    needs ``n_stages`` to divide ``n_layers``)."""
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} pipeline stages")
    return layer // (n_layers // n_stages)


def stage_mesh(mesh, axis: str):
    """``mesh`` without its ``axis`` dim: the mesh of one pipeline stage's
    ranks (this rank's), on which a stage's parameters are placed and its
    tensor- and data-parallel collectives run; None when ``axis`` is the
    mesh's only dim (a stage is one rank)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    rest = tuple(n for n in names if n != axis)
    return mesh[rest] if rest else None


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a ``MeshSpec``."""
    if isinstance(mesh, MeshSpec):
        return dict(mesh.axes())
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no dim names: build it with make_mesh")
    return dict(zip(names, mesh.shape))


def fit_spec_to_mesh(spec, mesh) -> PartitionSpec:
    """Drop axis names the mesh doesn't have (e.g. a tp rule on a dp-only
    mesh)."""
    names = set(mesh_axis_sizes(mesh))

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            return kept or None
        return entry if entry in names else None

    return PartitionSpec(*[keep(a) for a in spec])


def replicate_indivisible(spec, shape, mesh) -> PartitionSpec:
    """Replicate dims whose size isn't divisible by their assigned axis
    product (e.g. a 32000 vocab over tp=7): a sharded init value would be
    ill-defined.  Frameworks wanting sharded odd dims pad them instead."""
    sizes = mesh_axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    for dim, axes in enumerate(entries):
        if axes is None:
            fixed.append(None)
            continue
        axis_tuple = axes if isinstance(axes, tuple) else (axes,)
        size = 1
        for a in axis_tuple:
            size *= sizes[a]
        fixed.append(axes if shape[dim] % size == 0 else None)
    return PartitionSpec(*fixed)


def spec_placements(spec, mesh, ndim: int) -> list:
    """``DTensor`` placements of ``spec`` on ``mesh`` for a tensor of rank
    ``ndim``: mesh dim ``i`` is ``Shard(d)`` when its axis name is in entry
    ``d``, else ``Replicate()``.  A tuple entry must list its axes in the
    mesh's dim order (the earlier mesh dim the major one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axis_sizes(mesh))
    placements = [Replicate() for _ in names]
    for d, entry in enumerate(list(spec)[:ndim]):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(
                f"spec entry {entry!r} lists its axes out of the mesh's order "
                f"{tuple(names)}: DTensor cannot place it without strided sharding"
            )
        for i in dims:
            placements[i] = Shard(d)
    return placements


def fit_shardings(specs, shapes, mesh) -> Dict[str, list]:
    """``{name: placements}`` for ``{name: spec}`` and ``{name: shape}``:
    :func:`fit_spec_to_mesh`, then :func:`replicate_indivisible`, then
    :func:`spec_placements`, the rule of the JAX ``fit_shardings`` (and of
    :func:`~torchdistx_tpu_torch.materialize.materialize_module_torch`)."""
    out = {}
    for name, shape in shapes.items():
        spec = replicate_indivisible(fit_spec_to_mesh(specs[name], mesh), tuple(shape), mesh)
        out[name] = spec_placements(spec, mesh, len(shape))
    return out


def batch_sharding(mesh, *, data_axes: Sequence[str] = ("dp", "fsdp"),
                   seq_axis: Optional[str] = None):
    """This rank's block of a global batch: a function from a ``{"tokens",
    "targets", ...}`` batch of ``(B, S)`` tensors to this rank's rows (the
    batch dim split over ``data_axes``, the earlier mesh dim the major one,
    as ``Shard(0)`` places it) and, with ``seq_axis``, its columns (the
    sequence split over that axis).  Other keys pass through.  Counterpart
    of the JAX ``batch_sharding``'s ``P(data_axes, None)``; ``seq_axis`` is
    the sharding the JAX ring attention's ``shard_map`` gives the sequence.
    A batch or sequence that does not divide raises (as ``jax.device_put``
    does)."""
    sizes = mesh_axis_sizes(mesh)
    names = list(sizes)
    rows = [a for a in names if a in tuple(data_axes)]
    coord = mesh.get_coordinate() if rows or seq_axis else None
    if seq_axis is not None and seq_axis not in sizes:
        raise ValueError(f"mesh has no axis {seq_axis!r} (axes {tuple(names)})")

    def block(n, axes):
        parts, index = 1, 0
        for a in axes:
            i = names.index(a)
            parts *= sizes[a]
            index = index * sizes[a] + coord[i]
        return parts, index

    def shard(batch):
        out = dict(batch)
        for key in ("tokens", "targets"):
            if key not in batch:
                continue
            x = batch[key]
            for dim, axes in ((0, rows), (1, [seq_axis] if seq_axis else [])):
                parts, index = block(x.shape[dim], axes)
                if x.shape[dim] % parts:
                    raise ValueError(
                        f"batch {key!r} dim {dim} of size {x.shape[dim]} does not split "
                        f"over mesh axes {axes} ({parts} parts)")
                chunk = x.shape[dim] // parts
                x = x.narrow(dim, index * chunk, chunk)
            out[key] = x
        return out

    return shard


def replicated_plan() -> Plan:
    return lambda name, shape: PartitionSpec()


def fsdp_plan(
    axis: str = "fsdp",
    *,
    min_size: int = 1024,
    largest_dim: bool = True,
) -> Plan:
    """ZeRO-3-style parameter sharding: shard every big-enough param along
    one dimension of the ``axis`` mesh axis.

    ``largest_dim=True`` shards the largest dimension (best balance and the
    dimension most likely divisible by the axis size); otherwise dim 0.
    Params smaller than ``min_size`` elements stay replicated (the classic
    FSDP small-tensor exemption).
    """

    def plan(name: str, shape: Tuple[int, ...]):
        n = 1
        for s in shape:
            n *= s
        if not shape or n < min_size:
            return PartitionSpec()
        dim = max(range(len(shape)), key=lambda i: shape[i]) if largest_dim else 0
        spec = [None] * len(shape)
        spec[dim] = axis
        return PartitionSpec(*spec)

    return plan


def _regex_plan(rules: Iterable[Tuple[str, Sequence[Optional[str]]]]) -> Plan:
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def plan(name: str, shape: Tuple[int, ...]):
        for pat, spec in compiled:
            if pat.search(name):
                # A spec shorter than the rank leaves the rest replicated.
                return PartitionSpec(*list(spec)[: len(shape)])
        return None

    return plan


def tp_plan_gpt2(axis: str = "tp") -> Plan:
    """Megatron-style TP rules for GPT-2-family (HF naming, Conv1D weights
    are (in, out)): column-parallel QKV/MLP-up on the out dim, row-parallel
    proj/MLP-down on the in dim, embeddings on vocab/model dim."""
    return _regex_plan(
        [
            (r"c_attn\.weight$", (None, axis)),
            (r"c_attn\.bias$", (axis,)),
            (r"c_fc\.weight$", (None, axis)),
            (r"c_fc\.bias$", (axis,)),
            (r"c_proj\.weight$", (axis, None)),
            (r"c_proj\.bias$", ()),
            (r"(wte|lm_head)\.weight$", (axis, None)),
            (r"wpe\.weight$", ()),
            (r"ln_\w*\.(weight|bias)$", ()),
        ]
    )


def tp_plan_llama(axis: str = "tp") -> Plan:
    """Megatron-style TP rules for Llama-family (HF naming, Linear weights
    are (out, in)): column-parallel q/k/v/gate/up on dim 0, row-parallel
    o/down on dim 1, vocab-parallel embeddings."""
    return _regex_plan(
        [
            (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$", (axis, None)),
            (r"(o_proj|down_proj)\.weight$", (None, axis)),
            (r"(embed_tokens|lm_head)\.weight$", (axis, None)),
            (r"norm\.weight$", ()),
        ]
    )


def fsdp_over(base: Plan, axis: str = "fsdp", *, min_size: int = 1024) -> Plan:
    """2-D sharding: apply ``base`` (e.g. a TP plan), then additionally shard
    the largest still-unsharded dimension along ``axis``."""

    def plan(name: str, shape: Tuple[int, ...]):
        spec = base(name, shape)
        entries = list(spec) if spec is not None else []
        entries += [None] * (len(shape) - len(entries))
        n = 1
        for s in shape:
            n *= s
        if n >= min_size:
            free = [i for i, e in enumerate(entries) if e is None]
            if free:
                dim = max(free, key=lambda i: shape[i])
                entries[dim] = axis
        return PartitionSpec(*entries)

    return plan


def combine_plans(*plans: Plan) -> Plan:
    """First plan returning a non-None spec wins; else replicated.

    An explicit empty ``PartitionSpec()`` *is* a match ("replicate this
    param") and stops the search — e.g. a TP rule replicating a norm weight
    must not be overridden by a later FSDP catch-all.  For genuine 2-D
    sharding (FSDP over the dims TP left free) use :func:`fsdp_over`.
    """

    def plan(name: str, shape: Tuple[int, ...]):
        for p in plans:
            spec = p(name, shape)
            if spec is not None:
                return spec
        return PartitionSpec()

    return plan
