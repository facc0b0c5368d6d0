"""The training steps: the single-device step and the SlowMo step.

Counterpart of ``torchdistx_tpu/parallel/train_step.py`` (``TrainState``,
``make_train_step`` on one device, and :func:`make_slowmo_train_step`, whose
replicas are processes, one device each).  ``tx`` takes the place of the
optax transform: it builds a ``torch.optim.Optimizer`` over the model's
parameters.  The JAX step is a pure function of an immutable state; here
the model and the optimizer update in place (one copy of the weights and
moments in memory, which a 7B model on one 80 GB card needs), and
``step_fn`` returns a new :class:`TrainState` holding them with the new
step count.

``model=`` picks the model family as in the JAX steps: the port's
``models.llama`` (the default), ``models.gpt2`` or ``models.moe`` module.

With ``mesh=`` (a ``DeviceMesh`` of :func:`~torchdistx_tpu_torch.parallel.
mesh.make_mesh`) the step is the JAX dp/fsdp/tp/sp step: ``init_fn`` shards
then materializes (each rank holds the ``DTensor`` shards that the family's
``param_specs(cfg)`` give it, fitted to the mesh), the
optimizer's moments take each parameter's own placement, and ``step_fn``
takes the global batch on every rank; each rank computes its block (see
:mod:`~torchdistx_tpu_torch.parallel.spmd`).  With ``pp_axis`` the step is
pipeline-parallel over that mesh axis (:mod:`~torchdistx_tpu_torch.
parallel.pipeline`): each rank holds and materializes its stage's layers
only (plus the embedding and head, whole over ``pp``), placed on the mesh
without ``pp``, and ``pp_schedule`` is ``"gpipe"`` (the model's ``loss``
through the GPipe pipeline, with ``seq_axis`` the ring inside each stage)
or ``"1f1b"`` (the family's ``pp_value_and_grad``).  An ``ep`` axis holds
the MoE experts (:func:`~torchdistx_tpu_torch.models.moe.moe_ffn_ep`);
``tp`` / ``fsdp`` name the mesh axes of those roles, as in JAX.  The step
trains on the model's ``loss``, or on a custom ``loss_fn``, whose
attention is the flash kernel on CUDA tensors (on each rank's heads and
rows under a mesh, ring attention with ``seq_axis``) and the plain version
on CPU tensors.

The JAX SlowMo step keeps the replicas as a stacked leading ``dp`` axis and
vmaps the loss over it; here a replica is the ranks that share a ``dp``
coordinate (one rank, or a ``tp`` / ``fsdp`` mesh of them), trains on its
own row of the ``(dp, B, S)`` batch, and the averaging is a collective over
the mesh's ``dp`` group (see :mod:`~torchdistx_tpu_torch.parallel.slowmo`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .._device import resolve_device
from ..deferred_init import deferred_init, materialize_module
from ..models import gpt2, llama, moe
from ..resilience.guard import tree_allfinite
from .distributed import any_flags
from .sharding import batch_sharding, stage_mesh
from .slowmo import SlowMomentumOptimizer, _group_or_default, _local
from .spmd import replicated

__all__ = ["TrainState", "batch_sharding", "make_slowmo_train_step", "make_train_step",
           "slowmo_batch_sharding"]


class TrainState(NamedTuple):
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int


# Model family module -> its module class.
_FAMILIES = {llama: llama.Llama, gpt2: gpt2.GPT2, moe: moe.MoE}


def _model_class(model) -> type:
    """The module class of the family ``model`` (``None``: Llama)."""
    cls = _FAMILIES.get(llama if model is None else model)
    if cls is None:
        raise TypeError("model must be a model family (models.llama, models.gpt2 or "
                        f"models.moe), not {model!r}")
    return cls


def _check_mesh_args(mesh, tp, fsdp, seq_axis, seq_layout, pp_axis, n_microbatches,
                     pp_schedule, loss_fn, family):
    """The JAX ``make_train_step``'s checks of its custom loss and pipeline
    arguments (and its messages), then the arguments that name mesh axes
    without a mesh raise."""
    if loss_fn is not None and seq_layout != "contiguous":
        # The layout is applied inside the model's own loss (token
        # permutation + target alignment); it cannot be injected into a
        # user-provided loss, so silently ignoring it would train on a
        # contiguous layout the caller did not ask for.
        raise ValueError(
            f"seq_layout={seq_layout!r} cannot be combined with a custom "
            "loss_fn — apply the layout inside your loss_fn and pass "
            "seq_layout='contiguous'.")
    if pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pp_schedule: {pp_schedule!r}")
    if pp_schedule == "1f1b":
        if pp_axis is None:
            raise ValueError("pp_schedule='1f1b' requires pp_axis=")
        if loss_fn is not None:
            raise ValueError("pp_schedule='1f1b' computes the loss inside the pipeline "
                             "and cannot wrap a custom loss_fn")
        if seq_axis is not None or seq_layout != "contiguous":
            raise ValueError("pp_schedule='1f1b' does not compose with seq_axis/"
                             "seq_layout — use pp_schedule='gpipe' for sp×pp")
        if not hasattr(family, "pp_value_and_grad"):
            raise ValueError(f"pp_schedule='1f1b' requires {family.__name__} to expose "
                             "pp_value_and_grad (see models.llama / models.gpt2)")
    if pp_axis is None and n_microbatches != 1:
        raise ValueError(f"make_train_step: n_microbatches={n_microbatches!r} splits a "
                         "pipeline's batch; pass pp_axis=")
    if mesh is None:
        given = [f"{k}={v!r}" for k, v, d in (("tp", tp, "tp"), ("fsdp", fsdp, "fsdp"),
                                              ("seq_axis", seq_axis, None),
                                              ("seq_layout", seq_layout, "contiguous"),
                                              ("pp_axis", pp_axis, None))
                 if v != d]
        if given:
            raise ValueError(f"make_train_step: {', '.join(given)} name or lay out mesh "
                             "axes; pass mesh=")
        return
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise ValueError(f"make_train_step: mesh must be a DeviceMesh with named dims "
                         f"(parallel.make_mesh), not {mesh!r}")
    if pp_axis is not None and pp_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {pp_axis!r} (axes: {tuple(mesh.mesh_dim_names)})")


def _drop_other_stages(net: nn.Module) -> None:
    """The parameters left fake after a stage-only materialize (the other
    pipeline stages' layers) replaced by ``meta`` parameters of their
    shapes: held by no rank here, read by nothing."""
    from ..deferred_init import is_deferred

    for mod in net.modules():
        for key, t in list(mod._parameters.items()):
            if t is not None and is_deferred(t):
                mod._parameters[key] = nn.Parameter(
                    torch.empty(t.shape, dtype=t.dtype, device="meta"),
                    requires_grad=t.requires_grad)


def _mesh_device(mesh, device) -> torch.device:
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's {mesh.device_type}")
    return dev


def make_train_step(
    cfg,
    tx: Callable[[Any], torch.optim.Optimizer],
    *,
    model=None,
    device: Optional[Any] = None,
    nonfinite_guard: bool = True,
    mesh=None,
    tp: Optional[str] = "tp",
    fsdp: Optional[str] = "fsdp",
    seq_axis: Optional[str] = None,
    seq_layout: str = "contiguous",
    attn_impl: str = "auto",
    pp_axis: Optional[str] = None,
    n_microbatches: int = 1,
    pp_schedule: str = "gpipe",
    loss_fn: Optional[Callable] = None,
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for training a model of ``cfg``: on one
    device (``None``: CUDA; pass ``device="cpu"`` for the host), or with
    ``mesh`` on every rank of a mesh.  ``model`` is the family (default
    Llama; see the module docstring).

    ``init_fn(seed) -> TrainState``: shard-then-materialize.  The model is
    recorded with ``deferred_init`` (no bytes allocated), then its values
    are drawn from generators seeded by ``seed`` (the caller's RNG state is
    left as it was), so a seed gives the same parameters every time: on one
    device by ``materialize_module`` in place; on a mesh by
    ``materialize_module_torch(seed=, mesh=, plan=param_specs(cfg))``,
    each rank keeping its ``DTensor`` shards (no rank holds a
    whole parameter beyond the one being replayed), loaded by assignment.
    Then ``tx(model.parameters())`` and step 0.

    ``step_fn(state, batch) -> (state, metrics)``: ``batch`` is the global
    ``{"tokens": (B, S), "targets": (B, S)}`` (on a mesh the same on every
    rank; each rank takes its rows over ``dp`` and the ``fsdp`` axis and,
    with ``seq_axis``, its columns); ``metrics`` holds ``loss`` (f32 scalar
    tensor, the global batch's mean, on every rank), ``step`` and, with the
    guard, ``nonfinite``.  The reserved batch key ``_tdx_nan`` poisons the
    loss with NaN where it is true, as in the JAX step, for fault
    injection.  ``attn_impl`` and ``seq_layout`` as in the model's
    ``loss``.

    ``tp`` / ``fsdp`` (a mesh axis name, or ``None`` for none) are the axes
    that the family's ``param_specs`` place parameters over and that the
    step computes tensor-parallel over and splits the batch over (with
    ``dp``), as the JAX step's; an axis of another name replicates the
    compute.

    ``loss_fn(model, tokens, targets, **kw) -> f32 scalar``, the
    counterpart of the JAX ``loss_fn(params, tokens, targets)``, replaces
    the model's ``loss``.  ``kw`` holds the step's own loss keywords:
    ``attn_impl``; on a mesh ``mesh`` and ``seq_axis``, ``tp`` / ``fsdp``
    when they are not the default names, and under ``pp_axis`` (GPipe)
    ``pp_axis`` and ``n_microbatches``, so that a loss written on the
    model's own ``forward`` / ``loss`` (``model.loss(tokens, targets,
    **kw)``) runs as the step's does.  ``tokens`` and ``targets`` are the
    global batch on every rank.  On a mesh the model's ``forward`` returns
    a ``DTensor``, so a loss written in torch ops on its logits reduces
    globally by ``DTensor``'s rules (put ``targets`` beside them with
    ``distribute_tensor(targets, logits.device_mesh, logits.placements,
    src_data_rank=None)``); a ``DTensor`` result is reduced over its
    ``Partial`` mesh dims by c10d collectives
    (:func:`~torchdistx_tpu_torch.parallel.spmd.replicated`).  As in JAX,
    a custom loss does not take ``seq_layout`` (raises) nor the 1F1B
    schedule; with ``pp_axis`` the JAX step calls it unpipelined, and MoE's
    routing is then the whole batch's there and per microbatch here.

    ``nonfinite_guard`` (default on): a step whose loss or any gradient is
    non-finite leaves the parameters, the optimizer's moments and the step
    count bit-identical and reports ``nonfinite=True`` (see
    :mod:`~torchdistx_tpu_torch.resilience.guard`).  The check is read on
    the host before ``optimizer.step()``, so the step synchronizes with
    the device once; on a mesh the ranks agree on it in one all-reduce, so
    a NaN on one rank skips the step on all.
    """
    cls = _model_class(model)
    family = llama if model is None else model
    _check_mesh_args(mesh, tp, fsdp, seq_axis, seq_layout, pp_axis, n_microbatches,
                     pp_schedule, loss_fn, family)
    device = resolve_device(device) if mesh is None else _mesh_device(mesh, device)
    axes = {k: v for k, v in (("tp", tp), ("fsdp", fsdp)) if v != k}
    loss_kw = {"attn_impl": attn_impl}
    if mesh is not None:
        loss_kw.update(mesh=mesh, seq_axis=seq_axis, **axes)
    if seq_layout != "contiguous":
        loss_kw["seq_layout"] = seq_layout
    if pp_axis is not None:
        loss_kw.update(pp_axis=pp_axis, n_microbatches=n_microbatches)

    def init_fn(seed: int) -> TrainState:
        net = deferred_init(cls, cfg, device=device)
        if mesh is None:
            cuda = [device] if device.type == "cuda" else []
            with torch.random.fork_rng(devices=cuda, device_type="cuda"):
                torch.manual_seed(seed)
                materialize_module(net, device=device)
        else:
            from ..materialize import materialize_module_torch

            plan = family.param_specs(cfg, tp=tp, fsdp=fsdp,
                                      **({} if pp_axis is None else {"pp": pp_axis}))
            net.load_state_dict(materialize_module_torch(net, mesh=mesh, plan=plan,
                                                         seed=seed),
                                assign=True, strict=pp_axis is None)
            if pp_axis is not None:
                _drop_other_stages(net)
        return TrainState(net, tx([p for p in net.parameters() if not p.is_meta]), 0)

    def poisoned(loss, batch):
        if "_tdx_nan" not in batch:
            return loss
        poison = torch.as_tensor(batch["_tdx_nan"], device=loss.device)
        return torch.where(poison, torch.full_like(loss, float("nan")), loss)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, dict]:
        model, opt = state.model, state.optimizer
        tokens = batch["tokens"].to(device)
        targets = batch["targets"].to(device)
        if pp_schedule == "1f1b":
            loss, grads = family.pp_value_and_grad(
                model, tokens, targets, mesh=mesh, pp_axis=pp_axis,
                n_microbatches=n_microbatches, attn_impl=attn_impl, **axes)
            for name, p in model.named_parameters():
                if name in grads:
                    p.grad = grads[name]
            loss = poisoned(loss, batch)
        else:
            if loss_fn is None:
                loss = model.loss(tokens, targets, **loss_kw)
            else:
                loss = replicated(loss_fn(model, tokens, targets, **loss_kw))
            loss = poisoned(loss, batch)
            loss.backward()
            loss = loss.detach()
        ok = True
        if nonfinite_guard:
            grads = [_local(p.grad) for p in model.parameters() if p.grad is not None]
            ok = bool(tree_allfinite(loss.detach(), grads))
            if mesh is not None:
                ok = not any_flags([not ok])[0]
        if ok:
            opt.step()
        opt.zero_grad(set_to_none=True)
        new_state = TrainState(model, opt, state.step + int(ok))
        metrics = {"loss": loss, "step": new_state.step}
        if nonfinite_guard:
            metrics["nonfinite"] = not ok
        return new_state, metrics

    return init_fn, step_fn


# ---------------------------------------------------------------------------
# SlowMo training step (replicas averaged over the dp group)


def _replicas(mesh, dp_axis: str):
    """``(group, size, index, replica)`` of this rank's replica: the mesh's
    ``dp_axis`` group, its size and this rank's coordinate on it, and the
    replica's mesh (the mesh without ``dp_axis``, whose ranks share this
    rank's ``dp`` coordinate), or None when a replica is this rank alone
    (no other axis of size > 1).  With ``mesh=None``: the default group's
    world, one rank a replica, or one replica (no group) when none is
    initialized."""
    if mesh is None:
        group = _group_or_default(None)
        if group is None:
            return None, 1, 0, None
        return group, dist.get_world_size(group), dist.get_rank(group), None
    names = mesh.mesh_dim_names or ()
    if dp_axis not in names:
        raise ValueError(f"make_slowmo_train_step: the mesh has no {dp_axis!r} axis "
                         f"(axes {tuple(names)})")
    split = any(mesh.size(i) > 1 for i, n in enumerate(names) if n != dp_axis)
    replica = stage_mesh(mesh, dp_axis) if split else None
    return (mesh.get_group(dp_axis), mesh.size(names.index(dp_axis)),
            mesh.get_local_rank(dp_axis), replica)


def _replica_rows(mesh, dp_axis):
    """A function from a ``(dp, B, S)`` batch to this rank's replica's
    ``(B, S)`` row."""
    _, size, index, _ = _replicas(mesh, dp_axis)

    def rows(batch):
        out = {}
        for key in ("tokens", "targets"):
            x = batch[key]
            if x.dim() != 3 or x.shape[0] != size:
                raise ValueError(f"SlowMo batch {key!r} must be (dp={size}, B, S), "
                                 f"not {tuple(x.shape)}")
            out[key] = x[index]
        return out

    return rows


def slowmo_batch_sharding(mesh, *, dp_axis: str = "dp", data_axes=("fsdp",)):
    """The placement of a SlowMo batch: a function from a ``{"tokens",
    "targets"}`` batch of shape ``(dp, B, S)`` to this rank's block: the
    row of its ``dp_axis`` coordinate (``mesh=None``: its rank in the
    default group), then its rows of that over ``data_axes`` within the
    replica.  Counterpart of the JAX ``slowmo_batch_sharding``, whose
    ``P(dp_axis, data_axes, None)`` puts row ``i`` on the replica at
    coordinate ``i`` and splits it over the data axes."""
    rows = _replica_rows(mesh, dp_axis)
    replica = _replicas(mesh, dp_axis)[3]
    if replica is None:
        return rows
    within = batch_sharding(replica, data_axes=data_axes)
    return lambda batch: within(rows(batch))


def make_slowmo_train_step(
    cfg,
    mesh,
    opt: Callable[[Any], SlowMomentumOptimizer],
    *,
    model=None,
    dp_axis: str = "dp",
    tp: Optional[str] = "tp",
    fsdp: Optional[str] = "fsdp",
    attn_impl: str = "auto",
    device: Optional[Any] = None,
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for SlowMo training of a model of
    ``cfg``; ``model`` is the family, as in :func:`make_train_step`.

    ``mesh`` is a ``DeviceMesh`` (:func:`~torchdistx_tpu_torch.parallel.mesh.
    make_mesh`, :func:`~torchdistx_tpu_torch.parallel.distributed.
    make_hybrid_mesh`) whose ``dp_axis`` group is the averaging group, or
    None for the default group's world (one rank a replica; one replica
    with no group).  A replica is the ranks that share a ``dp``
    coordinate: this rank alone when the mesh's other axes have size 1,
    else the mesh without ``dp_axis``, on which the replica's model is
    placed as ``DTensor`` shards by the family's ``param_specs`` (``tp`` /
    ``fsdp`` name its axes, as in :func:`make_train_step`; within a
    replica they shard as usual) and steps as ``make_train_step(mesh=)``
    does.  ``opt`` builds the optimizer from the model's parameters, like
    ``make_train_step``'s ``tx``, and must return a
    :class:`SlowMomentumOptimizer`; one built with ``group=None`` averages
    over the mesh's ``dp`` group, each rank its local shards.
    ``device=None`` means CUDA (the mesh's device with a replica mesh).

    ``init_fn(seed) -> TrainState``: the model recorded with
    ``deferred_init`` and materialized from ``seed`` (the same values on
    every replica, so the replicas start equal), then ``opt(parameters)``.

    ``step_fn(state, batch) -> (state, metrics)``: ``batch`` holds
    ``"tokens"`` and ``"targets"`` of shape ``(dp, B, S)`` on every rank;
    each replica trains on the row of its ``dp`` coordinate (its ranks
    split it as ``make_train_step``'s do).  ``metrics["loss"]`` is the
    mean of the replicas' losses (one scalar all-reduce, queued without a
    host sync), ``metrics["step"]`` the step count.  ``attn_impl="auto"``
    is the flash kernels on CUDA and the plain attention on the CPU:
    unlike the JAX step, whose loss is vmapped over stacked replicas and
    takes XLA's attention, nothing here is vmapped.
    """
    group, _, _, replica = _replicas(mesh, dp_axis)
    rows = _replica_rows(mesh, dp_axis)
    step_kw = dict(model=model, attn_impl=attn_impl, nonfinite_guard=False)
    if replica is None:
        init_model, replica_step = make_train_step(cfg, opt, device=resolve_device(device),
                                                   **step_kw)
    else:
        init_model, replica_step = make_train_step(cfg, opt, device=device, mesh=replica,
                                                   tp=tp, fsdp=fsdp, **step_kw)

    def init_fn(seed: int) -> TrainState:
        state = init_model(seed)
        if not isinstance(state.optimizer, SlowMomentumOptimizer):
            raise TypeError(
                "make_slowmo_train_step: opt must build a SlowMomentumOptimizer, "
                f"not {type(state.optimizer).__name__}"
            )
        if state.optimizer.group is None:
            state.optimizer.group = group
        return state

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, dict]:
        state, metrics = replica_step(state, rows(batch))
        mean = metrics["loss"].clone()
        if group is not None:
            dist.all_reduce(mean, op=dist.ReduceOp.SUM, group=group)
            mean.div_(dist.get_world_size(group))
        return state, {"loss": mean, "step": state.step}

    return init_fn, step_fn
