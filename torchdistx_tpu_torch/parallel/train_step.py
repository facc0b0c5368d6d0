"""The single-device Llama training step.

Counterpart of ``torchdistx_tpu/parallel/train_step.py`` (``TrainState`` and
``make_train_step``) on one device.  ``tx`` takes the place of the optax
transform: it builds a ``torch.optim.Optimizer`` over the model's
parameters.  The JAX step is a pure function of an immutable state; here
the model and the optimizer update in place (one copy of the weights and
moments in memory, which a 7B model on one 80 GB card needs), and
``step_fn`` returns a new :class:`TrainState` holding them with the new
step count.

The mesh arguments of the JAX ``make_train_step`` (``mesh``, ``tp``,
``fsdp``, ``seq_axis``, ``pp_axis``, ``n_microbatches``, ``pp_schedule``,
``seq_layout``) belong to the multi-device port and raise here when given.
Its ``loss_fn`` option has no counterpart yet: the step trains on
:meth:`Llama.loss`, whose attention is the flash kernel on CUDA tensors and
the plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .._device import resolve_device
from ..deferred_init import deferred_init, materialize_module
from ..models.llama import Llama
from ..resilience.guard import tree_allfinite

__all__ = ["TrainState", "make_train_step"]


class TrainState(NamedTuple):
    model: Llama
    optimizer: torch.optim.Optimizer
    step: int


# Mesh argument -> the value that means "not used".
_MESH_ARGS = {
    "mesh": None, "tp": None, "fsdp": None, "seq_axis": None, "pp_axis": None,
    "n_microbatches": 1, "pp_schedule": "gpipe", "seq_layout": "contiguous",
}


def make_train_step(
    cfg,
    tx: Callable[[Any], torch.optim.Optimizer],
    *,
    device: Optional[Any] = None,
    nonfinite_guard: bool = True,
    **mesh_args,
) -> Tuple[Callable, Callable]:
    """Build ``(init_fn, step_fn)`` for training a :class:`Llama` of ``cfg``
    on one device (``None``: CUDA; pass ``device="cpu"`` for the host).

    ``init_fn(seed) -> TrainState``: shard-then-materialize on one device.
    The model is recorded with ``deferred_init`` (no bytes allocated), then
    materialized on the device with its random values drawn from
    generators seeded by ``seed`` (the caller's RNG state is left as it
    was), so a seed gives the same parameters every time; then
    ``tx(model.parameters())`` and step 0.

    ``step_fn(state, batch) -> (state, metrics)``: ``batch`` is
    ``{"tokens": (B, S), "targets": (B, S)}``; ``metrics`` holds ``loss``
    (f32 scalar tensor of :meth:`Llama.loss`), ``step`` and, with the
    guard, ``nonfinite``.  The reserved batch key ``_tdx_nan`` poisons the
    loss with NaN where it is true, as in the JAX step, for fault injection.

    ``nonfinite_guard`` (default on): a step whose loss or any gradient is
    non-finite leaves the parameters, the optimizer's moments and the step
    count bit-identical and reports ``nonfinite=True`` (see
    :mod:`~torchdistx_tpu_torch.resilience.guard`).  The check is read on
    the host before ``optimizer.step()``, so the step synchronizes with
    the device once.
    """
    bad = {k: v for k, v in mesh_args.items() if k not in _MESH_ARGS}
    if bad:
        raise TypeError(f"make_train_step got unexpected arguments {sorted(bad)}")
    given = sorted(k for k, v in mesh_args.items() if v != _MESH_ARGS[k])
    if given:
        raise ValueError(
            f"make_train_step: {given} need the multi-device port; this step "
            "runs on one device"
        )
    device = resolve_device(device)

    def init_fn(seed: int) -> TrainState:
        model = deferred_init(Llama, cfg, device=device)
        cuda = [device] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda, device_type="cuda"):
            torch.manual_seed(seed)
            materialize_module(model, device=device)
        return TrainState(model, tx(model.parameters()), 0)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, dict]:
        model, opt = state.model, state.optimizer
        tokens = batch["tokens"].to(device)
        targets = batch["targets"].to(device)
        loss = model.loss(tokens, targets)
        if "_tdx_nan" in batch:
            poison = torch.as_tensor(batch["_tdx_nan"], device=loss.device)
            loss = torch.where(poison, torch.full_like(loss, float("nan")), loss)
        loss.backward()
        ok = True
        if nonfinite_guard:
            grads = [p.grad for p in model.parameters()]
            ok = bool(tree_allfinite(loss.detach(), grads))
        if ok:
            opt.step()
        opt.zero_grad(set_to_none=True)
        new_state = TrainState(model, opt, state.step + int(ok))
        metrics = {"loss": loss.detach(), "step": new_state.step}
        if nonfinite_guard:
            metrics["nonfinite"] = not ok
        return new_state, metrics

    return init_fn, step_fn
