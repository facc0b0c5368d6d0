"""SlowMo (Slow Momentum): communication-efficient data-parallel training.

Counterpart of ``torchdistx_tpu/parallel/slowmo.py`` (after the reference's
``slowmo_comm.py`` / ``slowmo_optimizer.py``; arXiv:1910.00643).  Each rank
is one replica: it takes local steps of a base optimizer, and every
``slowmo_freq`` steps the replicas are averaged exactly over a process
group and a slow-momentum update is applied:

    m    <- slowmo_factor * m + (prev - avg) / base_lr
    prev <- prev - slowmo_lr * base_lr * m
    param <- prev                                   (on averaging steps)

Where the JAX package stacks the replicas on a leading ``dp`` axis and
averages with a ``mean`` over it, the port's replicas are processes and
``avg`` is an ``all_reduce`` over ``group``.  The JAX optimizer is a pure
``init`` / ``update`` pair over a :class:`SlowMoState`; here
:class:`SlowMomentumOptimizer` is a ``torch.optim.Optimizer`` whose
``step()`` updates the parameters in place, and ``prev`` and ``momentum``
are its per-parameter state.  A replica sharded over ranks (``DTensor``
parameters, ``tp`` / ``fsdp`` within it) averages each rank's local shard
over ``group``, whose ranks hold the same shard of every replica, and keeps
``prev`` and ``momentum`` per shard.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple

import torch
import torch.distributed as dist

__all__ = [
    "SlowMoState",
    "SlowMomentumOptimizer",
    "slowmo_grad_sync",
    "slowmo_state_dict",
    "load_slowmo_state_dict",
]


class SlowMoState(NamedTuple):
    """The JAX package's state, as a view of a :class:`SlowMomentumOptimizer`
    (:attr:`SlowMomentumOptimizer.slowmo_state`): ``base`` is the base
    optimizer's ``state``, ``prev`` and ``momentum`` list the buffers in
    parameter order (empty before the first step), ``step`` counts steps."""

    base: Any
    prev: List[torch.Tensor]
    momentum: List[torch.Tensor]
    step: int


def _group_or_default(group):
    """``group``; with none, the default group if one is initialized, else
    None (one replica)."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _local(p: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` parameter's local shard (a view), a plain one as it
    is."""
    return p.to_local() if hasattr(p, "to_local") else p


def _group_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over ``group``, as a new tensor of ``t``'s dtype:
    summed in float32 (gloo has no ``AVG``; the JAX mean accumulates bf16 in
    float32 too), divided, and rounded once.  The collective runs whenever
    there is a group, even of size 1."""
    acc = t.detach().to(torch.float32, copy=True)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc.div_(dist.get_world_size(group)).to(t.dtype)


def slowmo_grad_sync(params_or_grads, group=None, *, enabled: bool = True):
    """The all-mean of gradients over an intra group: the counterpart of the
    reference's ``slowmo_hook`` (slowmo_comm.py), which the JAX package
    writes as a ``pmean`` over a named axis.

    Each item is a gradient tensor, averaged in place, or a parameter, whose
    ``.grad`` is (a parameter with no gradient is skipped).  ``group=None``
    means the default group; with no initialized group, or ``enabled=False``,
    nothing changes.  Returns ``params_or_grads``.
    """
    group = _group_or_default(group)
    if not enabled or group is None:
        return params_or_grads
    grads = [t.grad if isinstance(t, torch.nn.Parameter) else t for t in params_or_grads]
    with torch.no_grad():
        for g in grads:  # one tensor at a time: one float32 copy in flight
            if g is not None:
                g.copy_(_group_mean(g, group))
    return params_or_grads


class SlowMomentumOptimizer(torch.optim.Optimizer):
    """Wraps a ``torch.optim.Optimizer`` with the SlowMo algorithm.

    Counterpart of the JAX ``SlowMomentumOptimizer``, with the same
    hyperparameters, validation and update math::

        base = torch.optim.SGD(model.parameters(), lr=0.1)
        opt = SlowMomentumOptimizer(base, base_lr=0.1, slowmo_freq=48,
                                    slowmo_factor=0.5, slowmo_lr=1.0)
        loss.backward(); opt.step(); opt.zero_grad()

    ``step()`` runs the base step, then counts it; steps ``slowmo_freq``,
    ``2 * slowmo_freq``, ... average the parameters over ``group`` (one
    replica per rank; ``None``: the default group if one is initialized,
    else one replica, whose mean is the parameter itself) and apply the slow
    momentum.  As in the JAX package, and unlike the reference's
    ``PeriodicModelAverager``, step 0 does not average.  ``prev`` (the
    parameters as the first step found them) and ``momentum`` (zeros) are
    made at the first step, in the parameter's dtype, as optimizers make
    their state.  The parameter groups are the base optimizer's.
    """

    def __init__(
        self,
        base: torch.optim.Optimizer,
        *,
        base_lr: float,
        slowmo_freq: int = 48,
        slowmo_factor: float = 0.5,
        slowmo_lr: float = 1.0,
        group=None,
    ):
        # Same ctor validation as the reference (slowmo_optimizer.py:96-115).
        if slowmo_freq < 1:
            raise ValueError(
                "Invalid ``slowmo_freq`` parameter, must be at least 1"
            )
        if slowmo_factor < 0.0:
            raise ValueError(
                "Invalid ``slowmo_factor`` parameter, must be non-negative"
            )
        if slowmo_lr < 0.0:
            raise ValueError(
                "Invalid ``slowmo_lr`` parameter, must be non-negative"
            )
        if base_lr <= 0.0:
            raise ValueError("Invalid ``base_lr`` parameter, must be positive")
        super().__init__(base.param_groups, {})
        self.param_groups = base.param_groups
        self.base = base
        self.base_lr = float(base_lr)
        self.slowmo_freq = int(slowmo_freq)
        self.slowmo_factor = float(slowmo_factor)
        self.slowmo_lr = float(slowmo_lr)
        self.group = group
        self.slowmo_step = 0

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @property
    def slowmo_state(self) -> SlowMoState:
        params = [p for p in self._params() if p in self.state]
        return SlowMoState(self.base.state, [self.state[p]["prev"] for p in params],
                           [self.state[p]["momentum"] for p in params], self.slowmo_step)

    @torch.no_grad()
    def step(self, closure=None):
        params = self._params()
        for p in params:
            if p not in self.state:
                local = _local(p)
                self.state[p] = {"prev": local.detach().clone(),
                                 "momentum": torch.zeros_like(local)}
        loss = self.base.step(closure)
        self.slowmo_step += 1
        if self.slowmo_step % self.slowmo_freq == 0:
            self._average(params)
        return loss

    def _average(self, params) -> None:
        group = _group_or_default(self.group)
        for p in params:  # one parameter at a time: one float32 copy in flight
            local = _local(p)  # a view of the parameter's own shard
            # One replica: the mean is the parameter itself.
            avg = local if group is None else _group_mean(local, group)
            state = self.state[p]
            prev, m = state["prev"], state["momentum"]
            m.mul_(self.slowmo_factor).add_((prev - avg).div_(self.base_lr))
            prev.sub_(m, alpha=self.slowmo_lr * self.base_lr)
            local.copy_(prev)

    # -- checkpointing ------------------------------------------------------
    # The reference's contract (slowmo_optimizer.py:156-189): the
    # hyperparameters travel with the buffers and are validated on load.

    def state_dict(self) -> dict:
        return slowmo_state_dict(self)

    def load_state_dict(self, state_dict: dict) -> None:
        load_slowmo_state_dict(self, state_dict)


def slowmo_state_dict(opt: SlowMomentumOptimizer) -> dict:
    """``{"state": {"base", "prev", "momentum", "step"}, "slowmo_freq",
    "slowmo_factor", "slowmo_lr", "base_lr", "step"}``: the base optimizer's
    state dict, the buffers in parameter order, and the hyperparameters.
    Tensors, lists and Python scalars only, so it saves with ``torch.save``
    and loads with ``weights_only=True``."""
    view = opt.slowmo_state
    return {
        "state": {"base": opt.base.state_dict(), "prev": list(view.prev),
                  "momentum": list(view.momentum), "step": view.step},
        "slowmo_freq": opt.slowmo_freq,
        "slowmo_factor": opt.slowmo_factor,
        "slowmo_lr": opt.slowmo_lr,
        "base_lr": opt.base_lr,
        "step": view.step,
    }


def load_slowmo_state_dict(opt: SlowMomentumOptimizer, d: dict) -> None:
    """Restore a SlowMo state dict into ``opt`` in place: the base
    optimizer's state, ``prev`` and ``momentum`` (copied into each
    parameter's device and dtype) and the step.

    .. warning:: Overwrites ``opt``'s hyperparameters (the loaded
       ``slowmo_freq/factor/lr/base_lr`` replace the constructor's), as the
       reference's ``load_state_dict`` does.
    """
    # Validation parity with slowmo_optimizer.py:180-189.
    for key in ("slowmo_freq", "slowmo_factor", "slowmo_lr", "base_lr"):
        if key not in d:
            raise ValueError(
                f"SlowMo state dict is missing required entry '{key}'."
            )
    state = d["state"]
    params = opt._params()
    if state["prev"] and len(state["prev"]) != len(params):
        raise ValueError(
            f"SlowMo state dict holds {len(state['prev'])} buffers for "
            f"{len(params)} parameters"
        )
    opt.slowmo_freq = int(d["slowmo_freq"])
    opt.slowmo_factor = float(d["slowmo_factor"])
    opt.slowmo_lr = float(d["slowmo_lr"])
    opt.base_lr = float(d["base_lr"])
    opt.base.load_state_dict(state["base"])
    opt.state.clear()
    for p, prev, m in zip(params, state["prev"], state["momentum"]):
        opt.state[p] = {
            "prev": prev.to(device=p.device, dtype=p.dtype, copy=True),
            "momentum": m.to(device=p.device, dtype=p.dtype, copy=True),
        }
    opt.slowmo_step = int(state["step"])
