"""Pipeline parallelism: the GPipe and 1F1B schedules over a ``pp`` mesh axis.

Counterpart of ``torchdistx_tpu/parallel/pipeline.py``.  The layers split
into ``P`` contiguous *stages*, one per rank of the ``pp`` axis (layer ``i``
on stage ``i // (n_layers / P)``, :func:`stage_blocks`); the batch splits
into ``M`` microbatches; activations hop one stage up a tick and their
cotangents one stage down.  Every other mesh axis (dp/fsdp/tp) works inside
a stage as it does without a pipeline: a stage's parameters are placed on
the stage's mesh (the mesh without ``pp``) and its collectives run over
that mesh's groups, whose ranks all belong to the stage, so they take the
same branch of every tick.

A hop is the ring's :class:`~torchdistx_tpu_torch.parallel.spmd._Hop`, one
``all_to_all_single`` over the ``pp`` group (gloo's point-to-point ops
abort or hang on CUDA tensors; ``torch.distributed.pipelining`` is built on
them).  Every rank hops on every tick but the last, also when its stage
did nothing (zeros then), so that every rank of the group issues the same
collectives in the same order.

- :func:`pipeline_forward` (GPipe): ``M + P - 1`` ticks; at tick ``t``
  stage ``p`` runs microbatch ``t - p`` when ``0 <= t - p < M`` and passes
  its input through otherwise, with no stage compute (the JAX ``lax.cond``
  identity branch).  The backward is an explicit transposed schedule, not
  the autograd engine's order: the ticks in reverse, each valid one
  recomputing its stage from the stashed input and back-propagating the
  cotangent that came down, the cotangents hopping down between ticks.
  The engine may run independent branches of a graph in any order, and a
  hop's transpose is a collective that every rank of the group must issue
  in the same order; here the order is the loop's.  The stage's parameter
  gradients accumulate into their ``.grad`` (as ``loss.backward()`` does),
  the input's gradient is what the function returns.
- :func:`pipeline_value_and_grad` (1F1B): the JAX schedule tick for tick
  (:func:`schedule_1f1b`): a forward slot and a backward slot a tick, the
  backward slot recomputing the stage from the stashed input (full remat)
  under ``torch.enable_grad()`` and transposing it with
  ``torch.autograd.grad``; the embedding on stage 0 and the loss head in
  the last stage, per microbatch; a ring buffer of ``3P // 2 + 1``
  activations; f32 gradient accumulators cast back to the parameters'
  dtypes; the loss the mean over microbatches, and the gradients of the
  parameters held whole over ``pp`` (embedding, head, a tied embedding
  once through ``shared_params``), and the loss, summed over ``pp`` once at
  the end.

Both schedules recompute a stage from its input in the backward, so a
stage's blocks run without their own checkpoints here (``cfg.remat``
would recompute them a second time).  ``last_stash_slots``,
``last_n_ticks`` and ``last_grad_acc_shapes`` describe the last 1F1B call
as in JAX; ``last_stage_calls`` counts this rank's stage computations
(forwards; recomputes with their transposes) in the last call of either
schedule.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.utils._pytree as pytree

from .sharding import PartitionSpec, StageSpec, stage_of
from .spmd import _Hop

__all__ = [
    "microbatch_rows",
    "pipeline_forward",
    "pipeline_value_and_grad",
    "contiguous_rows",
    "layer_grads",
    "schedule_1f1b",
    "stage_blocks",
    "stage_context",
    "stage_inputs",
    "stage_specs",
]

last_stash_slots = 0  # the ring buffer's depth in the last 1F1B call
last_n_ticks = 0
last_grad_acc_shapes: Tuple = ()  # (accumulator, shape, dtype) of the last 1F1B call
last_stage_calls: Dict[str, int] = {"forward": 0, "backward": 0}


def _coords(mesh, axis: str):
    """``(group or None, P, p)`` of this rank on the ``axis`` of ``mesh``."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    n = mesh.size(names.index(axis))
    return (mesh.get_group(axis) if n > 1 else None), n, mesh.get_local_rank(axis)


def stage_specs(specs: Dict[str, PartitionSpec], *, pp: str = "pp") -> Dict[str, PartitionSpec]:
    """``specs`` by parameter name with every layer's (``layers.<i>.*``)
    given to its pipeline stage over ``pp``
    (:class:`~torchdistx_tpu_torch.parallel.sharding.StageSpec`; the JAX
    ``stage_specs`` prefixes the stacked layer dim's spec with ``pp``).
    The other axes place a stage's layers as ``specs`` does; parameters
    outside the layers (embedding, final norm, head) stay whole over
    ``pp``."""
    layer = {}
    for name in specs:
        parts = name.split(".")
        if len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit():
            layer[name] = int(parts[1])
    n_layers = max(layer.values()) + 1 if layer else 0
    return {name: (StageSpec(*spec, pp=pp, layer=layer[name], n_layers=n_layers)
                   if name in layer else spec)
            for name, spec in specs.items()}


def stage_blocks(layers: Sequence, mesh, axis: str = "pp") -> Tuple[int, list]:
    """``(first, blocks)``: this rank's stage of ``layers`` on the ``axis``
    of ``mesh`` and the index of its first layer; raises when the stages do
    not divide the layers."""
    _, n, p = _coords(mesh, axis)
    per = len(layers) // n
    stage_of(0, len(layers), n)  # raises unless n divides the layers
    return p * per, list(layers)[p * per:(p + 1) * per]


def microbatch_rows(x: torch.Tensor, n_microbatches: int, shard) -> torch.Tensor:
    """This rank's block of a global batch ``x (B, ...)`` for a pipeline of
    ``n_microbatches``: microbatch ``m`` is the global rows ``m * B / M`` up
    to the next one's (the JAX split), and ``shard`` cuts each microbatch
    to this rank's block of it, its rows over the data axes and, with a
    sequence axis, its columns (``SpmdContext.shard_batch``; None: whole).
    The result holds the rank's block of microbatch 0, then of 1, ..."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} microbatches")
    if shard is None:
        return x
    return torch.cat([shard({"tokens": micro})["tokens"]
                      for micro in x.chunk(n_microbatches)])


def stage_inputs(tokens, targets, *, mesh, axis: str, n_microbatches: int,
                 attn_impl: str = "auto", seq_axis: Optional[str] = None,
                 seq_layout: str = "contiguous", tp: Optional[str] = "tp",
                 fsdp: Optional[str] = "fsdp"):
    """What a family's pipelined forward runs on: ``(ctx, tokens, targets,
    attn_impl)``, the context of this rank's stage (an ``SpmdContext`` on
    the stage's mesh with ``seq_axis``, ``tp`` and ``fsdp``, or ``SINGLE``
    when a stage is one rank), the global ``(B, S)`` batch's block of this
    rank (:func:`microbatch_rows`), and the attention impl inside a stage
    (``resolve_stage_attn_impl``: the ring over ``seq_axis`` when there is
    one).  The zigzag layout does not compose with a pipeline (the JAX
    message)."""
    from ..ops.attention import resolve_stage_attn_impl

    if seq_layout != "contiguous":
        raise ValueError("seq_layout='zigzag' does not compose with pp")
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if seq_axis is not None and seq_axis not in names:
        raise ValueError(f"mesh has no axis {seq_axis!r} (axes: {names})")
    ctx, _ = stage_context(mesh, axis, seq_axis=seq_axis, tp=tp, fsdp=fsdp)
    shard = getattr(ctx, "shard_batch", None)
    tokens = microbatch_rows(tokens, n_microbatches, shard)
    if targets is not None:
        targets = microbatch_rows(targets, n_microbatches, shard)
    return ctx, tokens, targets, resolve_stage_attn_impl(attn_impl, cuda=tokens.is_cuda,
                                                         seq_axis=seq_axis)


def stage_context(mesh, axis: str, *, seq_axis: Optional[str] = None,
                  tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
    """``(ctx, rows)``: the context of this rank's stage (an
    ``SpmdContext`` on the mesh without ``axis``, or ``SINGLE`` when a
    stage is one rank or there is no mesh), and the function that cuts a
    global ``(b, ...)`` microbatch to this rank's block of it (the 1F1B
    pieces' inputs)."""
    from .sharding import stage_mesh
    from .spmd import model_context

    ctx = model_context(None if mesh is None else stage_mesh(mesh, axis), seq_axis,
                        tp=tp, fsdp=fsdp)
    if not hasattr(ctx, "shard_batch"):
        return ctx, lambda x: x
    return ctx, lambda x: ctx.shard_batch({"tokens": x})["tokens"]


def contiguous_rows(x, ctx, n_microbatches: int):
    """This rank's block of ``x`` in the batch's contiguous split over the
    data axes (``batch_sharding``'s), from its block in the pipeline's
    split (:func:`microbatch_rows`): gathered over the data (and sequence)
    axes and cut again (differentiable).  Without data axes the two are
    the same."""
    if not getattr(ctx, "batch_axes", None):
        return x
    full = ctx.gather_tokens(x)  # (ranks, M, rows) ...
    b, rest = full.shape[0], tuple(full.shape[1:])
    ranks = b // x.shape[0]
    full = full.reshape((ranks, n_microbatches, -1) + rest).transpose(0, 1).reshape(
        (b,) + rest)
    return ctx.local_tokens(full, x)


def layer_grads(first: int, g_lp) -> Dict[str, torch.Tensor]:
    """A stage's per-layer gradients (:func:`pipeline_value_and_grad`'s
    ``g_layers``) by their model names, ``layers.<first + i>.<name>``."""
    return {f"layers.{first + i}.{k}": g for i, named in enumerate(g_lp)
            for k, g in named.items()}


def _shift(leaves, group, n, p, shift):
    """``leaves`` hopped ``shift`` stages along the pipeline (this rank
    receives those of rank ``p - shift``)."""
    if group is None:
        return list(leaves)
    return _Hop(list(leaves), group, n, p, shift).wait()


def _sum_over(tensors, group) -> None:
    """Sum each tensor in place over ``group`` (none: nothing to do)."""
    if group is not None:
        for t in tensors:
            dist.all_reduce(t, group=group)


# ---------------------------------------------------------------------------
# GPipe


class _Stage:
    """One call's stage: its blocks and ``block_fn`` over an activation
    pytree flattened to its leaves."""

    def __init__(self, blocks, block_fn, spec, counts):
        self.blocks, self.block_fn, self.spec, self.counts = blocks, block_fn, spec, counts

    def __call__(self, leaves, kind):
        self.counts[kind] += 1
        h = pytree.tree_unflatten(list(leaves), self.spec)
        for blk in self.blocks:
            h = self.block_fn(h, blk)
        out, spec = pytree.tree_flatten(h)
        if spec != self.spec:
            raise ValueError(f"block_fn changed the activation's structure: {spec} "
                             f"from {self.spec}")
        return out


class _GPipe(torch.autograd.Function):
    """The GPipe schedule over the flattened activation ``leaves``; its
    backward is the transposed schedule (module docstring).  ``anchor`` is
    an empty tensor that requires grad, so that the backward runs for the
    stage's parameters also when the input needs no gradient."""

    @staticmethod
    def forward(ctx, run, anchor, *leaves):
        stage, group, n, p, m_count = run
        b = leaves[0].shape[0]
        micro = [x.reshape((m_count, b // m_count) + tuple(x.shape[1:])) for x in leaves]
        n_ticks = m_count + n - 1
        incoming = [torch.zeros_like(x[0]) for x in micro]
        outputs = [torch.zeros_like(x) for x in micro]
        stash = {}
        for t in range(n_ticks):
            m = t - p
            valid = 0 <= m < m_count
            stage_in = [x[min(max(m, 0), m_count - 1)] for x in micro] if p == 0 else incoming
            if valid:
                stash[m] = stage_in
                y = stage(stage_in, "forward")
                if p == n - 1:
                    for out, yl in zip(outputs, y):
                        out[m] = yl
            else:
                y = stage_in  # no stage compute on a ramp or drain tick
            if t < n_ticks - 1:
                incoming = _shift(y, group, n, p, 1)
        _sum_over(outputs, group)  # zeros but on the last stage: a broadcast
        ctx.run, ctx.stash, ctx.shapes = run, stash, [x.shape for x in leaves]
        ctx.micro_like = [x[0] for x in micro]
        return tuple(out.reshape(x.shape) for out, x in zip(outputs, leaves))

    @staticmethod
    def backward(ctx, *grads):
        stage, group, n, p, m_count = ctx.run
        like = ctx.micro_like
        g_out = [None if g is None else g.reshape((m_count,) + tuple(x.shape))
                 for g, x in zip(grads, like)]
        d_micro = [torch.zeros((m_count,) + tuple(x.shape), dtype=x.dtype, device=x.device)
                   for x in like]
        n_ticks = m_count + n - 1
        g_send = None
        for t in reversed(range(n_ticks)):
            if t < n_ticks - 1:
                g_y = _shift(g_send, group, n, p, -1)
            else:
                g_y = [torch.zeros_like(x) for x in like]
            m = t - p
            if 0 <= m < m_count:
                if p == n - 1:
                    g_y = [gy if go is None else gy + go[m] for gy, go in zip(g_y, g_out)]
                x_in = [x.detach().requires_grad_(x.is_floating_point())
                        for x in ctx.stash.pop(m)]
                with torch.enable_grad():
                    y = stage(x_in, "backward")
                pairs = [(yl, gl) for yl, gl in zip(y, g_y) if yl.requires_grad]
                if pairs:
                    torch.autograd.backward([yl for yl, _ in pairs], [gl for _, gl in pairs])
                g_in = [torch.zeros_like(x) if x.grad is None else x.grad for x in x_in]
                if p == 0:
                    for d, g in zip(d_micro, g_in):
                        d[m] += g
            else:
                g_in = g_y
            g_send = [torch.zeros_like(g) for g in g_in] if p == 0 else g_in
        _sum_over(d_micro, group)  # the input's cotangent, from stage 0 to every stage
        dx = [d.reshape(s) for d, s in zip(d_micro, ctx.shapes)]
        need = ctx.needs_input_grad[2:]
        return (None, None, *[d if k else None for d, k in zip(dx, need)])


def pipeline_forward(
    x,
    layer_params: Sequence,
    block_fn: Callable,
    *,
    mesh,
    axis: str = "pp",
    n_microbatches: int,
):
    """Run this rank's stage of stacked layers over ``x`` with the GPipe
    schedule; every rank returns the last stage's output.

    ``x``: this rank's activations ``(B, ...)`` (the same on every rank of
    the ``pp`` axis), or a pytree of them with one leading batch dim (MoE's
    router aux loss rides along); ``n_microbatches`` must divide ``B``.
    ``layer_params``: this rank's stage, the layers that ``block_fn(h,
    layer) -> h`` takes one at a time (:func:`stage_blocks`), preserving
    ``h``'s structure.  Differentiable: the backward is the transposed
    schedule (module docstring), which recomputes each stage from its
    stashed input."""
    group, n, p = _coords(mesh, axis)
    leaves, spec = pytree.tree_flatten(x)
    batch = leaves[0].shape[0]
    if any(leaf.shape[0] != batch for leaf in leaves):
        raise ValueError("all activation leaves must share the batch dim")
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by {n_microbatches} microbatches")
    counts = {"forward": 0, "backward": 0}
    global last_stage_calls
    last_stage_calls = counts
    stage = _Stage(list(layer_params), block_fn, spec, counts)
    anchor = torch.empty(0, device=leaves[0].device, requires_grad=torch.is_grad_enabled())
    out = _GPipe.apply((stage, group, n, p, n_microbatches), anchor, *leaves)
    return pytree.tree_unflatten(list(out), spec)


# ---------------------------------------------------------------------------
# 1F1B


def schedule_1f1b(n_stages: int, n_microbatches: int, stage: int) -> List[tuple]:
    """Stage ``stage``'s 1F1B ticks: ``[(t, forward microbatch or None,
    backward microbatch or None)]`` for ``t`` in ``range(2M + 2P - 3)``, by
    the JAX schedule's counters: a forward at ``t == max(fc + p, 2 fc + 2p
    - P + 1)`` while ``fc < M``, a backward at ``t == 2P - 2 - p + 2 bc``
    while ``bc < M`` (the last stage's forward slot only counts: its
    backward slot runs the stage).  With ``M < 1`` there are no ticks."""
    p, n, m_count = stage, n_stages, n_microbatches
    fc = bc = 0
    out = []
    for t in range(max(2 * m_count + 2 * n - 3, 0)):
        do_fwd = t == max(fc + p, 2 * fc + 2 * p - n + 1) and fc < m_count
        do_bwd = t == 2 * n - 2 - p + 2 * bc and bc < m_count
        out.append((t, fc if do_fwd else None, bc if do_bwd else None))
        fc += do_fwd
        bc += do_bwd
    return out


def _params_of(layer) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(layer, nn.Module):
        return list(layer.named_parameters())
    return [("", layer)]


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _placed_like(g, p):
    """``g`` (a local tensor) as ``p``'s gradient: a ``DTensor`` placed as
    ``p`` when ``p`` is one."""
    if hasattr(p, "placements"):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(g, p.device_mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())
    return g


def _one_f_one_b(n, p, m_count, n_slots, group, stage, embed, head, tok_mb, tgt_mb, h_like,
                 h_spec, stage_params, head_params, embed_params):
    """This rank's ticks of the 1F1B schedule; the parameters' gradients go
    to their accumulators through their hooks.  Returns the sum of the
    microbatches' losses on the last stage (0 elsewhere)."""
    stash: List[Optional[list]] = [None] * n_slots
    prev_table = schedule_1f1b(n, m_count, p - 1) if p > 0 else None
    inc_y, inc_m, inc_g = h_like, -1, h_like
    loss = torch.zeros((), dtype=torch.float32, device=h_like[0].device)
    last = p == n - 1
    n_ticks = 2 * m_count + 2 * n - 3
    for t, f_m, b_m in schedule_1f1b(n, m_count, p):
        # 1. Take in the activation that came up last tick.
        if inc_m >= 0 and p > 0:
            stash[inc_m % n_slots] = inc_y
        # 2. Forward slot: stage 0 embeds and stashes; the last stage's
        # backward slot runs its stage.
        y_out = h_like
        if f_m is not None:
            if p == 0:
                with torch.no_grad():
                    stash[f_m % n_slots] = pytree.tree_leaves(embed(tok_mb[f_m]))
            if not last:
                with torch.no_grad():
                    y_out = stage(stash[f_m % n_slots], "forward")
        # 3. Backward slot: recompute the stage from its stashed input,
        # transpose it with the cotangent that came down (or, on the last
        # stage, the head's).
        g_out = h_like
        if b_m is not None:
            h_in = [x.detach().requires_grad_(x.is_floating_point())
                    for x in stash[b_m % n_slots]]
            with torch.enable_grad():
                y = stage(h_in, "backward")
                if last:
                    loss_mb = head(pytree.tree_unflatten(y, h_spec), tgt_mb[b_m])
                    outs, cots = [loss_mb], None
                    wrt = stage_params + head_params
                else:
                    pairs = [(yl, gl) for yl, gl in zip(y, inc_g) if yl.requires_grad]
                    outs, cots = [yl for yl, _ in pairs], [gl for _, gl in pairs]
                    wrt = stage_params
                torch.autograd.backward(outs, cots, inputs=wrt + [x for x in h_in
                                                                    if x.requires_grad])
            if last:
                loss += loss_mb.detach().float()
            g_h = [torch.zeros_like(x) if x.grad is None else x.grad for x in h_in]
            if p == 0:
                with torch.enable_grad():
                    e_out = pytree.tree_leaves(embed(tok_mb[b_m]))
                    pairs = [(e, g) for e, g in zip(e_out, g_h) if e.requires_grad]
                    torch.autograd.backward([e for e, _ in pairs], [g for _, g in pairs],
                                            inputs=embed_params)
            else:
                g_out = g_h
        # 4. Hand off: activations up, cotangents down, on every rank every
        # tick but the last (the microbatch that came up is the one the
        # previous stage's forward slot ran, from its own table).
        if t < n_ticks - 1 and n > 1:
            inc_y = _shift(y_out, group, n, p, 1)
            inc_g = _shift(g_out, group, n, p, -1)
            inc_m = -1 if p == 0 or prev_table[t][1] is None else prev_table[t][1]
    return loss


def pipeline_value_and_grad(
    embed_params: Dict[str, torch.Tensor],
    layer_params: Sequence,
    head_params: Dict[str, torch.Tensor],
    tokens,
    targets,
    embed_fn: Callable,
    block_fn: Callable,
    head_loss_fn: Callable,
    *,
    mesh,
    axis: str = "pp",
    n_microbatches: int,
    shared_params: Optional[Dict[str, torch.Tensor]] = None,
):
    """``(loss, (g_embed, g_layers, g_head))`` of this rank by the 1F1B
    schedule (module docstring).

    ``embed_fn(embed_params, tokens_mb) -> h`` runs on stage 0 per
    microbatch, ``block_fn(h, layer) -> h`` over this rank's stage
    ``layer_params`` (its layers: modules or tensors), ``head_loss_fn(
    head_params, h, targets_mb) -> scalar`` on the last stage per
    microbatch (the microbatch's mean).  ``tokens``/``targets``: the global
    ``(B, S)`` batch, the same on every rank, ``B % n_microbatches == 0``;
    a microbatch is ``B / M`` consecutive rows.  ``h`` may be a pytree.
    ``embed_params``/``head_params``: the parameters the embedding and the
    head read, by name; ``shared_params``: those both read (GPT-2's tied
    embedding), then passed to both as a last argument, with one f32
    accumulator, and the result gains ``g_shared``.

    The gradients are dicts by name (``g_layers``: a list, per layer, of
    its parameters' by name; a tensor layer's under ``""``), in the
    parameters' dtypes and placements; those of ``embed_params``,
    ``head_params`` and ``shared_params`` and the loss are the whole
    pipeline's on every rank, the layers' this rank's stage's."""
    global last_stash_slots, last_n_ticks, last_grad_acc_shapes, last_stage_calls
    group, n, p = _coords(mesh, axis)
    m_count = n_microbatches
    b, s = tokens.shape
    if b % m_count:
        raise ValueError(f"batch {b} not divisible by {m_count} microbatches")
    bt = b // m_count
    n_slots = (3 * n) // 2 + 1
    n_ticks = 2 * m_count + 2 * n - 3
    last_stash_slots, last_n_ticks = n_slots, n_ticks
    has_shared = shared_params is not None
    ep, hp, sp = dict(embed_params), dict(head_params), dict(shared_params or {})

    def embed(tok):
        return embed_fn(ep, tok, sp) if has_shared else embed_fn(ep, tok)

    def head(y, tgt):
        return head_loss_fn(hp, y, tgt, sp) if has_shared else head_loss_fn(hp, y, tgt)

    tok_mb = tokens.reshape(m_count, bt, s)
    tgt_mb = targets.reshape(m_count, bt, s)
    with torch.no_grad():  # the activation's structure, shapes and dtypes
        h_leaves, h_spec = pytree.tree_flatten(embed(tok_mb[0]))
    h_like = [torch.zeros_like(x) for x in h_leaves]
    del h_leaves
    counts = {"forward": 0, "backward": 0}
    last_stage_calls = counts
    layers = list(layer_params)
    stage = _Stage(layers, block_fn, h_spec, counts)
    lp = [_params_of(layer) for layer in layers]

    def zeros_f32(named):
        return {k: torch.zeros(_local(t).shape, dtype=torch.float32, device=_local(t).device)
                for k, t in named}

    acc = {"g_ep": zeros_f32(ep.items()),
           "g_lp": [zeros_f32(named) for named in lp],
           "g_hp": zeros_f32(hp.items()),
           "g_sp": zeros_f32(sp.items())}
    last_grad_acc_shapes = tuple(
        (name, tuple(t.shape), "float32")
        for name in ("g_ep", "g_lp", "g_hp", "g_sp")
        for t in (pytree.tree_leaves(acc[name])))

    # Each parameter's gradient is added to its accumulator as soon as the
    # backward has made it, and freed (a hook after accumulation), so that
    # a slot never holds the whole stage's gradients at once: at 7B widths
    # they are the size of the parameters.
    acc_of = {}
    for name, named in (("g_ep", ep.items()), ("g_hp", hp.items()), ("g_sp", sp.items())):
        for k, t in named:
            acc_of[id(t)] = acc[name][k]
    for i, named in enumerate(lp):
        for k, t in named:
            acc_of[id(t)] = acc["g_lp"][i][k]
    params = [t for named in [ep.items(), hp.items(), sp.items()] + lp for _, t in named]
    held_grads = [t.grad for t in params]

    def add_to_accumulator(t):
        acc_of[id(t)].add_(_local(t.grad))
        t.grad = None

    hooks = [t.register_post_accumulate_grad_hook(add_to_accumulator) for t in params]
    try:
        for t in params:
            t.grad = None
        loss = _one_f_one_b(
            n, p, m_count, n_slots, group, stage, embed, head, tok_mb, tgt_mb, h_like, h_spec,
            [t for named in lp for _, t in named], list(hp.values()) + list(sp.values()),
            list(ep.values()) + list(sp.values()))
    finally:
        for h in hooks:
            h.remove()
        for t, g in zip(params, held_grads):
            t.grad = g
    inv = 1.0 / m_count
    whole_over_pp = [loss] + [t for name in ("g_ep", "g_hp", "g_sp")
                              for t in acc[name].values()]
    _sum_over(whole_over_pp, group)

    def cast(grads, named):
        # Each accumulator freed as it is cast: a 7B stage's f32
        # accumulators are twice its bf16 parameters.
        return {k: _placed_like(grads.pop(k).mul_(inv).to(t.dtype), t) for k, t in named}

    g_ep = cast(acc["g_ep"], ep.items())
    g_lp = [cast(a, named) for a, named in zip(acc["g_lp"], lp)]
    g_hp = cast(acc["g_hp"], hp.items())
    out = (g_ep, g_lp, g_hp)
    if has_shared:
        out += (cast(acc["g_sp"], sp.items()),)
    return loss * inv, out
