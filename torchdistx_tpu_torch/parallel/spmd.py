"""One rank's share of a step on a mesh: local blocks and the collectives
between them.

The JAX package writes its models once, on global arrays, and XLA's SPMD
partitioner splits each step over the mesh.  Here each rank computes on its
own blocks, and :class:`SpmdContext` supplies what the partitioner inserts:

- **weights** (:meth:`SpmdContext.weight`): a parameter is a ``DTensor``
  placed by the model's ``param_specs``; its local compute tensor is the
  parameter gathered over every mesh axis but ``tp`` where the model
  computes tensor-parallel on that dim (Megatron: column-parallel weights
  keep their output dim split, row-parallel ones their input dim).  The
  gather's backward brings the gradient back to the parameter's own
  placements: reduce-scattered over an axis that splits the data (the batch
  axes ``dp``/``fsdp`` and the sequence axis), where each rank holds a
  partial sum, and cut to the rank's shard over an axis whose ranks compute
  the same gradient; a dim left whole is all-reduced over the data axes;
- **tensor parallelism** (:meth:`tp_copy`, :meth:`tp_reduce`): the input of
  a column-parallel product is all-reduced over ``tp`` in the backward, the
  output of a row-parallel one in the forward;
- **the loss** (:meth:`data_sum`): each rank's share of the global mean,
  summed over the data axes in the forward only (every rank's backward
  starts from the same global loss);
- **attention** (:meth:`attention`): the local q, k, v as ``DTensor``s
  placed ``(batch axes, sequence axis, tp, -)`` through
  :func:`~torchdistx_tpu_torch.ops.attention.attention`, which runs the
  kernel on each rank's block or the ring over the sequence axis;
- **tokens** (:meth:`gather_tokens`): every rank's rows of an activation
  (the MoE router's global capacity needs all tokens);
- **experts** (:meth:`ep_share`, :meth:`ep_exchange`, :meth:`ep_gather`):
  under an ``ep`` axis, this rank's share of its block's tokens, the rows
  sent to their experts' owners and back by ``all_to_all_single``, and the
  shares gathered again.

Axes: ``dp`` and the ``fsdp`` axis split the batch (the JAX
``batch_sharding``), the sequence axis splits the sequence, the ``tp`` axis
splits heads and the MLP width, ``ep`` splits the MoE expert stacks, and
any other axis replicates the compute.  The ``tp`` and ``fsdp`` roles take
the names that the train step is given (``tp=``/``fsdp=``, ``None`` for
none).  Axes of size 1 take no part.  Every collective is issued in the
same order on every rank (the autograd graph is the same on each), over the
groups of ``mesh.get_group(axis)``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist

from .sharding import mesh_axis_sizes

__all__ = ["SINGLE", "SpmdContext", "local_inputs", "model_context", "replicated", "whole"]

# The mesh axis that holds MoE experts (the JAX ``param_specs``' ``ep``).
EP_AXIS = "ep"


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _shard_of(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.narrow(dim, r * (x.shape[dim] // n), x.shape[dim] // n)


def whole(t):
    """The whole value of ``t`` (a ``DTensor`` sharded or replicated, not
    partial) on every rank, detached, gathered by c10d all-gathers over its sharded
    mesh dims.  ``DTensor.full_tensor`` issues functional collectives,
    which gloo does not run on CUDA tensors (the process faults); c10d's
    run there.  A plain tensor is returned detached (a parameter's whole
    value must not hold its autograd graph, nor through it the
    parameter)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t.detach()
    x, mesh = t.to_local().detach(), t.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = t.placements[i]
        if isinstance(p, Shard) and mesh.size(i) > 1:
            x = _all_gather(x, p.dim, mesh.get_group(i))
    return x


class _Hop:
    """One neighbour hop over ``group`` (``n`` ranks, this one at ``idx``):
    ``tensors`` sent to rank ``idx + shift`` and the same shapes received
    from rank ``idx - shift`` (mod ``n``), as one ``all_to_all_single``
    whose only non-empty parts are those two, packed in their dtype (f32
    when they differ; bf16 and integers below 2^24 widen to f32 exactly).
    Ring attention hops up (``shift=1``); the pipeline hops activations up
    and cotangents down (``shift=-1``).  An ``all_to_all_single`` and not
    point-to-point ops: gloo's ``isend``/``irecv`` abort or hang on CUDA
    tensors, its all-to-all runs on them."""

    def __init__(self, tensors, group, n, idx, shift: int = 1):
        self.shapes = [t.shape for t in tensors]
        self.dtypes = [t.dtype for t in tensors]
        wire = self.dtypes[0] if len(set(self.dtypes)) == 1 else torch.float32
        send = torch.cat([t.reshape(-1).to(wire) for t in tensors])
        self.recv = torch.empty_like(send)
        size = send.numel()
        dst, src = (idx + shift) % n, (idx - shift) % n
        self.work = dist.all_to_all_single(
            self.recv, send,
            output_split_sizes=[size if j == src else 0 for j in range(n)],
            input_split_sizes=[size if j == dst else 0 for j in range(n)],
            group=group, async_op=True)

    def wait(self):
        self.work.wait()
        out, start = [], 0
        for shape, dtype in zip(self.shapes, self.dtypes):
            numel = math.prod(shape)
            out.append(self.recv[start:start + numel].view(shape).to(dtype))
            start += numel
        return out


class _Unshard(torch.autograd.Function):
    """Forward: gather ``x`` along each step's dim over its group (the last
    mesh dim first) and, for a whole dim, nothing.  Backward: each step
    undone in reverse order, the gradient reduced where it is partial.

    A step is ``(group, dim, partial)``: ``dim`` None for a dim the
    parameter holds whole (the backward all-reduces when ``partial``),
    otherwise the tensor dim gathered (the backward reduce-scatters when
    ``partial``, else cuts out this rank's shard)."""

    @staticmethod
    def forward(ctx, x, steps):
        ctx.steps = steps
        for group, dim, _ in steps:
            if dim is not None:
                x = _all_gather(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, grad):
        for group, dim, partial in reversed(ctx.steps):
            if dim is None:
                if partial:
                    grad = _all_reduce(grad, group)
            elif partial:
                grad = _reduce_scatter(grad, dim, group)
            else:
                grad = _shard_of(grad, dim, group)
        return grad.contiguous(), None


class _ReduceForward(torch.autograd.Function):
    """All-reduce (sum) over each group in the forward; identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            x = _all_reduce(x, g)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceBackward(torch.autograd.Function):
    """Identity forward; all-reduce (sum, or with ``mean`` the mean) over
    ``group`` in the backward."""

    @staticmethod
    def forward(ctx, x, group, mean=False):
        ctx.group, ctx.mean = group, mean
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad, ctx.group)
        if ctx.mean:
            grad.div_(dist.get_world_size(ctx.group))
        return grad, None, None


class _Share(torch.autograd.Function):
    """Forward: this rank's part of ``x`` along dim 0 (``group``'s ranks
    take contiguous equal parts); backward: the parts' gradients gathered
    (every rank of ``group`` held the whole ``x``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shard_of(x, 0, group).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad.contiguous(), 0, ctx.group), None


class _AllToAll(torch.autograd.Function):
    """Rows of ``x (N, ...)`` exchanged over ``group``: ``send[j]`` rows
    (in order) to rank ``j``, ``recv[j]`` rows from it; the backward sends
    the gradients back the same way reversed."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _exchange(x, send, recv, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.recv, ctx.send, ctx.group), None, None, None


def _exchange(x, send, recv, group):
    x = x.contiguous()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=list(recv),
                           input_split_sizes=list(send), group=group)
    return out


class _PartialToReplicate(torch.autograd.Function):
    """A ``DTensor`` scalar's local value reduced over its ``Partial`` mesh
    dims by c10d all-reduces (``groups``, each with its size when the
    partial is a mean); identity backward: ``to_local``'s backward treats
    the gradient as the global value's, as ``DTensor`` ops do."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.detach().clone()
        for group, mean in groups:
            dist.all_reduce(x, group=group)
            if mean:
                x = x / dist.get_world_size(group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def replicated(t):
    """The global value of a ``DTensor`` scalar as a plain tensor on every
    rank, reduced over its ``Partial`` mesh dims by c10d all-reduces
    (differentiable; gloo runs them on CUDA tensors, where ``DTensor``'s
    functional collectives fault); a plain tensor as it is.  A loss written
    in torch ops on a mesh model's ``DTensor`` logits ends ``Partial`` over
    the data axes."""
    from torch.distributed.tensor import DTensor, Partial

    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    groups = tuple((mesh.get_group(i), p.reduce_op == "avg")
                   for i, p in enumerate(t.placements)
                   if isinstance(p, Partial) and mesh.size(i) > 1)
    return _PartialToReplicate.apply(t.to_local(), groups)


class SpmdContext:
    """The collectives of one rank on ``mesh`` (a named ``DeviceMesh``) for a
    model step whose sequence is split over ``seq_axis`` (or not)."""

    def __init__(self, mesh, *, seq_axis: Optional[str] = None, tp: Optional[str] = "tp",
                 fsdp: Optional[str] = "fsdp"):
        sizes = mesh_axis_sizes(mesh)
        if seq_axis is not None and seq_axis not in sizes:
            raise ValueError(f"mesh has no axis {seq_axis!r} (axes {tuple(sizes)})")
        self.mesh = mesh
        self.names: List[str] = list(sizes)
        self.sizes = sizes
        live = [a for a in self.names if sizes[a] > 1]
        # The batch splits over dp and the fsdp axis (the JAX batch_sharding).
        self.batch_axes = [a for a in live if a in ("dp", fsdp)]
        self.seq_axis = seq_axis
        self.tp = tp if tp in live else None
        self.ep = EP_AXIS if EP_AXIS in live else None
        self.reduce_axes = self.batch_axes + ([seq_axis] if seq_axis in live else [])
        self._groups = {a: mesh.get_group(a) for a in live}

    @property
    def tp_size(self) -> int:
        return self.sizes[self.tp] if self.tp else 1

    @property
    def n_reduce(self) -> int:
        """Ranks whose loss shares sum to the global loss."""
        n = 1
        for a in self.reduce_axes:
            n *= self.sizes[a]
        return n

    @property
    def tp_rank(self) -> int:
        return self.mesh.get_local_rank(self.tp) if self.tp else 0

    @property
    def ep_size(self) -> int:
        return self.sizes[self.ep] if self.ep else 1

    def tp_divides(self, *counts: int) -> bool:
        """Whether ``tp`` splits each count (heads, widths) evenly."""
        return all(c % self.tp_size == 0 for c in counts)

    def shard_batch(self, batch):
        """This rank's rows and columns of a global ``{"tokens", "targets"}``
        batch (:func:`~torchdistx_tpu_torch.parallel.sharding.batch_sharding`)."""
        from .sharding import batch_sharding

        seq = self.seq_axis if self.seq_axis in self.reduce_axes else None
        return batch_sharding(self.mesh, data_axes=self.batch_axes, seq_axis=seq)(batch)

    def seq_offset(self, s_local: int) -> int:
        """The global position of this rank's first column."""
        if self.seq_axis not in self.reduce_axes:
            return 0
        return self.mesh.get_local_rank(self.seq_axis) * s_local

    def loss(self, local_sum, n_global: int, replicated=None):
        """The global loss from this rank's ``local_sum`` of per-token losses
        over ``n_global`` tokens, plus ``replicated`` (a term every rank
        computes whole, such as MoE's aux loss)."""
        share = local_sum / n_global
        if replicated is not None:
            share = share + replicated / self.n_reduce
        return self.data_sum(share)

    # -- parameters -------------------------------------------------------

    def weight(self, param, *, tp_dim: Optional[int] = None,
               tp_partial: bool = False, experts: bool = False) -> torch.Tensor:
        """``param``'s local compute tensor: gathered over every mesh axis
        but ``tp``, and over ``tp`` too unless ``tp_dim`` is given, where it
        is this rank's ``tp`` share of that dim (the dim the model computes
        tensor-parallel: kept as placed when ``param`` is split there, else
        cut from the gathered tensor).  ``tp_partial``: the model uses only
        part of the gathered tensor (its heads), so the gradient is partial
        over ``tp``.  ``experts``: ``param`` is an expert stack, whose
        ``ep`` shard (this rank's experts) stays as placed; any other
        parameter's gradient is averaged over ``ep``, whose ranks compute
        it alike (their data is the same) but may round it otherwise where
        a kernel sums in a varying order, so that their copies stay
        bit-equal.  A plain tensor counts as replicated."""
        from torch.distributed.tensor import DTensor, Shard

        if isinstance(param, DTensor):
            placements = list(param.placements)
            local = param.to_local()
        else:
            placements = [None] * len(self.names)
            local = param
        cut = False
        steps = []
        for i in reversed(range(len(self.names))):
            a = self.names[i]
            if self.sizes[a] == 1 or (experts and a == self.ep):
                continue
            p = placements[i]
            dim = p.dim if isinstance(p, Shard) else None
            if a == self.tp and tp_dim is not None:
                if dim == tp_dim:
                    continue
                cut = True
            partial = a in self.reduce_axes or (a == self.tp and (tp_partial or cut))
            steps.append((self._groups[a], dim, partial))
        if self.ep and not experts:
            local = _ReduceBackward.apply(local, self._groups[self.ep], True)
        out = _Unshard.apply(local, tuple(steps)) if steps else local
        if cut:
            out = _shard_of(out, tp_dim, self._groups[self.tp])
        return out

    # -- activations ------------------------------------------------------

    def tp_copy(self, x):
        """The input of a column-parallel product (all-reduced over ``tp``
        in the backward)."""
        return x if self.tp is None else _ReduceBackward.apply(x, self._groups[self.tp])

    def tp_reduce(self, x):
        """The output of a row-parallel product, summed over ``tp``."""
        return x if self.tp is None else _ReduceForward.apply(x, (self._groups[self.tp],))

    def data_sum(self, x):
        """``x`` summed over the data axes (forward only)."""
        if not self.reduce_axes:
            return x
        return _ReduceForward.apply(x, tuple(self._groups[a] for a in self.reduce_axes))

    def gather_tokens(self, x):
        """Every rank's block of ``x (b, s, ...)``: the global ``(B, S,
        ...)`` tensor (its gradient, a partial sum on each rank,
        reduce-scattered)."""
        steps = [(self._groups[a], 0, True) for a in reversed(self.batch_axes)]
        if self.seq_axis in self.reduce_axes:
            steps.insert(0, (self._groups[self.seq_axis], 1, True))
        return _Unshard.apply(x, tuple(steps)) if steps else x

    def ep_share(self, x):
        """This rank's share of ``x (T, ...)``, which every rank of its
        ``ep`` group holds whole: the ``T / ep`` contiguous rows of its
        ``ep`` coordinate (the backward gathers the shares' gradients)."""
        return _Share.apply(x, self._groups[self.ep])

    def ep_gather(self, x):
        """Every ``ep`` rank's share ``x`` in order: the whole ``(T, ...)``
        (the backward cuts this rank's share again: every rank of the group
        computes the same downstream)."""
        return _Unshard.apply(x, ((self._groups[self.ep], 0, False),))

    def ep_counts(self, counts):
        """``counts (ep * n,)``, ``n`` to each ``ep`` rank in order, swapped
        over the group: the ``n`` counts each rank sent this one."""
        return _exchange(counts, [counts.numel() // self.ep_size] * self.ep_size,
                         [counts.numel() // self.ep_size] * self.ep_size,
                         self._groups[self.ep])

    def ep_exchange(self, x, send, recv):
        """Rows of ``x`` to the ``ep`` group's ranks, ``send[j]`` to rank
        ``j``, and ``recv[j]`` from each (differentiable)."""
        return _AllToAll.apply(x, send, recv, self._groups[self.ep])

    def local_tokens(self, full, like):
        """This rank's block of a global ``(B, S, ...)`` tensor, ``like``'s
        shape."""
        out = full
        for dim, axes in ((0, self.batch_axes),
                          (1, [self.seq_axis] if self.seq_axis in self.reduce_axes else [])):
            index = 0
            for a in axes:
                index = index * self.sizes[a] + self.mesh.get_local_rank(a)
            out = out.narrow(dim, index * like.shape[dim], like.shape[dim])
        return out

    # -- attention ---------------------------------------------------------

    def placements(self, *, heads: bool):
        """``(batch axes, sequence axis, tp if heads, -)`` on the mesh."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for a in self.names:
            if a in self.batch_axes:
                out.append(Shard(0))
            elif a == self.seq_axis and a in self.reduce_axes:
                out.append(Shard(1))
            elif heads and a == self.tp:
                out.append(Shard(2))
            else:
                out.append(Replicate())
        return out

    def dtensor(self, x, placements):
        """``x``, this rank's block, as the ``DTensor`` it is a block of."""
        from torch.distributed.tensor import DTensor, Shard

        shape = list(x.shape)
        for a, p in zip(self.names, placements):
            if isinstance(p, Shard):
                shape[p.dim] *= self.sizes[a]
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(x, self.mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    def attention(self, q, k, v, *, heads: bool, impl: str = "auto",
                  pre_permuted: bool = False):
        """Attention of this rank's ``(b, s, h, d)`` blocks (``heads``: the
        heads are this rank's ``tp`` share), its block of the output."""
        from ..ops.attention import attention

        placements = self.placements(heads=heads)
        qd, kd, vd = (self.dtensor(t, placements) for t in (q, k, v))
        out = attention(qd, kd, vd, causal=True, impl=impl, mesh=self.mesh,
                        seq_axis=self.seq_axis, pre_permuted=pre_permuted,
                        batch_axes=tuple(self.batch_axes), head_axis=self.tp if heads else None)
        if list(out.placements) != placements:
            out = out.redistribute(self.mesh, placements)
        return out.to_local()


class _Single:
    """The context of a model on one device: weights as they are, no
    collective."""

    tp = ep = None
    tp_size = ep_size = 1
    tp_rank = 0
    n_reduce = 1

    @staticmethod
    def tp_divides(*counts: int) -> bool:
        return True

    @staticmethod
    def weight(param, **_):
        return param

    @staticmethod
    def tp_copy(x):
        return x

    tp_reduce = data_sum = gather_tokens = tp_copy

    @staticmethod
    def local_tokens(full, like):
        return full

    @staticmethod
    def seq_offset(s_local: int) -> int:
        return 0

    @staticmethod
    def attention(q, k, v, *, heads: bool, impl: str = "auto", pre_permuted: bool = False):
        from ..ops.attention import attention

        return attention(q, k, v, causal=True, impl=impl, pre_permuted=pre_permuted)


SINGLE = _Single()


def _layout(s: int, mesh, seq_axis, seq_layout: str, attn_impl: str):
    """``(perm, attn_impl, pre_permuted)`` of a forward's sequence layout
    (the JAX ``llama._forward_hidden``'s checks): ``perm`` None for the
    contiguous layout; for ``"zigzag"`` the global permutation (tokens and
    positions permuted once at the embedding, targets at the loss) and the
    zigzag ring on every layer."""
    if seq_layout == "contiguous":
        return None, attn_impl, False
    if seq_layout != "zigzag":
        raise ValueError(f"unknown seq_layout: {seq_layout!r}")
    if seq_axis is None or mesh is None:
        raise ValueError("seq_layout='zigzag' needs mesh= and seq_axis=")
    if attn_impl not in ("auto", "ring_zigzag"):
        # Zigzag-ordered activations are only meaningful to the zigzag ring
        # schedule; any other kernel would attend in permuted order.
        raise ValueError(
            f"attn_impl={attn_impl!r} is incompatible with "
            "seq_layout='zigzag' (requires 'auto' or 'ring_zigzag')"
        )
    from .ring_attention import _zigzag_perm

    perm, _ = _zigzag_perm(s, mesh_axis_sizes(mesh)[seq_axis])
    return perm, "ring_zigzag", True


def model_context(mesh, seq_axis, *, tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
    """:data:`SINGLE` without a mesh, else an :class:`SpmdContext` whose
    ``tp`` and ``fsdp`` roles are the axes so named."""
    if mesh is None:
        if seq_axis is not None:
            raise ValueError("seq_axis needs mesh=")
        return SINGLE
    return SpmdContext(mesh, seq_axis=seq_axis, tp=tp, fsdp=fsdp)


def local_inputs(tokens, targets, *, mesh, seq_axis, seq_layout="contiguous",
                 attn_impl="auto", tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
    """What a model's forward runs on: ``(ctx, tokens, targets, positions,
    attn_impl, pre_permuted)``.  Without a mesh, the inputs as given and
    positions ``arange(S)[None]``.  With one, ``tokens`` and ``targets`` are
    the global ``(B, S)`` batch (the same on every rank), permuted by the
    sequence layout and cut to this rank's block; ``positions`` ``(1, s)``
    are its columns' global positions (the original ones under zigzag, for
    RoPE).  ``tp`` / ``fsdp`` name the mesh axes of those roles."""
    ctx = model_context(mesh, seq_axis, tp=tp, fsdp=fsdp)
    s = tokens.shape[1]
    perm, attn_impl, pre = _layout(s, mesh, seq_axis, seq_layout, attn_impl)
    if perm is None:
        positions = torch.arange(s, device=tokens.device)[None]
    else:
        perm = perm.to(tokens.device)
        positions = perm[None]
        tokens = tokens[:, perm]
        targets = None if targets is None else targets[:, perm]
    if mesh is not None:
        batch = ctx.shard_batch({"tokens": tokens, "targets": tokens if targets is None
                                 else targets})
        s_local = batch["tokens"].shape[1]
        positions = positions.narrow(1, ctx.seq_offset(s_local), s_local)
        tokens = batch["tokens"]
        targets = None if targets is None else batch["targets"]
    return ctx, tokens, targets, positions, attn_impl, pre
