"""Ring attention: sequence/context parallelism over a mesh axis.

Counterpart of ``torchdistx_tpu/parallel/ring_attention.py``.  The sequence
dim of q/k/v is split over the ``sp`` mesh axis; each rank keeps its q
block and the k/v blocks rotate around the ring, one neighbour hop a step,
while an online softmax merges each visiting block's contribution.  After
``sp`` steps every q block has attended to the whole sequence.  Causal runs
skip blocks wholly in a q block's future, forward and backward.
``schedule="zigzag"`` balances the causal work: rank ``i`` holds sequence
halves ``i`` and ``2 sp - 1 - i``, so every rank computes two half-block
contributions a step (three on its diagonal step).

The JAX ring is ``shard_map`` + ``lax.scan`` + ``ppermute``, and autodiff
transposes it.  Here the ring is a ``torch.autograd.Function`` whose
backward runs the transposed ring by hand: the k/v blocks travel the same
way again, each with the dk and dv summed for it so far, and after ``sp``
hops those sums are home.  A hop is one ``all_to_all_single`` over the
``sp`` group whose only non-empty parts go to the next rank and come from
the previous one (k and v, or k, v, dk and dv, packed into one buffer),
issued before the step's block math and waited for after it.  The block
math is plain torch ops on f32 scores and sums, as the JAX ring's is
``jnp`` (it is not a Pallas kernel there).

Layout ``(B, S, H, D)``; :func:`ring_attention` takes the global q, k, v as
``DTensor``s on the mesh (or plain tensors, each rank holding the whole
array) and returns the same kind.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .sharding import mesh_axis_sizes
from .spmd import _Hop

__all__ = ["ring_attention"]

_NEG_INF = float("-inf")


def _block_contrib(q, k, v, q_off, k_off, causal):
    """One k/v block's unnormalized contribution (GQA-aware).

    q ``(B, Sq, Hq, D)``; k/v ``(B, Sk, Hkv, D)``.  Returns ``(num (B, Sq,
    Hq, D) f32, m (B, Sq, Hq, 1) f32, l (B, Sq, Hq, 1) f32)`` where ``num =
    exp(logits - m) @ v``, ``m`` the row max, ``l`` the row sum.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    scale = 1.0 / (d**0.5)
    qg = q.reshape(b, sq, hkv, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, k).float() * scale
    if causal:
        logits = logits.masked_fill(~_mask(q_off, sq, k_off, sk, q.device), _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    finite = torch.isfinite(m)
    p = torch.exp(logits - torch.where(finite, m, 0.0))
    p = torch.where(torch.isfinite(logits), p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    num = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    m = torch.where(finite, m, _NEG_INF)
    return num.reshape(b, sq, hq, d), m.reshape(b, sq, hq, 1), l.reshape(b, sq, hq, 1)


def _mask(q_off, sq, k_off, sk, device):
    """``(1, Sq, 1, 1, Sk)``: key ``j`` visible to query ``i`` (global
    offsets)."""
    qi = q_off + torch.arange(sq, device=device)
    ki = k_off + torch.arange(sk, device=device)
    return (qi[:, None] >= ki[None, :])[None, :, None, None, :]


def _merge(acc, blk):
    """Online-softmax merge of two partial ``(num, m, l)`` triples."""
    num_a, m_a, l_a = acc
    num_b, m_b, l_b = blk
    m_new = torch.maximum(m_a, m_b)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.where(torch.isfinite(m_a), torch.exp(m_a - m_safe), 0.0)
    beta = torch.where(torch.isfinite(m_b), torch.exp(m_b - m_safe), 0.0)
    return num_a * alpha + num_b * beta, m_new, l_a * alpha + l_b * beta


def _block_grads(q, k, v, do, lse, delta, q_off, k_off, causal):
    """``(dq, dk, dv)`` f32 of one (q part, k/v block) pair, from the
    forward's final ``lse`` and ``delta = rowsum(do * out)``: the
    transpose of :func:`_block_contrib` + :func:`_merge`."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    scale = 1.0 / (d**0.5)
    qg = q.reshape(b, sq, hkv, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, k).float() * scale
    p = torch.exp(logits - lse.reshape(b, sq, hkv, groups, 1))
    if causal:
        p = p.masked_fill(~_mask(q_off, sq, k_off, sk, q.device), 0.0)
    dog = do.reshape(b, sq, hkv, groups, d)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, v.float())
    ds = p * (dp - delta.reshape(b, sq, hkv, groups, 1)) * scale
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, k.float()).reshape(b, sq, hq, d)
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qg.float())
    return dq, dk, dv


def _pairs(src, idx, n, sl, causal, zigzag):
    """The ``(q part, k part, causal, q_off, k_off)`` pairs that rank ``idx``
    computes against block ``src``, in the JAX ring's order.  Contiguous:
    one part each, offsets global.  Zigzag: part 0 is the early half and 1
    the late one; q's late half sees k's early half at every step, and the
    rest by the case analysis of the JAX ``_zigzag_ring_body``."""
    if zigzag:
        pairs = [(1, 0, False)]
        if src < idx:
            pairs.append((0, 0, False))
        elif src == idx:
            pairs += [(0, 0, True), (1, 1, True)]
        else:
            pairs.append((1, 1, False))
        return [(qi, ki, c, 0, 0) for qi, ki, c in pairs]
    if causal and src > idx:
        return []
    return [(0, 0, causal, idx * sl, src * sl)]


def _parts(x, zigzag):
    return list(x.chunk(2, dim=1)) if zigzag else [x]


class _Ring(torch.autograd.Function):
    """Ring attention of this rank's q, k, v blocks over ``group``."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, zigzag):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        b, sl, hq, d = q.shape
        q_parts = _parts(q, zigzag)
        accs = [(torch.zeros(p.shape, dtype=torch.float32, device=q.device),
                 torch.full(p.shape[:3] + (1,), _NEG_INF, device=q.device),
                 torch.zeros(p.shape[:3] + (1,), dtype=torch.float32, device=q.device))
                for p in q_parts]
        k_blk, v_blk = k, v
        for t in range(n):
            hop = _Hop([k_blk, v_blk], group, n, idx) if t < n - 1 else None
            src = (idx - t) % n
            k_parts, v_parts = _parts(k_blk, zigzag), _parts(v_blk, zigzag)
            for qi, ki, c, q_off, k_off in _pairs(src, idx, n, sl, causal, zigzag):
                accs[qi] = _merge(accs[qi], _block_contrib(
                    q_parts[qi], k_parts[ki], v_parts[ki], q_off, k_off, c))
            if hop is not None:
                k_blk, v_blk = hop.wait()
        out = torch.cat([num / torch.clamp(l, min=1e-30) for num, _, l in accs], dim=1)
        lse = torch.cat([torch.where(l > 0, m + torch.log(l), float("inf"))
                         for _, m, l in accs], dim=1)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.zigzag = group, causal, zigzag
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, zigzag = ctx.group, ctx.causal, ctx.zigzag
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        sl = q.shape[1]
        do = do.float()
        delta = (do * out.float()).sum(dim=-1, keepdim=True)
        q_parts, do_parts = _parts(q, zigzag), _parts(do, zigzag)
        lse_parts, delta_parts = _parts(lse, zigzag), _parts(delta, zigzag)
        dq_parts = [torch.zeros(p.shape, dtype=torch.float32, device=q.device)
                    for p in q_parts]
        k_blk, v_blk = k, v
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for t in range(n):
            src = (idx - t) % n
            k_parts, v_parts = _parts(k_blk, zigzag), _parts(v_blk, zigzag)
            dk_parts, dv_parts = _parts(dk_blk, zigzag), _parts(dv_blk, zigzag)
            for qi, ki, c, q_off, k_off in _pairs(src, idx, n, sl, causal, zigzag):
                dq, dk, dv = _block_grads(q_parts[qi], k_parts[ki], v_parts[ki],
                                          do_parts[qi], lse_parts[qi], delta_parts[qi],
                                          q_off, k_off, c)
                dq_parts[qi] += dq
                dk_parts[ki] += dk
                dv_parts[ki] += dv
            if n > 1:
                # dk and dv travel on with their block; after n hops they
                # are back with the rank that owns it.
                moving = [dk_blk, dv_blk] + ([k_blk, v_blk] if t < n - 1 else [])
                got = _Hop(moving, group, n, idx).wait()
                dk_blk, dv_blk = got[0], got[1]
                if t < n - 1:
                    k_blk, v_blk = got[2], got[3]
        dq = torch.cat(dq_parts, dim=1)
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), None, None, None)


def _zigzag_perm(s: int, n: int):
    """Global sequence permutation placing halves ``(i, 2n-1-i)`` on rank
    ``i``.  Returns ``(perm, inv)`` index tensors (int64): ``x_zig = x[:,
    perm]`` and ``x = x_zig[:, inv]``."""
    if s % (2 * n):
        raise ValueError(f"zigzag needs seq {s} divisible by 2·sp={2 * n}")
    h = s // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * h, (i + 1) * h))
        order.extend(range((2 * n - 1 - i) * h, (2 * n - i) * h))
    perm = torch.tensor(order, dtype=torch.int64)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(s)
    return perm, inv


def _placements(mesh, axis, batch, heads):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if a in batch else Shard(1) if a == axis else
            Shard(2) if a in heads else Replicate() for a in mesh.mesh_dim_names]


def _as_dtensor(x, mesh):
    """A plain tensor is the whole array on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _take_seq(x, index, mesh):
    """``x[:, index]`` of a global ``DTensor``: the sequence gathered, taken,
    left replicated (the ring reshards it)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
             for p in x.placements]
    full = x.redistribute(mesh, whole).to_local()
    return DTensor.from_local(full.index_select(1, index.to(full.device)), mesh, whole,
                              run_check=False)


def _ring_sharded(q, k, v, mesh, axis, causal, zigzag, placements):
    from torch.distributed.tensor import DTensor

    local = []
    for x in (q, k, v):
        if list(x.placements) != placements:
            x = x.redistribute(mesh, placements)
        local.append(x.to_local())
    out = _Ring.apply(*local, mesh.get_group(axis), causal, zigzag)
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=q.shape,
                              stride=q.stride())


def ring_attention(
    q,
    k,
    v,
    *,
    mesh,
    axis: str = "sp",
    causal: bool = True,
    batch_axes: Sequence[str] = ("dp", "fsdp"),
    head_axes: Sequence[str] = ("tp",),
    schedule: str = "contiguous",
    pre_permuted: bool = False,
):
    """Sequence-parallel attention.  Layout ``(B, S, H, D)`` (global shapes).

    ``q``/``k``/``v`` are ``DTensor``s on ``mesh`` (any placements: they
    are placed ``(batch_axes, axis, head_axes, -)``, as the JAX ring's
    ``P(batch, sp, heads, None)``, and the result carries that placement),
    or plain tensors holding the whole arrays on every rank (the result is
    then the whole output, a plain tensor).  Names in ``batch_axes`` /
    ``head_axes`` that ``mesh`` lacks are ignored.

    ``schedule``: ``"contiguous"`` (default) or ``"zigzag"``, the
    load-balanced causal schedule (see the module docstring); it needs
    ``causal=True`` and a sequence divisible by ``2·sp``.  Zigzag permutes
    q/k/v into zigzag order and the output back on each call;
    ``pre_permuted=True`` skips that: the caller keeps the whole model's
    activations in zigzag order (``models.llama``'s
    ``seq_layout="zigzag"``), and the output stays in zigzag order.
    """
    names = set(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {mesh.mesh_dim_names})")
    zigzag = schedule == "zigzag"
    if zigzag:
        if not causal:
            raise ValueError("zigzag schedule is a causal-only optimization")
        n = mesh_axis_sizes(mesh)[axis]
        s = q.shape[1]
        if s % (2 * n):
            raise ValueError(f"zigzag needs seq {s} divisible by 2·{axis}={2 * n}")
    elif schedule != "contiguous":
        raise ValueError(f"unknown schedule: {schedule!r}")
    elif pre_permuted:
        raise ValueError("pre_permuted requires schedule='zigzag'")
    plain = not hasattr(q, "placements")
    q, k, v = (_as_dtensor(x, mesh) for x in (q, k, v))
    batch = tuple(a for a in batch_axes if a in names)
    heads = tuple(a for a in head_axes if a in names)
    placements = _placements(mesh, axis, batch, heads)
    if zigzag and not pre_permuted:
        perm, inv = _zigzag_perm(s, n)
        qz, kz, vz = (_take_seq(x, perm, mesh) for x in (q, k, v))
        out = _take_seq(_ring_sharded(qz, kz, vz, mesh, axis, True, True, placements),
                        inv, mesh)
    else:
        out = _ring_sharded(q, k, v, mesh, axis, causal, zigzag, placements)
    return out.full_tensor() if plain else out
