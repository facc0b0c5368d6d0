"""Mixture-of-Experts Llama variant as a PyTorch module.

Counterpart of ``torchdistx_tpu/models/moe.py``: Llama blocks (the port's
RMSNorm, RoPE and GQA attention) with the dense FFN replaced by a top-k
routed expert FFN.  A router scores E experts per token, the top k are
taken with renormalized gates, each (token, choice) gets a position in its
expert's fixed-capacity buffer by a running count in token-major order,
choices past the capacity are dropped, the experts run as batched products
over the expert dim, and the outputs are combined gate-weighted.  A
load-balancing aux loss (the mean over layers of E * sum_e f_e * p_e, f
counting all k choices) is added to the loss with ``router_aux_coef``.

Under a pipeline (``pp_axis=``, :func:`pp_value_and_grad`) the router's
aux loss rides the pipelined activation as a second leaf, one value per
row (each row of a microbatch carries its microbatch's running sum over the
layers), and routing and capacity are per microbatch, as in JAX.  On a mesh
(``mesh=``, ``seq_axis=``) the attention half computes as Llama's (see
:mod:`~torchdistx_tpu_torch.models.llama`), and each layer routes on every
rank over all the tokens (gathered over the data axes), so that the
capacity and the positions are the global batch's, as under the JAX
``jit``; each rank keeps its rows.  Expert weights keep the JAX layout
``(E, in, out)``, so the products are plain ``bmm``; the router is an
``nn.Linear`` like the other projections.

Expert parallelism (a mesh with an ``ep`` axis, :func:`param_specs`'
layout): each rank holds its ``E / ep`` experts of every layer, and
:func:`moe_ffn_ep` moves rows to them: the ``ep`` ranks of a data block
hold the same tokens (the batch is not split over ``ep``), so each takes
the ``1 / ep`` contiguous share of them of its ``ep`` coordinate, sends its
share's kept choices to their experts' owners and gets their outputs back
by ``all_to_all_single`` over the ``ep`` group (the collective that XLA's
partitioner makes of the JAX dispatch and combine einsums), and the
shares' outputs are gathered over ``ep`` again.  Routing stays the global
one, so ``experts``, ``pos`` and ``keep`` are the JAX values exactly and a
dropped choice is never sent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..parallel.pipeline import (
    contiguous_rows,
    layer_grads,
    pipeline_forward,
    pipeline_value_and_grad,
    stage_blocks,
    stage_context,
    stage_inputs,
    stage_specs,
)
from ..parallel.sharding import PartitionSpec as P
from ..parallel.spmd import SINGLE, local_inputs
from . import llama as llama_mod
from .llama import LlamaConfig, RMSNorm, _rope_tables, _stage_positions

__all__ = [
    "MoEConfig",
    "moe_test",
    "num_params",
    "param_specs",
    "route",
    "moe_ffn",
    "moe_ffn_ep",
    "pp_pieces",
    "pp_value_and_grad",
    "MoE",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


def moe_test() -> MoEConfig:
    return MoEConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
        max_seq_len=128, dtype=torch.float32, remat=False, n_experts=4,
        experts_per_token=2,
    )


def num_params(cfg: MoEConfig) -> int:
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    per_layer = 2 * d + d * hq + 2 * d * hkv + hq * d + d * e + 3 * e * d * f
    return 2 * cfg.vocab_size * d + d + cfg.n_layers * per_layer


def param_specs(cfg: MoEConfig, *, tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp",
                ep: Optional[str] = "ep", pp: Optional[str] = None) -> Dict[str, P]:
    """Partition specs of :class:`MoE`'s parameters, by name: the Llama
    specs for the attention half, the router replicated, and the experts
    over ``ep`` (the JAX ``(ep, fsdp, tp)`` / ``(ep, tp, fsdp)``, in the
    same layout, since the expert weights keep it); ``pp`` gives each
    layer to its pipeline stage."""
    specs = {k: v for k, v in llama_mod.param_specs(cfg, tp=tp, fsdp=fsdp).items()
             if not k.endswith(("w_gate.weight", "w_up.weight", "w_down.weight"))}
    for i in range(cfg.n_layers):
        specs[f"layers.{i}.router.weight"] = P()
        specs[f"layers.{i}.e_gate"] = P(ep, fsdp, tp)
        specs[f"layers.{i}.e_up"] = P(ep, fsdp, tp)
        specs[f"layers.{i}.e_down"] = P(ep, tp, fsdp)
    return specs if pp is None else stage_specs(specs, pp=pp)


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = math.ceil(cfg.capacity_factor * n_tokens * cfg.experts_per_token / cfg.n_experts)
    return max(int(cap), 1)


class Routing(NamedTuple):
    """One layer's routing of ``T`` tokens: ``probs (T, E)`` f32, the
    renormalized ``gates (T, K)``, the ``experts (T, K)`` chosen, each
    choice's ``pos (T, K)`` in its expert's buffer, ``keep (T, K)`` (pos
    below ``capacity``)."""

    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(h, router_w, cfg: MoEConfig) -> Routing:
    """The router's choices for ``h (B, S, D)`` (``router_w`` is the
    ``nn.Linear`` weight ``(E, D)``).

    The top k come from a stable descending sort, so equal probabilities
    pick the lower expert first, as ``jax.lax.top_k`` does (``torch.topk``
    does not promise an order on ties).  Positions are integer counts and
    exact.
    """
    e, k = cfg.n_experts, cfg.experts_per_token
    ht = h.reshape(-1, h.shape[-1])
    t = ht.shape[0]
    probs = torch.softmax(F.linear(ht, router_w).float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :k], idx[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    flat = F.one_hot(experts.reshape(t * k), e)
    pos = ((flat.cumsum(0) - 1) * flat).sum(-1).reshape(t, k)
    cap = _capacity(cfg, t)
    return Routing(probs, gates, experts, pos, pos < cap, cap)


def _route_and_aux(h, router_w, cfg: MoEConfig):
    """:func:`route` and the load-balancing aux loss (E * sum_e f_e * p_e,
    f counting all k choices) of ``h (B, S, D)``."""
    r = route(h, router_w, cfg)
    frac = F.one_hot(r.experts, cfg.n_experts).float().sum(dim=1).mean(dim=0)
    frac = frac / cfg.experts_per_token
    return r, cfg.n_experts * (frac * r.probs.mean(dim=0)).sum()


def _expert(x, w_gate, w_up, w_down):
    """The SiLU-gated expert FFN, batched over a leading expert dim or of
    one expert."""
    mm = torch.bmm if x.dim() == 3 else torch.mm
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def moe_ffn(h, router_w, e_gate, e_up, e_down, cfg: MoEConfig):
    """Top-k routed expert FFN: ``h (B, S, D)`` -> ``(out (B, S, D), aux)``.

    ``e_gate``/``e_up`` are ``(E, D, F)``, ``e_down`` ``(E, F, D)``.  The
    dispatch copies each kept choice into its own slot of an ``(E, C, D)``
    buffer; every dropped choice goes to one extra row that is cut off, so
    no slot takes two writes (no atomics) and each holds exactly its
    token, as the JAX ``.at[].add`` of the kept row and zeros does.  The
    combine gathers each choice's slot (a dropped one reads slot ``C - 1``
    with weight 0, as in JAX), so the gather's backward adds into a slot one
    kept choice's gradient and zeros only: exact in any order.

    The phases run in ``torch.profiler`` ranges named ``moe.route``,
    ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` (for a profile's
    attribution only, as the JAX package's ``jax.named_scope`` regions).
    """
    b, s, d = h.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    ht = h.reshape(b * s, d)
    with record_function("moe.route"):
        r, aux = _route_and_aux(h, router_w, cfg)
        cap = r.capacity
        experts, keep = r.experts.reshape(-1), r.keep.reshape(-1)
        slot = experts * cap + r.pos.reshape(-1).clamp(max=cap - 1)
    with record_function("moe.dispatch"):
        dump = torch.where(keep, slot, e * cap)
        dispatch = ht.new_zeros(e * cap + 1, d).index_copy(
            0, dump, ht.repeat_interleave(k, dim=0))[:-1].view(e, cap, d)
    with record_function("moe.experts"):
        expert_out = _expert(dispatch, e_gate, e_up, e_down).reshape(e * cap, d)
    with record_function("moe.combine"):
        weights = (r.gates.reshape(-1) * keep).to(ht.dtype)
        out = (expert_out[slot] * weights[:, None]).reshape(b * s, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux


def moe_ffn_ep(h, router_w, e_gate, e_up, e_down, cfg: MoEConfig, ctx):
    """:func:`moe_ffn` of this rank's block ``h (b, s, D)`` under an ``ep``
    axis of ``ctx`` (an ``SpmdContext``): ``(out (b, s, D), aux)``, with
    ``e_gate``/``e_up``/``e_down`` this rank's ``E / ep`` experts.

    Routing is the global batch's on every rank (the tokens gathered over
    the data axes), the same bits everywhere.  The ``ep`` ranks of a block
    hold the same ``T`` tokens; rank ``j`` takes the contiguous ``T / ep``
    of coordinate ``j`` (an even split of the tokens, so of the rows sent
    on average, with no exchange needed to agree on it), sorts its share's
    kept choices by expert (dropped ones are never sent), swaps the
    per-expert counts with the group (one ``all_to_all_single`` of ``E``
    counts), sends the rows to the experts' owners and gets their outputs
    back by ``all_to_all_single`` (whose backward is the transposed
    exchange).  An owner runs each of its experts on the rows it got,
    grouped by expert.  The combine weights each choice's output by its
    gate as :func:`moe_ffn` does, a dropped choice by 0, and the shares'
    outputs are gathered over ``ep``.  The counts are read on the host
    once a layer (the split sizes)."""
    b, s, d = h.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    n_ep, e_loc = ctx.ep_size, e_gate.shape[0]
    t = b * s
    if e % n_ep or e_loc != e // n_ep:
        raise ValueError(f"{e} experts do not split over ep={n_ep} "
                         f"(this rank holds {e_loc})")
    if t % n_ep:
        raise ValueError(f"a rank's {t} tokens do not split over ep={n_ep}")
    t_s = t // n_ep
    with record_function("moe.route"):
        h_all = ctx.gather_tokens(h)
        r, aux = _route_and_aux(h_all, router_w, cfg)
        block = [ctx.local_tokens(x.reshape(h_all.shape[:2] + (k,)), h).reshape(t, k)
                 for x in (r.experts, r.keep, r.gates)]
        start = ctx.mesh.get_local_rank(ctx.ep) * t_s
        experts, keep = (x.narrow(0, start, t_s).reshape(-1) for x in block[:2])
        gates = ctx.ep_share(block[2]).reshape(-1)
    with record_function("moe.dispatch"):
        # Kept choices by expert, then the dropped ones (never sent).
        key = torch.where(keep, experts, e)
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=e + 1)[:e]
        got = ctx.ep_counts(counts).view(n_ep, e_loc)  # rows from each rank, per expert
        sizes = torch.cat([counts.view(n_ep, e_loc).sum(1), got.sum(1), got.sum(0)]).tolist()
        send, recv, per_expert = sizes[:n_ep], sizes[n_ep:2 * n_ep], sizes[2 * n_ep:]
        sent = order[:sum(send)]
        rows = ctx.ep_exchange(ctx.ep_share(h.reshape(t, d))[sent // k], send, recv)
        # The rows arrive by sender, then by expert: grouped by expert here.
        local = torch.arange(e_loc, device=h.device).repeat(n_ep)
        group = torch.argsort(torch.repeat_interleave(local, got.reshape(-1)), stable=True)
    with record_function("moe.experts"):
        outs = [_expert(x, e_gate[j], e_up[j], e_down[j])
                for j, x in enumerate(rows[group].split(per_expert))]
        y = torch.cat(outs).index_select(0, torch.argsort(group))
        back = ctx.ep_exchange(y, recv, send)
    with record_function("moe.combine"):
        out = back.new_zeros(t_s * k, d).index_copy(0, sent, back)
        weights = (gates * keep).to(h.dtype)
        out = (out * weights[:, None]).reshape(t_s, k, d).sum(dim=1)
    return ctx.ep_gather(out).reshape(b, s, d), aux


class MoEBlock(llama_mod.Block):
    """A Llama block whose feed-forward half is :func:`moe_ffn` (or, under
    an ``ep`` axis, :func:`moe_ffn_ep`); returns ``(x, aux)``."""

    def _build_mlp(self, cfg: MoEConfig, kw: dict) -> None:
        d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts
        self.router = nn.Linear(d, e, **kw)  # kw: bias=False, dtype, device
        like = dict(dtype=kw["dtype"], device=kw["device"])
        self.e_gate = nn.Parameter(torch.empty(e, d, f, **like))
        self.e_up = nn.Parameter(torch.empty(e, d, f, **like))
        self.e_down = nn.Parameter(torch.empty(e, f, d, **like))

    def forward(self, x, cos, sin, attn_impl: str = "auto", ctx=SINGLE,
                pre_permuted: bool = False):
        x = self.attend(x, cos, sin, attn_impl, ctx, pre_permuted)
        h = self.mlp_norm(x, ctx)
        router = ctx.weight(self.router.weight)
        stacks = [ctx.weight(w, experts=True) for w in (self.e_gate, self.e_up, self.e_down)]
        if ctx.ep_size > 1:
            out, aux = moe_ffn_ep(h, router, *stacks, self.cfg, ctx)
            return x + out, aux
        out, aux = moe_ffn(ctx.gather_tokens(h), router, *stacks, self.cfg)
        return x + ctx.local_tokens(out, h), aux


class MoE(nn.Module):
    """The MoE decoder.  ``device=None`` means CUDA.

    Initialization as the JAX ``init_params``: N(0, 0.02) for embeddings,
    projections, router and experts, 0.02/sqrt(2 n_layers) for ``wo`` and
    ``e_down``, ones for the norms.  Parameter names are the port's Llama
    names, with ``router.weight``, ``e_gate``, ``e_up`` and ``e_down`` in
    each layer for ``w_gate``/``w_up``/``w_down``.
    """

    def __init__(self, cfg: MoEConfig, *, device: Optional[Any] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.layers = nn.ModuleList(MoEBlock(cfg, device=device) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **kw)
        self._init_weights()

    @torch.no_grad()
    def _init_weights(self) -> None:
        std = 0.02
        resid_std = 0.02 / math.sqrt(2.0 * self.cfg.n_layers)
        nn.init.normal_(self.embed.weight, 0.0, std)
        for blk in self.layers:
            for w in (blk.wq.weight, blk.wk.weight, blk.wv.weight, blk.router.weight,
                      blk.e_gate, blk.e_up):
                nn.init.normal_(w, 0.0, std)
            for w in (blk.wo.weight, blk.e_down):
                nn.init.normal_(w, 0.0, resid_std)
        nn.init.normal_(self.lm_head.weight, 0.0, std)

    def _hidden(self, tokens, attn_impl: str, ctx=SINGLE, positions=None):
        """The blocks' output before the final norm, and the sum of the
        layers' aux losses (f32)."""
        cfg = self.cfg
        x = F.embedding(tokens, ctx.weight(self.embed.weight))
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim // 2, x.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            if remat:
                x, aux = checkpoint(blk, x, cos, sin, attn_impl, ctx, use_reentrant=False)
            else:
                x, aux = blk(x, cos, sin, attn_impl, ctx)
            aux_sum = aux_sum + aux
        return x, aux_sum

    def _run(self, tokens, targets, attn_impl, mesh, seq_axis, pp_axis=None,
             n_microbatches=1, axes=None):
        axes = axes or {}
        if pp_axis is not None:
            ctx, tokens, targets, impl = stage_inputs(
                tokens, targets, mesh=mesh, axis=pp_axis, n_microbatches=n_microbatches,
                attn_impl=attn_impl, seq_axis=seq_axis, **axes)
            x, aux_sum = self._stage_hidden(tokens, impl, ctx, mesh, pp_axis, n_microbatches)
        else:
            ctx, tokens, targets, positions, attn_impl, _ = local_inputs(
                tokens, targets, mesh=mesh, seq_axis=seq_axis, attn_impl=attn_impl, **axes)
            x, aux_sum = self._hidden(tokens, attn_impl, ctx, positions)
        logits = F.linear(self.norm(x, ctx), ctx.weight(self.lm_head.weight)).float()
        return ctx, targets, logits, aux_sum / self.cfg.n_layers

    def _stage_hidden(self, tokens, attn_impl, ctx, mesh, pp_axis, n_microbatches):
        """The blocks' output through the GPipe pipeline, and the mean over
        rows of each row's aux sum (the microbatches' mean: routing and
        capacity are per microbatch, as in JAX)."""
        cfg = self.cfg
        x = F.embedding(tokens, ctx.weight(self.embed.weight))
        cos, sin = _rope_tables(_stage_positions(tokens, ctx), cfg.rope_theta,
                                cfg.head_dim // 2, x.dtype)
        _, blocks = stage_blocks(self.layers, mesh, pp_axis)
        act = {"h": x, "aux": torch.zeros(x.shape[0], 1, dtype=torch.float32, device=x.device)}
        out = pipeline_forward(act, blocks, _pp_block(cos, sin, attn_impl, ctx), mesh=mesh,
                               axis=pp_axis, n_microbatches=n_microbatches)
        return out["h"], out["aux"].mean()

    def forward(self, tokens, attn_impl: str = "auto", return_aux: bool = False, *,
                mesh=None, seq_axis: Optional[str] = None, pp_axis: Optional[str] = None,
                n_microbatches: int = 1, tp: Optional[str] = "tp",
                fsdp: Optional[str] = "fsdp"):
        """Token ids ``(B, S)`` -> logits ``(B, S, V)`` float32; with
        ``return_aux`` also the aux loss averaged over layers.  With
        ``mesh``, ``tokens`` is the global batch on every rank and the
        logits are a ``DTensor`` (this rank's rows and columns), the experts
        over the mesh's ``ep`` axis if it has one; ``pp_axis`` /
        ``n_microbatches`` run the blocks through the GPipe pipeline (as
        Llama's ``forward``; routing per microbatch); ``tp`` / ``fsdp``
        name the mesh axes of those roles."""
        ctx, _, logits, aux = self._run(tokens, None, attn_impl, mesh, seq_axis, pp_axis,
                                        n_microbatches, {"tp": tp, "fsdp": fsdp})
        if pp_axis is not None:
            logits = contiguous_rows(logits, ctx, n_microbatches)
        if ctx is not SINGLE:
            logits = ctx.dtensor(logits, ctx.placements(heads=False))
        return (logits, aux) if return_aux else logits

    def loss(self, tokens, targets, attn_impl: str = "auto", *, mesh=None,
             seq_axis: Optional[str] = None, pp_axis: Optional[str] = None,
             n_microbatches: int = 1, tp: Optional[str] = "tp",
             fsdp: Optional[str] = "fsdp"):
        """Mean next-token cross-entropy plus ``router_aux_coef`` times the
        aux loss (the JAX ``loss_fn``), f32 scalar; with ``mesh``, the
        global batch's on every rank; ``pp_axis``, ``tp`` and ``fsdp`` as in
        :meth:`forward`."""
        ctx, targets, logits, aux = self._run(tokens, targets, attn_impl, mesh, seq_axis,
                                              pp_axis, n_microbatches, {"tp": tp, "fsdp": fsdp})
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets[..., None])[..., 0]
        if ctx is SINGLE:
            return nll.mean() + self.cfg.router_aux_coef * aux
        return ctx.loss(nll.sum(), nll.numel() * ctx.n_reduce,
                        replicated=self.cfg.router_aux_coef * aux)


def _pp_block(cos, sin, attn_impl, ctx):
    """One MoE block over the pipelined activation ``{"h", "aux"}``: the
    layer's aux loss added to every row's running sum."""

    def block(act, blk):
        h, aux = blk(act["h"], cos, sin, attn_impl, ctx)
        return {"h": h, "aux": act["aux"] + aux}

    return block


# ---------------------------------------------------------------------------
# 1F1B pipeline pieces: the aux channel rides the pipeline beside the hidden
# state; the last stage folds it into the loss.


def pp_pieces(model, *, mesh=None, pp_axis: str = "pp", attn_impl: str = "auto",
              tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
    """``(embed_fn, block_fn, head_loss_fn)`` of ``model`` for the 1F1B
    schedule, as Llama's, over the activation ``{"h", "aux"}``; the head's
    loss adds ``router_aux_coef`` times the microbatch's aux sum over the
    layers, averaged per layer, as :meth:`MoE.loss` does."""
    from ..ops.attention import resolve_stage_attn_impl

    cfg = model.cfg
    ctx, rows = stage_context(mesh, pp_axis, tp=tp, fsdp=fsdp)
    rope = llama_mod._rope_cache(cfg)

    def embed_fn(ep, tokens_mb):
        x = F.embedding(rows(tokens_mb), ctx.weight(ep["embed.weight"]))
        return {"h": x, "aux": torch.zeros(x.shape[0], 1, dtype=torch.float32, device=x.device)}

    def block_fn(act, blk):
        h = act["h"]
        impl = resolve_stage_attn_impl(attn_impl, cuda=h.is_cuda)
        return _pp_block(*rope(h), impl, ctx)(act, blk)

    def head_loss_fn(hp, act, targets_mb):
        logits = F.linear(model.norm(act["h"], ctx), ctx.weight(hp["lm_head.weight"])).float()
        targets = rows(targets_mb)
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets[..., None])[..., 0]
        aux = cfg.router_aux_coef * act["aux"].mean() / cfg.n_layers
        if ctx is SINGLE:
            return nll.mean() + aux
        return ctx.loss(nll.sum(), nll.numel() * ctx.n_reduce, replicated=aux)

    return embed_fn, block_fn, head_loss_fn


def pp_value_and_grad(model, tokens, targets, *, mesh, pp_axis: str = "pp",
                      n_microbatches: int = 1, attn_impl: str = "auto",
                      tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
    """``(loss, grads)`` of ``model`` by the 1F1B pipeline, as Llama's;
    routing and capacity per microbatch, as in the GPipe path (the experts
    over ``ep`` as there)."""
    embed_fn, block_fn, head_loss_fn = pp_pieces(model, mesh=mesh, pp_axis=pp_axis,
                                                 attn_impl=attn_impl, tp=tp, fsdp=fsdp)
    first, blocks = stage_blocks(model.layers, mesh, pp_axis)
    loss, (g_ep, g_lp, g_hp) = pipeline_value_and_grad(
        {"embed.weight": model.embed.weight}, blocks,
        {"norm.weight": model.norm.weight, "lm_head.weight": model.lm_head.weight},
        tokens, targets, embed_fn, block_fn, head_loss_fn,
        mesh=mesh, axis=pp_axis, n_microbatches=n_microbatches)
    return loss, {**g_ep, **g_hp, **layer_grads(first, g_lp)}
