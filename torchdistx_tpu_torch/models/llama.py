"""Llama-2-family decoder as a PyTorch module.

Counterpart of ``torchdistx_tpu/models/llama.py``: the same configurations,
initialization statistics and arithmetic (RMSNorm in f32 then cast, RoPE on
split halves, GQA, SiLU-gated MLP, head in ``cfg.dtype`` then f32 logits),
with the blocks in an ``nn.ModuleList`` and the projections as
``nn.Linear`` (weights stored ``(out, in)``).  Attention goes through
:func:`~torchdistx_tpu_torch.ops.attention.attention`: the hand-written
flash kernel on CUDA tensors.

The module computes in its parameters' dtype (``cfg.dtype`` as built;
``model.float()`` makes a float32 model of the same weights).

Training: :meth:`Llama.loss` is the mean next-token cross-entropy of the
JAX ``loss_fn``.  With ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` when gradients are on, so its activations are
recomputed in the backward (the flash forward then runs twice per layer).

On a mesh (``mesh=``, ``seq_axis=``, ``seq_layout=``, as the JAX
``forward`` / ``loss_fn``), the parameters are ``DTensor``s placed by
:func:`param_specs` and each rank computes its block of the global batch
through a :class:`~torchdistx_tpu_torch.parallel.spmd.SpmdContext`:
Megatron tensor parallelism over ``tp`` (the projections column- and
row-parallel, attention on the rank's heads, when ``tp`` divides both head
counts), the batch over ``dp``/``fsdp``, the sequence over ``seq_axis``
(ring attention; RoPE at each column's global position).

Decoding (:meth:`Llama.forward_cached`) fuses ``wq|wk|wv`` and
``w_gate|w_up`` (:meth:`Llama.prep_decode`) and updates the KV cache in
place, which keeps one cache in memory instead of a copy per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.attention import cached_attention
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

__all__ = [
    "LlamaConfig",
    "llama_test",
    "llama_tiny",
    "llama_7b",
    "llama_70b",
    "num_params",
    "param_specs",
    "pp_pieces",
    "pp_value_and_grad",
    "Llama",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX ``LlamaConfig``'s fields.  ``remat`` recomputes each block's
    activations in the backward (``jax.checkpoint`` there,
    ``torch.utils.checkpoint`` here).  The JAX ``layer_unroll`` tunes a
    ``jax.lax.scan`` and has no meaning for an eager loop over layers, so
    it has no counterpart."""

    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def llama_test() -> LlamaConfig:
    """CI-sized config: big enough to exercise GQA."""
    return LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=128, dtype=torch.float32, remat=False,
    )


def llama_tiny() -> LlamaConfig:
    """About 15M params."""
    return LlamaConfig(
        vocab_size=32000, dim=256, n_layers=4, n_heads=8, n_kv_heads=8,
        ffn_dim=688, max_seq_len=2048,
    )


def llama_7b() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
        ffn_dim=11008, max_seq_len=4096,
    )


def llama_70b() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=32000, dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        ffn_dim=28672, max_seq_len=4096,
    )


def num_params(cfg: LlamaConfig) -> int:
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    per_layer = 2 * d + d * hq + 2 * d * hkv + hq * d + 3 * d * f
    return 2 * v * d + d + cfg.n_layers * per_layer


def param_specs(cfg: LlamaConfig, *, tp: Optional[str] = "tp",
                fsdp: Optional[str] = "fsdp", pp: Optional[str] = None) -> Dict[str, P]:
    """Megatron-TP + FSDP partition specs of :class:`Llama`'s parameters, by
    name: a plan for
    :func:`~torchdistx_tpu_torch.materialize.materialize_module_torch`.

    The JAX ``param_specs``' layout on this module's names: column-parallel
    projections (wq/wk/wv/w_gate/w_up) shard their out dim over ``tp``,
    row-parallel ones (wo/w_down) their in dim, the other large dim goes
    over ``fsdp``, norms replicate.  ``nn.Linear`` weights are ``(out,
    in)`` where the JAX leaves are ``(in, out)`` (the transpose that
    ``models/convert.py`` applies), so each spec is the JAX leaf's with its
    two matrix dims swapped, and the JAX stacked layer axis (its ``pp``
    entry) is dropped: every layer has its own parameters here.  ``pp``
    (if given) gives each layer to its pipeline stage over that axis
    (:func:`~torchdistx_tpu_torch.parallel.pipeline.stage_specs`).
    """
    column, row = P(tp, fsdp), P(fsdp, tp)
    specs = {"embed.weight": P(fsdp, tp)}
    for i in range(cfg.n_layers):
        for norm in ("attn_norm", "mlp_norm"):
            specs[f"layers.{i}.{norm}.weight"] = P()
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            specs[f"layers.{i}.{name}.weight"] = column
        for name in ("wo", "w_down"):
            specs[f"layers.{i}.{name}.weight"] = row
    specs["norm.weight"] = P()
    specs["lm_head.weight"] = P(tp, fsdp)
    return specs if pp is None else stage_specs(specs, pp=pp)


def _rmsnorm(x, weight, eps: float):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight.to(x.dtype)


def _rope_tables(positions, theta: float, half: int, dtype):
    """(cos, sin) of shape (B, S, 1, half), cast to ``dtype``."""
    freqs = 1.0 / (
        theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    )
    angles = positions[:, :, None].float() * freqs
    return (
        torch.cos(angles)[:, :, None, :].to(dtype),
        torch.sin(angles)[:, :, None, :].to(dtype),
    )


def _rope_apply(x, cos, sin):
    # Split halves, as the JAX model does.
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x, ctx=SINGLE):
        return _rmsnorm(x, ctx.weight(self.weight), self.eps)


class Block(nn.Module):
    """One transformer block: attention then SiLU-gated MLP, pre-norm."""

    def __init__(self, cfg: LlamaConfig, *, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        hq = cfg.n_heads * cfg.head_dim
        hkv = cfg.n_kv_heads * cfg.head_dim
        kw = dict(bias=False, dtype=cfg.dtype, device=device)
        self.attn_norm = RMSNorm(d, cfg.norm_eps, dtype=cfg.dtype, device=device)
        self.wq = nn.Linear(d, hq, **kw)
        self.wk = nn.Linear(d, hkv, **kw)
        self.wv = nn.Linear(d, hkv, **kw)
        self.wo = nn.Linear(hq, d, **kw)
        self.mlp_norm = RMSNorm(d, cfg.norm_eps, dtype=cfg.dtype, device=device)
        self._build_mlp(cfg, kw)

    def _build_mlp(self, cfg: LlamaConfig, kw: dict) -> None:
        """The feed-forward half's parameters (the MoE block replaces it)."""
        d, f = cfg.dim, cfg.ffn_dim
        self.w_gate = nn.Linear(d, f, **kw)
        self.w_up = nn.Linear(d, f, **kw)
        self.w_down = nn.Linear(f, d, **kw)

    def attend(self, x, cos, sin, attn_impl: str = "auto", ctx=SINGLE,
               pre_permuted: bool = False):
        """The attention half with its residual: ``x + wo(attn(norm(x)))``
        (on a mesh, ``ctx`` gives the local weights and collectives)."""
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        split = ctx.tp_divides(cfg.n_heads, cfg.n_kv_heads)
        col, row = (0, 1) if split else (None, None)
        h = self.attn_norm(x, ctx)
        if split:
            h = ctx.tp_copy(h)
        q = F.linear(h, ctx.weight(self.wq.weight, tp_dim=col)).reshape(b, s, -1, cfg.head_dim)
        k = F.linear(h, ctx.weight(self.wk.weight, tp_dim=col)).reshape(b, s, -1, cfg.head_dim)
        v = F.linear(h, ctx.weight(self.wv.weight, tp_dim=col)).reshape(b, s, -1, cfg.head_dim)
        q = _rope_apply(q, cos, sin)
        k = _rope_apply(k, cos, sin)
        attn = ctx.attention(q, k, v, heads=split, impl=attn_impl, pre_permuted=pre_permuted)
        out = F.linear(attn.reshape(b, s, -1), ctx.weight(self.wo.weight, tp_dim=row))
        return x + (ctx.tp_reduce(out) if split else out)

    def forward(self, x, cos, sin, attn_impl: str = "auto", ctx=SINGLE,
                pre_permuted: bool = False):
        cfg = self.cfg
        x = self.attend(x, cos, sin, attn_impl, ctx, pre_permuted)
        split = ctx.tp_divides(cfg.ffn_dim)
        col, row = (0, 1) if split else (None, None)
        h = self.mlp_norm(x, ctx)
        if split:
            h = ctx.tp_copy(h)
        gated = (F.silu(F.linear(h, ctx.weight(self.w_gate.weight, tp_dim=col)))
                 * F.linear(h, ctx.weight(self.w_up.weight, tp_dim=col)))
        out = F.linear(gated, ctx.weight(self.w_down.weight, tp_dim=row))
        return x + (ctx.tp_reduce(out) if split else out)


class Llama(nn.Module):
    """The decoder.  ``device=None`` means CUDA (see
    :func:`~torchdistx_tpu_torch.resolve_device`).

    Initialization as the JAX ``init_params``: N(0, 0.02) for embeddings
    and projections, 0.02/sqrt(2 n_layers) for ``wo`` and ``w_down``, ones
    for the norms; values are drawn from PyTorch's default generator of
    the device they land on.
    """

    def __init__(self, cfg: LlamaConfig, *, device: Optional[Any] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.n_layers)
        )
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, **kw)
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **kw)
        self._init_weights()

    @torch.no_grad()
    def _init_weights(self) -> None:
        std = 0.02
        resid_std = 0.02 / math.sqrt(2.0 * self.cfg.n_layers)
        nn.init.normal_(self.embed.weight, 0.0, std)
        for blk in self.layers:
            for lin in (blk.wq, blk.wk, blk.wv, blk.w_gate, blk.w_up):
                nn.init.normal_(lin.weight, 0.0, std)
            for lin in (blk.wo, blk.w_down):
                nn.init.normal_(lin.weight, 0.0, resid_std)
        nn.init.normal_(self.lm_head.weight, 0.0, std)

    def _head(self, x):
        """Final norm and head in ``cfg.dtype``, then f32 logits."""
        return self.lm_head(self.norm(x)).float()

    def _hidden(self, tokens, attn_impl: str, ctx=SINGLE, positions=None,
                pre_permuted: bool = False):
        """The blocks' output ``(B, S, dim)`` before the final norm."""
        cfg = self.cfg
        x = F.embedding(tokens, ctx.weight(self.embed.weight))
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim // 2, x.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.layers:
            if remat:
                x = checkpoint(blk, x, cos, sin, attn_impl, ctx, pre_permuted,
                               use_reentrant=False)
            else:
                x = blk(x, cos, sin, attn_impl, ctx, pre_permuted)
        return x

    def _logits(self, x, ctx):
        """The head's logits in ``cfg.dtype`` (the whole vocabulary)."""
        return F.linear(self.norm(x, ctx), ctx.weight(self.lm_head.weight))

    def _stage_hidden(self, tokens, attn_impl, ctx, mesh, pp_axis, n_microbatches):
        """The blocks' output through the GPipe pipeline over ``pp_axis``
        (this rank's stage of them; ``tokens`` are its rows of each
        microbatch)."""
        cfg = self.cfg
        x = F.embedding(tokens, ctx.weight(self.embed.weight))
        cos, sin = _rope_tables(_stage_positions(tokens, ctx), cfg.rope_theta,
                                cfg.head_dim // 2, x.dtype)
        _, blocks = stage_blocks(self.layers, mesh, pp_axis)
        return pipeline_forward(x, blocks, lambda h, blk: blk(h, cos, sin, attn_impl, ctx),
                                mesh=mesh, axis=pp_axis, n_microbatches=n_microbatches)

    def forward(self, tokens, attn_impl: str = "auto", *, mesh=None,
                seq_axis: Optional[str] = None, seq_layout: str = "contiguous",
                pp_axis: Optional[str] = None, n_microbatches: int = 1,
                tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
        """Token ids ``(B, S)`` -> logits ``(B, S, V)`` float32.

        With ``mesh``, ``tokens`` is the global batch on every rank and the
        logits are a ``DTensor`` (this rank's rows and columns); under
        ``seq_layout="zigzag"`` they are in zigzag order, as in JAX (invert
        with ``parallel.ring_attention._zigzag_perm(S, sp)[1]``).
        ``pp_axis`` runs the blocks through the GPipe pipeline
        (:func:`~torchdistx_tpu_torch.parallel.pipeline.pipeline_forward`)
        with ``n_microbatches`` microbatches, each rank its stage; every
        rank returns the logits (a ``DTensor`` on the stage's mesh, or the
        whole tensor when ``pp`` is the mesh's only axis); with
        ``seq_axis`` each stage's attention is the ring over it.  ``tp`` /
        ``fsdp`` name the mesh axes of those roles (``None``: none)."""
        axes = {"tp": tp, "fsdp": fsdp}
        if pp_axis is not None:
            ctx, tokens, _, impl = stage_inputs(
                tokens, None, mesh=mesh, axis=pp_axis, n_microbatches=n_microbatches,
                attn_impl=attn_impl, seq_axis=seq_axis, seq_layout=seq_layout, **axes)
            x = self._stage_hidden(tokens, impl, ctx, mesh, pp_axis, n_microbatches)
            logits = self._logits(contiguous_rows(x, ctx, n_microbatches), ctx).float()
            return logits if ctx is SINGLE else ctx.dtensor(logits, ctx.placements(heads=False))
        if mesh is None and seq_axis is None and seq_layout == "contiguous":
            return self._head(self._hidden(tokens, attn_impl))
        ctx, tokens, _, positions, attn_impl, pre = local_inputs(
            tokens, None, mesh=mesh, seq_axis=seq_axis, seq_layout=seq_layout,
            attn_impl=attn_impl, **axes)
        logits = self._logits(self._hidden(tokens, attn_impl, ctx, positions, pre), ctx)
        return ctx.dtensor(logits.float(), ctx.placements(heads=False))

    def loss(self, tokens, targets, attn_impl: str = "auto", *, mesh=None,
             seq_axis: Optional[str] = None, seq_layout: str = "contiguous",
             pp_axis: Optional[str] = None, n_microbatches: int = 1,
             tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
        """Mean next-token cross-entropy, f32 scalar (the JAX ``loss_fn``).

        The head's logits stay in the parameters' dtype, as the JAX
        ``_head_ce`` keeps them; the loss is ``logsumexp`` of their f32
        upcast minus the target's logit, averaged over ``(B, S)``.  With
        ``mesh``, ``tokens`` and ``targets`` are the global batch on every
        rank, and every rank returns the global mean.  ``pp_axis`` /
        ``n_microbatches`` as in :meth:`forward` (the GPipe schedule; its
        backward is the pipeline's transposed schedule), as are ``tp`` and
        ``fsdp``.
        """
        axes = {"tp": tp, "fsdp": fsdp}
        if pp_axis is not None:
            ctx, tokens, targets, impl = stage_inputs(
                tokens, targets, mesh=mesh, axis=pp_axis, n_microbatches=n_microbatches,
                attn_impl=attn_impl, seq_axis=seq_axis, seq_layout=seq_layout, **axes)
            x = self._stage_hidden(tokens, impl, ctx, mesh, pp_axis, n_microbatches)
        else:
            ctx, tokens, targets, positions, attn_impl, pre = local_inputs(
                tokens, targets, mesh=mesh, seq_axis=seq_axis, seq_layout=seq_layout,
                attn_impl=attn_impl, **axes)
            x = self._hidden(tokens, attn_impl, ctx, positions, pre)
        logits = self._logits(x, ctx)
        nll = torch.logsumexp(logits.float(), dim=-1) - logits.gather(
            -1, targets[..., None])[..., 0].float()
        if ctx is SINGLE:
            return nll.mean()
        return ctx.loss(nll.sum(), nll.numel() * ctx.n_reduce)

    def init_cache(self, batch: int, max_len: int, *, device: Optional[Any] = None):
        """Static-shape KV cache: ``(L, B, Smax, Hkv, Dh)`` per k/v in the
        parameters' dtype, on their device unless ``device`` says
        otherwise."""
        cfg = self.cfg
        w = self.embed.weight
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        device = w.device if device is None else device
        return {
            "k": torch.zeros(shape, dtype=w.dtype, device=device),
            "v": torch.zeros(shape, dtype=w.dtype, device=device),
        }

    @torch.no_grad()
    def prep_decode(self) -> Dict[str, List[torch.Tensor]]:
        """Per-layer fused decode weights: ``wqkv`` (wq|wk|wv) and ``wgu``
        (w_gate|w_up), concatenated along the output dim.  Computed once
        per generation and passed to :meth:`forward_cached`."""
        return {
            "wqkv": [
                torch.cat([b.wq.weight, b.wk.weight, b.wv.weight], dim=0)
                for b in self.layers
            ],
            "wgu": [
                torch.cat([b.w_gate.weight, b.w_up.weight], dim=0)
                for b in self.layers
            ],
        }

    def forward_cached(self, tokens, cache, pos: int, decode_weights=None):
        """Incremental forward: ``tokens (B, T)`` at positions
        ``pos .. pos+T-1``.  Writes their K/V into ``cache`` in place and
        returns ``(logits (B, T, V) f32, cache)``.  ``decode_weights`` from
        :meth:`prep_decode`; computed here when not given."""
        cfg = self.cfg
        if decode_weights is None:
            decode_weights = self.prep_decode()
        b, t = tokens.shape
        x = self.embed(tokens)
        positions = (pos + torch.arange(t, device=tokens.device))[None].expand(b, t)
        cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim // 2, x.dtype)
        n_q = cfg.n_heads * cfg.head_dim
        n_kv = cfg.n_kv_heads * cfg.head_dim
        for i, blk in enumerate(self.layers):
            h = blk.attn_norm(x)
            qkv = F.linear(h, decode_weights["wqkv"][i])
            q = qkv[..., :n_q].reshape(b, t, cfg.n_heads, cfg.head_dim)
            k = qkv[..., n_q:n_q + n_kv].reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
            v = qkv[..., n_q + n_kv:].reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
            q = _rope_apply(q, cos, sin)
            k = _rope_apply(k, cos, sin)
            cache["k"][i, :, pos:pos + t] = k
            cache["v"][i, :, pos:pos + t] = v
            attn = cached_attention(q, cache["k"][i], cache["v"][i], pos)
            x = x + blk.wo(attn.reshape(b, t, -1))
            h = blk.mlp_norm(x)
            gu = F.linear(h, decode_weights["wgu"][i])
            x = x + blk.w_down(F.silu(gu[..., :cfg.ffn_dim]) * gu[..., cfg.ffn_dim:])
        return self._head(x), cache


# ---------------------------------------------------------------------------
# 1F1B pipeline pieces (see parallel.pipeline.pipeline_value_and_grad):
# the embedding on stage 0, the blocks pipelined, the loss head inside the
# last stage.


def _stage_positions(tokens, ctx):
    """``(1, s)``: the global positions of a pipeline stage's columns (its
    offset along the sequence axis, if the stage has one)."""
    s = tokens.shape[1]
    return (torch.arange(s, device=tokens.device) + ctx.seq_offset(s))[None]


def _rope_cache(cfg):
    """``(cos, sin)`` of positions ``arange(S)``, made once per ``(S,
    device, dtype)``."""
    tables = {}

    def get(h):
        key = (h.shape[1], h.device, h.dtype)
        if key not in tables:
            positions = torch.arange(h.shape[1], device=h.device)[None]
            tables[key] = _rope_tables(positions, cfg.rope_theta, cfg.head_dim // 2, h.dtype)
        return tables[key]

    return get


def pp_pieces(model, *, mesh=None, pp_axis: str = "pp", attn_impl: str = "auto",
              tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
    """``(embed_fn, block_fn, head_loss_fn)`` of ``model`` for the 1F1B
    schedule, on this rank's stage context (the mesh without ``pp_axis``):
    ``embed_fn(ep, tokens_mb)`` and ``head_loss_fn(hp, h, targets_mb)`` take
    the global microbatch and compute on this rank's rows of it (the loss
    is the microbatch's global mean); ``block_fn(h, block)`` is one block,
    without remat (the pipeline recomputes the stage)."""
    from ..ops.attention import resolve_stage_attn_impl

    ctx, rows = stage_context(mesh, pp_axis, tp=tp, fsdp=fsdp)
    rope = _rope_cache(model.cfg)

    def embed_fn(ep, tokens_mb):
        return F.embedding(rows(tokens_mb), ctx.weight(ep["embed.weight"]))

    def block_fn(h, blk):
        cos, sin = rope(h)
        return blk(h, cos, sin, resolve_stage_attn_impl(attn_impl, cuda=h.is_cuda), ctx)

    def head_loss_fn(hp, h, targets_mb):
        logits = F.linear(model.norm(h, ctx), ctx.weight(hp["lm_head.weight"]))
        targets = rows(targets_mb)
        nll = torch.logsumexp(logits.float(), dim=-1) - logits.gather(
            -1, targets[..., None])[..., 0].float()
        return nll.mean() if ctx is SINGLE else ctx.loss(nll.sum(), nll.numel() * ctx.n_reduce)

    return embed_fn, block_fn, head_loss_fn


def pp_value_and_grad(model, tokens, targets, *, mesh, pp_axis: str = "pp",
                      n_microbatches: int = 1, attn_impl: str = "auto",
                      tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
    """``(loss, grads)`` of ``model`` by the 1F1B pipeline: the global
    batch's loss on every rank and ``{name: gradient}`` of this rank's
    parameters (its stage's layers, the embedding and the head), placed as
    the parameters; a drop-in for ``loss`` + ``backward`` in pipeline
    training, with O(P) stashed activations where GPipe keeps O(M)."""
    embed_fn, block_fn, head_loss_fn = pp_pieces(model, mesh=mesh, pp_axis=pp_axis,
                                                 attn_impl=attn_impl, tp=tp, fsdp=fsdp)
    first, blocks = stage_blocks(model.layers, mesh, pp_axis)
    loss, (g_ep, g_lp, g_hp) = pipeline_value_and_grad(
        {"embed.weight": model.embed.weight}, blocks,
        {"norm.weight": model.norm.weight, "lm_head.weight": model.lm_head.weight},
        tokens, targets, embed_fn, block_fn, head_loss_fn,
        mesh=mesh, axis=pp_axis, n_microbatches=n_microbatches)
    return loss, {**g_ep, **g_hp, **layer_grads(first, g_lp)}
