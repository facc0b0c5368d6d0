"""GPT-2 family as a PyTorch module.

Counterpart of ``torchdistx_tpu/models/gpt2.py``: the same configurations,
initialization statistics and arithmetic (pre-LN with biases, layer norm
statistics in f32 then scale and bias in the storage dtype, learned
positions, tanh-approximated GELU, standard multi-head attention, logits
tied to the token embedding), with the blocks in an ``nn.ModuleList`` and
the projections as ``nn.Linear`` (weights stored ``(out, in)``).  Attention
goes through :func:`~torchdistx_tpu_torch.ops.attention.attention`: the
hand-written flash kernel on CUDA tensors.

The head is ``x @ wte.weight.T``: the embedding's own Parameter, with no
second head Parameter to untie (``materialize_module_torch`` lists a tied
Parameter once, and a state dict loaded by assignment would fill only one).

The module computes in its parameters' dtype (``cfg.dtype`` as built).
``cfg.remat`` runs each block under ``torch.utils.checkpoint`` when
gradients are on.  On a mesh (``mesh=``, ``seq_axis=``) the parameters are
``DTensor``s placed by :func:`param_specs` and each rank computes its
block as the port's Llama does (see
:mod:`~torchdistx_tpu_torch.models.llama`); ``attn_qkv``'s ``tp`` shards
cut across q, k and v, so each rank gathers it and takes its own heads'
rows of each.  The pipelined forward, :func:`pp_pieces` and :func:`pp_value_and_grad` are
Llama's (:mod:`~torchdistx_tpu_torch.models.llama`), with the tied ``wte``
read by both the embedding on stage 0 and the head on the last stage: the
1F1B schedule carries it as a shared parameter, with one f32 gradient
accumulator.  The JAX ``forward_paged`` (serving) belongs to a later part
of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.attention import cached_attention, paged_attention, paged_write_index
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
    "GPT2Config",
    "gpt2_test",
    "gpt2_small",
    "gpt2_xl",
    "num_params",
    "param_specs",
    "pp_pieces",
    "pp_value_and_grad",
    "GPT2",
]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """The JAX ``GPT2Config``'s fields; like the port's ``LlamaConfig`` it
    has no ``layer_unroll`` (a ``jax.lax.scan`` setting)."""

    vocab_size: int = 50257
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_dim(self) -> int:
        return 4 * self.dim


def gpt2_test() -> GPT2Config:
    return GPT2Config(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, max_seq_len=128,
        dtype=torch.float32, remat=False,
    )


def gpt2_small() -> GPT2Config:
    return GPT2Config()


def gpt2_xl() -> GPT2Config:
    return GPT2Config(dim=1600, n_layers=48, n_heads=25, max_seq_len=1024)


def num_params(cfg: GPT2Config) -> int:
    d, f = cfg.dim, cfg.ffn_dim
    per_layer = 4 * d + (d * 3 * d + 3 * d) + (d * d + d) + (d * f + f) + (f * d + d)
    return (cfg.vocab_size + cfg.max_seq_len) * d + cfg.n_layers * per_layer + 2 * d


def param_specs(cfg: GPT2Config, *, tp: Optional[str] = "tp",
                fsdp: Optional[str] = "fsdp", pp: Optional[str] = None) -> Dict[str, P]:
    """Megatron-TP + FSDP partition specs of :class:`GPT2`'s parameters, by
    name: the JAX ``param_specs`` on this module's names, each weight's two
    matrix dims swapped (``nn.Linear`` is ``(out, in)``) and the stacked
    layer axis dropped, as :func:`~torchdistx_tpu_torch.models.llama.
    param_specs` does.  qkv and fc are column-parallel, the projections
    row-parallel, the embeddings ``(fsdp, tp)``, norms replicated; ``pp``
    gives each layer to its pipeline stage, as Llama's does."""
    column, row = P(tp, fsdp), P(fsdp, tp)
    specs = {"wte.weight": P(fsdp, tp), "wpe.weight": P(fsdp, tp)}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        for norm in ("ln_1", "ln_2"):
            specs[pre + norm + ".weight"] = P()
            specs[pre + norm + ".bias"] = P()
        for name in ("attn_qkv", "mlp_fc"):
            specs[pre + name + ".weight"] = column
            specs[pre + name + ".bias"] = P(tp)
        for name in ("attn_proj", "mlp_proj"):
            specs[pre + name + ".weight"] = row
            specs[pre + name + ".bias"] = P()
    specs["ln_f.weight"] = P()
    specs["ln_f.bias"] = P()
    return specs if pp is None else stage_specs(specs, pp=pp)


def _layernorm(x, weight, bias, eps: float):
    """Statistics in f32, cast to x's dtype, then scale and bias in it (the
    JAX ``_layernorm``; ``F.layer_norm`` would apply them in f32)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * weight.to(x.dtype) + bias.to(x.dtype)


class LayerNorm(nn.Module):
    """Scale (``weight``, ones) and ``bias`` (zeros) over the last dim."""

    def __init__(self, dim: int, eps: float, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x, ctx=SINGLE):
        return _layernorm(x, ctx.weight(self.weight), ctx.weight(self.bias), self.eps)


class Block(nn.Module):
    """One pre-LN block: attention, then the GELU MLP."""

    def __init__(self, cfg: GPT2Config, *, device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.dim, cfg.ffn_dim
        kw = dict(dtype=cfg.dtype, device=device)
        self.ln_1 = LayerNorm(d, cfg.norm_eps, **kw)
        self.attn_qkv = nn.Linear(d, 3 * d, **kw)
        self.attn_proj = nn.Linear(d, d, **kw)
        self.ln_2 = LayerNorm(d, cfg.norm_eps, **kw)
        self.mlp_fc = nn.Linear(d, f, **kw)
        self.mlp_proj = nn.Linear(f, d, **kw)

    def qkv(self, x, ctx=SINGLE):
        """``(q, k, v)``, each ``(B, T, H, Dh)``: one product, split into
        thirds along the features, then into heads (the JAX order, so HF
        ``c_attn`` weights need no permutation).  Under ``tp`` the heads are
        this rank's."""
        b, t = x.shape[0], x.shape[1]
        cfg = self.cfg
        h = self.ln_1(x, ctx)
        split = ctx.tp_size > 1 and ctx.tp_divides(cfg.n_heads)
        w = ctx.weight(self.attn_qkv.weight, tp_partial=split)
        bias = ctx.weight(self.attn_qkv.bias, tp_partial=split)
        if split:
            width = cfg.dim // ctx.tp_size
            rows = [(part * cfg.dim + ctx.tp_rank * width, width) for part in range(3)]
            w = torch.cat([w.narrow(0, start, n) for start, n in rows])
            bias = torch.cat([bias.narrow(0, start, n) for start, n in rows])
            h = ctx.tp_copy(h)
        qkv = F.linear(h, w, bias)
        return tuple(part.reshape(b, t, -1, cfg.head_dim).contiguous()
                     for part in qkv.split(qkv.shape[-1] // 3, dim=-1))

    def finish(self, x, attn, ctx=SINGLE):
        """The attention output's projection, residual and the MLP."""
        b, t = x.shape[0], x.shape[1]
        cfg = self.cfg
        split = ctx.tp_divides(cfg.n_heads)
        x = x + self._row(ctx, split, self.attn_proj, attn.reshape(b, t, -1))
        h = self.ln_2(x, ctx)
        split = ctx.tp_divides(cfg.ffn_dim)
        col = 0 if split else None
        h = ctx.tp_copy(h) if split else h
        h = F.gelu(F.linear(h, ctx.weight(self.mlp_fc.weight, tp_dim=col),
                            ctx.weight(self.mlp_fc.bias, tp_dim=col)), approximate="tanh")
        return x + self._row(ctx, split, self.mlp_proj, h)

    @staticmethod
    def _row(ctx, split, lin, h):
        """A row-parallel product (summed over ``tp``), then its bias."""
        if not split or ctx.tp_size == 1:
            return F.linear(h, ctx.weight(lin.weight), ctx.weight(lin.bias))
        out = ctx.tp_reduce(F.linear(h, ctx.weight(lin.weight, tp_dim=1)))
        return out + ctx.weight(lin.bias)

    def forward(self, x, attn_impl: str = "auto", ctx=SINGLE):
        q, k, v = self.qkv(x, ctx)
        split = ctx.tp_divides(self.cfg.n_heads)
        return self.finish(x, ctx.attention(q, k, v, heads=split, impl=attn_impl), ctx)


class GPT2(nn.Module):
    """The decoder.  ``device=None`` means CUDA (see
    :func:`~torchdistx_tpu_torch.resolve_device`).

    Initialization as the JAX ``init_params``: N(0, 0.02) for the
    embeddings, ``attn_qkv`` and ``mlp_fc``, 0.02/sqrt(2 n_layers) for
    ``attn_proj`` and ``mlp_proj``, zero biases, unit layer-norm scales;
    values are drawn from PyTorch's default generator of the device they
    land on.
    """

    def __init__(self, cfg: GPT2Config, *, device: Optional[Any] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.dim, **kw)
        self.layers = nn.ModuleList(Block(cfg, device=device) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.dim, cfg.norm_eps, **kw)
        self._init_weights()

    @torch.no_grad()
    def _init_weights(self) -> None:
        std = 0.02
        resid_std = 0.02 / math.sqrt(2.0 * self.cfg.n_layers)
        nn.init.normal_(self.wte.weight, 0.0, std)
        nn.init.normal_(self.wpe.weight, 0.0, std)
        for blk in self.layers:
            for lin, s in ((blk.attn_qkv, std), (blk.mlp_fc, std),
                           (blk.attn_proj, resid_std), (blk.mlp_proj, resid_std)):
                nn.init.normal_(lin.weight, 0.0, s)
                nn.init.zeros_(lin.bias)

    @property
    def head_weight(self) -> nn.Parameter:
        """The head's weight: the token embedding itself."""
        return self.wte.weight

    def _embed(self, tokens, pos: int = 0, ctx=SINGLE):
        t = tokens.shape[1]
        if pos + t > self.cfg.max_seq_len:
            raise ValueError(f"positions up to {pos + t} exceed cfg.max_seq_len "
                             f"({self.cfg.max_seq_len})")
        wpe = ctx.weight(self.wpe.weight)
        return F.embedding(tokens, ctx.weight(self.wte.weight)) + wpe[pos:pos + t][None]

    def _head(self, x, ctx=SINGLE):
        """Final norm and tied head in ``cfg.dtype`` (not yet f32)."""
        return F.linear(self.ln_f(x, ctx), ctx.weight(self.head_weight))

    def _hidden(self, tokens, attn_impl: str, ctx=SINGLE, pos: int = 0):
        x = self._embed(tokens, pos, ctx)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.layers:
            if remat:
                x = checkpoint(blk, x, attn_impl, ctx, use_reentrant=False)
            else:
                x = blk(x, attn_impl, ctx)
        return x

    def _logits(self, tokens, targets, attn_impl, mesh, seq_axis, pp_axis=None,
                n_microbatches=1, axes=None):
        """``(ctx, targets, logits in cfg.dtype)`` of this rank's block (with
        ``pp_axis``, of its block of each microbatch, through the GPipe
        pipeline); ``axes`` the ``tp`` / ``fsdp`` names."""
        axes = axes or {}
        if pp_axis is not None:
            ctx, tokens, targets, impl = stage_inputs(
                tokens, targets, mesh=mesh, axis=pp_axis, n_microbatches=n_microbatches,
                attn_impl=attn_impl, seq_axis=seq_axis, **axes)
            _, blocks = stage_blocks(self.layers, mesh, pp_axis)
            # Each column's learned position is its global one.
            x = self._embed(tokens, ctx.seq_offset(tokens.shape[1]), ctx)
            x = pipeline_forward(x, blocks, lambda h, blk: blk(h, impl, ctx), mesh=mesh,
                                 axis=pp_axis, n_microbatches=n_microbatches)
            return ctx, targets, self._head(x, ctx)
        ctx, tokens, targets, positions, attn_impl, _ = local_inputs(
            tokens, targets, mesh=mesh, seq_axis=seq_axis, attn_impl=attn_impl, **axes)
        del positions  # contiguous: this rank's columns start at its offset
        pos = ctx.seq_offset(tokens.shape[1])
        return ctx, targets, self._head(self._hidden(tokens, attn_impl, ctx, pos), ctx)

    def forward(self, tokens, attn_impl: str = "auto", *, mesh=None,
                seq_axis: Optional[str] = None, pp_axis: Optional[str] = None,
                n_microbatches: int = 1, tp: Optional[str] = "tp",
                fsdp: Optional[str] = "fsdp"):
        """Token ids ``(B, S)`` -> logits ``(B, S, V)`` float32.  With
        ``mesh``, ``tokens`` is the global batch on every rank and the
        logits are a ``DTensor`` (this rank's rows and columns);
        ``pp_axis`` / ``n_microbatches`` run the blocks through the GPipe
        pipeline (as Llama's ``forward``); ``tp`` / ``fsdp`` name the mesh
        axes of those roles."""
        ctx, _, logits = self._logits(tokens, None, attn_impl, mesh, seq_axis, pp_axis,
                                      n_microbatches, {"tp": tp, "fsdp": fsdp})
        if pp_axis is not None:
            logits = contiguous_rows(logits, ctx, n_microbatches)
        if ctx is SINGLE:
            return logits.float()
        return ctx.dtensor(logits.float(), ctx.placements(heads=False))

    def loss(self, tokens, targets, attn_impl: str = "auto", *, mesh=None,
             seq_axis: Optional[str] = None, pp_axis: Optional[str] = None,
             n_microbatches: int = 1, tp: Optional[str] = "tp",
             fsdp: Optional[str] = "fsdp"):
        """Mean next-token cross-entropy, f32 scalar (the JAX ``loss_fn``:
        logits in ``cfg.dtype``, ``logsumexp`` of their f32 upcast minus
        the target's logit); with ``mesh``, the global batch's on every
        rank; ``pp_axis``, ``tp`` and ``fsdp`` as in :meth:`forward`."""
        ctx, targets, logits = self._logits(tokens, targets, attn_impl, mesh, seq_axis,
                                            pp_axis, n_microbatches, {"tp": tp, "fsdp": fsdp})
        nll = torch.logsumexp(logits.float(), dim=-1) - logits.gather(
            -1, targets[..., None])[..., 0].float()
        if ctx is SINGLE:
            return nll.mean()
        return ctx.loss(nll.sum(), nll.numel() * ctx.n_reduce)

    def init_cache(self, batch: int, max_len: int, *, device: Optional[Any] = None):
        """Static-shape KV cache: ``(L, B, Smax, H, Dh)`` per k/v in the
        parameters' dtype, on their device unless ``device`` says
        otherwise."""
        cfg = self.cfg
        w = self.wte.weight
        shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
        device = w.device if device is None else device
        return {"k": torch.zeros(shape, dtype=w.dtype, device=device),
                "v": torch.zeros(shape, dtype=w.dtype, device=device)}

    def prep_decode(self) -> dict:
        """Nothing to fuse: ``attn_qkv`` is one product already, and the MLP
        has no gate.  Kept so that ``generate`` treats every family alike."""
        return {}

    def forward_cached(self, tokens, cache, pos: int, decode_weights=None):
        """Incremental forward: ``tokens (B, T)`` at positions ``pos ..
        pos+T-1``.  Writes their K/V into ``cache`` in place and returns
        ``(logits (B, T, V) f32, cache)``.  ``decode_weights`` is accepted
        for the family protocol and unused."""
        del decode_weights
        t = tokens.shape[1]
        x = self._embed(tokens, pos)
        for i, blk in enumerate(self.layers):
            q, k, v = blk.qkv(x)
            cache["k"][i, :, pos:pos + t] = k
            cache["v"][i, :, pos:pos + t] = v
            x = blk.finish(x, cached_attention(q, cache["k"][i], cache["v"][i], pos))
        return self._head(x).float(), cache

    def forward_paged(self, tokens, cache, block_tables, positions, decode_weights=None):
        """``tokens (B, T)`` against a paged KV cache, slot ``b`` at its own
        positions ``positions[b] ..`` (see
        :meth:`~torchdistx_tpu_torch.models.llama.Llama.forward_paged`):
        learned positions at each slot's offsets, clamped to the table as
        the JAX ``jnp.take`` clamps them (a padding tail past
        ``max_seq_len`` reads the last row; its K/V lands in the trash
        page).  Returns ``(logits (B, T, V) f32, cache)``."""
        del decode_weights
        b, t = tokens.shape
        pos_bt = positions[:, None] + torch.arange(t, device=tokens.device)[None]
        x = self.wte(tokens) + self.wpe(pos_bt.clamp(0, self.cfg.max_seq_len - 1))
        blk_idx, off = paged_write_index(block_tables, pos_bt, cache["k"].shape[2])
        blk_idx, off = blk_idx.long(), off.long()
        for i, blk in enumerate(self.layers):
            q, k, v = blk.qkv(x)
            cache["k"][i, blk_idx, off] = k
            cache["v"][i, blk_idx, off] = v
            x = blk.finish(x, paged_attention(q, cache["k"][i], cache["v"][i], block_tables,
                                              positions))
        return self._head(x).float(), cache


# ---------------------------------------------------------------------------
# 1F1B pipeline pieces: wte + wpe on stage 0, the blocks pipelined, ln_f and
# the tied head inside the last stage.


def pp_pieces(model, *, mesh=None, pp_axis: str = "pp", attn_impl: str = "auto",
              tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
    """``(embed_fn, block_fn, head_loss_fn)`` of ``model`` for the 1F1B
    schedule, as Llama's :func:`~torchdistx_tpu_torch.models.llama.
    pp_pieces`; ``embed_fn(ep, tokens_mb, sp)`` and ``head_loss_fn(hp, h,
    targets_mb, sp)`` take the tied embedding ``sp["wte.weight"]`` last."""
    from ..ops.attention import resolve_stage_attn_impl

    ctx, rows = stage_context(mesh, pp_axis, tp=tp, fsdp=fsdp)

    def embed_fn(ep, tokens_mb, sp):
        tokens = rows(tokens_mb)
        wpe = ctx.weight(ep["wpe.weight"])
        return (F.embedding(tokens, ctx.weight(sp["wte.weight"]))
                + wpe[:tokens.shape[1]][None])

    def block_fn(h, blk):
        return blk(h, resolve_stage_attn_impl(attn_impl, cuda=h.is_cuda), ctx)

    def head_loss_fn(hp, h, targets_mb, sp):
        logits = F.linear(model.ln_f(h, ctx), ctx.weight(sp["wte.weight"]))
        targets = rows(targets_mb)
        nll = torch.logsumexp(logits.float(), dim=-1) - logits.gather(
            -1, targets[..., None])[..., 0].float()
        return nll.mean() if ctx is SINGLE else ctx.loss(nll.sum(), nll.numel() * ctx.n_reduce)

    return embed_fn, block_fn, head_loss_fn


def pp_value_and_grad(model, tokens, targets, *, mesh, pp_axis: str = "pp",
                      n_microbatches: int = 1, attn_impl: str = "auto",
                      tp: Optional[str] = "tp", fsdp: Optional[str] = "fsdp"):
    """``(loss, grads)`` of ``model`` by the 1F1B pipeline, as Llama's.
    The tied ``wte`` rides the pipeline's ``shared_params``: stage 0's
    embedding and the last stage's head both read it, and its gradient
    (the two contributions, summed over ``pp``) has one f32 accumulator."""
    embed_fn, block_fn, head_loss_fn = pp_pieces(model, mesh=mesh, pp_axis=pp_axis,
                                                 attn_impl=attn_impl, tp=tp, fsdp=fsdp)
    first, blocks = stage_blocks(model.layers, mesh, pp_axis)
    loss, (g_ep, g_lp, g_hp, g_sp) = pipeline_value_and_grad(
        {"wpe.weight": model.wpe.weight}, blocks,
        {"ln_f.weight": model.ln_f.weight, "ln_f.bias": model.ln_f.bias},
        tokens, targets, embed_fn, block_fn, head_loss_fn,
        mesh=mesh, axis=pp_axis, n_microbatches=n_microbatches,
        shared_params={"wte.weight": model.wte.weight})
    return loss, {**g_sp, **g_ep, **g_hp, **layer_grads(first, g_lp)}
