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
from ..ops.attention import attention, cached_attention

__all__ = [
    "LlamaConfig",
    "llama_test",
    "llama_tiny",
    "llama_7b",
    "llama_70b",
    "num_params",
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

    def forward(self, x):
        return _rmsnorm(x, self.weight, self.eps)


class Block(nn.Module):
    """One transformer block: attention then SiLU-gated MLP, pre-norm."""

    def __init__(self, cfg: LlamaConfig, *, device):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.dim, cfg.ffn_dim
        hq = cfg.n_heads * cfg.head_dim
        hkv = cfg.n_kv_heads * cfg.head_dim
        kw = dict(bias=False, dtype=cfg.dtype, device=device)
        self.attn_norm = RMSNorm(d, cfg.norm_eps, dtype=cfg.dtype, device=device)
        self.wq = nn.Linear(d, hq, **kw)
        self.wk = nn.Linear(d, hkv, **kw)
        self.wv = nn.Linear(d, hkv, **kw)
        self.wo = nn.Linear(hq, d, **kw)
        self.mlp_norm = RMSNorm(d, cfg.norm_eps, dtype=cfg.dtype, device=device)
        self.w_gate = nn.Linear(d, f, **kw)
        self.w_up = nn.Linear(d, f, **kw)
        self.w_down = nn.Linear(f, d, **kw)

    def forward(self, x, cos, sin, attn_impl: str = "auto"):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        h = self.attn_norm(x)
        q = self.wq(h).reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = self.wk(h).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(h).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = _rope_apply(q, cos, sin)
        k = _rope_apply(k, cos, sin)
        attn = attention(q, k, v, causal=True, impl=attn_impl)
        x = x + self.wo(attn.reshape(b, s, -1))
        h = self.mlp_norm(x)
        return x + self.w_down(F.silu(self.w_gate(h)) * self.w_up(h))


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

    def _hidden(self, tokens, attn_impl: str):
        """The blocks' output ``(B, S, dim)`` before the final norm."""
        cfg = self.cfg
        s = tokens.shape[1]
        x = self.embed(tokens)
        positions = torch.arange(s, device=tokens.device)[None]
        cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim // 2, x.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.layers:
            if remat:
                x = checkpoint(blk, x, cos, sin, attn_impl, use_reentrant=False)
            else:
                x = blk(x, cos, sin, attn_impl)
        return x

    def forward(self, tokens, attn_impl: str = "auto"):
        """Token ids ``(B, S)`` -> logits ``(B, S, V)`` float32."""
        return self._head(self._hidden(tokens, attn_impl))

    def loss(self, tokens, targets, attn_impl: str = "auto"):
        """Mean next-token cross-entropy, f32 scalar (the JAX ``loss_fn``).

        The head's logits stay in the parameters' dtype, as the JAX
        ``_head_ce`` keeps them; the loss is ``logsumexp`` of their f32
        upcast minus the target's logit, averaged over ``(B, S)``.
        """
        x = self._hidden(tokens, attn_impl)
        logits = self.lm_head(self.norm(x))
        lse = torch.logsumexp(logits.float(), dim=-1)
        tgt = logits.gather(-1, targets[..., None])[..., 0].float()
        return (lse - tgt).mean()

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
