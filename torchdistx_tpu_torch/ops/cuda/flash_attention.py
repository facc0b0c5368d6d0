"""Flash-attention forward: the Hopper kernel's wrapper and its plain version.

Counterpart of ``torchdistx_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` and the forward kernel ``_fwd_kernel``).  The kernel
lives in ``csrc/flash_fwd.cu``; :func:`flash_attention_reference` is the
same ``(out, lse)`` in plain PyTorch.

Layout ``(B, S, H, D)``, as everywhere in the model.  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.  Each
launch adds one to :data:`launches`.  The backward kernels belong to the
training slice, so on CUDA the autograd backward raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "flash_attention",
    "flash_attention_fwd_with_lse",
    "flash_attention_reference",
    "launches",
]

# Finite "minus infinity" of the masked logits (see the kernel's header).
_MASK = -1e30
_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

# Kernel launches made by this process (a plain count; callers reset it).
launches = 0
# The launcher ``tdx_flash_fwd`` with its C signature, bound at first use.
_launcher = None


def _flash_fwd():
    global _launcher
    if _launcher is None:
        fn = _build.load("flash_fwd").tdx_flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _scale_log2(d: int) -> float:
    return (1.0 / math.sqrt(d)) * _LOG2E


def flash_attention_reference(q, k, v, *, causal: bool = True):
    """Plain PyTorch ``(out, lse)`` of the kernel's computation.

    q ``(B, S, Hq, D)``, k/v ``(B, S, Hkv, D)``.  Logits accumulate in f32
    from the storage-dtype inputs and go to the log2 domain; masked
    logits are ``-1e30``; ``p`` is cast to v's dtype before ``p.v``; rows
    with ``l == 0`` are guarded to 1.  Returns ``out`` like q and ``lse``
    ``(B, Hq, S)`` f32, natural log.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * _scale_log2(d)
    if causal:
        keep = (
            torch.arange(s, device=q.device)[:, None]
            >= torch.arange(s, device=q.device)[None, :]
        )
        logits = torch.where(keep, logits, _MASK)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = (acc / l_safe.permute(0, 3, 1, 2, 4)).to(q.dtype)
    lse = m / _LOG2E + torch.log(l_safe)
    return out.reshape(b, s, hq, d), lse.reshape(b, hq, s)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors")
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k/v {tuple(k.shape)}"
            f"/{tuple(v.shape)} do not match as (B, S, H, D)"
        )
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of Hkv={hkv}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v are on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_attention: q, k and v differ in dtype")


def _launch(q, k, v, causal: bool):
    """Launch ``csrc/flash_fwd.cu`` on the current stream; ``(out, lse)``."""
    global launches
    _check(q, k, v)
    b, s, hq, d = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes bf16 or f32, not {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned {name}")
    if hq > 65535 or b > 65535:
        raise ValueError("flash kernel takes at most 65535 heads and batch rows")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    fn = _flash_fwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, hq, k.shape[2], d, _DTYPES[q.dtype],
            int(causal), _scale_log2(d), stream,
        )
    if err:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    launches += 1
    return out, lse


def flash_attention_fwd_with_lse(q, k, v, *, causal: bool = True):
    """``(out, lse)``: the kernel for CUDA tensors, the plain version for
    CPU tensors.  ``lse`` is ``(B, Hq, S)`` f32."""
    if q.is_cuda:
        return _launch(q, k, v, causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    return flash_attention_reference(q, k, v, causal=causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        return _launch(q, k, v, causal)[0]

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError("flash backward: training slice")


def flash_attention(q, k, v, *, causal: bool = True):
    """Fused attention, ``(B, S, H, D)`` in and out."""
    if q.is_cuda:
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd_with_lse(q, k, v, causal=causal)[0]
