"""Flash attention: the Hopper kernels' wrappers and their plain versions.

Counterpart of ``torchdistx_tpu/ops/pallas/flash_attention.py``
(``flash_attention``, the forward kernel ``_fwd_kernel`` and the backward
kernels ``_dqkv_fused_kernel``, ``_dq_kernel`` and ``_dkv_kernel``).  The
kernels live in ``csrc/``:

- ``flash_fwd.cu``: ``(out, lse)``; plain version
  :func:`flash_attention_reference`;
- ``flash_bwd_fused.cu``: ``(dq, dk, dv)`` in one kernel, taken for
  ``S <= 2048``;
- ``flash_bwd_dq.cu`` and ``flash_bwd_dkv.cu``: the streamed pair, taken
  above that;

the three backward kernels share ``flash_bwd_common.cuh``, and their plain
version is :func:`flash_bwd_plain` (:func:`flash_attention_backward_reference`
from ``out`` instead of ``delta``).

Layout ``(B, S, H, D)``, as everywhere in the model.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.  Each launch adds
one to its counter: :data:`launches` (forward), :data:`launches_bwd_fused`,
:data:`launches_bwd_dq`, :data:`launches_bwd_dkv`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "attention_delta",
    "backward_route",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_backward_reference",
    "flash_attention_fwd_with_lse",
    "flash_attention_reference",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_bwd_fused",
    "flash_bwd_plain",
    "launches",
    "launches_bwd_dkv",
    "launches_bwd_dq",
    "launches_bwd_fused",
]

# Finite "minus infinity" of the masked logits (see flash_fwd.cu's header).
_MASK = -1e30
_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# Sequences up to this length take the fused backward (the JAX package's
# _FUSED_BWD_MAX_KV, compared there with the length padded to 128; padding
# to 128 never crosses 2048 = 16 x 128, so the unpadded length decides the
# same way).
_FUSED_BWD_MAX_KV = 2048

# Kernel launches made by this process (plain counts; callers reset them).
launches = 0
launches_bwd_fused = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source -> (C launcher, argtypes); each bound once, at first use.
_SIGNATURES = {
    "flash_fwd": ("tdx_flash_fwd", [_P] * 5 + [_I] * 7 + [_F, _P]),
    "flash_bwd_fused": ("tdx_flash_bwd_fused", [_P] * 9 + [_I] * 7 + [_F, _F, _P]),
    "flash_bwd_dq": ("tdx_flash_bwd_dq", [_P] * 7 + [_I] * 7 + [_F, _F, _P]),
    "flash_bwd_dkv": ("tdx_flash_bwd_dkv", [_P] * 8 + [_I] * 7 + [_F, _F, _P]),
}
_launchers: dict = {}


def _launcher(source: str):
    fn = _launchers.get(source)
    if fn is None:
        symbol, argtypes = _SIGNATURES[source]
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launchers[source] = fn
    return fn


def _call_on(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)``: a C launcher called with ``device`` current and
    the handle of its current CUDA stream.  Both are read the cheap way (no
    device switch when ``device`` is current already, and no
    ``torch.cuda.Stream`` object), since the host's launch path otherwise
    takes longer than the 4 x 512 forward does on the card."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


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
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (_scale(d) * _LOG2E)
    if causal:
        logits = torch.where(_causal_keep(s, q.device), logits, _MASK)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = (acc / l_safe.permute(0, 3, 1, 2, 4)).to(q.dtype)
    lse = m / _LOG2E + torch.log(l_safe)
    return out.reshape(b, s, hq, d), lse.reshape(b, hq, s)


def _causal_keep(s: int, device) -> torch.Tensor:
    idx = torch.arange(s, device=device)
    return idx[:, None] >= idx[None, :]


def attention_delta(do, out) -> torch.Tensor:
    """``delta = rowsum(do * out)`` in f32, ``(B, Hq, S)``."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_bwd_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                    dq: bool = True, dkv: bool = True):
    """Plain PyTorch ``(dq, dk, dv)`` of the backward kernels' computation
    (``None`` for a part not asked for).

    The same identities in the same arithmetic: f32 logits in the log2
    domain; ``p = exp2(logits - lse * log2 e)``, 0 on masked pairs;
    ``ds = p * (do.v^T - delta) * scale`` cast to q's dtype; ``dq = ds.k``;
    ``dk = ds^T.q`` and ``dv = p^T.do`` (p cast to do's dtype) summed over
    the GQA group; products accumulate in f32 from storage-dtype values.
    ``lse`` and ``delta`` are ``(B, Hq, S)`` f32.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, s, hkv, g, d)
    dog = do.float().reshape(b, s, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (_scale(d) * _LOG2E)
    p = torch.exp2(logits - (lse.reshape(b, hkv, g, s) * _LOG2E)[..., None])
    if causal:
        p = torch.where(_causal_keep(s, q.device), p, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = (p * (dp - delta.reshape(b, hkv, g, s)[..., None]) * _scale(d))
    ds = ds.to(q.dtype).float()
    dq_out = dk_out = dv_out = None
    if dq:
        dq_out = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
        dq_out = dq_out.reshape(b, s, hq, d).to(q.dtype)
    if dkv:
        dk_out = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg).to(k.dtype)
        pd = p.to(do.dtype).float()
        dv_out = torch.einsum("bhgqk,bqhgd->bkhd", pd, dog).to(v.dtype)
    return dq_out, dk_out, dv_out


def flash_attention_backward_reference(q, k, v, out, lse, do, *, causal: bool = True):
    """Plain PyTorch ``(dq, dk, dv)`` of attention's backward, from the
    forward's ``out`` and ``lse`` (see :func:`flash_bwd_plain`)."""
    return flash_bwd_plain(q, k, v, do, lse, attention_delta(do, out), causal=causal)


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


def _check_kernel_inputs(tensors, b, hq) -> None:
    """What every kernel takes: bf16 or f32, head_dim 64 or 128,
    contiguous, 16-byte aligned, grid dimensions in range."""
    q = tensors["q"]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes bf16 or f32, not {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, not {q.shape[-1]}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned {name}")
    if hq > 65535 or b > 65535:
        raise ValueError("flash kernel takes at most 65535 heads and batch rows")


def _launch(q, k, v, causal: bool):
    """Launch ``csrc/flash_fwd.cu`` on the current stream; ``(out, lse)``."""
    global launches
    _check(q, k, v)
    b, s, hq, d = q.shape
    _check_kernel_inputs({"q": q, "k": k, "v": v}, b, hq)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    err = _call_on(
        q.device, _launcher("flash_fwd"),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, s, hq, k.shape[2], d, _DTYPES[q.dtype], int(causal), _scale(d) * _LOG2E,
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


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    b, s, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash backward: do {tuple(do.shape)} {do.dtype} does not match q")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, hq, s) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(
                f"flash backward: {name} must be ({b}, {hq}, {s}) float32 on "
                f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _launch_bwd(source, q, k, v, do, lse, delta, outs, causal) -> None:
    """Launch one backward kernel on the current stream, writing ``outs``."""
    b, s, hq, d = q.shape
    _check_kernel_inputs(
        {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta, **outs},
        b, hq,
    )
    err = _call_on(
        q.device, _launcher(source),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs.values()),
        b, s, hq, k.shape[2], d, _DTYPES[q.dtype], int(causal),
        _scale(d), _scale(d) * _LOG2E,
    )
    if err:
        raise RuntimeError(f"{source} launch failed: CUDA error {err}")


def _on_cpu(q) -> bool:
    if q.is_cuda:
        return False
    if q.device.type != "cpu":
        raise ValueError(f"flash backward: unsupported device {q.device}")
    return True


def flash_bwd_fused(q, k, v, do, lse, delta, *, causal: bool = True):
    """``(dq, dk, dv)`` by ``csrc/flash_bwd_fused.cu`` for CUDA tensors (dq
    summed across the kernel's blocks in f32, in an order that varies from
    run to run, then cast to q's dtype; dk and dv the same bits on every
    run), by the plain version for CPU tensors."""
    global launches_bwd_fused
    _check_bwd(q, k, v, do, lse, delta)
    if _on_cpu(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, causal=causal)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_fused", q, k, v, do, lse, delta,
                {"dq_acc": dq_acc, "dk": dk, "dv": dv}, causal)
    launches_bwd_fused += 1
    return dq_acc.to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True):
    """``dq`` by ``csrc/flash_bwd_dq.cu`` for CUDA tensors, by the plain
    version for CPU tensors."""
    global launches_bwd_dq
    _check_bwd(q, k, v, do, lse, delta)
    if _on_cpu(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, causal=causal, dkv=False)[0]
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, {"dq": dq}, causal)
    launches_bwd_dq += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True):
    """``(dk, dv)`` by ``csrc/flash_bwd_dkv.cu`` for CUDA tensors, by the
    plain version for CPU tensors."""
    global launches_bwd_dkv
    _check_bwd(q, k, v, do, lse, delta)
    if _on_cpu(q):
        return flash_bwd_plain(q, k, v, do, lse, delta, causal=causal, dq=False)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, {"dk": dk, "dv": dv}, causal)
    launches_bwd_dkv += 1
    return dk, dv


def backward_route(s: int) -> str:
    """``"fused"`` for ``S <= 2048``, else ``"streamed"``: the JAX
    package's ``_fa_backward`` rule."""
    return "fused" if s <= _FUSED_BWD_MAX_KV else "streamed"


def flash_attention_backward(q, k, v, out, lse, do, *, causal: bool = True,
                             route: str | None = None):
    """``(dq, dk, dv)`` of attention from the forward's ``out`` and ``lse``.

    ``route`` (default :func:`backward_route`): ``"fused"`` or
    ``"streamed"``.
    """
    do = do.contiguous()
    delta = attention_delta(do, out)
    route = route or backward_route(q.shape[1])
    if route == "fused":
        return flash_bwd_fused(q, k, v, do, lse, delta, causal=causal)
    if route == "streamed":
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
        return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
    raise ValueError(f"unknown flash backward route {route!r} (fused|streamed)")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd_with_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """Fused attention, ``(B, S, H, D)`` in and out, differentiable: the
    kernels on CUDA tensors, their plain versions on CPU tensors."""
    return _FlashAttention.apply(q, k, v, causal)
