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
plain version; a CUDA tensor launches the kernel or raises.
:func:`flash_attention_sharded` runs :func:`flash_attention` on each rank's
block of a mesh (the JAX ``shard_map`` wrapper; ``shardable`` says when).  Each launch adds
one to its counter: :data:`launches` (forward), :data:`launches_bwd_fused`,
:data:`launches_bwd_dq`, :data:`launches_bwd_dkv`.

The kernels have instances for head dims 64, 128, 256 and 512 (bf16 on TMA
+ wgmma, the three backward kernels at 512 on clusters of two blocks; f32
on the CUDA cores, register-blocked: the forward and dq on one q-tile body,
``csrc/flash_q_f32.cuh``, dk/dv and the fused backward on one kv-tile body,
``csrc/flash_bwd_kv_f32.cuh``).  Every entry point takes any head dim up to 512: q, k,
v (and ``do``) are zero-padded on the last axis to the next instance, the
kernels run with the scale of the true head dim, and out, dq, dk and dv
are cut back to it.  Zero columns add nothing to ``q.k^T``, and out, dq,
dk and dv are zero in them, so the padded
launch computes exactly what an unpadded one would.  The CPU path pads the
same way, so the tests here cover the padding the card runs.  A head dim
above 512 raises on CUDA.
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
    "flash_attention_sharded",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_bwd_fused",
    "flash_bwd_plain",
    "launches",
    "launches_bwd_dkv",
    "launches_bwd_dq",
    "launches_bwd_fused",
    "on_blocks",
    "shardable",
]

# Finite "minus infinity" of the masked logits (see flash_fwd.cu's header).
_MASK = -1e30
_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256, 512)
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


def _kernel_head_dim(d: int) -> int:
    """The head dim a launch for ``d`` runs at: the least instance in
    ``_HEAD_DIMS`` that holds it, or ``d`` itself above them all (which the
    launch refuses)."""
    return next((h for h in _HEAD_DIMS if d <= h), d)


def _pad_head(*ts):
    """``ts`` zero-padded on the last axis to the kernel's head dim."""
    d = ts[0].shape[-1]
    pad = _kernel_head_dim(d) - d
    return ts if pad == 0 else tuple(torch.nn.functional.pad(t, (0, pad)) for t in ts)


def _cut(d: int, *ts):
    """``ts`` cut back to head dim ``d`` on the last axis."""
    return tuple(t if t.shape[-1] == d else t[..., :d].contiguous() for t in ts)


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: float | None = None):
    """Plain PyTorch ``(out, lse)`` of the kernel's computation.

    q ``(B, S, Hq, D)``, k/v ``(B, S, Hkv, D)``.  Logits accumulate in f32
    from the storage-dtype inputs and go to the log2 domain; masked
    logits are ``-1e30``; ``p`` is cast to v's dtype before ``p.v``; rows
    with ``l == 0`` are guarded to 1.  Returns ``out`` like q and ``lse``
    ``(B, Hq, S)`` f32, natural log.  ``scale`` defaults to ``1 / sqrt(D)``.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    scale = _scale(d) if scale is None else scale
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (scale * _LOG2E)
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
                    dq: bool = True, dkv: bool = True, scale: float | None = None):
    """Plain PyTorch ``(dq, dk, dv)`` of the backward kernels' computation
    (``None`` for a part not asked for).

    The same identities in the same arithmetic: f32 logits in the log2
    domain; ``p = exp2(logits - lse * log2 e)``, 0 on masked pairs;
    ``ds = p * (do.v^T - delta) * scale`` cast to q's dtype; ``dq = ds.k``;
    ``dk = ds^T.q`` and ``dv = p^T.do`` (p cast to do's dtype) summed over
    the GQA group; products accumulate in f32 from storage-dtype values.
    ``lse`` and ``delta`` are ``(B, Hq, S)`` f32.  ``scale`` defaults to
    ``1 / sqrt(D)``.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = _scale(d) if scale is None else scale
    qg = q.float().reshape(b, s, hkv, g, d)
    dog = do.float().reshape(b, s, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (scale * _LOG2E)
    p = torch.exp2(logits - (lse.reshape(b, hkv, g, s) * _LOG2E)[..., None])
    if causal:
        p = torch.where(_causal_keep(s, q.device), p, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = (p * (dp - delta.reshape(b, hkv, g, s)[..., None]) * scale)
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
    """What every kernel takes: bf16 or f32, head_dim 64, 128, 256 or 512,
    contiguous, 16-byte aligned, grid dimensions in range."""
    q = tensors["q"]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes bf16 or f32, not {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(
            f"flash kernel takes head_dim up to {_HEAD_DIMS[-1]}, not {q.shape[-1]}"
        )
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned {name}")
    if hq > 65535 or b > 65535:
        raise ValueError("flash kernel takes at most 65535 heads and batch rows")


def _on_cpu(q) -> bool:
    if q.is_cuda:
        return False
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return True


def _padded(scale, *ts):
    """``(d, scale, ts)``: the true head dim, the scale (``1 / sqrt(d)``
    unless given) and ``ts`` zero-padded to the kernel's head dim."""
    d = ts[0].shape[-1]
    return d, (_scale(d) if scale is None else scale), _pad_head(*ts)


def _launch(q, k, v, causal: bool, scale: float):
    """Launch ``csrc/flash_fwd.cu`` on the current stream; ``(out, lse)``."""
    global launches
    b, s, hq, d = q.shape
    _check_kernel_inputs({"q": q, "k": k, "v": v}, b, hq)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    err = _call_on(
        q.device, _launcher("flash_fwd"),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, s, hq, k.shape[2], d, _DTYPES[q.dtype], int(causal), scale * _LOG2E,
    )
    if err:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    launches += 1
    return out, lse


def flash_attention_fwd_with_lse(q, k, v, *, causal: bool = True,
                                 scale: float | None = None):
    """``(out, lse)``: the kernel for CUDA tensors, the plain version for
    CPU tensors.  ``lse`` is ``(B, Hq, S)`` f32; ``scale`` defaults to
    ``1 / sqrt(D)``."""
    _check(q, k, v)
    d, scale, (q, k, v) = _padded(scale, q, k, v)
    if _on_cpu(q):
        out, lse = flash_attention_reference(q, k, v, causal=causal, scale=scale)
    else:
        out, lse = _launch(q, k, v, causal, scale)
    return _cut(d, out)[0], lse


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


def _launch_bwd(source, q, k, v, do, lse, delta, outs, causal, scale) -> None:
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
        scale, scale * _LOG2E,
    )
    if err:
        raise RuntimeError(f"{source} launch failed: CUDA error {err}")


def flash_bwd_fused(q, k, v, do, lse, delta, *, causal: bool = True,
                    scale: float | None = None):
    """``(dq, dk, dv)`` by ``csrc/flash_bwd_fused.cu`` for CUDA tensors (dq
    summed across the kernel's blocks in f32, in an order that varies from
    run to run, then cast to q's dtype; dk and dv the same bits on every
    run), by the plain version for CPU tensors."""
    global launches_bwd_fused
    _check_bwd(q, k, v, do, lse, delta)
    d, scale, (q, k, v, do) = _padded(scale, q, k, v, do)
    if _on_cpu(q):
        return _cut(d, *flash_bwd_plain(q, k, v, do, lse, delta, causal=causal, scale=scale))
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_fused", q, k, v, do, lse, delta,
                {"dq_acc": dq_acc, "dk": dk, "dv": dv}, causal, scale)
    launches_bwd_fused += 1
    return _cut(d, dq_acc.to(q.dtype), dk, dv)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 scale: float | None = None):
    """``dq`` by ``csrc/flash_bwd_dq.cu`` for CUDA tensors, by the plain
    version for CPU tensors."""
    global launches_bwd_dq
    _check_bwd(q, k, v, do, lse, delta)
    d, scale, (q, k, v, do) = _padded(scale, q, k, v, do)
    if _on_cpu(q):
        dq = flash_bwd_plain(q, k, v, do, lse, delta, causal=causal, dkv=False,
                             scale=scale)[0]
        return _cut(d, dq)[0]
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, {"dq": dq}, causal, scale)
    launches_bwd_dq += 1
    return _cut(d, dq)[0]


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  scale: float | None = None):
    """``(dk, dv)`` by ``csrc/flash_bwd_dkv.cu`` for CUDA tensors, by the
    plain version for CPU tensors."""
    global launches_bwd_dkv
    _check_bwd(q, k, v, do, lse, delta)
    d, scale, (q, k, v, do) = _padded(scale, q, k, v, do)
    if _on_cpu(q):
        return _cut(d, *flash_bwd_plain(q, k, v, do, lse, delta, causal=causal, dq=False,
                                        scale=scale)[1:])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, {"dk": dk, "dv": dv}, causal,
                scale)
    launches_bwd_dkv += 1
    return _cut(d, dk, dv)


def backward_route(s: int) -> str:
    """``"fused"`` for ``S <= 2048``, else ``"streamed"``: the JAX
    package's ``_fa_backward`` rule."""
    return "fused" if s <= _FUSED_BWD_MAX_KV else "streamed"


def flash_attention_backward(q, k, v, out, lse, do, *, causal: bool = True,
                             route: str | None = None, scale: float | None = None):
    """``(dq, dk, dv)`` of attention from the forward's ``out`` and ``lse``.

    ``route`` (default :func:`backward_route`): ``"fused"`` or
    ``"streamed"``.  ``scale`` defaults to ``1 / sqrt(D)``.
    """
    do = do.contiguous()
    delta = attention_delta(do, out)
    route = route or backward_route(q.shape[1])
    if route == "fused":
        return flash_bwd_fused(q, k, v, do, lse, delta, causal=causal, scale=scale)
    if route == "streamed":
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale)
        return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale))
    raise ValueError(f"unknown flash backward route {route!r} (fused|streamed)")


class _FlashAttention(torch.autograd.Function):
    """Attention on q, k, v already padded to the kernel's head dim, at the
    true head dim's ``scale``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd_with_lse(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, causal=ctx.causal,
                                              scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True):
    """Fused attention, ``(B, S, H, D)`` in and out, differentiable: the
    kernels on CUDA tensors, their plain versions on CPU tensors.  q, k and
    v are padded to the kernel's head dim before the autograd Function, so
    autograd cuts the gradients back to ``D``."""
    _check(q, k, v)
    d = q.shape[-1]
    out = _FlashAttention.apply(*_pad_head(q, k, v), causal, _scale(d))
    return out if out.shape[-1] == d else out[..., :d]


# ---------------------------------------------------------------------------
# Under a mesh: the kernel on each rank's block


def _mesh_split(mesh, batch_axes, head_axis):
    """The batch axes and the head axis of ``mesh`` that have size > 1."""
    from ...parallel.sharding import mesh_axis_sizes

    sizes = mesh_axis_sizes(mesh)
    batch = tuple(a for a in batch_axes if sizes.get(a, 1) > 1)
    head = head_axis if sizes.get(head_axis, 1) > 1 else None
    return batch, head


def shardable(mesh, q_shape, kv_shape, *, batch_axes=("dp", "fsdp"),
              head_axis: str = "tp") -> bool:
    """Whether the kernel can run under ``mesh`` through
    :func:`flash_attention_sharded`: the product of the batch axes divides
    the batch, and ``tp`` divides both head counts (whole GQA groups per
    shard)."""
    from ...parallel.sharding import mesh_axis_sizes

    sizes = mesh_axis_sizes(mesh)
    batch, head = _mesh_split(mesh, batch_axes, head_axis)
    b, hq, hkv = q_shape[0], q_shape[2], kv_shape[2]
    nb = math.prod(sizes[a] for a in batch)
    tp = sizes[head] if head else 1
    return b % nb == 0 and hq % tp == 0 and hkv % tp == 0


def on_blocks(fn, q, k, v, *, mesh, batch_axes=("dp", "fsdp"), head_axis: str = "tp"):
    """``fn(q, k, v)`` of attention on each rank's block of the global q, k,
    v (``DTensor``s, or plain tensors holding the whole arrays on every
    rank): the batch split over ``batch_axes`` and the heads over
    ``head_axis`` as far as each divides, the sequence whole.  The inputs are redistributed to that placement (no
    collective when they have it); the result is a ``DTensor`` so placed,
    or the whole output for plain inputs.  Differentiable: ``fn``'s
    backward runs on the blocks too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ...parallel.sharding import mesh_axis_sizes

    plain = not isinstance(q, DTensor)
    if plain:
        q, k, v = (DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
                   for x in (q, k, v))
    sizes = mesh_axis_sizes(mesh)
    batch, head = _mesh_split(mesh, batch_axes, head_axis)
    if q.shape[0] % math.prod(sizes[a] for a in batch):
        batch = ()
    if head and (q.shape[2] % sizes[head] or k.shape[2] % sizes[head]):
        head = None
    placements = [Shard(0) if a in batch else Shard(2) if a == head else Replicate()
                  for a in sizes]
    local = []
    for x in (q, k, v):
        if list(x.placements) != placements:
            x = x.redistribute(mesh, placements)
        local.append(x.to_local())
    out = DTensor.from_local(fn(*local), mesh, placements, run_check=False,
                             shape=q.shape, stride=q.stride())
    return out.full_tensor() if plain else out


def flash_attention_sharded(q, k, v, *, causal: bool = True, mesh,
                            batch_axes=("dp", "fsdp"), head_axis: str = "tp"):
    """:func:`flash_attention` under a mesh: the batch split over
    ``batch_axes``, the heads over ``head_axis``, the sequence whole, no
    collective; the kernels (forward and backward) run on each rank's
    block.  q, k, v are the global arrays as ``DTensor``s (or plain
    tensors, each rank holding the whole array); the result is of the same
    kind.  With no axis of size > 1 it is the bare :func:`flash_attention`.
    """
    from torch.distributed.tensor import DTensor

    if not shardable(mesh, q.shape, k.shape, batch_axes=batch_axes, head_axis=head_axis):
        from ...parallel.sharding import mesh_axis_sizes

        raise ValueError(
            f"flash_attention_sharded: q {tuple(q.shape)} / kv {tuple(k.shape)} not "
            f"divisible over mesh {mesh_axis_sizes(mesh)} "
            f"(batch_axes={tuple(batch_axes)}, head_axis={head_axis!r})"
        )
    batch, head = _mesh_split(mesh, batch_axes, head_axis)
    if not batch and head is None and not isinstance(q, DTensor):
        return flash_attention(q, k, v, causal=causal)
    return on_blocks(lambda a, b, c: flash_attention(a, b, c, causal=causal), q, k, v,
                     mesh=mesh, batch_axes=batch_axes, head_axis=head_axis)
