"""Counter-based random fills: the Philox kernel's wrappers and its plain
version.

Replaces no TPU kernel.  The JAX package's seeded materialization draws with
threefry inside one XLA program whose outputs are sharded, so each chip
generates only its own shard (``torchdistx_tpu/materialize.py``'s
``rng_impl``, ``models/llama.py``'s ``init_sharded``).  The port's
counterpart is this generator: the value of element ``g`` (its row-major
index in the full tensor) is a function of the key and ``g`` alone, so any
rectangular box of a tensor, a rank's shard, can be drawn by itself and is
bit-equal to the same slice of the whole draw.

The definition (``csrc/philox.cu`` has it at length): Philox4x32-10 keyed by
the 64-bit ``key`` split into its low and high words; element ``g`` takes
lane ``g % 4`` of the block at counter ``(g // 4, 0)`` (a float64 also the
same lane of the block at ``(g // 4, 1)``); a uniform is 24 bits in [0, 1)
(53 for float64) scaled to ``[lo, hi)``; a normal is Box-Muller on the lane
pairs (0, 1) and (2, 3); float32 arithmetic (float64 for float64), rounded
once to the stored dtype (float32, bfloat16, float16 or float64).

:func:`normal_`, :func:`uniform_` and :func:`words_` write a box into
``out``: a CUDA tensor launches the kernel (and raises if it cannot be built
or launched), a CPU tensor takes the plain version :func:`fill_plain`, and
anything else raises.  Each launch adds one to :data:`launches`.  The plain
version is the same definition in torch ops on any device, in chunks whose
temporaries are each no larger than ``out``: the 32 x 32 -> 64-bit products
are taken on 16-bit halves of the multiplier, so no int64 product overflows
(:func:`philox4x32`).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build

__all__ = ["fill_plain", "launch_plan", "launches", "normal_", "philox4x32", "uniform_",
           "walk", "words_"]

# Kernel launches made by this process (a plain count; callers reset it).
launches = 0

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_KINDS = {"words": 0, "uniform": 1, "normal": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 3,
           torch.int32: 4}
# float(2 pi) in each compute dtype, as the kernel writes it.
_TWO_PI = {torch.float32: float(torch.tensor(2 * math.pi, dtype=torch.float32)),
           torch.float64: 2 * math.pi}
_MAX_DIMS = 8
# The plain version's temporaries: at most this many int64 elements each.
_MAX_CHUNK = 1 << 20
# Elements a kernel thread computes a step (csrc/philox.cu's kUnit): two
# Philox blocks, from an element index that is a multiple of it.
UNIT = 8

_LL = ctypes.c_longlong
_launcher_fn = None


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words ``(c0, c1, c2, c3)`` (ints, or
    int64 tensors of one shape, in [0, 2^32)) under the key ``(k0, k1)``:
    the four output words, ints or tensors as given.

    The two words each round multiplies are stacked as one ``(2, n)``
    tensor and the two it xors as another, so a round is a few ops on
    ``2 x n`` elements.  A 32 x 32 -> 64-bit product would overflow int64,
    so the multipliers are split into 16-bit halves: ``x * m_lo`` and ``x *
    m_hi`` stay below 2^48."""
    like = next((c for c in (c0, c1, c2, c3) if isinstance(c, torch.Tensor)), None)
    dev, shape = (like.device, like.shape) if like is not None else ("cpu", ())

    def col(words):
        return torch.stack([torch.as_tensor(w, dtype=torch.int64, device=dev).expand(shape)
                            .reshape(-1) for w in words])

    a, b = col((c0, c2)), col((c1, c3))
    m_lo = col((_M0 & 0xFFFF, _M1 & 0xFFFF))[:, :1]
    m_hi = col((_M0 >> 16, _M1 >> 16))[:, :1]
    k, step = col((k0, k1))[:, :1], col((_W0, _W1))[:, :1]
    for _ in range(10):
        p_lo = a * m_lo
        p_hi = a * m_hi
        t = (p_hi & 0xFFFF).bitwise_left_shift_(16).add_(p_lo)  # low 48 bits, carried
        hi = p_hi.bitwise_right_shift_(16).add_(t >> 32)  # (hi0, hi1)
        # (c0, c2) <- (hi1 ^ c1 ^ k0, hi0 ^ c3 ^ k1); (c1, c3) <- (lo1, lo0)
        a = hi.flip(0).bitwise_xor_(b).bitwise_xor_(k)
        b = t.bitwise_and_(_MASK32).flip(0)
        k = (k + step) & _MASK32
    words = [w.reshape(shape) for w in (a[0], b[0], a[1], b[1])]
    return tuple(int(w) for w in words) if like is None else tuple(words)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scalars(kind: str, a: float, b: float, dtype: torch.dtype) -> Tuple[float, float]:
    """The kernel's ``(a, b)``: ``(lo, hi - lo)`` for a uniform, ``(mean,
    std)`` for a normal, each a value of the compute dtype (``hi - lo`` taken
    in it)."""
    cd = _compute_dtype(dtype)
    a_t, b_t = torch.tensor(a, dtype=cd), torch.tensor(b, dtype=cd)
    if kind == "uniform":
        b_t = b_t - a_t
    return float(a_t), float(b_t)


def _unit(w, w2, cd, open_low: bool):
    """Uniform variates from words: 24 bits in float32, 53 (``w`` and
    ``w2``) in float64; in (0, 1] if ``open_low``, else [0, 1)."""
    if cd == torch.float64:
        bits = ((w >> 5) << 26) | (w2 >> 6)
        return (bits + int(open_low)).to(cd) * 2.0 ** -53
    return ((w >> 8) + int(open_low)).to(cd) * 2.0 ** -24


def _block_values(kind: str, ctr, key: int, a: float, b: float, cd):
    """``(..., 4 * n)`` values of the blocks at counters ``ctr`` (``(..., n)``
    int64), lanes in order: raw words (int64) or variates in ``cd``."""
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    c0, c1 = ctr & _MASK32, ctr >> 32
    w = philox4x32(c0, c1, 0, 0, k0, k1)
    if kind == "words":
        return torch.stack(w, dim=-1).flatten(-2)
    w2 = philox4x32(c0, c1, 1, 0, k0, k1) if cd == torch.float64 else (None,) * 4
    if kind == "uniform":
        z = [_unit(w[lane], w2[lane], cd, False) for lane in range(4)]
    else:
        z = []
        for p in (0, 1):
            u1 = _unit(w[2 * p], w2[2 * p], cd, True)
            u2 = _unit(w[2 * p + 1], w2[2 * p + 1], cd, False)
            r = torch.log(u1).mul_(-2.0).sqrt_()
            theta = u2.mul_(_TWO_PI[cd])
            z += [r * torch.cos(theta), r.mul_(torch.sin(theta))]
    return torch.stack(z, dim=-1).flatten(-2).mul_(b).add_(a)


def _collapse(full_shape, offset, size):
    """``(full_shape, offset, size)`` with each dim merged into the one
    before it where the box spans it whole: the same elements, fewer dims
    (at least one)."""
    full, off, sz = [1], [0], [1]
    for n, o, s in zip(full_shape, offset, size):
        if o == 0 and s == n:
            full[-1], off[-1], sz[-1] = full[-1] * n, off[-1] * n, sz[-1] * n
        else:
            full.append(n)
            off.append(o)
            sz.append(s)
    if len(full) > 1 and full[0] == 1:
        full, off, sz = full[1:], off[1:], sz[1:]
    return full, off, sz


def _divisor(d: int) -> Tuple[int, int]:
    """CUTLASS's FastDivmod constants ``(mul, shr)`` of ``d`` (csrc/philox.cu's
    ``find_divisor``): ``n // d == _fast_div(n, mul, shr)`` for ``0 <= n <
    2^31``; ``mul`` 0 for ``d`` 1."""
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()  # 31 + ceil(log2(d))
    return ((1 << p) + d - 1) // d, p - 32


def _fast_div(n: int, mul: int, shr: int) -> int:
    return n if mul == 0 else ((n * mul) >> 32) >> shr


def launch_plan(full_shape, offset, size, grid_threads: int) -> dict:
    """The kernel's launch plan of a box (csrc/philox.cu's ``Box``, as
    ``tdx_philox_fill`` and ``launch`` fill it), for ``grid_threads``
    threads in all: the box with whole dims merged, its ``rows`` and
    ``len``, ``units`` a row (a unit: UNIT elements from a multiple of
    UNIT), the grid's stride in whole rows and units, whether a row's start
    may divide in 32 bits (``fast``), each dim's divisor constants, and
    whether the box is ``tiled`` (every row starts at a unit's first
    element and spans whole units: the kernel's flat loop, for an output
    at a 16-byte-aligned address)."""
    full, off, size = _collapse([int(n) for n in full_shape], [int(o) for o in offset],
                                [int(s) for s in size])
    rows, length = math.prod(size[:-1]), size[-1]
    # Every row starts at offset[-1] modulo UNIT where the row stride is a
    # multiple of UNIT; else a row may start anywhere in its first unit.
    phase = off[-1] % UNIT if len(size) == 1 or full[-1] % UNIT == 0 else UNIT - 1
    units = (phase + length - 1) // UNIT + 1
    return {"full": full, "offset": off, "size": size, "rows": rows, "len": length,
            "units": units, "step_rows": grid_threads // units,
            "step_units": grid_threads % units,
            "fast": rows < 1 << 31 and all(s < 1 << 31 for s in size),
            "tiled": phase == 0 and length % UNIT == 0,
            "divisors": [_divisor(s) if s < 1 << 31 else (0, 0) for s in size]}


def _row_start(plan: dict, row: int) -> int:
    """Row ``row``'s first element in the full tensor (csrc/philox.cu's
    ``row_start``)."""
    full, off, size = plan["full"], plan["offset"], plan["size"]
    strides = [math.prod(full[d + 1:]) for d in range(len(full))]
    nd = len(size)
    if nd == 1:
        return off[0]
    if nd == 2:
        return off[1] + (off[0] + row) * strides[0]
    g0, rest = off[-1], row
    for d in range(nd - 2, 0 if plan["fast"] else -1, -1):
        q = _fast_div(rest, *plan["divisors"][d]) if plan["fast"] else rest // size[d]
        g0 += (off[d] + rest - q * size[d]) * strides[d]
        rest = q
    return g0 + (off[0] + rest) * strides[0] if plan["fast"] else g0


def walk(plan: dict, thread: int):
    """The ``(row, first element of the unit)`` that thread ``thread`` of the
    plan's grid computes, step by step (csrc/philox.cu's ``philox_fill``
    loop): its first from one division, then carried by the grid's
    stride; a unit past its row's end is skipped."""
    row, u = divmod(thread, plan["units"])
    while row < plan["rows"]:
        g0 = _row_start(plan, row)
        e0 = (g0 // UNIT + u) * UNIT
        if e0 < g0 + plan["len"]:
            yield row, e0
        u += plan["step_units"]
        row += plan["step_rows"]
        if u >= plan["units"]:
            u -= plan["units"]
            row += 1


def _box(out: torch.Tensor, full_shape, offset):
    size = list(out.shape)
    full_shape = size if full_shape is None else [int(n) for n in full_shape]
    offset = [0] * len(size) if offset is None else [int(o) for o in offset]
    if not (len(full_shape) == len(offset) == len(size)):
        raise ValueError(f"a box of {len(size)} dims needs a shape and offset of as many, "
                         f"not {full_shape} and {offset}")
    if any(o < 0 or s < 0 or o + s > n for n, o, s in zip(full_shape, offset, size)):
        raise ValueError(f"box {size} at {offset} is not inside {full_shape}")
    return _collapse(full_shape, offset, size)


def fill_plain(out: torch.Tensor, kind: str, key: int, a: float = 0.0, b: float = 1.0, *,
               full_shape: Optional[Sequence[int]] = None,
               offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The plain version: write into ``out`` (contiguous, on any device) the
    box of size ``out.shape`` at ``offset`` of a tensor of ``full_shape``
    (default: ``out`` is the whole tensor) drawn under ``key`` as ``kind``
    (``"normal"``: ``a`` mean, ``b`` std; ``"uniform"``: ``[a, b)``;
    ``"words"``: the raw words as int32 bits)."""
    _check(out, kind)
    with _one_thread(out.device):
        return _fill_plain(out, kind, key, a, b, full_shape, offset)


@contextlib.contextmanager
def _one_thread(device: torch.device):
    """On the CPU, torch's intra-op threads set to one while the plain
    version runs: its ops are many and short, and where several processes
    share the host (a test run's workers), waking a pool of threads for each
    costs several times the work (ResNet-50's seeded materialize in a
    4-worker test run: 20 s with the pool, 3 s without)."""
    threads = torch.get_num_threads()
    if device.type != "cpu" or threads == 1:
        yield
        return
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _fill_plain(out, kind, key, a, b, full_shape, offset):
    full, off, size = _box(out, full_shape, offset)
    cd = _compute_dtype(out.dtype)
    if kind != "words":
        a, b = _scalars(kind, a, b, out.dtype)
    dev = out.device
    length = size[-1]
    rows = math.prod(size[:-1])
    if rows * length == 0:
        return out
    strides = [math.prod(full[d + 1:]) for d in range(len(full))]
    flat = out.view(rows, length)
    budget = max(16, min(_MAX_CHUNK, out.numel() * out.element_size() // 8))
    lc = min(length, max(4, budget // 2))
    rc = max(1, budget // (lc + 8))
    n_blocks = (lc + 3) // 4 + 1
    for r0 in range(0, rows, rc):
        r1 = min(rows, r0 + rc)
        rest = torch.arange(r0, r1, device=dev)
        g_row = torch.full_like(rest, off[-1])
        for d in range(len(size) - 2, -1, -1):
            g_row += (rest % size[d] + off[d]) * strides[d]
            rest = rest // size[d]
        del rest
        for c0 in range(0, length, lc):
            c1 = min(length, c0 + lc)
            g0 = g_row + c0
            first = g0 >> 2
            ctr = first[:, None] + torch.arange(n_blocks, device=dev)
            vals = _block_values(kind, ctr, key, a, b, cd)
            del ctr
            cols = (g0 - 4 * first)[:, None] + torch.arange(c1 - c0, device=dev)
            picked = vals.gather(1, cols)
            del vals, cols
            if kind == "words":
                picked = torch.where(picked >= 1 << 31, picked - (1 << 32), picked)
            flat[r0:r1, c0:c1] = picked
    return out


def _check(out: torch.Tensor, kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"kind {kind!r} is not one of {sorted(_KINDS)}")
    if (out.dtype == torch.int32) != (kind == "words") or out.dtype not in _DTYPES:
        raise TypeError(f"a {kind} fill cannot write {out.dtype}")
    if not out.is_contiguous():
        raise ValueError("philox fills write a contiguous tensor")


def _launcher():
    global _launcher_fn
    if _launcher_fn is None:
        fn = _build.load("philox").tdx_philox_fill
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(_LL), ctypes.POINTER(_LL), ctypes.POINTER(_LL),
                       ctypes.c_ulonglong, ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher_fn = fn
    return _launcher_fn


def _fill(out, kind, key, a, b, full_shape, offset):
    global launches
    _check(out, kind)
    if out.device.type == "cpu":
        return fill_plain(out, kind, key, a, b, full_shape=full_shape, offset=offset)
    if out.device.type != "cuda":
        raise RuntimeError(f"the philox kernel runs on CUDA tensors, not {out.device}")
    full, off, size = _box(out, full_shape, offset)
    if out.numel() == 0:
        return out
    if len(size) > _MAX_DIMS:
        raise ValueError(f"the philox kernel takes boxes of up to {_MAX_DIMS} dims "
                         f"after merging whole ones, not {len(size)}")
    if kind != "words":
        a, b = _scalars(kind, a, b, out.dtype)
    from .flash_attention import _call_on

    n = len(size)
    err = _call_on(out.device, _launcher(), out.data_ptr(), _DTYPES[out.dtype], _KINDS[kind],
                   n, (_LL * n)(*full), (_LL * n)(*off), (_LL * n)(*size),
                   key & 0xFFFFFFFFFFFFFFFF, float(a), float(b))
    if err != 0:
        raise RuntimeError(f"philox kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def normal_(out: torch.Tensor, key: int, mean: float = 0.0, std: float = 1.0, *,
            full_shape: Optional[Sequence[int]] = None,
            offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``out`` filled with the box at ``offset`` of a normal draw of
    ``full_shape`` (default ``out.shape``) under ``key``."""
    return _fill(out, "normal", key, mean, std, full_shape, offset)


def uniform_(out: torch.Tensor, key: int, lo: float = 0.0, hi: float = 1.0, *,
             full_shape: Optional[Sequence[int]] = None,
             offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``out`` filled with the box at ``offset`` of a uniform ``[lo, hi)``
    draw of ``full_shape`` (default ``out.shape``) under ``key``."""
    return _fill(out, "uniform", key, lo, hi, full_shape, offset)


def words_(out: torch.Tensor, key: int, *, full_shape: Optional[Sequence[int]] = None,
           offset: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``out`` (int32) filled with the raw Philox words of the box, as bits."""
    return _fill(out, "words", key, 0.0, 0.0, full_shape, offset)
