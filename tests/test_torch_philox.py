"""The counter-based generator (``ops/cuda/philox.py``): its plain version on
the CPU, which CPU tensors take and which the card's kernel is held to.

The raw words are held to Random123's published known-answer vectors for
philox4x32-10.  A box drawn alone is bit-equal to the same slice of the
whole draw (the property that lets each rank draw only its shard), for 1-4
dims, ragged offsets, the four dtypes and both distributions.  The draws
are held by statistics: moments and a Kolmogorov-Smirnov test against
scipy's distributions, and neighbouring streams (keys of consecutive ops)
and neighbouring elements uncorrelated.  The JAX package draws with
threefry, so its values differ by design: the seeded materializations of
the same recorded ``normal_`` / ``uniform_`` are held to JAX's by a
two-sample Kolmogorov-Smirnov test.
"""

import math

import numpy as np
import pytest
import scipy.stats
import torch

import torchdistx_tpu.deferred_init as jdi
from torchdistx_tpu.materialize import materialize_tensor_jax
from torchdistx_tpu_torch import deferred_init as tdi
from torchdistx_tpu_torch.materialize import materialize_tensor_torch, stream_seed
from torchdistx_tpu_torch.ops.cuda import philox

# Random123 (kat_vectors): philox4x32-10, counter words then key words,
# and the four output words.
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
KEY = stream_seed(11, 0, 5)
DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
# (full shape, box offset, box size): 1-4 dims, ragged offsets and sizes
# that cut Philox blocks (4 elements) at both ends.
BOXES = [
    ((1001,), (3,), (517,)),
    ((37, 29), (5, 7), (19, 13)),
    ((6, 11, 13), (1, 4, 3), (4, 5, 9)),
    ((3, 5, 7, 9), (1, 2, 1, 5), (2, 3, 5, 3)),
    ((64, 96), (32, 0), (32, 96)),  # an fsdp row shard: one contiguous run
]


def _draw(kind, dtype, shape, key=KEY, a=None, b=None, **box):
    a = {"normal": 0.25, "uniform": -1.5}.get(kind) if a is None else a
    b = {"normal": 1.75, "uniform": 2.5}.get(kind) if b is None else b
    size = box.pop("size", shape)
    out = torch.empty(size, dtype=torch.int32 if kind == "words" else dtype)
    if kind == "words":
        return philox.words_(out, key, full_shape=shape, **box)
    fill = philox.normal_ if kind == "normal" else philox.uniform_
    return fill(out, key, a, b, full_shape=shape, **box)


@pytest.mark.parametrize("ctr, key, want", KAT, ids=["zeros", "ones", "pi"])
def test_known_answers(ctr, key, want):
    assert philox.philox4x32(*ctr, *key) == want
    # The same words from int64 tensors (the plain version's own route).
    got = philox.philox4x32(*(torch.tensor([c]) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want


def test_words_follow_the_counter_and_lane_rule():
    # Element g is lane g % 4 of the block at counter (g // 4, 0).
    key = (0x1234567 << 32) | 0x89ABCDEF
    words = _draw("words", None, (10,), key=key).tolist()
    for g, w in enumerate(words):
        block = philox.philox4x32(g // 4, 0, 0, 0, 0x89ABCDEF, 0x1234567)
        assert w & 0xFFFFFFFF == block[g % 4], g


@pytest.mark.parametrize("shape, offset, size", BOXES, ids=[f"{len(b[0])}d" for b in BOXES[:4]]
                         + ["rows"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_box_equals_its_slice_of_the_whole(kind, dtype, shape, offset, size):
    whole = _draw(kind, dtype, shape)
    box = _draw(kind, dtype, shape, offset=offset, size=size)
    piece = whole
    for d, (o, n) in enumerate(zip(offset, size)):
        piece = piece.narrow(d, o, n)
    assert box.dtype == dtype and torch.equal(box, piece)


def test_words_box_equals_its_slice():
    shape, offset, size = BOXES[2]
    whole = _draw("words", None, shape)
    box = _draw("words", None, shape, offset=offset, size=size)
    assert torch.equal(box, whole[1:5, 4:9, 3:12])


def test_f64_takes_53_bits_and_casts_round_once():
    u64 = _draw("uniform", torch.float64, (4096,), a=0.0, b=1.0)
    # 53-bit uniforms: the low bits below float32's are used.
    assert (u64 * 2.0 ** 53 % 2 ** 29).ne(0).float().mean() > 0.99
    n32 = _draw("normal", torch.float32, (4096,))
    for dtype in (torch.bfloat16, torch.float16):
        assert torch.equal(_draw("normal", dtype, (4096,)), n32.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_statistics(kind, dtype):
    n = 1 << 18
    a, b = (0.5, 2.0) if kind == "normal" else (-1.0, 3.0)
    x = _draw(kind, dtype, (n,), a=a, b=b).double().numpy()
    if kind == "normal":
        assert abs(x.mean() - a) < 5 * b / n ** 0.5 and abs(x.std() / b - 1) < 0.01
        p = scipy.stats.kstest(x, "norm", args=(a, b)).pvalue
    else:
        assert x.min() >= a and x.max() < b
        assert abs(x.mean() - (a + b) / 2) < 5 * (b - a) / (12 * n) ** 0.5
        p = scipy.stats.kstest(x, "uniform", args=(a, b - a)).pvalue
    assert p > 1e-3, p


def test_neighbouring_streams_and_elements_are_independent():
    n = 1 << 16
    xs = [_draw("normal", torch.float64, (n,), key=stream_seed(0, 0, r), a=0.0, b=1.0).numpy()
          for r in range(4)]
    bound = 5 / n ** 0.5
    for x, y in zip(xs, xs[1:]):  # keys of consecutive ops
        assert abs(np.corrcoef(x, y)[0, 1]) < bound
        assert scipy.stats.ks_2samp(x, y).pvalue > 1e-3
    x = xs[0]
    for lag in (1, 2, 3, 4):  # lanes of one block, and the next block
        assert abs(np.corrcoef(x[:-lag], x[lag:])[0, 1]) < bound, lag
    # Another seed of the same op: another stream.
    other = _draw("normal", torch.float64, (n,), key=stream_seed(1, 0, 0), a=0.0, b=1.0)
    assert abs(np.corrcoef(xs[0], other.numpy())[0, 1]) < bound


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    before = philox.launches
    out = philox.normal_(torch.empty(33, 5), KEY, 0.0, 1.0)
    assert torch.equal(out, philox.fill_plain(torch.empty(33, 5), "normal", KEY, 0.0, 1.0))
    assert philox.launches == before  # no kernel ran
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        philox.normal_(torch.empty(4, device="meta"), KEY)
    with pytest.raises(TypeError, match="cannot write"):
        philox.uniform_(torch.empty(4, dtype=torch.int64), KEY)
    with pytest.raises(ValueError, match="contiguous"):
        philox.normal_(torch.empty(4, 4).t(), KEY)
    with pytest.raises(ValueError, match="not inside"):
        philox.normal_(torch.empty(4), KEY, full_shape=(6,), offset=(3,))


@pytest.mark.parametrize("fill, kind", [("normal_", "normal"), ("uniform_", "uniform")])
def test_seeded_draws_match_jax_in_distribution(fill, kind):
    # The same recording materialized by both packages: threefry there,
    # Philox here, the same distribution.
    def build():
        t = torch.empty(128, 256)
        getattr(t, fill)(-0.5, 1.5)
        return t

    with jdi._deferred_init_context():
        j = build()
    with tdi._deferred_init_context():
        t = build()
    want = np.asarray(materialize_tensor_jax(j, seed=4)).ravel()
    got = materialize_tensor_torch(t, seed=4, device="cpu").numpy().ravel()
    assert got.shape == want.shape
    assert scipy.stats.ks_2samp(got, want).pvalue > 1e-3
    if kind == "uniform":
        assert got.min() >= -0.5 and got.max() < 1.5


def test_fast_division_is_integer_division_below_2_31():
    # The kernel's row start divides by a box's sizes in 32 bits
    # (CUTLASS's FastDivmod); csrc/philox.cu's find_divisor, mirrored.
    rng = np.random.default_rng(5)
    divisors = [1, 2, 3, 5, 7, 64, 100, 4095, 65535, 65537, 2 ** 30 + 1, 2 ** 31 - 1]
    divisors += rng.integers(2, 2 ** 31, size=40).tolist()
    ns = [0, 1, 2 ** 31 - 1, 2 ** 31 - 2] + rng.integers(0, 2 ** 31, size=200).tolist()
    for d in divisors:
        mul, shr = philox._divisor(int(d))
        assert mul < 2 ** 32 and shr < 32
        for n in ns + [int(d) - 1, int(d), int(d) + 1, 2 * int(d) - 1]:
            if 0 <= n < 2 ** 31:
                assert philox._fast_div(n, mul, shr) == n // int(d), (n, d)


# (full shape, offset, size) of the kernel's launch plan: rows whose length
# is not a multiple of a unit, starts at every phase of a unit (row strides
# that are and are not multiples of it), rows narrower than a Philox block,
# one-element rows, more rows than a grid's y extent, 3-5 dims after
# merging (the 32-bit divisions), and a box in a tensor past 2^32 elements.
PLAN_BOXES = [
    ((1001,), (3,), (517,)), ((37, 29), (5, 7), (19, 13)), ((20, 64), (2, 3), (10, 50)),
    ((33, 101), (1, 1), (31, 99)), ((10, 1000), (2, 5), (7, 3)), ((1000, 7), (3, 6), (997, 1)),
    ((70000, 9), (0, 4), (70000, 3)), ((6, 11, 13), (1, 4, 3), (4, 5, 9)),
    ((3, 5, 7, 9), (1, 2, 1, 5), (2, 3, 5, 3)),
    ((4, 6, 5, 3, 10), (1, 1, 2, 0, 3), (3, 4, 2, 3, 6)),
    ((1 << 20, 1 << 14), ((1 << 20) - 3, 100), (3, 1000)), ((64, 96), (32, 0), (32, 96)),
]


@pytest.mark.parametrize("threads", [1, 7, 256, 4096])
@pytest.mark.parametrize("full, offset, size", PLAN_BOXES,
                         ids=[f"{len(b[0])}d_{i}" for i, b in enumerate(PLAN_BOXES)])
def test_launch_plan_covers_every_element_once(full, offset, size, threads):
    plan = philox.launch_plan(full, offset, size, threads)
    steps = [s for t in range(threads) for s in philox.walk(plan, t)]
    assert len(steps) == len(set(steps))  # no unit computed twice
    covered = []
    for row, e0 in steps:
        g0 = philox._row_start(plan, row)
        assert e0 % philox.UNIT == 0 and e0 < g0 + plan["len"] and e0 + philox.UNIT > g0
        covered += [(row, g) for g in range(max(e0, g0), min(e0 + philox.UNIT,
                                                             g0 + plan["len"]))]
    assert len(covered) == len(set(covered)) == math.prod(size)  # each element once
    # Each row's start: the 32-bit division against the plain one.
    plain = dict(plan, fast=False)
    for row in {0, plan["rows"] // 2, plan["rows"] - 1}:
        assert philox._row_start(plan, row) == philox._row_start(plain, row)
    # A row spans at most `units` units, every row exactly that many where
    # the row stride is a multiple of a unit.
    spans = {}
    for row, _ in steps:
        spans[row] = spans.get(row, 0) + 1
    assert max(spans.values()) <= plan["units"]
    if len(plan["size"]) == 1 or plan["full"][-1] % philox.UNIT == 0:
        assert set(spans.values()) == {plan["units"]}
    # A tiled box's flat loop: every unit whole in its row, unit q of the
    # box at out's elements from q UNIT.
    for row, e0 in steps if plan["tiled"] else []:
        g0 = philox._row_start(plan, row)
        assert g0 % philox.UNIT == 0 and g0 <= e0 and e0 + philox.UNIT <= g0 + plan["len"]
        q = row * plan["units"] + (e0 - g0) // philox.UNIT
        assert row * plan["len"] + e0 - g0 == q * philox.UNIT


def test_launch_plan_merges_whole_dims_and_strides_the_grid():
    # The embedding's fsdp=2 x tp=2 box: 16000 rows of 2048 from element
    # 16000 x 4096 + 2048, each 256 units; the whole embedding: one row.
    plan = philox.launch_plan((32000, 4096), (16000, 2048), (16000, 2048), 132 * 8 * 256)
    assert (plan["rows"], plan["len"], plan["units"]) == (16000, 2048, 256)
    assert (plan["step_rows"], plan["step_units"]) == divmod(132 * 8 * 256, 256)
    whole = philox.launch_plan((32000, 4096), (0, 0), (32000, 4096), 1024)
    assert (whole["rows"], whole["len"], whole["units"]) == (1, 32000 * 4096,
                                                             32000 * 4096 // 8)
    assert (whole["step_rows"], whole["step_units"]) == (0, 1024)
    assert plan["tiled"] and whole["tiled"]
    # Tiled: rows from a unit's start, of whole units.
    tiled = [philox.launch_plan(f, o, s, 256)["tiled"] for f, o, s in PLAN_BOXES]
    assert tiled == [False] * 11 + [True]
    assert philox.launch_plan((1001,), (8,), (512,), 256)["tiled"]
