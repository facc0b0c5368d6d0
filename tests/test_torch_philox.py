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
