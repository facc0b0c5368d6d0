"""The yardsticks of ``chip_smoke.py``, checked on the CPU.

Each kernel's bound is the larger of its bytes over the H100's memory rate
and its operations over its tensor rate (``chip_smoke._flash_bound`` and
``_bwd_bound``); ``PERF.md`` states these values beside every kernel time.
"""

import pytest
import torch

import chip_smoke
from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

# (B, S, Hq, Hkv, D): the train path's two shapes, Llama-7B's 32 heads.
TRAIN_4x512 = (4, 512, 32, 32, 128)
TRAIN_1x4096 = (1, 4096, 32, 32, 128)


@pytest.mark.parametrize(
    "shape, bound_ms, bound_by",
    [(TRAIN_4x512, 0.0201, "bytes"), (TRAIN_1x4096, 0.139, "operations")],
    ids=["4x512", "1x4096"],
)
def test_flash_bound(shape, bound_ms, bound_by):
    got_ms, got_by = chip_smoke._flash_bound(*shape, torch.bfloat16, True)
    assert got_ms == pytest.approx(bound_ms, rel=3e-3)
    assert got_by == bound_by


@pytest.mark.parametrize(
    "kernel, bound_ms", [("flash_bwd_dq", 0.2085), ("flash_bwd_dkv", 0.2780)]
)
def test_bwd_bound(kernel, bound_ms):
    got_ms, got_by = chip_smoke._bwd_bound(kernel, *TRAIN_1x4096, torch.bfloat16, True)
    assert got_ms == pytest.approx(bound_ms, rel=1e-3)
    assert got_by == "operations"


def test_bwd_bound_fused_train_4x512():
    # The fused kernel at the 4 x 512 train step: q, k, v, do read and dq,
    # dk, dv written once (7 x 16.8 MB) plus lse and delta, by bytes.
    got_ms, got_by = chip_smoke._bwd_bound("flash_bwd_fused", *TRAIN_4x512, torch.bfloat16, True)
    assert got_ms == pytest.approx(0.03521, rel=1e-3)
    assert got_by == "bytes"


# The streamed rows of BWD_SHAPES beside the train path's: (B, S, Hq, Hkv,
# D, causal); bounds by operations (products x 2 D flops per pair).
GQA_RAGGED = (1, 4095, 32, 8, 128, True)
FULL_D64 = (2, 1000, 12, 12, 64, False)


@pytest.mark.parametrize(
    "kernel, shape, bound_ms",
    [("flash_bwd_dq", GQA_RAGGED, 0.20840), ("flash_bwd_dkv", GQA_RAGGED, 0.27787),
     ("flash_bwd_dq", FULL_D64, 0.0093185), ("flash_bwd_dkv", FULL_D64, 0.012425)],
    ids=["dq-gqa-ragged", "dkv-gqa-ragged", "dq-full-d64", "dkv-full-d64"],
)
def test_bwd_bound_streamed_rows(kernel, shape, bound_ms):
    b, s, hq, hkv, d, causal = shape
    row = next(r for r in chip_smoke.BWD_SHAPES
               if r[1:6] == (b, s, hq, hkv, d) and r[7] == causal)
    assert row[6] == torch.bfloat16 and row[8] == "streamed"
    got_ms, got_by = chip_smoke._bwd_bound(kernel, b, s, hq, hkv, d, torch.bfloat16, causal)
    assert got_ms == pytest.approx(bound_ms, rel=1e-4)
    assert got_by == "operations"


# The port's bf16 kernels as the card's profiler names them
# (torch.profiler on an H100, CUDA 12).
PROFILED_NAMES = {
    "flash_fwd": "void (anonymous namespace)::flash_fwd_bf16_wgmma<128>(CUtensorMap_st, "
                 "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float*, int, int, int, int, "
                 "float, int)",
    "flash_bwd_fused": "void tdx_bwd::(anonymous namespace)::flash_bwd_fused_wgmma<128>("
                       "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                       "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
                       "float const*, int, int, int, int, int, float, float)",
    "flash_bwd_dq": "void tdx_bwd::(anonymous namespace)::flash_bwd_dq_wgmma<128>("
                    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                    "CUtensorMap_st, float const*, float const*, int, int, int, int, float, "
                    "float)",
    "flash_bwd_dkv": "void tdx_bwd::(anonymous namespace)::flash_bwd_dkv_wgmma<128>("
                     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, int, int, "
                     "int, int, float, float)",
}


@pytest.mark.parametrize("kernel", sorted(PROFILED_NAMES))
def test_kernel_name_pattern_matches_one_kernel(kernel):
    # The train profile's per-kernel device time sums the kernels whose
    # names hold every fragment of the kernel's pattern: exactly its own.
    parts = chip_smoke._KERNEL_NAMES[kernel]
    matched = [k for k, name in PROFILED_NAMES.items() if all(p in name for p in parts)]
    assert matched == [kernel]
    assert not any(p in "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT" for p in parts)


def test_flash_shapes_take_the_kernels_head_dims():
    assert chip_smoke.FLASH_SHAPES[0][0] == "llama7b_main"
    for name, _b, _s, hq, hkv, d, dtype, _causal in chip_smoke.FLASH_SHAPES:
        assert d in fa._HEAD_DIMS, name
        assert dtype in fa._DTYPES, name
        assert hq % hkv == 0, name


@pytest.mark.parametrize("d", fa._HEAD_DIMS)
def test_bwd_shapes_hold_a_bf16_fused_row_per_head_dim(d):
    # Both instantiations of the fused kernel are held against the plain
    # backward on the card.
    assert any(r[5] == d and r[6] == torch.bfloat16 and r[8] == "fused"
               for r in chip_smoke.BWD_SHAPES)
