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


# The f32 train gates' attention (llama_7b's 32 heads of 128 at 4 x 512,
# causal), both routes: bounds by operations at the f32 rate, 67 TFLOP/s.
TRAIN_GATE_F32 = (4, 512, 32, 32, 128)


@pytest.mark.parametrize(
    "kernel, route, bound_ms",
    [("flash_bwd_fused", "fused", 0.32115), ("flash_bwd_dq", "streamed", 0.19269),
     ("flash_bwd_dkv", "streamed", 0.25692)],
    ids=["fused", "dq", "dkv"],
)
def test_bwd_bound_train_gate_f32_rows(kernel, route, bound_ms):
    row = next(r for r in chip_smoke.BWD_SHAPES
               if r[0] == "train_gate_f32" and r[8] == route)
    assert row[1:8] == (*TRAIN_GATE_F32, torch.float32, True)
    got_ms, got_by = chip_smoke._bwd_bound(kernel, *TRAIN_GATE_F32, torch.float32, True)
    assert got_ms == pytest.approx(bound_ms, rel=1e-4)
    assert got_by == "operations"


def test_train_gate_f32_rows_are_the_gates_shapes():
    # The rows' shape is the f32 train gates' attention at TRAIN_SHAPES'
    # 4 x 512 with llama_7b's heads; the forward row is there too.
    from torchdistx_tpu_torch.models.llama import llama_7b

    cfg = llama_7b()
    b, s = chip_smoke.TRAIN_SHAPES[0][0]
    want = (b, s, cfg.n_heads, cfg.n_kv_heads, cfg.dim // cfg.n_heads)
    assert want == TRAIN_GATE_F32
    routes = sorted(r[8] for r in chip_smoke.BWD_SHAPES if r[0] == "train_gate_f32")
    assert routes == ["fused", "streamed"]
    fwd = [r for r in chip_smoke.FLASH_SHAPES if r[0] == "train_gate_f32"]
    assert fwd == [("train_gate_f32", *TRAIN_GATE_F32, torch.float32, True)]


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
# The bf16 D = 256 dk/dv instance, a kernel of its own (profiled under the
# dk/dv pattern too).
PROFILED_DKV_WIDE = ("void tdx_bwd::(anonymous namespace)::flash_bwd_dkv_wgmma_wide<256>("
                     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, int, int, "
                     "int, int, float, float)")


@pytest.mark.parametrize("kernel", sorted(PROFILED_NAMES))
def test_kernel_name_pattern_matches_one_kernel(kernel):
    # The train profile's per-kernel device time sums the kernels whose
    # names hold every fragment of the kernel's pattern: exactly its own.
    parts = chip_smoke._KERNEL_NAMES[kernel]
    matched = [k for k, name in PROFILED_NAMES.items() if all(p in name for p in parts)]
    assert matched == [kernel]
    assert all(p in PROFILED_DKV_WIDE for p in parts) == (kernel == "flash_bwd_dkv")
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


def test_fit_flops_at_two_layers_of_llama_7b():
    # 6 x matmul params x tokens (the embedding table left out) plus the
    # causal attention products, 3 x 4 D flops a pair, over 2 layers.
    import dataclasses

    from torchdistx_tpu_torch.models.llama import llama_7b

    cfg = dataclasses.replace(llama_7b(), n_layers=chip_smoke.FIT_LAYERS)
    b, s = chip_smoke.FIT_SHAPE
    matmul = 535_842_816  # 666,914,816 params less the 32000 x 4096 embedding
    attention = 3 * 4 * b * 32 * 128 * (s * (s + 1) // 2) * 2
    assert chip_smoke._fit_flops(cfg, b, s) == 6 * matmul * b * s + attention
    assert chip_smoke._fit_flops(cfg, b, s) == pytest.approx(6.6361e12, rel=1e-4)


def test_padded_head_dims_have_no_instance_and_fit_one():
    for d in chip_smoke.PADDED_HEAD_DIMS:
        assert d not in fa._HEAD_DIMS
        assert fa._kernel_head_dim(d) in fa._HEAD_DIMS


def test_fit_run_is_cut_and_interrupted_as_documented():
    # The fused route (S <= 2048), a stop strictly inside the run, and a
    # checkpoint cadence that keeps FIT_KEEP steps around the stop.
    b, s = chip_smoke.FIT_SHAPE
    assert fa.backward_route(s) == "fused"
    assert 1 < chip_smoke.FIT_STOP < chip_smoke.FIT_STEPS
    assert chip_smoke.FIT_STOP % chip_smoke.FIT_EVERY != 0


# The 256 instances at phase 2's wide_d256 shape (B 2, S 1024, 16/16 heads,
# causal) and at the D = 256 path's bf16 shape (1 x 2112, 4/2 heads): bf16
# bounds against the tensor rate, f32 against the CUDA cores'.  The bf16
# forward and dk/dv (TMA + wgmma since this slice) are the rows whose times
# PERF.md sets beside these bounds.
@pytest.mark.parametrize(
    "shape, kernel, dtype, bound_ms, bound_by",
    [("wide_d256", "flash_fwd", torch.bfloat16, 0.020072, "bytes"),
     ("wide_d256", "flash_bwd_fused", torch.bfloat16, 0.043470, "operations"),
     ("wide_d256", "flash_bwd_dq", torch.float32, 0.38500, "operations"),
     ("wide_d256", "flash_bwd_dkv", torch.float32, 0.51333, "operations"),
     ("wide_d256", "flash_bwd_dkv", torch.bfloat16, 0.034776, "operations"),
     ("d256_path_bf16", "flash_fwd", torch.bfloat16, 0.0092412, "operations"),
     ("d256_path_bf16", "flash_bwd_dkv", torch.bfloat16, 0.018482, "operations")],
)
def test_wide_shape_bounds(shape, kernel, dtype, bound_ms, bound_by):
    row = next(r for r in chip_smoke.FLASH_SHAPES if r[0] == shape)
    assert row[5] == 256 and row[6] == torch.bfloat16
    args = (*row[1:6], dtype, True)
    if kernel == "flash_fwd":
        got_ms, got_by = chip_smoke._flash_bound(*args)
    else:
        got_ms, got_by = chip_smoke._bwd_bound(kernel, *args)
    assert got_ms == pytest.approx(bound_ms, rel=1e-4)
    assert got_by == bound_by


# The bf16 D = 512 rows at phase 2's wide_d512 shape (B 2, S 1024, 8/8
# heads of 512, causal): the bytes and operations of wide_d256 in half the
# heads, so the same bounds (the forward's lse bytes are half as many).
@pytest.mark.parametrize(
    "kernel, bound_ms, bound_by",
    [("flash_fwd", 0.020052, "bytes"),
     ("flash_bwd_dkv", 0.034776, "operations"),
     ("flash_bwd_fused", 0.043470, "operations"),
     ("flash_bwd_dq", 0.026082, "operations")],
)
def test_wide_d512_bounds(kernel, bound_ms, bound_by):
    row = next(r for r in chip_smoke.FLASH_SHAPES if r[0] == "wide_d512")
    assert row[1:] == (2, 1024, 8, 8, 512, torch.bfloat16, True)
    assert sum(r[0] == "wide_d512" for r in chip_smoke.BWD_SHAPES) == 2
    if kernel == "flash_fwd":
        got_ms, got_by = chip_smoke._flash_bound(*row[1:])
    else:
        got_ms, got_by = chip_smoke._bwd_bound(kernel, *row[1:])
    assert got_ms == pytest.approx(bound_ms, rel=1e-4)
    assert got_by == bound_by


def test_wide_llama_has_256_wide_heads():
    cfg = chip_smoke._wide_llama_cfg()
    assert cfg.head_dim == 256 and cfg.n_heads % cfg.n_kv_heads == 0
    assert fa._kernel_head_dim(cfg.head_dim) == 256
    assert chip_smoke.WIDE_STREAMED_S > 2048 and fa.backward_route(chip_smoke.WIDE_STREAMED_S) \
        == "streamed"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_d256_path_rows_are_the_paths_own_shapes(dtype):
    # Phase 2 holds each D = 256 kernel that the D = 256 path launches at the
    # path's own (B, S, Hq, Hkv, D) and dtype: f32 at WIDE_F32_BATCH (the
    # fused backward), bf16 at 1 x WIDE_STREAMED_S (the streamed pair).
    cfg = chip_smoke._wide_llama_cfg()
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    b, s = chip_smoke.WIDE_F32_BATCH if dtype == torch.float32 else (1, chip_smoke.WIDE_STREAMED_S)
    name = chip_smoke.WIDE_PATH_SHAPES[dtype]
    fwd = [r for r in chip_smoke.FLASH_SHAPES if r[0] == name]
    assert [r[1:] for r in fwd] == [(b, s, *heads, dtype, True)]
    bwd = [r for r in chip_smoke.BWD_SHAPES if r[0] == name]
    assert [r[1:] for r in bwd] == [(b, s, *heads, dtype, True, fa.backward_route(s))]


def test_kernels_line_takes_the_d256_rows_at_the_paths_shapes():
    # Fake rows named by phase 2's shapes; the D = 256 entries must come
    # from the path's own rows with the launches of the path's part in
    # that dtype, and every entry carries the contract's keys.
    shapes = sorted({r[0] for r in chip_smoke.FLASH_SHAPES + chip_smoke.BWD_SHAPES})

    def row(spec, kernel=None):
        shape, d, dtype = spec[0], spec[5], spec[6]
        r = {"shape": shape, "max_abs_err": 0.0, "ms": shapes.index(shape), "plain_ms": 2.0,
             "bound_ms": 0.5, "bound_by": "bytes", "library_ms": 0.1,
             "instance": chip_smoke._instance(kernel or "flash_fwd", d, dtype)}
        return r if kernel is None else {**r, "kernel": kernel}

    rows = [row(r) for r in chip_smoke.FLASH_SHAPES]
    bwd_rows = [row(r, k) for r in chip_smoke.BWD_SHAPES
                for k in chip_smoke.BWD_KERNELS[r[8]]]
    wide = {"launches_f32": {"flash_fwd": 8, "flash_bwd_fused": 6, "flash_bwd_dq": 0,
                             "flash_bwd_dkv": 0},
            "launches_bf16": {"flash_fwd": 2, "flash_bwd_fused": 0, "flash_bwd_dq": 2,
                              "flash_bwd_dkv": 2}}
    entries = chip_smoke._kernels_line(rows, bwd_rows, lambda k: {"train": 3}, wide)
    names = [e["name"] for e in entries]
    assert names == ["flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
                     "flash_fwd (D 256, float32)", "flash_bwd_fused (D 256, float32)",
                     "flash_fwd (D 256, bfloat16)", "flash_bwd_dq (D 256, bfloat16)",
                     "flash_bwd_dkv (D 256, bfloat16)"]
    assert [e["launches"] for e in entries] == [3, 3, 3, 3, 8, 6, 2, 2, 2]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "instance"}
    assert all(keys <= set(e) for e in entries)
    f32, bf16 = (shapes.index(chip_smoke.WIDE_PATH_SHAPES[d])
                 for d in (torch.float32, torch.bfloat16))
    assert [e["ms"] for e in entries[4:]] == [f32, f32, bf16, bf16, bf16]
    assert entries[6]["source"] == "torchdistx_tpu_torch/ops/cuda/csrc/flash_fwd.cu"
    assert entries[6]["replaces"] == "torchdistx_tpu/ops/pallas/flash_attention.py:161"
    # The D = 256 path's bf16 step runs the TMA + wgmma forward, dq and
    # dk/dv; the f32 part runs on the register-blocked CUDA-core bodies.
    assert [e["instance"] for e in entries[4:]] == [
        "q_f32_tiled<(int)256, (bool)0>", "bwd_kv_f32_tiled<(int)256, (bool)1>",
        "flash_fwd_bf16_wgmma<(int)256>", "flash_bwd_dq_wgmma_wide<(int)256>",
        "flash_bwd_dkv_wgmma_wide<(int)256>"]
    assert entries[0]["instance"] == "flash_fwd_bf16_wgmma<(int)128>"


# The instance each (kernel, kernel head dim, dtype) runs, as the sources'
# dispatch (tdx_flash_fwd, tdx_flash_bwd_*) picks it: bf16 at D 256 and 512
# takes TMA + wgmma for every kernel, and no CUDA-core body (the backward
# kernels on clusters of two blocks at 512); f32 runs on the CUDA cores, the
# forward and dq on the q-tile body, dk/dv and fused on the kv-tile body.
@pytest.mark.parametrize(
    "kernel, d, dtype, instance",
    [("flash_fwd", 256, torch.bfloat16, "flash_fwd_bf16_wgmma<(int)256>"),
     ("flash_bwd_dkv", 256, torch.bfloat16, "flash_bwd_dkv_wgmma_wide<(int)256>"),
     ("flash_bwd_fused", 256, torch.bfloat16, "flash_bwd_fused_wgmma_wide<(int)256>"),
     ("flash_bwd_dq", 256, torch.bfloat16, "flash_bwd_dq_wgmma_wide<(int)256>"),
     pytest.param("flash_fwd", 256, torch.float32, "q_f32_tiled<(int)256, (bool)0>",
                  id="flash_fwd-256-dtype4-flash_fwd_f32<float, (int)256>"),
     ("flash_bwd_dkv", 256, torch.float32, "bwd_kv_f32_tiled<(int)256, (bool)0>"),
     ("flash_bwd_fused", 256, torch.float32, "bwd_kv_f32_tiled<(int)256, (bool)1>"),
     pytest.param("flash_bwd_dq", 256, torch.float32, "q_f32_tiled<(int)256, (bool)1>",
                  id="flash_bwd_dq-256-dtype7-bwd_dq_f32<float, (int)256>"),
     ("flash_fwd", 512, torch.bfloat16, "flash_fwd_bf16_wgmma<(int)512>"),
     ("flash_bwd_dkv", 512, torch.bfloat16, "flash_bwd_dkv_wgmma_wide<(int)512>"),
     ("flash_bwd_fused", 512, torch.bfloat16, "flash_bwd_fused_wgmma_wide<(int)512>"),
     ("flash_bwd_dq", 512, torch.bfloat16, "flash_bwd_dq_wgmma_wide<(int)512>"),
     pytest.param("flash_fwd", 512, torch.float32, "q_f32_tiled<(int)512, (bool)0>",
                  id="flash_fwd-512-dtype12-flash_fwd_f32<float, (int)512>"),
     ("flash_bwd_dkv", 512, torch.float32, "bwd_kv_f32_tiled<(int)512, (bool)0>"),
     ("flash_bwd_fused", 512, torch.float32, "bwd_kv_f32_tiled<(int)512, (bool)1>"),
     ("flash_bwd_dkv", 64, torch.float32, "bwd_kv_f32_tiled<(int)64, (bool)0>"),
     ("flash_bwd_fused", 64, torch.float32, "bwd_kv_f32_tiled<(int)64, (bool)1>"),
     ("flash_bwd_dkv", 128, torch.float32, "bwd_kv_f32_tiled<(int)128, (bool)0>"),
     ("flash_bwd_fused", 128, torch.float32, "bwd_kv_f32_tiled<(int)128, (bool)1>"),
     ("flash_bwd_dkv", 128, torch.bfloat16, "flash_bwd_dkv_wgmma<(int)128>"),
     ("flash_bwd_fused", 64, torch.bfloat16, "flash_bwd_fused_wgmma<(int)64>"),
     ("flash_bwd_dq", 512, torch.float32, "q_f32_tiled<(int)512, (bool)1>"),
     ("flash_fwd", 64, torch.float32, "q_f32_tiled<(int)64, (bool)0>"),
     ("flash_bwd_dq", 64, torch.float32, "q_f32_tiled<(int)64, (bool)1>"),
     ("flash_fwd", 128, torch.float32, "q_f32_tiled<(int)128, (bool)0>"),
     ("flash_bwd_dq", 128, torch.float32, "q_f32_tiled<(int)128, (bool)1>")],
)
def test_instance_names_the_dispatch(kernel, d, dtype, instance):
    assert chip_smoke._instance(kernel, d, dtype) == instance


def test_d256_wgmma_instances_are_found_in_a_ptxas_report():
    # The [build] line reads the new instances' registers and spills from
    # the report, whose keys carry the namespaces (names as cu++filt gives
    # them on the card); an instance absent from the report reads None.
    report = {"<unnamed>::flash_fwd_bf16_wgmma<(int)256>": {"registers": 128},
              "tdx_bwd::<unnamed>::flash_bwd_fused_wgmma_wide<(int)256>": {"registers": 232},
              "tdx_bwd::<unnamed>::flash_bwd_dq_wgmma_wide<(int)256>": {"registers": 229},
              "tdx_bwd::<unnamed>::flash_bwd_dkv_wgmma_wide<(int)256>": {"registers": 232},
              "tdx_bwd::bwd_kv_f32<float, (int)256, (bool)0>": {"registers": 168}}
    assert {k: chip_smoke._in_report(report, n)["registers"]
            for k, n in chip_smoke.D256_WGMMA.items()} == {"flash_fwd": 128,
                                                           "flash_bwd_fused": 232,
                                                           "flash_bwd_dq": 229,
                                                           "flash_bwd_dkv": 232}
    assert chip_smoke._in_report(report, "flash_fwd_f32<__nv_bfloat16, (int)256>") is None
    assert chip_smoke._in_report(report, "bwd_kv_f32<float, (int)256, (bool)0>") == {
        "registers": 168}


def test_d512_wgmma_instances_are_found_in_a_ptxas_report():
    # The [build] line checks the four bf16 D = 512 kernels (TMA + wgmma)
    # for spills; the CUDA-core bodies that they replaced are no instance of
    # the build.
    report = {"<unnamed>::flash_fwd_bf16_wgmma<(int)512>": {"registers": 180},
              "tdx_bwd::<unnamed>::flash_bwd_fused_wgmma_wide<(int)512>": {"registers": 215},
              "tdx_bwd::<unnamed>::flash_bwd_dq_wgmma_wide<(int)512>": {"registers": 206},
              "tdx_bwd::<unnamed>::flash_bwd_dkv_wgmma_wide<(int)512>": {"registers": 215}}
    assert {k: chip_smoke._in_report(report, n)["registers"]
            for k, n in chip_smoke.D512_WGMMA.items()} == {"flash_fwd": 180,
                                                           "flash_bwd_fused": 215,
                                                           "flash_bwd_dq": 206,
                                                           "flash_bwd_dkv": 215}
    for gone in ("flash_fwd_f32<__nv_bfloat16, (int)512>",
                 "bwd_kv_f32<__nv_bfloat16, (int)512, (bool)0>",
                 "bwd_kv_f32<__nv_bfloat16, (int)512, (bool)1>",
                 "bwd_dq_f32<__nv_bfloat16, (int)512>"):
        assert gone not in chip_smoke.D512_WGMMA.values()
        assert chip_smoke._in_report(report, gone) is None


def _csrc(name):
    from pathlib import Path

    return (Path(__file__).resolve().parents[1] / "torchdistx_tpu_torch" / "ops" / "cuda"
            / "csrc" / name).read_text()


def _c_function(source, head):
    """The text of the C++ function whose definition starts with ``head``,
    up to its closing brace at the start of a line."""
    start = source.index(head)
    return source[start:source.index("\n}\n", start) + 3]


def test_bf16_backward_has_no_cuda_core_branch_left():
    # Every bf16 kernel is on TMA + wgmma: launch_kv (the dispatch of the
    # dk/dv and fused kernels' CUDA-core bodies) takes f32 only, and the dq
    # kernel's dispatch sends bf16 at every head dim to a wgmma instance;
    # the CUDA-core body of bf16 D = 512 is gone from the sources.
    launch_kv = _c_function(_csrc("flash_bwd_kv_f32.cuh"), "int launch_kv(")
    assert "launch_kv_f32_tiled<512, kDq>" in launch_kv
    assert "dtype == 1" not in launch_kv and "bfloat16" not in launch_kv
    dq = _c_function(_csrc("flash_bwd_dq.cu"), 'extern "C" int tdx_flash_bwd_dq(')
    assert "tdx_qf32::launch_q_f32<true>(args, B, D, st)" in dq and "launch_dq<" not in dq
    assert "launch_dq_cluster(" in dq
    branches = [line.strip() for line in dq.splitlines() if "dtype == 1" in line]
    assert branches == [f"if (dtype == 1 && D == {d}) {{" for d in (64, 128, 256, 512)]
    fused = _c_function(_csrc("flash_bwd_fused.cu"), 'extern "C" int tdx_flash_bwd_fused(')
    assert [line.strip() for line in fused.splitlines() if "dtype == 1" in line] == [
        f"if (dtype == 1 && D == {d}) {{" for d in (64, 128, 256, 512)]
    common = _csrc("flash_bwd_common.cuh")
    for gone in ("KvTileF32", "bwd_kv_f32(", "launch_kv_f32", "bwd_kv_f32<"):
        assert gone not in common, gone
    assert "constexpr size_t kMaxSmem" in common


def test_f32_kv_instances_are_found_in_a_ptxas_report():
    # The [build] line reads the register-blocked f32 dk/dv and fused
    # instances (no storage type: f32 only) from the report, one per (kernel,
    # D); the instances of the CUDA-core body they replaced are absent, its
    # bf16 D = 512 fused one too (that launch is on TMA + wgmma).
    report = {f"tdx_bwd::bwd_kv_f32_tiled<(int){d}, (bool){f}>": {
        "registers": 128 if d <= 128 else 208, "spill_stores": 0, "spill_loads": 0}
        for d in (64, 128, 256, 512) for f in (0, 1)}
    report["tdx_bwd::<unnamed>::flash_bwd_fused_wgmma_wide<(int)512>"] = {"registers": 215}
    assert sorted(chip_smoke.F32_KV) == [(k, d) for k in ("flash_bwd_dkv", "flash_bwd_fused")
                                         for d in (64, 128, 256, 512)]
    for (kernel, d), name in chip_smoke.F32_KV.items():
        entry = chip_smoke._in_report(report, name)
        assert entry == report[f"tdx_bwd::{name}"], (kernel, d)
        gone = f"bwd_kv_f32<float, (int){d}, (bool){int(kernel == 'flash_bwd_fused')}>"
        assert chip_smoke._in_report(report, gone) is None
    assert chip_smoke._in_report(report, "bwd_kv_f32<__nv_bfloat16, (int)512, (bool)1>") is None
    assert chip_smoke._in_report(
        report, chip_smoke._instance("flash_bwd_fused", 512, torch.bfloat16)) == {
        "registers": 215}


def test_bf16_forward_chooses_its_work_order():
    # The bf16 forward at D 64, 128 and 256 walks ForwardWorks in the order
    # forward_order chooses from each order's busiest block (busiest_block,
    # the same struct walked on the host); PairedWorks itself is the fused
    # backward's.  [build] checks the D 64 and 128 instances for spills.
    fwd = _csrc("flash_fwd.cu")
    assert "hw::PairedWorks" not in fwd
    assert fwd.count("hw::ForwardWorks w(n_q, Hq, B, order, blockIdx.x, gridDim.x)") == 2
    launch = _c_function(fwd, "int launch_bf16(")
    assert "forward_order(n_q, B * Hq, n_sm, causal != 0, &grid)" in launch
    choose = _c_function(fwd, "int forward_order(")
    for order in ("kPaired", "kHeadMajor", "kTileMajor"):
        assert f"hw::busiest_block(n, n_hb, 1, W::{order}, " in choose
    assert "hw::PairedWorks" in _csrc("flash_bwd_fused.cu")
    assert chip_smoke.FWD_WGMMA == {d: {"flash_fwd": f"flash_fwd_bf16_wgmma<(int){d}>"}
                                    for d in (64, 128)}
    report = {f"<unnamed>::flash_fwd_bf16_wgmma<(int){d}>": {
        "registers": 128 if d == 64 else 166, "spill_stores": 0, "spill_loads": 0}
        for d in (64, 128)}
    for d in (64, 128):
        assert chip_smoke._in_report(report, chip_smoke.FWD_WGMMA[d]["flash_fwd"]) == report[
            f"<unnamed>::flash_fwd_bf16_wgmma<(int){d}>"]


def test_f32_q_instances_are_found_in_a_ptxas_report():
    # The [build] line reads the register-blocked f32 forward and dq
    # instances (q_f32_tiled, one per (kernel, D)) from the report; the
    # CUDA-core bodies they replaced (flash_fwd_f32, bwd_dq_f32) are no
    # longer looked up, and a report of them alone leaves every entry empty.
    report = {f"tdx_qf32::q_f32_tiled<(int){d}, (bool){f}>": {
        "registers": 120 if d == 64 else 160, "spill_stores": 0, "spill_loads": 0}
        for d in (64, 128, 256, 512) for f in (0, 1)}
    assert sorted(chip_smoke.F32_Q) == [(k, d) for k in ("flash_bwd_dq", "flash_fwd")
                                        for d in (64, 128, 256, 512)]
    old = {f"<unnamed>::flash_fwd_f32<float, (int){d}>": {"registers": 96} for d in (64, 512)}
    old.update({f"tdx_bwd::<unnamed>::bwd_dq_f32<float, (int){d}>": {"registers": 56}
                for d in (64, 512)})
    for (kernel, d), name in chip_smoke.F32_Q.items():
        assert name == chip_smoke._instance(kernel, d, torch.float32)
        assert chip_smoke._in_report(report, name) == report[f"tdx_qf32::{name}"], (kernel, d)
        assert chip_smoke._in_report(old, name) is None, (kernel, d)
    names = set(chip_smoke.F32_Q.values()) | set(chip_smoke.F32_KV.values())
    assert not any("flash_fwd_f32" in n or "bwd_dq_f32" in n for n in names)
    assert not any("flash_fwd_f32" in chip_smoke._instance(k, d, dtype)
                   or "bwd_dq_f32" in chip_smoke._instance(k, d, dtype)
                   for k in ("flash_fwd", "flash_bwd_dq") for d in (64, 128, 256, 512)
                   for dtype in (torch.float32, torch.bfloat16))


def test_f32_forward_and_dq_run_the_q_tile_body_only():
    # tdx_flash_fwd and tdx_flash_bwd_dq send f32 at every head dim to the
    # q-tile body (flash_q_f32.cuh), and the CUDA-core bodies it replaced
    # are gone from every source: no flag, size or retry reaches them.
    import re
    from pathlib import Path

    fwd = _c_function(_csrc("flash_fwd.cu"), 'extern "C" int tdx_flash_fwd(')
    assert "tdx_qf32::launch_q_f32<false>(args, B, D, st)" in fwd
    assert [line.strip() for line in fwd.splitlines() if "dtype == 0" in line] == [
        "} else if (dtype == 0) {  // f32 at D 64, 128, 256 and 512 (flash_q_f32.cuh)"]
    body = _csrc("flash_q_f32.cuh")
    launch = _c_function(body, "int launch_q_f32(")
    assert [line.strip().split(")")[0] for line in launch.splitlines() if "if (D ==" in line] == [
        f"if (D == {d}" for d in (64, 128, 256, 512)]
    assert "return static_cast<int>(cudaErrorInvalidValue);" in launch
    csrc = Path(__file__).resolve().parents[1] / "torchdistx_tpu_torch" / "ops" / "cuda" / "csrc"
    for path in sorted(csrc.glob("*.cu*")):
        text = path.read_text()
        for gone in ("flash_fwd_f32", "bwd_dq_f32", "DqF32", "launch_f32", "launch_dq(",
                     "launch_dq<", "storage.cuh", "round_to<"):
            assert gone not in text, (path.name, gone)
        assert not re.search(r"\bF32Tiles\b", text), path.name
    assert not (csrc / "storage.cuh").exists()


def test_ab_script_f32_shapes_are_the_chip_smoke_f32_rows():
    # scripts/torch_d256_ab.py --dtype f32 times chip_smoke.py's f32 rows:
    # ragged_f32 at D 64, train_gate_f32 at D 128 (each a phase-2 row of
    # both routes and a forward row), and [head dims]' shape at D 256 and
    # 512, causal.
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "torch_d256_ab", Path(__file__).resolve().parents[1] / "scripts" / "torch_d256_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)

    def rows(name, d):
        fwd = {(*r[1:5], r[7]) for r in chip_smoke.FLASH_SHAPES
               if r[0] == name and r[5] == d and r[6] == torch.float32}
        bwd = {(*r[1:5], r[7]) for r in chip_smoke.BWD_SHAPES
               if r[0] == name and r[5] == d and r[6] == torch.float32}
        routes = {r[8] for r in chip_smoke.BWD_SHAPES if r[0] == name and r[5] == d}
        assert fwd == bwd and routes == {"fused", "streamed"}, name
        return [(name, *shape) for shape in sorted(fwd)]

    assert sorted(ab.F32_SHAPES) == [64, 128, 256, 512]
    assert ab.F32_SHAPES[64] == rows("ragged_f32", 64)
    assert ab.F32_SHAPES[128] == rows("train_gate_f32", 128)
    for d in (256, 512):
        assert d in chip_smoke.WIDE_HEAD_DIMS
        assert ab.F32_SHAPES[d] == [("head_dims", *chip_smoke.PADDED_SHAPE, True)]
    assert [r[:2] for r in ab._rows("f32", None)] == [
        ("ragged_f32 D 64", 64), ("train_gate_f32 D 128", 128), ("head_dims D 256", 256),
        ("head_dims D 512", 512)]


@pytest.mark.parametrize("d", [64, 128])
def test_ab_script_bf16_shapes_are_the_chip_smoke_bf16_rows(d):
    # scripts/torch_d256_ab.py --d 64 / --d 128 times exactly chip_smoke.py's
    # bf16 forward rows at that head dim, in FLASH_SHAPES' order, so its
    # A/B tables read against the kernel table row by row.
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "torch_d256_ab", Path(__file__).resolve().parents[1] / "scripts" / "torch_d256_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)

    want = [(r[0], *r[1:5], r[7]) for r in chip_smoke.FLASH_SHAPES
            if r[5] == d and r[6] == torch.bfloat16]
    assert ab.SHAPES[d] == want
    assert [r[:2] for r in ab._rows("bf16", d)] == [(r[0], d) for r in want]
    names = {64: ["ragged_bf16_d64", "gpt2_xl_heads", "pp_gpt2_block"],
             128: ["llama7b_main", "gqa_70b_heads", "decode_s1", "train_1x4096",
                   "gqa_ragged_bf16", "mesh_rank_block", "pp_micro_block", "pp_tp_block",
                   "ep_fsdp_block"]}
    assert [r[0] for r in want] == names[d]


def _ab_script():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "torch_d256_ab", Path(__file__).resolve().parents[1] / "scripts" / "torch_d256_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    return ab


@pytest.mark.parametrize("order", [0, 1, 2], ids=["pairs", "head_major", "tile_major"])
@pytest.mark.parametrize("n, h, b, grid", [(4, 16, 1, 64), (4, 32, 4, 132), (8, 25, 4, 132),
                                           (32, 32, 1, 132), (7, 19, 1, 132), (3, 5, 2, 7),
                                           (1, 32, 4, 128)])
def test_forward_works_take_every_work_once(n, h, b, grid, order):
    # hopper.cuh's ForwardWorks in each order, as the A/B script mirrors it
    # step for step: over the grid's blocks every (q tile, head, batch) is
    # taken once, and a pair's two tiles go to one block, the longer first.
    ab = _ab_script()
    taken = [w for block in range(grid) for w in ab._works(n, h * b, order, block, grid)]
    assert sorted(taken) == [(t, hb) for t in range(n) for hb in range(h * b)]
    if order == ab.PAIRED:
        for block in range(grid):
            mine = list(ab._works(n, h * b, order, block, grid))
            for (t0, hb0), (t1, hb1) in zip(mine, mine[1:]):
                if t0 > n - 1 - t0:  # the long tile of a pair: its partner follows
                    assert (t1, hb1) == (n - 1 - t0, hb0)


def test_forward_order_at_the_kernel_table_rows():
    # The forward's order, grid and busiest block at chip_smoke.py's bf16
    # rows on a 132-SM H100 (PERF.md's kernel table), beside the
    # pairs-only rule's: single q tiles where pairs would leave a block busier
    # (the 1 x 512 blocks, GPT-2 XL's heads, the 1 x 4096 step, the D 256
    # path's step), pairs elsewhere.
    ab = _ab_script()
    got = {name: ab.schedule(b, s, hq, d, causal)
           for d in (64, 128, 256) for name, b, s, hq, _, causal in ab.SHAPES[d]}
    assert {k: (v["order"], v["grid"], v["busiest_kv_tiles"], v["paired_grid"],
                v["paired_busiest_kv_tiles"]) for k, v in got.items()} == {
        "ragged_bf16_d64": ("pairs", 96, 16, 96, 16),
        "gpt2_xl_heads": ("tile-major", 132, 28, 132, 36),
        "pp_gpt2_block": ("head-major", 100, 4, 50, 5),
        "llama7b_main": ("pairs", 132, 10, 132, 10),
        "gqa_70b_heads": ("pairs", 132, 36, 132, 36),
        "decode_s1": ("pairs", 128, 1, 128, 1),
        "train_1x4096": ("tile-major", 132, 128, 132, 132),
        "gqa_ragged_bf16": ("tile-major", 132, 128, 132, 132),
        "mesh_rank_block": ("head-major", 128, 4, 64, 5),
        "pp_micro_block": ("head-major", 128, 4, 64, 5),
        "pp_tp_block": ("head-major", 64, 4, 32, 5),
        "ep_fsdp_block": ("pairs", 128, 5, 128, 5),
        "wide_d256": ("pairs", 132, 34, 132, 34),
        "d256_path_bf16": ("head-major", 132, 33, 68, 34)}
    assert got["gpt2_xl_heads"]["mean_kv_tiles"] == 27.3


@pytest.mark.parametrize(
    "name, bound_ms, bound_by",
    [("gqa_70b_heads", 0.034776, "operations"), ("decode_s1", 3.9279e-05, "bytes"),
     ("ragged_bf16_d64", 0.0062123, "operations"), ("gqa_ragged_bf16", 0.13893, "operations")],
)
def test_flash_bound_of_the_kernel_tables_added_rows(name, bound_ms, bound_by):
    # The bf16 forward rows that PERF.md's kernel table gained: their bounds
    # as chip_smoke.py computes them from FLASH_SHAPES.
    (row,) = [r for r in chip_smoke.FLASH_SHAPES if r[0] == name]
    got_ms, got_by = chip_smoke._flash_bound(*row[1:])
    assert got_ms == pytest.approx(bound_ms, rel=1e-4)
    assert got_by == bound_by


def test_slowmo_run_is_cut_as_documented():
    # The fused route (S <= 2048), whole averaging cycles before the
    # profiled one, and a step 2 that averages, so momentum is checked from
    # there on; the two-replica run ends on an averaging step.
    b, s = chip_smoke.SLOWMO_SHAPE
    assert fa.backward_route(s) == "fused"
    assert chip_smoke.SLOWMO_FREQ == 2
    assert chip_smoke.SLOWMO_STEPS % chip_smoke.SLOWMO_FREQ == 0
    assert chip_smoke.SLOWMO_STEPS >= 3 * chip_smoke.SLOWMO_FREQ
    assert chip_smoke.SLOWMO_REPLICA_STEPS % chip_smoke.SLOWMO_FREQ == 0
    assert chip_smoke.SLOWMO_LR > 0 and chip_smoke.SLOWMO_FACTOR >= 0


def test_slowmo_averaging_bound_at_llama_7b():
    # 12 bytes a bf16 parameter (parameter, prev and momentum read and
    # written once): 80.9 GB, 24.1 ms at 3.35 TB/s.
    from torchdistx_tpu_torch.models.llama import llama_7b, num_params

    n = num_params(llama_7b())
    assert 12 * n == pytest.approx(80.86e9, rel=1e-3)
    assert 12 * n / chip_smoke.PEAK_BYTES_PER_S * 1e3 == pytest.approx(24.14, rel=1e-3)


def test_gpt2_rows_are_the_paths_own_shapes():
    # Phase 2 holds the forward and the fused backward at the [gpt2] path's
    # attention: GPT2_SHAPE, gpt2_xl's 25 heads of 64, bf16, causal.
    from torchdistx_tpu_torch.models.gpt2 import gpt2_xl

    cfg = gpt2_xl()
    b, s = chip_smoke.GPT2_SHAPE
    want = (b, s, cfg.n_heads, cfg.n_heads, cfg.head_dim, cfg.dtype, True)
    fwd = [r[1:] for r in chip_smoke.FLASH_SHAPES if r[0] == chip_smoke.GPT2_HEADS]
    bwd = [r[1:] for r in chip_smoke.BWD_SHAPES if r[0] == chip_smoke.GPT2_HEADS]
    assert fwd == [want] and bwd == [(*want, fa.backward_route(s))]
    assert fa.backward_route(s) == "fused" and cfg.head_dim in fa._HEAD_DIMS
    assert [shape for shape, _, _ in chip_smoke.GPT2_TRAIN_SHAPES] == [chip_smoke.GPT2_SHAPE]
    assert s <= cfg.max_seq_len and chip_smoke.SEQ + chip_smoke.NEW_TOKENS <= cfg.max_seq_len


def test_gpt2_rows_bounds():
    # 4 x 1024, 25/25 heads of 64, bf16, causal: the forward reads q, k, v
    # and writes out (4 x 6,553,600 bf16 values) and lse (4 x 25 x 1024 f32),
    # by bytes; the fused backward's 5 products over 524,800 pairs a head,
    # by operations.
    args = (4, 1024, 25, 25, 64, torch.bfloat16, True)
    fwd_ms, fwd_by = chip_smoke._flash_bound(*args)
    assert fwd_by == "bytes"
    assert fwd_ms == pytest.approx((4 * 6_553_600 * 2 + 102_400 * 4) / 3.35e12 * 1e3, rel=1e-9)
    bwd_ms, bwd_by = chip_smoke._bwd_bound("flash_bwd_fused", *args)
    assert bwd_by == "operations"
    assert bwd_ms == pytest.approx(5 * 2 * 4 * 25 * 64 * 524_800 / 989e12 * 1e3, rel=1e-9)


def test_gpt2_entries_take_the_gpt2_rows():
    def row(shape, kernel=None):
        r = {"shape": shape, "max_abs_err": 0.0, "ms": 1.0 if shape == "gpt2_xl_heads" else 9.0,
             "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes", "library_ms": 0.1}
        return r if kernel is None else {**r, "kernel": kernel}

    rows = [row(r[0]) for r in chip_smoke.FLASH_SHAPES]
    bwd_rows = [row(r[0], k) for r in chip_smoke.BWD_SHAPES
                for k in chip_smoke.BWD_KERNELS[r[8]]]
    launched = {"flash_fwd": 241, "flash_bwd_fused": 144, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    entries = chip_smoke._gpt2_entries(rows, bwd_rows, launched)
    assert [e["name"] for e in entries] == ["flash_fwd (gpt2_xl heads, D 64)",
                                            "flash_bwd_fused (gpt2_xl heads, D 64)"]
    assert [e["launches"] for e in entries] == [241, 144]
    assert all(e["ms"] == 1.0 and e["route"] == "cuda" for e in entries)
    assert entries[1]["replaces"] == "torchdistx_tpu/ops/pallas/flash_attention.py:492"


def test_moe_path_is_cut_as_documented():
    # MoEConfig()'s own widths at MOE_LAYERS layers: 4,859,269,120 params
    # (9.72 GB in bf16; the 32 layers are 37.0 B); capacity 640 at 4 x 512
    # and 1280 at 1 x 4096; each shape's route is the kernels' rule.
    import dataclasses

    from torchdistx_tpu_torch.models import moe

    full = moe.MoEConfig()
    cfg = dataclasses.replace(full, n_layers=chip_smoke.MOE_LAYERS)
    assert (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.n_experts,
            cfg.experts_per_token, cfg.capacity_factor) == (4096, 32, 32, 11008, 8, 2, 1.25)
    assert moe.num_params(cfg) == 4_859_269_120
    assert moe.num_params(full) == pytest.approx(37.0e9, rel=2e-3)
    caps = [moe._capacity(cfg, b * s) for (b, s), _, _ in chip_smoke.MOE_TRAIN_SHAPES]
    assert caps == [640, 1280]
    assert [route for (_, s), _, route in chip_smoke.MOE_TRAIN_SHAPES] == \
        [fa.backward_route(s) for (_, s), _, _ in chip_smoke.MOE_TRAIN_SHAPES]
    assert all(n >= 2 for _, n, _ in chip_smoke.MOE_TRAIN_SHAPES)  # a steady step each


class _Event:
    def __init__(self, name, parent=None, kernels=()):
        import collections

        kernel = collections.namedtuple("Kernel", "name duration")
        self.name, self.cpu_parent = name, parent
        self.kernels = [kernel(n, d) for n, d in kernels]


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_moe_split_attributes_kernels_by_range_and_node():
    # Device time (us) of kernels under moe_ffn's profiler ranges, under
    # backward nodes, and elsewhere; ms out.
    node = "autograd::engine::evaluate_function: "
    experts = _Event("moe.experts")
    route = _Event("moe.route", _Event("aten::linear"))
    bmm_bwd = _Event(node + "BmmBackward0")
    idx_bwd = _Event(node + "IndexBackward0")
    mul_bwd = _Event(node + "MulBackward0")
    flash = "void (anonymous namespace)::flash_fwd_bf16_wgmma<128>(CUtensorMap_st)"
    events = [
        experts, route, bmm_bwd, idx_bwd, mul_bwd,
        _Event("aten::bmm", experts, [("nvjet_tst_a", 1000.0)]),
        _Event("aten::silu", experts, [("vectorized_elementwise", 100.0)]),
        _Event("aten::sort", route, [("radixSort", 200.0)]),
        _Event("aten::bmm", bmm_bwd, [("nvjet_tst_b", 3000.0)]),
        _Event("aten::index_put_", idx_bwd, [("indexing_backward", 400.0)]),
        _Event("aten::mm", mul_bwd, [("nvjet_tst_c", 500.0)]),
        _Event("aten::mul", mul_bwd, [("elementwise", 50.0)]),
        _Event("_FlashAttention", None, [(flash, 700.0)]),
    ]
    split = chip_smoke._moe_split(_Prof(events))
    assert split == pytest.approx({"routing": 0.6, "expert_gemms": 4.0, "attention": 0.7,
                                   "other_gemms": 0.5, "other": 0.15})


@pytest.mark.parametrize("run", ["a", "b"])
def test_mesh_rank_rows_are_the_runs_own_blocks(run):
    # [mesh ranks] (a): llama_7b's heads at MESH_RANKS_SHAPE, (b):
    # llama_test's at MESH_RANKS_F32_SHAPE, each over fsdp=2 x tp=2 (half
    # the rows, half of each head count); phase 2 holds the forward and the
    # fused backward at that block, at the kernel's padded head dim.
    import dataclasses

    from torchdistx_tpu_torch.models.llama import llama_7b, llama_test

    if run == "a":
        cfg = dataclasses.replace(llama_7b(), n_layers=chip_smoke.MESH_RANKS_LAYERS)
        (b, s), dtype = chip_smoke.MESH_RANKS_SHAPE, torch.bfloat16
    else:
        cfg, (b, s), dtype = llama_test(), chip_smoke.MESH_RANKS_F32_SHAPE, torch.float32
    block, name = chip_smoke.MESH_RANK_BLOCKS[run]
    assert cfg.dtype == dtype
    assert block == (b // 2, s, cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.head_dim)
    want = (*block[:4], fa._kernel_head_dim(block[4]), dtype, True)
    assert [r[1:] for r in chip_smoke.FLASH_SHAPES if r[0] == name] == [want]
    assert [r[1:] for r in chip_smoke.BWD_SHAPES if r[0] == name] == [
        (*want, fa.backward_route(s))]


def test_mesh_rank_entries_take_the_mesh_rank_rows():
    def row(shape, kernel=None):
        r = {"shape": shape, "max_abs_err": 0.0, "ms": 1.0 if shape.startswith("mesh") else 9.0,
             "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes", "library_ms": 0.1}
        return r if kernel is None else {**r, "kernel": kernel}

    rows = [row(r[0]) for r in chip_smoke.FLASH_SHAPES]
    bwd_rows = [row(r[0], k) for r in chip_smoke.BWD_SHAPES
                for k in chip_smoke.BWD_KERNELS[r[8]]]
    launches = {"a": {"flash_fwd": 32, "flash_bwd_fused": 16, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0},
                "b": {"flash_fwd": 24, "flash_bwd_fused": 24, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0},
                "d": {"flash_fwd": 12, "flash_bwd_fused": 12, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}}
    entries = chip_smoke._mesh_rank_entries(rows, bwd_rows, launches)
    # (d), the (data, model) mesh with a custom loss, hands the kernel (b)'s
    # block, so it takes (b)'s rows.
    assert [(e["name"], e["launches"]) for e in entries] == [
        ("flash_fwd (mesh rank block, llama_7b widths)", 32),
        ("flash_bwd_fused (mesh rank block, llama_7b widths)", 16),
        ("flash_fwd (mesh rank block, llama_test f32)", 24),
        ("flash_bwd_fused (mesh rank block, llama_test f32)", 24),
        ("flash_fwd (mesh rank block, llama_test f32, data/model mesh, custom loss)", 12),
        ("flash_bwd_fused (mesh rank block, llama_test f32, data/model mesh, custom loss)",
         12)]
    assert all(e["ms"] == 1.0 for e in entries)
    assert entries[1]["launches_by_path"] == {"mesh_ranks_a": 16}


def test_fingerprint_err_sees_a_misplaced_gradient():
    # Signed row and column sums of a matrix: equal tensors give 0, a
    # gradient with two row blocks swapped (a shard in the wrong place) is
    # far off, and so is one whose columns each sum to 0 (a softmax head's
    # gradient over the vocabulary) against a column-wise wrong copy; a
    # zero reference against a nonzero tensor is inf.
    g = torch.Generator().manual_seed(0)
    w = {"m": torch.randn(8, 6, generator=g), "v": torch.randn(5, generator=g)}
    want = chip_smoke._fingerprint(w)
    assert [x.shape for x in want["m"]] == [(8,), (6,)] and len(want["v"]) == 1
    assert chip_smoke._fingerprint_err(chip_smoke._fingerprint(w), want) == 0.0
    swapped = {"m": torch.cat([w["m"][4:], w["m"][:4]]), "v": w["v"]}
    assert chip_smoke._fingerprint_err(chip_smoke._fingerprint(swapped), want) > 0.5
    centred = {"m": w["m"] - w["m"].mean(dim=0), "v": w["v"]}
    wrong = {"m": centred["m"][:, torch.arange(5, -1, -1)], "v": w["v"]}
    assert chip_smoke._fingerprint_err(chip_smoke._fingerprint(wrong),
                                       chip_smoke._fingerprint(centred)) > 0.5
    zero = {"m": torch.zeros(8, 6), "v": torch.zeros(5)}
    assert chip_smoke._fingerprint_err(want, chip_smoke._fingerprint(zero)) == float("inf")
    change = chip_smoke._fingerprint_change(want, want)
    assert chip_smoke._fingerprint_err(change, chip_smoke._fingerprint(zero)) == 0.0


@pytest.mark.parametrize("run", list(chip_smoke.PIPE_BLOCKS))
def test_pipeline_rows_are_the_runs_own_blocks(run):
    # A pipeline's kernel sees one rank's rows of a microbatch (the batch
    # over PIPE_MICROBATCHES, then over the data axes) and its tp share of
    # the heads; phase 2 holds the forward and the fused backward there.
    # A run with a sequence axis runs the ring in each stage: no kernel
    # block, no row.
    if run == "pipeline":
        family, layers, axes, shape = "llama", 32, {"pp": 1}, chip_smoke.PIPE_SHAPE
    else:
        family, layers, axes, _, shape = chip_smoke.PIPE_RANK_RUNS[run]
    options = chip_smoke.PIPE_RANK_OPTIONS.get(run, {})
    micro = options.get("n_microbatches", chip_smoke.PIPE_MICROBATCHES)
    _, cfg = chip_smoke._pipe_cfg(family, layers)
    b, s = shape
    data = axes.get("dp", 1) * axes.get("fsdp", 1)
    tp = axes.get("tp", 1)
    assert b % (micro * data) == 0 and layers % axes["pp"] == 0
    block, name = chip_smoke.PIPE_BLOCKS[run]
    if options.get("seq_axis"):
        assert (block, name) == (None, None) and s % axes[options["seq_axis"]] == 0
        return
    kv = getattr(cfg, "n_kv_heads", cfg.n_heads)
    assert block == (b // micro // data, s, cfg.n_heads // tp, kv // tp, cfg.head_dim)
    want = (*block[:4], fa._kernel_head_dim(block[4]), torch.bfloat16, True)
    assert [r[1:] for r in chip_smoke.FLASH_SHAPES if r[0] == name] == [want]
    assert [r[1:] for r in chip_smoke.BWD_SHAPES if r[0] == name] == [
        (*want, fa.backward_route(s))]


@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipe_launches_follow_the_schedules(n_stages, schedule):
    # A stage computation launches the forward once a layer of the stage,
    # a transpose the fused backward once a layer: GPipe computes every
    # microbatch forward and again in its backward; 1F1B's forward slots
    # run the stage on all but the last stage (the port's tick tables).
    from torchdistx_tpu_torch.parallel.pipeline import schedule_1f1b

    m_count, layers, steps = 4, 8, 2
    per = layers // n_stages
    for p in range(n_stages):
        got = chip_smoke._pipe_launches(schedule, n_stages, p, layers, m_count, steps)
        if schedule == "gpipe":
            forwards = m_count
        else:
            table = schedule_1f1b(n_stages, m_count, p)
            forwards = sum(f is not None for _, f, _ in table) if p < n_stages - 1 else 0
        assert got == {"flash_fwd": (forwards + m_count) * per * steps,
                       "flash_bwd_fused": m_count * per * steps,
                       "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert chip_smoke._pipe_ticks(schedule, n_stages, m_count) == (
        m_count + n_stages - 1 if schedule == "gpipe" else 2 * m_count + 2 * n_stages - 3)


def test_vocab_accumulators_skip_the_layers():
    shapes = (("g_ep", (1024, 64), "float32"), ("g_lp", (256, 64), "float32"),
              ("g_hp", (64,), "float32"), ("g_sp", (256, 64), "float32"))
    assert chip_smoke._vocab_accumulators(shapes, 256) == [["g_sp", [256, 64]]]


def test_pipeline_entries_take_the_pipeline_rows():
    def row(shape, kernel=None):
        r = {"shape": shape, "max_abs_err": 0.0, "ms": 1.0 if shape.startswith("pp_") else 9.0,
             "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes", "library_ms": 0.1}
        return r if kernel is None else {**r, "kernel": kernel}

    rows = [row(r[0]) for r in chip_smoke.FLASH_SHAPES]
    bwd_rows = [row(r[0], k) for r in chip_smoke.BWD_SHAPES
                for k in chip_smoke.BWD_KERNELS[r[8]]]
    counts = {"flash_fwd": 8, "flash_bwd_fused": 4, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    ranks = {key: counts for key in chip_smoke.PIPE_RANK_RUNS}
    entries = chip_smoke._pipeline_entries(rows, bwd_rows, counts, ranks)
    # The ring runs (no kernel block) have no entry.
    with_block = [k for k in ranks if chip_smoke.PIPE_BLOCKS[k][1] is not None]
    assert len(with_block) == len(ranks) - 1
    assert len(entries) == 2 * (1 + len(with_block))
    assert entries[0]["name"] == "flash_fwd (pipeline microbatch block, llama_7b)"
    assert entries[0]["launches_by_path"] == {"pipeline": 8}
    assert entries[-1]["launches_by_path"] == {"pipeline_ranks_d": 4}
    assert all(e["ms"] == 1.0 for e in entries)


def test_fingerprint_holds_no_autograd_graph():
    # A fingerprint of a parameter that requires grad is detached: kept in
    # a reference's results, a graph would keep the parameter alive (and
    # its card memory held) after the run's model is gone.
    import weakref

    p = torch.nn.Parameter(torch.randn(6, 4))
    prints = chip_smoke._fingerprint({"p": p})
    assert all(x.grad_fn is None and not x.requires_grad for x in prints["p"])
    ref = weakref.ref(p)
    del p
    assert ref() is None


def test_fingerprint_of_an_expert_stack_is_its_flattened_rows_and_columns():
    # An (E, in, out) expert weight is fingerprinted as the (E x in, out)
    # matrix: two vectors, not the whole tensor (a 0.7 GB expert weight
    # kept whole on the CPU for each fingerprint would fill the host).
    w = torch.randn(3, 5, 4, generator=torch.Generator().manual_seed(1))
    got = chip_smoke._fingerprint({"e": w})["e"]
    assert [tuple(x.shape) for x in got] == [(15,), (4,)]
    flat = chip_smoke._fingerprint({"e": w.reshape(15, 4)})["e"]
    assert all(torch.equal(a, b) for a, b in zip(got, flat))


def test_every_pipeline_rank_run_has_its_bounds_and_block():
    assert set(chip_smoke.PIPE_RANKS_BOUNDS) == set(chip_smoke.PIPE_RANK_RUNS)
    assert set(chip_smoke.PIPE_BLOCKS) == set(chip_smoke.PIPE_RANK_RUNS) | {"pipeline"}
    for loss_atol, grad_rtol, change_rtol in chip_smoke.PIPE_RANKS_BOUNDS.values():
        assert 0 < loss_atol and 0 < grad_rtol < 1 and 0 < change_rtol


@pytest.mark.parametrize("axes, params", [
    ({"ep": 4}, 937_512_960),
    ({"fsdp": 2, "ep": 2}, 739_332_096),
], ids=["ep4", "fsdp2_ep2"])
def test_ep_rank_bytes_by_the_plan(axes, params):
    """[ep ranks]' bytes a rank at MoEConfig()'s widths x 2 layers: ep=4
    holds 2 of 8 experts a layer and every other parameter whole; fsdp=2 x
    ep=2 halves the embedding, the head and the projections and holds 4 of
    8 experts a layer, each split over fsdp."""
    from torchdistx_tpu_torch.models import moe

    mod, cfg = chip_smoke._pipe_cfg("moe", chip_smoke.EP_RANKS_LAYERS)
    assert moe.num_params(cfg) == 2_560_708_608
    assert chip_smoke._plan_bytes(mod, cfg, axes) == 2 * params


def test_every_new_rank_run_has_its_bounds_and_block():
    assert set(chip_smoke.EP_RANKS_BOUNDS) == set(chip_smoke.EP_RANK_RUNS) == set(
        chip_smoke.EP_BLOCKS)
    assert set(chip_smoke.PIPE_RANK_OPTIONS) <= set(chip_smoke.PIPE_RANK_RUNS)
    rows = {name for name, *_ in chip_smoke.FLASH_SHAPES}
    bwd = {name for name, *_ in chip_smoke.BWD_SHAPES}
    for _, row in (*chip_smoke.EP_BLOCKS.values(), *chip_smoke.SLOWMO_RANK_BLOCKS.values()):
        assert row in rows
    for key in ("b",):
        assert chip_smoke.EP_BLOCKS[key][1] in bwd
    for _, row in chip_smoke.SLOWMO_RANK_BLOCKS.values():
        assert row in bwd


def test_serve_traffic_shape():
    """[serve] (a)'s requests: 24, each admissible at max_model_len 1024,
    budgets from the menu; request 0 and the SERVE_SHARERS start with one
    512-token prefix (32 full pages), SERVE_EXACT are exactly it; the same
    seed gives the same requests."""
    import numpy as np

    reqs = chip_smoke.serve_traffic(32000)
    assert len(reqs) == chip_smoke.SERVE_REQUESTS == 24
    prefix = reqs[0][0][:chip_smoke.SERVE_PREFIX_LEN]
    assert chip_smoke.SERVE_PREFIX_LEN // chip_smoke.SERVE_KW["block_size"] == 32
    lo, hi = chip_smoke.SERVE_PROMPT_LENS
    for i, (prompt, budget) in enumerate(reqs):
        assert prompt.dtype == np.int32 and budget in chip_smoke.SERVE_BUDGETS
        assert len(prompt) + budget <= chip_smoke.SERVE_KW["max_model_len"]
        shares = i == 0 or i in chip_smoke.SERVE_SHARERS
        assert np.array_equal(prompt[:len(prefix)], prefix) == shares, i
        assert (len(prompt) == len(prefix)) == (i in chip_smoke.SERVE_EXACT), i
        if not shares:
            assert lo <= len(prompt) <= hi
    assert sum(len(p) > chip_smoke.SERVE_KW["prefill_chunk"] for p, _ in reqs) >= 4
    again = chip_smoke.serve_traffic(32000)
    assert all(np.array_equal(a, b) and x == y for (a, x), (b, y) in zip(reqs, again))


def test_serve_traffic_hits_and_copies_on_a_small_model():
    """[serve] (a)'s scheduling on the CPU: the requests through an Engine
    of SERVE_KW over a one-layer model at max_seq_len 1024 give the prefix
    hits and copy-on-write copies that (a) gates on (they depend on the
    schedule, not the weights), and the bound's bytes count the fused
    decode weights, the rest of each layer, the head, one embedding row a
    slot and the gathered K/V pages."""
    import dataclasses

    from torchdistx_tpu_torch.models import llama as tllama
    from torchdistx_tpu_torch.serving import Engine

    cfg = dataclasses.replace(tllama.llama_test(), vocab_size=32000, dim=32, n_heads=2,
                              n_kv_heads=2, n_layers=1, ffn_dim=32, max_seq_len=1024)
    torch.manual_seed(0)
    eng = Engine(tllama.Llama(cfg, device="cpu"), device="cpu", **chip_smoke.SERVE_KW)
    handles = [eng.submit(p, max_new_tokens=b, key=i)
               for i, (p, b) in enumerate(chip_smoke.serve_traffic(cfg.vocab_size))]
    eng.drain()
    st = eng.stats()
    assert st["prefix_hits"] >= chip_smoke.SERVE_MIN_HITS
    assert st["cow_copies"] >= chip_smoke.SERVE_MIN_COW
    assert eng.allocator.num_in_use == len(eng.prefix)
    assert all(h.done and h.error is None for h in handles)
    bound_ms, w, kv = chip_smoke._serve_decode_bound(eng)
    layer = (3 * 32 * 32 + 2 * 32 * 32) + 32 * 32 + 32 * 32 + 2 * 32  # wqkv+wgu, wo, w_down, norms
    assert w == 4 * (layer + 32 + 32000 * 32 + 8 * 32)
    assert kv == 2 * 1 * 8 * 64 * 16 * 2 * 16 * 4
    assert bound_ms == pytest.approx((w + kv) / chip_smoke.PEAK_BYTES_PER_S * 1e3)


def test_serve_planes_traffic_pool_and_page_bytes():
    """[serve planes] (a)'s requests: 16 class-0 "batch" requests (prompts
    512-900, budget 64), then 8 class-1 "chat" ones (64-128, budget 16);
    the pool holds exactly the first 6 batch reservations, so each later
    reservation meets an empty free list; a page of K and V at llama_7b in
    bf16 is 8 MiB."""
    from torchdistx_tpu_torch.models.llama import llama_7b

    traffic = chip_smoke.planes_traffic(32000)
    assert len(traffic) == 24
    for i, (prompt, budget, tenant, prio) in enumerate(traffic):
        batch = i < chip_smoke.PLANES_BATCH
        lo, hi = chip_smoke.PLANES_BATCH_LENS if batch else chip_smoke.PLANES_CHAT_LENS
        assert lo <= len(prompt) <= hi
        assert (budget, tenant, prio) == ((64, "batch", 0) if batch else (16, "chat", 1))
        assert len(prompt) + budget <= chip_smoke.SERVE_KW["max_model_len"]
    bs = chip_smoke.SERVE_KW["block_size"]
    pages = [-(-(len(p) + b) // bs) for p, b, _, _ in traffic]
    nb = chip_smoke.planes_num_blocks(traffic, bs)
    assert nb == 1 + sum(pages[:chip_smoke.PLANES_FILL]) == 272
    assert chip_smoke.planes_page_bytes(llama_7b(), bs) == 2 * 32 * 16 * 32 * 128 * 2 == 8 << 20


def test_serve_planes_memory_plan_fits():
    """(c) holds the engine's llama_7b and one resident pool model, each
    parameters plus prep_decode copy, and the default pool: 49.2 GB, below
    the phase's 70 GB."""
    from torchdistx_tpu_torch.models.llama import llama_7b

    plan = chip_smoke.planes_memory_plan(llama_7b())
    assert plan["params"] == 2 * 6_738_415_616
    assert plan["prep_decode"] == 32 * (3 * 4096 * 4096 + 2 * 11008 * 4096) * 2 == 8_992_587_776
    assert plan["kv_pool"] == 513 * (8 << 20)
    assert plan["total"] < chip_smoke.PLANES_PEAK_LIMIT


def _tiny_serving_llama():
    import dataclasses

    from torchdistx_tpu_torch.models import llama as tllama

    cfg = dataclasses.replace(tllama.llama_test(), vocab_size=32000, dim=32, n_heads=2,
                              n_kv_heads=2, n_layers=1, ffn_dim=32, max_seq_len=1024)
    torch.manual_seed(0)
    return tllama.Llama(cfg, device="cpu")


@pytest.mark.parametrize("mech", ["swap", "replay"])
def test_serve_planes_qos_schedule_preempts_on_a_small_model(mech):
    """(a)'s schedule on the CPU (preemptions depend on the schedule, not
    the weights): the batch class fills the pool in PLANES_CHAT_AFTER
    ticks, the chat arrivals preempt by the mechanism under page pressure
    and by replay under slot pressure, and every page settles to the
    prefix index's own."""
    from torchdistx_tpu_torch.serving import Engine

    model = _tiny_serving_llama()
    traffic = chip_smoke.planes_traffic(32000)
    nb = chip_smoke.planes_num_blocks(traffic, chip_smoke.SERVE_KW["block_size"])
    eng = Engine(model, device="cpu", **dict(
        chip_smoke.SERVE_KW, num_blocks=nb,
        max_prefills_per_tick=chip_smoke.PLANES_PREFILLS_PER_TICK),
        scheduler="qos", tenant_weights=chip_smoke.PLANES_WEIGHTS, preempt_mechanism=mech)
    subs = [dict(prompt=p, max_new_tokens=b, key=i, tenant=t, priority=pr)
            for i, (p, b, t, pr) in enumerate(traffic)]
    hs = [eng.submit(**kw) for kw in subs[:chip_smoke.PLANES_BATCH]]
    for _ in range(chip_smoke.PLANES_CHAT_AFTER):
        eng.step()
    assert eng.allocator.num_free == 0 and eng._n_decoding() == chip_smoke.PLANES_FILL
    hs += [eng.submit(**kw) for kw in subs[chip_smoke.PLANES_BATCH:]]
    eng.drain()
    st = eng.stats()
    assert st["preemptions_swap" if mech == "swap" else "preemptions_replay"] > 0
    assert [len(h.result()) for h in hs] == [b for _, b, _, _ in traffic]
    assert eng.allocator.num_in_use == len(eng.prefix) and eng.allocator.num_swapped == 0


def test_serve_planes_migration_picks_and_moves_on_a_small_model():
    """(e) on the CPU: the picked requests all decode before any ends, and
    move A to B with nothing recomputed."""
    from torchdistx_tpu_torch.serving import Engine

    model = _tiny_serving_llama()
    first = chip_smoke.serve_traffic(32000)[:chip_smoke.PLANES_JOURNAL]
    picks = [i for i, (_, n) in enumerate(first)
             if n >= chip_smoke.PLANES_MIGRATE_BUDGET][:chip_smoke.PLANES_MIGRATE]
    assert len(picks) == chip_smoke.PLANES_MIGRATE
    a = Engine(model, device="cpu", **dict(
        chip_smoke.SERVE_KW, max_prefills_per_tick=chip_smoke.PLANES_PREFILLS_PER_TICK))
    b = Engine(model, device="cpu", **chip_smoke.SERVE_KW)
    hs = [a.submit(first[i][0], max_new_tokens=first[i][1], key=i) for i in picks]
    while len(a.migratable_slots()) < chip_smoke.PLANES_MIGRATE:
        assert not any(h.done for h in hs)
        a.step()
    for slot in a.migratable_slots():
        b.migrate_in(a.migrate_out(slot))
    b.drain()
    assert [len(h.result()) for h in hs] == [first[i][1] for i in picks]
    assert b.stats()["recoveries"] == 0 and a.allocator.num_in_use == len(a.prefix)


def test_fleet_traffic_and_constants():
    """[fleet]'s requests: (a) serves serve_traffic's first FLEET_AUDIT with
    one of budget >= FLEET_CORRUPT_BUDGET for the corrupt fault, whose flip
    lands inside it; (b) and (c) the first FLEET_ROUTED, with FLEET_MIGRATE
    of budget >= 32 to move; (d) FLEET_SWAP_STREAMS streams of
    FLEET_SWAP_BUDGET tokens and FLEET_SWAP_QUEUED queued ones, each within
    max_model_len."""
    routed = chip_smoke.serve_traffic(32000)[:chip_smoke.FLEET_ROUTED]
    audit = routed[:chip_smoke.FLEET_AUDIT]
    pick = next(i for i, (_, b) in enumerate(audit) if b >= chip_smoke.FLEET_CORRUPT_BUDGET)
    flip = 1 + (chip_smoke.FLEET_CORRUPT_CHUNK - 1) * chip_smoke.SERVE_KW["decode_chunk"]
    assert flip < audit[pick][1]
    assert sum(b >= 32 for _, b in routed) >= chip_smoke.FLEET_MIGRATE
    assert chip_smoke.FLEET_JOURNAL <= chip_smoke.FLEET_ROUTED
    assert chip_smoke.FLEET_WAVE <= chip_smoke.FLEET_ROUTED
    assert chip_smoke.FLEET_MIN_LIVE <= chip_smoke.SERVE_KW["num_slots"]
    swap = chip_smoke.fleet_swap_traffic(32000)
    assert len(swap) == chip_smoke.FLEET_SWAP_STREAMS + chip_smoke.FLEET_SWAP_QUEUED
    lo, hi = chip_smoke.FLEET_SWAP_LENS
    for i, (prompt, budget) in enumerate(swap):
        assert lo <= len(prompt) <= hi
        assert budget == (chip_smoke.FLEET_SWAP_BUDGET if i < chip_smoke.FLEET_SWAP_STREAMS
                          else 32)
        assert len(prompt) + budget <= chip_smoke.SERVE_KW["max_model_len"]
        assert len(prompt) + chip_smoke.FLEET_SWAP_INFLIGHT <= chip_smoke.SERVE_KW["max_model_len"]
    # The streams outlast the build: FLEET_SWAP_AFTER ticks before and
    # after it leave most of the budget (58 ticks) to decode while it runs.
    chunk = chip_smoke.SERVE_KW["decode_chunk"]
    assert chip_smoke.FLEET_SWAP_BUDGET // chunk - 2 * chip_smoke.FLEET_SWAP_AFTER >= 58


def test_fleet_memory_plan_and_autoscaler_bounds():
    """(d) at its height holds two llama_7b versions (parameters plus one
    shared prep_decode copy, 22.47 GB each) and three default pools: 57.9
    GB, below the phase's 70 GB; (c) scales between 1 and 3 replicas."""
    from torchdistx_tpu_torch.fleet import AutoscaleConfig
    from torchdistx_tpu_torch.models.llama import llama_7b

    plan = chip_smoke.fleet_memory_plan(llama_7b())
    assert plan["version"] == 2 * 6_738_415_616 + 8_992_587_776
    assert plan["kv_pool"] == 513 * (8 << 20)
    assert plan["total"] == 2 * plan["version"] + 3 * plan["kv_pool"]
    assert plan["total"] < chip_smoke.FLEET_PEAK_LIMIT
    cfg = AutoscaleConfig(**chip_smoke.FLEET_SCALE).validate()
    assert (cfg.min_replicas, cfg.max_replicas) == (1, 3)


def test_fleet_audit_schedules_and_compiles_on_a_small_model():
    """[fleet] (a)'s audited run on the CPU (the schedules depend on the
    traffic, not the weights): with the prefix cache on, every one of the
    FLEET_AUDIT audits is checked, replays its original's prefill schedule
    (C6) and reproduces its stream; the engine captures its decode chunk
    once, with no recompile, as (a) gates on the card."""
    from torchdistx_tpu_torch.serving import Engine

    before = chip_smoke._compile_rows("decode_chunk").get("decode_chunk", {})
    eng = Engine(_tiny_serving_llama(), device="cpu", audit_sample=1.0, **chip_smoke.SERVE_KW)
    traffic = chip_smoke.serve_traffic(32000)[:chip_smoke.FLEET_AUDIT]
    hs = [eng.submit(p, max_new_tokens=b, key=i) for i, (p, b) in enumerate(traffic)]
    eng.drain()
    st = eng.stats()
    assert st["prefix_hits"] >= 1 and all(h.error is None for h in hs)
    assert st["audit_checked"] == chip_smoke.FLEET_AUDIT and st["audit_divergences"] == 0
    assert eng._auditor.schedule_unmatched == 0
    row = chip_smoke._compile_rows("decode_chunk")["decode_chunk"]
    assert row["count"] - before.get("count", 0) == 1
    assert row["recompiles"] == before.get("recompiles", 0)
    eng.close()


def test_compile_rows_read_the_observatory():
    """[build]'s and [fleet]'s readings: each program's count, recompiles
    and seconds from the observatory's families."""
    from torchdistx_tpu_torch.telemetry import perf

    perf.record_compile("kernel:tdx_rows_a", 1.5)
    perf.record_compile("kernel:tdx_rows_a", 0.25)
    perf.record_compile("kernel:tdx_rows_b", 2.0)
    rows = chip_smoke._compile_rows("kernel:tdx_rows_")
    assert rows == {"kernel:tdx_rows_a": {"count": 2, "recompiles": 0, "time_s": 1.75,
                                          "max_s": 1.5},
                    "kernel:tdx_rows_b": {"count": 1, "recompiles": 0, "time_s": 2.0,
                                          "max_s": 2.0}}


def test_storm_check_on_the_cpu():
    """The card's storm check, run here: the latch, one dump with the
    ledger, OVERLOADED then READY, cleared after a quiet window, five
    captures of which three are recompiles, storm_config restored."""
    out = chip_smoke.storm_check("cpu")
    assert out["count"] == 5 and out["recompiles"] == 3
    assert [tag for tag, _ in out["capture_s"]] == list(chip_smoke.OBS_STORM_TAGS)
    assert all(s > 0 for _, s in out["capture_s"])


def test_drill_check_runs_the_drills_in_children_on_the_cpu():
    out = chip_smoke.drill_check("cpu")
    assert "chunk 6" in out["scripts/torch_incident_replay.py --drill"]["last"]
    assert "chunk 6" in out["scripts/torch_incident_replay.py --journal-drill"]["last"]
    assert "scripts/trace_report.py --strict" in out


class _RankMesh:
    """The coordinate and shape of one rank of a 2 x 2 mesh, as
    ``materialize._shard_box`` reads them."""

    shape = (2, 2)

    def __init__(self, coord):
        self.coord = coord

    def get_coordinate(self):
        return list(self.coord)


def test_philox_rows_are_llama_7b_parameters_and_the_last_ranks_boxes():
    from torchdistx_tpu_torch.materialize import _shard_box
    from torchdistx_tpu_torch.models import llama
    from torchdistx_tpu_torch.parallel import MeshSpec
    from torchdistx_tpu_torch.parallel.sharding import spec_placements

    cfg = llama.llama_7b()
    specs = llama.param_specs(cfg)
    shapes = {"embed": ((cfg.vocab_size, cfg.dim), specs["embed.weight"]),
              "w_gate": ((cfg.ffn_dim, cfg.dim), specs["layers.0.w_gate.weight"]),
              "w_down": ((cfg.dim, cfg.ffn_dim), specs["layers.0.w_down.weight"])}
    mesh = MeshSpec(fsdp=2, tp=2)
    for name, kind, dtype, full, offset, (a, b) in chip_smoke.PHILOX_ROWS:
        shape, spec = shapes[name.split("_")[0] if name.startswith("embed") else
                             "_".join(name.split("_")[:2])]
        assert full == shape, name
        if offset is not None:  # the last rank's (1, 1) box
            off, size = _shard_box(full, _RankMesh((1, 1)), spec_placements(spec, mesh, 2))
            assert chip_smoke._philox_box(full, offset) == (off, size), name
            assert all(o > 0 for o in off), name
        if kind == "uniform":  # nn.Linear's kaiming bound, 1 / sqrt(in)
            assert (a, b) == pytest.approx((-full[1] ** -0.5, full[1] ** -0.5)), name
    rows = {r[0]: r for r in chip_smoke.PHILOX_ROWS}
    assert rows[chip_smoke.PHILOX_MAIN_ROW][4] is None  # the forward path's whole draw
    assert rows[chip_smoke.PHILOX_RANK_ROW][4] is not None


def test_philox_bound_is_the_bytes_written():
    # The embedding in bf16: 32000 x 4096 x 2 bytes at 3.35 TB/s.
    assert 32000 * 4096 * 2 / chip_smoke.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.078248,
                                                                                rel=1e-4)


def test_ulps_of_the_stored_dtype():
    # bf16 holds 8 significant bits: 1 + 2^-7 is one ulp above 1.
    want = torch.tensor([1.0, -3.0, 0.02], dtype=torch.bfloat16)
    got = torch.tensor([1.0078125, -3.0, want[2].item()], dtype=torch.bfloat16)
    assert chip_smoke._ulps(got, want).tolist() == [1.0, 0.0, 0.0]
    w32 = torch.tensor([0.5, 1e-3])
    assert chip_smoke._ulps(torch.nextafter(w32, torch.ones(2)), w32).tolist() == [1.0, 1.0]


def test_philox_instances_are_found_in_a_ptxas_report():
    report = {f"tdx_philox::{name}": {"registers": 40, "spill_stores": 0, "spill_loads": 0}
              for name in chip_smoke.PHILOX_INSTANCES}
    assert len(chip_smoke.PHILOX_INSTANCES) == 9
    assert all(chip_smoke._in_report(report, n) for n in chip_smoke.PHILOX_INSTANCES)
    # Each row's instance is one the build compiles.
    for name, kind, dtype, *_ in chip_smoke.PHILOX_ROWS:
        inst = (f"philox_fill<{chip_smoke.PHILOX_INSTANCE[dtype]}, "
                f"(int){chip_smoke.PHILOX_KINDS[kind]}>")
        assert inst in chip_smoke.PHILOX_INSTANCES, name


def test_philox_entries_take_the_rows():
    rows = [{"shape": name, "instance": "philox_fill<__nv_bfloat16, (int)2>",
             "max_abs_err": 0.0, "ms": 1.0, "plain_ms": 9.0, "bound_ms": 0.08,
             "bound_by": "bytes", "library_ms": 0.5} for name, *_ in chip_smoke.PHILOX_ROWS]
    entries = chip_smoke._philox_entries(rows, 227, 904)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(e) for e in entries)
    assert [e["launches"] for e in entries] == [227, 904]
    assert entries[0]["source"] == "torchdistx_tpu_torch/ops/cuda/csrc/philox.cu"
    assert all(e["route"] == "cuda" for e in entries)


def test_philox_blocks_count_each_rows_partial_blocks():
    # Each row of the (37, 29) box at (5, 7) of 19 x 13: its blocks from
    # the one holding its first element to the one holding its last.
    want = 0
    for r in range(19):
        g0 = (5 + r) * 29 + 7
        want += (g0 + 12) // 4 - g0 // 4 + 1
    assert chip_smoke._philox_blocks((37, 29), [5, 7], [19, 13]) == want
    assert chip_smoke._philox_blocks((32000, 4096), [0, 0], [32000, 4096]) == 32000 * 1024


def test_philox_bound_is_the_larger_of_bytes_and_multiplies():
    # bf16 normal at the embedding: 262,144,000 bytes at 3.35 TB/s and
    # 32,768,000 blocks x 40 multiplies at 64 x 132 x 1.98e9 a second tie.
    b = chip_smoke._philox_bound("normal", torch.bfloat16, (32000, 4096), [0, 0], [32000, 4096])
    assert b["bytes"] == 262_144_000 and b["int32_muls"] == 1_310_720_000
    assert b["bound_bytes_ms"] == pytest.approx(0.078252, rel=1e-4)
    assert b["bound_ops_ms"] == pytest.approx(0.078359, rel=1e-4)
    assert b["bound_ms"] == b["bound_ops_ms"] and b["bound_by"] == "operations"
    assert b["bounds_tie"]
    # float64 draws two blocks a counter; its bytes still bound it.
    f64 = chip_smoke._philox_bound("normal", torch.float64, (4096, 11008), [2048, 5504],
                                   [2048, 5504])
    assert f64["int32_muls"] == 2048 * 1376 * 2 * 40
    assert f64["bound_by"] == "bytes" and not f64["bounds_tie"]
    words = chip_smoke._philox_bound("words", torch.int32, (32000, 4096), [16000, 2048],
                                     [16000, 2048])
    assert words["int32_muls"] == 16000 * 512 * 40 and words["bound_by"] == "bytes"


_SASS = [(0x00, "LDC R1, c[0x0][0x28]"), (0x10, "S2R R0, SR_TID.X"),
         (0x20, "IMAD.WIDE.U32 R2, R0, R3, RZ"), (0x30, "LOP3.LUT R4, R2, R5, R6, 0x96, !PT"),
         (0x40, "@P0 BRA 0x20"), (0x50, "IMAD.WIDE.U32 R2, R4, R3, RZ"),
         (0x60, "@!P1 BRA 0x10"), (0x70, "EXIT"), (0x80, "BRA 0x80"), (0x90, "NOP")]


# Two outer loops: a drawing one (0x10-0xc0) whose cold path (0x80-0x90,
# skipped by the branch at 0x70, holds a local store) sits inside a wider
# forward skip (0x30-0xa0, which holds the cold path only through it), and
# a 2-instruction loop after EXIT that does not draw.
_SASS_COLD = [(0x00, "S2R R0, SR_TID.X"), (0x10, "IMAD.WIDE.U32 R2, R5, -0x2daee0ad, RZ"),
              (0x20, "@P2 BRA 0xb0"), (0x30, "IADD3 R4, R2, 0x1, RZ"),
              (0x40, "LOP3.LUT R4, R2, R5, R6, 0x96, !PT"), (0x50, "MUFU.RSQ R7, R4"),
              (0x60, "FMUL R7, R7, R4"), (0x70, "@!P1 BRA 0xa0"), (0x80, "STL [R1], R4"),
              (0x90, "LDL R4, [R1+0x4]"), (0xa0, "STG.E.128 desc[UR4][R8.64], R4"),
              (0xb0, "ISETP.GE.AND P0, PT, R0, R9, PT"), (0xc0, "@!P0 BRA 0x10"),
              (0xd0, "EXIT"), (0xe0, "IADD3 R1, R1, 0x1, RZ"), (0xf0, "@P3 BRA 0xe0")]


def test_sass_loop_takes_the_widest_backward_branch():
    got = chip_smoke._sass_loop(_SASS)
    assert got["instructions"] == 9  # the NOP left out
    assert got["loop"] == 6  # 0x10 to the branch at 0x60
    assert got["loops"] == [{"span": [0x10, 0x60], "all": 6, "hot": 6}]
    assert got["loop_ops"] == {"IMAD": 2, "BRA": 2, "S2R": 1, "LOP3": 1}
    assert chip_smoke._sass_loop(_SASS[:4])["loop"] is None


def test_sass_loop_leaves_out_the_innermost_cold_paths_and_loops_that_do_not_draw():
    got = chip_smoke._sass_loop(_SASS_COLD)
    assert got["loops"] == [{"span": [0x10, 0xc0], "all": 12, "hot": 10},
                            {"span": [0xe0, 0xf0], "all": 2, "hot": 2}]
    assert got["loop"] == 2  # the shortest loop, without a mark
    marked = chip_smoke._sass_loop(_SASS_COLD, chip_smoke.PHILOX_SASS_MARK)
    assert marked["loops"] == got["loops"][:1] and marked["loop"] == 10
    assert "STL" not in marked["loop_ops"] and marked["loop_ops"]["BRA"] == 3


def test_philox_issue_time_is_instructions_over_the_card_issue_rate():
    sass = {"philox_fill<__nv_bfloat16, (int)2>": {"per_element": 50.0}}
    got = chip_smoke._philox_issue("philox_fill<__nv_bfloat16, (int)2>", 131_072_000, sass,
                                   1.98e9)
    # 50 x 131,072,000 / (132 SMs x 128 a clock x 1.98e9) s.
    assert got["issue_ms"] == pytest.approx(0.19590, rel=1e-4)
    assert got["sass_per_element"] == 50.0 and got["sm_clock_hz"] == 1.98e9
    assert chip_smoke._philox_issue("philox_fill<float, (int)1>", 10, sass, 1.98e9)[
        "issue_ms"] is None


def test_route_gaps_near_ties_flips_and_logit_moves():
    # bf16 logits (8 significant bits): token 0's 2nd and 3rd are 2^-9
    # apart, half a unit of the last place at the larger, 0.5 (2^-8);
    # token 1's 0.375 apart, 48 units at 1.0 (2^-7).
    lg = torch.tensor([[1.0, 0.5, 0.5 - 2 ** -9, -1.0], [2.0, 1.0, 0.625, 0.0]],
                      dtype=torch.bfloat16)
    gaps = chip_smoke._route_gaps(lg, 2)
    assert gaps.tolist() == [0.5, 48.0]
    ref = [{"experts": torch.tensor([[0, 1], [0, 1]]), "logits": lg.float(), "gap_ulps": gaps}]
    moved = lg.float() + torch.tensor([[0.0, 0.0, 2 ** -8, 0.0], [0.0] * 4])
    got = [{"experts": torch.tensor([[0, 2], [1, 0]]), "logits": moved, "gap_ulps": None}]
    assert chip_smoke._route_flips(ref, got) == [(0, 0, 0.5)]  # token 1: the same set
    assert chip_smoke._logit_moves(ref, got) == [2 ** -8]


def test_ep_margin_rule_constants():
    # The margin is a few units of bf16's last place, and the near-tie
    # bound applies to (b) alone, above (b)'s own.
    assert 0 < chip_smoke.EP_RANKS_NEAR_TIE_ULPS <= 4
    assert set(chip_smoke.EP_RANKS_NEAR_TIE_GRAD_RTOL) == {"b"}
    assert chip_smoke.EP_RANKS_BOUNDS["b"][1] == 0.036
    assert chip_smoke.EP_RANKS_NEAR_TIE_GRAD_RTOL["b"] > chip_smoke.EP_RANKS_BOUNDS["b"][1]
