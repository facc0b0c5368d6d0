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
# causal): bf16 bounds against the tensor rate, f32 against the CUDA cores'.
@pytest.mark.parametrize(
    "kernel, dtype, bound_ms, bound_by",
    [("flash_fwd", torch.bfloat16, 0.020072, "bytes"),
     ("flash_bwd_fused", torch.bfloat16, 0.043470, "operations"),
     ("flash_bwd_dq", torch.float32, 0.38500, "operations"),
     ("flash_bwd_dkv", torch.float32, 0.51333, "operations")],
)
def test_wide_shape_bounds(kernel, dtype, bound_ms, bound_by):
    row = next(r for r in chip_smoke.FLASH_SHAPES if r[0] == "wide_d256")
    assert row[5] == 256 and row[6] == torch.bfloat16
    args = (*row[1:6], dtype, True)
    if kernel == "flash_fwd":
        got_ms, got_by = chip_smoke._flash_bound(*args)
    else:
        got_ms, got_by = chip_smoke._bwd_bound(kernel, *args)
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

    def row(shape, kernel=None):
        r = {"shape": shape, "max_abs_err": 0.0, "ms": shapes.index(shape), "plain_ms": 2.0,
             "bound_ms": 0.5, "bound_by": "bytes", "library_ms": 0.1}
        return r if kernel is None else {**r, "kernel": kernel}

    rows = [row(r[0]) for r in chip_smoke.FLASH_SHAPES]
    bwd_rows = [row(r[0], k) for r in chip_smoke.BWD_SHAPES
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
            "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(e) for e in entries)
    f32, bf16 = (shapes.index(chip_smoke.WIDE_PATH_SHAPES[d])
                 for d in (torch.float32, torch.bfloat16))
    assert [e["ms"] for e in entries[4:]] == [f32, f32, bf16, bf16, bf16]
    assert entries[6]["source"] == "torchdistx_tpu_torch/ops/cuda/csrc/flash_fwd.cu"
    assert entries[6]["replaces"] == "torchdistx_tpu/ops/pallas/flash_attention.py:161"


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
