#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``torchdistx_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line:

1. build every kernel in ``torchdistx_tpu_torch/ops/cuda/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and the other shapes below, and time the kernel, the
   plain version and the PyTorch library call that computes the same
   function (a yardstick only; the port never calls it): the flash forward
   against SDPA, the three backward kernels against SDPA's backward; every
   input of a kernel must be unchanged after its launch, and a second call
   of a backward kernel must give the same bits in every output that it
   sums in a fixed order (all but the fused kernel's dq);
   ``[head dims]``: the forward and the three backward kernels at head dims
   without a kernel instance (16, 32, 80, 192, 320: zero-padded to 64, 128,
   256 or 512 by the wrappers) and at 256 and 512, bf16 and f32, against
   their plain versions, the rows above 128 timed beside SDPA; then
   ``Llama(llama_test())`` (head_dim 16) on the card, its forward and 3 SGD
   steps of ``make_train_step`` against the CPU port on the same weights;
   then the D = 256 path: a 2-layer Llama of dim 1024 and head_dim 256 in
   f32 against the CPU port (forward, 3 SGD steps), and one bf16 step past
   2048 tokens (the streamed pair); phase 2 holds every D = 256 kernel
   that this path launches at the path's own shapes and dtypes;
3. ``deferred_init`` Llama-7B on ``cuda`` (no bytes allocated); the
   in-place ``materialize_module`` timed as the comparison and freed; then
   a second recording through ``materialize_module_torch(model, seed=0)``
   (per-node seeded generators; bytes, peak and time), one parameter alone
   bit-equal to the module's, distinct streams, the init's statistics, and
   the values loaded into the module by assignment;
4. the 4 x 512 forward with ``attn_impl="auto"`` on those values, which
   launches the flash kernel once per layer; after the forward path it is
   checked against a float32 forward of the same weights (see the
   tolerances below);
5. greedy ``generate`` of 32 tokens for 4 prompts of 512, once cold and
   three times steady;
6. train: ``make_train_step``'s ``step_fn`` on the same model (bf16,
   remat, AdamW), 3 steps on one repeated 4 x 512 batch (the fused
   backward kernel) and 3 steps at 1 x 4096 (the streamed dq + dk/dv
   pair), each shape followed by one more step under the profiler (the
   steady step time is the median of the unprofiled steps after the
   first);
7. train gates: the gradients of a 2-layer model at Llama-7B's width,
   through the kernels and through the plain attention, in f32 and bf16,
   at both training shapes (see the tolerances below);
8. ``[fit]``: ``fit`` on a FIT_LAYERS-layer model at Llama-7B's width
   (bf16, remat, AdamW; ``init_fn`` records and materializes it on the
   card), 4 x 512 batches, checkpointing into a temporary directory: a
   straight run, then a run stopped by a real SIGTERM (the ``step.exec``
   fault site) and resumed, with the checkpoint, resume and launch gates
   below; the save, restore and step times;
9. ``[materialize]``: the f32-recorded Llama-7B materialized in bf16 (its
   peak), two recordings of a 2-layer model bit-equal, and a 1-rank NCCL
   mesh (DTensor values equal to the unsharded ones);
10. ``[slowmo]``: ``initialize`` a 1-rank NCCL group, ``make_mesh``, and
   ``make_slowmo_train_step`` on the full Llama-7B (bf16, remat, SGD base,
   averaging every 2 steps): 6 steps of one repeated 4 x 512 batch, then a
   plain and a profiled averaging step (the averaging's device time against
   its bound), with the launch, ``prev``, momentum and loss gates below;
11. ``[slowmo replicas]``: two SlowMo replicas on the one card (two
   processes over gloo, ``llama_test`` in f32) against the same two-rank run
   on the CPU, bit-equal after each averaging step; ``[slowmo ranks]``:
   replicas of two ranks (4 gloo processes on the card): (a) llama_7b's
   widths x 2 layers under dp=2 x tp=2 against two whole replicas (2 more
   processes) on the same weights and batches, (b) ``llama_test`` f32 under
   dp=2 x fsdp=2 against 4 CPU ranks; replicas bit-equal after each
   averaging step and only then;
12. ``[gpt2]``: the full GPT-2 XL (48 layers, dim 1600, 25 heads of 64,
   bf16): ``deferred_init`` (no bytes), ``materialize_module_torch(seed=0)``
   (bytes 2 x params, the head the embedding's own tensor), the 4 x 1024
   forward (one flash launch a layer) checked against an f32 forward,
   greedy ``generate``, 3 steps of ``make_train_step(model=gpt2)`` (remat,
   AdamW; the fused backward); then ``gpt2_test`` on the card against the
   CPU port;
13. ``[moe]``: ``MoEConfig()``'s widths (llama_7b's, 8 experts, top-2) cut
   to 4 layers: deferred init, seeded materialize, the 4 x 512 forward with
   its aux loss, 3 train steps at 4 x 512 (fused) and 2 at 1 x 4096
   (streamed), each shape's profiled step split between routing, the
   expert GEMMs and attention; then ``moe_test`` on the card against the
   CPU port, its routing exactly, at its own capacity factor and at one
   that drops choices; ``[ep ranks]``: expert parallelism, 4 gloo
   processes on the card: (a) ``MoEConfig()``'s widths x 2 layers under
   ep=4 and (b) fsdp=2 x ep=2 against a 1-rank NCCL run of the same model
   (losses, fingerprints), each rank holding E / ep experts a layer, the
   all-to-all's ms; (c) ``moe_test`` f32 under ep=4 against 4 CPU ranks,
   routing exact;
14. ``[mesh]`` (run after phase 11): ``make_train_step(mesh=)`` on a 1-rank
   NCCL mesh at the full Llama-7B (seeded shard-then-materialize, the
   train path's shapes with its launches a step, each shape's first loss
   against the single-device loss on the same weights, one profiled 4 x
   512 step, and a second step function with a custom ``loss_fn`` on the
   same state, whose loss at lr 0 is the default step's bit for bit), then
   the 2-layer reference run of phase 15 (a);
15. ``[mesh ranks]``: 4 gloo processes sharing the card and 4 on the CPU:
   (a) Llama-7B's widths at 2 layers under ``MeshSpec(fsdp=2, tp=2)``
   (the kernels on each rank's 2 rows and 16 of 32 heads, phase 2's
   ``mesh_rank_block`` rows) against phase 14's reference: losses, the
   first step's gradients and the parameters' change; (b) ``llama_test``
   in f32 under ``fsdp=2, tp=2`` and (c) under ``fsdp=2, sp=2`` with the
   ring (contiguous and zigzag), and (d) on a mesh named ``("data",
   "model")`` with ``fsdp="data", tp="model"`` and a custom ``loss_fn``
   (cross-entropy plus a z-loss in torch ops on the ``DTensor`` logits),
   the card's ranks against the CPU's;
16. ``[pipeline]``: ``make_train_step(mesh=, pp_axis="pp")`` on a 1-rank
   NCCL mesh whose pp axis has size 1, the full Llama-7B, 1F1B and GPipe,
   4 x 512 in 4 microbatches (the kernels on each microbatch's 1 x 512
   block, phase 2's ``pp_micro_block`` rows): seeded stage materialize,
   2 steps each with their launches, the first loss against the
   single-device loss on the same storage, a profiled step (device ms, the
   host's share a tick), the peak allocated; then the 1-rank runs that
   phase 17 is held to;
17. ``[pipeline ranks]``: 4 gloo processes on the card (a hop is an
   ``all_to_all_single``): (a) Llama-7B's widths x 4 layers under pp=4,
   GPipe and 1F1B; (b) pp=2 x tp=2, 1F1B; (c) GPT-2 XL's widths x 4 layers
   under pp=2 x fsdp=2, 1F1B, the tied ``wte`` one f32 accumulator; (d)
   ``MoEConfig()``'s widths x 2 layers under dp=2 x pp=2, GPipe; (e)
   llama_7b's widths x 4 layers under pp=2 x sp=2, GPipe, 2 x 1024 in 2
   microbatches, the ring in each stage (no flash launch); each against its
   1-rank run (losses, the fingerprints of the first step's
   gradients and of the parameters' change), each rank holding its stage's
   layers only, the kernel on the microbatch block phase 2 holds, and the
   hop's time a tick;
18. ``[resnet]``: ResNet-50 (BASELINE config 2) recorded claiming the card
   with no byte allocated, seeded onto it (bytes those of its parameters
   and buffers), an eval forward, two recordings bit-equal.

Ten main paths are driven, each with every launch count set to 0 just
before it and read just after: the D = 256 path (end of phase 2), the
forward path (phases 3 to 5: seeded materialize, forward, generate), the
train path (phase 6, on the forward path's values), the fit path (phase 8),
the SlowMo path (phase 10), the mesh path (phase 14, read around each of
its steps, so that its single-device reference forwards and its 2-layer
reference run are not counted), the mesh ranks' runs (phase 15 (a), (b)
and (d), in each card rank), the SlowMo ranks' runs and the ep ranks'
runs (in each card rank; their references are not counted), the pipeline
path (phase 16, read around each
of its steps; the pipeline ranks' runs in each card rank), the GPT-2 path
(phase 12: its forward part, then its train part) and the MoE path (phase
13).  Any failed check
raises, so the script exits non-zero and prints no result.  float32
matmuls run in full float32 (TF32 is switched off).  The last three lines
are the kernels' summary, the card's name and power limit, then the result
object.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import torch

# Yardsticks of one H100 SXM (NVIDIA's data sheet, dense rates).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain tolerances on (out, lse).  bf16: out is rounded to bf16
# (2^-8 relative) and p is rounded to bf16 against a running max in the
# kernel but the row max in the plain version; f32: summation order only.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}

# (name, B, S, Hq, Hkv, D, dtype, causal); the first is the main path's.
FLASH_SHAPES = [
    ("llama7b_main", 4, 512, 32, 32, 128, torch.bfloat16, True),
    ("gqa_70b_heads", 2, 1024, 64, 8, 128, torch.bfloat16, True),
    ("ragged_f32", 2, 1000, 8, 8, 64, torch.float32, False),
    ("decode_s1", 4, 1, 32, 32, 128, torch.bfloat16, True),
    ("train_1x4096", 1, 4096, 32, 32, 128, torch.bfloat16, True),
    ("ragged_bf16_d64", 2, 1000, 12, 12, 64, torch.bfloat16, False),
    ("gqa_ragged_bf16", 1, 4095, 32, 8, 128, torch.bfloat16, True),
    # The D = 256 instances (CUDA cores) at a 256-wide-head model's shape,
    # then at the D = 256 path's own shapes (WIDE_PATH_SHAPES).
    ("wide_d256", 2, 1024, 16, 16, 256, torch.bfloat16, True),
    ("d256_path_f32", 2, 64, 4, 2, 256, torch.float32, True),
    ("d256_path_bf16", 1, 2112, 4, 2, 256, torch.bfloat16, True),
    # The D = 512 instances (CUDA cores) at [head dims]' shape.
    ("d512", 2, 300, 8, 2, 512, torch.bfloat16, True),
    # The [gpt2] path's attention: gpt2_xl at GPT2_SHAPE, 25 heads of 64.
    ("gpt2_xl_heads", 4, 1024, 25, 25, 64, torch.bfloat16, True),
    # [mesh ranks]' kernel blocks (MESH_RANK_BLOCKS): (a) llama_7b's heads at
    # MESH_RANKS_SHAPE over fsdp=2 x tp=2; (b) llama_test's (head dim 16,
    # launched at 64) at MESH_RANKS_F32_SHAPE.
    ("mesh_rank_block", 2, 512, 16, 16, 128, torch.bfloat16, True),
    ("mesh_rank_f32_block", 2, 32, 2, 1, 64, torch.float32, True),
    # The pipelines' microbatch blocks (PIPE_BLOCKS): [pipeline] and
    # [pipeline ranks] (a), (d) at llama_7b's heads; (b) at its tp share;
    # (c) at gpt2_xl's heads.
    ("pp_micro_block", 1, 512, 32, 32, 128, torch.bfloat16, True),
    ("pp_tp_block", 1, 512, 16, 16, 128, torch.bfloat16, True),
    ("pp_gpt2_block", 1, 512, 25, 25, 64, torch.bfloat16, True),
    # [ep ranks] (b)'s block (EP_BLOCKS: MoEConfig()'s heads at
    # EP_RANKS_SHAPE over fsdp=2; (a)'s is llama7b_main's), and [slowmo
    # ranks] (b)'s (SLOWMO_RANK_BLOCKS: llama_test's heads over fsdp=2; (a)'s
    # is mesh_rank_block's).
    ("ep_fsdp_block", 2, 512, 32, 32, 128, torch.bfloat16, True),
    ("slowmo_f32_block", 2, 32, 4, 2, 64, torch.float32, True),
]

BATCH, SEQ, NEW_TOKENS = 4, 512, 32
# Generate runs once cold, then this many times steady (the median is
# reported with every run, since the host's dispatch rate varies).
GENERATE_STEADY_RUNS = 3
# The forward's checks against a float32 forward of the same weights on the
# plain attention ("the f32 reference").  In float32 the flash path must
# match it: logits within F32_LOGITS_ATOL, top-1 agreement >= TOP1_MIN.  In
# bf16, rounding through 32 random layers leaves every implementation about
# as far from it as any other (top-1 near 0.87 for each), so the bf16 flash
# forward must be no farther from it than the bf16 plain forward: mean
# |dlogits| at most BF16_MEAN_SLACK times the plain one's, top-1 agreement
# at most BF16_TOP1_SLACK below it; and the two bf16 forwards may differ
# from each other by a mean |dlogits| no larger than the plain one's own
# mean error against the f32 reference.
F32_LOGITS_ATOL = 1e-3
TOP1_MIN = 0.99
BF16_MEAN_SLACK = 1.1
BF16_TOP1_SLACK = 0.02
# GPT-2 XL's 48 layers carry any rounding difference up to the full size of
# the bf16 error, so its two bf16 forwards are about as far from the f32
# reference as each other (flash 0.010619, plain 0.010619 mean |dlogits| on
# an H100) and, their errors being nearly independent, up to sqrt(2) times
# that apart (0.011835): its flash-vs-plain gate allows that factor.
GPT2_PAIR_SLACK = math.sqrt(2)

# Backward kernels: (name, B, S, Hq, Hkv, D, dtype, causal, route); the
# first two are the train path's shapes.  route "fused" runs
# flash_bwd_fused, "streamed" runs flash_bwd_dq and flash_bwd_dkv.
BWD_SHAPES = [
    ("train_4x512", 4, 512, 32, 32, 128, torch.bfloat16, True, "fused"),
    ("train_1x4096", 1, 4096, 32, 32, 128, torch.bfloat16, True, "streamed"),
    ("gqa_70b_heads", 2, 1024, 64, 8, 128, torch.bfloat16, True, "fused"),
    ("ragged_f32", 2, 1000, 8, 8, 64, torch.float32, False, "fused"),
    ("ragged_f32", 2, 1000, 8, 8, 64, torch.float32, False, "streamed"),
    ("gqa_ragged_bf16", 1, 4095, 32, 8, 128, torch.bfloat16, True, "streamed"),
    ("ragged_bf16_d64", 2, 1000, 12, 12, 64, torch.bfloat16, False, "streamed"),
    ("ragged_bf16_d64", 2, 1000, 12, 12, 64, torch.bfloat16, False, "fused"),
    ("wide_d256", 2, 1024, 16, 16, 256, torch.bfloat16, True, "fused"),
    ("wide_d256", 2, 1024, 16, 16, 256, torch.bfloat16, True, "streamed"),
    ("d256_path_f32", 2, 64, 4, 2, 256, torch.float32, True, "fused"),
    ("d256_path_bf16", 1, 2112, 4, 2, 256, torch.bfloat16, True, "streamed"),
    ("d512", 2, 300, 8, 2, 512, torch.bfloat16, True, "fused"),
    ("d512", 2, 300, 8, 2, 512, torch.bfloat16, True, "streamed"),
    ("gpt2_xl_heads", 4, 1024, 25, 25, 64, torch.bfloat16, True, "fused"),
    ("mesh_rank_block", 2, 512, 16, 16, 128, torch.bfloat16, True, "fused"),
    ("mesh_rank_f32_block", 2, 32, 2, 1, 64, torch.float32, True, "fused"),
    ("pp_micro_block", 1, 512, 32, 32, 128, torch.bfloat16, True, "fused"),
    ("pp_tp_block", 1, 512, 16, 16, 128, torch.bfloat16, True, "fused"),
    ("pp_gpt2_block", 1, 512, 25, 25, 64, torch.bfloat16, True, "fused"),
    ("ep_fsdp_block", 2, 512, 32, 32, 128, torch.bfloat16, True, "fused"),
    ("slowmo_f32_block", 2, 32, 4, 2, 64, torch.float32, True, "fused"),
]
# kernel -> (returns dq, returns dk/dv); per route.
BWD_KERNELS = {
    "fused": {"flash_bwd_fused": (True, True)},
    "streamed": {"flash_bwd_dq": (True, False), "flash_bwd_dkv": (False, True)},
}
# The outputs that each kernel sums in a fixed order: a second call on the
# same inputs must give them the same bits.  The fused kernel's dq is summed
# across blocks in an order that varies from run to run (TMA reductions in
# bf16, atomics in f32); its dk and dv are not.
BWD_DETERMINISTIC = {"flash_bwd_fused": ("dk", "dv"), "flash_bwd_dq": ("dq",),
                     "flash_bwd_dkv": ("dk", "dv")}
# Kernel vs plain on (dq, dk, dv): the largest |kernel - plain| over
# max(1, the largest |plain|).  bf16: p, ds and the outputs are rounded to
# bf16 (2^-8 relative), so a pair whose p or ds rounds the other way moves
# its products by that much; f32: summation order only (the fused dq also
# sums across blocks in an order that changes from run to run).
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# 2 D flops per causal pair for each product of the kernel.
BWD_PRODUCTS = {"flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}

# The train path: Llama-7B, bf16, remat on, AdamW (foreach=False: the
# default multi-tensor AdamW takes temporaries the size of the whole
# parameter set, 13.5 GB, on top of the 54 GB of parameters, gradients and
# two moments).  Per shape (B, S): steps on one repeated batch, and the
# backward route every layer must take.
TRAIN_SEED = 0
TRAIN_LR = 1e-4
TRAIN_SHAPES = [((4, 512), 3, "fused"), ((1, 4096), 3, "streamed")]
# Train gates on a 2-layer model at Llama-7B's width, each parameter's
# gradient g against the plain attention's, as ||g - g_ref|| / ||g_ref||:
# in f32 the kernels' gradients within GRAD_F32_RTOL of the plain ones (and
# the loss within LOSS_F32_ATOL); in bf16 the kernels' gradients no farther
# from the f32 plain ones than GRAD_BF16_SLACK times the bf16 plain ones.
GATE_LAYERS = 2
GATE_SEED = 5
LOSS_F32_ATOL = 1e-4
GRAD_F32_RTOL = 1e-3
GRAD_BF16_SLACK = 1.1

# [head dims]: head dims without a kernel instance (the wrappers pad them to
# 64, 128, 256 or 512) and the 256 and 512 instances, at (B, S, Hq, Hkv), the
# ones above 128 timed beside SDPA; llama_test on the card against the CPU
# port within HEAD_DIM_LOSS_ATOL (f32, TF32 off), SGD(lr) for 3 steps.
PADDED_HEAD_DIMS = [16, 32, 80]
WIDE_HEAD_DIMS = [192, 256, 320, 512]
PADDED_SHAPE = (2, 300, 8, 2)
HEAD_DIM_LOSS_ATOL = 1e-5
HEAD_DIM_SGD_LR = 0.1

# [head dims]'s D = 256 path: f32 at WIDE_F32_BATCH (the fused backward),
# then the bf16 step at 1 x WIDE_STREAMED_S (above 2048, so the streamed
# pair).  Phase 2 holds each kernel the path launches against its plain
# version at the path's own (B, S, Hq, Hkv, D) and dtype: the rows named in
# WIDE_PATH_SHAPES, by dtype.
WIDE_F32_BATCH = (2, 64)
WIDE_STREAMED_S = 2112
WIDE_PATH_SHAPES = {torch.float32: "d256_path_f32", torch.bfloat16: "d256_path_bf16"}

# The seeded materialize at llama_7b width (phase 3, whose values the
# forward and train paths run on): std within 2 % of the init's; then
# [materialize]: the f32-recorded model materialized in bf16 within 2 x its
# largest f32 parameter of the bf16 total, two recordings of
# MAT_SMALL_LAYERS layers bit-equal, and a 1-rank NCCL mesh.
MAT_SEED = 0
MAT_SMALL_LAYERS = 2

# [fit]: depth cut to FIT_LAYERS at Llama-7B's width, so that a checkpoint
# (parameters and AdamW's two moments, bf16) is about 4 GB, not 40 GB.
# FIT_STEPS steps of 4 x 512, a checkpoint every FIT_EVERY, FIT_KEEP kept;
# the interrupted run takes a real SIGTERM as step FIT_STOP is about to run,
# so fit saves FIT_STOP and returns, and the second call resumes there.
# The resumed losses may differ from the straight run's by FIT_LOSS_ATOL:
# the fused kernel's dq is summed by TMA reductions in an order that varies,
# so the last bits of the gradients (and of AdamW's bf16 updates) do.
FIT_LAYERS = 2
FIT_SHAPE = (4, 512)
FIT_STEPS, FIT_EVERY, FIT_KEEP, FIT_STOP = 6, 2, 3, 3
FIT_DATA_SEED = 6
FIT_LOSS_ATOL = 0.02

# [slowmo]: make_slowmo_train_step on the full llama_7b (bf16, remat), one
# replica on a 1-rank NCCL mesh, SGD at SLOWMO_LR, averaging every
# SLOWMO_FREQ steps; then one more cycle, whose averaging step is profiled.
# At SLOWMO_LR the loss on the repeated batch falls over SLOWMO_STEPS steps
# in bf16 (from 11.23 to 5-6 by step 7 on an H100); from 0.5 up it climbs again
# by step 6, and from 8 it overflows to nan.  SGD, because parameters,
# gradients, prev and momentum are 4 x 13.48 GB: an AdamW base would add 27
# GB past 80 GB.
SLOWMO_SHAPE = (4, 512)
SLOWMO_STEPS = 6
SLOWMO_LR = 0.1
SLOWMO_FREQ, SLOWMO_FACTOR, SLOWMO_SLR = 2, 0.5, 1.0
SLOWMO_DATA_SEED = 11
# Two replicas on the one card (gloo, 2 processes; NCCL takes one rank per
# device): llama_test in f32 on rows that differ, SLOWMO_FREQ, against the
# same 2-rank run on the CPU within SLOWMO_REPLICA_ATOL (TF32 off).
SLOWMO_REPLICA_STEPS = 4
SLOWMO_REPLICA_ATOL = 1e-5
SLOWMO_REPLICA_TIMEOUT_S = 300

# [gpt2]: the full gpt2_xl (48 layers, dim 1600, 25 heads of 64, vocab
# 50257, bf16, remat), random weights from MAT_SEED: deferred init, seeded
# materialize, the forward at GPT2_SHAPE, greedy generate of NEW_TOKENS for
# BATCH prompts of SEQ, then GPT2_TRAIN_SHAPES of make_train_step(model=
# gpt2) with the train path's AdamW; then gpt2_test on the card against the
# CPU port.  Phase 2 holds its kernels at the GPT2_HEADS rows.
GPT2_SHAPE = (4, 1024)
GPT2_TRAIN_SHAPES = [(GPT2_SHAPE, 3, "fused")]
# At the train path's 1e-4, AdamW's third step on the repeated batch
# overshoots (losses 11.146, 10.706, 11.633 on an H100), in bf16 and f32
# and through the flash and the plain attention alike; at 3e-5 the loss
# falls for three steps (11.146, 10.681, 10.332); scripts/
# torch_gpt2_adamw_rates.py runs that comparison.
GPT2_TRAIN_LR = 3e-5
GPT2_HEADS = "gpt2_xl_heads"
# [moe]: MoEConfig()'s own widths (llama_7b's, 8 experts, top-2, capacity
# factor 1.25) cut to MOE_LAYERS layers, 4.86 B parameters (9.72 GB in
# bf16): the 32 layers are 37.0 B (74 GB), which leave no room for
# gradients and AdamW's moments on one 80 GB card.  The forward at
# MOE_SHAPE, MOE_TRAIN_SHAPES' steps (the train path's AdamW) with the
# routing split of each profiled step; then moe_test on the card against
# the CPU port, routing exact.
MOE_LAYERS = 4
MOE_SHAPE = (4, 512)
MOE_TRAIN_SHAPES = [(MOE_SHAPE, 3, "fused"), ((1, 4096), 2, "streamed")]
MOE_DROPPING_FACTOR = 0.5
# [mesh]: make_train_step(mesh=) on a 1-rank NCCL mesh (MeshSpec(): every
# parameter a replicated DTensor), the full llama_7b (bf16, remat) with the
# train path's AdamW at TRAIN_SHAPES: the same launches a step as the train
# path, and each shape's first loss within MESH_LOSS_ATOL of the
# single-device loss on the same weights (the same kernels; the mean's
# summation order differs).  Then the MESH_RANKS_LAYERS-layer model's
# MESH_RANKS_STEPS steps on the same mesh: the losses [mesh ranks] (a) is
# held to.
MESH_LOSS_ATOL = 1e-3
# [mesh ranks]: 4 processes sharing the card over gloo (NCCL takes one rank
# per device).  Gloo runs the mesh step's all-gathers, reduce-scatters and
# all-reduces and the ring's all_to_all_single on CUDA tensors; its
# point-to-point send and receive abort or hang on them
# (scripts/torch_gloo_cuda_probe.py), which is why a ring hop is an
# all_to_all_single.  (a) llama_7b's widths cut to MESH_RANKS_LAYERS layers,
# bf16, remat, MeshSpec(fsdp=2, tp=2), MESH_RANKS_STEPS AdamW steps at
# MESH_RANKS_SHAPE, against [mesh]'s run on the same seeded weights: the
# losses within MESH_RANKS_BF16_ATOL (the row-parallel products are bf16
# partial sums added over tp in another order), and the fingerprints
# (_fingerprint: signed row and column sums) of the first step's gradients and of the parameters'
# change over the steps within MESH_RANKS_GRAD_RTOL and
# MESH_RANKS_UPDATE_RTOL; (b) llama_test in f32 under
# MeshSpec(fsdp=2, tp=2) and (c) MeshSpec(fsdp=2, sp=2) with the ring,
# contiguous and zigzag, MESH_RANKS_F32_STEPS AdamW steps, each against the
# same 4 ranks on the CPU within MESH_RANKS_F32_ATOL (TF32 off).
MESH_RANKS_LAYERS = 2
MESH_RANKS_STEPS = 2
MESH_RANKS_SHAPE = (4, 512)
MESH_RANKS_SEED = 7
MESH_RANKS_DATA_SEED = 8
# On an H100 the losses read 3.0e-4 to 4.4e-4 from the 1-rank run's, the
# fingerprints 2.4e-2 (gradients) and 0.12 (change: AdamW moves an element
# by about lr a step, under bf16's ulp near 0.02, so an update that rounds
# the other way counts whole); a misplaced shard reads about 1 or more.
MESH_RANKS_BF16_ATOL = 2e-3
MESH_RANKS_GRAD_RTOL = 0.1
MESH_RANKS_UPDATE_RTOL = 0.5
MESH_RANKS_F32_ATOL = 1e-5
MESH_RANKS_F32_STEPS = 3
MESH_RANKS_F32_SHAPE = (4, 32)
MESH_RANKS_TIMEOUT_S = 400
# The (B, S, Hq, Hkv, D) each [mesh ranks] run hands the kernel (D before
# padding to the kernel's head dim), and its phase-2 rows.
MESH_RANK_BLOCKS = {"a": ((2, 512, 16, 16, 128), "mesh_rank_block"),
                    "b": ((2, 32, 2, 1, 16), "mesh_rank_f32_block")}
# [pipeline]: make_train_step(mesh=, pp_axis="pp") on a 1-rank NCCL mesh
# whose only axis is "pp" (size 1: one stage holds every layer, and the
# parameters are plain tensors), the full llama_7b (bf16, the train path's
# AdamW) at PIPE_SHAPE in PIPE_MICROBATCHES microbatches, PIPE_STEPS steps
# of each schedule then one profiled step; each schedule's first loss
# within MESH_LOSS_ATOL of the single-device loss on the same storage.
# Then the 1-rank runs that [pipeline ranks] is held to (PIPE_RANK_RUNS).
PIPE_SHAPE = (4, 512)
PIPE_MICROBATCHES = 4
PIPE_STEPS = 2
PIPE_SCHEDULES = ("1f1b", "gpipe")
PIPE_DATA_SEED = 12
# [pipeline ranks]: 4 gloo processes on the card (a hop is an
# all_to_all_single, which gloo runs on CUDA tensors), each run against
# the same run on the 1-rank mesh of [pipeline] (same seed, same batch,
# same schedule): (a) llama_7b's widths x 4 layers under pp=4, GPipe and
# 1F1B; (b) the same under pp=2 x tp=2, 1F1B; (c) gpt2_xl's widths x 4
# layers under pp=2 x fsdp=2, 1F1B (the tied wte one f32 accumulator);
# (d) MoEConfig()'s widths x 2 layers under dp=2 x pp=2, GPipe (1F1B's f32
# accumulators of a whole 2.2 GB expert layer on each of four ranks,
# beside its moments, outgrow the card); (e) below.  Run ->
# (family, layers, mesh axes, schedule, batch); every run takes
# PIPE_MICROBATCHES microbatches and PIPE_RANKS_STEPS AdamW steps.
PIPE_RANK_RUNS = {
    "a_gpipe": ("llama", 4, {"pp": 4}, "gpipe", (4, 512)),
    "a_1f1b": ("llama", 4, {"pp": 4}, "1f1b", (4, 512)),
    "b": ("llama", 4, {"pp": 2, "tp": 2}, "1f1b", (4, 512)),
    "c": ("gpt2", 4, {"pp": 2, "fsdp": 2}, "1f1b", (8, 512)),
    "d": ("moe", 2, {"dp": 2, "pp": 2}, "gpipe", (8, 512)),
    "e": ("llama", 4, {"pp": 2, "sp": 2}, "gpipe", (2, 1024)),
}
# (e) is sequence parallelism inside each GPipe stage: 2 microbatches of one
# row, each stage's attention the ring over sp (its block math plain torch,
# as the JAX ring's is jnp: no flash launch), against the 1-rank run, whose
# attention is the kernel over the whole sequence.
PIPE_RANK_OPTIONS = {"e": {"n_microbatches": 2, "seq_axis": "sp"}}
PIPE_RANKS_STEPS = 2
PIPE_RANKS_SEED = 9
PIPE_RANKS_DATA_SEED = 10
PIPE_RANKS_TIMEOUT_S = 400
# Each run against its 1-rank run: (losses' atol, and the relative error of
# the fingerprints (_fingerprint) of the first step's gradients and of the
# parameters' change), about 4x the largest readings of two runs on an H100
# 80GB HBM3 at 700 W (a: 4.7e-5, 9.9e-3, 0.084; b: 5.7e-4, 4.0e-2, 0.199;
# c: 3.0e-4, 1.6e-2, 0.687; d: 3.0e-2, 9.6e-3, 0.230; PERF.md section 6).  (a) splits the same math over
# stages, so only the head's and the fused dq's summation orders differ;
# (b) adds tp's bf16 partial sums; (c)'s change is GPT-2's zero-initialized
# biases, whose first AdamW step is +-lr by the sign of a near-zero
# gradient (its gradients carry the check); (d)'s second loss follows top-2
# near-ties that bf16 rounding on a 1-row block breaks otherwise; (e)
# (one run: 2.5e-4, 5.4e-2, 0.23) sums the ring's blocks in f32 where the
# 1-rank run's kernel rounds p to bf16.
PIPE_RANKS_BOUNDS = {"a_gpipe": (2e-4, 0.04, 0.35), "a_1f1b": (2e-4, 0.04, 0.35),
                     "b": (2.5e-3, 0.16, 0.8), "c": (1.2e-3, 0.064, 2.75),
                     "d": (0.12, 0.04, 0.92), "e": (1e-3, 0.22, 0.92)}
# [resnet]: BASELINE config 2, "deferred_init resnet50, materialize on a
# single chip": ResNet-50 (models/resnet_torch.py) recorded claiming the
# card, seeded onto it, then an eval forward of RESNET_BATCH images.
RESNET_BATCH = (8, 3, 224, 224)
# The (B, S, Hq, Hkv, D) the kernel sees on each pipeline (a rank's rows
# of a microbatch), and its phase-2 rows.
PIPE_BLOCKS = {"pipeline": ((1, 512, 32, 32, 128), "pp_micro_block"),
               "a_gpipe": ((1, 512, 32, 32, 128), "pp_micro_block"),
               "a_1f1b": ((1, 512, 32, 32, 128), "pp_micro_block"),
               "b": ((1, 512, 16, 16, 128), "pp_tp_block"),
               "c": ((1, 512, 25, 25, 64), "pp_gpt2_block"),
               "d": ((1, 512, 32, 32, 128), "pp_micro_block"),
               "e": (None, None)}  # the ring: no kernel block
# [ep ranks]: 4 gloo processes sharing the card and 4 on the CPU.  (a)
# MoEConfig()'s widths (dim 4096, 8 experts of ffn 11008, top-2) x
# EP_RANKS_LAYERS layers, bf16, remat, under MeshSpec(ep=4), and (b) under
# MeshSpec(fsdp=2, ep=2): EP_RANKS_STEPS AdamW steps at EP_RANKS_SHAPE each,
# against the same steps on a 1-rank NCCL mesh from the same seeded weights
# (phase_ep_reference): losses, and the fingerprints of the first step's
# gradients and of the parameters' change within EP_RANKS_BOUNDS; each
# rank's expert stacks E / ep experts a layer and its bytes those of its
# shards by the plan; the all-to-all's time.  (c) moe_test in f32 under
# ep=4, EP_RANKS_F32_STEPS AdamW steps, the card's ranks against the CPU's
# within MESH_RANKS_F32_ATOL, every layer's routing equal.
EP_RANKS_LAYERS = 2
EP_RANKS_STEPS = 3
EP_RANKS_SHAPE = (4, 512)
EP_RANKS_SEED = 15
EP_RANKS_DATA_SEED = 16
EP_RANK_RUNS = {"a": {"ep": 4}, "b": {"fsdp": 2, "ep": 2}}
# (losses' atol, the fingerprints' relative errors: first-step gradients,
# the parameters' change): about 4x the readings of a run on an H100 80GB
# HBM3 at 700 W (a: 3.5e-2, 3.2e-3, 0.23; b: 5.2e-2, 8.8e-3, 0.24): bf16
# expert GEMMs on a share's rows round otherwise than on the whole buffer,
# and top-2 near-ties then route otherwise from the second step.
EP_RANKS_BOUNDS = {"a": (0.14, 0.013, 0.92), "b": (0.2, 0.036, 0.96)}
EP_RANKS_F32_STEPS = 3
EP_RANKS_TIMEOUT_S = 400
# The (B, S, Hq, Hkv, D) each run hands the kernel, and its phase-2 rows:
# (a)'s batch is not split (ep does not split the batch), (b)'s over fsdp.
EP_BLOCKS = {"a": ((4, 512, 32, 32, 128), "llama7b_main"),
             "b": ((2, 512, 32, 32, 128), "ep_fsdp_block")}
# [slowmo ranks]: replicas of two ranks.  4 gloo processes on the card: (a)
# llama_7b's widths x SLOWMO_RANKS_LAYERS layers, bf16, remat, under
# MeshSpec(dp=2, tp=2), SGD base at SLOWMO_LR averaging every SLOWMO_FREQ,
# SLOWMO_RANKS_STEPS steps on a (dp, B, S) = (2,) + SLOWMO_RANKS_SHAPE batch,
# against the same run with whole replicas (2 gloo processes, MeshSpec(dp=2),
# phase 11's kind) on the same seeded weights and batches: the mean losses
# within SLOWMO_RANKS_BOUNDS[0] and the fingerprints of the parameters'
# change within [1]; the replicas bit-equal after each averaging step and
# only then.  (b) llama_test in f32 under MeshSpec(dp=2, fsdp=2), the same
# steps, the card's ranks against 4 CPU ranks within SLOWMO_REPLICA_ATOL.
SLOWMO_RANKS_LAYERS = 2
SLOWMO_RANKS_STEPS = 4
SLOWMO_RANKS_SHAPE = (2, 512)
SLOWMO_RANKS_F32_SHAPE = (4, 32)
SLOWMO_RANKS_SEED = 17
SLOWMO_RANKS_DATA_SEED = 18
# About 4x the readings of a run on an H100 80GB HBM3 at 700 W (1.7e-3,
# 0.19): tp's bf16 partial sums, carried by SGD at 0.1 on a repeated batch
# (the loss falls from 11.2 to 0.4 in a step).
SLOWMO_RANKS_BOUNDS = (7e-3, 0.8)
SLOWMO_RANKS_TIMEOUT_S = 400
SLOWMO_RANK_BLOCKS = {"a": ((2, 512, 16, 16, 128), "mesh_rank_block"),
                      "b": ((2, 32, 4, 2, 16), "slowmo_f32_block")}
# [mesh ranks] (d) and [mesh]'s custom loss: cross-entropy plus Z_LOSS times
# the mean squared log-partition, torch ops on the model's logits.
Z_LOSS = 1e-3


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _time_ms(fn, *, warmup: int = 3, reps: int = 21, calls: int = 10) -> float:
    """Time of one call by CUDA events: the median over ``reps`` of
    ``calls`` back-to-back calls between two events, divided by ``calls``.
    Back to back, the host queues the next launch while the card runs the
    last one, so a call that takes the card longer than the host's launch
    path reads its device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _device_ms(fn, *, calls: int = 10) -> float:
    """Device time of one call from torch.profiler: the card's kernel time
    summed over ``calls`` calls, divided by ``calls`` (host time left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.time_range.elapsed_us() for ev in _device_events(prof))
    return total_us / 1e3 / calls


def _device_events(prof, *, annotations: bool = False):
    """The profiler's device events: kernels and copies, or (with
    ``annotations``) the user annotations that the profiler also lists on
    the device, such as ``Optimizer.step#AdamW.step``, whose span covers
    kernels already counted."""
    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and bool(getattr(ev, "is_user_annotation", False)) == annotations]


def _flash_bound(b, s, hq, hkv, d, dtype, causal):
    """(bound_ms, bound_by): each input read once and each output written
    once, against the operations these shapes need (the causal triangle
    counts only its pairs)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * esize + b * hq * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4 * b * hq * d * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _bwd_bound(kernel, b, s, hq, hkv, d, dtype, causal):
    """(bound_ms, bound_by) of one backward kernel: q, k, v, do, lse and
    delta read once, its outputs (dq; dk, dv; or all three) written once,
    against its products' operations over the pairs these shapes need."""
    esize = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes = b * s * hq * d * esize, b * s * hkv * d * esize
    nbytes = 2 * q_bytes + 2 * kv_bytes + 2 * b * hq * s * 4
    if kernel != "flash_bwd_dkv":
        nbytes += q_bytes
    if kernel != "flash_bwd_dq":
        nbytes += 2 * kv_bytes
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = BWD_PRODUCTS[kernel] * 2 * b * hq * d * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _ptxas_report(logs):
    """{demangled kernel: {registers, spill_stores, spill_loads, stack}} from
    nvcc's -Xptxas -v output."""
    import os
    import re

    entries, current = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = m.group(1)
                entries[current] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if current is not None and m:
                entries[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                        spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if current is not None and m:
                entries[current]["registers"] = int(m.group(1))
    filt = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cu++filt")
    names = subprocess.run([filt], input="\n".join(entries), text=True, capture_output=True,
                           check=True, timeout=60).stdout.splitlines()
    out = {}
    for mangled, name in zip(entries, names):
        name = name.removeprefix("void ")  # "ns::kernel<T, (int)D>(args)"
        out[name[:name.rindex(">") + 1]] = entries[mangled]
    return out


def phase_build():
    """Build every kernel; returns the ptxas report of each instance."""
    from torchdistx_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    print(f"[build] {built} in {secs:.2f} s (sources: {_build.sources()})")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill",
                                       "Performance Loss")):
                print(f"[build] {name}: {line.strip()}")
    report = _ptxas_report(_build.build_logs)
    _check(bool(report) or not built, "no ptxas report from the build")
    wide = {k: v for k, v in report.items() if "(int)512" in k}
    print("[build] the D = 512 instances: " + json.dumps(wide))
    return report


def phase_kernels():
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, s, hq, hkv, d, dtype, causal in FLASH_SHAPES:
        def rand(h):
            return torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=dtype)

        q, k, v = rand(hq), rand(hkv), rand(hkv)
        before = [t.clone() for t in (q, k, v)]
        out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _check(all(torch.equal(t, c) for t, c in zip((q, k, v), before)),
               f"{name}: an input changed during the forward launch")
        del before
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = TOL[dtype]
        _check(bool(torch.isfinite(out).all()), f"{name}: non-finite out")
        _check(err_out <= tol_out, f"{name}: out err {err_out} > {tol_out}")
        _check(err_lse <= tol_lse, f"{name}: lse err {err_lse} > {tol_lse}")

        # The library call on (B, H, S, D) inputs with the kv heads
        # expanded to Hq (done once, outside the timed call).
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
        calls = {
            "": lambda: fa.flash_attention_fwd_with_lse(q, k, v, causal=causal),
            "plain_": lambda: fa.flash_attention_reference(q, k, v, causal=causal),
            "library_": lambda: sdpa(qt, kt, vt, is_causal=causal),
        }
        bound_ms, bound_by = _flash_bound(b, s, hq, hkv, d, dtype, causal)
        row = {
            "shape": name, "B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d,
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "max_abs_err": err_out, "lse_max_abs_err": err_lse, "inputs_unchanged": True,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        for prefix, fn in calls.items():
            row[prefix + "ms"] = _time_ms(fn)
            row[prefix + "device_ms"] = _device_ms(fn)
        print("[flash_fwd] " + json.dumps(row))
        rows.append(row)
        del q, k, v, out, lse, ref_out, ref_lse, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_bwd_kernels():
    """Each backward kernel against its plain version (flash_bwd_plain) on
    the same (q, k, v, do, lse, delta), with its time, the plain version's,
    SDPA's backward of the same (out, do) and its bound."""
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, b, s, hq, hkv, d, dtype, causal, route in BWD_SHAPES:
        def rand(h):
            return torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=dtype)

        q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)
        out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=causal)
        delta = fa.attention_delta(do, out)
        args = (q, k, v, do, lse, delta)

        library = _library_grads(q, k, v, do, causal)
        library_ms, library_device_ms = _time_ms(library), _device_ms(library)
        for kernel, (want_dq, want_dkv) in BWD_KERNELS[route].items():
            launch = getattr(fa, kernel)

            def run():
                return launch(*args, causal=causal)

            def plain():
                return fa.flash_bwd_plain(*args, causal=causal, dq=want_dq, dkv=want_dkv)

            before = [a.clone() for a in args]
            got = run()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            _check(all(torch.equal(a, c) for a, c in zip(args, before)),
                   f"{kernel} {name}: an input changed during the launch")
            again = run()
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            _check(all(torch.equal(a, c) for a, c in zip(args, before)),
                   f"{kernel} {name}: an input changed during the second launch")
            outs = [n for n, w in zip(("dq", "dk", "dv"), (want_dq, want_dkv, want_dkv)) if w]
            same = dict(zip(outs, (torch.equal(g, a) for g, a in zip(got, again))))
            _check(all(same[n] for n in BWD_DETERMINISTIC[kernel]),
                   f"{kernel} {name}: two calls gave different bits: {same}")
            del again, before
            want = [w for w in plain() if w is not None]
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            scale = max(1.0, max(w.float().abs().max().item() for w in want))
            _check(all(bool(torch.isfinite(g).all()) for g in got), f"{kernel} {name}: non-finite")
            _check(err / scale <= BWD_TOL[dtype],
                   f"{kernel} {name}: err {err} / {scale} > {BWD_TOL[dtype]}")
            bound_ms, bound_by = _bwd_bound(kernel, b, s, hq, hkv, d, dtype, causal)
            row = {
                "kernel": kernel, "shape": name, "B": b, "S": s, "Hq": hq, "Hkv": hkv,
                "D": d, "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                "max_abs_err": err, "max_abs_ref": scale, "inputs_unchanged": True,
                "same_bits_twice": same,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "ms": _time_ms(run), "device_ms": _device_ms(run),
                "plain_ms": _time_ms(plain, warmup=1, reps=3, calls=2),
                "plain_device_ms": _device_ms(plain, calls=2),
                "library_ms": library_ms, "library_device_ms": library_device_ms,
            }
            print("[flash_bwd] " + json.dumps(row))
            rows.append(row)
            del got, want
        del q, k, v, do, out, lse, delta, args, library
        torch.cuda.empty_cache()
    return rows


def phase_deferred_init(cfg):
    """deferred_init Llama-7B on the card (no bytes), the in-place
    ``materialize_module`` timed as the comparison and freed, then the path:
    a second recording through ``materialize_module_torch(seed=MAT_SEED)``
    (bytes, peak and time), one parameter alone bit-equal to the module's,
    distinct streams, the init's statistics, and the values loaded into the
    module by assignment.  Returns the loaded model."""
    from torchdistx_tpu_torch.deferred_init import (
        deferred_init,
        is_deferred,
        materialize_module,
    )
    from torchdistx_tpu_torch.materialize import (
        materialize_module_torch,
        materialize_tensor_torch,
    )
    from torchdistx_tpu_torch.models.llama import Llama, num_params

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    n = num_params(cfg)
    want = n * 2

    # The comparison: the in-place replay on the global generator.
    model = deferred_init(Llama, cfg, device_="cuda")
    torch.manual_seed(0)
    t0 = time.perf_counter()
    materialize_module(model)
    torch.cuda.synchronize()
    inplace_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated() - before
    _check(abs(allocated - want) <= 0.01 * want,
           f"materialize_module: {allocated} bytes, expected about {want}")
    _check(all(p.is_cuda and not is_deferred(p) for p in model.parameters()),
           "materialize_module left a parameter off the card")
    del model
    _free()

    # The path: record, then the seeded materialize.
    t0 = time.perf_counter()
    model = deferred_init(Llama, cfg, device_="cuda")
    record_s = time.perf_counter() - t0
    recorded = torch.cuda.memory_allocated() - before
    params = list(model.parameters())
    _check(recorded == 0, f"deferred_init allocated {recorded} bytes")
    _check(all(is_deferred(p) for p in params), "a parameter is not deferred")
    _check(sum(p.numel() for p in params) == n, "parameter count")
    largest = max(p.numel() * p.element_size() for p in params)
    del params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    values = materialize_module_torch(model, seed=MAT_SEED)
    torch.cuda.synchronize()
    mat_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated() - before
    peak = torch.cuda.max_memory_allocated() - before
    _check(abs(allocated - want) <= 0.01 * want,
           f"materialized {allocated} bytes, expected about {want}")
    _check(peak <= allocated + largest, f"peak {peak} > {allocated} + largest {largest}")
    _check(all(v.is_cuda and v.dtype == cfg.dtype for v in values.values()), "values")
    _check(all(is_deferred(p) for p in model.parameters()), "the module was changed")

    # Order independence, distinct streams, statistics.
    last = f"layers.{cfg.n_layers - 1}.w_down.weight"
    alone = materialize_tensor_torch(model.layers[-1].w_down.weight, seed=MAT_SEED)
    _check(torch.equal(alone, values[last]), f"{last} alone differs from the module's")
    del alone
    _check(not torch.equal(values["layers.0.wq.weight"], values["layers.1.wq.weight"]),
           "layers 0 and 1 drew the same wq")
    resid = 0.02 / math.sqrt(2 * cfg.n_layers)
    stds = {"wq": values["layers.0.wq.weight"].float().std().item(),
            "wo": values["layers.0.wo.weight"].float().std().item()}
    _check(abs(stds["wq"] / 0.02 - 1) <= 0.02, f"wq std {stds['wq']}")
    _check(abs(stds["wo"] / resid - 1) <= 0.02, f"wo std {stds['wo']} vs {resid}")
    norms = [v for k, v in values.items() if k.endswith("norm.weight")]
    _check(len(norms) == 2 * cfg.n_layers + 1 and all(bool((v == 1).all()) for v in norms),
           "a norm weight is not exactly 1")
    del norms

    # Load by assignment: no copy, no second set.
    model.load_state_dict(values, assign=True)
    _check(all(p.data_ptr() == values[k].data_ptr() for k, p in model.named_parameters()),
           "load_state_dict copied")
    del values
    _check(torch.cuda.memory_allocated() - before == allocated, "loading allocated bytes")
    _check(all(p.is_cuda and not is_deferred(p) for p in model.parameters()),
           "a parameter was not loaded on the card")
    print(f"[deferred_init] llama_7b: {n} params, bytes after record {recorded}; in-place "
          f"materialize_module (the comparison) {inplace_s:.3f} s; "
          f"materialize_module_torch(seed={MAT_SEED}) {mat_s:.3f} s, bytes {allocated} "
          f"(2 x params = {want}), peak {peak} (<= + largest {largest}); {last} alone "
          f"bit-equal; std wq {stds['wq']:.6f} (0.02), wo {stds['wo']:.6f} ({resid:.6f}); "
          f"norms 1; loaded by assignment; record {record_s:.3f} s")
    return model, {"record_s": record_s, "materialize_s": inplace_s,
                   "seeded_materialize_s": mat_s, "bytes_recorded": recorded,
                   "bytes_materialized": allocated, "peak_bytes": peak,
                   "largest_param_bytes": largest, "std": stds}


def phase_forward(model, tokens, fa, label="forward"):
    cfg = model.cfg
    n0 = fa.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = model(tokens, attn_impl="auto")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launched = fa.launches - n0
    _check(logits.shape == (*tokens.shape, cfg.vocab_size), f"logits shape {logits.shape}")
    _check(logits.dtype == torch.float32, "logits dtype")
    _check(bool(torch.isfinite(logits).all()), "non-finite logits")
    _check(launched == cfg.n_layers, f"{launched} flash launches, expected {cfg.n_layers}")
    print(f"[{label}] logits {tuple(logits.shape)} f32 finite; flash launches "
          f"{launched}; first call {first_ms:.3f} ms")
    return logits, first_ms


def phase_generate(model, tokens, label="generate"):
    from torchdistx_tpu_torch.models.generate import generate

    b, s = tokens.shape
    outs, secs = [], []
    for _ in range(1 + GENERATE_STEADY_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, tokens, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    _check(outs[0].shape == (b, NEW_TOKENS), f"generate shape {outs[0].shape}")
    _check(bool(((outs[0] >= 0) & (outs[0] < model.cfg.vocab_size)).all()),
           "generated token out of range")
    _check(all(torch.equal(outs[0], o) for o in outs[1:]),
           "greedy generate is not deterministic")
    tps = [b * NEW_TOKENS / t for t in secs]
    steady_tps = statistics.median(tps[1:])
    with torch.inference_mode():
        weights = model.prep_decode()
        cache = model.init_cache(b, s + 2)
        model.forward_cached(tokens, cache, 0, weights)
        step = tokens[:, -1:]
        model.forward_cached(step, cache, s, weights)  # warm-up step
        def decode_step():
            return model.forward_cached(step, cache, s + 1, weights)

        decode = _profile(f"{label} decode step", decode_step)
        # One step at a time, so the events read the host's dispatch of it.
        decode["event_ms"] = _time_ms(decode_step, warmup=1, reps=11, calls=1)
        print(f"[{label} decode step] {decode['event_ms']:.3f} ms by events, "
              f"{decode['device_ms']:.3f} ms of it on the card")
        del weights, cache
    print(f"[{label}] {b} x {s} prompts, {NEW_TOKENS} new tokens, "
          f"deterministic over {len(outs)} runs; cold {secs[0]:.3f} s "
          f"({tps[0]:.2f} tokens/s); steady {[round(s, 3) for s in secs[1:]]} s, "
          f"{[round(t, 2) for t in tps[1:]]} tokens/s, median {steady_tps:.2f}; "
          f"first tokens {outs[0][:, :8].tolist()}")
    return {"generate_s": secs, "tokens_per_s": tps,
            "steady_tokens_per_s_median": steady_tps, "decode_step_profile": decode}


# Profiler kernel-name fragments of cuBLAS's matrix products.
_GEMM_NAMES = ("nvjet", "gemm", "cutlass", "xmma")
# Profiler kernel-name patterns of the port's bf16 kernels (the train
# path's): a kernel's device time sums the kernels whose names hold every
# fragment of its pattern.
_KERNEL_NAMES = {
    "flash_fwd": ("flash_fwd_bf16",),
    "flash_bwd_fused": ("flash_bwd_fused_wgmma<",),
    "flash_bwd_dq": ("flash_bwd_dq_wgmma<",),
    "flash_bwd_dkv": ("flash_bwd_dkv_wgmma<",),
}


def _profile(label, fn, split=None):
    """Wall time and device time by kernel of one call of ``fn``, from
    torch.profiler (the wall time includes the profiler's own cost); with
    ``split``, also ``split(prof)``'s device ms by part."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in _device_events(prof):
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    spans = {}
    for ev in _device_events(prof, annotations=True):
        spans[ev.name] = spans.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    out = {"wall_ms": wall_ms, "device_ms": sum(by_kernel.values()),
           "gemm_ms": sum(t for n, t in by_kernel.items()
                          if any(p in n for p in _GEMM_NAMES)),
           "annotation_spans_ms": spans, "top": [[n[:60], t] for n, t in top]}
    for kernel, parts in _KERNEL_NAMES.items():
        out[kernel + "_ms"] = sum(
            t for n, t in by_kernel.items() if all(p in n for p in parts)
        )
    if split is not None:
        out["split_ms"] = split(prof)
    print(f"[{label}] profile " + json.dumps(out))
    return out


def _compare(a, b):
    d = (a - b).abs()
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return d.max().item(), d.mean().item(), top1


def check_forward_against_f32(model, tokens, logits, label="forward", pair_slack=1.0):
    """Steady timings of the bf16 forward on both attentions, then the
    checks against the f32 reference (the model is cast to float32 in place
    here, after the main path's counts were read, and back to its dtype at
    the end: bf16 -> f32 -> bf16 gives the same values)."""
    dtype = model.cfg.dtype
    with torch.inference_mode():
        ms = _time_ms(lambda: model(tokens, attn_impl="auto"), warmup=1, reps=5, calls=3)
        plain_ms = _time_ms(lambda: model(tokens, attn_impl="plain"), warmup=1, reps=5,
                            calls=3)
        print(f"[{label}] steady bf16: flash {ms:.3f} ms, plain attention {plain_ms:.3f} ms")
        profile = _profile(label, lambda: model(tokens, attn_impl="auto"))
        plain = model(tokens, attn_impl="plain")
    model.float()
    with torch.inference_mode():
        ref = model(tokens, attn_impl="plain")
        flash32 = model(tokens, attn_impl="auto")
    model.to(dtype)
    stats = {"forward_ms": ms, "forward_plain_ms": plain_ms, "forward_profile": profile}
    for name, a, b in (("f32 flash vs f32 reference", flash32, ref),
                       ("bf16 flash vs f32 reference", logits, ref),
                       ("bf16 plain vs f32 reference", plain, ref),
                       ("bf16 flash vs bf16 plain", logits, plain)):
        mx, mean, top1 = _compare(a, b)
        stats[name] = {"max_abs": mx, "mean_abs": mean, "top1": top1}
        print(f"[{label}] {name}: max abs {mx:.6f}, mean abs {mean:.6f}, "
              f"top-1 agreement {top1:.6f}")
    f32 = stats["f32 flash vs f32 reference"]
    _check(f32["max_abs"] <= F32_LOGITS_ATOL,
           f"f32 logits err {f32['max_abs']} > {F32_LOGITS_ATOL}")
    _check(f32["top1"] >= TOP1_MIN, f"f32 top-1 agreement {f32['top1']} < {TOP1_MIN}")
    flash, plain_s = stats["bf16 flash vs f32 reference"], stats["bf16 plain vs f32 reference"]
    _check(flash["mean_abs"] <= BF16_MEAN_SLACK * plain_s["mean_abs"],
           f"bf16 flash mean err {flash['mean_abs']} vs plain {plain_s['mean_abs']}")
    _check(flash["top1"] >= plain_s["top1"] - BF16_TOP1_SLACK,
           f"bf16 flash top-1 {flash['top1']} vs plain {plain_s['top1']}")
    pair = stats["bf16 flash vs bf16 plain"]
    _check(pair["mean_abs"] <= pair_slack * plain_s["mean_abs"],
           f"bf16 flash vs bf16 plain mean err {pair['mean_abs']} > {pair_slack} x plain's "
           f"own error {plain_s['mean_abs']}")
    return stats


def _counts(fa):
    return {"flash_fwd": fa.launches, "flash_bwd_fused": fa.launches_bwd_fused,
            "flash_bwd_dq": fa.launches_bwd_dq, "flash_bwd_dkv": fa.launches_bwd_dkv}


def _reset_counts(fa) -> None:
    fa.launches = fa.launches_bwd_fused = fa.launches_bwd_dq = fa.launches_bwd_dkv = 0


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(cfg, fa, model, *, family=None, shapes=TRAIN_SHAPES, watched=None,
                label="train", split=None, lr=TRAIN_LR):
    """A train path on ``model`` (a seeded materialize's values): ``shapes``'
    steps of ``make_train_step(model=family)``'s ``step_fn`` with their
    launch counts, losses and times, each shape followed by one profiled
    step (``split`` as in ``_profile``); the parameters named in
    ``watched`` (default: three of Llama's) must change."""
    from torchdistx_tpu_torch.parallel.train_step import TrainState, make_train_step

    def tx(params):
        return torch.optim.AdamW(params, lr=lr, foreach=False)

    _, step_fn = make_train_step(cfg, tx, model=family)
    torch.cuda.reset_peak_memory_stats()
    _check(cfg.remat and model.cfg == cfg and all(
        p.is_cuda and p.dtype == cfg.dtype for p in model.parameters()),
        "the train path's model is not the bf16 remat model on the card")
    state = TrainState(model, tx(model.parameters()), 0)
    if watched is None:
        watched = ("layers.0.wq.weight", f"layers.{cfg.n_layers - 1}.w_down.weight",
                   "lm_head.weight")
    watched = {n: model.get_parameter(n) for n in watched}
    before = {n: p.detach().clone() for n, p in watched.items()}
    print(f"[{label}] {type(model).__name__} of {cfg.n_layers} layers on the seeded values "
          f"(seed {MAT_SEED}); AdamW(lr={lr}, foreach=False)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_layers = cfg.n_layers
    stats = {"optimizer": f"AdamW(lr={lr}, foreach=False)"}
    for (b, s), n_steps, route in shapes:
        seq = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        want = {"flash_fwd": 2 * n_layers, "flash_bwd_fused": 0,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        for kernel in BWD_KERNELS[route]:
            want[kernel] = n_layers
        losses, step_ms = [], []
        for i in range(n_steps):
            c0 = _counts(fa)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step_fn(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            launched = {k: v - c0[k] for k, v in _counts(fa).items()}
            loss = metrics["loss"].item()
            losses.append(loss)
            _check(math.isfinite(loss) and not metrics["nonfinite"],
                   f"{label} {b}x{s} step {i + 1}: loss {loss}")
            _check(launched == want,
                   f"{label} {b}x{s} step {i + 1}: launches {launched}, expected {want}")
        held = {}

        def profiled_step():
            held["out"] = step_fn(state, batch)

        c0 = _counts(fa)
        profile = _profile(f"{label} {b}x{s} step", profiled_step, split)
        state, metrics = held["out"]
        _check(math.isfinite(metrics["loss"].item()), f"{label} {b}x{s}: profiled step loss")
        _check({k: v - c0[k] for k, v in _counts(fa).items()} == want,
               f"{label} {b}x{s}: profiled step launches")
        steady_ms = statistics.median(step_ms[1:])
        bwd_ms = sum(profile[k + "_ms"] for k in BWD_KERNELS[route])
        row = {
            "B": b, "S": s, "route": route, "losses": losses, "step_ms": step_ms,
            "steady_step_ms": steady_ms, "tokens_per_s": b * s / (steady_ms / 1e3),
            "launches_per_step": want, "profile": profile,
            "bwd_kernels_device_share": bwd_ms / profile["device_ms"],
            "flash_fwd_device_share": profile["flash_fwd_ms"] / profile["device_ms"],
            # The profiled step's kernel time over an unprofiled step's time.
            "device_busy_share": profile["device_ms"] / steady_ms,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        }
        print(f"[{label}] {b}x{s}: losses {losses}; step ms {step_ms}; steady "
              f"{steady_ms:.3f} ms, {row['tokens_per_s']:.1f} tokens/s; launches per "
              f"step {want}; backward kernels {100 * row['bwd_kernels_device_share']:.2f} % "
              f"of device time; peak allocated {row['peak_allocated_bytes']} bytes")
        stats[f"{b}x{s}"] = row
        if route == "fused":
            _check(losses[-1] < losses[0],
                   f"{label}: loss did not fall on the repeated batch: {losses}")
    changed = {n: not torch.equal(before[n], p) for n, p in watched.items()}
    _check(all(changed.values()), f"{label}: parameters unchanged: {changed}")
    stats["parameters_changed"] = changed
    del state, model, watched, before, held
    _free()
    return stats


def _grads(model, tokens, targets, impl):
    """(loss, {name: f32 gradient}) of ``model.loss`` with ``impl``."""
    loss = model.loss(tokens, targets, attn_impl=impl)
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        grads[name] = p.grad.float()
        p.grad = None
    return loss.item(), grads


def _rel_err(got, ref):
    return {n: (torch.linalg.vector_norm(got[n] - ref[n])
                / torch.linalg.vector_norm(ref[n])).item() for n in ref}


def phase_train_gates(cfg):
    """Gradients through the kernels against gradients through the plain
    attention, on a GATE_LAYERS-layer model at cfg's width (weights from
    GATE_SEED), at each training shape, in f32 and bf16."""
    from torchdistx_tpu_torch.models.llama import Llama

    small = dataclasses.replace(cfg, n_layers=GATE_LAYERS)
    torch.manual_seed(GATE_SEED)
    m16 = Llama(small, device="cuda")
    m32 = copy.deepcopy(m16).float()
    gen = torch.Generator(device="cuda").manual_seed(4)
    stats = {}
    for (b, s), _, route in TRAIN_SHAPES:
        seq = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
        tokens, targets = seq[:, :-1], seq[:, 1:]
        loss_k, g_k = _grads(m32, tokens, targets, "flash")
        loss_p, g_ref = _grads(m32, tokens, targets, "plain")
        f32_rel = _rel_err(g_k, g_ref)
        del g_k
        loss_k16, g = _grads(m16, tokens, targets, "flash")
        bf16_kernel = _rel_err(g, g_ref)
        del g
        loss_p16, g = _grads(m16, tokens, targets, "plain")
        bf16_plain = _rel_err(g, g_ref)
        del g, g_ref
        _free()
        worst = max(f32_rel, key=f32_rel.get)
        ratio = {n: bf16_kernel[n] / bf16_plain[n] for n in bf16_plain}
        worst16 = max(ratio, key=ratio.get)
        row = {
            "route": route, "loss_f32_kernel": loss_k, "loss_f32_plain": loss_p,
            "loss_bf16_kernel": loss_k16, "loss_bf16_plain": loss_p16,
            "f32_max_rel_err": f32_rel[worst], "f32_worst_param": worst,
            "bf16_kernel_rel_err": bf16_kernel, "bf16_plain_rel_err": bf16_plain,
            "bf16_max_ratio": ratio[worst16], "bf16_worst_param": worst16,
        }
        print(f"[train gates] {b}x{s} ({route}): f32 loss kernel {loss_k:.6f} vs plain "
              f"{loss_p:.6f}; f32 grads max rel err {f32_rel[worst]:.3e} ({worst}); "
              f"bf16 grads vs f32 plain: kernel/plain rel err ratio max "
              f"{ratio[worst16]:.4f} ({worst16}: {bf16_kernel[worst16]:.4e} vs "
              f"{bf16_plain[worst16]:.4e})")
        _check(abs(loss_k - loss_p) <= LOSS_F32_ATOL,
               f"{b}x{s}: f32 loss {loss_k} vs plain {loss_p}")
        _check(f32_rel[worst] <= GRAD_F32_RTOL,
               f"{b}x{s}: f32 grad rel err {f32_rel[worst]} ({worst}) > {GRAD_F32_RTOL}")
        _check(ratio[worst16] <= GRAD_BF16_SLACK,
               f"{b}x{s}: bf16 kernel grad err {bf16_kernel[worst16]} > {GRAD_BF16_SLACK} x "
               f"plain {bf16_plain[worst16]} ({worst16})")
        stats[f"{b}x{s}"] = row
    del m16, m32
    _free()
    return stats


def _library_grads(q, k, v, do, causal):
    """SDPA's backward alone on (B, H, S, D) copies with the kv heads
    expanded (the graph is kept between calls): the library yardstick."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    hq, hkv = q.shape[2], k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
    vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous().requires_grad_()
    out_t = sdpa(qt, kt, vt, is_causal=causal)
    do_t = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t, retain_graph=True)


def _head_dim_row(fa, gen, b, s, hq, hkv, d, dtype, timed):
    """The forward and the three backward kernels at head dim ``d`` against
    their plain versions (causal); with ``timed``, each call's ms by events
    and on the device beside the plain version's, SDPA's and the bound."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    def rand(h):
        return torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=dtype)

    q, k, v, do = rand(hq), rand(hkv), rand(hkv), rand(hq)
    out, lse = fa.flash_attention_fwd_with_lse(q, k, v, causal=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    err = {"out": (out.float() - ref_out.float()).abs().max().item(),
           "lse": (lse - ref_lse).abs().max().item()}
    _check(out.shape == q.shape and bool(torch.isfinite(out).all()), f"D {d}: out")
    tol_out, tol_lse = TOL[dtype]
    _check(err["out"] <= tol_out and err["lse"] <= tol_lse, f"D {d} {dtype}: fwd {err}")
    delta = fa.attention_delta(do, ref_out)
    args = (q, k, v, do, ref_lse, delta)
    row = {"D": d, "kernel_D": fa._kernel_head_dim(d), "B": b, "S": s, "Hq": hq,
           "Hkv": hkv, "dtype": str(dtype).replace("torch.", ""), "causal": True,
           "max_err": err}
    timing = {}
    if timed:
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
        calls = {"": lambda: fa.flash_attention_fwd_with_lse(q, k, v, causal=True),
                 "plain_": lambda: fa.flash_attention_reference(q, k, v, causal=True),
                 "library_": lambda: sdpa(qt, kt, vt, is_causal=True)}
        fwd = dict(zip(("bound_ms", "bound_by"), _flash_bound(b, s, hq, hkv, d, dtype, True)))
        fwd["max_abs_err"] = err["out"]
        for prefix, fn in calls.items():
            fwd[prefix + "ms"] = _time_ms(fn, **({} if prefix != "plain_" else
                                                 dict(warmup=1, reps=3, calls=2)))
            fwd[prefix + "device_ms"] = _device_ms(fn, calls=10 if prefix != "plain_" else 2)
        timing["flash_fwd"] = fwd
        del qt, kt, vt
        library = _library_grads(q, k, v, do, True)
        library_ms, library_device_ms = _time_ms(library), _device_ms(library)
        del library
    for route in ("fused", "streamed"):
        for kernel, (want_dq, want_dkv) in BWD_KERNELS[route].items():
            def run():
                return getattr(fa, kernel)(*args, causal=True)

            def plain():
                return fa.flash_bwd_plain(*args, causal=True, dq=want_dq, dkv=want_dkv)

            got = run()
            got = got if isinstance(got, tuple) else (got,)
            want = [w for w in plain() if w is not None]
            scale = max(1.0, max(w.float().abs().max().item() for w in want))
            err[kernel] = max((g.float() - w.float()).abs().max().item()
                              for g, w in zip(got, want)) / scale
            _check(all(g.shape == w.shape for g, w in zip(got, want)), f"D {d}: {kernel} shapes")
            _check(err[kernel] <= BWD_TOL[dtype], f"D {d} {dtype}: {kernel} {err}")
            del got, want
            if timed:
                bound_ms, bound_by = _bwd_bound(kernel, b, s, hq, hkv, d, dtype, True)
                timing[kernel] = {
                    "max_abs_err": err[kernel], "bound_ms": bound_ms, "bound_by": bound_by,
                    "ms": _time_ms(run), "device_ms": _device_ms(run),
                    "plain_ms": _time_ms(plain, warmup=1, reps=3, calls=2),
                    "plain_device_ms": _device_ms(plain, calls=2),
                    "library_ms": library_ms, "library_device_ms": library_device_ms,
                }
    torch.cuda.synchronize()
    if timed:
        row["timing"] = timing
    print("[head dims] " + json.dumps(row))
    return row


def phase_head_dims(fa):
    """C1 and C2 on the card: the kernels at head dims that are padded to
    an instance (16, 32, 80, 192) and at the 256 instances, against their
    plain versions, the D > 128 rows timed beside SDPA; then llama_test
    (head_dim 16) forward and training against the CPU."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for d in PADDED_HEAD_DIMS + WIDE_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(_head_dim_row(fa, gen, *PADDED_SHAPE, d, dtype, timed=d > 128))
    _free()

    from torchdistx_tpu_torch.models.llama import llama_test

    card = _family_on_card(fa, None, llama_test(), seed=9, label="head dims")
    return {"rows": rows, "llama_test_logits_err": card["logits_err"],
            "llama_test_loss_errs": card["loss_errs"]}


def _family_on_card(fa, family, cfg, *, seed, label):
    """``cfg`` (a test configuration, f32) of ``family`` on the card against
    the CPU port from the same weights (``make_train_step(model=family)``'s
    seeded init): the forward's logits within HEAD_DIM_LOSS_ATOL with one
    flash launch a layer, then 3 SGD steps' losses within it; for MoE also
    the aux loss within it and every layer's routing exactly (the experts
    each token picks and which choices are dropped)."""
    from torchdistx_tpu_torch.models import moe
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    def sgd(params):
        return torch.optim.SGD(params, lr=HEAD_DIM_SGD_LR)

    cpu_init, cpu_step = make_train_step(cfg, sgd, model=family, device="cpu")
    gpu_init, gpu_step = make_train_step(cfg, sgd, model=family, device="cuda")
    cpu_state, gpu_state = cpu_init(TRAIN_SEED), gpu_init(TRAIN_SEED)
    gpu_state.model.load_state_dict(cpu_state.model.state_dict())
    name = type(gpu_state.model).__name__
    g = torch.Generator().manual_seed(seed)
    seq = torch.randint(0, cfg.vocab_size, (4, 65), generator=g)
    stats = {}
    if family is moe:
        # Each layer's FFN input, for its routing on both devices.
        seen = {"cpu": [], "cuda": []}
        hooks = [blk.mlp_norm.register_forward_hook(
                     lambda mod, args, out, key=key: seen[key].append(out))
                 for key, state in (("cpu", cpu_state), ("cuda", gpu_state))
                 for blk in state.model.layers]
    n0 = fa.launches
    with torch.no_grad():
        if family is moe:
            got, aux = gpu_state.model(seq.cuda(), return_aux=True)
            want, want_aux = cpu_state.model(seq, return_aux=True)
            stats["aux_err"] = abs(aux.item() - want_aux.item())
            _check(stats["aux_err"] <= HEAD_DIM_LOSS_ATOL, f"{name} aux err {stats}")
        else:
            got, want = gpu_state.model(seq.cuda()), cpu_state.model(seq)
    stats["logits_err"] = (got.cpu() - want).abs().max().item()
    _check(fa.launches - n0 == cfg.n_layers, f"{name} forward: flash launches")
    _check(stats["logits_err"] <= HEAD_DIM_LOSS_ATOL, f"{name} logits err {stats}")
    if family is moe:
        for h in hooks:
            h.remove()
        drops = []
        for i, (h_cpu, h_gpu) in enumerate(zip(seen["cpu"], seen["cuda"], strict=True)):
            r_cpu = moe.route(h_cpu, cpu_state.model.layers[i].router.weight, cfg)
            r_gpu = moe.route(h_gpu, gpu_state.model.layers[i].router.weight, cfg)
            _check(torch.equal(r_gpu.experts.cpu(), r_cpu.experts)
                   and torch.equal(r_gpu.keep.cpu(), r_cpu.keep),
                   f"{name} layer {i}: the card routes differently from the CPU")
            drops.append(int((~r_cpu.keep).sum()))
        stats["dropped_choices_by_layer"] = drops
        del seen
    loss_err = []
    for _ in range(3):
        seq = torch.randint(0, cfg.vocab_size, (4, 65), generator=g)
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        cpu_state, cpu_m = cpu_step(cpu_state, batch)
        gpu_state, gpu_m = gpu_step(gpu_state, batch)
        loss_err.append(abs(gpu_m["loss"].item() - cpu_m["loss"].item()))
    stats["loss_errs"] = loss_err
    _check(max(loss_err) <= HEAD_DIM_LOSS_ATOL, f"{name} loss errs {loss_err}")
    _check(gpu_state.step == 3, f"{name}: steps")
    print(f"[{label}] {name} (head_dim {cfg.head_dim}, f32) on the card vs the CPU port: "
          f"{json.dumps(stats)} (atol {HEAD_DIM_LOSS_ATOL}"
          f"{'; routing equal' if family is moe else ''})")
    return stats


def _wide_llama_cfg():
    """The D = 256 path's model: llama_test widened to 256-wide heads (dim
    1024, 4 query and 2 kv heads), 2 layers, f32, remat off."""
    from torchdistx_tpu_torch.models.llama import llama_test

    return dataclasses.replace(llama_test(), dim=1024, n_heads=4, n_kv_heads=2,
                               ffn_dim=2816, max_seq_len=4096)


def phase_wide_llama(fa):
    """The D = 256 path: ``_wide_llama_cfg`` in f32 on the card against the CPU port
    (forward, then 3 SGD steps at WIDE_F32_BATCH: the fused backward), then the same
    weights in bf16 for one SGD step at 1 x WIDE_STREAMED_S (the streamed
    pair), with exact launch counts."""
    from torchdistx_tpu_torch.parallel.train_step import TrainState, make_train_step

    cfg = _wide_llama_cfg()
    n = cfg.n_layers

    def sgd(params):
        return torch.optim.SGD(params, lr=HEAD_DIM_SGD_LR)

    cpu_init, cpu_step = make_train_step(cfg, sgd, device="cpu")
    gpu_init, gpu_step = make_train_step(cfg, sgd, device="cuda")
    cpu_state, gpu_state = cpu_init(TRAIN_SEED), gpu_init(TRAIN_SEED)
    gpu_state.model.load_state_dict(cpu_state.model.state_dict())
    g = torch.Generator().manual_seed(10)
    b, s = WIDE_F32_BATCH
    seq = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    c0 = _counts(fa)
    with torch.no_grad():
        logits_err = (gpu_state.model(seq.cuda()).cpu() - cpu_state.model(seq)).abs().max().item()
    _check(logits_err <= HEAD_DIM_LOSS_ATOL, f"D 256 llama logits err {logits_err}")
    loss_err = []
    for _ in range(3):
        seq = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        cpu_state, cpu_m = cpu_step(cpu_state, batch)
        gpu_state, gpu_m = gpu_step(gpu_state, batch)
        loss_err.append(abs(gpu_m["loss"].item() - cpu_m["loss"].item()))
    _check(max(loss_err) <= HEAD_DIM_LOSS_ATOL, f"D 256 llama loss errs {loss_err}")
    want = {"flash_fwd": 4 * n, "flash_bwd_fused": 3 * n, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    launched = {k: v - c0[k] for k, v in _counts(fa).items()}
    _check(launched == want, f"D 256 llama f32 launches {launched}, expected {want}")

    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model16 = gpu_state.model.to(torch.bfloat16)
    _, step16 = make_train_step(cfg16, sgd, device="cuda")
    seq = torch.randint(0, cfg.vocab_size, (1, WIDE_STREAMED_S + 1), generator=g).cuda()
    c0 = _counts(fa)
    _, m16 = step16(TrainState(model16, sgd(model16.parameters()), 0),
                    {"tokens": seq[:, :-1], "targets": seq[:, 1:]})
    loss16 = m16["loss"].item()
    launched16 = {k: v - c0[k] for k, v in _counts(fa).items()}
    want16 = {"flash_fwd": n, "flash_bwd_fused": 0, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    _check(math.isfinite(loss16) and not m16["nonfinite"], f"D 256 bf16 loss {loss16}")
    _check(launched16 == want16, f"D 256 bf16 launches {launched16}, expected {want16}")
    print(f"[head dims] D 256 llama ({cfg.n_layers} layers, dim {cfg.dim}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads) on the card vs the CPU port, f32: logits max err "
          f"{logits_err:.3e}; SGD loss errs {[f'{e:.3e}' for e in loss_err]} (atol "
          f"{HEAD_DIM_LOSS_ATOL}); launches {launched}; bf16 step at 1x{WIDE_STREAMED_S}: "
          f"loss {loss16:.4f}, launches {launched16}")
    del cpu_state, gpu_state, model16
    _free()
    return {"logits_err": logits_err, "loss_errs": loss_err, "bf16_loss": loss16,
            "launches_f32": launched, "launches_bf16": launched16}


def phase_materialize_gates(cfg):
    """The dtype override (the f32-recorded model never resident),
    reproducibility across recordings and a 1-rank NCCL mesh."""
    import os
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.materialize import materialize_module_torch
    from torchdistx_tpu_torch.models.llama import Llama, num_params
    from torchdistx_tpu_torch.parallel import MeshSpec, fsdp_plan, make_mesh

    # dtype override: recorded in f32, materialized in bf16.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    n = num_params(cfg32)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model32 = deferred_init(Llama, cfg32, device_="cuda")
    largest32 = max(p.numel() * p.element_size() for p in model32.parameters())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    values = materialize_module_torch(model32, seed=MAT_SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    override_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated() - before
    peak = torch.cuda.max_memory_allocated() - before
    _check(all(v.dtype == torch.bfloat16 for v in values.values()), "override dtype")
    _check(abs(allocated - 2 * n) <= 0.01 * 2 * n, f"override bytes {allocated}")
    _check(peak <= allocated + 2 * largest32,
           f"override peak {peak} > bf16 {allocated} + 2 x f32 largest {largest32}")
    del values, model32
    _free()

    # Two recordings of a MAT_SMALL_LAYERS-layer model: the same values.
    small = dataclasses.replace(cfg, n_layers=MAT_SMALL_LAYERS)
    first = materialize_module_torch(deferred_init(Llama, small, device_="cuda"), seed=MAT_SEED)
    model = deferred_init(Llama, small, device_="cuda")
    second = materialize_module_torch(model, seed=MAT_SEED)
    _check(list(first) == list(second) and all(torch.equal(first[k], second[k]) for k in first),
           "two recordings differ")
    del second

    # A 1-rank NCCL mesh: DTensor values, each local tensor the unsharded one.
    store_dir = tempfile.mkdtemp(prefix="tdx_store_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "s"), 1),
                            rank=0, world_size=1)
    try:
        placements = {}
        for mesh in (make_mesh(MeshSpec(fsdp=1)), make_mesh(axis_names=("fsdp",))):
            sharded = materialize_module_torch(model, mesh=mesh, plan=fsdp_plan(),
                                               seed=MAT_SEED)
            _check(all(isinstance(v, DTensor) for v in sharded.values()), "mesh values")
            _check(all(torch.equal(v.to_local(), first[k]) for k, v in sharded.items()),
                   "a mesh value differs from the unsharded one")
            placements[mesh.mesh_dim_names[0]] = sorted({str(v.placements)
                                                         for v in sharded.values()})
            del sharded
    finally:
        dist.destroy_process_group()
        import shutil

        shutil.rmtree(store_dir, ignore_errors=True)
    del first, model
    _free()
    print(f"[materialize] f32-recorded llama_7b -> bf16 in {override_s:.3f} s: bytes "
          f"{allocated}, peak {peak} (<= bf16 + 2 x {largest32}); {MAT_SMALL_LAYERS}-layer "
          f"recordings bit-equal; 1-rank NCCL mesh, fsdp_plan: DTensor values bit-equal, "
          f"placements {placements}")
    return {"override_s": override_s, "override_bytes": allocated, "override_peak": peak,
            "f32_largest_param_bytes": largest32, "mesh_placements": placements}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _fit_flops(cfg, b, s):
    """Model flops of one train step: 6 x matmul params x tokens (the
    embedding table is a gather, not a product) plus attention's two
    products, 4 D flops per causal pair forward, three times for training."""
    from torchdistx_tpu_torch.models.llama import num_params

    matmul_params = num_params(cfg) - cfg.vocab_size * cfg.dim
    attention = 3 * 4 * b * cfg.n_heads * cfg.head_dim * (s * (s + 1) // 2) * cfg.n_layers
    return 6 * matmul_params * b * s + attention


def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for pid, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"opt.{pid}.{k}"] = torch.as_tensor(v)
    return out


def phase_fit(cfg, fa):
    """The fit path: a straight run and an interrupted, resumed one, with
    checkpoints in a temporary directory removed at the end."""
    import os
    import shutil
    import tempfile

    from torchdistx_tpu_torch import telemetry
    from torchdistx_tpu_torch.parallel.fit import fit
    from torchdistx_tpu_torch.parallel.train_step import make_train_step
    from torchdistx_tpu_torch.resilience import faults
    from torchdistx_tpu_torch.utils.checkpoint import Checkpointer, latest_step

    small = dataclasses.replace(cfg, n_layers=FIT_LAYERS)
    init_fn, step_fn = make_train_step(
        small, lambda ps: torch.optim.AdamW(ps, lr=TRAIN_LR, foreach=False))
    b, s = FIT_SHAPE
    flops = _fit_flops(small, b, s)
    want = {"flash_fwd": 2 * FIT_LAYERS, "flash_bwd_fused": FIT_LAYERS,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

    def batches():
        gen = torch.Generator(device="cuda").manual_seed(FIT_DATA_SEED)
        while True:
            seq = torch.randint(0, small.vocab_size, (b, s + 1), generator=gen, device="cuda")
            yield {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    record = {}  # run -> {step: (loss, derived metrics, launches)}

    def watch(run):
        record[run] = {}
        last = [_counts(fa)]

        def on_metrics(step, metrics):
            now = _counts(fa)
            launched = {k: now[k] - last[0][k] for k in now}
            last[0] = now
            record[run][step] = (metrics["loss"].item(), {
                k: metrics[k] for k in ("steps_per_s", "tokens_per_s", "mfu") if k in metrics
            }, launched)
        return on_metrics

    def run_fit(run, directory, step=step_fn):
        return fit(init_fn, step, batches(), seed=TRAIN_SEED, n_steps=FIT_STEPS,
                   checkpoint_dir=directory, checkpoint_every=FIT_EVERY,
                   on_metrics=watch(run), flops_per_step=flops,
                   peak_flops=PEAK_OPS_PER_S[torch.bfloat16])

    def committed(directory):
        return sorted(int(n) for n in os.listdir(directory) if n.isdigit())

    root = tempfile.mkdtemp(prefix="tdx_fit_")
    stats = {"layers": FIT_LAYERS, "shape": [b, s], "flops_per_step": flops}
    try:
        # (a) the straight run.
        telemetry.reset()
        t0 = time.perf_counter()
        state, _ = run_fit("a", os.path.join(root, "a"))
        stats["straight_run_s"] = time.perf_counter() - t0
        _check(state.step == FIT_STEPS, f"straight run ended at {state.step}")
        periodic = set(range(FIT_EVERY, FIT_STEPS + 1, FIT_EVERY)) | {FIT_STEPS}
        keep = sorted(periodic)[-FIT_KEEP:]
        _check(committed(os.path.join(root, "a")) == keep,
               f"straight run committed {committed(os.path.join(root, 'a'))}, want {keep}")
        stats["mfu_gauge"] = telemetry.gauges().get("train.mfu")
        steady = [d for _, d, _ in list(record["a"].values())[1:]]
        for key in ("steps_per_s", "tokens_per_s", "mfu"):
            stats[key] = statistics.median(d[key] for d in steady)

        # Save and restore times of this state, in a directory of their own.
        timing = Checkpointer(os.path.join(root, "timing"), max_to_keep=None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timing.save(1, state, wait=True)
        stats["save_sync_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        timing.save(2, state, wait=False)
        stats["save_async_return_ms"] = (time.perf_counter() - t0) * 1e3
        timing.wait_until_finished()
        stats["save_async_total_ms"] = (time.perf_counter() - t0) * 1e3
        stats["checkpoint_bytes"] = os.path.getsize(os.path.join(root, "timing", "2", "state.pt"))
        t0 = time.perf_counter()
        timing.restore_latest(target=state)
        torch.cuda.synchronize()
        stats["restore_s"] = time.perf_counter() - t0
        del state, timing
        shutil.rmtree(os.path.join(root, "a"))
        shutil.rmtree(os.path.join(root, "timing"))
        _free()

        # (b) a real SIGTERM as step FIT_STOP is about to run, then resume.
        run_b = os.path.join(root, "b")
        telemetry.reset()
        faults.reset(f"step.exec:{FIT_STOP}:sigterm")
        stopped, _ = run_fit("b1", run_b)
        faults.reset("")
        steps_first = telemetry.counters()["train.steps"]
        _check(stopped.step == FIT_STOP and latest_step(run_b) == FIT_STOP,
               f"interrupted run: step {stopped.step}, committed {committed(run_b)}")
        _check(telemetry.counters()["train.preemptions"] == 1, "no preemption counted")
        saved = {k: v.clone() for k, v in _state_tensors(stopped).items()}
        del stopped
        _free()
        restored = {}

        def probe(state, batch):
            if not restored:
                got = _state_tensors(state)
                restored["step"] = state.step
                restored["equal"] = (got.keys() == saved.keys()
                                     and all(torch.equal(got[k], saved[k]) for k in saved))
            return step_fn(state, batch)

        state, _ = run_fit("b2", run_b, step=probe)
        steps_second = telemetry.counters()["train.steps"] - steps_first
        _check(state.step == FIT_STEPS, f"resumed run ended at {state.step}")
        _check((steps_first, steps_second) == (FIT_STOP, FIT_STEPS - FIT_STOP),
               f"train.steps {steps_first} + {steps_second}: a step ran twice or not at all")
        _check(restored.get("step") == FIT_STOP and restored.get("equal"),
               f"restored state at the resume: {restored}")
        keep_b = sorted(periodic | {FIT_STOP})[-FIT_KEEP:]
        _check(committed(run_b) == keep_b, f"resumed run committed {committed(run_b)}, "
               f"want {keep_b}")
        _check(list(record["b2"]) == list(range(FIT_STOP + 1, FIT_STEPS + 1)),
               f"resumed run's steps {list(record['b2'])}")
        gap = {st: abs(record["b2"][st][0] - record["a"][st][0]) for st in record["b2"]}
        _check(max(gap.values()) <= FIT_LOSS_ATOL, f"resumed losses vs straight: {gap}")
        for run, steps in record.items():
            for st, (loss, _, launched) in steps.items():
                _check(math.isfinite(loss), f"fit {run} step {st}: loss {loss}")
                _check(launched == want, f"fit {run} step {st}: launches {launched}, "
                       f"expected {want}")
        stats.update({
            # Wall ms from the last step's return to this one's (fit's own
            # steps_per_s): a save's host time lands in the next step.
            "step_ms": {run: {st: 1e3 / d["steps_per_s"] for st, (_, d, _) in steps.items()
                              if "steps_per_s" in d} for run, steps in record.items()},
            "losses_straight": {st: v[0] for st, v in record["a"].items()},
            "losses_resumed": {st: v[0] for st, v in {**record["b1"], **record["b2"]}.items()},
            "resumed_loss_gap": gap, "committed_resumed": committed(run_b),
            "launches_per_step": want, "train_steps": [steps_first, steps_second],
        })
        del state, saved
    finally:
        faults.reset(None)
        shutil.rmtree(root, ignore_errors=True)
        _free()
    smi = _smi()
    print(f"[fit] {FIT_LAYERS} layers at llama_7b width, {b}x{s}, {FIT_STEPS} steps, "
          f"checkpoint every {FIT_EVERY} ({smi}): straight run {stats['straight_run_s']:.3f} s; "
          f"steady {stats['steps_per_s']:.3f} steps/s, {stats['tokens_per_s']:.1f} tokens/s, "
          f"mfu {stats['mfu']:.4f} (gauge {stats['mfu_gauge']:.4f}; {flops:.4e} flops a step, "
          f"peak {PEAK_OPS_PER_S[torch.bfloat16]:.3e}); step ms "
          f"{ {st: round(ms, 1) for st, ms in stats['step_ms']['a'].items()} }; "
          f"checkpoint {stats['checkpoint_bytes']} "
          f"bytes: save sync {stats['save_sync_ms']:.1f} ms, async returns in "
          f"{stats['save_async_return_ms']:.1f} ms and commits in "
          f"{stats['save_async_total_ms']:.1f} ms, restore {stats['restore_s']:.3f} s; "
          f"SIGTERM before step {FIT_STOP}: saved {FIT_STOP}, resumed, steps "
          f"{stats['train_steps']}, committed {stats['committed_resumed']}, restored state "
          f"equal to the saved one; resumed loss gap max {max(gap.values()):.3e} "
          f"(atol {FIT_LOSS_ATOL}); launches a step {want}")
    print("[fit] " + json.dumps({**stats, "card": smi}))
    return stats


def _span_ms(prof, name):
    """Device time of the user annotations named ``name`` in ``prof``."""
    return sum(ev.time_range.elapsed_us() for ev in _device_events(prof, annotations=True)
               if ev.name == name) / 1e3


def phase_slowmo(cfg, fa):
    """The SlowMo path: ``initialize`` a 1-rank NCCL group, ``make_mesh``,
    ``make_slowmo_train_step`` on ``cfg`` (``init_fn`` records and
    materializes on the card), SLOWMO_STEPS steps of one repeated batch with
    exact launch counts, parameters equal to ``prev`` after every averaging
    step, momentum non-zero from the first averaging step, the loss falling;
    then one more cycle, its averaging step profiled."""
    import socket

    import torch.distributed as dist

    from torchdistx_tpu_torch.models.llama import num_params
    from torchdistx_tpu_torch.parallel import MeshSpec, initialize, make_mesh
    from torchdistx_tpu_torch.parallel.slowmo import SlowMomentumOptimizer
    from torchdistx_tpu_torch.parallel.train_step import make_slowmo_train_step

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    info = initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        mesh = make_mesh(MeshSpec())

        def opt(params):
            return SlowMomentumOptimizer(
                torch.optim.SGD(params, lr=SLOWMO_LR), base_lr=SLOWMO_LR,
                slowmo_freq=SLOWMO_FREQ, slowmo_factor=SLOWMO_FACTOR, slowmo_lr=SLOWMO_SLR)

        init_fn, step_fn = make_slowmo_train_step(cfg, mesh, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = init_fn(MAT_SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        sm = state.optimizer
        _check(sm.group.group_name == mesh.get_group("dp").group_name
               and dist.get_backend(sm.group) == "nccl",
               "the SlowMo optimizer does not average over the mesh's NCCL dp group")
        b, s = SLOWMO_SHAPE
        gen = torch.Generator(device="cuda").manual_seed(SLOWMO_DATA_SEED)
        seq = torch.randint(0, cfg.vocab_size, (1, b, s + 1), generator=gen, device="cuda")
        batch = {"tokens": seq[..., :-1], "targets": seq[..., 1:]}
        want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_fused": cfg.n_layers,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        losses, step_ms = [], []
        for i in range(1, SLOWMO_STEPS + 2):
            c0 = _counts(fa)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step_fn(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            launched = {k: v - c0[k] for k, v in _counts(fa).items()}
            losses.append(metrics["loss"].item())
            _check(math.isfinite(losses[-1]) and metrics["step"] == i,
                   f"slowmo step {i}: loss {losses[-1]}, step {metrics['step']}")
            _check(launched == want, f"slowmo step {i}: launches {launched}, expected {want}")
            view = sm.slowmo_state
            if i % SLOWMO_FREQ == 0:
                _check(all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                              view.prev)),
                       f"slowmo step {i}: a parameter differs from prev after averaging")
            if i >= SLOWMO_FREQ:
                # A norm weight (1.0) takes no SGD update that bf16 can hold
                # at these learning rates, so its momentum may stay 0; every
                # matrix's momentum must not.
                zero = [n for (n, p), m in zip(state.model.named_parameters(), view.momentum)
                        if not bool(m.any())]
                _check(not any(state.model.get_parameter(n).dim() > 1 for n in zero),
                       f"slowmo step {i}: a matrix's momentum is zero: {zero}")
        _check(losses[SLOWMO_STEPS - 1] < losses[0],
               f"slowmo: the loss did not fall on the repeated batch: {losses}")
        del view
        held = {}

        def averaging_step():
            held["out"] = step_fn(state, batch)

        c0 = _counts(fa)
        _check((sm.slowmo_step + 1) % SLOWMO_FREQ == 0, "the profiled step does not average")
        profile = _profile("slowmo averaging step", averaging_step)
        state, metrics = held.pop("out")
        _check({k: v - c0[k] for k, v in _counts(fa).items()} == want,
               "slowmo: profiled step launches")
        _check(all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                      sm.slowmo_state.prev)),
               "slowmo: a parameter differs from prev after the profiled averaging step")
        peak = torch.cuda.max_memory_allocated()
        n = num_params(cfg)
        esize = torch.tensor([], dtype=cfg.dtype).element_size()
        # Averaging reads the parameter, prev and momentum and writes all three.
        bound_ms = 6 * esize * n / PEAK_BYTES_PER_S * 1e3
        spans = profile["annotation_spans_ms"]
        slowmo_span = spans.get("Optimizer.step#SlowMomentumOptimizer.step", 0.0)
        sgd_span = spans.get("Optimizer.step#SGD.step", 0.0)
        plain = [step_ms[i - 1] for i in range(3, SLOWMO_STEPS + 1) if i % SLOWMO_FREQ]
        averaging = [step_ms[i - 1] for i in range(3, SLOWMO_STEPS + 1) if i % SLOWMO_FREQ == 0]
        plain_ms, averaging_ms = statistics.median(plain), statistics.median(averaging)
        stats = {
            "process": list(info.__dict__.values()), "init_s": init_s, "lr": SLOWMO_LR,
            "freq": SLOWMO_FREQ, "factor": SLOWMO_FACTOR, "slowmo_lr": SLOWMO_SLR,
            "shape": [b, s], "losses": losses, "step_ms": step_ms,
            "plain_step_ms_median": plain_ms, "averaging_step_ms_median": averaging_ms,
            "averaging_added_ms": averaging_ms - plain_ms,
            "tokens_per_s": SLOWMO_FREQ * b * s / ((plain_ms + averaging_ms) / 1e3),
            "profile": profile, "optimizer_span_device_ms": slowmo_span,
            "sgd_span_device_ms": sgd_span,
            "averaging_device_ms": slowmo_span - sgd_span,
            "averaging_bound_ms": bound_ms, "averaging_bound_bytes": 6 * esize * n,
            "launches_per_step": want, "peak_allocated_bytes": peak,
            "zero_momentum_buffers": zero,
        }
        _check(slowmo_span > sgd_span > 0, f"slowmo: optimizer spans {spans}")
        del state, sm, held, metrics
    finally:
        dist.destroy_process_group()
        _free()
    print(f"[slowmo] llama_7b ({cfg.n_layers} layers, bf16, remat), {b}x{s}, one replica on a "
          f"1-rank NCCL mesh, SGD(lr={SLOWMO_LR}) every {SLOWMO_FREQ} steps averaged "
          f"(factor {SLOWMO_FACTOR}, slowmo_lr {SLOWMO_SLR}): init {init_s:.3f} s; losses "
          f"{[round(x, 4) for x in losses]}; step ms {[round(x, 1) for x in step_ms]}; "
          f"plain {plain_ms:.3f}, averaging {averaging_ms:.3f} (+{averaging_ms - plain_ms:.3f}) "
          f"ms; {stats['tokens_per_s']:.1f} tokens/s; averaging on the device "
          f"{stats['averaging_device_ms']:.3f} ms (optimizer span {slowmo_span:.3f} - SGD "
          f"{sgd_span:.3f}) against its bound {bound_ms:.3f} ms (bytes); peak allocated {peak} "
          f"bytes; launches a step {want}")
    print("[slowmo] " + json.dumps(stats))
    return stats


def _spawn_ranks(flag, devices, outs, timeout):
    """The ranks of ``chip_smoke.py <flag> <device> <rank> <store> <out>``,
    one for each output of ``outs[device]``, for each device of
    ``devices``, all started together; every rank's saved dict, by
    device."""
    import os

    procs, names = [], []
    root = os.path.dirname(next(iter(outs.values()))[0])
    try:
        for device in devices:
            store = os.path.join(root, f"store_{flag.strip('-')}_{device}")
            for rank, out in enumerate(outs[device]):
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, flag, device, str(rank), store, out],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                names.append(f"{device} rank {rank}")
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        failed = [(n, p.returncode, log) for n, p, log in zip(names, procs, logs)
                  if p.returncode]
        _check(not failed, f"{flag} ranks exited " + "; ".join(
            f"{n}: {code}:\n{log[-2000:]}" for n, code, log in failed))
        return {device: [torch.load(out, weights_only=True) for out in outs[device]]
                for device in devices}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def slowmo_replica(device, rank, store, out) -> None:
    """One rank of ``phase_slowmo_replicas``: 2 gloo ranks, llama_test in
    f32 from the CPU port's seeded weights, SLOWMO_REPLICA_STEPS steps of
    ``make_slowmo_train_step``'s ``step_fn`` on rows that differ; saves the
    losses, every step's parameters and the launch counts to ``out``."""
    import torch.distributed as dist

    from torchdistx_tpu_torch.models.llama import llama_test
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa
    from torchdistx_tpu_torch.parallel.slowmo import SlowMomentumOptimizer
    from torchdistx_tpu_torch.parallel.train_step import make_slowmo_train_step, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    try:
        cfg = llama_test()

        def opt(params):
            return SlowMomentumOptimizer(torch.optim.SGD(params, lr=HEAD_DIM_SGD_LR),
                                         base_lr=HEAD_DIM_SGD_LR, slowmo_freq=SLOWMO_FREQ)

        init_fn, step_fn = make_slowmo_train_step(cfg, None, opt, device=device)
        state = init_fn(TRAIN_SEED)
        weights = make_train_step(cfg, opt, device="cpu")[0](TRAIN_SEED).model.state_dict()
        state.model.load_state_dict(weights)
        seq = torch.randint(0, cfg.vocab_size, (2, 4, 65),
                            generator=torch.Generator().manual_seed(12))
        batch = {"tokens": seq[..., :-1], "targets": seq[..., 1:]}
        _reset_counts(fa)
        losses, params = [], []
        for _ in range(SLOWMO_REPLICA_STEPS):
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"].item())
            params.append([p.detach().cpu().clone() for p in state.model.parameters()])
        torch.save({"losses": losses, "params": params, "launches": _counts(fa),
                    "device": str(next(state.model.parameters()).device)}, out)
    finally:
        dist.destroy_process_group()


def phase_slowmo_replicas():
    """Two SlowMo replicas on the one card (2 processes over gloo) against
    the same 2-rank run on the CPU, all four processes started together."""
    import os
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="tdx_slowmo_")
    runs = {device: [os.path.join(root, f"{device}{r}.pt") for r in range(2)]
            for device in ("cuda", "cpu")}
    t0 = time.perf_counter()
    try:
        got = _spawn_ranks("--slowmo-replica", tuple(runs), runs, SLOWMO_REPLICA_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    n_layers = 2  # llama_test
    want = {"flash_fwd": n_layers * SLOWMO_REPLICA_STEPS,
            "flash_bwd_fused": n_layers * SLOWMO_REPLICA_STEPS,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    loss_err, param_err = 0.0, 0.0
    for rank in range(2):
        card, cpu = got["cuda"][rank], got["cpu"][rank]
        _check(card["device"].startswith("cuda") and cpu["device"] == "cpu", "replica devices")
        _check(card["launches"] == want, f"card replica {rank}: launches {card['launches']}")
        _check(not any(cpu["launches"].values()), "a CPU replica launched a kernel")
        loss_err = max(loss_err, max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"])))
        for step_a, step_b in zip(card["params"], cpu["params"]):
            param_err = max(param_err, max((a - b).abs().max().item()
                                           for a, b in zip(step_a, step_b)))
    _check(loss_err <= SLOWMO_REPLICA_ATOL and param_err <= SLOWMO_REPLICA_ATOL,
           f"card replicas vs the CPU run: loss err {loss_err}, param err {param_err}")
    equal = {}
    for device in ("cuda", "cpu"):
        a, b = (r["params"] for r in got[device])
        equal[device] = [all(torch.equal(x, y) for x, y in zip(sa, sb)) for sa, sb in zip(a, b)]
        _check(equal[device] == [(i + 1) % SLOWMO_FREQ == 0
                                 for i in range(SLOWMO_REPLICA_STEPS)],
               f"{device} replicas bit-equal after steps {equal[device]}")
    stats = {"loss_max_abs_err": loss_err, "param_max_abs_err": param_err,
             "replicas_bit_equal_by_step": equal, "launches_per_card_rank": want,
             "losses_card": [r["losses"] for r in got["cuda"]], "wall_s": wall_s}
    print(f"[slowmo replicas] 2 gloo ranks on the card vs 2 on the CPU, llama_test f32, "
          f"{SLOWMO_REPLICA_STEPS} steps, averaging every {SLOWMO_FREQ}: loss max err "
          f"{loss_err:.3e}, parameter max err {param_err:.3e} (atol {SLOWMO_REPLICA_ATOL}); "
          f"replicas bit-equal by step {equal['cuda']}; launches per card rank {want}; "
          f"{wall_s:.1f} s")
    return stats


def _mesh_tx(params):
    return torch.optim.AdamW(params, lr=TRAIN_LR, foreach=False)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_ranks_batch(vocab, b, s):
    """The [mesh ranks] batch, from a CPU generator (the same in every
    process)."""
    seq = torch.randint(0, vocab, (b, s + 1),
                        generator=torch.Generator().manual_seed(MESH_RANKS_DATA_SEED))
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


def _placed_by_plan(model, mesh, optimizer):
    """Each parameter a DTensor placed as ``param_specs`` fitted to
    ``mesh``, each AdamW moment as its parameter, no gradient held."""
    from torch.distributed.tensor import DTensor

    from torchdistx_tpu_torch.models.llama import param_specs
    from torchdistx_tpu_torch.parallel.sharding import fit_shardings

    named = dict(model.named_parameters())
    want = fit_shardings(param_specs(model.cfg), {n: tuple(p.shape) for n, p in named.items()},
                         mesh)
    return (all(isinstance(p, DTensor) and list(p.placements) == want[n]
                for n, p in named.items())
            and all(list(optimizer.state[p][k].placements) == list(p.placements)
                    for p in named.values() if p in optimizer.state
                    for k in ("exp_avg", "exp_avg_sq"))
            and all(p.grad is None for p in named.values()))


def _fingerprint(named):
    """A tensor's fingerprint: its whole value's sums in f32 along each dim
    with fixed random signs (a matrix's signed row and column sums, a
    higher-rank tensor's those of its leading dims flattened; a vector is
    its own), on the CPU; by name for ``named``.  The signs keep sums
    that cancel by construction from hiding a fault: a softmax head's
    gradient sums to 0 over the vocabulary."""
    from torchdistx_tpu_torch.parallel.spmd import whole

    out = {}
    for name, t in named.items():
        w = whole(t).float()
        if w.dim() > 2:  # an expert stack (E, in, out): its rows are E x in
            w = w.reshape(-1, w.shape[-1])
        if w.dim() == 2:
            gen = torch.Generator().manual_seed(0)
            rows, cols = (torch.randint(0, 2, (n,), generator=gen).float().mul_(2).sub_(1)
                          .to(w.device) for n in w.shape)
            sums = [w @ cols, rows @ w]
        else:
            sums = [w]
        out[name] = [x.cpu() for x in sums]
    return out


def _fingerprint_change(after, before):
    return {n: [a - b for a, b in zip(after[n], before[n])] for n in after}


def _fingerprint_err(got, want):
    """The largest L2 distance between two fingerprints' sums over the
    L2 norm of ``want``'s (infinite where ``want``'s is 0 and ``got``'s
    is not)."""
    worst = 0.0
    for name, sums in want.items():
        for g, w in zip(got[name], sums):
            diff, scale = (g - w).norm().item(), w.norm().item()
            worst = max(worst, diff / scale if scale else (math.inf if diff else 0.0))
    return worst


def _fingerprinted_steps(state, step_fn, batch, steps):
    """``steps`` steps of ``step_fn``, with the fingerprints of the first
    step's gradients (read by a hook before the optimizer steps) and of the
    parameters' change; returns ``(state, losses, step_ms, grads,
    change)``."""
    named = {n: p for n, p in state.model.named_parameters() if not p.is_meta}
    before = _fingerprint(named)
    grads = {}

    def capture(optimizer, args, kwargs):
        if not grads:
            grads.update(_fingerprint({n: p.grad for n, p in named.items()}))

    hook = state.optimizer.register_step_pre_hook(capture)
    losses, step_ms = [], []
    try:
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step_fn(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(metrics["loss"].item())
    finally:
        hook.remove()
    change = _fingerprint_change(_fingerprint(named), before)
    return state, losses, step_ms, grads, change


class _KernelBlocks:
    """Within it, the (B, S, Hq, Hkv, D) of every ``flash_attention`` call
    (``blocks``)."""

    def __init__(self, fa):
        self.fa, self.bare, self.blocks = fa, fa.flash_attention, set()

    def __enter__(self):
        def spy(q, k, v, **kw):
            self.blocks.add((*q.shape[:3], k.shape[2], q.shape[3]))
            return self.bare(q, k, v, **kw)

        self.fa.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention = self.bare


def phase_mesh(cfg, fa, train_stats):
    """The mesh path: ``make_train_step(mesh=)`` on a 1-rank NCCL mesh at
    full depth (seeded shard-then-materialize, TRAIN_SHAPES' steps with
    their launches, the first loss of each shape against the single-device
    loss on the same weights, one profiled 4 x 512 step), then the
    MESH_RANKS_LAYERS-layer reference of [mesh ranks] (a).  The path's
    launches (``path_launches``) are the sum of the mesh steps' own, read
    around each step: the single-device reference forwards and the
    2-layer reference are not the path."""
    import torch.distributed as dist

    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.models.llama import Llama, num_params
    from torchdistx_tpu_torch.parallel import MeshSpec, initialize, make_mesh
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    info = initialize(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0)
    try:
        mesh = make_mesh(MeshSpec())
        init_fn, step_fn = make_train_step(cfg, _mesh_tx, mesh=mesh)
        t0 = time.perf_counter()
        state = init_fn(MAT_SEED)  # cold: the first DTensor work of the process
        torch.cuda.synchronize()
        init_cold_s = time.perf_counter() - t0
        del state
        _free()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = init_fn(MAT_SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_allocated = torch.cuda.memory_allocated() - before
        init_peak = torch.cuda.max_memory_allocated() - before
        n = num_params(cfg)
        params = dict(state.model.named_parameters())
        nbytes = sum(p.to_local().untyped_storage().nbytes() for p in params.values())
        _check(nbytes == 2 * n, f"[mesh]: the shards hold {nbytes} bytes, not {2 * n}")
        _check(_placed_by_plan(state.model, mesh, state.optimizer),
               "[mesh]: a parameter is not placed by the plan")
        with torch.no_grad():  # the single-device model on the same storage
            plain = deferred_init(Llama, cfg, device="cuda")
            plain.load_state_dict({k: p.to_local().detach() for k, p in params.items()},
                                  assign=True)
        gen = torch.Generator(device="cuda").manual_seed(2)
        stats = {"process": list(info.__dict__.values()), "init_s": init_s,
                 "init_cold_s": init_cold_s,
                 "init_bytes": nbytes, "init_allocated_bytes": init_allocated,
                 "init_peak_bytes": init_peak}
        torch.cuda.reset_peak_memory_stats()
        path = dict.fromkeys(_counts(fa), 0)
        for (b, s), n_steps, route in TRAIN_SHAPES:
            seq = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
            batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
            with torch.no_grad():
                single_loss = plain.loss(batch["tokens"], batch["targets"]).item()
            want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_fused": 0, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}
            for kernel in BWD_KERNELS[route]:
                want[kernel] = cfg.n_layers
            losses, step_ms = [], []
            for i in range(n_steps):
                c0 = _counts(fa)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, metrics = step_fn(state, batch)
                end.record()
                end.synchronize()
                step_ms.append(start.elapsed_time(end))
                launched = {k: v - c0[k] for k, v in _counts(fa).items()}
                path = {k: v + launched[k] for k, v in path.items()}
                losses.append(metrics["loss"].item())
                _check(math.isfinite(losses[-1]) and not metrics["nonfinite"],
                       f"[mesh] {b}x{s} step {i + 1}: loss {losses[-1]}")
                _check(launched == want,
                       f"[mesh] {b}x{s} step {i + 1}: launches {launched}, expected {want}")
            _check(abs(losses[0] - single_loss) <= MESH_LOSS_ATOL,
                   f"[mesh] {b}x{s}: first loss {losses[0]} vs single-device {single_loss}")
            if route == "fused":
                _check(losses[-1] < losses[0], f"[mesh]: the loss did not fall: {losses}")
            row = {"losses": losses, "single_device_first_loss": single_loss,
                   "step_ms": step_ms, "steady_step_ms": statistics.median(step_ms[1:]),
                   "launches_per_step": want}
            row["tokens_per_s"] = b * s / (row["steady_step_ms"] / 1e3)
            single = train_stats.get(f"{b}x{s}", {})
            row["single_device_steady_step_ms"] = single.get("steady_step_ms")
            row["single_device_tokens_per_s"] = single.get("tokens_per_s")
            if route == "fused":
                held = {}

                def profiled_step():
                    held["out"] = step_fn(state, batch)

                c0 = _counts(fa)
                row["profile"] = _profile(f"mesh {b}x{s} step", profiled_step)
                state, _ = held.pop("out")
                launched = {k: v - c0[k] for k, v in _counts(fa).items()}
                path = {k: v + launched[k] for k, v in path.items()}
                _check(launched == want, "[mesh]: profiled step launches")
                row["device_busy_share"] = row["profile"]["device_ms"] / row["steady_step_ms"]
            stats[f"{b}x{s}"] = row
            print(f"[mesh] {b}x{s}: losses {losses} (single-device first loss "
                  f"{single_loss}); step ms {[round(x, 1) for x in step_ms]}; steady "
                  f"{row['steady_step_ms']:.3f} ms, {row['tokens_per_s']:.1f} tokens/s "
                  f"(single-device {row['single_device_steady_step_ms']} ms, "
                  f"{row['single_device_tokens_per_s']} tokens/s); launches a step {want}")
        # A second step function with a custom loss_fn (the model's own loss
        # through the step's keywords) on the same TrainState.  At lr 0
        # AdamW leaves every weight as it is, so the default step and the
        # custom one take their losses on the same weights: the same bits.
        _, custom_step = make_train_step(cfg, _mesh_tx, mesh=mesh,
                                         loss_fn=lambda m, t, y, **kw: m.loss(t, y, **kw))
        b, s = TRAIN_SHAPES[0][0]
        seq = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device="cuda")
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        lrs = [group["lr"] for group in state.optimizer.param_groups]
        for group in state.optimizer.param_groups:
            group["lr"] = 0.0
        pair = {}
        for name, fn in (("default", step_fn), ("custom", custom_step)):
            c0 = _counts(fa)
            state, metrics = fn(state, batch)
            launched = {k: v - c0[k] for k, v in _counts(fa).items()}
            path = {k: v + launched[k] for k, v in path.items()}
            pair[name] = metrics["loss"]
            _check(launched == stats[f"{b}x{s}"]["launches_per_step"],
                   f"[mesh] {name}-loss step: launches {launched}")
        for group, lr in zip(state.optimizer.param_groups, lrs):
            group["lr"] = lr
        _check(torch.equal(pair["default"], pair["custom"]),
               f"[mesh] custom loss_fn {pair['custom'].item()!r} vs the default step's "
               f"{pair['default'].item()!r} on the same weights")
        stats["custom_loss_fn"] = {k: v.item() for k, v in pair.items()}
        print(f"[mesh] a custom loss_fn (the model's loss through the step's keywords) on the "
              f"same TrainState at lr 0: loss {pair['custom'].item()!r}, the default step's "
              f"{pair['default'].item()!r}: bit-equal")
        stats["path_launches"] = path
        stats["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        stats["placed_by_plan_after_steps"] = _placed_by_plan(state.model, mesh,
                                                              state.optimizer)
        _check(stats["placed_by_plan_after_steps"], "[mesh]: placements after the steps")
        del state, plain, params, init_fn, step_fn
        _free()

        # [mesh ranks] (a)'s reference: the same seeded weights and batch.
        small = dataclasses.replace(cfg, n_layers=MESH_RANKS_LAYERS)
        init_fn, step_fn = make_train_step(small, _mesh_tx, mesh=mesh)
        state = init_fn(MESH_RANKS_SEED)
        stats["ranks_reference_param_bytes"] = 2 * num_params(small)
        batch = {k: v.cuda() for k, v in _mesh_ranks_batch(small.vocab_size,
                                                          *MESH_RANKS_SHAPE).items()}
        state, ref, _, grads, change = _fingerprinted_steps(state, step_fn, batch,
                                                            MESH_RANKS_STEPS)
        stats["ranks_reference_losses"] = ref
        stats["ranks_reference_fingerprints"] = {"grads": grads, "change": change}
        del state, init_fn, step_fn
    finally:
        dist.destroy_process_group()
        _free()
    print(f"[mesh] llama_7b ({cfg.n_layers} layers, bf16, remat) on a 1-rank NCCL mesh "
          f"(MeshSpec()): make_train_step(mesh=) init {init_s:.3f} s (cold {init_cold_s:.3f} "
          f"s), {nbytes} bytes of "
          f"DTensor shards (peak {init_peak}); peak allocated "
          f"{stats['peak_allocated_bytes']} bytes; {MESH_RANKS_LAYERS}-layer reference losses "
          f"{ref}")
    print("[mesh] " + json.dumps({k: v for k, v in stats.items()
                                  if k != "ranks_reference_fingerprints"}))
    return stats


def _rank_weights(mesh, model, values):
    """Each DTensor parameter's local shard set from the whole ``values``."""
    from torchdistx_tpu_torch.materialize import _local_shard

    dev = next(model.parameters()).to_local().device
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.to_local().copy_(_local_shard(values[name].to(dev), mesh, p.placements))


def _ce_z_loss(model, tokens, targets, **kw):
    """A custom ``loss_fn``: mean cross-entropy plus Z_LOSS times the mean
    squared log-partition, torch ops on the model's logits (a ``DTensor`` on
    a mesh, the targets placed beside them with no collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    logits = model(tokens, **kw)
    if isinstance(logits, DTensor):
        targets = distribute_tensor(targets, logits.device_mesh, logits.placements,
                                    src_data_rank=None)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, targets[..., None])[..., 0]
    return nll.mean() + Z_LOSS * (lse * lse).mean()


def _rank_f32(device, spec, kw):
    """[mesh ranks] (b)/(c)/(d): llama_test in f32 from the CPU port's seeded
    weights, MESH_RANKS_F32_STEPS AdamW steps on the mesh (``spec``: a
    ``MeshSpec``, or ``make_mesh``'s ``axis_names`` / ``shape``)."""
    from torchdistx_tpu_torch.models.llama import llama_test
    from torchdistx_tpu_torch.parallel import make_mesh
    from torchdistx_tpu_torch.parallel.spmd import whole
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    def tx(params):
        # eps 1e-6: at 1e-8 an element whose gradient is near eps turns
        # summation-order noise into a share of a step (the CPU tests' note).
        return torch.optim.AdamW(params, lr=1e-3, eps=1e-6, foreach=False)

    cfg = llama_test()
    mesh = (make_mesh(**spec, device_type=device) if isinstance(spec, dict)
            else make_mesh(spec, device_type=device))
    init_fn, step_fn = make_train_step(cfg, tx, mesh=mesh, **kw)
    state = init_fn(TRAIN_SEED)
    _rank_weights(mesh, state.model,
                  make_train_step(cfg, tx, device="cpu")[0](TRAIN_SEED).model.state_dict())
    batch = _mesh_ranks_batch(cfg.vocab_size, *MESH_RANKS_F32_SHAPE)
    losses = []
    for _ in range(MESH_RANKS_F32_STEPS):
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())
    return {"losses": losses, "params": {n: whole(p).detach().cpu()
                                         for n, p in state.model.named_parameters()}}


def _rank_llama7b_width(fa, rank):
    """[mesh ranks] (a): llama_7b's widths at MESH_RANKS_LAYERS layers, bf16,
    MeshSpec(fsdp=2, tp=2): the steps' losses, times and launches, the
    blocks the kernel saw, the bytes this rank holds, and (rank 0) the
    fingerprints of the first step's gradients and the parameters'
    change."""
    from torchdistx_tpu_torch.models.llama import llama_7b
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    cfg = dataclasses.replace(llama_7b(), n_layers=MESH_RANKS_LAYERS)
    mesh = make_mesh(MeshSpec(fsdp=2, tp=2), device_type="cuda")
    init_fn, step_fn = make_train_step(cfg, _mesh_tx, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    state = init_fn(MESH_RANKS_SEED)
    placed = _placed_by_plan(state.model, mesh, state.optimizer)
    held = sum(p.to_local().untyped_storage().nbytes() for p in state.model.parameters())
    batch = {k: v.cuda() for k, v in _mesh_ranks_batch(cfg.vocab_size,
                                                      *MESH_RANKS_SHAPE).items()}
    _reset_counts(fa)
    with _KernelBlocks(fa) as spy:
        state, losses, step_ms, grads, change = _fingerprinted_steps(state, step_fn, batch,
                                                                     MESH_RANKS_STEPS)
    return {"losses": losses, "step_ms": step_ms, "launches": _counts(fa),
            "kernel_blocks": sorted(spy.blocks), "held_param_bytes": held,
            "placed_by_plan": placed and _placed_by_plan(state.model, mesh, state.optimizer),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "fingerprints": {"grads": grads, "change": change} if rank == 0 else None}


def mesh_rank(device, rank, store, out) -> None:
    """One rank of ``phase_mesh_ranks`` (4 gloo ranks on ``device``): (a) on
    the card only, then (b) and (c); saves what the parent checks."""
    import torch.distributed as dist

    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa
    from torchdistx_tpu_torch.parallel import MeshSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
    got = {"device": device}
    try:
        if device == "cuda":
            got["a"] = _rank_llama7b_width(fa, rank)
        _reset_counts(fa)
        with _KernelBlocks(fa) as spy:
            got["b"] = _rank_f32(device, MeshSpec(fsdp=2, tp=2), {})
        got["b_launches"] = _counts(fa)
        got["b_kernel_blocks"] = sorted(spy.blocks)
        got["c_ring"] = _rank_f32(device, MeshSpec(fsdp=2, sp=2),
                                  {"seq_axis": "sp", "attn_impl": "ring"})
        got["c_zigzag"] = _rank_f32(device, MeshSpec(fsdp=2, sp=2),
                                    {"seq_axis": "sp", "seq_layout": "zigzag"})
        _reset_counts(fa)
        with _KernelBlocks(fa) as spy:
            got["d"] = _rank_f32(device, {"axis_names": ("data", "model"), "shape": (2, 2)},
                                 {"fsdp": "data", "tp": "model", "loss_fn": _ce_z_loss})
        got["d_launches"] = _counts(fa)
        got["d_kernel_blocks"] = sorted(spy.blocks)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(got, out)


def phase_mesh_ranks(mesh_stats):
    """4 gloo ranks on the card and 4 on the CPU, all started together; (a)
    against [mesh]'s reference, (b) and (c) against the CPU ranks."""
    import os
    import shutil
    import tempfile

    from torchdistx_tpu_torch.models.llama import llama_7b, num_params

    root = tempfile.mkdtemp(prefix="tdx_mesh_")
    runs = {device: [os.path.join(root, f"{device}{r}.pt") for r in range(4)]
            for device in ("cuda", "cpu")}
    t0 = time.perf_counter()
    try:
        got = _spawn_ranks("--mesh-rank", tuple(runs), runs, MESH_RANKS_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0

    # (a): every rank's losses the global ones, within the bf16 bound of
    # the 1-rank reference, and so the fingerprints of the first step's
    # gradients and of the parameters' change; the kernel on 16 of 32 heads
    # and 2 of 4 rows.
    cfg = dataclasses.replace(llama_7b(), n_layers=MESH_RANKS_LAYERS)
    a = [r["a"] for r in got["cuda"]]
    ref = mesh_stats["ranks_reference_losses"]
    a_err = max(abs(x - y) for r in a for x, y in zip(r["losses"], ref))
    _check(all(r["losses"] == a[0]["losses"] for r in a), "(a): the ranks' losses differ")
    _check(a_err <= MESH_RANKS_BF16_ATOL, f"(a): losses {a[0]['losses']} vs 1-rank {ref}")
    ref_prints = mesh_stats.pop("ranks_reference_fingerprints")
    grad_err = _fingerprint_err(a[0]["fingerprints"]["grads"], ref_prints["grads"])
    change_err = _fingerprint_err(a[0]["fingerprints"]["change"], ref_prints["change"])
    print(f"[mesh ranks] (a) vs the 1-rank run: losses {a[0]['losses']} vs {ref}; the "
          f"fingerprints' relative error: first-step gradients {grad_err}, the parameters' "
          f"change {change_err}")
    _check(grad_err <= MESH_RANKS_GRAD_RTOL,
           f"(a): first-step gradients {grad_err} from the 1-rank run's")
    _check(change_err <= MESH_RANKS_UPDATE_RTOL,
           f"(a): the parameters' change {change_err} from the 1-rank run's")
    local = (MESH_RANKS_SHAPE[0] // 2, MESH_RANKS_SHAPE[1], cfg.n_heads // 2,
             cfg.n_kv_heads // 2, cfg.head_dim)
    _check(local == MESH_RANK_BLOCKS["a"][0], f"(a): block {local} is not phase 2's row")
    want_a = {"flash_fwd": 2 * cfg.n_layers * MESH_RANKS_STEPS,
              "flash_bwd_fused": cfg.n_layers * MESH_RANKS_STEPS,
              "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for rank, r in enumerate(a):
        _check(r["kernel_blocks"] == [local],
               f"(a) rank {rank}: the kernel saw (B, S, Hq, Hkv, D) {r['kernel_blocks']}")
        _check(r["launches"] == want_a, f"(a) rank {rank}: launches {r['launches']}")
        _check(r["placed_by_plan"], f"(a) rank {rank}: placements")
    total = 2 * num_params(cfg)
    norm_bytes = 2 * cfg.dim * (2 * cfg.n_layers + 1)
    for rank, r in enumerate(a):
        _check(r["held_param_bytes"] == (total - norm_bytes) // 4 + norm_bytes,
               f"(a) rank {rank}: holds {r['held_param_bytes']} of {total} bytes")
    # (b), (c): the card's ranks against the CPU's.
    errs = {}
    for key in ("b", "c_ring", "c_zigzag", "d"):
        card, cpu = got["cuda"][0][key], got["cpu"][0][key]
        loss_err = max(abs(x - y) for x, y in zip(card["losses"], cpu["losses"]))
        param_err = max((card["params"][n] - cpu["params"][n]).abs().max().item()
                        for n in cpu["params"])
        errs[key] = {"loss": loss_err, "param": param_err, "losses": card["losses"]}
        _check(loss_err <= MESH_RANKS_F32_ATOL and param_err <= MESH_RANKS_F32_ATOL,
               f"({key}) card vs CPU ranks: loss err {loss_err}, param err {param_err}")
    b_launches = got["cuda"][0]["b_launches"]
    _check(b_launches["flash_fwd"] > 0 and b_launches["flash_bwd_fused"] > 0,
           f"(b): the card's ranks did not launch the kernels: {b_launches}")
    _check(all(r["b_kernel_blocks"] == [MESH_RANK_BLOCKS["b"][0]] for r in got["cuda"]),
           f"(b): the kernel saw (B, S, Hq, Hkv, D) {got['cuda'][0]['b_kernel_blocks']}")
    _check(not any(got["cpu"][0]["b_launches"].values()), "a CPU rank launched a kernel")
    # (d): the mesh named ("data", "model") with a custom loss; its kernel
    # block is (b)'s (the batch over "data", the heads over "model").
    d_launches = got["cuda"][0]["d_launches"]
    _check(d_launches["flash_fwd"] > 0 and d_launches["flash_bwd_fused"] > 0,
           f"(d): the card's ranks did not launch the kernels: {d_launches}")
    _check(all(r["d_kernel_blocks"] == [MESH_RANK_BLOCKS["b"][0]] for r in got["cuda"]),
           f"(d): the kernel saw (B, S, Hq, Hkv, D) {got['cuda'][0]['d_kernel_blocks']}")
    _check(not any(got["cpu"][0]["d_launches"].values()), "a CPU rank launched a kernel")
    # Each run's launches over the 4 card ranks, for the kernels line.
    launches = {key: {k: sum(r[field][k] for r in rs) for k in want_a}
                for key, field, rs in (("a", "launches", a), ("b", "b_launches", got["cuda"]),
                                       ("d", "d_launches", got["cuda"]))}
    stats = {"a_losses": a[0]["losses"], "a_reference_losses": ref, "a_loss_max_abs_err": a_err,
             "a_grad_fingerprint_rel_err": grad_err,
             "a_change_fingerprint_rel_err": change_err,
             "a_step_ms_by_rank": [r["step_ms"] for r in a],
             "a_launches_per_rank": want_a, "a_kernel_block": local,
             "launches_all_ranks": launches,
             "a_held_param_bytes_per_rank": a[0]["held_param_bytes"],
             "a_total_param_bytes": total,
             "a_peak_allocated_bytes_by_rank": [r["peak_allocated_bytes"] for r in a],
             "f32": errs, "b_launches_card_rank0": b_launches, "wall_s": wall_s}
    print(f"[mesh ranks] 4 gloo ranks on the card: (a) llama_7b widths x {cfg.n_layers} "
          f"layers, bf16, fsdp=2 x tp=2, {MESH_RANKS_SHAPE[0]}x{MESH_RANKS_SHAPE[1]}: losses "
          f"{a[0]['losses']} vs 1-rank {ref} (max err {a_err:.3e}, atol "
          f"{MESH_RANKS_BF16_ATOL}); fingerprints' relative error: first-step gradients "
          f"{grad_err:.3e} (rtol {MESH_RANKS_GRAD_RTOL}), the parameters' change "
          f"{change_err:.3e} (rtol {MESH_RANKS_UPDATE_RTOL}); step ms by rank "
          f"{[[round(x, 1) for x in r['step_ms']] for r in a]}; the kernel on (B, S, Hq, "
          f"Hkv, D) {local}; launches per rank {want_a}; bytes held per rank "
          f"{a[0]['held_param_bytes']} of {total} (total / 4 = {total // 4}, norms "
          f"replicated); (b) llama_test f32 fsdp x tp, (c) fsdp x sp ring / zigzag and (d) "
          f"a mesh named (data, model) with fsdp=data, tp=model and a custom loss_fn "
          f"(cross-entropy + {Z_LOSS} z-loss on the DTensor logits) vs 4 CPU ranks: "
          f"{json.dumps(errs)} (atol {MESH_RANKS_F32_ATOL}); {wall_s:.1f} s")
    return stats


def _record_and_materialize(cls, cfg, n, label):
    """``deferred_init`` of ``cls(cfg)`` on the card (no bytes, ``n``
    parameters), ``materialize_module_torch(seed=MAT_SEED)`` (the values
    hold exactly ``n`` elements' bytes; the allocator's count of them at
    most 1 MiB a tensor more, the most it rounds a block up by; peak at
    most that plus the largest parameter), loaded by assignment.  Returns
    the model and the numbers."""
    from torchdistx_tpu_torch.deferred_init import deferred_init, is_deferred
    from torchdistx_tpu_torch.materialize import materialize_module_torch

    _free()  # no tensor of an earlier phase may be collected mid-record
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = deferred_init(cls, cfg, device_="cuda")
    record_s = time.perf_counter() - t0
    recorded = torch.cuda.memory_allocated() - before
    params = list(model.parameters())
    _check(recorded == 0, f"{label}: deferred_init allocated {recorded} bytes")
    _check(all(is_deferred(p) for p in params), f"{label}: a parameter is not deferred")
    _check(sum(p.numel() for p in params) == n, f"{label}: parameter count")
    largest = max(p.numel() * p.element_size() for p in params)
    want = n * params[0].element_size()
    del params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    values = materialize_module_torch(model, seed=MAT_SEED)
    torch.cuda.synchronize()
    mat_s = time.perf_counter() - t0
    allocated = torch.cuda.memory_allocated() - before
    peak = torch.cuda.max_memory_allocated() - before
    nbytes = sum(v.untyped_storage().nbytes() for v in values.values())
    _check(nbytes == want, f"{label}: the values hold {nbytes} bytes, not {want}")
    _check(nbytes <= allocated <= nbytes + len(values) * 2**20,
           f"{label}: the allocator counts {allocated} bytes for {nbytes} in {len(values)}")
    _check(peak <= allocated + largest, f"{label}: peak {peak} > {allocated} + {largest}")
    model.load_state_dict(values, assign=True)
    _check(all(p.data_ptr() == values[k].data_ptr() for k, p in model.named_parameters()),
           f"{label}: load_state_dict copied")
    del values
    _check(all(p.is_cuda and not is_deferred(p) for p in model.parameters()),
           f"{label}: a parameter was not loaded on the card")
    stats = {"params": n, "record_s": record_s, "bytes_recorded": recorded,
             "seeded_materialize_s": mat_s, "bytes_materialized": nbytes,
             "bytes_allocated": allocated, "peak_bytes": peak, "largest_param_bytes": largest}
    print(f"[{label}] deferred_init: {n} params, bytes after record {recorded}, record "
          f"{record_s:.3f} s; materialize_module_torch(seed={MAT_SEED}) {mat_s:.3f} s, bytes "
          f"{nbytes} (2 x params), {allocated} by the allocator, peak {peak} (<= + largest "
          f"{largest}); loaded by assignment")
    return model, stats


def _std_gates(model, label, stds):
    """Each named parameter's std within 2 % of the init's; returns them."""
    got = {n: model.get_parameter(n).float().std().item() for n in stds}
    for n, want in stds.items():
        _check(abs(got[n] / want - 1) <= 0.02, f"{label}: {n} std {got[n]} vs {want}")
    return got


def phase_gpt2(fa):
    """[gpt2]'s forward part: gpt2_xl recorded and materialized, its head the
    embedding itself, its init's statistics, the forward at GPT2_SHAPE and
    greedy generate.  Returns the model, the tokens, the logits and the
    numbers."""
    from torchdistx_tpu_torch.models.gpt2 import GPT2, gpt2_xl, num_params

    cfg = gpt2_xl()
    model, stats = _record_and_materialize(GPT2, cfg, num_params(cfg), "gpt2")
    _check(model.head_weight.data_ptr() == model.wte.weight.data_ptr()
           and not any("head" in n for n, _ in model.named_parameters()),
           "gpt2: the head is not the embedding's own tensor")
    resid = 0.02 / math.sqrt(2 * cfg.n_layers)
    last = cfg.n_layers - 1
    stats["std"] = _std_gates(model, "gpt2", {
        "wte.weight": 0.02, "wpe.weight": 0.02, "layers.0.attn_qkv.weight": 0.02,
        f"layers.{last}.mlp_fc.weight": 0.02, "layers.0.attn_proj.weight": resid,
        f"layers.{last}.mlp_proj.weight": resid})
    blk = model.layers[0]
    _check(all(bool((t == 0).all()) for t in (blk.attn_qkv.bias, blk.mlp_proj.bias,
                                                model.ln_f.bias))
           and all(bool((t == 1).all()) for t in (blk.ln_1.weight, model.ln_f.weight)),
           "gpt2: a bias is not 0 or a layer-norm scale not 1")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, GPT2_SHAPE, generator=gen, device="cuda")
    logits, stats["forward_first_ms"] = phase_forward(model, tokens, fa, label="gpt2 forward")
    stats["generate"] = phase_generate(model, tokens[:BATCH, :SEQ], label="gpt2 generate")
    return model, tokens, logits, stats


# A MoE step's device time by part.  Attention: the flash kernels, by name.
# Inside moe_ffn's profiler ranges (the forward and remat's recompute):
# aten::bmm under moe.experts is the expert GEMMs, any kernel under
# moe.route, moe.dispatch or moe.combine is routing.  In the backward: the
# bmm's of BmmBackward nodes are the expert GEMMs, the kernels of the
# routing's own nodes (_MOE_ROUTING_NODES) routing.  The rest: other GEMMs by
# name, and everything else (norms, RoPE, elementwise, the loss, AdamW).
_MOE_ROUTING_SCOPES = ("moe.route", "moe.dispatch", "moe.combine")
_MOE_ROUTING_NODES = ("IndexCopyBackward", "IndexBackward", "SortBackward", "SoftmaxBackward")
_BACKWARD_NODE = "autograd::engine::evaluate_function: "


def _moe_split(prof):
    split = dict.fromkeys(("routing", "expert_gemms", "attention", "other_gemms", "other"),
                          0.0)
    for ev in prof.events():
        if not ev.kernels:
            continue
        chain, parent = [], ev
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        scope = next((c for c in chain if c.startswith("moe.")), None)
        node = next((c[len(_BACKWARD_NODE):] for c in chain if c.startswith(_BACKWARD_NODE)),
                    "")
        for kernel in ev.kernels:
            if any(all(p in kernel.name for p in parts) for parts in _KERNEL_NAMES.values()):
                part = "attention"
            elif scope is not None:
                part = ("routing" if scope in _MOE_ROUTING_SCOPES else
                        "expert_gemms" if ev.name == "aten::bmm" else "other")
            elif ev.name == "aten::bmm" and node.startswith("BmmBackward"):
                part = "expert_gemms"
            elif node.startswith(_MOE_ROUTING_NODES):
                part = "routing"
            elif any(g in kernel.name for g in _GEMM_NAMES):
                part = "other_gemms"
            else:
                part = "other"
            split[part] += kernel.duration / 1e3
    return split


def phase_moe(fa):
    """The [moe] path: MoEConfig() cut to MOE_LAYERS layers, recorded and
    materialized, the forward at MOE_SHAPE with its aux loss, then
    MOE_TRAIN_SHAPES' train steps with the routing split of each profiled
    step.  Returns the model and the numbers."""
    from torchdistx_tpu_torch.models import moe

    cfg = dataclasses.replace(moe.MoEConfig(), n_layers=MOE_LAYERS)
    model, stats = _record_and_materialize(moe.MoE, cfg, moe.num_params(cfg), "moe")
    resid = 0.02 / math.sqrt(2 * cfg.n_layers)
    stats["std"] = _std_gates(model, "moe", {
        "layers.0.e_gate": 0.02, "layers.0.e_up": 0.02, "layers.0.wq.weight": 0.02,
        f"layers.{cfg.n_layers - 1}.e_down": resid, "layers.0.wo.weight": resid})
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, MOE_SHAPE, generator=gen, device="cuda")
    n0 = fa.launches
    with torch.inference_mode():
        logits, aux = model(tokens, return_aux=True)
    launched = fa.launches - n0
    _check(logits.shape == (*MOE_SHAPE, cfg.vocab_size) and logits.dtype == torch.float32
           and bool(torch.isfinite(logits).all()), "moe: logits")
    _check(math.isfinite(aux.item()), f"moe: aux {aux.item()}")
    _check(launched == cfg.n_layers, f"moe forward: {launched} flash launches")
    stats["forward_aux"] = aux.item()
    capacity = {f"{b}x{s}": moe._capacity(cfg, b * s) for (b, s), _, _ in MOE_TRAIN_SHAPES}
    print(f"[moe] forward {MOE_SHAPE[0]}x{MOE_SHAPE[1]}: logits {tuple(logits.shape)} f32 "
          f"finite, aux {aux.item():.6f}, flash launches {launched}; capacity {capacity}")
    del logits, aux
    stats["train"] = phase_train(
        cfg, fa, model, family=moe, shapes=MOE_TRAIN_SHAPES, split=_moe_split,
        watched=("layers.0.e_gate", f"layers.{cfg.n_layers - 1}.router.weight",
                 "lm_head.weight"), label="moe train")
    stats["capacity"] = capacity
    return model, tokens, stats


def _moe_after(model, tokens, stats):
    """[moe]'s numbers read after the path: the forward's steady time and
    each profiled step's split between routing, expert GEMMs and attention."""
    with torch.inference_mode():
        stats["forward_ms"] = _time_ms(lambda: model(tokens), warmup=1, reps=5, calls=3)
    for (b, s), _, _ in MOE_TRAIN_SHAPES:
        row = stats["train"][f"{b}x{s}"]
        split = row["profile"]["split_ms"]
        total = row["profile"]["device_ms"]
        row["split_share"] = {k: v / total for k, v in split.items()}
        print(f"[moe split] {b}x{s} step, {total:.3f} ms on the card: " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / total:.2f} %)" for k, v in split.items())
            + f"; peak allocated {row['peak_allocated_bytes']} bytes")
    print(f"[moe] forward steady {stats['forward_ms']:.3f} ms")


def _pipe_cfg(family, layers):
    """The family's full-width configuration (llama_7b, gpt2_xl,
    MoEConfig()) cut to ``layers`` layers, and its module."""
    from torchdistx_tpu_torch.models import gpt2, llama, moe

    mod, make = {"llama": (llama, llama.llama_7b), "gpt2": (gpt2, gpt2.gpt2_xl),
                 "moe": (moe, moe.MoEConfig)}[family]
    return mod, dataclasses.replace(make(), n_layers=layers)


def _pipe_batch(vocab, b, s, seed):
    """A pipeline run's batch, from a CPU generator (the same in every
    process)."""
    seq = torch.randint(0, vocab, (b, s + 1), generator=torch.Generator().manual_seed(seed))
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


def _pipe_launches(schedule, n_stages, stage, layers, m_count, steps):
    """The flash launches of one rank's ``steps`` pipeline steps at 512
    tokens (the fused backward): each stage computation launches the
    forward kernel once a layer of the stage, each transpose the fused
    backward once a layer.  A step runs M forwards and M recomputes with
    their transposes, but 1F1B's last stage, whose forward slot runs
    nothing (its backward slot runs the stage)."""
    per = layers // n_stages
    forwards = m_count if schedule == "gpipe" or stage < n_stages - 1 else 0
    return {"flash_fwd": (forwards + m_count) * per * steps,
            "flash_bwd_fused": m_count * per * steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _pipe_ticks(schedule, n_stages, m_count):
    return m_count + n_stages - 1 if schedule == "gpipe" else 2 * m_count + 2 * n_stages - 3


def _vocab_accumulators(shapes, vocab):
    """The vocab-sized f32 accumulators outside the layers of a 1F1B call
    (``pipeline.last_grad_acc_shapes``)."""
    return [[name, list(shape)] for name, shape, dtype in shapes
            if name != "g_lp" and shape[:1] == (vocab,) and dtype == "float32"]


def phase_pipeline(cfg, fa, train_stats):
    """The pipeline path: ``make_train_step(mesh=, pp_axis="pp")`` on a
    1-rank NCCL mesh with a pp axis of size 1, the full llama_7b, each of
    PIPE_SCHEDULES: seeded stage materialize, PIPE_STEPS steps at PIPE_SHAPE
    with their launches (read around each step), the first loss against
    the single-device loss on the same storage, one profiled step (device
    ms; the host's share a tick), the peak allocated over the steps.  Then
    the 1-rank references of [pipeline ranks]."""
    import torch.distributed as dist

    from torchdistx_tpu_torch.models.llama import num_params
    from torchdistx_tpu_torch.parallel import initialize, make_mesh
    from torchdistx_tpu_torch.parallel import pipeline as pl
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    b, s = PIPE_SHAPE
    m_count = PIPE_MICROBATCHES
    info = initialize(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0)
    stats = {"process": list(info.__dict__.values()), "shape": [b, s],
             "n_microbatches": m_count,
             "single_device_steady_step_ms": train_stats.get(f"{b}x{s}", {}).get(
                 "steady_step_ms")}
    path = dict.fromkeys(_counts(fa), 0)
    refs = {}
    try:
        mesh = make_mesh(axis_names=("pp",), shape=(1,))
        batch = {k: v.cuda() for k, v in _pipe_batch(cfg.vocab_size, b, s,
                                                      PIPE_DATA_SEED).items()}
        for schedule in PIPE_SCHEDULES:
            init_fn, step_fn = make_train_step(cfg, _mesh_tx, mesh=mesh, pp_axis="pp",
                                               n_microbatches=m_count, pp_schedule=schedule)
            t0 = time.perf_counter()
            state = init_fn(MAT_SEED)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            nbytes = sum(p.untyped_storage().nbytes() for p in state.model.parameters())
            _check(nbytes == 2 * num_params(cfg),
                   f"[pipeline] {schedule}: the stage holds {nbytes} bytes")
            with torch.no_grad():  # the single-device step's loss, same storage
                single_loss = state.model.loss(batch["tokens"], batch["targets"]).item()
            want = _pipe_launches(schedule, 1, 0, cfg.n_layers, m_count, 1)
            _free()
            torch.cuda.reset_peak_memory_stats()
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
            losses, step_ms = [], []
            with _KernelBlocks(fa) as spy:
                for i in range(PIPE_STEPS):
                    c0 = _counts(fa)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    state, metrics = step_fn(state, batch)
                    end.record()
                    end.synchronize()
                    step_ms.append(start.elapsed_time(end))
                    launched = {k: v - c0[k] for k, v in _counts(fa).items()}
                    path = {k: v + launched[k] for k, v in path.items()}
                    losses.append(metrics["loss"].item())
                    _check(math.isfinite(losses[-1]) and not metrics["nonfinite"],
                           f"[pipeline] {schedule} step {i + 1}: loss {losses[-1]}")
                    _check(launched == want, f"[pipeline] {schedule} step {i + 1}: launches "
                           f"{launched}, expected {want}")
            peak = torch.cuda.max_memory_allocated()
            # cudaMalloc calls that failed and were retried after the
            # allocator freed its cache (each synchronizes the device).
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
            _check(sorted(spy.blocks) == [PIPE_BLOCKS["pipeline"][0]],
                   f"[pipeline] {schedule}: the kernel saw {sorted(spy.blocks)}")
            _check(abs(losses[0] - single_loss) <= MESH_LOSS_ATOL,
                   f"[pipeline] {schedule}: first loss {losses[0]} vs single-device "
                   f"{single_loss}")
            _check(losses[-1] < losses[0], f"[pipeline] {schedule}: the loss did not fall")
            held = {}

            def profiled_step():
                held["out"] = step_fn(state, batch)

            c0 = _counts(fa)
            profile = _profile(f"pipeline {schedule} step", profiled_step)
            state, _ = held.pop("out")
            launched = {k: v - c0[k] for k, v in _counts(fa).items()}
            path = {k: v + launched[k] for k, v in path.items()}
            _check(launched == want, f"[pipeline] {schedule}: profiled step launches")
            ticks = _pipe_ticks(schedule, 1, m_count)
            row = {"losses": losses, "single_device_first_loss": single_loss,
                   "step_ms": step_ms, "last_step_ms": step_ms[-1],
                   "device_ms": profile["device_ms"], "profile": profile,
                   "ticks": ticks, "stage_calls": dict(pl.last_stage_calls),
                   "host_ms_per_tick": (step_ms[-1] - profile["device_ms"]) / ticks,
                   "peak_allocated_bytes": peak, "alloc_retries": retries,
                   "launches_per_step": want,
                   "init_s": init_s, "stage_bytes": nbytes}
            if schedule == "1f1b":
                row["stash_slots"] = pl.last_stash_slots
            stats[schedule] = row
            print(f"[pipeline] {schedule}: llama_7b ({cfg.n_layers} layers, bf16) on a 1-rank "
                  f"NCCL mesh (axis pp of size 1), {b}x{s} in {m_count} microbatches: losses "
                  f"{losses} (single-device {single_loss}); step ms by events "
                  f"{[round(x, 1) for x in step_ms]}, device {profile['device_ms']:.1f} ms, "
                  f"host {row['host_ms_per_tick']:.2f} ms a tick over {ticks} ticks; peak "
                  f"allocated {peak} bytes ({retries} allocator retries); flash launches a "
                  f"step {want} (single-device "
                  f"4x512 step {stats['single_device_steady_step_ms']} ms); {_smi()}")
            del state, init_fn, step_fn, held
            _free()
        stats["path_launches"] = path

        # [pipeline ranks]' 1-rank references: same seed, batch and schedule.
        for key, (family, layers, _, schedule, (rb, rs)) in PIPE_RANK_RUNS.items():
            mod, small = _pipe_cfg(family, layers)
            micro = PIPE_RANK_OPTIONS.get(key, {}).get("n_microbatches", m_count)
            init_fn, step_fn = make_train_step(small, _mesh_tx, model=mod, mesh=mesh,
                                               pp_axis="pp", n_microbatches=micro,
                                               pp_schedule=schedule)
            state = init_fn(PIPE_RANKS_SEED)
            rbatch = {k: v.cuda() for k, v in _pipe_batch(small.vocab_size, rb, rs,
                                                          PIPE_RANKS_DATA_SEED).items()}
            state, losses, step_ms, grads, change = _fingerprinted_steps(
                state, step_fn, rbatch, PIPE_RANKS_STEPS)
            refs[key] = {"losses": losses, "step_ms": step_ms,
                         "fingerprints": {"grads": grads, "change": change}}
            if family == "gpt2":
                refs[key]["vocab_accumulators"] = _vocab_accumulators(
                    pl.last_grad_acc_shapes, small.vocab_size)
            del state, init_fn, step_fn
            _free()
    finally:
        dist.destroy_process_group()
        _free()
    stats["rank_references"] = {k: {"losses": v["losses"], "step_ms": v["step_ms"]}
                                for k, v in refs.items()}
    print("[pipeline] " + json.dumps({k: v for k, v in stats.items()
                                      if k not in ("1f1b", "gpipe")}))
    return stats, refs


def phase_resnet():
    """[resnet]: ``deferred_init`` ResNet-50 claiming the card (no bytes
    allocated: every parameter and buffer a recorded fake, the BatchNorms'
    ``num_batches_tracked`` literals too), then
    ``materialize_module_torch(seed=MAT_SEED)`` onto it (the values' bytes
    exactly the parameters' and buffers' storage), loaded by assignment; an
    eval forward of RESNET_BATCH, finite; a second recording gives the same
    values."""
    from torchdistx_tpu_torch.deferred_init import deferred_init, is_deferred
    from torchdistx_tpu_torch.materialize import materialize_module_torch
    from torchdistx_tpu_torch.models.resnet_torch import resnet50

    _free()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = deferred_init(resnet50, device_="cuda")
    record_s = time.perf_counter() - t0
    recorded = torch.cuda.memory_allocated() - before
    _check(recorded == 0, f"[resnet]: deferred_init allocated {recorded} bytes")
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    _check(all(is_deferred(t) for t in tensors.values()), "[resnet]: a tensor is not deferred")
    want = sum(t.numel() * t.element_size() for t in tensors.values())
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    values = materialize_module_torch(model, seed=MAT_SEED)
    torch.cuda.synchronize()
    mat_s = time.perf_counter() - t0
    nbytes = sum(v.untyped_storage().nbytes() for v in values.values())
    _check(sorted(values) == sorted(tensors) and nbytes == want,
           f"[resnet]: {len(values)} values of {nbytes} bytes, want {len(tensors)} of {want}")
    _check(all(v.is_cuda for v in values.values()), "[resnet]: a value is not on the card")
    model.load_state_dict(values, assign=True)
    model.eval()
    x = torch.randn(RESNET_BATCH, generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    with torch.inference_mode():
        y = model(x)
        forward_ms = _time_ms(lambda: model(x), warmup=2, reps=5, calls=3)
    _check(y.shape == (RESNET_BATCH[0], 1000) and bool(torch.isfinite(y).all()),
           f"[resnet]: forward {tuple(y.shape)} not finite")
    again = materialize_module_torch(deferred_init(resnet50, device_="cuda"), seed=MAT_SEED)
    _check(all(torch.equal(again[k], v) for k, v in values.items()),
           "[resnet]: two recordings materialize different values")
    stats = {"params": n_params, "tensors": len(values), "record_s": record_s,
             "bytes_recorded": recorded, "seeded_materialize_s": mat_s,
             "bytes_materialized": nbytes, "forward_ms": forward_ms,
             "batch": list(RESNET_BATCH)}
    print(f"[resnet] ResNet-50: deferred_init claiming the card, {n_params} params, "
          f"{len(values)} tensors, bytes after record {recorded}, record {record_s:.3f} s; "
          f"materialize_module_torch(seed={MAT_SEED}) {mat_s:.3f} s, {nbytes} bytes (the "
          f"parameters' and buffers' storage); eval forward {RESNET_BATCH} {forward_ms:.3f} "
          f"ms, finite; a second recording bit-equal; {_smi()}")
    del model, values, again, x, y
    _free()
    return stats


def _timed_hops(pl):
    """Wrap the pipeline's hop to time it (synchronized); returns the
    record ``{"ms": total, "hops": count}`` and the undo."""
    record = {"ms": 0.0, "hops": 0}
    bare = pl._shift

    def timed(*args):
        torch.cuda.synchronize()  # the tick's compute is not the hop's
        t0 = time.perf_counter()
        out = bare(*args)
        torch.cuda.synchronize()
        record["ms"] += (time.perf_counter() - t0) * 1e3
        record["hops"] += 1
        return out

    pl._shift = timed
    return record, lambda: setattr(pl, "_shift", bare)


def _counted_ring():
    """Count the calls of ``ring_attention`` (the attention dispatcher looks
    it up at each call); returns the record ``{"calls": n}`` and the
    undo."""
    from torchdistx_tpu_torch.parallel import ring_attention as ra

    record, bare = {"calls": 0}, ra.ring_attention

    def counted(*args, **kwargs):
        record["calls"] += 1
        return bare(*args, **kwargs)

    ra.ring_attention = counted
    return record, lambda: setattr(ra, "ring_attention", bare)


def _pipe_rank_run(fa, rank, family, layers, axes, schedule, shape, options):
    """One [pipeline ranks] run on this rank (``options``: its
    PIPE_RANK_OPTIONS)."""
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel import pipeline as pl
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    mod, cfg = _pipe_cfg(family, layers)
    mesh = make_mesh(MeshSpec(**axes), device_type="cuda")
    init_fn, step_fn = make_train_step(
        cfg, _mesh_tx, model=mod, mesh=mesh, pp_axis="pp", pp_schedule=schedule,
        n_microbatches=options.get("n_microbatches", PIPE_MICROBATCHES),
        seq_axis=options.get("seq_axis"))
    torch.cuda.reset_peak_memory_stats()
    state = init_fn(PIPE_RANKS_SEED)
    held = [(n, p) for n, p in state.model.named_parameters() if not p.is_meta]
    held_bytes = sum((p.to_local() if hasattr(p, "to_local") else p).untyped_storage().nbytes()
                     for _, p in held)
    batch = {k: v.cuda() for k, v in _pipe_batch(cfg.vocab_size, *shape,
                                                 PIPE_RANKS_DATA_SEED).items()}
    _reset_counts(fa)
    hops, undo = _timed_hops(pl)
    ring, ring_undo = _counted_ring()
    try:
        with _KernelBlocks(fa) as spy:
            state, losses, step_ms, grads, change = _fingerprinted_steps(
                state, step_fn, batch, PIPE_RANKS_STEPS)
    finally:
        undo()
        ring_undo()
    out = {"losses": losses, "step_ms": step_ms, "launches": _counts(fa),
           "ring_calls": ring["calls"],
           "kernel_blocks": sorted(spy.blocks), "held_param_bytes": held_bytes,
           "held_layers": sorted({int(n.split(".")[1]) for n, _ in held
                                  if n.startswith("layers.")}),
           "stage": mesh.get_local_rank("pp"), "n_stages": axes["pp"],
           "hop_ms": hops["ms"], "hops": hops["hops"],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "host_peak_rss": _host_mem()["peak_rss"],
           "fingerprints": {"grads": grads, "change": change}}
    if schedule == "1f1b":
        out["vocab_accumulators"] = _vocab_accumulators(pl.last_grad_acc_shapes,
                                                        cfg.vocab_size)
    del state, init_fn, step_fn
    _free()
    return out


def pipeline_rank(rank, store, out) -> None:
    """One rank of ``phase_pipeline_ranks`` (4 gloo ranks on the card): each
    run of PIPE_RANK_RUNS; saves what the parent checks."""
    import torch.distributed as dist

    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
    got = {}
    try:
        for key, run in PIPE_RANK_RUNS.items():
            got[key] = _pipe_rank_run(fa, rank, *run, PIPE_RANK_OPTIONS.get(key, {}))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(got, out)


def _merged_prints(ranks, which):
    """One fingerprint dict from every rank's (each holds its stage)."""
    out = {}
    for r in ranks:
        out.update(r["fingerprints"][which])
    return out


def _host_mem():
    """This process's peak resident host memory (``getrusage``) and the
    machine's available memory (``/proc/meminfo``, None where it is not
    given), in bytes."""
    import resource

    out = {"peak_rss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
           "available": None}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                name, _, value = line.partition(":")
                if name == "MemAvailable":
                    out["available"] = int(value.split()[0]) * 1024
    except OSError:
        pass
    return out


def phase_pipeline_ranks(refs):
    """4 gloo ranks on the card, each run of PIPE_RANK_RUNS against its
    1-rank reference from [pipeline]."""
    import os
    import shutil
    import tempfile

    _free()
    if hasattr(torch._C, "_host_emptyCache"):  # pinned host blocks that earlier phases cached
        torch._C._host_emptyCache()
    host_before = _host_mem()
    card_before = {"allocated": torch.cuda.memory_allocated(),
                   "reserved": torch.cuda.memory_reserved(),
                   "used_by_all": torch.cuda.mem_get_info()}
    print(f"[pipeline ranks] before the ranks: this process's card memory {card_before}")

    root = tempfile.mkdtemp(prefix="tdx_pipe_")
    outs = [os.path.join(root, f"rank{r}.pt") for r in range(4)]
    store = os.path.join(root, "store")
    t0 = time.perf_counter()
    procs = []
    try:
        for rank, out in enumerate(outs):
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--pipeline-rank", str(rank), store, out],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=PIPE_RANKS_TIMEOUT_S)[0] for p in procs]
        failed = [(r, p.returncode, log) for r, (p, log) in enumerate(zip(procs, logs))
                  if p.returncode]
        _check(not failed, "pipeline ranks exited " + "; ".join(
            f"rank {r}: {code}:\n{log[-2000:]}" for r, code, log in failed))
        got = [torch.load(out, weights_only=True) for out in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    stats = {"wall_s": wall_s, "runs": {}, "launches_all_ranks": {},
             "host_mem_before": host_before, "card_mem_before": card_before,
             "rank_peak_rss_bytes": [max(r["host_peak_rss"] for r in g.values()) for g in got]}
    for key, (family, layers, axes, schedule, shape) in PIPE_RANK_RUNS.items():
        ranks = [g[key] for g in got]
        ref = refs[key]
        losses = ranks[0]["losses"]
        _check(all(r["losses"] == losses for r in ranks), f"({key}): the ranks' losses differ")
        loss_err = max(abs(x - y) for x, y in zip(losses, ref["losses"]))
        grad_err = _fingerprint_err(_merged_prints(ranks, "grads"),
                                    ref["fingerprints"]["grads"])
        change_err = _fingerprint_err(_merged_prints(ranks, "change"),
                                      ref["fingerprints"]["change"])
        loss_atol, grad_rtol, change_rtol = PIPE_RANKS_BOUNDS[key]
        _check(loss_err <= loss_atol, f"({key}): losses {losses} vs 1-rank {ref['losses']}")
        _check(grad_err <= grad_rtol, f"({key}): first-step gradients {grad_err}")
        _check(change_err <= change_rtol, f"({key}): the parameters' change {change_err}")
        n_stages = axes["pp"]
        per = layers // n_stages
        options = PIPE_RANK_OPTIONS.get(key, {})
        micro = options.get("n_microbatches", PIPE_MICROBATCHES)
        ring = options.get("seq_axis") is not None  # no flash launch: the ring
        for rank, r in enumerate(ranks):
            want = _pipe_launches(schedule, n_stages, r["stage"], layers, micro,
                                  PIPE_RANKS_STEPS)
            if ring:
                want = dict.fromkeys(want, 0)
            _check(r["launches"] == want, f"({key}) rank {rank}: launches {r['launches']}, "
                   f"expected {want}")
            _check(r["kernel_blocks"] == ([] if ring else [PIPE_BLOCKS[key][0]]),
                   f"({key}) rank {rank}: the kernel saw {r['kernel_blocks']}")
            _check(r["held_layers"] == list(range(r["stage"] * per, (r["stage"] + 1) * per)),
                   f"({key}) rank {rank}: holds layers {r['held_layers']}")
            _check(r["hops"] == 2 * PIPE_RANKS_STEPS * (_pipe_ticks(schedule, n_stages,
                                                                    micro) - 1),
                   f"({key}) rank {rank}: {r['hops']} hops")
            if ring:
                # A step runs each stage once a microbatch forward and once
                # again in the backward's recompute.
                _check(r["ring_calls"] == 2 * micro * per * PIPE_RANKS_STEPS,
                       f"({key}) rank {rank}: {r['ring_calls']} ring calls")
        mod, cfg = _pipe_cfg(family, layers)
        if family == "gpt2":  # the tied wte: one (V, D) f32 accumulator, on every rank
            one_acc = [["g_sp", [cfg.vocab_size, cfg.dim]]]
            _check(ref["vocab_accumulators"] == one_acc
                   and all(r["vocab_accumulators"] == one_acc for r in ranks),
                   f"({key}): the tied wte's accumulators "
                   f"{[r['vocab_accumulators'] for r in ranks]}")
        if axes == {"pp": 4}:
            one = 2 * (mod.num_params(dataclasses.replace(cfg, n_layers=1))
                       - mod.num_params(dataclasses.replace(cfg, n_layers=0)))
            outside = 2 * mod.num_params(dataclasses.replace(cfg, n_layers=0))
            for rank, r in enumerate(ranks):
                _check(r["held_param_bytes"] == outside + per * one,
                       f"({key}) rank {rank}: holds {r['held_param_bytes']} bytes, its stage "
                       f"{outside + per * one}")
        n_hop = sum(r["hops"] for r in ranks)
        stats["launches_all_ranks"][key] = {k: sum(r["launches"][k] for r in ranks)
                                            for k in ranks[0]["launches"]}
        stats["runs"][key] = {
            "family": family, "layers": layers, "mesh": axes, "schedule": schedule,
            "batch": list(shape), "losses": losses, "reference_losses": ref["losses"],
            "loss_max_abs_err": loss_err, "grad_fingerprint_rel_err": grad_err,
            "change_fingerprint_rel_err": change_err,
            "step_ms_by_rank": [r["step_ms"] for r in ranks],
            "reference_step_ms": ref["step_ms"],
            "hop_ms_per_tick": sum(r["hop_ms"] for r in ranks) / n_hop,
            "held_param_bytes_by_rank": [r["held_param_bytes"] for r in ranks],
            "peak_allocated_bytes_by_rank": [r["peak_allocated_bytes"] for r in ranks],
            "kernel_block": PIPE_BLOCKS[key][0]}
        row = stats["runs"][key]
        print(f"[pipeline ranks] ({key}) {family} x {layers} layers, {axes}, {schedule}, "
              f"{shape[0]}x{shape[1]} in {micro} microbatches: losses {losses} "
              f"vs 1-rank {ref['losses']} (max err {loss_err:.3e}, atol {loss_atol}); "
              f"fingerprints' relative error: gradients {grad_err:.3e} (rtol {grad_rtol}), "
              f"change {change_err:.3e} (rtol {change_rtol}); step ms by rank "
              f"{[[round(x, 1) for x in t] for t in row['step_ms_by_rank']]}; hop "
              f"{row['hop_ms_per_tick']:.3f} ms (synchronized around it); bytes held by rank "
              f"{row['held_param_bytes_by_rank']}; "
              + (f"the ring in every stage's attention ({ranks[0]['ring_calls']} calls a "
                 f"rank), no flash launch" if ring else f"kernel on {PIPE_BLOCKS[key][0]}"))
    print(f"[pipeline ranks] 4 gloo ranks on the card, {wall_s:.1f} s; host memory before "
          f"{json.dumps(host_before)}, the ranks' peak RSS {stats['rank_peak_rss_bytes']}; "
          f"{_smi()}")
    return stats


# ---------------------------------------------------------------------------
# [ep ranks]: MoE expert parallelism, 4 gloo ranks on the card


def _timed_exchange():
    """Wrap ``SpmdContext.ep_exchange`` (the expert rows' all-to-all, in the
    forward and its recompute) to time it, synchronized; returns the record
    ``{"ms": total, "calls": count}`` and the undo."""
    from torchdistx_tpu_torch.parallel.spmd import SpmdContext

    record, bare = {"ms": 0.0, "calls": 0}, SpmdContext.ep_exchange

    def timed(self, *args):
        torch.cuda.synchronize()  # the layer's compute is not the exchange's
        t0 = time.perf_counter()
        out = bare(self, *args)
        torch.cuda.synchronize()
        record["ms"] += (time.perf_counter() - t0) * 1e3
        record["calls"] += 1
        return out

    SpmdContext.ep_exchange = timed
    return record, lambda: setattr(SpmdContext, "ep_exchange", bare)


def _plan_bytes(mod, cfg, axes):
    """The bytes a rank holds of ``cfg``'s parameters in bf16 on a mesh of
    ``axes`` by the family's plan: each parameter's elements over the
    sizes of the axes that shard it."""
    from torch.distributed.tensor import Shard

    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.parallel import MeshSpec
    from torchdistx_tpu_torch.parallel.sharding import fit_shardings

    cls = {"MoEConfig": "MoE", "LlamaConfig": "Llama"}[type(cfg).__name__]
    shapes = {n: tuple(p.shape) for n, p in
              deferred_init(getattr(mod, cls), cfg, device="cpu").named_parameters()}
    spec = MeshSpec(**axes)
    sizes = dict(spec.axes())
    total = 0
    for name, placements in fit_shardings(mod.param_specs(cfg), shapes, spec).items():
        parts = math.prod(sizes[a] for a, p in zip(sizes, placements) if isinstance(p, Shard))
        total += math.prod(shapes[name]) // parts
    return 2 * total


def _ep_rank_run(fa, rank, key):
    """[ep ranks] (a)/(b) on this rank."""
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    mod, cfg = _pipe_cfg("moe", EP_RANKS_LAYERS)
    mesh = make_mesh(MeshSpec(**EP_RANK_RUNS[key]), device_type="cuda")
    init_fn, step_fn = make_train_step(cfg, _mesh_tx, model=mod, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    state = init_fn(EP_RANKS_SEED)
    held = sum(p.to_local().untyped_storage().nbytes() for p in state.model.parameters())
    experts = [tuple(blk.e_gate.to_local().shape) for blk in state.model.layers]
    batch = {k: v.cuda() for k, v in _pipe_batch(cfg.vocab_size, *EP_RANKS_SHAPE,
                                                 EP_RANKS_DATA_SEED).items()}
    _reset_counts(fa)
    a2a, undo = _timed_exchange()
    try:
        with _KernelBlocks(fa) as spy:
            state, losses, step_ms, grads, change = _fingerprinted_steps(
                state, step_fn, batch, EP_RANKS_STEPS)
    finally:
        undo()
    out = {"losses": losses, "step_ms": step_ms, "launches": _counts(fa),
           "kernel_blocks": sorted(spy.blocks), "held_param_bytes": held,
           "expert_stacks": experts, "a2a_ms": a2a["ms"], "a2a_calls": a2a["calls"],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "fingerprints": {"grads": grads, "change": change} if rank == 0 else None}
    del state, init_fn, step_fn
    _free()
    return out


def _ep_rank_f32(device):
    """[ep ranks] (c): moe_test in f32 under ep=4 from the CPU port's seeded
    weights, EP_RANKS_F32_STEPS AdamW steps; the first step's routing of
    every layer (the tokens' experts, positions and kept choices)."""
    from torchdistx_tpu_torch.models import moe
    from torchdistx_tpu_torch.parallel import MeshSpec, make_mesh
    from torchdistx_tpu_torch.parallel.spmd import whole
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    def tx(params):
        return torch.optim.AdamW(params, lr=1e-3, eps=1e-6, foreach=False)

    cfg = moe.moe_test()
    mesh = make_mesh(MeshSpec(ep=4), device_type=device)
    init_fn, step_fn = make_train_step(cfg, tx, model=moe, mesh=mesh)
    state = init_fn(TRAIN_SEED)
    _rank_weights(mesh, state.model, make_train_step(cfg, tx, model=moe, device="cpu")[0](
        TRAIN_SEED).model.state_dict())
    batch = _mesh_ranks_batch(cfg.vocab_size, *MESH_RANKS_F32_SHAPE)
    routing, bare = [], moe.route

    def spy(*args, **kwargs):
        r = bare(*args, **kwargs)
        if len(routing) < cfg.n_layers:
            routing.append([getattr(r, n).cpu() for n in ("experts", "pos", "keep")])
        return r

    moe.route = spy
    losses = []
    try:
        for _ in range(EP_RANKS_F32_STEPS):
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"].item())
    finally:
        moe.route = bare
    return {"losses": losses, "routing": routing,
            "params": {n: whole(p).detach().cpu() for n, p in state.model.named_parameters()}}


def ep_rank(device, rank, store, out) -> None:
    """One rank of ``phase_ep_ranks`` (4 gloo ranks on ``device``): (a) and
    (b) on the card only, then (c); saves what the parent checks."""
    import torch.distributed as dist

    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
    got = {"device": device}
    try:
        if device == "cuda":
            for key in EP_RANK_RUNS:
                got[key] = _ep_rank_run(fa, rank, key)
        _reset_counts(fa)
        got["c"] = _ep_rank_f32(device)
        got["c_launches"] = _counts(fa)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(got, out)


def phase_ep_reference():
    """[ep ranks]' reference: the same MoE model, seed, batch and steps on a
    1-rank NCCL mesh (every expert on the one rank)."""
    import torch.distributed as dist

    from torchdistx_tpu_torch.parallel import MeshSpec, initialize, make_mesh
    from torchdistx_tpu_torch.parallel.train_step import make_train_step

    mod, cfg = _pipe_cfg("moe", EP_RANKS_LAYERS)
    initialize(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0)
    try:
        mesh = make_mesh(MeshSpec())
        init_fn, step_fn = make_train_step(cfg, _mesh_tx, model=mod, mesh=mesh)
        state = init_fn(EP_RANKS_SEED)
        batch = {k: v.cuda() for k, v in _pipe_batch(cfg.vocab_size, *EP_RANKS_SHAPE,
                                                     EP_RANKS_DATA_SEED).items()}
        state, losses, step_ms, grads, change = _fingerprinted_steps(state, step_fn, batch,
                                                                     EP_RANKS_STEPS)
        del state, init_fn, step_fn
    finally:
        dist.destroy_process_group()
        _free()
    print(f"[ep ranks] the 1-rank reference: MoEConfig() widths x {cfg.n_layers} layers, "
          f"bf16, {EP_RANKS_SHAPE[0]}x{EP_RANKS_SHAPE[1]}: losses {losses}; step ms "
          f"{[round(x, 1) for x in step_ms]}")
    return {"losses": losses, "step_ms": step_ms,
            "fingerprints": {"grads": grads, "change": change}}


def phase_ep_ranks(ref):
    """4 gloo ranks on the card and 4 on the CPU, all started together; (a)
    and (b) against the 1-rank reference ``ref``, (c) against the CPU
    ranks."""
    import os
    import shutil
    import tempfile

    from torchdistx_tpu_torch.models import moe

    root = tempfile.mkdtemp(prefix="tdx_ep_")
    outs = {device: [os.path.join(root, f"{device}{r}.pt") for r in range(4)]
            for device in ("cuda", "cpu")}
    t0 = time.perf_counter()
    try:
        got = _spawn_ranks("--ep-rank", ("cuda", "cpu"), outs, EP_RANKS_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    mod, cfg = _pipe_cfg("moe", EP_RANKS_LAYERS)
    whole_bytes = 2 * moe.num_params(cfg)
    stats = {"wall_s": wall_s, "runs": {}, "launches_all_ranks": {},
             "reference_losses": ref["losses"], "reference_step_ms": ref["step_ms"],
             "whole_param_bytes": whole_bytes}
    per_step = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_fused": cfg.n_layers,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}  # remat: the forward twice
    want_launches = {k: v * EP_RANKS_STEPS for k, v in per_step.items()}
    for key, axes in EP_RANK_RUNS.items():
        ranks = [r[key] for r in got["cuda"]]
        losses = ranks[0]["losses"]
        _check(all(r["losses"] == losses for r in ranks), f"({key}): the ranks' losses differ")
        loss_err = max(abs(x - y) for x, y in zip(losses, ref["losses"]))
        grad_err = _fingerprint_err(ranks[0]["fingerprints"]["grads"],
                                    ref["fingerprints"]["grads"])
        change_err = _fingerprint_err(ranks[0]["fingerprints"]["change"],
                                      ref["fingerprints"]["change"])
        print(f"[ep ranks] ({key}) {axes} vs the 1-rank run: losses {losses} vs "
              f"{ref['losses']}; the fingerprints' relative error: first-step gradients "
              f"{grad_err}, the parameters' change {change_err}")
        loss_atol, grad_rtol, change_rtol = EP_RANKS_BOUNDS[key]
        _check(loss_err <= loss_atol, f"({key}): losses {losses} vs 1-rank {ref['losses']}")
        _check(grad_err <= grad_rtol, f"({key}): first-step gradients {grad_err}")
        _check(change_err <= change_rtol, f"({key}): the parameters' change {change_err}")
        plan_bytes = _plan_bytes(mod, cfg, axes)
        e_loc = cfg.n_experts // axes["ep"]
        for rank, r in enumerate(ranks):
            _check(all(shape[0] == e_loc for shape in r["expert_stacks"]),
                   f"({key}) rank {rank}: expert stacks {r['expert_stacks']}")
            _check(r["held_param_bytes"] == plan_bytes,
                   f"({key}) rank {rank}: holds {r['held_param_bytes']} bytes, the plan's "
                   f"{plan_bytes}")
            _check(r["launches"] == want_launches, f"({key}) rank {rank}: launches "
                   f"{r['launches']}, expected {want_launches}")
            _check(r["kernel_blocks"] == [EP_BLOCKS[key][0]],
                   f"({key}) rank {rank}: the kernel saw {r['kernel_blocks']}")
            # Each layer's forward exchanges twice (rows out, outputs back),
            # once in the step and again in remat's recompute.
            _check(r["a2a_calls"] == 4 * cfg.n_layers * EP_RANKS_STEPS,
                   f"({key}) rank {rank}: {r['a2a_calls']} exchanges")
        a2a_ms = statistics.mean(r["a2a_ms"] / r["a2a_calls"] for r in ranks)
        stats["launches_all_ranks"][key] = {k: sum(r["launches"][k] for r in ranks)
                                            for k in want_launches}
        stats["runs"][key] = {
            "mesh": axes, "losses": losses, "loss_max_abs_err": loss_err,
            "grad_fingerprint_rel_err": grad_err, "change_fingerprint_rel_err": change_err,
            "step_ms_by_rank": [r["step_ms"] for r in ranks],
            "held_param_bytes_per_rank": ranks[0]["held_param_bytes"],
            "experts_per_layer_per_rank": e_loc,
            "a2a_ms_per_exchange": a2a_ms, "a2a_ms_per_layer_forward": 2 * a2a_ms,
            "peak_allocated_bytes_by_rank": [r["peak_allocated_bytes"] for r in ranks],
            "kernel_block": EP_BLOCKS[key][0]}
        print(f"[ep ranks] ({key}) MoEConfig() widths x {cfg.n_layers} layers, bf16, {axes}, "
              f"{EP_RANKS_SHAPE[0]}x{EP_RANKS_SHAPE[1]}: losses {losses} vs 1-rank "
              f"{ref['losses']} (max err {loss_err:.3e}, atol {loss_atol}); fingerprints' "
              f"relative error: gradients {grad_err:.3e} (rtol {grad_rtol}), change "
              f"{change_err:.3e} (rtol {change_rtol}); step ms by rank "
              f"{[[round(x, 1) for x in r['step_ms']] for r in ranks]}; {e_loc} of "
              f"{cfg.n_experts} experts a layer on each rank, {ranks[0]['held_param_bytes']} "
              f"bytes of {whole_bytes}; the all-to-all {a2a_ms:.3f} ms an exchange, "
              f"{2 * a2a_ms:.3f} ms a layer's forward (synchronized around it); kernel on "
              f"{EP_BLOCKS[key][0]}")
    # (c): the card's ranks against the CPU's, routing exactly.
    card, cpu = got["cuda"][0]["c"], got["cpu"][0]["c"]
    loss_err = max(abs(x - y) for x, y in zip(card["losses"], cpu["losses"]))
    param_err = max((card["params"][n] - cpu["params"][n]).abs().max().item()
                    for n in cpu["params"])
    _check(loss_err <= MESH_RANKS_F32_ATOL and param_err <= MESH_RANKS_F32_ATOL,
           f"(c) card vs CPU ranks: loss err {loss_err}, param err {param_err}")
    for r_card, r_cpu in zip(got["cuda"], got["cpu"]):
        for layer, (a, b) in enumerate(zip(r_card["c"]["routing"], r_cpu["c"]["routing"],
                                           strict=True)):
            _check(all(torch.equal(x, y) for x, y in zip(a, b)),
                   f"(c) layer {layer}: the card's ranks route differently from the CPU's")
    c_launches = got["cuda"][0]["c_launches"]
    _check(c_launches["flash_fwd"] > 0 and c_launches["flash_bwd_fused"] > 0,
           f"(c): the card's ranks did not launch the kernels: {c_launches}")
    _check(not any(got["cpu"][0]["c_launches"].values()), "a CPU rank launched a kernel")
    stats["f32"] = {"loss": loss_err, "param": param_err, "losses": card["losses"]}
    print(f"[ep ranks] (c) moe_test f32 under ep=4, 4 card ranks vs 4 CPU ranks: loss err "
          f"{loss_err:.3e}, param err {param_err:.3e} (atol {MESH_RANKS_F32_ATOL}); every "
          f"layer's experts, positions and kept choices equal; {wall_s:.1f} s; {_smi()}")
    return stats


# ---------------------------------------------------------------------------
# [slowmo ranks]: SlowMo replicas of two ranks (tp / fsdp within a replica)


def _digests(model):
    """A digest of each parameter's local shard (its bytes), for bit
    equality across processes."""
    import hashlib

    out = []
    for p in model.parameters():
        local = p.to_local() if hasattr(p, "to_local") else p
        raw = local.detach().contiguous().view(torch.uint8 if local.element_size() == 1
                                               else torch.int16)
        out.append(hashlib.sha1(raw.cpu().numpy().tobytes()).hexdigest())
    return out


def _slowmo_opt(params):
    from torchdistx_tpu_torch.parallel.slowmo import SlowMomentumOptimizer

    return SlowMomentumOptimizer(torch.optim.SGD(params, lr=SLOWMO_LR), base_lr=SLOWMO_LR,
                                 slowmo_freq=SLOWMO_FREQ, slowmo_factor=SLOWMO_FACTOR,
                                 slowmo_lr=SLOWMO_SLR)


def _slowmo_batch(vocab, b, s):
    """The (dp, B, S) batch of [slowmo ranks], rows that differ by replica,
    from a CPU generator."""
    seq = torch.randint(0, vocab, (2, b, s + 1),
                        generator=torch.Generator().manual_seed(SLOWMO_RANKS_DATA_SEED))
    return {"tokens": seq[..., :-1], "targets": seq[..., 1:]}


def _slowmo_run(fa, spec, cfg, device, values=None):
    """SLOWMO_RANKS_STEPS SlowMo steps on a mesh of ``spec``: each step's
    mean loss, this rank's shard digests and (f32) its replica's whole
    values; the fingerprints of the parameters' change (its replica's)."""
    from torchdistx_tpu_torch.parallel import make_mesh
    from torchdistx_tpu_torch.parallel.spmd import whole
    from torchdistx_tpu_torch.parallel.train_step import make_slowmo_train_step

    mesh = make_mesh(spec, device_type=device)
    init_fn, step_fn = make_slowmo_train_step(cfg, mesh, _slowmo_opt, device=device)
    state = init_fn(SLOWMO_RANKS_SEED)
    if values is not None:
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                if hasattr(p, "to_local"):
                    from torchdistx_tpu_torch.materialize import _local_shard

                    p.to_local().copy_(_local_shard(values[name].to(p.to_local().device),
                                                    p.device_mesh, p.placements))
                else:
                    p.copy_(values[name])
    shape = SLOWMO_RANKS_F32_SHAPE if cfg.dtype == torch.float32 else SLOWMO_RANKS_SHAPE
    batch = {k: v.to(device) for k, v in _slowmo_batch(cfg.vocab_size, *shape).items()}
    named = dict(state.model.named_parameters())
    before = _fingerprint(named) if cfg.dtype != torch.float32 else None
    _reset_counts(fa)
    losses, step_ms, digests, params = [], [], [], []
    with _KernelBlocks(fa) as spy:
        for _ in range(SLOWMO_RANKS_STEPS):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            digests.append(_digests(state.model))
            if cfg.dtype == torch.float32:  # copies: whole() of a replicated shard is a view
                params.append({n: whole(p).cpu().clone() for n, p in named.items()})
    out = {"losses": losses, "step_ms": step_ms, "digests": digests, "params": params,
           "launches": _counts(fa), "kernel_blocks": sorted(spy.blocks),
           "coordinate": list(mesh.get_coordinate())}
    if before is not None:
        out["change"] = _fingerprint_change(_fingerprint(named), before)
    del state, init_fn, step_fn
    _free()
    return out


def slowmo_rank(device, rank, store, out) -> None:
    """One rank of ``phase_slowmo_ranks``: ``device`` "cuda" (4 ranks: (a),
    then (b)), "cpu" (4 ranks: (b)) or "whole" (2 ranks on the card: (a)'s
    reference with whole replicas, on the values of a seeded materialize
    of the whole model)."""
    import torch.distributed as dist

    from torchdistx_tpu_torch.deferred_init import deferred_init
    from torchdistx_tpu_torch.materialize import materialize_module_torch
    from torchdistx_tpu_torch.models.llama import Llama, llama_7b, llama_test
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa
    from torchdistx_tpu_torch.parallel import MeshSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = 2 if device == "whole" else 4
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    big = dataclasses.replace(llama_7b(), n_layers=SLOWMO_RANKS_LAYERS)
    got = {"device": device}
    try:
        if device == "whole":
            values = materialize_module_torch(deferred_init(Llama, big, device="cuda"),
                                              device="cuda", seed=SLOWMO_RANKS_SEED)
            got["a"] = _slowmo_run(fa, MeshSpec(dp=2), big, "cuda", values)
        else:
            if device == "cuda":
                got["a"] = _slowmo_run(fa, MeshSpec(dp=2, tp=2), big, "cuda")
            from torchdistx_tpu_torch.parallel.train_step import make_train_step

            values = make_train_step(llama_test(), _slowmo_opt, device="cpu")[0](
                TRAIN_SEED).model.state_dict()
            got["b"] = _slowmo_run(fa, MeshSpec(dp=2, fsdp=2), llama_test(), device, values)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(got, out)


def phase_slowmo_ranks():
    """4 gloo ranks on the card, 4 on the CPU and the 2 whole-replica ranks
    on the card, all started together."""
    import os
    import shutil
    import tempfile

    from torchdistx_tpu_torch.models.llama import llama_7b

    root = tempfile.mkdtemp(prefix="tdx_slowmo_ranks_")
    worlds = {"cuda": 4, "cpu": 4, "whole": 2}
    outs = {device: [os.path.join(root, f"{device}{r}.pt") for r in range(n)]
            for device, n in worlds.items()}
    t0 = time.perf_counter()
    try:
        got = _spawn_ranks("--slowmo-rank", tuple(worlds), outs, SLOWMO_RANKS_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    cfg = dataclasses.replace(llama_7b(), n_layers=SLOWMO_RANKS_LAYERS)
    averaged = [(i + 1) % SLOWMO_FREQ == 0 for i in range(SLOWMO_RANKS_STEPS)]

    def replicas_equal(ranks, run, peers):
        """By step: whether the ranks of each ``peers`` pair (the same
        shard of the two replicas) hold the same bits."""
        return [all(ranks[i][run]["digests"][step] == ranks[j][run]["digests"][step]
                    for i, j in peers) for step in range(SLOWMO_RANKS_STEPS)]

    # (a): replicas of 2 ranks (dp=2 x tp=2) against whole replicas.
    a, whole_a = [r["a"] for r in got["cuda"]], [r["a"] for r in got["whole"]]
    losses, ref = a[0]["losses"], whole_a[0]["losses"]
    _check(all(r["losses"] == losses for r in a), "(a): the ranks' mean losses differ")
    loss_err = max(abs(x - y) for x, y in zip(losses, ref))
    change_err = _fingerprint_err(a[0]["change"], whole_a[0]["change"])
    print(f"[slowmo ranks] (a) dp=2 x tp=2 vs whole replicas: mean losses {losses} vs {ref}; "
          f"the change's fingerprints' relative error {change_err} (replica 0)")
    _check(loss_err <= SLOWMO_RANKS_BOUNDS[0], f"(a): losses {losses} vs {ref}")
    _check(change_err <= SLOWMO_RANKS_BOUNDS[1], f"(a): the change {change_err}")
    eq_a = replicas_equal(got["cuda"], "a", ((0, 2), (1, 3)))
    eq_whole = replicas_equal(got["whole"], "a", ((0, 1),))
    _check(eq_a == averaged and eq_whole == averaged,
           f"(a): replicas bit-equal by step {eq_a}, whole replicas {eq_whole}")
    want_a = {"flash_fwd": 2 * cfg.n_layers * SLOWMO_RANKS_STEPS,
              "flash_bwd_fused": cfg.n_layers * SLOWMO_RANKS_STEPS,
              "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for rank, r in enumerate(a):
        _check(r["launches"] == want_a, f"(a) rank {rank}: launches {r['launches']}")
        _check(r["kernel_blocks"] == [SLOWMO_RANK_BLOCKS["a"][0]],
               f"(a) rank {rank}: the kernel saw {r['kernel_blocks']}")
    # (b): llama_test f32, dp=2 x fsdp=2, the card's ranks against the CPU's.
    loss_err_b = max(abs(x - y) for c, p in zip(got["cuda"], got["cpu"])
                     for x, y in zip(c["b"]["losses"], p["b"]["losses"]))
    param_err_b = max((x[n] - y[n]).abs().max().item()
                      for c, p in zip(got["cuda"], got["cpu"])
                      for x, y in zip(c["b"]["params"], p["b"]["params"]) for n in y)
    _check(loss_err_b <= SLOWMO_REPLICA_ATOL and param_err_b <= SLOWMO_REPLICA_ATOL,
           f"(b) card vs CPU ranks: loss err {loss_err_b}, param err {param_err_b}")
    eq_b = {device: replicas_equal(got[device], "b", ((0, 2), (1, 3)))
            for device in ("cuda", "cpu")}
    _check(all(v == averaged for v in eq_b.values()), f"(b): replicas bit-equal by step {eq_b}")
    b_launches = got["cuda"][0]["b"]["launches"]
    _check(b_launches["flash_fwd"] > 0 and b_launches["flash_bwd_fused"] > 0,
           f"(b): the card's ranks did not launch the kernels: {b_launches}")
    _check(all(r["b"]["kernel_blocks"] == [SLOWMO_RANK_BLOCKS["b"][0]] for r in got["cuda"]),
           f"(b): the kernel saw {got['cuda'][0]['b']['kernel_blocks']}")
    _check(not any(got["cpu"][0]["b"]["launches"].values()), "a CPU rank launched a kernel")
    launches = {"a": {k: sum(r["launches"][k] for r in a) for k in want_a},
                "b": {k: sum(r["b"]["launches"][k] for r in got["cuda"]) for k in want_a}}
    stats = {"wall_s": wall_s, "a_losses": losses, "a_whole_replica_losses": ref,
             "a_loss_max_abs_err": loss_err, "a_change_fingerprint_rel_err": change_err,
             "a_step_ms_by_rank": [r["step_ms"] for r in a],
             "a_whole_replica_step_ms": [r["step_ms"] for r in whole_a],
             "replicas_bit_equal_by_step": {"a": eq_a, "a_whole": eq_whole, **eq_b},
             "b_loss_max_abs_err": loss_err_b, "b_param_max_abs_err": param_err_b,
             "launches_all_ranks": launches}
    print(f"[slowmo ranks] (a) llama_7b widths x {cfg.n_layers} layers, bf16, dp=2 x tp=2, "
          f"SGD {SLOWMO_LR}, averaging every {SLOWMO_FREQ}, {SLOWMO_RANKS_STEPS} steps of "
          f"(2, {SLOWMO_RANKS_SHAPE[0]}, {SLOWMO_RANKS_SHAPE[1]}): losses {losses} vs whole "
          f"replicas {ref} (max err {loss_err:.3e}, atol {SLOWMO_RANKS_BOUNDS[0]}); the "
          f"change's fingerprints {change_err:.3e} (rtol {SLOWMO_RANKS_BOUNDS[1]}); replicas "
          f"bit-equal by step {eq_a}; step ms by rank "
          f"{[[round(x, 1) for x in r['step_ms']] for r in a]}, whole replicas "
          f"{[[round(x, 1) for x in r['step_ms']] for r in whole_a]}; kernel on "
          f"{SLOWMO_RANK_BLOCKS['a'][0]}; (b) llama_test f32 dp=2 x fsdp=2 vs 4 CPU ranks: "
          f"loss err {loss_err_b:.3e}, param err {param_err_b:.3e} (atol "
          f"{SLOWMO_REPLICA_ATOL}), replicas bit-equal by step {eq_b}; {wall_s:.1f} s; "
          f"{_smi()}")
    return stats


# Each kernel's source is csrc/<kernel>.cu; the line of the Pallas kernel
# it replaces in torchdistx_tpu/ops/pallas/flash_attention.py.
PALLAS_LINES = {"flash_fwd": 161, "flash_bwd_fused": 492, "flash_bwd_dq": 393,
                "flash_bwd_dkv": 438}


def _kernel_entry(name, kernel, row, launches):
    return {
        "name": name, "route": "cuda",
        "source": f"torchdistx_tpu_torch/ops/cuda/csrc/{kernel}.cu",
        "replaces": f"torchdistx_tpu/ops/pallas/flash_attention.py:{PALLAS_LINES[kernel]}",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }


def _kernels_line(rows, bwd_rows, launches, wide_stats):
    """The kernels line's entries: each kernel at its first row (the main
    paths' shapes) with ``launches(kernel)``; then each D = 256 instance
    that the D = 256 path launched, at phase 2's row of the path's own
    shape and dtype, with the launches of the path's part in that dtype."""
    first = {"flash_fwd": rows[0], **{r["kernel"]: r for r in reversed(bwd_rows)}}
    entries = [_kernel_entry(kernel, kernel, first[kernel], launches(kernel))
               for kernel in PALLAS_LINES]
    for dtype, shape in WIDE_PATH_SHAPES.items():
        dtype_name = str(dtype).replace("torch.", "")
        launched = wide_stats[f"launches_{'f32' if dtype == torch.float32 else 'bf16'}"]
        path_rows = {"flash_fwd": next(r for r in rows if r["shape"] == shape)}
        path_rows.update({r["kernel"]: r for r in bwd_rows if r["shape"] == shape})
        for kernel in PALLAS_LINES:
            if launched[kernel] == 0:
                continue
            _check(kernel in path_rows, f"D 256 path: no {dtype_name} row of {kernel}")
            entries.append(_kernel_entry(f"{kernel} (D 256, {dtype_name})", kernel,
                                         path_rows[kernel], {"head_dim_256": launched[kernel]}))
    return entries


def _path_entries(rows, bwd_rows, shape, label, path, launched):
    """The kernels line's entries for each kernel that ``path`` launched
    (``launched``), at phase 2's rows of ``shape``."""
    by_kernel = {"flash_fwd": next(r for r in rows if r["shape"] == shape)}
    by_kernel.update({r["kernel"]: r for r in bwd_rows if r["shape"] == shape})
    entries = []
    for kernel, n in launched.items():
        if n:
            _check(kernel in by_kernel, f"{path}: no {shape} row of {kernel}")
            entries.append(_kernel_entry(f"{kernel} ({label})", kernel, by_kernel[kernel],
                                         {path: n}))
    return entries


def _gpt2_entries(rows, bwd_rows, launched):
    """The kernels line's entries for the D 64 instances that the [gpt2] path
    launches, at phase 2's GPT2_HEADS rows, with the path's launches."""
    return _path_entries(rows, bwd_rows, GPT2_HEADS, "gpt2_xl heads, D 64", "gpt2", launched)


def _pipeline_entries(rows, bwd_rows, path_launches, rank_launches):
    """The kernels line's entries for the pipelines' microbatch blocks: the
    [pipeline] path's launches, then each [pipeline ranks] run's over the
    4 card ranks."""
    entries = _path_entries(rows, bwd_rows, PIPE_BLOCKS["pipeline"][1],
                            "pipeline microbatch block, llama_7b", "pipeline", path_launches)
    for key, launched in rank_launches.items():
        if PIPE_BLOCKS[key][1] is None:  # the ring: no kernel launched
            continue
        entries += _path_entries(rows, bwd_rows, PIPE_BLOCKS[key][1],
                                 f"pipeline ranks ({key}) block", f"pipeline_ranks_{key}",
                                 launched)
    return entries


def _slowmo_rank_entries(rows, bwd_rows, launches):
    """The kernels line's entries for [slowmo ranks]' kernel blocks, with
    each run's launches over the 4 card ranks."""
    return [entry for key, label in (("a", "slowmo rank block, llama_7b widths, dp=2 x tp=2"),
                                     ("b", "slowmo rank block, llama_test f32, dp=2 x fsdp=2"))
            for entry in _path_entries(rows, bwd_rows, SLOWMO_RANK_BLOCKS[key][1], label,
                                       f"slowmo_ranks_{key}", launches[key])]


def _mesh_rank_entries(rows, bwd_rows, launches):
    """The kernels line's entries for [mesh ranks]' kernel blocks, with each
    run's launches over the 4 card ranks (``launches["a"]``, ``["b"]``)."""
    return [entry for key, block, label in (
                ("a", "a", "mesh rank block, llama_7b widths"),
                ("b", "b", "mesh rank block, llama_test f32"),
                ("d", "b", "mesh rank block, llama_test f32, data/model mesh, custom loss"))
            for entry in _path_entries(rows, bwd_rows, MESH_RANK_BLOCKS[block][1], label,
                                       f"mesh_ranks_{key}", launches[key])]


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[env] TF32 off for matmuls and cuDNN; torch", torch.__version__,
          "cuda", torch.version.cuda, "python", sys.version.split()[0])
    t_start = time.perf_counter()

    from torchdistx_tpu_torch.models.llama import llama_7b
    from torchdistx_tpu_torch.ops.cuda import flash_attention as fa

    ptxas = phase_build()
    rows = phase_kernels()
    bwd_rows = phase_bwd_kernels()
    head_dim_stats = phase_head_dims(fa)
    _reset_counts(fa)  # the D = 256 path starts here
    wide_stats = phase_wide_llama(fa)
    wide_launches = _counts(fa)  # the D = 256 path ends here
    print(f"[head dims path] launches: {json.dumps(wide_launches)}")
    for kernel, n in wide_launches.items():
        _check(n > 0, f"{kernel} was not launched on the D = 256 path")
    _free()  # the forward path's allocation checks start from a settled heap

    cfg = llama_7b()
    _reset_counts(fa)  # the forward path starts here
    model, init_stats = phase_deferred_init(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device="cuda")
    logits, first_ms = phase_forward(model, tokens, fa)
    gen_stats = phase_generate(model, tokens)
    fwd_launches = _counts(fa)  # the forward path ends here
    _check(fwd_launches["flash_fwd"] > 0, "flash_fwd was not launched on the forward path")
    print(f"[forward path] launches: {json.dumps(fwd_launches)}")

    fwd_stats = check_forward_against_f32(model, tokens, logits)
    fwd_peak = torch.cuda.max_memory_allocated()
    del logits
    _free()

    _reset_counts(fa)  # the train path starts here
    train_stats = phase_train(cfg, fa, model)
    train_launches = _counts(fa)  # the train path ends here
    print(f"[train path] launches: {json.dumps(train_launches)}")
    for kernel, n in train_launches.items():
        _check(n > 0, f"{kernel} was not launched on the train path")
    del model
    _free()

    gate_stats = phase_train_gates(cfg)

    _reset_counts(fa)  # the fit path starts here
    fit_stats = phase_fit(cfg, fa)
    fit_launches = _counts(fa)  # the fit path ends here
    print(f"[fit path] launches: {json.dumps(fit_launches)}")
    for kernel in ("flash_fwd", "flash_bwd_fused"):
        _check(fit_launches[kernel] > 0, f"{kernel} was not launched on the fit path")

    mat_gate_stats = phase_materialize_gates(cfg)
    _free()

    _reset_counts(fa)  # the SlowMo path starts here
    slowmo_stats = phase_slowmo(cfg, fa)
    slowmo_launches = _counts(fa)  # the SlowMo path ends here
    print(f"[slowmo path] launches: {json.dumps(slowmo_launches)}")
    for kernel in ("flash_fwd", "flash_bwd_fused"):
        _check(slowmo_launches[kernel] > 0, f"{kernel} was not launched on the SlowMo path")
    _check(slowmo_launches["flash_bwd_dq"] == slowmo_launches["flash_bwd_dkv"] == 0,
           "the streamed pair was launched on the SlowMo path")
    replica_stats = phase_slowmo_replicas()
    replica_stats["ranks"] = phase_slowmo_ranks()
    _free()

    mesh_stats = phase_mesh(cfg, fa, train_stats)
    mesh_launches = mesh_stats["path_launches"]  # read around each mesh step
    print(f"[mesh path] launches: {json.dumps(mesh_launches)}")
    for kernel, n in mesh_launches.items():
        _check(n > 0, f"{kernel} was not launched on the mesh path")
    mesh_stats["ranks"] = phase_mesh_ranks(mesh_stats)
    _free()

    pipe_stats, pipe_refs = phase_pipeline(cfg, fa, train_stats)
    pipe_launches = pipe_stats["path_launches"]  # read around each pipeline step
    print(f"[pipeline path] launches: {json.dumps(pipe_launches)}")
    for kernel in ("flash_fwd", "flash_bwd_fused"):
        _check(pipe_launches[kernel] > 0, f"{kernel} was not launched on the pipeline path")
    pipe_stats["ranks"] = phase_pipeline_ranks(pipe_refs)
    del pipe_refs
    _free()

    from torchdistx_tpu_torch.models import gpt2, moe

    _reset_counts(fa)  # the GPT-2 path's forward part starts here
    model, tokens, logits, gpt2_stats = phase_gpt2(fa)
    gpt2_launches = _counts(fa)  # ... and ends here
    gpt2_stats["f32_check"] = check_forward_against_f32(
        model, tokens, logits, label="gpt2 forward", pair_slack=GPT2_PAIR_SLACK)
    del logits
    _free()
    _reset_counts(fa)  # the GPT-2 path's train part starts here
    gpt2_stats["train"] = phase_train(
        model.cfg, fa, model, family=gpt2, shapes=GPT2_TRAIN_SHAPES, label="gpt2 train",
        lr=GPT2_TRAIN_LR, watched=("wte.weight", "layers.0.attn_qkv.weight",
                 f"layers.{model.cfg.n_layers - 1}.mlp_proj.weight"))
    gpt2_launches = {k: v + gpt2_launches[k] for k, v in _counts(fa).items()}  # ends here
    print(f"[gpt2 path] launches: {json.dumps(gpt2_launches)}")
    for kernel in ("flash_fwd", "flash_bwd_fused"):
        _check(gpt2_launches[kernel] > 0, f"{kernel} was not launched on the GPT-2 path")
    _check(gpt2_launches["flash_bwd_dq"] == gpt2_launches["flash_bwd_dkv"] == 0,
           "the streamed pair was launched on the GPT-2 path")
    del model, tokens
    _free()
    gpt2_stats["gpt2_test"] = _family_on_card(fa, gpt2, gpt2.gpt2_test(), seed=13,
                                              label="gpt2")

    _reset_counts(fa)  # the MoE path starts here
    model, tokens, moe_stats = phase_moe(fa)
    moe_launches = _counts(fa)  # the MoE path ends here
    print(f"[moe path] launches: {json.dumps(moe_launches)}")
    for kernel, n in moe_launches.items():
        _check(n > 0, f"{kernel} was not launched on the MoE path")
    _moe_after(model, tokens, moe_stats)
    del model, tokens
    _free()
    moe_stats["moe_test"] = _family_on_card(fa, moe, moe.moe_test(), seed=14, label="moe")
    # moe_test again at a capacity factor that drops choices.
    moe_stats["moe_test_dropping"] = _family_on_card(
        fa, moe, dataclasses.replace(moe.moe_test(), capacity_factor=MOE_DROPPING_FACTOR),
        seed=14, label="moe")
    _check(sum(moe_stats["moe_test_dropping"]["dropped_choices_by_layer"]) > 0,
           "moe_test dropped no choice at its dropping capacity factor")
    _free()
    moe_stats["ep_ranks"] = phase_ep_ranks(phase_ep_reference())
    ep_launches = moe_stats["ep_ranks"]["launches_all_ranks"]
    _free()

    resnet_stats = phase_resnet()

    print("[summary] " + json.dumps({
        **init_stats, **gen_stats, **fwd_stats, "forward_first_ms": first_ms,
        "forward_path_peak_allocated_bytes": fwd_peak, "train": train_stats,
        "train_gates": gate_stats, "head_dims": head_dim_stats, "fit": fit_stats,
        "wide_llama": wide_stats, "materialize_gates": mat_gate_stats,
        "slowmo": slowmo_stats, "slowmo_replicas": replica_stats, "mesh": mesh_stats,
        "pipeline": pipe_stats, "resnet": resnet_stats, "gpt2": gpt2_stats,
        "moe": moe_stats, "ptxas_d512": {k: v for k, v in ptxas.items() if "(int)512" in k},
        "script_s": time.perf_counter() - t_start,
    }))

    def launches(kernel):
        return {"forward": fwd_launches[kernel], "train": train_launches[kernel],
                "fit": fit_launches[kernel], "slowmo": slowmo_launches[kernel],
                "mesh": mesh_launches[kernel], "moe": moe_launches[kernel],
                "ep_ranks_a": ep_launches["a"][kernel]}

    entries = (_kernels_line(rows, bwd_rows, launches, wide_stats)
               + _gpt2_entries(rows, bwd_rows, gpt2_launches)
               + _mesh_rank_entries(rows, bwd_rows, mesh_stats["ranks"]["launches_all_ranks"])
               + _pipeline_entries(rows, bwd_rows, pipe_launches,
                                   pipe_stats["ranks"]["launches_all_ranks"])
               + _path_entries(rows, bwd_rows, EP_BLOCKS["b"][1],
                               "ep rank block, MoEConfig() widths, fsdp=2 x ep=2", "ep_ranks_b",
                               ep_launches["b"])
               + _slowmo_rank_entries(rows, bwd_rows,
                                      replica_stats["ranks"]["launches_all_ranks"]))
    print(json.dumps({"kernels": entries}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--slowmo-replica"]:
        device, rank, store, out = sys.argv[2:6]
        slowmo_replica(device, int(rank), store, out)
        sys.exit(0)
    if sys.argv[1:2] == ["--mesh-rank"]:
        device, rank, store, out = sys.argv[2:6]
        mesh_rank(device, int(rank), store, out)
        sys.exit(0)
    if sys.argv[1:2] == ["--ep-rank"]:
        device, rank, store, out = sys.argv[2:6]
        ep_rank(device, int(rank), store, out)
        sys.exit(0)
    if sys.argv[1:2] == ["--slowmo-rank"]:
        device, rank, store, out = sys.argv[2:6]
        slowmo_rank(device, int(rank), store, out)
        sys.exit(0)
    if sys.argv[1:2] == ["--pipeline-rank"]:
        rank, store, out = sys.argv[2:5]
        pipeline_rank(int(rank), store, out)
        sys.exit(0)
    sys.exit(main())
