// Fused flash-attention backward for Hopper (sm_90a): dq, dk and dv in one
// kernel, causal or not, with GQA.
//
// Replaces torchdistx_tpu/ops/pallas/flash_attention.py:_dqkv_fused_kernel,
// the Pallas TPU kernel launched by _fa_backward_fused_nk1, which the JAX
// backward takes when the padded sequence is at most _FUSED_BWD_MAX_KV
// (2048).  Same function: p and ds recomputed ONCE per (q, kv) pair from the
// saved lse (flash_bwd_common.cuh:p_ds) and fed to all three products,
// dq = ds.k, dk = ds^T.q and dv = p^T.do, with the GQA group summed inside
// the block.
//
// The TPU premise does not carry over.  There, one grid step holds the whole
// kv extent in VMEM and a sequential grid axis carries dk/dv accumulators
// over (group, q block) steps, which leaves each q block's dq complete after
// its own step.  Here K and V at S = 2048, D = 128 are 512 KB each in bf16
// against 227 KB of shared memory a block, and blocks run in parallel in no
// order.  So the design is the kv-tile-outer body of flash_bwd_common.cuh:
// one block per (kv tile of 64, kv head, batch) keeps dk and dv in f32
// registers and loops over (group, q tile) from the causal diagonal on; dq,
// which sums over kv tiles held by different blocks, goes into an f32 buffer
// with atomicAdd, and the caller casts it to q's dtype.  Atomics make dq's
// summation order, and so its last bits, change from run to run.
//
// The TPU working-set cap (_FUSED_BWD_VMEM_CAP, with its fall back to the
// streamed pair once even 128-row q blocks overflow VMEM) becomes the
// shared-memory budget, checked when the kernel is compiled: the block asks
// for a fixed amount that does not grow with S (57 KB bf16 / 54 KB f32 at
// D = 128, against the 227 KB a Hopper block may use; static_assert in
// flash_bwd_common.cuh), so no shape can exceed it and none fails at launch
// for it.  The fall back has no case left to take.
//
// What bounds it on an H100 SXM: at the Llama-7B training shape (B 4, S 512,
// 32 heads, D 128, bf16, causal) it must read q, k, v, do and write dq, dk,
// dv (7 x 16.8 MB) plus lse and delta, 118 MB, 35 us at 3.35 TB/s, against
// 5 products of 2 D flops per causal pair, 21.5 GFLOP, 22 us at 989
// TFLOP/s: bound by bytes.  What this simple design leaves on the table:
// the dq atomics (4 bytes of L2 traffic per product element and per kv
// tile), mma.sync instead of wgmma, synchronous staging with no
// cp.async/TMA double-buffering, B fragments gathered as 16-bit loads
// (ldmatrix.trans would do it in one instruction), and the 32-row q tile
// chosen to keep dk, dv, S and dP in registers without spilling.

#include "flash_bwd_common.cuh"

// Launches the fused backward on `stream`; returns cudaGetLastError() (0 on
// success).  dq_acc is f32 (B, S, Hq, D) and zeroed by the caller.  dtype:
// 0 = float32, 1 = bfloat16.  The caller checks shapes, contiguity and
// alignment; this checks only what selects a kernel.
extern "C" int tdx_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq_acc, void* dk,
                                   void* dv, int B, int S, int Hq, int Hkv,
                                   int D, int dtype, int causal, float scale,
                                   float scale_log2, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  tdx_bwd::BwdArgs args{};
  args.q = q;
  args.k = k;
  args.v = v;
  args.dout = dout;
  args.lse = static_cast<const float*>(lse);
  args.delta = static_cast<const float*>(delta);
  args.dq_acc = static_cast<float*>(dq_acc);
  args.dk = dk;
  args.dv = dv;
  args.S = S;
  args.Hq = Hq;
  args.Hkv = Hkv;
  args.causal = causal;
  args.scale = scale;
  args.scale_log2 = scale_log2;
  return tdx_bwd::launch_kv<true>(args, B, D, dtype,
                                  static_cast<cudaStream_t>(stream));
}
