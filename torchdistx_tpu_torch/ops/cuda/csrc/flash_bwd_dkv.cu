// Streamed flash-attention backward, dk/dv half, for Hopper (sm_90a),
// causal or not, with GQA.
//
// Replaces torchdistx_tpu/ops/pallas/flash_attention.py:_dkv_kernel, the
// Pallas TPU kernel that _fa_backward_streamed launches beside _dq_kernel
// for padded sequences above _FUSED_BWD_MAX_KV (2048).  Same function:
// dk = sum ds^T.q and dv = sum p^T.do per kv block over (GQA group, q block)
// pairs, p and ds recomputed from the saved lse (flash_bwd_common.cuh:p_ds).
//
// The TPU grid's sequential (group, q block) axis, which carries dk/dv in
// VMEM scratch, becomes a loop inside one block per (kv tile of 64, kv head,
// batch) that starts at the causal diagonal (the TPU's _diag_clamp is DMA
// elision and reduces to that bound); dk and dv stay in f32 registers.  It
// is the fused kernel's body (flash_bwd_common.cuh:bwd_kv_bf16/bwd_kv_f32)
// without the dq product, so nothing is summed across blocks: no atomics,
// and the result is the same bits on every run.
//
// What bounds it on an H100 SXM: at Llama-7B's max_seq_len (B 1, S 4096, 32
// heads, D 128, bf16, causal) it does 4 products of 2 D flops per causal
// pair, 275 GFLOP, 278 us at the 989 TFLOP/s dense bf16 rate, against
// 202 MB of q, k, v, do, dk, dv, lse and delta, 60 us at 3.35 TB/s: bound
// by operations.  What this simple design leaves on the table: mma.sync
// instead of wgmma, synchronous staging of each q/do tile with no
// cp.async/TMA double-buffering, 16-bit gathers of the B fragments, the
// small 32-row q tile, and the recomputation of S and dP that the dq kernel
// repeats (the price of two deterministic kernels).

#include "flash_bwd_common.cuh"

// Launches the dk/dv kernel on `stream`; returns cudaGetLastError() (0 on
// success).  dtype: 0 = float32, 1 = bfloat16.  The caller checks shapes,
// contiguity and alignment; this checks only what selects a kernel.
extern "C" int tdx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int S, int Hq, int Hkv, int D, int dtype,
                                 int causal, float scale, float scale_log2,
                                 void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  tdx_bwd::BwdArgs args{};
  args.q = q;
  args.k = k;
  args.v = v;
  args.dout = dout;
  args.lse = static_cast<const float*>(lse);
  args.delta = static_cast<const float*>(delta);
  args.dk = dk;
  args.dv = dv;
  args.S = S;
  args.Hq = Hq;
  args.Hkv = Hkv;
  args.causal = causal;
  args.scale = scale;
  args.scale_log2 = scale_log2;
  return tdx_bwd::launch_kv<false>(args, B, D, dtype,
                                   static_cast<cudaStream_t>(stream));
}
