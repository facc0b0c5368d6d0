// Streamed flash-attention backward, dq half, for Hopper (sm_90a), causal or
// not, with GQA.
//
// Replaces torchdistx_tpu/ops/pallas/flash_attention.py:_dq_kernel, the
// Pallas TPU kernel that _fa_backward_streamed launches beside _dkv_kernel
// for padded sequences above _FUSED_BWD_MAX_KV (2048).  Same function:
// dq = sum over kv blocks of ds.k, with p and ds recomputed from the saved
// lse (flash_bwd_common.cuh:p_ds), ds cast to q's dtype before the product.
//
// The TPU grid's sequential kv axis, which carries dq in VMEM scratch,
// becomes a loop inside one block per (q tile of 64, q head, batch) over kv
// tiles of 32 up to the causal diagonal; heaviest causal tiles launch first.
// Each block owns its dq rows, so nothing is summed across blocks: no
// atomics, and the result is the same bits on every run.
//
// bf16: 4 warps of 16 q rows; q and do stay in registers as A fragments, K
// and V tiles are staged in shared memory; S = Q.K^T and dP = dO.V^T on the
// tensor cores (mma.sync m16n8k16, f32 accumulate), then dQ += dS.K with the
// dS accumulator fragments reused as the A operand.  f32: CUDA cores, 16 q
// rows a block, one warp lane per kv column for the two dots and per 32nd
// output column for dS.K.
//
// What bounds it on an H100 SXM: at Llama-7B's max_seq_len (B 1, S 4096, 32
// heads, D 128, bf16, causal) it does 3 products of 2 D flops per causal
// pair, 206 GFLOP, 208 us at the 989 TFLOP/s dense bf16 rate, against
// 168 MB of q, k, v, do, dq, lse and delta, 50 us at 3.35 TB/s: bound by
// operations.  What this simple design leaves on the table: mma.sync instead
// of wgmma, synchronous K/V staging with no cp.async/TMA double-buffering,
// K's B fragments for dS.K gathered as 16-bit loads (ldmatrix.trans), the
// small 32-wide kv tile that keeps q, do, dq, S and dP in registers, and the
// recomputation of S and dP that the dk/dv kernel repeats.

#include "flash_bwd_common.cuh"

namespace tdx_bwd {
namespace {

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_bf16(const BwdArgs a) {
  constexpr int BQ = 64, BK = 32, LD = D + 8;
  __shared__ __align__(16) bf16 ks[BK * LD];
  __shared__ __align__(16) bf16 vs[BK * LD];

  const int S = a.S;
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = q_tile * BQ;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const size_t q_rs = static_cast<size_t>(a.Hq) * D;
  const size_t kv_rs = static_cast<size_t>(a.Hkv) * D;
  const bf16* qb = static_cast<const bf16*>(a.q) +
                   static_cast<size_t>(b) * S * q_rs + h * D;
  const bf16* dob = static_cast<const bf16*>(a.dout) +
                    static_cast<size_t>(b) * S * q_rs + h * D;
  const bf16* kb = static_cast<const bf16*>(a.k) +
                   static_cast<size_t>(b) * S * kv_rs + hk * D;
  const bf16* vb = static_cast<const bf16*>(a.v) +
                   static_cast<size_t>(b) * S * kv_rs + hk * D;

  // q and do rows stay in registers as A fragments for the whole kv loop.
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = row0 < S ? ld32(qb + row0 * q_rs + c) : 0u;
    qf[kk][1] = row1 < S ? ld32(qb + row1 * q_rs + c) : 0u;
    qf[kk][2] = row0 < S ? ld32(qb + row0 * q_rs + c + 8) : 0u;
    qf[kk][3] = row1 < S ? ld32(qb + row1 * q_rs + c + 8) : 0u;
    df[kk][0] = row0 < S ? ld32(dob + row0 * q_rs + c) : 0u;
    df[kk][1] = row1 < S ? ld32(dob + row1 * q_rs + c) : 0u;
    df[kk][2] = row0 < S ? ld32(dob + row0 * q_rs + c + 8) : 0u;
    df[kk][3] = row1 < S ? ld32(dob + row1 * q_rs + c + 8) : 0u;
  }
  const float* lseb = a.lse + (static_cast<size_t>(b) * a.Hq + h) * S;
  const float* deltab = a.delta + (static_cast<size_t>(b) * a.Hq + h) * S;
  const float lse2[2] = {row0 < S ? lseb[row0] * kLog2e : 0.f,
                         row1 < S ? lseb[row1] * kLog2e : 0.f};
  const float dl[2] = {row0 < S ? deltab[row0] : 0.f,
                       row1 < S ? deltab[row1] : 0.f};

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  }

  const int last_row = min(q0 + BQ, S) - 1;
  const int n_tiles = a.causal ? last_row / BK + 1 : (S + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < BK * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + r < S) {
        const size_t off = static_cast<size_t>(k0 + r) * kv_rs + c;
        kx = *reinterpret_cast<const uint4*>(kb + off);
        vx = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kx;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vx;
    }
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T: BK / 8 tiles of 16 q rows x 8 kv cols.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const bf16* kr = ks + (j * 8 + g) * LD + 2 * t;
      const bf16* vr = vs + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[j], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
        mma_bf16(dp[j], df[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
      }
    }

    // ds into dp.
    const bool mask = needs_mask(a.causal, q0, BQ, k0, BK, S);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = r ? row1 : row0;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool keep = !mask || keep_pair(a.causal, row, col, S);
        p_ds(s[j][e], dp[j][e], lse2[r], dl[r], keep, a.scale, a.scale_log2);
      }
    }

    // dQ += dS.K; the k dimension is the kv rows.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(dp[2 * kk], dp[2 * kk + 1], da);
      const bf16* k0p = ks + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* kp = k0p + n * 8;
        mma_bf16(dq[n], da, pack_bf16(kp[0], kp[LD]),
                 pack_bf16(kp[8 * LD], kp[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= S) continue;
    bf16* out = static_cast<bf16*>(a.dq) +
                (static_cast<size_t>(b) * S + row) * q_rs + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(dq[n][2 * r], dq[n][2 * r + 1]);
    }
  }
}

template <int D>
struct DqF32 {
  static constexpr int BQ = 16, BK = 32, LDK = D + 1;
  static constexpr size_t smem() {
    return (2 * BQ * D + 2 * BK * LDK) * sizeof(float);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_f32(const BwdArgs a) {
  using T = DqF32<D>;
  constexpr int BQ = T::BQ, BK = T::BK, LDK = T::LDK;
  constexpr int RPW = BQ / (kThreads / 32), DPL = D / 32;
  extern __shared__ float smf[];
  float* qs = smf;
  float* dos = qs + BQ * D;
  float* ks = dos + BQ * D;
  float* vs = ks + BK * LDK;

  const int S = a.S;
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = q_tile * BQ;
  const size_t q_rs = static_cast<size_t>(a.Hq) * D;
  const size_t kv_rs = static_cast<size_t>(a.Hkv) * D;
  const float* qb = static_cast<const float*>(a.q) +
                    static_cast<size_t>(b) * S * q_rs + h * D;
  const float* dob = static_cast<const float*>(a.dout) +
                     static_cast<size_t>(b) * S * q_rs + h * D;
  const float* kb = static_cast<const float*>(a.k) +
                    static_cast<size_t>(b) * S * kv_rs + hk * D;
  const float* vb = static_cast<const float*>(a.v) +
                    static_cast<size_t>(b) * S * kv_rs + hk * D;

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < S;
    const size_t off = static_cast<size_t>(q0 + r) * q_rs + c;
    qs[i] = in ? qb[off] : 0.f;
    dos[i] = in ? dob[off] : 0.f;
  }
  const float* lseb = a.lse + (static_cast<size_t>(b) * a.Hq + h) * S;
  const float* deltab = a.delta + (static_cast<size_t>(b) * a.Hq + h) * S;
  float lse2[RPW], dl[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = q0 + warp * RPW + rr;
    lse2[rr] = row < S ? lseb[row] * kLog2e : 0.f;
    dl[rr] = row < S ? deltab[row] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int last_row = min(q0 + BQ, S) - 1;
  const int n_tiles = a.causal ? last_row / BK + 1 : (S + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const size_t off = static_cast<size_t>(k0 + r) * kv_rs + c;
      ks[r * LDK + c] = in ? kb[off] : 0.f;
      vs[r * LDK + c] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    const bool mask = needs_mask(a.causal, q0, BQ, k0, BK, S);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int lr = warp * RPW + rr, row = q0 + lr;
      float s = 0.f, ds = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[lr * D + d], ks[lane * LDK + d], s);
        ds = fmaf(dos[lr * D + d], vs[lane * LDK + d], ds);
      }
      const bool keep = !mask || keep_pair(a.causal, row, k0 + lane, S);
      p_ds(s, ds, lse2[rr], dl[rr], keep, a.scale, a.scale_log2);
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        const float dsc = __shfl_sync(0xffffffffu, ds, c);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          acc[rr][i] = fmaf(dsc, ks[c * LDK + lane + 32 * i], acc[rr][i]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = q0 + warp * RPW + rr;
    if (row >= S) continue;
    float* out = static_cast<float*>(a.dq) +
                 (static_cast<size_t>(b) * S + row) * q_rs + h * D + lane;
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[32 * i] = acc[rr][i];
  }
}

template <typename Kernel>
int launch_dq(Kernel kernel, int bq, size_t smem, const BwdArgs& args, int B,
              cudaStream_t stream) {
  return launch_dyn(kernel, dim3((args.S + bq - 1) / bq, args.Hq, B), smem,
                    stream, args);
}

}  // namespace
}  // namespace tdx_bwd

// Launches the dq kernel on `stream`; returns cudaGetLastError() (0 on
// success).  dtype: 0 = float32, 1 = bfloat16.  The caller checks shapes,
// contiguity and alignment; this checks only what selects a kernel.
extern "C" int tdx_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int S,
                                int Hq, int Hkv, int D, int dtype, int causal,
                                float scale, float scale_log2, void* stream) {
  using namespace tdx_bwd;
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  BwdArgs args{};
  args.q = q;
  args.k = k;
  args.v = v;
  args.dout = dout;
  args.lse = static_cast<const float*>(lse);
  args.delta = static_cast<const float*>(delta);
  args.dq = dq;
  args.S = S;
  args.Hq = Hq;
  args.Hkv = Hkv;
  args.causal = causal;
  args.scale = scale;
  args.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return launch_dq(bwd_dq_bf16<64>, 64, 0, args, B, st);
  if (dtype == 1 && D == 128) return launch_dq(bwd_dq_bf16<128>, 64, 0, args, B, st);
  if (dtype == 0 && D == 64) {
    return launch_dq(bwd_dq_f32<64>, DqF32<64>::BQ, DqF32<64>::smem(), args, B, st);
  }
  if (dtype == 0 && D == 128) {
    return launch_dq(bwd_dq_f32<128>, DqF32<128>::BQ, DqF32<128>::smem(), args, B, st);
  }
  return cudaErrorInvalidValue;
}
