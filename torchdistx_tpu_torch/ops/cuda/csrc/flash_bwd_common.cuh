// Shared pieces of the flash-attention backward kernels for Hopper (sm_90a):
// flash_bwd_fused.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu include this file.
//
// Counterpart of torchdistx_tpu/ops/pallas/flash_attention.py:_recompute_p,
// _needs_mask and _p_ds: ONE definition of the backward block chain
//
//   p  = exp2(q.k^T * scale * log2 e - lse * log2 e),  0 on masked pairs
//   ds = p * (do.v^T - delta) * scale
//
// (p_ds below), so a change to the gradient identities cannot diverge
// between the kernels.  q.k^T and do.v^T accumulate in f32 from the storage
// dtype; ds is cast to q's dtype, and p to do's dtype, right before the
// products that take them; delta = rowsum(do * out) and lse arrive as f32
// (B, Hq, S).
//
// Masking: a pair is kept iff its q row and its kv column are both < S and,
// when causal, the column is <= the row.  Padded rows and columns are masked
// in the kernels themselves (no padding copies), which also covers the
// non-causal overflow hazard of the TPU kernel (p = exp(-lse) of a padded
// column overflowing f32).  needs_mask is the block-level test that lets
// interior tiles skip the per-pair compare.
//
// Also here: the mma.sync helpers, the launch helper for dynamic shared
// memory, and the kv-tile-outer kernel body (bwd_kv_bf16 / bwd_kv_f32) that
// the fused and the dk/dv kernels share.  The two differ only in kDq: the
// fused kernel adds dq = ds.k from the same p/ds (atomically, see
// flash_bwd_fused.cu), the dk/dv kernel does not.
//
// Layout: q, do, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D); contiguous,
// read and written in place.  GQA maps q head h to kv head h / (Hq / Hkv).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdx_bwd {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

using bf16 = __nv_bfloat16;

// Arguments of every backward kernel; pointers a kernel does not use are
// null.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, Hq, S), natural log
  const float* delta;  // (B, Hq, S)
  float* dq_acc;       // fused: f32 (B, S, Hq, D), zeroed by the caller
  void* dq;            // dq kernel: (B, S, Hq, D) in q's dtype
  void* dk;
  void* dv;
  int S, Hq, Hkv, causal;
  float scale, scale_log2;
};

// _needs_mask: the tile [q0, q0 + bq) x [k0, k0 + bk) holds a ragged row or
// column, or crosses the causal diagonal (worst pair: first row, last col).
__device__ __forceinline__ bool needs_mask(int causal, int q0, int bq, int k0,
                                           int bk, int S) {
  return q0 + bq > S || k0 + bk > S || (causal && k0 + bk - 1 > q0);
}

__device__ __forceinline__ bool keep_pair(int causal, int row, int col,
                                          int S) {
  return row < S && col < S && (!causal || col <= row);
}

// _recompute_p + _p_ds for one (q row, kv col) pair.  s: the f32 q.k dot;
// dp: the f32 do.v dot, replaced by ds; lse2 = lse * log2 e.  Returns p.
__device__ __forceinline__ float p_ds(float s, float& dp, float lse2,
                                      float delta, bool keep, float scale,
                                      float scale_log2) {
  const float p = keep ? exp2f(s * scale_log2 - lse2) : 0.f;
  dp = p * (dp - delta) * scale;
  return p;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b for a 16x16 (row) by 16x8 (col) bf16 tile, f32 accumulate.
// Fragments (g = lane / 4, t = lane % 4): a0 (row g, cols 2t, 2t+1), a1 (row
// g+8), a2 (cols +8), a3 (both); b0 (rows 2t, 2t+1, col g), b1 (rows +8);
// c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of the kk-th 16-wide k slice, taken from two 16x8 f32
// accumulator tiles (2kk and 2kk + 1) and rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&lo)[4],
                                         const float (&hi)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

// Launch with `smem` bytes of dynamic shared memory (above 48 KB only after
// the opt-in attribute); returns cudaGetLastError().
template <typename Kernel>
int launch_dyn(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
               const BwdArgs& args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// kv-tile-outer body, bf16: one block per (kv tile of 64, kv head, batch);
// 4 warps, each owning 16 kv rows.  K and V stay in shared memory; the block
// loops over (GQA group, q tile of 32) from the causal diagonal on, and per
// pair computes S^T = K.Q^T and dP^T = V.dO^T (16 x 32 per warp, on the
// tensor cores), p and ds in registers, then dV += P^T.dO and dK += dS^T.Q
// with the accumulator fragments reused as A operands; dk and dv stay in
// f32 registers until the end.  kDq adds dQ = dS.K: ds goes to shared
// memory q-major, each warp takes 16 q rows x D/2 columns of the product,
// and adds it to the f32 dq buffer with atomics.

template <int D>
struct KvTileBf16 {
  static constexpr int BK = 64, BQ = 32, LD = D + 8, LDS = BK + 8;
  static constexpr size_t smem(bool with_dq) {
    return 2 * BQ * sizeof(float) +
           (2 * BK * LD + 2 * BQ * LD + (with_dq ? BQ * LDS : 0)) *
               sizeof(bf16);
  }
};

template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads) bwd_kv_bf16(const BwdArgs a) {
  using T = KvTileBf16<D>;
  constexpr int BK = T::BK, BQ = T::BQ, LD = T::LD, LDS = T::LDS;
  static_assert(BK == 16 * (kThreads / 32), "one 16-row slice per warp");
  static_assert(BQ == 32, "the dq split assumes 2 x 16 q rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lse_s = reinterpret_cast<float*>(smem_raw);
  float* delta_s = lse_s + BQ;
  bf16* ks = reinterpret_cast<bf16*>(delta_s + BQ);
  bf16* vs = ks + BK * LD;
  bf16* qs = vs + BK * LD;
  bf16* dos = qs + BQ * LD;
  bf16* dss = dos + BQ * LD;  // kDq only: dS, q-major

  const int S = a.S, G = a.Hq / a.Hkv;
  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr_l = warp * 16 + g;  // this thread's kv rows: kr_l, kr_l + 8
  const size_t q_rs = static_cast<size_t>(a.Hq) * D;
  const size_t kv_rs = static_cast<size_t>(a.Hkv) * D;
  const bf16* kb = static_cast<const bf16*>(a.k) +
                   static_cast<size_t>(b) * S * kv_rs + hk * D;
  const bf16* vb = static_cast<const bf16*>(a.v) +
                   static_cast<size_t>(b) * S * kv_rs + hk * D;

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

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const bf16* qb = static_cast<const bf16*>(a.q) +
                     static_cast<size_t>(b) * S * q_rs + h * D;
    const bf16* dob = static_cast<const bf16*>(a.dout) +
                      static_cast<size_t>(b) * S * q_rs + h * D;
    const float* lseb = a.lse + (static_cast<size_t>(b) * a.Hq + h) * S;
    const float* deltab = a.delta + (static_cast<size_t>(b) * a.Hq + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous pair's readers are done
      for (int i = threadIdx.x; i < BQ * D / 8; i += kThreads) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        uint4 qx = make_uint4(0u, 0u, 0u, 0u), dx = qx;
        if (q0 + r < S) {
          const size_t off = static_cast<size_t>(q0 + r) * q_rs + c;
          qx = *reinterpret_cast<const uint4*>(qb + off);
          dx = *reinterpret_cast<const uint4*>(dob + off);
        }
        *reinterpret_cast<uint4*>(qs + r * LD + c) = qx;
        *reinterpret_cast<uint4*>(dos + r * LD + c) = dx;
      }
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lseb[row] * kLog2e : 0.f;
        delta_s[threadIdx.x] = row < S ? deltab[row] : 0.f;
      }
      __syncthreads();

      // S^T = K.Q^T and dP^T = V.dO^T: BQ / 8 tiles of 16 kv rows x 8 q cols.
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* kp = ks + kr_l * LD + kk * 16 + 2 * t;
        const bf16* vp = vs + kr_l * LD + kk * 16 + 2 * t;
        const uint32_t ka[4] = {ld32(kp), ld32(kp + 8 * LD), ld32(kp + 8),
                                ld32(kp + 8 * LD + 8)};
        const uint32_t va[4] = {ld32(vp), ld32(vp + 8 * LD), ld32(vp + 8),
                                ld32(vp + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const bf16* qp = qs + (j * 8 + g) * LD + kk * 16 + 2 * t;
          const bf16* dp = dos + (j * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16(st[j], ka, ld32(qp), ld32(qp + 8));
          mma_bf16(dpt[j], va, ld32(dp), ld32(dp + 8));
        }
      }

      // p into st, ds into dpt.
      const bool mask = needs_mask(a.causal, q0, BQ, k0, BK, S);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          const int kr = k0 + kr_l + (e >= 2 ? 8 : 0);
          const bool keep = !mask || keep_pair(a.causal, q0 + qc, kr, S);
          st[j][e] = p_ds(st[j][e], dpt[j][e], lse_s[qc], delta_s[qc], keep,
                          a.scale, a.scale_log2);
        }
      }

      // dV += P^T.dO and dK += dS^T.Q; the k dimension is the q rows.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(st[2 * kk], st[2 * kk + 1], pa);
        acc_to_a(dpt[2 * kk], dpt[2 * kk + 1], sa);
        const bf16* d0 = dos + (kk * 16 + 2 * t) * LD + g;
        const bf16* q0p = qs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const bf16* dp = d0 + n * 8;
          const bf16* qp = q0p + n * 8;
          mma_bf16(dv_acc[n], pa, pack_bf16(dp[0], dp[LD]),
                   pack_bf16(dp[8 * LD], dp[9 * LD]));
          mma_bf16(dk_acc[n], sa, pack_bf16(qp[0], qp[LD]),
                   pack_bf16(qp[8 * LD], qp[9 * LD]));
        }
      }

      if constexpr (kDq) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = j * 8 + 2 * t + (e & 1);
            dss[qc * LDS + kr_l + (e >= 2 ? 8 : 0)] =
                __float2bfloat16_rn(dpt[j][e]);
          }
        }
        __syncthreads();
        // dQ (BQ x D) = dS (BQ x BK) . K (BK x D): warp -> 16 rows x D / 2.
        const int mt = warp & 1, nh = warp >> 1;
        float acc[D / 16][4];
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const bf16* ap = dss + (mt * 16 + g) * LDS + kk * 16 + 2 * t;
          const uint32_t da[4] = {ld32(ap), ld32(ap + 8 * LDS), ld32(ap + 8),
                                  ld32(ap + 8 * LDS + 8)};
          const bf16* k0p = ks + (kk * 16 + 2 * t) * LD + nh * (D / 2) + g;
#pragma unroll
          for (int n = 0; n < D / 16; ++n) {
            const bf16* kp = k0p + n * 8;
            mma_bf16(acc[n], da, pack_bf16(kp[0], kp[LD]),
                     pack_bf16(kp[8 * LD], kp[9 * LD]));
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + mt * 16 + g + 8 * r;
          if (row >= S) continue;
          float* dst = a.dq_acc + (static_cast<size_t>(b) * S + row) * q_rs +
                       h * D + nh * (D / 2) + 2 * t;
#pragma unroll
          for (int n = 0; n < D / 16; ++n) {
            atomicAdd(dst + n * 8, acc[n][2 * r]);
            atomicAdd(dst + n * 8 + 1, acc[n][2 * r + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = k0 + kr_l + 8 * r;
    if (kr >= S) continue;
    const size_t off = (static_cast<size_t>(b) * S + kr) * kv_rs + hk * D + 2 * t;
    bf16* dkr = static_cast<bf16*>(a.dk) + off;
    bf16* dvr = static_cast<bf16*>(a.dv) + off;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvr + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// kv-tile-outer body, f32 on the CUDA cores: one block per (kv tile of 32,
// kv head, batch), looping over (GQA group, q tile of 16).  Per pair:
// (A) warp w computes p and ds for q rows 4w..4w+3, one lane per kv column,
// into shared memory; (B) warp w accumulates dV and dK for kv rows
// 8w..8w+7, one lane per 32nd output column, in registers; (C, kDq) warp w
// forms dQ for q rows 4w..4w+3 and adds it to the f32 dq buffer with
// atomics.

template <int D>
struct KvTileF32 {
  static constexpr int BK = 32, BQ = 16, LDK = D + 1, LDP = BK + 1;
  static constexpr size_t smem() {
    return (2 * BQ + 2 * BQ * D + 2 * BK * LDK + 2 * BQ * LDP) * sizeof(float);
  }
};

template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads) bwd_kv_f32(const BwdArgs a) {
  using T = KvTileF32<D>;
  constexpr int BK = T::BK, BQ = T::BQ, LDK = T::LDK, LDP = T::LDP;
  constexpr int DPL = D / 32, RPW = BQ / (kThreads / 32),
                KPW = BK / (kThreads / 32);
  extern __shared__ float smf[];
  float* lse_s = smf;
  float* delta_s = lse_s + BQ;
  float* qs = delta_s + BQ;
  float* dos = qs + BQ * D;
  float* ks = dos + BQ * D;
  float* vs = ks + BK * LDK;
  float* ps = vs + BK * LDK;
  float* dss = ps + BQ * LDP;

  const int S = a.S, G = a.Hq / a.Hkv;
  const int hk = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_rs = static_cast<size_t>(a.Hq) * D;
  const size_t kv_rs = static_cast<size_t>(a.Hkv) * D;
  const float* kb = static_cast<const float*>(a.k) +
                    static_cast<size_t>(b) * S * kv_rs + hk * D;
  const float* vb = static_cast<const float*>(a.v) +
                    static_cast<size_t>(b) * S * kv_rs + hk * D;

  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < S;
    const size_t off = static_cast<size_t>(k0 + r) * kv_rs + c;
    ks[r * LDK + c] = in ? kb[off] : 0.f;
    vs[r * LDK + c] = in ? vb[off] : 0.f;
  }

  float dk_acc[KPW][DPL], dv_acc[KPW][DPL];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;
  }

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const float* qb = static_cast<const float*>(a.q) +
                      static_cast<size_t>(b) * S * q_rs + h * D;
    const float* dob = static_cast<const float*>(a.dout) +
                       static_cast<size_t>(b) * S * q_rs + h * D;
    const float* lseb = a.lse + (static_cast<size_t>(b) * a.Hq + h) * S;
    const float* deltab = a.delta + (static_cast<size_t>(b) * a.Hq + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const bool in = q0 + r < S;
        const size_t off = static_cast<size_t>(q0 + r) * q_rs + c;
        qs[i] = in ? qb[off] : 0.f;
        dos[i] = in ? dob[off] : 0.f;
      }
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lseb[row] * kLog2e : 0.f;
        delta_s[threadIdx.x] = row < S ? deltab[row] : 0.f;
      }
      __syncthreads();

      // (A) p and ds for (q row, kv col = lane).
      const bool mask = needs_mask(a.causal, q0, BQ, k0, BK, S);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int qr = warp * RPW + rr;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[qr * D + d], ks[lane * LDK + d], s);
          dp = fmaf(dos[qr * D + d], vs[lane * LDK + d], dp);
        }
        const bool keep = !mask || keep_pair(a.causal, q0 + qr, k0 + lane, S);
        ps[qr * LDP + lane] =
            p_ds(s, dp, lse_s[qr], delta_s[qr], keep, a.scale, a.scale_log2);
        dss[qr * LDP + lane] = dp;
      }
      __syncthreads();

      // (B) dV += P^T.dO, dK += dS^T.Q for kv rows KPW * warp + j.
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        const int r = warp * KPW + j;
#pragma unroll 4
        for (int q = 0; q < BQ; ++q) {
          const float pv = ps[q * LDP + r], sv = dss[q * LDP + r];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            dv_acc[j][i] = fmaf(pv, dos[q * D + lane + 32 * i], dv_acc[j][i]);
            dk_acc[j][i] = fmaf(sv, qs[q * D + lane + 32 * i], dk_acc[j][i]);
          }
        }
      }

      if constexpr (kDq) {
        // (C) dQ = dS.K for q rows RPW * warp + rr.
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          const int qr = warp * RPW + rr, row = q0 + qr;
          float acc[DPL];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
#pragma unroll 8
          for (int c = 0; c < BK; ++c) {
            const float sv = dss[qr * LDP + c];
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
              acc[i] = fmaf(sv, ks[c * LDK + lane + 32 * i], acc[i]);
            }
          }
          if (row < S) {
            float* dst = a.dq_acc + (static_cast<size_t>(b) * S + row) * q_rs +
                         h * D + lane;
#pragma unroll
            for (int i = 0; i < DPL; ++i) atomicAdd(dst + 32 * i, acc[i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const int kr = k0 + warp * KPW + j;
    if (kr >= S) continue;
    const size_t off = (static_cast<size_t>(b) * S + kr) * kv_rs + hk * D + lane;
    float* dkr = static_cast<float*>(a.dk) + off;
    float* dvr = static_cast<float*>(a.dv) + off;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      dkr[32 * i] = dk_acc[j][i];
      dvr[32 * i] = dv_acc[j][i];
    }
  }
}

// Hopper grants a block at most 227 KB of shared memory.  The tiles do not
// grow with S, so a kernel that fits here fits every shape.
constexpr size_t kMaxSmem = 227 * 1024;
static_assert(KvTileBf16<128>::smem(true) <= kMaxSmem, "bf16 tile too large");
static_assert(KvTileF32<128>::smem() <= kMaxSmem, "f32 tile too large");

// Launches the kv-tile-outer kernel for (dtype, D); kDq selects the fused
// variant.  dtype: 0 = float32, 1 = bfloat16.
template <bool kDq>
int launch_kv(const BwdArgs& args, int B, int D, int dtype,
              cudaStream_t stream) {
  if (dtype == 1 && D == 64) {
    using T = KvTileBf16<64>;
    return launch_dyn(bwd_kv_bf16<64, kDq>,
                      dim3((args.S + T::BK - 1) / T::BK, args.Hkv, B),
                      T::smem(kDq), stream, args);
  }
  if (dtype == 1 && D == 128) {
    using T = KvTileBf16<128>;
    return launch_dyn(bwd_kv_bf16<128, kDq>,
                      dim3((args.S + T::BK - 1) / T::BK, args.Hkv, B),
                      T::smem(kDq), stream, args);
  }
  if (dtype == 0 && D == 64) {
    using T = KvTileF32<64>;
    return launch_dyn(bwd_kv_f32<64, kDq>,
                      dim3((args.S + T::BK - 1) / T::BK, args.Hkv, B),
                      T::smem(), stream, args);
  }
  if (dtype == 0 && D == 128) {
    using T = KvTileF32<128>;
    return launch_dyn(bwd_kv_f32<128, kDq>,
                      dim3((args.S + T::BK - 1) / T::BK, args.Hkv, B),
                      T::smem(), stream, args);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tdx_bwd
