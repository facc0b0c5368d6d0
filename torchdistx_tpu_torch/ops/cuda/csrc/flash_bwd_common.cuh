// Shared pieces of the flash-attention backward kernels for Hopper (sm_90a):
// flash_bwd_fused.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu include this file.
//
// Counterpart of torchdistx_tpu/ops/pallas/flash_attention.py:_recompute_p,
// _needs_mask and _p_ds: ONE definition of the backward block chain
//
//   p  = exp2(q.k^T * scale * log2 e - lse * log2 e),  0 on masked pairs
//   ds = p * (do.v^T - delta) * scale
//
// (p_ds below, and p_ds_fast, the same with the scale folded into delta,
// for the wgmma kernels), so a change to the gradient identities cannot
// diverge between the kernels.  q.k^T and do.v^T accumulate in f32 from
// the storage dtype; ds is cast to q's dtype, and p to do's dtype, right
// before the products that take them; delta = rowsum(do * out) and lse
// arrive as f32 (B, Hq, S).
//
// Masking: a pair is kept iff its q row and its kv column are both < S and,
// when causal, the column is <= the row.  Padded rows and columns are masked
// in the kernels themselves (no padding copies), which also covers the
// non-causal overflow hazard of the TPU kernel (p = exp(-lse) of a padded
// column overflowing f32).  needs_mask is the block-level test that lets
// interior tiles skip the per-pair compare.
//
// Also here: the steps that the two bf16 kv-tile kernels on wgmma share
// (flash_bwd_dkv.cu and flash_bwd_fused.cu: s^T and dp^T, p and ds into
// shared memory, the dk/dv accumulation), the launch helper for dynamic
// shared memory, and bwd_kv_f32, the f32 kv-tile-outer body on the CUDA
// cores that the dk/dv kernel and (with kDq, dq by atomics) the fused
// kernel run for f32.  The bf16 kernels are built on hopper.cuh.  What
// bounds the shared steps: a step's critical path is one warpgroup's p and
// ds (4,096 pairs, an exp2 each on the special-function unit) and then the
// accumulations that wait for them; knocking out half the tensor work saved
// less than knocking out p and ds, so this chain, not the tensor rate,
// holds the kv-tile kernels back (each source's header gives its bound).
//
// Layout: q, do, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D); contiguous,
// read and written in place.  GQA maps q head h to kv head h / (Hq / Hkv).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "storage.cuh"

namespace tdx_bwd {

namespace hw = tdx::hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

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

// 2^x by the special-function unit alone (exp2f adds a range check and two
// conditional multiplies).  Results below 2^-126 flush to 0, far under what
// p's bf16 rounding or the f32 sums can see.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p_ds for the wgmma kernels, whose p and ds are on the critical path: the
// same identities with delta_s = delta * scale taken once per row, so ds =
// p * (dp * scale - delta_s) is an FFMA and an FMUL, and exp2 by exp2_ftz.
// The pair (row, col) is tested only when the tile needs the mask, after
// the exp2 (in this order the wgmma kernels' loops compile tightest).
__device__ __forceinline__ float p_ds_fast(float s, float& dp, float lse2,
                                           float delta_s, bool mask,
                                           int causal, int row, int col,
                                           int S, float scale,
                                           float scale_log2) {
  float p = exp2_ftz(fmaf(s, scale_log2, -lse2));
  if (mask && !keep_pair(causal, row, col, S)) p = 0.f;
  dp = p * fmaf(dp, scale, -delta_s);
  return p;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The steps of the bf16 kv-tile kernels on wgmma (flash_bwd_dkv.cu and
// flash_bwd_fused.cu).  A block holds the k and v of 64 kv rows and streams
// q and do tiles of 64 rows, all as TMA writes them (hopper.cuh: D / 64
// chunks of 64 x 64, 128-byte swizzled).  A step (GQA head, q tile)
// computes s^T and dp^T (issue_st_dpt), then p and ds, which go to shared
// memory (p_ds_store) for the accumulations dv += p^T.do and dk += ds^T.q
// (issue_acc).

constexpr int kChunk = 64 * 128;  // bytes of one 64 x 64 bf16 chunk

// Issues s^T = k.q^T and dp^T = v.do^T for the 64 kv rows and the 64 q
// rows (wgmma m64n64k16, both operands K-major; not committed), each a new
// definition by its first wgmma.
template <int D>
__device__ __forceinline__ void issue_st_dpt(float (&s)[32], float (&dp)[32],
                                             uint32_t k_addr, uint32_t v_addr,
                                             uint32_t q_addr,
                                             uint32_t do_addr) {
  hw::wgmma_ss_init(s, hw::sw128_desc(k_addr, 16, 1024),
                    hw::sw128_desc(q_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
    hw::wgmma_ss(s, hw::sw128_desc(k_addr + off, 16, 1024),
                 hw::sw128_desc(q_addr + off, 16, 1024), 1);
  }
  hw::wgmma_ss_init(dp, hw::sw128_desc(v_addr, 16, 1024),
                    hw::sw128_desc(do_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
    hw::wgmma_ss(dp, hw::sw128_desc(v_addr + off, 16, 1024),
                 hw::sw128_desc(do_addr + off, 16, 1024), 1);
  }
}

// p = 2^(s scale log2 e - lse log2 e) and ds = p (dp scale - delta scale)
// of one step (lse_st and delta_st hold the q tile's lse log2 e and delta
// scale), 0 on masked pairs (p_ds_fast); column qc of the tile is q row q0 +
// qc, this thread's kv rows are k0 + 16 (warp % 4) + lane / 4 and that + 8.
// Then p and ds in bf16 into the step's buffer (p at pb, ds one chunk on),
// four 8 x 8 blocks a stmatrix, laid out as the 128-byte swizzle of a
// K-major operand: kv row r at byte r * 128, the 16-byte group of q columns
// 8 c .. 8 c + 7 at (c ^ r % 8) * 16.
__device__ __forceinline__ void p_ds_store(const float (&s)[32],
                                           float (&dp)[32],
                                           const float* lse_st,
                                           const float* delta_st, bool mask,
                                           int causal, int q0, int k0, int S,
                                           float scale, float scale_log2,
                                           uint8_t* pb, int warp, int lane) {
  const int t = lane % 4;
  const int row = 16 * (warp % 4) + lane / 4;
  uint32_t pk[16], dsk[16];  // block (j, r): kv rows row + 8 r, cols 8 j..
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qc = 8 * j + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(lse_st + qc);
    const float2 dl = *reinterpret_cast<const float2*>(delta_st + qc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * r + c;
        ds[c] = dp[e];
        p[c] = p_ds_fast(s[e], ds[c], c ? l2.y : l2.x, c ? dl.y : dl.x, mask,
                         causal, q0 + qc + c, k0 + row + 8 * r, S, scale,
                         scale_log2);
      }
      pk[2 * j + r] = pack_f32(p[0], p[1]);
      dsk[2 * j + r] = pack_f32(ds[0], ds[1]);
    }
  }
  // Lane l addresses row l % 8 of block (2 jp + l / 16, l / 8 % 2).
  const int m_row = 16 * (warp % 4) + lane % 8 + 8 * (lane / 8 % 2);
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    const int off = m_row * 128 + ((2 * jp + lane / 16) ^ (lane % 8)) * 16;
    const uint32_t pa = hw::smem_addr(pb + off);
    hw::stmatrix_x4(pa, pk[4 * jp], pk[4 * jp + 1], pk[4 * jp + 2],
                    pk[4 * jp + 3]);
    hw::stmatrix_x4(pa + kChunk, dsk[4 * jp], dsk[4 * jp + 1],
                    dsk[4 * jp + 2], dsk[4 * jp + 3]);
  }
}

// Issues acc += a^T.b over a step's 64 q rows (not committed): a is p or ds
// (64 kv rows x 64 q columns, K-major, from p_ds_store), b is do or q (64 q
// rows x D, MN-major, as TMA lays it out), so nothing is transposed.
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hw::wgmma_ss_mn(acc, hw::sw128_desc(a + kk * 32, 16, 1024),
                    hw::sw128_desc(b + kk * 16 * 128, kChunk, 1024));
  }
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
// kv-tile-outer body, f32 on the CUDA cores: one block per (kv tile of BK,
// kv head, batch), looping over (GQA group, q tile of 16).  Per pair:
// (A) warp w computes p and ds for q rows 4w..4w+3, one lane per kv column,
// into shared memory; (B) warp w accumulates dV and dK for kv rows
// BK/4 w..BK/4 w + BK/4 - 1, one lane per 32nd output column, in registers;
// (C, kDq) warp w forms dQ for q rows 4w..4w+3 and adds it to the f32 dq
// buffer with atomics.  Elem is the storage type (storage.cuh): float at D
// 64, 128, 256 and 512, bf16 at D 512 and, for the fused kernel (kDq), at
// D 256, where the wgmma kernels' dk and dv accumulators do not fit a
// consumer's registers (the bf16 dk/dv kernel at D 256 is
// flash_bwd_dkv_wgmma_wide, on wgmma); p and ds are
// rounded to Elem before the products that take them, and dk and dv to Elem
// on the store.  BK is 32 up to D 256; at D 512 it is 16, which keeps a
// lane's dk and dv accumulators at 2 x 4 rows x 16 columns (128 registers,
// as at D 256, where 32-row tiles would need 256) and the tiles at 130 KB;
// (A) then runs two q rows at once, half a warp on each.

template <int D>
struct KvTileF32 {
  static constexpr int BK = D > 256 ? 16 : 32, BQ = 16, LDK = D + 1,
                       LDP = BK + 1;
  static constexpr size_t smem() {
    return (2 * BQ + 2 * BQ * D + 2 * BK * LDK + 2 * BQ * LDP) * sizeof(float);
  }
};

template <typename Elem, int D, bool kDq>
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
  const Elem* kb = static_cast<const Elem*>(a.k) +
                   static_cast<size_t>(b) * S * kv_rs + hk * D;
  const Elem* vb = static_cast<const Elem*>(a.v) +
                   static_cast<size_t>(b) * S * kv_rs + hk * D;

  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < S;
    const size_t off = static_cast<size_t>(k0 + r) * kv_rs + c;
    ks[r * LDK + c] = in ? tdx::to_f32(kb[off]) : 0.f;
    vs[r * LDK + c] = in ? tdx::to_f32(vb[off]) : 0.f;
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
    const Elem* qb = static_cast<const Elem*>(a.q) +
                     static_cast<size_t>(b) * S * q_rs + h * D;
    const Elem* dob = static_cast<const Elem*>(a.dout) +
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
        qs[i] = in ? tdx::to_f32(qb[off]) : 0.f;
        dos[i] = in ? tdx::to_f32(dob[off]) : 0.f;
      }
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lseb[row] * kLog2e : 0.f;
        delta_s[threadIdx.x] = row < S ? deltab[row] : 0.f;
      }
      __syncthreads();

      // (A) p and ds for (q row, kv col = lane).
      const bool mask = needs_mask(a.causal, q0, BQ, k0, BK, S);
      if constexpr (BK == 32) {
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
          const float p =
              p_ds(s, dp, lse_s[qr], delta_s[qr], keep, a.scale, a.scale_log2);
          ps[qr * LDP + lane] = tdx::round_to<Elem>(p);
          dss[qr * LDP + lane] = tdx::round_to<Elem>(dp);
        }
      } else {
        // BK 16: half-warp h of the lanes takes q row rr + h, kv col lane % 16.
        static_assert(BK == 16 && RPW % 2 == 0, "two q rows a pass");
        const int col = lane % BK;
#pragma unroll
        for (int rr = 0; rr < RPW; rr += 2) {
          const int qr = warp * RPW + rr + lane / BK;
          float s = 0.f, dp = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) {
            s = fmaf(qs[qr * D + d], ks[col * LDK + d], s);
            dp = fmaf(dos[qr * D + d], vs[col * LDK + d], dp);
          }
          const bool keep = !mask || keep_pair(a.causal, q0 + qr, k0 + col, S);
          const float p =
              p_ds(s, dp, lse_s[qr], delta_s[qr], keep, a.scale, a.scale_log2);
          ps[qr * LDP + col] = tdx::round_to<Elem>(p);
          dss[qr * LDP + col] = tdx::round_to<Elem>(dp);
        }
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
    Elem* dkr = static_cast<Elem*>(a.dk) + off;
    Elem* dvr = static_cast<Elem*>(a.dv) + off;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      dkr[32 * i] = tdx::from_f32<Elem>(dk_acc[j][i]);
      dvr[32 * i] = tdx::from_f32<Elem>(dv_acc[j][i]);
    }
  }
}

// Hopper grants a block at most 227 KB of shared memory.  The tiles do not
// grow with S, so a kernel that fits here fits every shape.
constexpr size_t kMaxSmem = 227 * 1024;
static_assert(KvTileF32<256>::smem() <= kMaxSmem, "f32 tile too large");
static_assert(KvTileF32<512>::smem() <= kMaxSmem, "f32 tile too large");

template <typename Elem, int D, bool kDq>
int launch_kv_f32(const BwdArgs& args, int B, cudaStream_t stream) {
  using T = KvTileF32<D>;
  return launch_dyn(bwd_kv_f32<Elem, D, kDq>,
                    dim3((args.S + T::BK - 1) / T::BK, args.Hkv, B),
                    T::smem(), stream, args);
}

// Launches the kv-tile-outer body on the CUDA cores for (D, dtype): f32 at
// D 64, 128, 256 and 512, bf16 at D 512 and, fused, 256 (dtype 0 =
// float32, 1 = bfloat16; the bf16 kernels at D 64 and 128, and dk/dv's at
// 256, are on wgmma); kDq selects the fused variant.
template <bool kDq>
int launch_kv(const BwdArgs& args, int B, int D, int dtype,
              cudaStream_t stream) {
  if (dtype == 0 && D == 64) {
    return launch_kv_f32<float, 64, kDq>(args, B, stream);
  }
  if (dtype == 0 && D == 128) {
    return launch_kv_f32<float, 128, kDq>(args, B, stream);
  }
  if (dtype == 0 && D == 256) {
    return launch_kv_f32<float, 256, kDq>(args, B, stream);
  }
  if constexpr (kDq) {
    if (dtype == 1 && D == 256) {
      return launch_kv_f32<__nv_bfloat16, 256, kDq>(args, B, stream);
    }
  }
  if (dtype == 0 && D == 512) {
    return launch_kv_f32<float, 512, kDq>(args, B, stream);
  }
  if (dtype == 1 && D == 512) {
    return launch_kv_f32<__nv_bfloat16, 512, kDq>(args, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tdx_bwd
