// The f32 q-tile body for Hopper (sm_90a), on the CUDA cores:
// q_f32_tiled<D, kDq>, which flash_fwd.cu runs for the f32 forward (kDq
// false: out and lse) and flash_bwd_dq.cu for the f32 streamed dq (kDq
// true), at D 64, 128, 256 and 512.  Also here: launch_q_f32, the launch
// of both.  The counterpart of flash_bwd_kv_f32.cuh (the f32 dk/dv and
// fused body), with the loops turned around: a block owns a q tile and
// walks the kv tiles.
//
// Replaces torchdistx_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (pallas_call at :286) and _dq_kernel (:696) for float32 inputs.  Same
// function as the bf16 kernels (flash_fwd.cu's and flash_bwd_common.cuh's
// headers): per (q tile, q head, batch) block, a loop over the kv tiles up
// to the causal diagonal that forms s = q.k^T over D and
// - forward: the online softmax in the log2 domain (logits s * scale log2
//   e, masked ones the finite -1e30, running max m and sum l per row), o
//   rescaled by alpha = 2^(m_old - m_new) and o += p.v; out = o / l (l 0
//   guarded to 1), lse = m / log2 e + log l;
// - dq: dp = do.v^T, p and ds from lse and delta (flash_bwd_common.cuh's
//   p_ds), dq += ds.k.
// Every sum is f32 FMAs on the CUDA cores: no TF32, whose 10 mantissa bits
// the 1e-4 gates against the plain version would see.  p and ds are f32,
// the storage type, so rounding them to it before their products changes
// nothing.  The kv loop is not split: each block owns its rows and sums
// them in a fixed order, so out, lse and dq are the same bits on every
// call.
//
// What bounds it on an H100 SXM: its products of 2 D flops a kept pair (2
// forward, 3 dq) against 67 TFLOP/s of f32 FMA outside the tensor cores
// (PEAK_OPS_PER_S in chip_smoke.py).  At the f32 train gates' 4 x 512, 32
// heads of 128, causal: 8.6 GFLOP forward, 0.1285 ms; dq 0.1927 ms; the
// bytes take less.  Operations bound it at every shape the port runs but
// the tiny ones (2 x 32, 2 x 64), where bytes and the launch do.  On an
// NVIDIA H100 80GB HBM3 at 700 W it takes 0.3275 ms (forward, 39 % of the
// bound) and 0.4679 ms (dq, 41 %) there (chip_smoke.py, PERF.md).
//
// The CUDA-core bodies this replaces reached 4-24 % of that bound (PERF.md,
// run 20g): a lane formed one pair's dot product over D, two
// scalar shared loads an FMA; p.v and ds.k took one shared load an FMA; a
// kv tile was loaded, widened and stored between two barriers with nothing
// in flight; and 16 q rows a block re-read k and v S / 16 times.  Here:
//
// 1. Register blocking from 16-byte shared loads.  s (and dp) are 4 x 4
//    (q row x kv column) pairs a thread, rows rg + RG i and columns cg + CG
//    j, each load of 4 d values of a q or k row feeding 16 FMAs, over Z
//    slices of D (interleaved 4-column chunks) whose partial sums go through
//    shared memory and are added in slice order; a warp covers 8 x 4 of
//    those blocks where the tile allows, the fewest distinct rows a load
//    can touch.  p (or ds) is written over the partials, then o += p.v (dq
//    += ds.k) runs as 4 x CC blocks of a thread (rows 4 rg2 .. + 3,
//    columns 4 cg2 + 4 NCG m ..), one float4 of p a row and CC / 4 of v a
//    kv row.  Tile rows are padded (LDX, LDR) so that a warp's loads and
//    stores hit distinct banks.
// 2. The softmax (forward) or p and ds (dq) by TPR neighbouring lanes a q
//    row, each holding PPT of its columns: the row max reduced by
//    shuffles, each lane's part of l kept and summed at the end (alpha is
//    the row's, so the parts rescale alike); alpha goes to shared memory
//    for the o rows' owners, which skip the rescale where a row keeps its
//    max (alpha exactly 1).  dq reads its rows' lse and delta once.
// 3. A cp.async ring of two stages for k and v (16 bytes a copy, zero-
//    filled past S): tile j + 1 lands while tile j's products run.
// 4. q tiles of 64 rows at D 64 and 128 (k and v read from L2 S / 64
//    times), 32 at D 256 and 16 at D 512, where a 64-row tile would give
//    [head dims]' 2 x 300, 8 heads only 80 blocks for 132 SMs, and o or dq
//    would not fit the registers.  The grid's slowest axis is the q tile,
//    from the last, so the heaviest causal tiles start first; the fastest
//    is the q head, so the heads of a GQA group run side by side and share
//    their k and v in L2.
//
// Tiles (QF32Tiles): 256 threads; q x kv tiles 64 x 64 (forward) and 64 x
// 32 (dq) at D 64 and 128, 32 x 32 at D 256, 16 x 16 at D 512; o or dq 16
// floats a thread at D 64, 32 above.  Two blocks an SM at D 64 (at most
// 128 registers), one above.  No block takes more than 216 KB of shared
// memory.
//
// What sets the pace (scripts/torch_d256_ab.py --dtype f32 on an H100,
// knock-outs that give wrong values and the time only, PERF.md): at D 64
// and 128 the two products, s's shared loads and its FMAs each near their
// limit (either alone knocked out takes 3-8 % off, both 40 %; p.v 25 %);
// the softmax and the barriers take at most 2 %, the k and v refills 3 %.
// At D 256 and 512 the k and v traffic from L2 does (both products knocked
// out leave 64-80 % of the time).  Tried and dropped there: 8 x 8 s blocks
// on 128-row q tiles (half the loads an FMA: no faster at D 128, 11 %
// slower at D 64), 64 x 32 forward tiles at two blocks an SM (7 % slower),
// 32-row q tiles at D 512 (12 % slower).

#pragma once

#include <limits.h>

#include "flash_bwd_common.cuh"

namespace tdx_qf32 {

namespace hw = tdx::hopper;
using tdx_bwd::keep_pair;
using tdx_bwd::kLog2e;
using tdx_bwd::needs_mask;

constexpr float kMask = -1e30f;  // a masked logit (flash_fwd.cu's header)

// Arguments of both kernels: q, k, v (B, S, H, D) f32; dq also do, delta
// and lse (B, Hq, S); the forward writes out and lse, dq writes out (dq).
struct QF32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // dq only
  const float* delta;  // dq only
  float* lse;          // forward: written; dq: read
  float* out;          // forward: out; dq: dq
  int S, Hq, Hkv, causal;
  float scale, scale_log2;
};

template <int D, bool kDq>
struct QF32Tiles {
  static constexpr int NT = 256;  // threads
  static constexpr int BQ = D <= 128 ? 64 : D == 256 ? 32 : 16;
  static constexpr int BK = D == 512 ? 16 : D == 256 || kDq ? 32 : 64;
  static constexpr int NP = kDq ? 2 : 1;  // products over D: s (and dp)
  // (1) s (kind 0, from q and k) and dp (kind 1, from do and v): RI x CJ
  // pairs a thread, q rows rg + RG i, kv columns cg + CG j, over Z slices
  // of D; a warp's threads are WRG row groups by 32 / WRG column groups.
  static constexpr int RI = 4, CJ = 4;
  static constexpr int RG = BQ / RI, CG = BK / CJ, MT = RG * CG;
  static constexpr int Z = NT / (NP * MT);
  static constexpr int WRG = RG < 8 ? RG : 8;
  // (2) p and ds: PPT columns t + TPR e of q row tid / TPR a thread.
  static constexpr int PPT = BQ * BK / NT, TPR = BK / PPT;
  // (3) o or dq: rows RR rg2 .. RR rg2 + RR - 1, columns 4 cg2 + 4 NCG m +
  // e (CC of them) of a thread.
  static constexpr int RR = 4;
  static constexpr int NRG = BQ / RR, NCG = NT / NRG, CC = D / NCG;
  // Row strides (floats).  q, do, k and v: D + 4, so that 8 rows of one
  // 4-column chunk hit 8 distinct 16-byte bank groups.  The partials and p
  // or ds ([q][kv]): 4 mod 32 banks, or 8 where TPR is 8, so that the TPR
  // lanes of each of a warp's rows read distinct banks in (2) where TPR is
  // 4 or 8 (two rows share banks where it is 2 or 16); a slab of partials
  // a (kind, slice), 16 banks apart where one warp writes two of them.
  static constexpr int LDX = D + 4;
  static constexpr int LDR = BK + (TPR == 8 ? 8 : 4);
  static constexpr int SLAB = BQ * LDR + (MT < 32 ? 16 : 0);
  // Shared memory, in floats: q; do (dq); k and v of both stages; the
  // partials (p or ds over slab 0); a value a q row (alpha, then l).
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + BQ * LDX;
  static constexpr int kK = kDo + (kDq ? BQ * LDX : 0);
  static constexpr int kV = kK + 2 * BK * LDX;
  static constexpr int kRed = kV + 2 * BK * LDX;
  static constexpr int kRow = kRed + NP * Z * SLAB;
  static constexpr int kFloats = kRow + BQ;
  static constexpr int kSmem = kFloats * 4;
  // Two blocks an SM where two fit in its 228 KB (1 KB each reserved).
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= 233472 ? 2 : 1;
  // Unrolling of the s / dp chunk loop: none within the 128 registers of
  // two blocks an SM, 4 at one block an SM (1-3 % off against 2, PERF.md).
  static constexpr int kUnroll = kMinBlocks == 2 ? 1 : 4;

  static_assert(Z >= 1 && NP * Z * MT == NT && (D / 4) % Z == 0, "slices");
  static_assert(RG <= 8 || (CG % 4 == 0 && MT % 32 == 0), "a warp's 8 x 4 blocks");
  static_assert(PPT >= 1 && TPR <= 32 && TPR * PPT == BK, "p and ds");
  static_assert(NRG * NCG == NT && RR % 4 == 0 && CC % 4 == 0 && NCG * CC == D,
                "o and dq");
  static_assert(LDR % 4 == 0 && SLAB % 4 == 0 && BK % 4 == 0, "16-byte rows");
  static_assert(kSmem <= static_cast<int>(tdx_bwd::kMaxSmem),
                "exceeds the 227 KB a block may use");
};

template <int D, bool kDq>
__global__ void __launch_bounds__(QF32Tiles<D, kDq>::NT,
                                  QF32Tiles<D, kDq>::kMinBlocks)
    q_f32_tiled(const QF32Args a) {
  using T = QF32Tiles<D, kDq>;
  constexpr int NT = T::NT, BQ = T::BQ, BK = T::BK, LDX = T::LDX;
  constexpr int LDR = T::LDR, Z = T::Z, PPT = T::PPT, TPR = T::TPR;
  constexpr int CC = T::CC, NCG = T::NCG, RR = T::RR;
  extern __shared__ float4 q_f32_smem[];
  float* sm = reinterpret_cast<float*>(q_f32_smem);
  float* red = sm + T::kRed;  // partials; p or ds over slab 0
  float* rowv = sm + T::kRow;

  const int tid = threadIdx.x;
  const int S = a.S, Hq = a.Hq;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t q_rs = static_cast<size_t>(Hq) * D;
  const size_t kv_rs = static_cast<size_t>(a.Hkv) * D;
  const size_t q_base = static_cast<size_t>(b) * S * q_rs + h * D;
  const size_t kv_base = static_cast<size_t>(b) * S * kv_rs + hk * D;
  const int last_row = min(q0 + BQ, S) - 1;
  const int n_kv = a.causal ? last_row / BK + 1 : (S + BK - 1) / BK;

  // Rows [r0, r0 + n) of a (.., S, H, D) tensor (row stride rs, from src at
  // the head's column 0) into a tile of stride LDX, zeros past S.
  auto load_rows = [&](float* dst, const float* src, size_t rs, int r0, int n) {
    for (int i = tid; i < n * (D / 4); i += NT) {
      const int r = i / (D / 4), c = i % (D / 4);
      const bool in = r0 + r < S;
      hw::cp_async16(dst + r * LDX + 4 * c,
                     src + static_cast<size_t>(in ? r0 + r : 0) * rs + 4 * c,
                     in ? 16 : 0);
    }
  };
  auto load_kv = [&](int st, int j) {
    load_rows(sm + T::kK + st * BK * LDX, a.k + kv_base, kv_rs, j * BK, BK);
    load_rows(sm + T::kV + st * BK * LDX, a.v + kv_base, kv_rs, j * BK, BK);
  };
  load_rows(sm + T::kQ, a.q + q_base, q_rs, q0, BQ);
  if constexpr (kDq) load_rows(sm + T::kDo, a.dout + q_base, q_rs, q0, BQ);
  load_kv(0, 0);
  hw::cp_async_commit();

  // (2)'s row and columns; the row's running max and this thread's part of
  // its sum (forward), or its lse log2 e and delta (dq, read once).
  const int qr = tid / TPR, t = tid % TPR;
  const int row2 = q0 + qr;
  float m = kMask, l = 0.f, lse2 = 0.f, dl = 0.f;
  if constexpr (kDq) {
    if (row2 < S) {
      const size_t i = (static_cast<size_t>(b) * Hq + h) * S + row2;
      lse2 = a.lse[i] * kLog2e;
      dl = a.delta[i];
    }
  }

  // (3)'s accumulator: o or dq of rows RR rg2 + r, columns 4 cg2 + 4 NCG m
  // + e.
  const int cg2 = tid % NCG, rg2 = tid / NCG;
  float acc[RR][CC];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1, k0 = j * BK;
    const float* ks = sm + T::kK + st * BK * LDX;
    const float* vs = sm + T::kV + st * BK * LDX;
    hw::cp_async_wait_all();
    __syncthreads();  // tile j landed; tile j - 1 is done with the rest
    if (j + 1 < n_kv) load_kv(st ^ 1, j + 1);
    hw::cp_async_commit();

    // (1) s (kind 0) or dp (kind 1) partials over slice z of D.
    {
      const int grp = tid / T::MT, mt = tid % T::MT;
      const int kind = grp / Z, z = grp % Z;
      constexpr int kWarpRows = T::RG / T::WRG;
      const int rg = mt % T::WRG + T::WRG * ((mt / 32) % kWarpRows);
      const int cg = (mt % 32) / T::WRG + (32 / T::WRG) * ((mt / 32) / kWarpRows);
      const float* ar = sm + (kind ? T::kDo : T::kQ) + rg * LDX;
      const float* br = (kind ? vs : ks) + cg * LDX;
      float s[T::RI][T::CJ];
#pragma unroll
      for (int i = 0; i < T::RI; ++i) {
#pragma unroll
        for (int jj = 0; jj < T::CJ; ++jj) s[i][jj] = 0.f;
      }
#pragma unroll (T::kUnroll)
      for (int c = z; c < D / 4; c += Z) {
        float4 x[T::RI], y[T::CJ];
#pragma unroll
        for (int i = 0; i < T::RI; ++i) {
          x[i] = *reinterpret_cast<const float4*>(ar + T::RG * i * LDX + 4 * c);
        }
#pragma unroll
        for (int jj = 0; jj < T::CJ; ++jj) {
          y[jj] = *reinterpret_cast<const float4*>(br + T::CG * jj * LDX + 4 * c);
        }
#pragma unroll
        for (int i = 0; i < T::RI; ++i) {
#pragma unroll
          for (int jj = 0; jj < T::CJ; ++jj) {
            s[i][jj] = fmaf(x[i].x, y[jj].x, s[i][jj]);
            s[i][jj] = fmaf(x[i].y, y[jj].y, s[i][jj]);
            s[i][jj] = fmaf(x[i].z, y[jj].z, s[i][jj]);
            s[i][jj] = fmaf(x[i].w, y[jj].w, s[i][jj]);
          }
        }
      }
      float* out = red + (kind * Z + z) * T::SLAB + rg * LDR + cg;
#pragma unroll
      for (int i = 0; i < T::RI; ++i) {
#pragma unroll
        for (int jj = 0; jj < T::CJ; ++jj) out[T::RG * i * LDR + T::CG * jj] = s[i][jj];
      }
    }
    __syncthreads();

    // (2) the slices summed in order, then the softmax (forward) or p and
    // ds (dq) of q row qr, kv columns t + TPR e; p or ds over slab 0.
    {
      const bool mask = needs_mask(a.causal, q0, BQ, k0, BK, S);
      float* pr = red + qr * LDR + t;
      if constexpr (kDq) {
#pragma unroll
        for (int e = 0; e < PPT; ++e) {
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int z = 0; z < Z; ++z) {
            s += pr[z * T::SLAB + TPR * e];
            dp += pr[(Z + z) * T::SLAB + TPR * e];
          }
          const bool keep = !mask || keep_pair(a.causal, row2, k0 + t + TPR * e, S);
          tdx_bwd::p_ds(s, dp, lse2, dl, keep, a.scale, a.scale_log2);
          pr[TPR * e] = dp;
        }
      } else {
        float x[PPT];
        float mx = kMask;
#pragma unroll
        for (int e = 0; e < PPT; ++e) {
          float s = 0.f;
#pragma unroll
          for (int z = 0; z < Z; ++z) s += pr[z * T::SLAB + TPR * e];
          const bool keep = !mask || keep_pair(a.causal, row2, k0 + t + TPR * e, S);
          x[e] = keep ? s * a.scale_log2 : kMask;
          mx = fmaxf(mx, x[e]);
        }
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_next = fmaxf(m, mx);
        const float alpha = exp2f(m - m_next);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < PPT; ++e) {
          const float p = exp2f(x[e] - m_next);
          pr[TPR * e] = p;
          sum += p;
        }
        l = l * alpha + sum;
        m = m_next;
        if (t == 0) rowv[qr] = alpha;
      }
    }
    __syncthreads();

    // (3) o = o alpha + p.v (forward) or dq += ds.k, 4 kv columns a pass.
    {
      if constexpr (!kDq) {
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const float alpha = rowv[RR * rg2 + r];
          if (alpha != 1.f) {
#pragma unroll
            for (int c = 0; c < CC; ++c) acc[r][c] *= alpha;
          }
        }
      }
      const float* pm = red + RR * rg2 * LDR;
      const float* xm = (kDq ? ks : vs) + 4 * cg2;
#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        float4 p4[RR];
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          p4[r] = *reinterpret_cast<const float4*>(pm + r * LDR + kk);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float x[CC];
#pragma unroll
          for (int mm = 0; mm < CC / 4; ++mm) {
            const float4 v =
                *reinterpret_cast<const float4*>(xm + (kk + u) * LDX + 4 * NCG * mm);
            x[4 * mm] = v.x;
            x[4 * mm + 1] = v.y;
            x[4 * mm + 2] = v.z;
            x[4 * mm + 3] = v.w;
          }
#pragma unroll
          for (int r = 0; r < RR; ++r) {
            const float p = u == 0 ? p4[r].x : u == 1 ? p4[r].y : u == 2 ? p4[r].z : p4[r].w;
#pragma unroll
            for (int c = 0; c < CC; ++c) acc[r][c] = fmaf(p, x[c], acc[r][c]);
          }
        }
      }
    }
  }

  // Epilogue.  Forward: each row's sum over its TPR lanes (a fixed order),
  // lse, and l into the row buffer (after every thread's last read of
  // alpha); then out = o / l.  dq: dq as it stands.
  float lr[RR] = {};  // the rows' l (forward)
  if constexpr (!kDq) {
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    __syncthreads();
    if (t == 0) {
      const float l_safe = l == 0.f ? 1.f : l;
      rowv[qr] = l_safe;
      if (row2 < S) {
        a.lse[(static_cast<size_t>(b) * Hq + h) * S + row2] = m / kLog2e + logf(l_safe);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RR; ++r) lr[r] = rowv[RR * rg2 + r];
  }
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int row = q0 + RR * rg2 + r;
    if (row >= S) continue;
    float* dst = a.out + q_base + static_cast<size_t>(row) * q_rs + 4 * cg2;
#pragma unroll
    for (int mm = 0; mm < CC / 4; ++mm) {
      float4 o;
      if constexpr (kDq) {
        o = make_float4(acc[r][4 * mm], acc[r][4 * mm + 1], acc[r][4 * mm + 2],
                        acc[r][4 * mm + 3]);
      } else {
        o = make_float4(acc[r][4 * mm] / lr[r], acc[r][4 * mm + 1] / lr[r],
                        acc[r][4 * mm + 2] / lr[r], acc[r][4 * mm + 3] / lr[r]);
      }
      *reinterpret_cast<float4*>(dst + 4 * NCG * mm) = o;
    }
  }
}

// Launches the body over a grid of (Hq x B, q tiles); a launch the card
// refuses returns its own error, as does a grid out of range.
template <int D, bool kDq>
int launch_q_f32_tiled(const QF32Args& args, int B, cudaStream_t stream) {
  using T = QF32Tiles<D, kDq>;
  static bool opted[hw::kMaxDevices];
  const int err = hw::smem_opt_in(q_f32_tiled<D, kDq>, T::kSmem, opted);
  if (err) return err;
  const long long heads = static_cast<long long>(args.Hq) * B;
  const int n_q = (args.S + T::BQ - 1) / T::BQ;
  if (heads > INT_MAX || n_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
  q_f32_tiled<D, kDq><<<dim3(static_cast<unsigned>(heads), n_q), T::NT, T::kSmem,
                        stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The f32 forward (kDq false) or dq (true) at head dim D: 64, 128, 256 or
// 512; any other is refused.
template <bool kDq>
int launch_q_f32(const QF32Args& args, int B, int D, cudaStream_t stream) {
  if (D == 64) return launch_q_f32_tiled<64, kDq>(args, B, stream);
  if (D == 128) return launch_q_f32_tiled<128, kDq>(args, B, stream);
  if (D == 256) return launch_q_f32_tiled<256, kDq>(args, B, stream);
  if (D == 512) return launch_q_f32_tiled<512, kDq>(args, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tdx_qf32
