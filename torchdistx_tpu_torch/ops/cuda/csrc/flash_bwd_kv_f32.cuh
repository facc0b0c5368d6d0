// The f32 kv-tile backward body for Hopper (sm_90a), on the CUDA cores:
// bwd_kv_f32_tiled<D, kDq>, which flash_bwd_dkv.cu runs for f32 dk and dv
// (kDq false) and flash_bwd_fused.cu for f32 dq, dk and dv (kDq true), at
// D 64, 128, 256 and 512.  Also here: launch_kv, the dispatch of both
// kernels' f32 instances (their bf16 ones are on TMA + wgmma).
//
// Replaces torchdistx_tpu/ops/pallas/flash_attention.py:_dkv_kernel (dk,
// dv streamed over q; pallas_call at :731) and _dqkv_fused_kernel (dq, dk
// and dv in one kernel; :616) for float32 inputs.  Same function and
// masking rules as the rest of the backward (flash_bwd_common.cuh's header
// and p_ds): per (kv tile, GQA head, q tile) step s^T = k.q^T and dp^T =
// v.do^T over D, p and ds from lse and delta, dv += p^T.do, dk += ds^T.q
// and (kDq) dq += ds.k, all in f32 FMAs on the CUDA cores: no TF32, whose
// 10 mantissa bits the 1e-4 gates against the plain version would see.
//
// What bounds it on an H100 SXM: its 4 (dk/dv) or 5 (fused) products of 2 D
// flops a kept pair, against 67 TFLOP/s of f32 FMA outside the tensor
// cores (PEAK_OPS_PER_S in chip_smoke.py).  At [head dims]' 2 x 300, 8/2
// heads, causal, D 512: 2.96 GFLOP for dk/dv, 0.044 ms; the bytes (q, k,
// v, do, lse, delta in, the gradients out) take less.  Operations bound it
// at every shape the port runs.
//
// The CUDA-core body this replaces reached 1-3 % of that rate at those
// shapes.  What held it back, and what this design does about each:
//
// 1. Too few blocks: one 128-thread block per (kv tile, kv head, batch),
//    with the GQA group's heads and the q tiles one after another in it, 40
//    or 76 blocks at [head dims]' shape on 132 SMs.  Here the step list of
//    a kv tile (GQA head major, then q tile from the causal diagonal) is
//    split round robin over the `split` blocks of a thread block cluster
//    (split 1 to 4, chosen at launch: 1 where the kv tiles alone give the
//    card's SMs a block each, as at 2 x 1000, 8/8 heads or at Llama-7B's
//    4 x 512, else about two blocks an SM).  Each block keeps partial dk
//    and dv; at the end every block writes its partials to its shared
//    memory, and after a cluster barrier block r sums its share of the
//    tile's elements over ranks 0, 1, .. in that order, reading the peers'
//    shared memory (ld.shared::cluster), and stores it.  The order is fixed,
//    so dk and dv are the same bits on every call.  The grid's slowest axis
//    is the kv tile, so the causal mask's heaviest tiles start first.
// 2. No register blocking: a lane formed one pair's dot products, one
//    shared load an FMA.  Here every product is register-blocked from
//    16-byte shared loads: s^T and dp^T as 4 x 4 pairs a thread (each load
//    of 4 d values of a k or q row feeds 16 FMAs), over D split into Z
//    slices of interleaved 4-column chunks (1 at D 64, 8 at D 512) whose
//    partial sums are added in a fixed order through shared memory; dv += p^T.do (threads 0-127) and
//    dk += ds^T.q (128-255) as RR x CC blocks of a thread (8 x 8 at D 256,
//    4 x 16 at D 512); dq = ds.k as R3 x C3 blocks.  Tile rows are padded
//    (LDX, LDR, LDP below) so that the loads of a warp hit distinct banks.
// 3. No copy in flight: q and do tiles were loaded, widened and stored
//    between two barriers.  Here q, do, lse and delta arrive by cp.async
//    (16 bytes a copy for q and do, zero-filled past S) into a ring of two
//    stages: step l + 1's tiles land while step l's products run.
// 4. Scalar dq atomics (fused): here each thread adds its dq block as
//    16-byte vector atomics (atomicAdd on float4, one red of 4 floats), a
//    quarter of the adds; dq's order of addition across blocks varies from
//    run to run, as before.
//
// Tiles by D (KvF32Tiles): 256 threads; kv tiles of BK = 64 rows and q
// tiles of BQ = 32 at D 64 (18 % and 13 % off dk/dv and the fused kernel
// against 32 x 16 at 2 x 1000, 8/8 heads, PERF.md), 32 x 16 at D 128 and
// 256, 16 x 16 at D 512, where k, v and two stages of q and do take 200 KB
// of the 227 a block may use.  dk and dv are 2 x BK x D / 256 registers a
// thread (32 at D 64 and 128, 64 at D 256 and 512); two blocks an SM at D
// 64 and 128 (at most 128 registers; one block an SM at D 128 was 27 %
// slower), one above.

#pragma once

#include "flash_bwd_common.cuh"

namespace tdx_bwd {

// ---- the cluster's shared memory

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// 16 bytes at a shared::cluster address (hw::map_rank).
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ---- the body

template <int D>
struct KvF32Tiles {
  static constexpr int NT = 256;  // threads
  static constexpr int BK = D == 512 ? 16 : D == 64 ? 64 : 32;
  static constexpr int BQ = D == 64 ? 32 : 16;
  // s^T and dp^T: 4 x 4 pairs a thread, kv rows rg + RG i, q rows cg + CG
  // j; kind 0 (s^T from k, q) and kind 1 (dp^T from v, do), each over Z
  // slices of D: slice z takes the 4-column chunks z, z + Z, ..
  static constexpr int RG = BK / 4, CG = BQ / 4, MT = RG * CG;
  static constexpr int Z = NT / (2 * MT);
  // Row strides (floats).  k, v, q and do: D + 4 when a warp reads 8 rows
  // of one chunk (row r's 16-byte group at r mod 8), D + 8 when it reads 4
  // rows of two neighbouring chunks (at 2 r + chunk mod 8).  The partials:
  // kv rows of q row q at q LDR (a warp's stores then hit 32 banks), and
  // one slab of BQ rows per (kind, slice); p and ds: [q][kv], 16-byte rows.
  static constexpr int LDX = D + (RG >= 8 ? 4 : 8);
  static constexpr int LDR = BK + RG;
  static constexpr int SLAB = BQ * LDR + (RG >= 8 ? 0 : 16);
  static constexpr int LDP = BK + 4;
  // p and ds: PPT neighbouring kv columns of one q row a thread.
  static constexpr int PPT = BK * BQ / NT;
  // dv (threads 0-127) and dk (128-255): kv rows RR rg2 .. + RR - 1 and the
  // 4-column groups cg2, cg2 + NCG, .. (CC columns) of a thread.
  static constexpr int NCG = D / 4 < 32 ? D / 4 : 32, NRG = 128 / NCG;
  static constexpr int RR = BK / NRG, CC = D / NCG;
  // dq (kDq): q rows rg3 + NRG3 a (R3 of them) and CC3 columns of a thread.
  static constexpr int NCG3 = D / 4 < 64 ? D / 4 : 64, NRG3 = NT / NCG3;
  static constexpr int R3 = BQ / NRG3, C3 = D / NCG3;
  // Shared memory, in floats: k, v; q and do of both stages; lse and delta
  // of both stages; the partials; p, ds.  dk and dv go out through k, v
  // and the stages (2 BK D floats fit in them), dead after the last step.
  static constexpr int kK = 0, kV = BK * LDX, kQ = 2 * BK * LDX;
  static constexpr int kDo = kQ + 2 * BQ * LDX;
  static constexpr int kLse = kDo + 2 * BQ * LDX, kDelta = kLse + 2 * BQ;
  static constexpr int kRed = kDelta + 2 * BQ;
  static constexpr int kP = kRed + 2 * Z * SLAB, kDs = kP + BQ * LDP;
  static constexpr int kFloats = kDs + BQ * LDP;
  static constexpr int kSmem = kFloats * 4;
  static constexpr int kMinBlocks = D <= 128 ? 2 : 1;  // blocks an SM
  // Unrolling of the s^T / dp^T chunk loop: more at D <= 128 spills at
  // the 128 registers of two blocks an SM; at D 512 none costs 6 %.
  static constexpr int kUnroll = D <= 128 ? 1 : 2;
  static constexpr int kMaxSplit = 4;                  // blocks a cluster

  static_assert(Z >= 1 && 2 * Z * MT == NT && (D / 4) % Z == 0, "slices");
  static_assert(PPT >= 1 && BK % PPT == 0, "p and ds pass");
  static_assert(NRG * NCG == 128 && RR % 4 == 0 && CC % 4 == 0, "dk, dv");
  static_assert(NRG3 * NCG3 == NT && R3 >= 1 && C3 % 4 == 0, "dq");
  static_assert(2 * BK * D <= kLse, "dk and dv fit k, v and the stages");
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
};

template <int D, bool kDq>
__global__ void __launch_bounds__(KvF32Tiles<D>::NT, KvF32Tiles<D>::kMinBlocks)
    bwd_kv_f32_tiled(const BwdArgs a) {
  using T = KvF32Tiles<D>;
  constexpr int NT = T::NT, BK = T::BK, BQ = T::BQ, LDX = T::LDX;
  constexpr int LDR = T::LDR, LDP = T::LDP, Z = T::Z;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  float* ks = sm + T::kK;
  float* vs = sm + T::kV;
  float* ps = sm + T::kP;
  float* dss = sm + T::kDs;
  float* red = sm + T::kRed;

  const int tid = threadIdx.x;
  const int S = a.S, Hq = a.Hq, Hkv = a.Hkv, G = Hq / Hkv;
  const int rank = static_cast<int>(hw::cluster_rank());
  const int split = static_cast<int>(cluster_size());
  const int hk = blockIdx.y % Hkv, b = blockIdx.y / Hkv;
  const int k0 = blockIdx.z * BK;
  const int n_q = (S + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;
  const int n_per_group = n_q - qt0;
  const int n_steps = G * n_per_group;
  // This block's steps: rank, rank + split, ..
  const int n_loc = rank < n_steps ? (n_steps - rank + split - 1) / split : 0;
  const size_t q_rs = static_cast<size_t>(Hq) * D;
  const size_t kv_rs = static_cast<size_t>(Hkv) * D;
  const float* qg = static_cast<const float*>(a.q) + static_cast<size_t>(b) * S * q_rs;
  const float* dog = static_cast<const float*>(a.dout) + static_cast<size_t>(b) * S * q_rs;

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
  // Step j's q, do, lse and delta into stage st.
  auto load_step = [&](int st, int j) {
    const int h = hk * G + j / n_per_group;
    const int q0 = (qt0 + j % n_per_group) * BQ;
    load_rows(sm + T::kQ + st * BQ * LDX, qg + h * D, q_rs, q0, BQ);
    load_rows(sm + T::kDo + st * BQ * LDX, dog + h * D, q_rs, q0, BQ);
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool in = q0 + r < S;
      const float* row = (tid < BQ ? a.lse : a.delta) +
                         (static_cast<size_t>(b) * Hq + h) * S + (in ? q0 + r : 0);
      hw::cp_async4(sm + (tid < BQ ? T::kLse : T::kDelta) + st * BQ + r, row,
                    in ? 4 : 0);
    }
  };

  if (n_loc > 0) {
    const size_t kv0 = static_cast<size_t>(b) * S * kv_rs + hk * D;
    load_rows(ks, static_cast<const float*>(a.k) + kv0, kv_rs, k0, BK);
    load_rows(vs, static_cast<const float*>(a.v) + kv0, kv_rs, k0, BK);
    load_step(0, rank);
  }
  hw::cp_async_commit();

  // dv (kind2 0) or dk (kind2 1) of kv rows RR rg2 + r, columns 4 cg2 + 4
  // NCG m + e.
  const int kind2 = tid / 128, t2 = tid % 128;
  const int cg2 = t2 % T::NCG, rg2 = t2 / T::NCG;
  float acc[T::RR][T::CC];
#pragma unroll
  for (int r = 0; r < T::RR; ++r) {
#pragma unroll
    for (int c = 0; c < T::CC; ++c) acc[r][c] = 0.f;
  }

  for (int l = 0; l < n_loc; ++l) {
    const int st = l & 1, j = rank + l * split;
    const int h = hk * G + j / n_per_group;
    const int q0 = (qt0 + j % n_per_group) * BQ;
    const float* qs = sm + T::kQ + st * BQ * LDX;
    const float* dos = sm + T::kDo + st * BQ * LDX;
    hw::cp_async_wait_all();
    __syncthreads();  // stage st landed; step l - 1 is done with the rest
    if (l + 1 < n_loc) load_step(st ^ 1, j + split);
    hw::cp_async_commit();

    // (1) s^T (kind 0) or dp^T (kind 1) partials over slice z of D.
    {
      const int grp = tid / T::MT, mt = tid % T::MT;
      const int kind = grp / Z, z = grp % Z;
      const int rg = mt % T::RG, cg = mt / T::RG;
      const float* ar = (kind ? vs : ks) + rg * LDX;
      const float* br = (kind ? dos : qs) + cg * LDX;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      }
#pragma unroll (T::kUnroll)
      for (int c = z; c < D / 4; c += Z) {
        float4 x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = *reinterpret_cast<const float4*>(ar + T::RG * i * LDX + 4 * c);
          y[i] = *reinterpret_cast<const float4*>(br + T::CG * i * LDX + 4 * c);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(x[i].x, y[jj].x, s[i][jj]);
            s[i][jj] = fmaf(x[i].y, y[jj].y, s[i][jj]);
            s[i][jj] = fmaf(x[i].z, y[jj].z, s[i][jj]);
            s[i][jj] = fmaf(x[i].w, y[jj].w, s[i][jj]);
          }
        }
      }
      float* out = red + (kind * Z + z) * T::SLAB + cg * LDR + rg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) out[T::CG * jj * LDR + T::RG * i] = s[i][jj];
      }
    }
    __syncthreads();

    // (2) p and ds of q row qr, kv columns kc .. kc + PPT - 1: the slices
    // summed in order, then p_ds; into ps and dss ([q][kv]).
    {
      constexpr int PPT = T::PPT;
      const int qr = tid / (BK / PPT), kc = (tid % (BK / PPT)) * PPT;
      float s[PPT], dp[PPT];
#pragma unroll
      for (int e = 0; e < PPT; ++e) s[e] = dp[e] = 0.f;
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        const float* rs = red + z * T::SLAB + qr * LDR + kc;
        const float* rd = red + (Z + z) * T::SLAB + qr * LDR + kc;
#pragma unroll
        for (int e = 0; e < PPT; ++e) {
          s[e] += rs[e];
          dp[e] += rd[e];
        }
      }
      const float lse2 = sm[T::kLse + st * BQ + qr] * kLog2e;
      const float dl = sm[T::kDelta + st * BQ + qr];
      const bool mask = needs_mask(a.causal, q0, BQ, k0, BK, S);
#pragma unroll
      for (int e = 0; e < PPT; ++e) {
        const bool keep = !mask || keep_pair(a.causal, q0 + qr, k0 + kc + e, S);
        ps[qr * LDP + kc + e] =
            p_ds(s[e], dp[e], lse2, dl, keep, a.scale, a.scale_log2);
        dss[qr * LDP + kc + e] = dp[e];
      }
    }
    __syncthreads();

    // (3) dv += p^T.do (kind2 0), dk += ds^T.q (kind2 1).
    {
      const float* pm = (kind2 ? dss : ps) + T::RR * rg2;
      const float* xm = (kind2 ? qs : dos) + 4 * cg2;
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pr[T::RR], x[T::CC];
#pragma unroll
        for (int r = 0; r < T::RR; r += 4) {
          const float4 v = *reinterpret_cast<const float4*>(pm + qq * LDP + r);
          pr[r] = v.x;
          pr[r + 1] = v.y;
          pr[r + 2] = v.z;
          pr[r + 3] = v.w;
        }
#pragma unroll
        for (int m = 0; m < T::CC / 4; ++m) {
          const float4 v =
              *reinterpret_cast<const float4*>(xm + qq * LDX + 4 * T::NCG * m);
          x[4 * m] = v.x;
          x[4 * m + 1] = v.y;
          x[4 * m + 2] = v.z;
          x[4 * m + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < T::RR; ++r) {
#pragma unroll
          for (int c = 0; c < T::CC; ++c) acc[r][c] = fmaf(pr[r], x[c], acc[r][c]);
        }
      }
    }

    // (4, kDq) dq = ds.k for q rows rg3 + NRG3 i, added to the f32 buffer
    // 4 columns an atomic.
    if constexpr (kDq) {
      constexpr int R3 = T::R3, C3 = T::C3, NCG3 = T::NCG3, NRG3 = T::NRG3;
      const int cg3 = tid % NCG3, rg3 = tid / NCG3;
      float dq[R3][C3];
#pragma unroll
      for (int i = 0; i < R3; ++i) {
#pragma unroll
        for (int c = 0; c < C3; ++c) dq[i][c] = 0.f;
      }
#pragma unroll 2
      for (int c4 = 0; c4 < BK / 4; ++c4) {
        float4 dsv[R3];
#pragma unroll
        for (int i = 0; i < R3; ++i) {
          dsv[i] = *reinterpret_cast<const float4*>(dss + (rg3 + NRG3 * i) * LDP + 4 * c4);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float kx[C3];
#pragma unroll
          for (int m = 0; m < C3 / 4; ++m) {
            const float4 v = *reinterpret_cast<const float4*>(
                ks + (4 * c4 + cc) * LDX + 4 * cg3 + 4 * NCG3 * m);
            kx[4 * m] = v.x;
            kx[4 * m + 1] = v.y;
            kx[4 * m + 2] = v.z;
            kx[4 * m + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < R3; ++i) {
            const float d = cc == 0 ? dsv[i].x : cc == 1 ? dsv[i].y
                          : cc == 2 ? dsv[i].z : dsv[i].w;
#pragma unroll
            for (int c = 0; c < C3; ++c) dq[i][c] = fmaf(d, kx[c], dq[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R3; ++i) {
        const int row = q0 + rg3 + NRG3 * i;
        if (row >= S) continue;
        float* dst = a.dq_acc + (static_cast<size_t>(b) * S + row) * q_rs + h * D +
                     4 * cg3;
#pragma unroll
        for (int m = 0; m < C3 / 4; ++m) {
          atomicAdd(reinterpret_cast<float4*>(dst + 4 * NCG3 * m),
                    make_float4(dq[i][4 * m], dq[i][4 * m + 1], dq[i][4 * m + 2],
                                dq[i][4 * m + 3]));
        }
      }
    }
  }

  // Epilogue: this block's partial dv and dk (rows of BK x D each, dv
  // first) into k, v and the stages, then, after the cluster barrier, block
  // `rank` sums its share of them over the cluster's blocks in rank order
  // and stores the rows < S.  The last barrier keeps every block's shared
  // memory alive until its peers have read it.
  hw::cp_async_wait_all();
  __syncthreads();
  float* part = sm + T::kK;
#pragma unroll
  for (int r = 0; r < T::RR; ++r) {
#pragma unroll
    for (int m = 0; m < T::CC / 4; ++m) {
      *reinterpret_cast<float4*>(part + kind2 * BK * D + (T::RR * rg2 + r) * D +
                                 4 * cg2 + 4 * T::NCG * m) =
          make_float4(acc[r][4 * m], acc[r][4 * m + 1], acc[r][4 * m + 2],
                      acc[r][4 * m + 3]);
    }
  }
  hw::cluster_sync();
  constexpr int kN4 = 2 * BK * D / 4;
  const uint32_t part_addr = hw::smem_addr(part);
  for (int f = kN4 * rank / split + tid; f < kN4 * (rank + 1) / split; f += NT) {
    float4 sum = ld_cluster_f4(hw::map_rank(part_addr + 16 * f, 0));
    for (int rr = 1; rr < split; ++rr) {
      const float4 v = ld_cluster_f4(hw::map_rank(part_addr + 16 * f, rr));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int e = 4 * f, which = e / (BK * D), row = e / D % BK, col = e % D;
    if (k0 + row >= S) continue;
    float* dst = static_cast<float*>(which ? a.dk : a.dv) +
                 (static_cast<size_t>(b) * S + k0 + row) * kv_rs + hk * D + col;
    *reinterpret_cast<float4*>(dst) = sum;
  }
  hw::cluster_sync();
}

// Launches the body over a grid of (split, Hkv x B, kv tiles) in clusters
// of (split, 1, 1): split 1 where the kv tiles alone give every SM a block,
// else the least of kMaxSplit, the blocks that give about two an SM, and a
// first tile's steps.  A launch the card refuses returns its error.
template <int D, bool kDq>
int launch_kv_f32_tiled(const BwdArgs& args, int B, cudaStream_t stream) {
  using T = KvF32Tiles<D>;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(bwd_kv_f32_tiled<D, kDq>, T::kSmem, opted);
  int n_sm = 0;
  if (!err) err = hw::sm_count(&n_sm);
  if (err) return err;
  const int n_kv = (args.S + T::BK - 1) / T::BK;
  const int blocks = n_kv * args.Hkv * B;
  const int first_steps = args.Hq / args.Hkv * ((args.S + T::BQ - 1) / T::BQ);
  int split = 1;
  if (blocks < n_sm) {
    split = (2 * n_sm + blocks - 1) / blocks;
    split = split < T::kMaxSplit ? split : T::kMaxSplit;
    split = split < first_steps ? split : first_steps;
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(split, args.Hkv * B, n_kv);
  config.blockDim = dim3(T::NT);
  config.dynamicSmemBytes = T::kSmem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&config, bwd_kv_f32_tiled<D, kDq>, args);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the kv-tile body on the CUDA cores for (D, dtype): f32 at D 64,
// 128, 256 and 512 (bwd_kv_f32_tiled); dtype 0 = float32.  Every bf16
// kernel is on TMA + wgmma, so a bf16 dtype here is refused.
template <bool kDq>
int launch_kv(const BwdArgs& args, int B, int D, int dtype,
              cudaStream_t stream) {
  if (dtype == 0 && D == 64) return launch_kv_f32_tiled<64, kDq>(args, B, stream);
  if (dtype == 0 && D == 128) return launch_kv_f32_tiled<128, kDq>(args, B, stream);
  if (dtype == 0 && D == 256) return launch_kv_f32_tiled<256, kDq>(args, B, stream);
  if (dtype == 0 && D == 512) return launch_kv_f32_tiled<512, kDq>(args, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tdx_bwd
