// Shared pieces of the flash-attention backward kernels for Hopper (sm_90a):
// flash_bwd_fused.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu include this file
// (and flash_fwd.cu, through flash_q_f32.cuh, for the masking rules).
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
// Also here: the steps that the bf16 kv-tile kernels on wgmma share
// (flash_bwd_dkv.cu and flash_bwd_fused.cu: s^T and dp^T, p and ds into
// shared memory, the dk/dv accumulation, dq = ds.k), the body of both at D
// = 256 (bwd_kv_wide) and at D = 512 over a cluster of two blocks
// (bwd_kv_cluster, whose exchange of partial products between the blocks
// the D = 512 dq kernel runs too), and the launch helper for clusters of
// two blocks.  Every bf16 kernel is built on hopper.cuh's TMA and wgmma;
// the f32 ones run on the CUDA cores (flash_bwd_kv_f32.cuh's
// bwd_kv_f32_tiled for dk/dv and the fused kernel, flash_q_f32.cuh's
// q_f32_tiled for dq, which the forward shares).
// What bounds the shared steps: a step's critical path is one warpgroup's p
// and ds (4,096 pairs, an exp2 each on the special-function unit) and then
// the accumulations that wait for them; knocking out half the tensor work
// saved less than knocking out p and ds, so this chain, not the tensor
// rate, holds the kv-tile kernels back (each source's header gives its
// bound).
//
// Layout: q, do, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D); contiguous,
// read and written in place.  GQA maps q head h to kv head h / (Hq / Hkv).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tdx_bwd {

namespace hw = tdx::hopper;

constexpr float kLog2e = 1.4426950408889634f;

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

// Issues s^T = k.q^T and dp^T = v.do^T for the 64 kv rows and the step's
// NQ q rows over D columns (wgmma m64nNQk16, both operands K-major; not
// committed), each a new definition by its first wgmma; q and do are
// chunks of NQ rows (NQ 32 at D = 512, where D is a block's 256 columns).
template <int D, int NQ = 64>
__device__ __forceinline__ void issue_st_dpt(float (&s)[NQ / 2],
                                             float (&dp)[NQ / 2],
                                             uint32_t k_addr, uint32_t v_addr,
                                             uint32_t q_addr,
                                             uint32_t do_addr) {
  hw::wgmma_ss_init(s, hw::sw128_desc(k_addr, 16, 1024),
                    hw::sw128_desc(q_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
    const uint32_t off_q = (kk / 4) * NQ * 128 + (kk % 4) * 32;
    hw::wgmma_ss(s, hw::sw128_desc(k_addr + off, 16, 1024),
                 hw::sw128_desc(q_addr + off_q, 16, 1024), 1);
  }
  hw::wgmma_ss_init(dp, hw::sw128_desc(v_addr, 16, 1024),
                    hw::sw128_desc(do_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
    const uint32_t off_q = (kk / 4) * NQ * 128 + (kk % 4) * 32;
    hw::wgmma_ss(dp, hw::sw128_desc(v_addr + off, 16, 1024),
                 hw::sw128_desc(do_addr + off_q, 16, 1024), 1);
  }
}

// p = 2^(s scale log2 e - lse log2 e) and ds = p (dp scale - delta scale)
// of one step (lse_st and delta_st hold the q tile's lse log2 e and delta
// scale), 0 on masked pairs (p_ds_fast); column qc of the tile is q row q0 +
// qc, this thread's kv rows are k0 + 16 (warp % 4) + lane / 4 and that + 8.
// Then p and ds in bf16 into the step's buffer (p at pb, ds one chunk on),
// four 8 x 8 blocks a stmatrix, laid out as the 128-byte swizzle of a
// K-major operand: kv row r at byte r * 128, the 16-byte group of q columns
// 8 c .. 8 c + 7 at (c ^ r % 8) * 16.  NQ is the step's q columns: 64, or
// 32 at D = 512 (the buffer's rows then hold groups 0-3 of their 8).
template <int NQ = 64>
__device__ __forceinline__ void p_ds_store(const float (&s)[NQ / 2],
                                           float (&dp)[NQ / 2],
                                           const float* lse_st,
                                           const float* delta_st, bool mask,
                                           int causal, int q0, int k0, int S,
                                           float scale, float scale_log2,
                                           uint8_t* pb, int warp, int lane) {
  const int t = lane % 4;
  const int row = 16 * (warp % 4) + lane / 4;
  // Block (j, r): kv rows row + 8 r, cols 8 j..
  uint32_t pk[NQ / 4], dsk[NQ / 4];
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
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
  for (int jp = 0; jp < NQ / 16; ++jp) {
    const int off = m_row * 128 + ((2 * jp + lane / 16) ^ (lane % 8)) * 16;
    const uint32_t pa = hw::smem_addr(pb + off);
    hw::stmatrix_x4(pa, pk[4 * jp], pk[4 * jp + 1], pk[4 * jp + 2],
                    pk[4 * jp + 3]);
    hw::stmatrix_x4(pa + kChunk, dsk[4 * jp], dsk[4 * jp + 1],
                    dsk[4 * jp + 2], dsk[4 * jp + 3]);
  }
}

// Issues acc += a^T.b over a step's NQ q rows (not committed): a is p or
// ds (64 kv rows x NQ q columns, K-major, from p_ds_store), b is do or q
// (NQ q rows x D, MN-major, as TMA lays it out, in chunks of NQ rows), so
// nothing is transposed.
template <int D, int NQ = 64>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < NQ / 16; ++kk) {
    hw::wgmma_ss_mn(acc, hw::sw128_desc(a + kk * 32, 16, 1024),
                    hw::sw128_desc(b + kk * 16 * 128, NQ * 128, 1024));
  }
}

// Issues dq = ds.k for a step's 64 q rows (not committed): ds^T from the
// p/ds buffer (64 kv rows x 64 q columns, K-major) read as an MN-major A,
// k (64 kv rows x N, N = 2 x the registers of dq) as an MN-major B; k runs
// over the 64 kv rows.  dq is a new definition by the first wgmma.
template <int N>
__device__ __forceinline__ void issue_dq(float (&dq)[N / 2], uint32_t ds_addr,
                                         uint32_t k_addr) {
  hw::wgmma_ss_init<1, 1>(dq, hw::sw128_desc(ds_addr, kChunk, 1024),
                          hw::sw128_desc(k_addr, kChunk, 1024));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) {
    hw::wgmma_ss_mn<1>(dq, hw::sw128_desc(ds_addr + kk * 16 * 128, kChunk, 1024),
                       hw::sw128_desc(k_addr + kk * 16 * 128, kChunk, 1024));
  }
}

// Issues dq^T = k^T.ds^T for one 64-column chunk of k and a step's 32 q
// rows (not committed), where wgmma's 64 rows cannot be q's: the chunk (64
// kv rows x 64 columns, as TMA lays it out) read as an MN-major A, ds^T
// from the p/ds buffer (64 kv rows x 32 q columns in rows of 128 bytes,
// p_ds_store<32>) as an MN-major B; k runs over the 64 kv rows.  dq^T (row
// = column of D, column = q row) is a new definition by the first wgmma.
__device__ __forceinline__ void issue_dqt(float (&dqt)[16], uint32_t k_addr,
                                          uint32_t ds_addr) {
  hw::wgmma_ss_init<1, 1>(dqt, hw::sw128_desc(k_addr, kChunk, 1024),
                          hw::sw128_desc(ds_addr, kChunk, 1024));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) {
    hw::wgmma_ss_mn<1>(dqt, hw::sw128_desc(k_addr + kk * 16 * 128, kChunk, 1024),
                       hw::sw128_desc(ds_addr + kk * 16 * 128, kChunk, 1024));
  }
}

// Writes dq^T of one 64-column chunk (issue_dqt's accumulator, the
// m64n32k16 layout of hopper.cuh) transposed into an f32 tile of 32 q rows
// x 128 columns laid out as four TMA boxes of 32 columns: box x at tile + x
// 4096, q row r at byte r 128 of its box, 16-byte group j at (j ^ r % 8)
// 16; the chunk lands at columns c0 .. c0 + 63.  A warp's stores of one
// register hit 32 distinct banks.
__device__ __forceinline__ void store_dqt_f32(uint8_t* tile,
                                              const float (&dqt)[16], int c0) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + 16 * warp + g + 8 * (e >> 1);
      const int row = 8 * j + 2 * t + (e & 1);
      *reinterpret_cast<float*>(tile + (col / 32) * 4096 + row * 128 +
                                (((col % 32) / 4) ^ (row % 8)) * 16 +
                                (col % 4) * 4) = dqt[4 * j + e];
    }
  }
}

// ---------------------------------------------------------------------------
// The wide kv-tile kernels, bf16 at D = 256: flash_bwd_dkv_wgmma_wide (dk,
// dv) and flash_bwd_fused_wgmma_wide (kDq: dq as well), one body.  dk and
// dv of 64 kv rows are 128 registers a thread each, which with s^T and dp^T
// (64) do not fit the 168 registers of a 288-thread block.  A block of 256
// threads (two warpgroups, no producer warp) gets 255, so warpgroup 0 holds
// dv and warpgroup 1 dk whole, each as two 64 x 128 halves (m64n128k16 on
// do's or q's chunks 0-1 and 2-3), 232 registers, no spills.  Steps (GQA
// head, q tile) alternate owners, who compute s^T and dp^T
// (issue_st_dpt<256>) and p and ds (p_ds_store) into the stage's p/ds
// buffer; each warpgroup then accumulates both steps of the pair in order.
// Shared memory holds k and v (64 KB), two stages of q and do (128 KB), two
// p/ds buffers (32 KB) and lse and delta: 231,480 of 232,448 bytes, so two
// stages.  With no producer warp, mbarriers carry the handoffs: full (a
// stage landed), ready (a step's p and ds written, every owner thread
// arriving) and done (both warpgroups accumulated a step); the warpgroup
// that does not own a step accumulates it second, so its first warp then
// refills the stage with the step two on (lse and delta loaded into
// registers before the accumulation, q and do by TMA).  dk and dv are the
// same bits on every run.
//
// With kDq the owner of a step also forms dq = ds.k for the step's 64 q
// rows once it has accumulated the step, in two 64 x 128 column halves
// (issue_dq<128>: ds read from the p/ds buffer as an MN-major A, the tile's
// transpose; k as an MN-major B), each in the 64 registers that s^T and
// dp^T held.  Shared memory has no room for f32 dq tiles, so each half is
// written in f32 (128-byte swizzled) into half of the step's own stage,
// whose q and do are dead once the step is accumulated, and added to the
// caller's zeroed f32 buffer by TMA bulk tensor reductions (cp.reduce
// .async.bulk.tensor ... add, which drops rows >= S), issued as soon as the
// half is written.  The first half goes where the owner's own accumulation
// read (do for warpgroup 0, q for 1: dead at once), the second where the
// other warpgroup's did (dead at done).  The stage's next load waits until
// the reductions have read it, so the owner, which issued them, refills its
// own steps' stages.  The p/ds buffer is next written by the same
// warpgroup, two steps on, after that dq has completed.  dq's order of
// additions across blocks, and so its last bits, vary from run to run.
// Variants timed in turns with this design (PERF.md; at B 2, S 1024,
// 16 heads): adding each half from registers, two or four columns an
// atomic, 20-25 % longer; both halves written once the step is done, then
// reduced, 13 %; the first half early but both reduced together, 5 %;
// without the reductions (wrong dq) 19 % shorter.

constexpr int kWideThreads = 256;  // 2 warpgroups, no producer warp

// Tiles and dynamic shared memory: k and v (64 rows x 4 chunks each), then
// per stage q and do (the same), then per stage p and ds (one 64 x 64
// chunk each), then per stage 64 lse and 64 delta values, then the
// barriers; + 1024 bytes to align the base to a swizzle atom.
template <int D>
struct KvWideTiles {
  static_assert(D == 256, "the wide design is for D = 256");
  static constexpr int kBK = 64, kBQ = 64, kStages = 2;
  static constexpr int kTile = D / 64 * kChunk;  // one 64 x D tile
  static constexpr int kPOffset = (2 + 2 * kStages) * kTile;
  static constexpr int kRowsOffset = kPOffset + kStages * 2 * kChunk;
  static constexpr int kBarOffset = kRowsOffset + 2 * kStages * kBQ * 4;
  static constexpr int kSmem = kBarOffset + (1 + 3 * kStages) * 8 + 1024;
  static constexpr int kThreads = kWideThreads;
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
};

template <int D, bool kDq>
__device__ __forceinline__ void bwd_kv_wide(
    const CUtensorMap* map_q, const CUtensorMap* map_do,
    const CUtensorMap* map_k, const CUtensorMap* map_v,
    const CUtensorMap* map_dk, const CUtensorMap* map_dv,
    const CUtensorMap* map_dq, const float* __restrict__ lse,
    const float* __restrict__ delta, int S, int Hq, int Hkv, int causal,
    float scale, float scale_log2) {
  using T = KvWideTiles<D>;
  static_assert(T::kStages == 2, "a stage per warpgroup's step parity");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = sm;
  uint8_t* vs = sm + T::kTile;
  uint8_t* qds = sm + 2 * T::kTile;  // stage st: q at 2 st kTile, then do
  uint8_t* pds = sm + T::kPOffset;   // stage st: p at 2 st kChunk, then ds
  float* lse_s = reinterpret_cast<float*>(sm + T::kRowsOffset);
  float* delta_s = lse_s + T::kStages * T::kBQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + T::kBarOffset);
  uint64_t* full = kv_full + 1;         // a stage's q, do, lse, delta landed
  uint64_t* ready = full + T::kStages;  // a stage's p and ds written
  uint64_t* done = ready + T::kStages;  // both accumulations of a stage done

  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * T::kBK;
  const int G = Hq / Hkv;
  const int n_q = (S + T::kBQ - 1) / T::kBQ;
  const int qt0 = causal ? k0 / T::kBQ : 0;
  const int n_per_group = n_q - qt0;
  const int n_steps = G * n_per_group;

  if (threadIdx.x == 0) {
    hw::mbar_init(kv_full, 1);
    for (int st = 0; st < T::kStages; ++st) {
      hw::mbar_init(full + st, 32);    // every lane of the loading warp
      hw::mbar_init(ready + st, 128);  // every thread of the step's owner
      hw::mbar_init(done + st, 8);     // every warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  // Warps 0-3 are warpgroup 0, 4-7 warpgroup 1; the index goes through a
  // shuffle so that the compiler knows it is uniform across each warp.
  const int warp =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int wg = warp / 4, lane = threadIdx.x % 32;
  const int tid = threadIdx.x % 128;

  // Step j is (GQA head hk G + j / n_per_group, q tile qt0 + j %
  // n_per_group).  Its lse (times log2 e) and delta (times scale) of q rows
  // q0 + lane and q0 + lane + 32, by plain guarded loads (a (B, Hq, S) f32
  // row is 16-byte aligned only when S % 4 == 0, which TMA would need).
  auto fetch_rows = [&](int j, float (&r)[4]) {
    const int h = hk * G + j / n_per_group;
    const int q0 = (qt0 + j % n_per_group) * T::kBQ;
    const size_t row0 = (static_cast<size_t>(b) * Hq + h) * S;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + lane + 32 * e;
      r[e] = row < S ? lse[row0 + row] * kLog2e : 0.f;
      r[2 + e] = row < S ? delta[row0 + row] * scale : 0.f;
    }
  };
  // One warp fills stage j % kStages with step j: those rows into shared
  // memory, and (lane 0) q and do by TMA, which zero-fills rows >= S; every
  // lane arrives on the stage's full barrier, lane 0 with the bytes.
  auto fill = [&](int j, const float (&r)[4]) {
    const int st = j % T::kStages;
    const int h = hk * G + j / n_per_group;
    const int q0 = (qt0 + j % n_per_group) * T::kBQ;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lse_s[st * T::kBQ + lane + 32 * e] = r[e];
      delta_s[st * T::kBQ + lane + 32 * e] = r[2 + e];
    }
    if (lane == 0) {
      uint8_t* qs = qds + 2 * st * T::kTile;
      hw::mbar_expect_tx(full + st, 2 * T::kTile);
      for (int c = 0; c < D / 64; ++c) {
        hw::tma_load_4d(qs + c * kChunk, map_q, full + st, 64 * c, h, q0, b);
        hw::tma_load_4d(qs + T::kTile + c * kChunk, map_do, full + st, 64 * c,
                        h, q0, b);
      }
    } else {
      hw::mbar_arrive(full + st);
    }
  };

  float rows[4];
  if (warp == 0) {
    if (lane == 0) {
      hw::prefetch_map(map_q);
      hw::prefetch_map(map_do);
      hw::mbar_expect_tx(kv_full, 2 * T::kTile);
      for (int c = 0; c < D / 64; ++c) {
        hw::tma_load_4d(ks + c * kChunk, map_k, kv_full, 64 * c, hk, k0, b);
        hw::tma_load_4d(vs + c * kChunk, map_v, kv_full, 64 * c, hk, k0, b);
      }
    }
    for (int j = 0; j < min(T::kStages, n_steps); ++j) {
      fetch_rows(j, rows);
      fill(j, rows);
    }
  }

  // Warpgroup 0 accumulates dv, warpgroup 1 dk, each as two 64 x 128
  // halves (the columns of chunks 0-1 and 2-3).  Step i is owned by
  // warpgroup i % 2.  For each pair of steps (2m, 2m + 1) a warpgroup
  // computes its own step's s^T and dp^T, p and ds into the stage's p/ds
  // buffer (arriving on ready), then accumulates both steps in order.  A
  // step's stage and buffer are free once both warpgroups have accumulated
  // it (done); the warpgroup that accumulates it second in the common case,
  // the one that does not own it, then fills the stage with step + 2, from
  // lse and delta it loaded before its accumulation.  With kDq the owner
  // fills it, once its dq reductions have read the stage.
  float acc[2][64];
#pragma unroll
  for (int n = 0; n < 64; ++n) acc[0][n] = acc[1][n] = 0.f;
  const uint32_t k_addr = hw::smem_addr(ks), v_addr = hw::smem_addr(vs);
  hw::mbar_wait(kv_full, 0);
  for (int m = 0; 2 * m < n_steps; ++m) {
    const int i = 2 * m + wg;
    if (i < n_steps) {
      const int st = i % T::kStages;
      const int q0 = (qt0 + i % n_per_group) * T::kBQ;
      const uint32_t q_addr = hw::smem_addr(qds + 2 * st * T::kTile);
      hw::mbar_wait(full + st, (i / T::kStages) & 1);
      float s[32], dp[32];
      hw::wgmma_fence();
      issue_st_dpt<D>(s, dp, k_addr, v_addr, q_addr, q_addr + T::kTile);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
      hw::fence_regs(dp);
      p_ds_store(s, dp, lse_s + st * T::kBQ, delta_s + st * T::kBQ,
                 needs_mask(causal, q0, T::kBQ, k0, T::kBK, S), causal, q0, k0,
                 S, scale, scale_log2, pds + st * 2 * kChunk, warp, lane);
      hw::fence_async_shared();
      hw::mbar_arrive(ready + st);
    }
    const int j_end = min(2 * m + 2, n_steps);
    for (int j = 2 * m; j < j_end; ++j) {
      const int st = j % T::kStages;
      const uint32_t phase = (j / T::kStages) & 1;
      const int filler = kDq ? j % 2 : 1 - j % 2;
      const bool loads =
          warp % 4 == 0 && wg == filler && j + T::kStages < n_steps;
      if (loads) fetch_rows(j + T::kStages, rows);
      hw::mbar_wait(ready + st, phase);
      // A is p (warpgroup 0) or ds (1), K-major; B is do (0) or q (1),
      // MN-major; k runs over the step's 64 q rows.
      const uint32_t a = hw::smem_addr(pds + st * 2 * kChunk + wg * kChunk);
      const uint32_t bt =
          hw::smem_addr(qds + 2 * st * T::kTile + (1 - wg) * T::kTile);
      hw::wgmma_fence();
      issue_acc<128>(acc[0], a, bt);
      issue_acc<128>(acc[1], a, bt + 2 * kChunk);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc[0]);
      hw::fence_regs(acc[1]);
      if (lane == 0) hw::mbar_arrive(done + st);
      if (!kDq && loads) {
        hw::mbar_wait(done + st, phase);
        fill(j + T::kStages, rows);
      }
      if constexpr (kDq) {
        if (j % 2 == wg) {  // own step: dq = ds.k through the stage
          const int h = hk * G + j / n_per_group;
          const int q0 = (qt0 + j % n_per_group) * T::kBQ;
          const uint32_t ds_addr =
              hw::smem_addr(pds + st * 2 * kChunk + kChunk);
          uint8_t* stage = qds + 2 * st * T::kTile;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float dq[64];
            hw::wgmma_fence();
            issue_dq<128>(dq, ds_addr, k_addr + half * 2 * kChunk);
            hw::wgmma_commit();
            hw::wgmma_wait<0>();
            hw::fence_regs(dq);
            // The area is dead once every warp's accumulation has read it:
            // this warpgroup's (half 0) or both (half 1, done).
            if (half == 0) hw::named_barrier(1 + wg, 128);
            if (half == 1) hw::mbar_wait(done + st, phase);
            uint8_t* area = stage + (half ? wg : 1 - wg) * T::kTile;
            hw::store_acc_sw128_f32(area, dq);
            hw::fence_async_shared();
            hw::named_barrier(1 + wg, 128);
            if (tid == 0) {
              for (int c = 0; c < 4; ++c) {
                hw::tma_reduce_add_4d(map_dq, area + c * 8192,
                                      128 * half + 32 * c, h, q0, b);
              }
              hw::tma_store_commit();
            }
          }
          if (loads) {
            if (lane == 0) hw::tma_store_wait_read();
            fill(j + T::kStages, rows);
          }
        }
      }
    }
  }

  // Epilogue: dv (warpgroup 0) through the v buffer, dk (1) through the k
  // buffer, in bf16: each warpgroup has waited for every step's p and ds,
  // which follow that step's s^T and dp^T, so neither reads v any more; k
  // is read by dq = ds.k as well, so with kDq both warpgroups first finish
  // their last dq.  Then one TMA store per chunk, which drops rows >= S.
  if constexpr (kDq) hw::named_barrier(3, 256);
  uint8_t* out = wg == 0 ? vs : ks;
  hw::store_acc_sw128(out, acc[0]);
  hw::store_acc_sw128(out + 2 * kChunk, acc[1]);
  hw::fence_async_shared();
  hw::named_barrier(1 + wg, 128);
  if (tid == 0) {
    const CUtensorMap* map = wg == 0 ? map_dv : map_dk;
    for (int c = 0; c < D / 64; ++c) {
      hw::tma_store_4d(map, out + c * kChunk, 64 * c, hk, k0, b);
    }
    hw::tma_store_commit();
    hw::tma_store_wait_read();
  }
}

// ---------------------------------------------------------------------------
// The kv-tile kernels at D = 512 over a cluster of two blocks:
// flash_bwd_dkv_wgmma_wide<512> (dk, dv) and flash_bwd_fused_wgmma_wide<512>
// (kDq: dq as well), one body.  Two blocks on neighbouring SMs share 64 kv
// rows, block r (its rank in the cluster) owning D's columns 256 r .. 256 r
// + 255.  dk and dv of 64 kv rows at D = 512 are 2 x 64 x 512 f32, the
// whole register file of an SM; a block holds its half of each: warpgroup 0
// dv's and warpgroup 1 dk's, 64 x 256 f32 (two 64 x 128 halves, 128
// registers a thread), as bwd_kv_wide holds D = 256 whole.  Its shared
// memory holds its columns of k and v (64 KB), two stages of its columns of
// q and do for 32-row q tiles (64 KB), two p/ds buffers (32 KB: 64 kv rows
// x 32 q columns each, in rows of 128 bytes), two buffers that receive the
// peer's partials and two that stage its own (64 KB): 231,000 bytes with
// lse, delta and the barriers.  Steps (GQA head, q tile of 32 rows)
// alternate owners as in bwd_kv_wide; the owner of a step computes its
// partial s^T = k.q^T and dp^T = v.do^T over the block's 256 columns (wgmma
// m64n32k16) and exchanges them with the peer (exchange_partials: staged,
// sent by one bulk copy into the peer's buffer of the stage, the peer's
// added), so both blocks form the same sums, and from them the same bits of
// p and ds.  Then p and ds into the p/ds buffer (p_ds_store<32>) and both
// warpgroups accumulate, as in bwd_kv_wide: dv_h += p^T.do_h, dk_h +=
// ds^T.q_h (wgmma m64n128k16 on two 32-row chunks of do or q).  The
// epilogue stores each block's columns of dk and dv through its k and v
// buffers.  A cluster barrier at the start (every barrier initialised) and
// at the end (no copy or arrival still to come from the peer) brackets the
// exchange.  dk and dv are the same bits on every run.  Tried and dropped
// (scripts/torch_d256_ab.py --d 512 on an H100, PERF.md): the partials
// written into the peer by 16-byte st.shared::cluster stores (7 % slower),
// s^T's half sent while dp^T is still on the tensor cores (no gain beyond
// the spread), and the other warpgroup's accumulation issued while the
// peer's partials arrive (30 % slower).
//
// With kDq the owner of a step also forms dq = ds.k for the step's 32 q
// rows over the block's 256 columns once it has accumulated the step.
// wgmma's 64 rows cannot be the step's 32 q rows, so it forms the
// transpose, dq^T = k^T.ds^T (issue_dqt: a 64-column chunk of k read as an
// MN-major A, ds^T from the p/ds buffer as an MN-major B), in two passes of
// two chunks (128 columns, 32 registers, in those that s^T and dp^T held:
// 64 would not fit beside dk or dv).  As in bwd_kv_wide, shared memory has
// no room for an f32 dq tile: a pass's 32 x 128 f32 (16 KB) is written,
// transposed (store_dqt_f32), into half of the step's own stage and added
// to the caller's zeroed f32 buffer by TMA bulk tensor reductions (which
// drop rows >= S): the first pass where the owner's own accumulation read
// (do for warpgroup 0, q for 1: dead at once), the second where the other
// warpgroup's did (dead at done).  The owner refills its steps' stages once
// its reductions have read them.  dq's order of additions across blocks,
// and so its last bits, vary from run to run.  Adding each pass from
// registers by float4 atomics instead was 10-17 % slower (PERF.md).

// Bytes of one warpgroup's partial s and dp (16 f32 registers each, a
// thread's of an m64n32 accumulator) that exchange_partials sends.
constexpr int kPartialBytes = 2 * 16 * 128 * 4;

struct KvClusterTiles {
  static constexpr int kCols = 256;  // a block's columns of D = 512
  static constexpr int kBK = 64, kBQ = 32, kStages = 2;
  static constexpr int kChunkQ = kBQ * 128;     // a 32-row chunk: q, do
  static constexpr int kKv = kCols / 64 * kChunk;  // a block's k or v: 32 KB
  static constexpr int kQ = kCols / 64 * kChunkQ;  // its q or do: 16 KB
  static constexpr int kStageOffset = 2 * kKv;
  static constexpr int kPOffset = kStageOffset + kStages * 2 * kQ;
  static constexpr int kXOffset = kPOffset + kStages * 2 * kChunk;
  static constexpr int kX = kPartialBytes;  // a step's s^T and dp^T
  static constexpr int kYOffset = kXOffset + kStages * kX;  // staging
  static constexpr int kRowsOffset = kYOffset + kStages * kX;
  static constexpr int kBarOffset = kRowsOffset + 2 * kStages * kBQ * 4;
  static constexpr int kSmem = kBarOffset + (1 + 5 * kStages) * 8 + 1024;
  static constexpr int kThreads = kWideThreads;
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
  static_assert(kQ == kBQ * 128 * 4,
                "a dq pass (kBQ x 128 f32) fills a stage's q or do");
};

// Sums a warpgroup's partial products of one step (s and dp: 16 f32
// registers a thread each, an m64n32 accumulator over the block's columns)
// with the peer block's, which holds the same step over the other columns.
// This thread's 32 partials are staged in `y` (16-byte group e of thread
// tid at (e 128 + tid) 16) and sent by one bulk copy into the peer's buffer
// `x_peer`, once the peer has read that buffer's previous partials (its
// release arrival on this block's `xempty`, which also means that copy has
// read `y`); then the peer's partials are awaited in `x` (`xfull`), added
// (f32 addition commutes, so both blocks form the same sums) and `x`
// released to the peer (`xempty_peer`).  `round` is the parity of this use
// of the buffers, `bar` the warpgroup's named barrier.
__device__ __forceinline__ void exchange_partials(
    float (&s)[16], float (&dp)[16], uint8_t* y, const uint8_t* x,
    uint32_t x_peer, uint64_t* xfull, uint32_t xfull_peer, uint64_t* xempty,
    uint32_t xempty_peer, uint32_t round, int bar) {
  const int tid = threadIdx.x % 128;
  hw::mbar_wait<true>(xempty, round ^ 1);
  float4* yt = reinterpret_cast<float4*>(y) + tid;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    yt[e * 128] =
        make_float4(s[4 * e], s[4 * e + 1], s[4 * e + 2], s[4 * e + 3]);
    yt[(4 + e) * 128] =
        make_float4(dp[4 * e], dp[4 * e + 1], dp[4 * e + 2], dp[4 * e + 3]);
  }
  hw::fence_async_shared();
  hw::named_barrier(bar, 128);
  if (tid == 0) {
    hw::mbar_expect_tx(xfull, kPartialBytes);
    hw::bulk_copy_cluster(x_peer, y, kPartialBytes, xfull_peer);
  }
  hw::mbar_wait(xfull, round);
  const float4* xt = reinterpret_cast<const float4*>(x) + tid;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 a = xt[e * 128], c = xt[(4 + e) * 128];
    s[4 * e] += a.x;
    s[4 * e + 1] += a.y;
    s[4 * e + 2] += a.z;
    s[4 * e + 3] += a.w;
    dp[4 * e] += c.x;
    dp[4 * e + 1] += c.y;
    dp[4 * e + 2] += c.z;
    dp[4 * e + 3] += c.w;
  }
  hw::mbar_arrive_cluster(xempty_peer);
}

template <bool kDq>
__device__ __forceinline__ void bwd_kv_cluster(
    const CUtensorMap* map_q, const CUtensorMap* map_do,
    const CUtensorMap* map_k, const CUtensorMap* map_v,
    const CUtensorMap* map_dk, const CUtensorMap* map_dv,
    const CUtensorMap* map_dq, const float* __restrict__ lse,
    const float* __restrict__ delta, int S, int Hq, int Hkv, int causal,
    float scale, float scale_log2) {
  using T = KvClusterTiles;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = sm;
  uint8_t* vs = sm + T::kKv;
  uint8_t* qds = sm + T::kStageOffset;  // stage st: q at 2 st kQ, then do
  uint8_t* pds = sm + T::kPOffset;      // stage st: p at 2 st kChunk, then ds
  uint8_t* xs = sm + T::kXOffset;       // stage st's partials from the peer
  uint8_t* ys = sm + T::kYOffset;       // stage st's partials to the peer
  float* lse_s = reinterpret_cast<float*>(sm + T::kRowsOffset);
  float* delta_s = lse_s + T::kStages * T::kBQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + T::kBarOffset);
  uint64_t* full = kv_full + 1;           // a stage's q, do, lse, delta landed
  uint64_t* ready = full + T::kStages;    // a stage's p and ds written
  uint64_t* done = ready + T::kStages;    // both accumulations of a stage done
  uint64_t* xfull = done + T::kStages;    // the peer's partials landed
  uint64_t* xempty = xfull + T::kStages;  // the peer read this block's partials

  const uint32_t rank = hw::cluster_rank(), peer = rank ^ 1;
  const int col0 = static_cast<int>(rank) * T::kCols;
  const int hk = blockIdx.x / 2, b = blockIdx.z;
  const int k0 = blockIdx.y * T::kBK;
  const int G = Hq / Hkv;
  const int n_q = (S + T::kBQ - 1) / T::kBQ;
  const int qt0 = causal ? k0 / T::kBQ : 0;
  const int n_per_group = n_q - qt0;
  const int n_steps = G * n_per_group;

  if (threadIdx.x == 0) {
    hw::mbar_init(kv_full, 1);
    for (int st = 0; st < T::kStages; ++st) {
      hw::mbar_init(full + st, 32);     // every lane of the loading warp
      hw::mbar_init(ready + st, 128);   // every thread of the step's owner
      hw::mbar_init(done + st, 8);      // every warp
      hw::mbar_init(xfull + st, 1);     // the owner's expect_tx, + the copy
      hw::mbar_init(xempty + st, 128);  // every thread of the peer's owner
    }
    hw::fence_barrier_init();
  }
  hw::cluster_sync();

  const int warp =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int wg = warp / 4, lane = threadIdx.x % 32;
  const int tid = threadIdx.x % 128;

  // Step j is (GQA head hk G + j / n_per_group, q tile qt0 + j %
  // n_per_group); its lse (times log2 e) and delta (times scale) of q row
  // q0 + lane, by plain guarded loads, and its q and do columns by TMA.
  auto fetch_rows = [&](int j, float (&r)[2]) {
    const int h = hk * G + j / n_per_group;
    const int row = (qt0 + j % n_per_group) * T::kBQ + lane;
    const size_t row0 = (static_cast<size_t>(b) * Hq + h) * S;
    r[0] = row < S ? lse[row0 + row] * kLog2e : 0.f;
    r[1] = row < S ? delta[row0 + row] * scale : 0.f;
  };
  auto fill = [&](int j, const float (&r)[2]) {
    const int st = j % T::kStages;
    const int h = hk * G + j / n_per_group;
    const int q0 = (qt0 + j % n_per_group) * T::kBQ;
    lse_s[st * T::kBQ + lane] = r[0];
    delta_s[st * T::kBQ + lane] = r[1];
    if (lane == 0) {
      uint8_t* qs = qds + 2 * st * T::kQ;
      hw::mbar_expect_tx(full + st, 2 * T::kQ);
      for (int c = 0; c < T::kCols / 64; ++c) {
        hw::tma_load_4d(qs + c * T::kChunkQ, map_q, full + st, col0 + 64 * c, h,
                        q0, b);
        hw::tma_load_4d(qs + T::kQ + c * T::kChunkQ, map_do, full + st,
                        col0 + 64 * c, h, q0, b);
      }
    } else {
      hw::mbar_arrive(full + st);
    }
  };

  float rows[2];
  if (warp == 0) {
    if (lane == 0) {
      hw::prefetch_map(map_q);
      hw::prefetch_map(map_do);
      hw::mbar_expect_tx(kv_full, 2 * T::kKv);
      for (int c = 0; c < T::kCols / 64; ++c) {
        hw::tma_load_4d(ks + c * kChunk, map_k, kv_full, col0 + 64 * c, hk, k0,
                        b);
        hw::tma_load_4d(vs + c * kChunk, map_v, kv_full, col0 + 64 * c, hk, k0,
                        b);
      }
    }
    for (int j = 0; j < min(T::kStages, n_steps); ++j) {
      fetch_rows(j, rows);
      fill(j, rows);
    }
  }

  float acc[2][64];
#pragma unroll
  for (int n = 0; n < 64; ++n) acc[0][n] = acc[1][n] = 0.f;
  const uint32_t k_addr = hw::smem_addr(ks), v_addr = hw::smem_addr(vs);
  const uint32_t x_peer = hw::map_rank(hw::smem_addr(xs), peer);
  const uint32_t xfull_peer = hw::map_rank(hw::smem_addr(xfull), peer);
  const uint32_t xempty_peer = hw::map_rank(hw::smem_addr(xempty), peer);
  hw::mbar_wait(kv_full, 0);
  for (int m = 0; 2 * m < n_steps; ++m) {
    const int i = 2 * m + wg;
    if (i < n_steps) {
      const int st = i % T::kStages;
      const uint32_t round = (i / T::kStages) & 1;
      const int q0 = (qt0 + i % n_per_group) * T::kBQ;
      const uint32_t q_addr = hw::smem_addr(qds + 2 * st * T::kQ);
      hw::mbar_wait(full + st, round);
      float s[16], dp[16];
      hw::wgmma_fence();
      issue_st_dpt<T::kCols, T::kBQ>(s, dp, k_addr, v_addr, q_addr,
                                     q_addr + T::kQ);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
      hw::fence_regs(dp);
      exchange_partials(s, dp, ys + st * T::kX, xs + st * T::kX,
                        x_peer + st * T::kX, xfull + st, xfull_peer + st * 8,
                        xempty + st, xempty_peer + st * 8, round, 1 + wg);
      p_ds_store<T::kBQ>(s, dp, lse_s + st * T::kBQ, delta_s + st * T::kBQ,
                         needs_mask(causal, q0, T::kBQ, k0, T::kBK, S), causal,
                         q0, k0, S, scale, scale_log2, pds + st * 2 * kChunk,
                         warp, lane);
      hw::fence_async_shared();
      hw::mbar_arrive(ready + st);
    }
    const int j_end = min(2 * m + 2, n_steps);
    for (int j = 2 * m; j < j_end; ++j) {
      const int st = j % T::kStages;
      const uint32_t phase = (j / T::kStages) & 1;
      const int filler = kDq ? j % 2 : 1 - j % 2;
      const bool loads =
          warp % 4 == 0 && wg == filler && j + T::kStages < n_steps;
      if (loads) fetch_rows(j + T::kStages, rows);
      hw::mbar_wait(ready + st, phase);
      // A is p (warpgroup 0) or ds (1), K-major; B is do (0) or q (1),
      // MN-major; k runs over the step's 32 q rows.
      const uint32_t a = hw::smem_addr(pds + st * 2 * kChunk + wg * kChunk);
      const uint32_t bt =
          hw::smem_addr(qds + 2 * st * T::kQ + (1 - wg) * T::kQ);
      hw::wgmma_fence();
      issue_acc<128, T::kBQ>(acc[0], a, bt);
      issue_acc<128, T::kBQ>(acc[1], a, bt + 2 * T::kChunkQ);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc[0]);
      hw::fence_regs(acc[1]);
      if (lane == 0) hw::mbar_arrive(done + st);
      if (!kDq && loads) {
        hw::mbar_wait(done + st, phase);
        fill(j + T::kStages, rows);
      }
      if constexpr (kDq) {
        if (j % 2 == wg) {  // own step: dq = ds.k through the stage
          const int h = hk * G + j / n_per_group;
          const int q0 = (qt0 + j % n_per_group) * T::kBQ;
          const uint32_t ds_addr =
              hw::smem_addr(pds + st * 2 * kChunk + kChunk);
          uint8_t* stage = qds + 2 * st * T::kQ;
#pragma unroll
          for (int pass = 0; pass < 2; ++pass) {
            float dqt[2][16];
            hw::wgmma_fence();
            issue_dqt(dqt[0], k_addr + 2 * pass * kChunk, ds_addr);
            issue_dqt(dqt[1], k_addr + (2 * pass + 1) * kChunk, ds_addr);
            hw::wgmma_commit();
            hw::wgmma_wait<0>();
            hw::fence_regs(dqt[0]);
            hw::fence_regs(dqt[1]);
            // The area is dead once every warp's accumulation has read it:
            // this warpgroup's (pass 0) or both (pass 1, done).
            if (pass == 0) hw::named_barrier(1 + wg, 128);
            if (pass == 1) hw::mbar_wait(done + st, phase);
            uint8_t* area = stage + (pass ? wg : 1 - wg) * T::kQ;
            store_dqt_f32(area, dqt[0], 0);
            store_dqt_f32(area, dqt[1], 64);
            hw::fence_async_shared();
            hw::named_barrier(1 + wg, 128);
            if (tid == 0) {
              for (int c = 0; c < 4; ++c) {
                hw::tma_reduce_add_4d(map_dq, area + c * 4096,
                                      col0 + 128 * pass + 32 * c, h, q0, b);
              }
              hw::tma_store_commit();
            }
          }
          if (loads) {
            if (lane == 0) hw::tma_store_wait_read();
            fill(j + T::kStages, rows);
          }
        }
      }
    }
  }

  // Epilogue: this block's columns of dv (warpgroup 0) through the v buffer
  // and of dk (1) through the k buffer, in bf16 (neither is read once each
  // warpgroup has waited for every step's p and ds, but k is read by dq =
  // ds.k as well, so with kDq both warpgroups first finish their last dq),
  // one TMA store a chunk.
  if constexpr (kDq) hw::named_barrier(3, 256);
  uint8_t* out = wg == 0 ? vs : ks;
  hw::store_acc_sw128(out, acc[0]);
  hw::store_acc_sw128(out + 2 * kChunk, acc[1]);
  hw::fence_async_shared();
  hw::named_barrier(1 + wg, 128);
  if (tid == 0) {
    const CUtensorMap* map = wg == 0 ? map_dv : map_dk;
    for (int c = 0; c < T::kCols / 64; ++c) {
      hw::tma_store_4d(map, out + c * kChunk, col0 + 64 * c, hk, k0, b);
    }
    hw::tma_store_commit();
    hw::tma_store_wait_read();
  }
  hw::cluster_sync();
}

// Launches `kernel` on `grid` in clusters of two blocks along x, with
// kWideThreads threads and `smem` bytes of dynamic shared memory (opted in
// by the caller).  A launch the card refuses (a grid dimension out of
// range, no room for a cluster) returns the launch's own error.
template <typename... Params, typename... Args>
int launch_cluster_pair(void (*kernel)(Params...), dim3 grid, int smem,
                        cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 2;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kWideThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&config, kernel, static_cast<Args&&>(args)...);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Hopper grants a block at most 227 KB of shared memory.  The tiles do not
// grow with S, so a kernel that fits here fits every shape.
constexpr size_t kMaxSmem = 227 * 1024;

}  // namespace tdx_bwd
