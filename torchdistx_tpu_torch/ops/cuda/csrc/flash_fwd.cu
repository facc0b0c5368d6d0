// Flash-attention forward for Hopper (sm_90a), causal or not, with GQA.
//
// Replaces torchdistx_tpu/ops/pallas/flash_attention.py:_fwd_kernel, the
// Pallas TPU forward launched by _fa_forward_padded.  Same arithmetic:
// logits = q.k^T * (scale * log2 e) accumulated in f32, masked logits set to
// the finite -1e30 (so the rescale term never computes inf - inf), an
// online softmax in the log2 domain with f32 running max m, sum l and
// accumulator, p cast to v's dtype before the P.V product, rows with l == 0
// guarded to 1, out = acc / l in q's dtype and lse = m / log2 e + log(l)
// (natural log, f32).
//
// Layout: q (B, S, Hq, D), k/v (B, S, Hkv, D), out like q, lse (B, Hq, S);
// all contiguous and read in place, so the model's (B, S, H, D) activations
// need no transpose.  Any S, with no padding copies.  The TPU grid's
// sequential kv axis becomes a loop over kv tiles, bounded at the causal
// diagonal (the Pallas kernel's _diag_clamp is DMA elision and reduces to
// that bound).
//
// bf16 (flash_fwd_bf16_wgmma), built from hopper.cuh.  Persistent: one block
// per SM, or one per unit of work where there are fewer, walks its units
// (hopper.cuh's ForwardWorks) in the order forward_order chooses from each
// order's busiest block (busiest_block, the same struct walked on the host).
// Pairs: a unit is the q tiles n_q - 1 - p and p of one (batch, head), 128 rows
// each, so that every causal unit holds the same work and the second tile reads
// kv tiles the block has just read; taken where no block is then busier than
// with single tiles (Llama-7B's 4 x 512 and 70B's GQA heads: single tiles were
// 2.5-7 % slower there at equal balance on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md).  Single q tiles, longest first, in a snake over the blocks: where
// pairs would leave SMs idle (B x H x n_q / 2 below the SM count: the 1 x 512
// mesh and pipeline blocks run on 64-128 blocks, not 32-64, their busiest block
// doing 4 kv tiles, not 5) or unbalanced (GPT-2 XL's 4 x 1024 x 25 heads: 28 kv
// tiles on the busiest block, not 36); head-major (a head's tiles side by side,
// k and v shared in L2) or, where it balances better, tile-major (every head's
// last tile, then the tiles before them).  A block has two consumer warpgroups
// (64 q rows each) and one producer warp.  One producer thread loads each
// unit's q tiles into one of two q buffers (the next one's q streams in during
// this one) and k and v tiles of 128 rows by TMA into a ring of kStages stages,
// numbered across works (2 at D = 128: 2 x q 32 KB + 2 x (k 32 KB + v 32 KB) =
// 192 KB of dynamic shared memory; 4 at D = 64), each stage with its own
// k-full, v-full and empty mbarrier, so the next tile, of this work or the
// next, streams in while one is multiplied.  TMA zero-fills rows >= S, so loads
// need no guard.  Per kv tile a consumer computes s = q.k^T with wgmma
// m64n128k16 (both operands K-major in shared memory), takes the online softmax
// in registers, and adds p.v with wgmma m64nDk16, p from registers (the s
// accumulator packed pairwise to bf16 is the A fragment, see hopper.cuh) and v
// from shared memory as an MN-major operand, so v needs no transpose copy.  The
// two consumers take turns to issue their products (ping-pong on two named
// barriers), so one's softmax runs while the other's wgmma does; a warp
// releases the stage after wgmma_wait for both products.  kv tiles run from the
// last to the first, so the one tile that needs the mask (the causal diagonal,
// or the ragged tile holding columns >= S when not causal: the Pallas kernel's
// _needs_mask, with kv tiles aligned to the q tile) comes first, and every
// other tile skips the iota/compare/select and folds the scale into its
// exponent's FFMA.  A work's epilogue takes 1 / l once a row and o / l by
// div_rn (three FMAs, the division's bits; the division itself was a large
// share of the epilogue, which knocked out took 17-28 % off the bytes-bound
// rows on that card, PERF.md), writes out through the warpgroup's half of its q
// buffer by stmatrix and a TMA store, which drops rows >= S, and lse directly.
// out and lse are the same bits under every work order and as with the plain
// division (kv tiles and their order do not change).
//
// bf16 at D = 256 (flash_fwd_bf16_wgmma<256>, Bf16Tiles::kSplit): a 64 x
// 256 f32 accumulator is 128 registers a thread, and beside a tile's s and
// p it does not fit the 168 that ptxas gives a thread of a 288-thread
// block.  So the two consumer warpgroups share one work of 64 q rows and
// split o's columns: each holds 64 x 128 (64 registers), computes the same
// s = q.k^T (m64n64k16 over the 4 chunks of q and k) and softmax, and adds
// p.v for its 128 columns of v (m64n128k16, v's chunks 2w and 2w + 1 as
// the MN-major operand).  kv tiles are 64 rows, so a q buffer is 32 KB and
// a stage of k and v 64 KB: 2 x 32 + 2 x 64 = 192 KB, as at D = 128.  The
// epilogue waits for both warpgroups (named barrier 5) before either
// writes its columns of out into the q buffer.  146 registers, no spills.
// Its 64-row q tiles follow the same work rule: pairs at 2 x 1024 x 16
// heads, single tiles at the D = 256 path's 1 x 2112 x 4 heads (132
// blocks, not 68: 6 % faster on that card, PERF.md).
// Tried and dropped (scripts/torch_d256_ab.py on an H100, PERF.md): 128 q
// rows a block with o whole in each warpgroup (256 threads, no producer
// warp, 209 registers), which computes q.k^T once and reads each kv tile
// for twice the rows, was no faster at 2 x 1024 x 16 heads and 1.8x slower
// at 1 x 2112 x 4 heads (half the blocks); a third kv stage (one q buffer,
// out from registers) moved nothing.
//
// bf16 at D = 512 (flash_fwd_bf16_wgmma<512>, its own body): a 64 x 512
// f32 accumulator is 256 registers a thread, and split over two warpgroups
// (64 x 256 each, 128 registers) it does not fit the 168 of a 288-thread
// block beside s and p.  So a block is 256 threads, two warpgroups and no
// producer warp (up to 255 registers; 180 used, no spills), one thread
// issuing the TMA loads.  Both warpgroups share one 64-row q tile, compute
// the same s = q.k^T (m64n32k16 over q's 8 chunks) and softmax, and each
// adds p.v for its 256 of o's columns (m64n256k16, p from registers), in
// ping-pong as above.  A 64 x 512 q tile is 64 KB, and so is a 64-row k
// or v tile, so two stages of 64-row k and v do not fit beside q: kv tiles
// are 32 rows, and k and v take turns through five 32 KB slots (64 + 160
// KB), loaded by TMA as soon as a slot's previous tensor has been read.
// One block per 64-row q tile, not persistent: with one q buffer a block's
// next q could not stream in during its epilogue.  Where every row of a
// warp keeps its max, o's rescale is skipped (alpha is exactly 1: no bit
// changes).  At B 2, S 1024, 8 heads (the 17.2 GFLOP and 67 MB of D =
// 256's shape) bytes bound it (20 us); it takes about five times that
// (PERF.md), the redundant q.k^T on 32-column products (each 64 x 16 A
// tile read from shared memory for 32 columns) being the price of keeping
// the softmax of one warpgroup under the other's products.  Tried and
// dropped (scripts/torch_d256_ab.py --d 512 on an H100, PERF.md): one
// warpgroup computing s, the softmax and alpha, p written to shared memory
// in bf16, both adding p.v as a shared-memory A product (q.k^T once, not
// twice): 25 % slower, the softmax no longer under any product.
//
// f32 at D 64, 128, 256 and 512: flash_q_f32.cuh's q_f32_tiled<D, false>,
// on the CUDA cores (no TF32, which the 1e-4 gates would see), the dq
// kernel's body with the softmax in place of p and ds.  Register-blocked
// products from 16-byte shared loads (s as 4 x 4 pairs a thread, o += p.v
// as 4 x 8 blocks at D 128), the softmax's row max by shuffles over the
// lanes of a row, k and v through a two-stage cp.async ring, q tiles of 64
// rows (32 at D 256, 16 at D 512).  Bound by operations: at the f32 train
// gates' 4 x 512, 32 heads of 128, causal, 8.6 GFLOP take 0.1285 ms at 67
// TFLOP/s; it takes 0.3275 ms there on an NVIDIA H100 80GB HBM3 at 700 W
// (39 % of the bound; SDPA's f32 forward 0.2736, PERF.md).
//
// What bounds it on an H100 SXM: at the Llama-7B training shape B 4, S 512, 32
// heads, D 128, bf16, causal, q, k, v and out are 16.8 MB each, 67 MB in all:
// 20 us at 3.35 TB/s, against 4 B H D S(S+1)/2 = 8.6 GFLOP, 8.7 us at the 989
// TFLOP/s dense bf16 tensor rate, so bytes bound it; at B 1, S 4096 the 137
// GFLOP take 139 us at that rate against 34 MB in 10 us, so operations do
// (from S of about 1200 up, or with GQA).  What this design leaves on the
// table: each consumer waits for one product before its next step.  Overlapping
// a tile's softmax with its own next q.k^T needs s, p and o (about 200
// registers at D = 128) live at once, and ptxas holds a thread of this kernel
// to 168: three warps share each SM quarter's 16 K registers.  A producer
// warpgroup at 24 registers and consumers raised to 240 (setmaxnreg.dec /
// .inc, as FlashAttention-3 has) gave the consumers nothing:
// USETMAXREG.TRY_ALLOC 0xf0 is in the SASS, but the code after it names no
// register above R165 and spills (33 STL / 28 LDL, 156 bytes at D = 128; nvcc
// 12.9), also with __maxnreg__(168) in place of the launch bounds and with
// ptxas --register-usage-level=10; it ran 2x slower at D = 128, and at D = 64
// (4 bytes spilled) it was slower than without the overlap (PERF.md, NVIDIA
// H100 80GB HBM3, 700 W): the SASS shows why an earlier try spilled at 384
// threads with setmaxnreg granting 232.  __maxnreg__(224) at 288 threads
// compiles without spills, but the launch is refused for want of
// registers.  Tried and dropped at D = 64 (the same card): kv tiles of 192 rows
// (11 % slower at 4 x 1024 x 25 heads, spilling at 168).  At D = 64 the step is
// mostly not products: on GPT-2 XL's heads a kv step takes about twice its
// products' time, the softmax's 2^x alone about a tenth (PERF.md).
// At D = 256 (B 2, S 1024, 16 heads, causal: 17.2 GFLOP, 17 us at the
// tensor rate, against 67 MB in 20 us) bytes bound it; the split design
// does q.k^T twice, 1.5x the tensor work, and each 64-column q.k^T reads
// both operands from shared memory (4 KB a 64 x 64 x 16 product, about the
// port's rate), so it runs near half the tensor rate on what it executes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "flash_q_f32.cuh"
#include "hopper.cuh"

namespace {

namespace hw = tdx::hopper;

constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 kernel's tiles and dynamic shared memory: two q buffers (each
// kBQ / 64 x D / 64 chunks of 64 rows), then per stage k and v (D / 64
// chunks of kBK rows each), then the barriers; + 1024 bytes to align the
// base to a swizzle atom.  A work (ForwardWorks: a unit is one q tile or a
// pair of them) is one q tile of kBQ rows at a time.  Below D = 256 that is
// 128 q rows, 64 for each consumer warpgroup, against kv tiles of 128, at
// D = 64 too (192-row kv tiles spilled and were slower, PERF.md),
// with four stages there, each half the bytes of D = 128's.  At D = 256
// (kSplit) the two warpgroups share one tile of 64 q rows and split o's
// columns, 128 each, against kv tiles of 64: both compute the same s and
// p, and each adds p.v for its half of v's columns.
template <int D>
struct Bf16Tiles {
  static constexpr bool kSplit = D == 256;
  static constexpr int kBQ = kSplit ? 64 : 128, kBK = kSplit ? 64 : 128;
  static constexpr int kOCols = kSplit ? D / 2 : D;  // o's columns a warpgroup
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kChunks = D / 64;
  static constexpr int kChunkQ = 64 * 128;    // bytes of a 64-row chunk
  static constexpr int kChunkKV = kBK * 128;  // bytes of a kBK-row chunk
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;  // k or v of one stage
  static constexpr int kBarOffset = 2 * kQBytes + kStages * 2 * kKVBytes;
  static constexpr int kSmem = kBarOffset + (4 + 3 * kStages) * 8 + 1024;
  static constexpr int kThreads = 288;  // 2 consumer warpgroups + 1 warp
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
};

// At D = 512 (flash_fwd_bf16_wgmma<512>, its own body below): one block of
// two warpgroups and no producer warp per 64-row q tile, o's columns split
// (256 each), kv tiles of 32 rows.  One q buffer (8 chunks of 64 rows, 64
// KB), then kSlots slots of 32 KB, each holding one kv tile's k or v (8
// chunks of 32 rows): the block's n-th load (k of its i-th tile at n = 2i,
// v at 2i + 1) goes to slot n % kSlots; then a full and an empty barrier a
// slot and q's full barrier; + 1024 bytes to align the base.
template <>
struct Bf16Tiles<512> {
  static constexpr int kBQ = 64, kBK = 32;
  static constexpr int kOCols = 256;  // o's columns a warpgroup
  static constexpr int kChunks = 8;
  static constexpr int kChunkQ = 64 * 128;    // bytes of a 64-row chunk
  static constexpr int kChunkKV = kBK * 128;  // bytes of a 32-row chunk
  static constexpr int kQBytes = kBQ * 512 * 2;
  static constexpr int kKVBytes = kBK * 512 * 2;  // one slot: k or v
  static constexpr int kSlots = 5;
  static constexpr int kBarOffset = kQBytes + kSlots * kKVBytes;
  static constexpr int kSmem = kBarOffset + (1 + 2 * kSlots) * 8 + 1024;
  static constexpr int kThreads = 256;  // 2 warpgroups, no producer warp
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
};

// A consumer warpgroup's steps on one kv tile.  s: the 64 x kBK logits;
// p: s packed pairwise to bf16, the A fragments of p.v (accumulator columns
// 16kk .. 16kk + 15 are the kk-th step's fragment, see hopper.cuh); o: the
// 64 x kOCols accumulator; m: the row max in the log2 domain; l: this
// thread's share of the row sum (the four threads of a row are summed at
// the end).

// Issues s = q.k^T (not committed).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Bf16Tiles<D>::kBK / 2],
                                         uint32_t q_addr, uint32_t k_addr) {
  using T = Bf16Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte chunk row
    const uint32_t q = q_addr + (kk / 4) * T::kChunkQ + col;
    const uint32_t k = k_addr + (kk / 4) * T::kChunkKV + col;
    hw::wgmma_ss(s, hw::sw128_desc(q, 16, 1024), hw::sw128_desc(k, 16, 1024),
                 kk > 0);
  }
}

// Issues o += p.v (not committed); v_addr is the first of the warpgroup's
// kOCols / 64 chunks of v.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[Bf16Tiles<D>::kOCols / 2],
    const uint32_t (&p)[Bf16Tiles<D>::kBK / 16][4], uint32_t v_addr) {
  using T = Bf16Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < T::kBK / 16; ++kk) {
    hw::wgmma_rs(o, p[kk],
                 hw::sw128_desc(v_addr + kk * 16 * 128, T::kChunkKV, 1024));
  }
}

// 2^x by the special-function unit alone (exp2f adds a range check and two
// conditional multiplies).  Results below 2^-126 flush to 0, far under what
// p's bf16 rounding or l's f32 sum can see.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x / l rounded to nearest, as the division x / l gives it, from r = 1 / l
// rounded to nearest (taken once a row): q = x r is within an ulp of the
// quotient, and one correction with the remainder x - q l (exact by FMA)
// rounds to it (Markstein's theorem, for normal operands; l is at least
// 1 here).  Three FMA-pipe instructions in place of a division each.
__device__ __forceinline__ float div_rn(float x, float l, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, l, x), r, q);
}

// The online softmax update of one tile: m to the new row max of the
// logits in the log2 domain, s to p = exp2(s * scale_log2 - m), l rescaled
// and summed; returns in alpha the factor exp2(m_old - m_new) that o still
// has to be scaled by.  On a masked tile, pairs past S or above the causal
// diagonal take the logit kMask; elsewhere the scale is folded into the
// exponent (the max of s scaled is the scaled max, the scale being > 0).
template <bool kMasked, int N>
__device__ __forceinline__ void softmax(float (&s)[N], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int k0, int r0, int t, int S,
                                        float scale_log2, int causal) {
  if (kMasked) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = r0 + (e & 2) * 4;
        const bool keep = col < S && (!causal || col <= row);
        s[4 * j + e] = keep ? s[4 * j + e] * scale_log2 : kMask;
      }
    }
  }
  const float scale = kMasked ? 1.f : scale_log2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four threads of a quad share a row
    float mx = fmaxf(s[2 * r], s[2 * r + 1]);
#pragma unroll
    for (int j = 1; j < N / 4; ++j) {
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale);
    alpha[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[4 * j + e] = exp2_ftz(fmaf(s[4 * j + e], scale, -m_new));
        sum += s[4 * j + e];
      }
    }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// p = s cast to bf16, as A fragments.
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N / 8][4],
                                       const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[kk][i] = pack_f32(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    o[4 * n] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(Bf16Tiles<D>::kThreads, 1)
flash_fwd_bf16_wgmma(__grid_constant__ const CUtensorMap tm_q,
                     __grid_constant__ const CUtensorMap tm_k,
                     __grid_constant__ const CUtensorMap tm_v,
                     __grid_constant__ const CUtensorMap tm_o,
                     float* __restrict__ lse, int B, int S, int Hq, int Hkv,
                     float scale_log2, int causal, int order) {
  using T = Bf16Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm;                    // q buffer j at j * kQBytes
  uint8_t* kvs = sm + 2 * T::kQBytes;  // stage st: k at st * 2 * kKVBytes, v
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + T::kBarOffset);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + T::kStages;
  uint64_t* kv_empty = v_full + T::kStages;

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      hw::mbar_init(q_full + j, 1);
      hw::mbar_init(q_empty + j, 2);  // one arrival per consumer warpgroup
    }
    for (int st = 0; st < T::kStages; ++st) {
      hw::mbar_init(k_full + st, 1);
      hw::mbar_init(v_full + st, 1);
      hw::mbar_init(kv_empty + st, 8);  // one arrival per consumer warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  // Both roles walk the same works and number their kv tiles across them:
  // the block's i-th kv tile goes to stage i % kStages, its round's parity
  // flips every kStages tiles, and the j-th work's q to buffer j % 2, its
  // parity flipping every two works; first-round empty waits pass.
  const int n_q = (S + T::kBQ - 1) / T::kBQ;
  auto n_tiles_of = [&](int q0) {
    return causal ? (min(q0 + T::kBQ, S) - 1) / T::kBK + 1
                  : (S + T::kBK - 1) / T::kBK;
  };

  // Warps 0-7 are consumer warpgroups 0 and 1, warp 8 the producer; the
  // index goes through a shuffle so that the compiler knows it is uniform
  // across each warp.
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    if (threadIdx.x == 256) {
      hw::prefetch_map(&tm_q);
      hw::prefetch_map(&tm_k);
      hw::prefetch_map(&tm_v);
      int tile = 0;
      int j = 0;
      for (hw::ForwardWorks w(n_q, Hq, B, order, blockIdx.x, gridDim.x);
           !w.done(); w.next(), ++j) {
        const int q0 = w.tile() * T::kBQ, h = w.head(), b = w.batch();
        const int hk = h / (Hq / Hkv), n_tiles = n_tiles_of(q0);
        uint8_t* qj = qs + (j % 2) * T::kQBytes;
        hw::mbar_wait(q_empty + j % 2, ((j / 2) & 1) ^ 1);
        hw::mbar_expect_tx(q_full + j % 2, T::kQBytes);
        for (int half = 0; half < T::kBQ / 64; ++half) {
          for (int c = 0; c < T::kChunks; ++c) {
            hw::tma_load_4d(qj + (half * T::kChunks + c) * T::kChunkQ, &tm_q,
                            q_full + j % 2, 64 * c, h, q0 + 64 * half, b);
          }
        }
        for (int i = 0; i < n_tiles; ++i, ++tile) {
          const int st = tile % T::kStages;
          const int k0 = (n_tiles - 1 - i) * T::kBK;
          uint8_t* ks = kvs + st * 2 * T::kKVBytes;
          hw::mbar_wait(kv_empty + st, ((tile / T::kStages) & 1) ^ 1);
          hw::mbar_expect_tx(k_full + st, T::kKVBytes);
          for (int c = 0; c < T::kChunks; ++c) {
            hw::tma_load_4d(ks + c * T::kChunkKV, &tm_k, k_full + st, 64 * c,
                            hk, k0, b);
          }
          hw::mbar_expect_tx(v_full + st, T::kKVBytes);
          for (int c = 0; c < T::kChunks; ++c) {
            hw::tma_load_4d(ks + T::kKVBytes + c * T::kChunkKV, &tm_v,
                            v_full + st, 64 * c, hk, k0, b);
          }
        }
      }
    }
  } else {
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    float o[T::kOCols / 2], s[T::kBK / 2], m[2], l[2], alpha[2];
    uint32_t p[T::kBK / 16][4];
#pragma unroll
    for (int i = 0; i < T::kBK / 2; ++i) s[i] = 0.f;
    // The two warpgroups take turns to issue their products (ping-pong):
    // before each product warpgroup w waits on named barrier kTurn + w,
    // which the other warpgroup arrives on once it has issued its own
    // product, so one warpgroup's softmax runs while the other's wgmma does.
    // Warpgroup 1 opens with one arrival so that warpgroup 0 goes first, and
    // skips its block's last one, so every barrier phase gets 128 + 128
    // threads.
    constexpr int kTurn = 3;  // ids 3 and 4; 1, 2 and 5 are the epilogue's
    if (wg == 1) hw::named_arrive(kTurn, 256);
    int tile = 0;
    int j = 0;
    for (hw::ForwardWorks w(n_q, Hq, B, order, blockIdx.x, gridDim.x);
         !w.done(); ++j) {
      const int q0 = w.tile() * T::kBQ, h = w.head(), b = w.batch();
      const int n_tiles = n_tiles_of(q0);
      w.next();
      const bool last_work = w.done();
      // The warpgroup's first q row, and its q in the buffer: its own 64
      // rows, or (kSplit) the block's 64, shared.
      const int row_q = q0 + (T::kSplit ? 0 : 64 * wg);
      const int r0 = row_q + 16 * warp + g;  // this thread's rows: r0, r0 + 8
      uint8_t* qw = qs + (j % 2) * T::kQBytes +
                    (T::kSplit ? 0 : wg * T::kChunks * T::kChunkQ);
      const uint32_t q_addr = hw::smem_addr(qw);
#pragma unroll
      for (int i = 0; i < T::kOCols / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = kMask;
      l[0] = l[1] = 0.f;

      hw::mbar_wait(q_full + j % 2, (j / 2) & 1);
      for (int i = 0; i < n_tiles; ++i, ++tile) {
        const int st = tile % T::kStages;
        const uint32_t phase = (tile / T::kStages) & 1;
        const int k0 = (n_tiles - 1 - i) * T::kBK;
        const uint32_t k_addr = hw::smem_addr(kvs + st * 2 * T::kKVBytes);
        hw::mbar_wait(k_full + st, phase);
        hw::fence_regs(s);
        hw::named_barrier(kTurn + wg, 256);
        hw::wgmma_fence();
        issue_qk<D>(s, q_addr, k_addr);
        hw::wgmma_commit();
        hw::named_arrive(kTurn + 1 - wg, 256);
        if (i == 0 && j > 0 && tid == 0) {
          // The previous work's out store has read its half of that q
          // buffer (waited for here, under this product, not at the end
          // of the previous work): the buffer is free.
          hw::tma_store_wait_read();
          hw::mbar_arrive(q_empty + (j - 1) % 2);
        }
        hw::wgmma_wait<0>();
        hw::fence_regs(s);
        // _needs_mask for this warpgroup's rows (rows >= S are never
        // stored); kv tiles run from the last, so only the first can need
        // it.
        if (k0 + T::kBK > S || (causal && k0 + T::kBK - 1 > row_q)) {
          softmax<true>(s, m, l, alpha, k0, r0, t, S, scale_log2, causal);
        } else {
          softmax<false>(s, m, l, alpha, k0, r0, t, S, scale_log2, causal);
        }
        rescale(o, alpha);
        pack_p(p, s);
        hw::mbar_wait(v_full + st, phase);
        hw::named_barrier(kTurn + wg, 256);
        hw::wgmma_fence();
        issue_pv<D>(o, p,
                    k_addr + T::kKVBytes +
                        (T::kSplit ? wg * (T::kOCols / 64) * T::kChunkKV : 0));
        hw::wgmma_commit();
        if (wg == 0 || !last_work || i + 1 < n_tiles) {
          hw::named_arrive(kTurn + 1 - wg, 256);
        }
        hw::wgmma_wait<0>();
        hw::fence_regs(o);
        if (lane == 0) hw::mbar_arrive(kv_empty + st);
      }

      // Epilogue: out = o / l into this warpgroup's part of the q buffer
      // (no longer read: its own half, or under kSplit the chunks of its
      // columns, once both warpgroups' products have read all of q), laid
      // out as TMA's 128-byte swizzle expects, then one TMA store per
      // chunk, which frees the buffer once it has been read (see above);
      // lse from the quad's summed l (under kSplit both warpgroups hold
      // the same m and l, and warpgroup 0 writes it).
      float l_safe[2], l_inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_safe[r] = sum == 0.f ? 1.f : sum;
        l_inv[r] = __frcp_rn(l_safe[r]);
      }
      const int c0 = T::kSplit ? wg * (T::kOCols / 64) : 0;  // first chunk
      uint8_t* ow = qw + c0 * T::kChunkQ;
      // out packed to bf16 pairs, ok[2n + r] = rows g + 8r, columns 8n +
      // 2t (the accumulator's layout), stored as 8 x 8 matrices: lane l
      // gives row l % 8 of matrix l / 8 of each stmatrix.x4, which writes
      // columns 16jp .. 16jp + 15 of the warp's 16 rows.
      uint32_t ok[T::kOCols / 4];
#pragma unroll
      for (int n = 0; n < T::kOCols / 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          ok[2 * n + r] =
              pack_f32(div_rn(o[4 * n + 2 * r], l_safe[r], l_inv[r]),
                       div_rn(o[4 * n + 2 * r + 1], l_safe[r], l_inv[r]));
        }
      }
      if (T::kSplit) hw::named_barrier(5, 256);
      const int m_row = 16 * warp + lane % 8 + 8 * (lane / 8 % 2);
#pragma unroll
      for (int jp = 0; jp < T::kOCols / 16; ++jp) {
        const int group = 2 * (jp % 4) + lane / 16;  // 16-byte group in a chunk
        const uint32_t dst = hw::smem_addr(ow + (jp / 4) * T::kChunkQ) +
                             m_row * 128 + (group ^ (lane % 8)) * 16;
        hw::stmatrix_x4(dst, ok[4 * jp], ok[4 * jp + 1], ok[4 * jp + 2],
                        ok[4 * jp + 3]);
      }
      hw::fence_async_shared();
      hw::named_barrier(1 + wg, 128);
      if (tid == 0) {
        if (row_q < S) {
          for (int c = 0; c < T::kOCols / 64; ++c) {
            hw::tma_store_4d(&tm_o, ow + c * T::kChunkQ, 64 * (c0 + c), h,
                             row_q, b);
          }
        }
        hw::tma_store_commit();
      }
      if (t == 0 && (!T::kSplit || wg == 0)) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row < S) {
            lse[(static_cast<size_t>(b) * Hq + h) * S + row] =
                m[r] / kLog2e + logf(l_safe[r]);
          }
        }
      }
    }
    if (tid == 0) hw::tma_store_wait_read();  // before the block exits
  }
}

// The D = 512 kernel (see the header): both warpgroups compute s = q.k^T
// for the block's 64 q rows (m64n32k16) and its softmax, and each adds p.v
// for its 256 of o's columns (m64n256k16, p from registers).  Thread 0
// issues every TMA load: q and the first kSlots k and v tiles at the start,
// then, once its warpgroup's product m has completed, load m - 1 + kSlots
// into the slot of the tensor that product m - 1 read (both warpgroups'
// products m - 1 have then nearly always completed, so the wait on the
// slot's empty barrier is short).  The warpgroups take turns to issue
// their products (ping-pong), as below D = 512.
template <>
__global__ void __launch_bounds__(Bf16Tiles<512>::kThreads, 1)
flash_fwd_bf16_wgmma<512>(__grid_constant__ const CUtensorMap tm_q,
                          __grid_constant__ const CUtensorMap tm_k,
                          __grid_constant__ const CUtensorMap tm_v,
                          __grid_constant__ const CUtensorMap tm_o,
                          float* __restrict__ lse, int B, int S, int Hq,
                          int Hkv, float scale_log2, int causal,
                          int /*order: one block per q tile here*/) {
  using T = Bf16Tiles<512>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm;
  uint8_t* slots = sm + T::kQBytes;  // slot j at j * kKVBytes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + T::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + T::kSlots;

  // Block -> (q tile, head, batch): under the causal mask the heaviest q
  // tiles first, each tile's heads and batch rows side by side.
  const int n_q = (S + T::kBQ - 1) / T::kBQ;
  const int n_hb = Hq * B;
  const int qt = causal ? n_q - 1 - static_cast<int>(blockIdx.x) / n_hb
                        : static_cast<int>(blockIdx.x) / n_hb;
  const int h = blockIdx.x % n_hb % Hq, b = blockIdx.x % n_hb / Hq;
  const int hk = h / (Hq / Hkv), q0 = qt * T::kBQ;
  const int n_tiles = causal ? (min(q0 + T::kBQ, S) - 1) / T::kBK + 1
                             : (S + T::kBK - 1) / T::kBK;
  const int n_loads = 2 * n_tiles;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
    for (int j = 0; j < T::kSlots; ++j) {
      hw::mbar_init(full + j, 1);
      hw::mbar_init(empty + j, 8);  // one arrival per warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  // Load n: k (n even) or v of the block's tile n / 2, which is kv tile
  // n_tiles - 1 - n / 2 (tiles run from the last), into slot n % kSlots
  // once the slot's previous tensor, load n - kSlots, has been read by
  // every warp.  TMA zero-fills rows >= S.
  auto issue_load = [&](int n) {
    const int j = n % T::kSlots;
    const int k0 = (n_tiles - 1 - n / 2) * T::kBK;
    uint8_t* dst = slots + j * T::kKVBytes;
    const CUtensorMap* map = n % 2 ? &tm_v : &tm_k;
    hw::mbar_wait(empty + j, ((n / T::kSlots) & 1) ^ 1);
    hw::mbar_expect_tx(full + j, T::kKVBytes);
    for (int c = 0; c < T::kChunks; ++c) {
      hw::tma_load_4d(dst + c * T::kChunkKV, map, full + j, 64 * c, hk, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    hw::prefetch_map(&tm_k);
    hw::prefetch_map(&tm_v);
    hw::mbar_expect_tx(q_full, T::kQBytes);
    for (int c = 0; c < T::kChunks; ++c) {
      hw::tma_load_4d(qs + c * T::kChunkQ, &tm_q, q_full, 64 * c, h, q0, b);
    }
    for (int n = 0; n < min(T::kSlots, n_loads); ++n) issue_load(n);
  }

  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8
  const uint32_t q_addr = hw::smem_addr(qs);
  float o[T::kOCols / 2], s[T::kBK / 2], m[2], l[2], alpha[2];
  uint32_t p[T::kBK / 16][4];
#pragma unroll
  for (int i = 0; i < T::kOCols / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::kBK / 2; ++i) s[i] = 0.f;
  m[0] = m[1] = kMask;
  l[0] = l[1] = 0.f;

  // Ping-pong on named barriers kTurn + w, as in the template above.
  constexpr int kTurn = 3;  // ids 3 and 4; 1, 2 and 5 are the epilogue's
  if (wg == 1) hw::named_arrive(kTurn, 256);
  hw::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (n_tiles - 1 - i) * T::kBK;
    const int nk = 2 * i, nv = 2 * i + 1;  // the loads of k and v
    hw::mbar_wait(full + nk % T::kSlots, (nk / T::kSlots) & 1);
    hw::fence_regs(s);
    hw::named_barrier(kTurn + wg, 256);
    hw::wgmma_fence();
    issue_qk<512>(s, q_addr,
                  hw::smem_addr(slots + (nk % T::kSlots) * T::kKVBytes));
    hw::wgmma_commit();
    hw::named_arrive(kTurn + 1 - wg, 256);
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    if (lane == 0) hw::mbar_arrive(empty + nk % T::kSlots);
    if (threadIdx.x == 0 && i > 0 && nk - 1 + T::kSlots < n_loads) {
      issue_load(nk - 1 + T::kSlots);
    }
    if (k0 + T::kBK > S || (causal && k0 + T::kBK - 1 > q0)) {
      softmax<true>(s, m, l, alpha, k0, r0, t, S, scale_log2, causal);
    } else {
      softmax<false>(s, m, l, alpha, k0, r0, t, S, scale_log2, causal);
    }
    // Where every row of the warp kept its max, alpha is exactly 1 and the
    // rescale would change no bit of o: skip it.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
      rescale(o, alpha);
    }
    pack_p(p, s);
    hw::mbar_wait(full + nv % T::kSlots, (nv / T::kSlots) & 1);
    hw::named_barrier(kTurn + wg, 256);
    hw::wgmma_fence();
    issue_pv<512>(o, p,
                  hw::smem_addr(slots + (nv % T::kSlots) * T::kKVBytes) +
                      wg * (T::kOCols / 64) * T::kChunkKV);
    hw::wgmma_commit();
    if (wg == 0 || i + 1 < n_tiles) hw::named_arrive(kTurn + 1 - wg, 256);
    hw::wgmma_wait<0>();
    hw::fence_regs(o);
    if (lane == 0) hw::mbar_arrive(empty + nv % T::kSlots);
    if (threadIdx.x == 0 && nv - 1 + T::kSlots < n_loads) {
      issue_load(nv - 1 + T::kSlots);
    }
  }

  // Epilogue: out = o / l into the q buffer's chunks of this warpgroup's
  // columns once both warpgroups' products have read all of q (named
  // barrier 5), one TMA store per chunk (rows >= S dropped), lse by
  // warpgroup 0 (both hold the same m and l).
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_safe[r] = sum == 0.f ? 1.f : sum;
  }
  const int c0 = wg * (T::kOCols / 64);  // the warpgroup's first chunk
  uint8_t* ow = qs + c0 * T::kChunkQ;
  hw::named_barrier(5, 256);
#pragma unroll
  for (int n = 0; n < T::kOCols / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;  // row % 8 == g
      uint8_t* dst =
          ow + (n / 8) * T::kChunkQ + row * 128 + ((n % 8) ^ g) * 16 + t * 4;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
          o[4 * n + 2 * r] / l_safe[r], o[4 * n + 2 * r + 1] / l_safe[r]);
    }
  }
  hw::fence_async_shared();
  hw::named_barrier(1 + wg, 128);
  if (tid == 0) {
    for (int c = 0; c < T::kOCols / 64; ++c) {
      hw::tma_store_4d(&tm_o, ow + c * T::kChunkQ, 64 * (c0 + c), h, q0, b);
    }
    hw::tma_store_commit();
    hw::tma_store_wait_read();  // before the block exits
  }
  if (t == 0 && wg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < S) {
        lse[(static_cast<size_t>(b) * Hq + h) * S + row] =
            m[r] / kLog2e + logf(l_safe[r]);
      }
    }
  }
}

// The forward's work order and grid (hopper.cuh's ForwardWorks) for n q
// tiles of n_hb (batch, head) pairs on n_sm SMs: pairs where no block is
// then busier than with single q tiles (a pair's second tile reads the kv
// tiles its block has just read: on one card, single tiles were 2.5-7 %
// slower at equal balance, PERF.md), else single q tiles,
// tile-major where that balances the blocks better than head-major.  The
// last few answers are kept, since a model calls the forward at a few
// shapes.
int forward_order(int n, int n_hb, int n_sm, bool causal, int* grid) {
  using W = hw::ForwardWorks;
  struct Entry {
    int n, n_hb, n_sm, causal, order, grid;
  };
  constexpr int kEntries = 16;
  static thread_local Entry seen[kEntries];
  static thread_local int next = 0;
  for (const Entry& e : seen) {
    if (e.n == n && e.n_hb == n_hb && e.n_sm == n_sm && e.causal == causal) {
      *grid = e.grid;
      return e.order;
    }
  }
  const long long units = static_cast<long long>(n_hb) * ((n + 1) / 2);
  const long long works = static_cast<long long>(n_hb) * n;
  const int grid_pairs = static_cast<int>(units < n_sm ? units : n_sm);
  const int grid_single = static_cast<int>(works < n_sm ? works : n_sm);
  const long long pairs =
      hw::busiest_block(n, n_hb, 1, W::kPaired, grid_pairs, causal);
  const long long head =
      hw::busiest_block(n, n_hb, 1, W::kHeadMajor, grid_single, causal);
  const long long tile =
      causal ? hw::busiest_block(n, n_hb, 1, W::kTileMajor, grid_single, true)
             : head;
  const int order = pairs <= (tile < head ? tile : head) ? W::kPaired
                    : tile < head                         ? W::kTileMajor
                                                          : W::kHeadMajor;
  *grid = order == W::kPaired ? grid_pairs : grid_single;
  seen[next] = {n, n_hb, n_sm, causal, order, *grid};
  next = (next + 1) % kEntries;
  return order;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int S, int Hq, int Hkv, float scale_log2,
                int causal, cudaStream_t stream) {
  using T = Bf16Tiles<D>;
  static bool opted[hw::kMaxDevices];
  int n_sm = 0;
  int err = hw::smem_opt_in(flash_fwd_bf16_wgmma<D>, T::kSmem, opted);
  if (!err) err = hw::sm_count(&n_sm);
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, 64);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_o, o, B, S, Hq, D, 64);
  if (err) return err;
  // One persistent block per SM, or one per unit of work (forward_order).
  const int n_q = (S + T::kBQ - 1) / T::kBQ;
  if (static_cast<long long>(B) * Hq * n_q > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  int grid = 0;
  const int order = forward_order(n_q, B * Hq, n_sm, causal != 0, &grid);
  flash_fwd_bf16_wgmma<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), B, S, Hq, Hkv,
      scale_log2, causal, order);
  return static_cast<int>(cudaGetLastError());
}

// The D = 512 kernel: one block per (q tile, head, batch), not
// persistent (one q buffer: a block's next q could not stream in during
// its epilogue).
int launch_bf16_512(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int S, int Hq, int Hkv, float scale_log2,
                    int causal, cudaStream_t stream) {
  using T = Bf16Tiles<512>;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(flash_fwd_bf16_wgmma<512>, T::kSmem, opted);
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, 512, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, 512, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, 512, T::kBK);
  if (!err) err = hw::bshd_map(&tm_o, o, B, S, Hq, 512, T::kBQ);
  if (err) return err;
  const long long n_blocks =
      static_cast<long long>((S + T::kBQ - 1) / T::kBQ) * Hq * B;
  if (n_blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_fwd_bf16_wgmma<512>
      <<<static_cast<int>(n_blocks), T::kThreads, T::kSmem, stream>>>(
          tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), B, S, Hq, Hkv,
          scale_log2, causal, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the forward on `stream`; returns cudaGetLastError() (0 on
// success).  dtype: 0 = float32, 1 = bfloat16.  The caller checks shapes,
// contiguity and alignment; this checks only what selects a kernel.
extern "C" int tdx_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int Hq, int Hkv,
                             int D, int dtype, int causal, float scale_log2,
                             void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) {
    return launch_bf16<64>(q, k, v, o, lse, B, S, Hq, Hkv, scale_log2, causal,
                           st);
  } else if (dtype == 1 && D == 128) {
    return launch_bf16<128>(q, k, v, o, lse, B, S, Hq, Hkv, scale_log2, causal,
                            st);
  } else if (dtype == 1 && D == 256) {
    return launch_bf16<256>(q, k, v, o, lse, B, S, Hq, Hkv, scale_log2, causal,
                            st);
  } else if (dtype == 1 && D == 512) {
    return launch_bf16_512(q, k, v, o, lse, B, S, Hq, Hkv, scale_log2, causal,
                           st);
  } else if (dtype == 0) {  // f32 at D 64, 128, 256 and 512 (flash_q_f32.cuh)
    tdx_qf32::QF32Args args{};
    args.q = static_cast<const float*>(q);
    args.k = static_cast<const float*>(k);
    args.v = static_cast<const float*>(v);
    args.out = static_cast<float*>(o);
    args.lse = static_cast<float*>(lse);
    args.S = S;
    args.Hq = Hq;
    args.Hkv = Hkv;
    args.causal = causal;
    args.scale_log2 = scale_log2;
    return tdx_qf32::launch_q_f32<false>(args, B, D, st);
  }
  return cudaErrorInvalidValue;
}
