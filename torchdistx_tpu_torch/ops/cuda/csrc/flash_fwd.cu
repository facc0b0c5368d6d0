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
// per SM walks its works (PairedWorks), a work being 128 q rows of one
// (batch, head), the two q tiles n_q - 1 - p and p of a head taken together
// so that every block gets the same number of causal kv tiles; works go out
// head-major, so blocks running side by side share their heads' k and v in
// L2.  A block has two consumer warpgroups (64 q rows each) and one
// producer warp.  One producer thread loads each work's q into one of two q
// buffers (the next work's q streams in during this one) and k and v tiles
// of 128 rows by TMA into a ring of kStages stages, numbered across works
// (2 at D = 128: 2 x q 32 KB + 2 x (k 32 KB + v 32 KB) = 192 KB of dynamic
// shared memory; 4 at D = 64), each stage with its own k-full, v-full and
// empty mbarrier, so the next tile, of this work or the next, streams in
// while one is multiplied.  TMA zero-fills rows >= S, so loads need no
// guard.  Per kv tile a consumer computes s = q.k^T with wgmma m64n128k16
// (both operands K-major in shared memory), takes the online softmax in
// registers, and adds p.v with wgmma m64nDk16, p from registers (the s
// accumulator packed pairwise to bf16 is the A fragment, see hopper.cuh)
// and v from shared memory as an MN-major operand, so v needs no transpose
// copy.  The two consumers take turns to issue their products (ping-pong
// on two named barriers), so one's softmax runs while the other's wgmma
// does; a warp releases the stage after wgmma_wait for both products.  kv
// tiles run from the last to the first, so the one tile that needs the
// mask (the causal diagonal, or the ragged tile holding columns >= S when
// not causal: the Pallas kernel's _needs_mask, with kv tiles aligned to the
// q tile) comes first, and every other tile skips the iota/compare/select
// and folds the scale into its exponent's FFMA.  A work's epilogue writes
// out through the warpgroup's half of its q buffer and a TMA store, which
// drops rows >= S, and lse directly.
//
// f32: CUDA cores, 4 warps, 16 q rows per block, kv tiles of 32, one warp
// lane per kv column for q.k and per output column for P.V.
//
// What bounds it on an H100 SXM: at the Llama-7B training shape B 4, S 512,
// 32 heads, D 128, bf16, causal, q, k, v and out are 16.8 MB each, 67 MB in
// all: 20 us at 3.35 TB/s, against 4 B H D S(S+1)/2 = 8.6 GFLOP, 8.7 us at
// the 989 TFLOP/s dense bf16 tensor rate, so bytes bound it; at B 1, S 4096
// the 137 GFLOP take 139 us at that rate against 34 MB in 10 us, so
// operations do (from S of about 1200 up, or with GQA).  What this design
// leaves on the table: each consumer waits for one product before its next
// step.  Overlapping a tile's softmax with its own next q.k^T needs s, p and
// o (160 registers) live at once, and ptxas holds a thread of this kernel
// to 168 registers: it spilled at 384 threads with setmaxnreg granting 232
// and at 288 threads, and __maxnreg__(224) compiled without spills but the
// launch was refused for want of registers.  A block's first q and k loads
// and its last epilogue are still exposed, which weighs most at S = 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace hw = tdx::hopper;

constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // the f32 kernel's block

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 kernel's tiles and dynamic shared memory: two q buffers (each
// two warpgroups x D / 64 chunks of 64 rows), then per stage k and v (D / 64
// chunks of kBK rows each), then the barriers; + 1024 bytes to align the
// base to a swizzle atom.
template <int D>
struct Bf16Tiles {
  static constexpr int kBQ = 128, kBK = 128;
  static constexpr int kStages = D == 128 ? 2 : 4;
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

// A consumer warpgroup's steps on one kv tile.  s: the 64 x 128 logits;
// p: s packed pairwise to bf16, the A fragments of p.v (accumulator columns
// 16kk .. 16kk + 15 are the kk-th step's fragment, see hopper.cuh); o: the
// 64 x D accumulator; m: the row max in the log2 domain; l: this thread's
// share of the row sum (the four threads of a row are summed at the end).

// Issues s = q.k^T (not committed).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
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

// Issues o += p.v (not committed).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[8][4],
                                         uint32_t v_addr) {
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

// The online softmax update of one tile: m to the new row max of the
// logits in the log2 domain, s to p = exp2(s * scale_log2 - m), l rescaled
// and summed; returns in alpha the factor exp2(m_old - m_new) that o still
// has to be scaled by.  On a masked tile, pairs past S or above the causal
// diagonal take the logit kMask; elsewhere the scale is folded into the
// exponent (the max of s scaled is the scaled max, the scale being > 0).
template <bool kMasked>
__device__ __forceinline__ void softmax(float (&s)[64], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int k0, int r0, int t, int S,
                                        float scale_log2, int causal) {
  if (kMasked) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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
    for (int j = 1; j < 16; ++j) {
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale);
    alpha[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
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
                     float scale_log2, int causal) {
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
      for (hw::PairedWorks w(n_q, Hq, B); !w.done(); w.next(), ++j) {
        const int q0 = w.tile() * T::kBQ, h = w.head(), b = w.batch();
        const int hk = h / (Hq / Hkv), n_tiles = n_tiles_of(q0);
        uint8_t* qj = qs + (j % 2) * T::kQBytes;
        hw::mbar_wait(q_empty + j % 2, ((j / 2) & 1) ^ 1);
        hw::mbar_expect_tx(q_full + j % 2, T::kQBytes);
        for (int half = 0; half < 2; ++half) {
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
    float o[D / 2], s[64], m[2], l[2], alpha[2];
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    // The two warpgroups take turns to issue their products (ping-pong):
    // before each product warpgroup w waits on named barrier kTurn + w,
    // which the other warpgroup arrives on once it has issued its own
    // product, so one warpgroup's softmax runs while the other's wgmma does.
    // Warpgroup 1 opens with one arrival so that warpgroup 0 goes first, and
    // skips its block's last one, so every barrier phase gets 128 + 128
    // threads.
    constexpr int kTurn = 3;  // ids 3 and 4; 1 and 2 are the epilogue's
    if (wg == 1) hw::named_arrive(kTurn, 256);
    int tile = 0;
    int j = 0;
    for (hw::PairedWorks w(n_q, Hq, B); !w.done(); ++j) {
      const int q0 = w.tile() * T::kBQ, h = w.head(), b = w.batch();
      const int n_tiles = n_tiles_of(q0);
      w.next();
      const bool last_work = w.done();
      const int row_q = q0 + 64 * wg;        // the warpgroup's first row
      const int r0 = row_q + 16 * warp + g;  // this thread's rows: r0, r0 + 8
      uint8_t* qw =
          qs + (j % 2) * T::kQBytes + wg * T::kChunks * T::kChunkQ;
      const uint32_t q_addr = hw::smem_addr(qw);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
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
        issue_pv<D>(o, p, k_addr + T::kKVBytes);
        hw::wgmma_commit();
        if (wg == 0 || !last_work || i + 1 < n_tiles) {
          hw::named_arrive(kTurn + 1 - wg, 256);
        }
        hw::wgmma_wait<0>();
        hw::fence_regs(o);
        if (lane == 0) hw::mbar_arrive(kv_empty + st);
      }

      // Epilogue: out = o / l into this warpgroup's half of the q buffer (no
      // longer read), laid out as TMA's 128-byte swizzle expects, then one
      // TMA store per chunk, which frees the buffer once it has been read
      // (see above); lse from the quad's summed l.
      float l_safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_safe[r] = sum == 0.f ? 1.f : sum;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r;  // row % 8 == g
          uint8_t* dst = qw + (n / 8) * T::kChunkQ + row * 128 +
                         ((n % 8) ^ g) * 16 + t * 4;
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(o[4 * n + 2 * r] / l_safe[r],
                                    o[4 * n + 2 * r + 1] / l_safe[r]);
        }
      }
      hw::fence_async_shared();
      hw::named_barrier(1 + wg, 128);
      if (tid == 0) {
        if (row_q < S) {
          for (int c = 0; c < T::kChunks; ++c) {
            hw::tma_store_4d(&tm_o, qw + c * T::kChunkQ, 64 * c, h, row_q,
                             b);
          }
        }
        hw::tma_store_commit();
      }
      if (t == 0) {
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S, int Hq, int Hkv,
              float scale_log2, int causal) {
  constexpr int BQ = 16, BK = 32, RPW = BQ / (kThreads / 32), DPL = D / 32;
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];  // +1: lanes reading rows hit distinct banks
  __shared__ float vs[BK][D + 1];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_rs = static_cast<size_t>(Hq) * D;
  const size_t kv_rs = static_cast<size_t>(Hkv) * D;
  const float* qb = q + static_cast<size_t>(b) * S * q_rs + h * D;
  const float* kb = k + static_cast<size_t>(b) * S * kv_rs + hk * D;
  const float* vb = v + static_cast<size_t>(b) * S * kv_rs + hk * D;

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q_tile * BQ + r;
    qs[r][c] = row < S ? qb[row * q_rs + c] : 0.f;
  }

  float acc[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kMask;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int last_row = min(q_tile * BQ + BQ, S) - 1;
  const int n_tiles = causal ? last_row / BK + 1 : (S + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < S;
      const size_t off = static_cast<size_t>(k0 + r) * kv_rs + c;
      ks[r][c] = in ? kb[off] : 0.f;
      vs[r][c] = in ? vb[off] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int lr = warp * RPW + rr, row = q_tile * BQ + lr;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qs[lr][d], ks[lane][d], dot);
      const int col = k0 + lane;
      const bool keep = col < S && (!causal || col <= row);
      const float x = keep ? dot * scale_log2 : kMask;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_next = fmaxf(m[rr], mx);
      const float alpha = exp2f(m[rr] - m_next);
      const float p = exp2f(x - m_next);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[rr] = l[rr] * alpha + sum;
      m[rr] = m_next;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        const float pc = __shfl_sync(0xffffffffu, p, c);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          acc[rr][i] = fmaf(pc, vs[c][lane + 32 * i], acc[rr][i]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = q_tile * BQ + warp * RPW + rr;
    if (row >= S) continue;
    const float l_safe = l[rr] == 0.f ? 1.f : l[rr];
    float* orow = o + (static_cast<size_t>(b) * S + row) * q_rs + h * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[lane + 32 * i] = acc[rr][i] / l_safe;
    if (lane == 0) {
      lse[(static_cast<size_t>(b) * Hq + h) * S + row] =
          m[rr] / kLog2e + logf(l_safe);
    }
  }
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
  // One persistent block per SM, or one per unit of work (PairedWorks).
  const int n_q = (S + T::kBQ - 1) / T::kBQ;
  const long long n_units = static_cast<long long>(B) * Hq * ((n_q + 1) / 2);
  if (n_units > INT_MAX) return cudaErrorInvalidValue;
  const int grid =
      static_cast<int>(n_units < n_sm ? n_units : n_sm);
  flash_fwd_bf16_wgmma<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), B, S, Hq, Hkv,
      scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void launch(void (*kernel)(const T*, const T*, const T*, T*, float*, int, int,
                           int, float, int),
            int bq, const void* q, const void* k, const void* v, void* o,
            void* lse, int B, int S, int Hq, int Hkv, float scale_log2,
            int causal, cudaStream_t stream) {
  const dim3 grid((S + bq - 1) / bq, Hq, B);
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, Hq, Hkv, scale_log2, causal);
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
  } else if (dtype == 0 && D == 64) {
    launch(flash_fwd_f32<64>, 16, q, k, v, o, lse, B, S, Hq, Hkv, scale_log2,
           causal, st);
  } else if (dtype == 0 && D == 128) {
    launch(flash_fwd_f32<128>, 16, q, k, v, o, lse, B, S, Hq, Hkv, scale_log2,
           causal, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
