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
// becomes a loop inside one block per (q tile, q head, batch) over kv tiles
// up to the causal diagonal; the heaviest causal q tiles launch first.  Each
// block owns its dq rows, so nothing is summed across blocks: no atomics,
// and the result is the same bits on every run.
//
// bf16 (flash_bwd_dq_wgmma), built from hopper.cuh: the forward's shape.  A
// block takes 128 q rows, two consumer warpgroups of 64 rows and one
// producer warp.  The producer loads q and do once by TMA, then k and v
// tiles of 64 rows into a ring of kStages stages (4 at D = 128: 4 x 32 KB,
// with q and do 192 KB of dynamic shared memory), each with a full and an
// empty mbarrier, from the diagonal down, so that the tiles that need the
// mask (needs_mask, for each warpgroup's rows: with 64-row kv tiles the
// diagonal crosses two of them) come first.  Each consumer reads its rows'
// lse (times log2 e) and delta (times scale) once with plain loads (a (B,
// Hq, S) f32 row is 16-byte aligned only when S % 4 == 0, which TMA would
// need), guarded for rows >= S.  Per kv tile it computes s = q.k^T and dp =
// do.v^T with wgmma m64n64k16 (both operands K-major in shared memory), p
// and ds in registers (p_ds_fast: one FFMA, the special-function unit's
// exp2 and an FFMA and FMUL a pair; tiles that need no mask take a copy of
// the loop without the per-pair test), then dq += ds.k with wgmma
// m64nDk16, ds from registers (the dp accumulator packed pairwise to bf16
// is the A fragment, see hopper.cuh) and the k tile read again as an
// MN-major B operand, so k needs no transpose copy.  The two consumers take
// turns to issue their products (ping-pong on two named barriers, as in
// flash_fwd.cu), so one's p and ds run while the other's wgmma does.  TMA
// zero-fills rows >= S; p is still masked there.  The epilogue writes dq as
// bf16 through the warpgroup's half of the q buffer and a TMA store, which
// drops rows >= S.
//
// bf16 at D = 256 (flash_bwd_dq_wgmma_wide): a 64 x 256 f32 dq is 128
// registers a thread, which beside s and dp (64) does not fit the 168 of a
// 288-thread block.  A block of 256 threads (two warpgroups, no producer
// warp) gets 255: each warpgroup holds its 64 rows' dq whole, as two 64 x
// 128 halves (m64n128k16 on k's chunks 0-1 and 2-3), beside s and dp; 229
// registers, no spills, and no product computed twice.  q and do of the
// block's 128 rows take 128 KB, so two whole stages of k and v (128 KB)
// do not fit; three 32 KB slots that take v and k in turns do (230,456 of
// 232,448 bytes): v of a tile frees once both warpgroups have s and dp, k
// once both have added ds.k, and the next tile's k and the tile after
// next's v go there.  With no producer warp, warpgroup 1, whose products
// run second in the ping-pong, issues those loads once every warp has
// arrived on the slot's empty barrier.  The rest is the design above:
// tiles from the diagonal down, ds from registers as the A fragment, k read
// in place as the MN-major B, dq the same bits on every run.  Device ms on
// an NVIDIA H100 80GB HBM3 at 700 W: 0.063-0.065 at B 2, S 1024, 16 heads
// (3.8 on the CUDA cores it replaces; bound 0.026), 0.080-0.082 at B 1, S
// 2112, 4/2 heads (2.55; bound 0.014), where 68 blocks fill half the SMs
// and the heaviest walks 33 kv tiles (PERF.md).
//
// bf16 at D = 512 (flash_bwd_dq_wgmma_wide<512>): a 64 x 512 f32 dq is
// 256 registers a thread of a warpgroup, so one block cannot hold a 64-row
// q tile's dq.  Two blocks of a cluster (neighbouring SMs, launched by
// cudaLaunchKernelEx with a cluster dimension of 2 along the grid's x,
// which pairs them per q head) share a q tile of 64 rows, block r owning
// D's columns 256 r .. 256 r + 255 of q, do, k, v and dq.  Its two
// warpgroups take the kv tiles of 32 rows in turns (the diagonal first),
// each holding its own 64 x 256 f32 dq (two m64n128 halves, 128
// registers).  Per tile a warpgroup forms partial s = q.k^T and dp =
// do.v^T over the block's columns (m64n32k16), exchanges them with the
// peer's same warpgroup through distributed shared memory and adds them
// (flash_bwd_common.cuh's exchange_partials, as the D = 512 dk/dv kernel
// does; f32 addition commutes, so both blocks get the same bits of p and
// ds), runs p and ds (p_ds_fast) in registers, and adds dq_h += ds.k_h
// with ds from registers as the A fragment and k read in place as the
// MN-major B.  Shared memory: q and do halves 64 KB, three stages of k and
// v halves 96 KB, a receive and a staging buffer of partials per
// warpgroup 64 KB: 230,488 of 232,448 bytes.  With no producer warp, the
// first thread of the warpgroup that read a stage loads the tile three on
// into it; each tile completes one of six full barriers (one per stage and
// warpgroup), so a warpgroup waits for every phase of its barriers in
// turn.  At the end warpgroup 1 hands its dq to warpgroup 0 through the
// stages, which adds it and stores the block's columns in bf16 by TMA
// (rows >= S dropped): the same bits on every run, no atomics.  It
// replaces a CUDA-core body that (1) ran every product as scalar FMAs
// from shared memory, bf16 widened to f32; (2) took 16 q rows a block
// with 192 KB of tiles, one 4-warp block an SM; (3) loaded each kv tile
// between two barriers, nothing in flight under the products.  Here (1)
// the products run on the tensor cores from bf16 tiles, (2) 64 q rows
// take two 256-thread blocks, and (3) TMA keeps two tiles in flight.
// What bounds it on an H100 SXM: at B 2, S 1024, 8 heads of 512, causal,
// 3 products, 25.8 GFLOP, 0.0261 ms at 989 TFLOP/s, against 84 MB of q,
// k, v, do, dq, lse and delta, 0.0251 ms at 3.35 TB/s: operations
// (chip_smoke.py's _bwd_bound).  Device ms on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py, PERF.md): 0.127 there, 21 % of the bound (the
// CUDA-core body 5.56), and 0.022 at B 2, S 300, 8/2 heads (0.61).  With
// the exchange knocked out (wrong values) it takes 42 % less
// (scripts/torch_d256_ab.py --d 512): the exchange, not the products, is
// what holds it back.
//
// f32 at D 64, 128, 256 and 512 (bwd_dq_f32): CUDA cores, 16 q rows a
// block, one warp lane per kv column for the two dots and per 32nd output
// column for dS.K.
//
// What bounds it on an H100 SXM: at Llama-7B's max_seq_len (B 1, S 4096, 32
// heads, D 128, bf16, causal) it does 3 products of 2 D flops per causal
// pair, 206 GFLOP, 208 us at the 989 TFLOP/s dense bf16 rate, against
// 168 MB of q, k, v, do, dq, lse and delta, 50 us at 3.35 TB/s: bound by
// operations.  What this design leaves on the table: each consumer waits
// for its products before its next step (s, dp and dq together hold 128 of
// the 168 registers that ptxas gives a thread of a 288-thread block, so a
// tile's p and ds cannot overlap its own next products); s and dp at N = 64
// read 4 KB of shared memory per 32 tensor-core cycles, all that shared
// memory gives; a block's first loads and its epilogue are exposed (it is
// not persistent); and s and dp are recomputed from the dk/dv kernel's (the
// price of two deterministic kernels).

#include "flash_bwd_common.cuh"

namespace tdx_bwd {
namespace {

// Tiles and dynamic shared memory of the bf16 kernel: q and do (each two
// warpgroups x D / 64 chunks of 64 rows, 8 KB a chunk), then per stage k
// and v (D / 64 chunks of 64 rows each), then the barriers; + 1024 bytes to
// align the base to a swizzle atom.
template <int D>
struct DqTiles {
  static constexpr int kBQ = 128, kBK = 64;
  static constexpr int kStages = D == 128 ? 4 : 6;
  static constexpr int kChunk = 64 * 128;        // one 64 x 64 chunk
  static constexpr int kTile = D / 64 * kChunk;  // one 64 x D tile
  static constexpr int kBarOffset = 4 * kTile + kStages * 2 * kTile;
  static constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
  static constexpr int kThreads = 288;  // 2 consumer warpgroups + 1 warp
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
};

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
flash_bwd_dq_wgmma(__grid_constant__ const CUtensorMap tm_q,
                   __grid_constant__ const CUtensorMap tm_do,
                   __grid_constant__ const CUtensorMap tm_k,
                   __grid_constant__ const CUtensorMap tm_v,
                   __grid_constant__ const CUtensorMap tm_dq,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, int S, int Hq, int Hkv,
                   int causal, float scale, float scale_log2) {
  using T = DqTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm;                 // warpgroup w's rows at w * kTile
  uint8_t* dos = sm + 2 * T::kTile;  // the same for do
  uint8_t* kvs = sm + 4 * T::kTile;  // stage st: k at 2 st kTile, then v
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + T::kBarOffset);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + T::kStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kBQ;
  const int hk = h / (Hq / Hkv);
  const int n_tiles = causal ? (min(q0 + T::kBQ, S) - 1) / T::kBK + 1
                             : (S + T::kBK - 1) / T::kBK;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
    for (int st = 0; st < T::kStages; ++st) {
      hw::mbar_init(kv_full + st, 1);
      hw::mbar_init(kv_empty + st, 8);  // one arrival per consumer warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  // Both roles walk the kv tiles from the last to the first: the i-th goes
  // to stage i % kStages, whose round's parity flips every kStages tiles;
  // the first round's empty waits pass.  Warps 0-7 are consumer warpgroups
  // 0 and 1, warp 8 the producer; the index goes through a shuffle so that
  // the compiler knows it is uniform across each warp.
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    if (threadIdx.x == 256) {
      hw::prefetch_map(&tm_k);
      hw::prefetch_map(&tm_v);
      hw::mbar_expect_tx(q_full, 4 * T::kTile);
      for (int half = 0; half < 2; ++half) {
        for (int c = 0; c < D / 64; ++c) {
          const int off = half * T::kTile + c * T::kChunk;
          hw::tma_load_4d(qs + off, &tm_q, q_full, 64 * c, h, q0 + 64 * half,
                          b);
          hw::tma_load_4d(dos + off, &tm_do, q_full, 64 * c, h,
                          q0 + 64 * half, b);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % T::kStages;
        const int k0 = (n_tiles - 1 - i) * T::kBK;
        uint8_t* ks = kvs + st * 2 * T::kTile;
        hw::mbar_wait(kv_empty + st, ((i / T::kStages) & 1) ^ 1);
        hw::mbar_expect_tx(kv_full + st, 2 * T::kTile);
        for (int c = 0; c < D / 64; ++c) {
          hw::tma_load_4d(ks + c * T::kChunk, &tm_k, kv_full + st, 64 * c, hk,
                          k0, b);
          hw::tma_load_4d(ks + T::kTile + c * T::kChunk, &tm_v, kv_full + st,
                          64 * c, hk, k0, b);
        }
      }
    }
  } else {
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_q = q0 + 64 * wg;        // the warpgroup's first row
    const int r0 = row_q + 16 * warp + g;  // this thread's rows: r0, r0 + 8
    const size_t row_base = (static_cast<size_t>(b) * Hq + h) * S;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      lse2[r] = row < S ? lse[row_base + row] * kLog2e : 0.f;
      dl[r] = row < S ? delta[row_base + row] * scale : 0.f;
    }
    uint8_t* qw = qs + wg * T::kTile;
    const uint32_t q_addr = hw::smem_addr(qw);
    const uint32_t do_addr = hw::smem_addr(dos + wg * T::kTile);
    float dq[D / 2], s[32], dp[32];
    uint32_t da[4][4];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) dq[n] = 0.f;
#pragma unroll
    for (int n = 0; n < 32; ++n) s[n] = dp[n] = 0.f;

    // Ping-pong, as in flash_fwd.cu: before each product warpgroup w waits
    // on named barrier kTurn + w, which the other warpgroup arrives on once
    // it has issued its own product.  Warpgroup 1 opens with one arrival so
    // that warpgroup 0 goes first, and skips its last one, so every barrier
    // phase gets 128 + 128 threads.
    constexpr int kTurn = 3;  // ids 3 and 4; 1 and 2 are the epilogue's
    if (wg == 1) hw::named_arrive(kTurn, 256);
    hw::mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % T::kStages;
      const int k0 = (n_tiles - 1 - i) * T::kBK;
      const uint32_t k_addr = hw::smem_addr(kvs + st * 2 * T::kTile);
      const uint32_t v_addr = k_addr + T::kTile;
      hw::mbar_wait(kv_full + st, (i / T::kStages) & 1);

      // s = q.k^T and dp = do.v^T (64 q rows x 64 kv columns).
      hw::fence_regs(s);
      hw::fence_regs(dp);
      hw::named_barrier(kTurn + wg, 256);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * T::kChunk + (kk % 4) * 32;
        hw::wgmma_ss(s, hw::sw128_desc(q_addr + off, 16, 1024),
                     hw::sw128_desc(k_addr + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * T::kChunk + (kk % 4) * 32;
        hw::wgmma_ss(dp, hw::sw128_desc(do_addr + off, 16, 1024),
                     hw::sw128_desc(v_addr + off, 16, 1024), kk > 0);
      }
      hw::wgmma_commit();
      hw::named_arrive(kTurn + 1 - wg, 256);
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
      hw::fence_regs(dp);

      // ds = p (dp scale - delta scale) into dp (dl holds delta scale), p =
      // 2^(s scale log2 e - lse log2 e), 0 on masked pairs; this thread's
      // rows r0 and r0 + 8.
      auto softmax = [&](const bool masked) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            p_ds_fast(s[4 * j + e], dp[4 * j + e], lse2[r], dl[r], masked,
                      causal, r0 + 8 * r, k0 + 8 * j + 2 * t + (e & 1), S,
                      scale, scale_log2);
          }
        }
      };
      if (needs_mask(causal, row_q, 64, k0, T::kBK, S)) {
        softmax(true);
      } else {
        softmax(false);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          da[kk][r] = pack_f32(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      }

      // dq += ds.k; the k dimension is the kv rows, k read as an MN-major
      // B operand.
      hw::named_barrier(kTurn + wg, 256);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hw::wgmma_rs(dq, da[kk],
                     hw::sw128_desc(k_addr + kk * 16 * 128, T::kChunk, 1024));
      }
      hw::wgmma_commit();
      if (wg == 0 || i + 1 < n_tiles) hw::named_arrive(kTurn + 1 - wg, 256);
      hw::wgmma_wait<0>();
      hw::fence_regs(dq);
      if (lane == 0) hw::mbar_arrive(kv_empty + st);
    }

    // Epilogue: dq in bf16 through this warpgroup's half of the q buffer
    // (no longer read), then one TMA store per chunk.
    hw::store_acc_sw128(qw, dq);
    hw::fence_async_shared();
    hw::named_barrier(1 + wg, 128);
    if (tid == 0) {
      if (row_q < S) {
        for (int c = 0; c < D / 64; ++c) {
          hw::tma_store_4d(&tm_dq, qw + c * T::kChunk, 64 * c, h, row_q, b);
        }
      }
      hw::tma_store_commit();
      hw::tma_store_wait_read();
    }
  }
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int S, int Hq, int Hkv, int causal,
                   float scale, float scale_log2, cudaStream_t stream) {
  using T = DqTiles<D>;
  const int n_q = (S + T::kBQ - 1) / T::kBQ;
  if (n_q > 65535 || B > 65535) return cudaErrorInvalidValue;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(flash_bwd_dq_wgmma<D>, T::kSmem, opted);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, 64);
  if (!err) err = hw::bshd_map(&tm_do, dout, B, S, Hq, D, 64);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dq, dq, B, S, Hq, D, 64);
  if (err) return err;
  flash_bwd_dq_wgmma<D><<<dim3(Hq, n_q, B), T::kThreads, T::kSmem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dq, lse, delta, S, Hq, Hkv, causal, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The D = 256 kernel's tiles and dynamic shared memory: q and do (each two
// warpgroups x 4 chunks of 64 rows, 8 KB a chunk: 128 KB), then kSlots
// slots of one 64 x 256 tile (32 KB) that take v and k in turns, then the
// barriers; + 1024 bytes to align the base to a swizzle atom.  Two whole
// stages of k and v (128 KB) do not fit beside q and do; three slots do.
template <int D>
struct DqWideTiles {
  static_assert(D == 256, "the wide design is for D = 256");
  static constexpr int kBQ = 128, kBK = 64, kSlots = 3;
  static constexpr int kTile = D / 64 * kChunk;  // one 64 x D tile
  static constexpr int kSlotOffset = 4 * kTile;
  static constexpr int kBarOffset = kSlotOffset + kSlots * kTile;
  static constexpr int kSmem = kBarOffset + (1 + 2 * kSlots) * 8 + 1024;
  static constexpr int kThreads = 256;  // 2 warpgroups, no producer warp
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
};

template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_dq_wgmma_wide(__grid_constant__ const CUtensorMap tm_q,
                        __grid_constant__ const CUtensorMap tm_do,
                        __grid_constant__ const CUtensorMap tm_k,
                        __grid_constant__ const CUtensorMap tm_v,
                        __grid_constant__ const CUtensorMap tm_dq,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, int S, int Hq,
                        int Hkv, int causal, float scale, float scale_log2) {
  using T = DqWideTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm;                  // warpgroup w's rows at w * kTile
  uint8_t* dos = sm + 2 * T::kTile;  // the same for do
  uint8_t* slots = sm + T::kSlotOffset;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + T::kBarOffset);
  uint64_t* full = q_full + 1;        // a slot's tile landed
  uint64_t* empty = full + T::kSlots;  // every warp has read a slot's tile

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kBQ;
  const int hk = h / (Hq / Hkv);
  const int n_tiles = causal ? (min(q0 + T::kBQ, S) - 1) / T::kBK + 1
                             : (S + T::kBK - 1) / T::kBK;
  const int n_loads = 2 * n_tiles;
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
    for (int x = 0; x < T::kSlots; ++x) {
      hw::mbar_init(full + x, 1);
      hw::mbar_init(empty + x, 8);  // one arrival per warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  // The kv tiles are walked from the last to the first (the diagonal, and
  // the tiles that need the mask, first).  Load n is tile n / 2's v (n
  // even) or k (n odd), into slot n % kSlots, whose round's parity flips
  // every kSlots loads (the first round's empty waits pass).  Tile i's v is
  // read by s and dp, its k by s and dq += ds.k, so with three slots the
  // next tile's k goes where this tile's v was once both warpgroups have
  // their s and dp, and the tile after next's v where this tile's k was
  // once both have added their dq.  One thread issues each load.
  auto load = [&](int n) {
    const int x = n % T::kSlots;
    const int k0 = (n_tiles - 1 - n / 2) * T::kBK;
    uint8_t* dst = slots + x * T::kTile;
    hw::mbar_wait(empty + x, ((n / T::kSlots) & 1) ^ 1);
    hw::mbar_expect_tx(full + x, T::kTile);
    for (int c = 0; c < D / 64; ++c) {
      hw::tma_load_4d(dst + c * kChunk, n % 2 ? map_k : map_v, full + x,
                      64 * c, hk, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    hw::prefetch_map(map_k);
    hw::prefetch_map(map_v);
    hw::mbar_expect_tx(q_full, 4 * T::kTile);
    for (int half = 0; half < 2; ++half) {
      for (int c = 0; c < D / 64; ++c) {
        const int off = half * T::kTile + c * kChunk;
        hw::tma_load_4d(qs + off, &tm_q, q_full, 64 * c, h, q0 + 64 * half, b);
        hw::tma_load_4d(dos + off, &tm_do, q_full, 64 * c, h, q0 + 64 * half,
                        b);
      }
    }
    for (int n = 0; n < min(T::kSlots, n_loads); ++n) load(n);
  }

  // Warps 0-3 are warpgroup 0 (q rows q0 .. q0 + 63), 4-7 warpgroup 1 (the
  // next 64); the index goes through a shuffle so that the compiler knows
  // it is uniform across each warp.  Each holds its 64 x 256 dq whole, as
  // two 64 x 128 halves (m64n128k16 on k's chunks 0-1 and 2-3), beside s
  // and dp (m64n64k16).
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_q = q0 + 64 * wg;        // the warpgroup's first row
  const int r0 = row_q + 16 * warp + g;  // this thread's rows: r0, r0 + 8
  const size_t row_base = (static_cast<size_t>(b) * Hq + h) * S;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse2[r] = row < S ? lse[row_base + row] * kLog2e : 0.f;
    dl[r] = row < S ? delta[row_base + row] * scale : 0.f;
  }
  uint8_t* qw = qs + wg * T::kTile;
  const uint32_t q_addr = hw::smem_addr(qw);
  const uint32_t do_addr = hw::smem_addr(dos + wg * T::kTile);
  float dq[2][64];
#pragma unroll
  for (int n = 0; n < 64; ++n) dq[0][n] = dq[1][n] = 0.f;

  // Ping-pong, as in flash_bwd_dq_wgmma: before each product warpgroup w
  // waits on named barrier kTurn + w, which the other warpgroup arrives on
  // once it has issued its own product.  Warpgroup 1 opens with one arrival
  // so that warpgroup 0 goes first, and skips its last one, so every
  // barrier phase gets 128 + 128 threads.  Warpgroup 1's products run
  // second, so its first thread issues the loads of the slots both have
  // read.
  constexpr int kTurn = 3;  // ids 3 and 4; 1 and 2 are the epilogue's
  if (wg == 1) hw::named_arrive(kTurn, 256);
  hw::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (n_tiles - 1 - i) * T::kBK;
    const int xv = (2 * i) % T::kSlots, xk = (2 * i + 1) % T::kSlots;
    const uint32_t v_addr = hw::smem_addr(slots + xv * T::kTile);
    const uint32_t k_addr = hw::smem_addr(slots + xk * T::kTile);
    hw::mbar_wait(full + xv, ((2 * i) / T::kSlots) & 1);
    hw::mbar_wait(full + xk, ((2 * i + 1) / T::kSlots) & 1);

    // s = q.k^T and dp = do.v^T (64 q rows x 64 kv columns), each a new
    // definition by its first wgmma.
    float s[32], dp[32];
    hw::named_barrier(kTurn + wg, 256);
    hw::wgmma_fence();
    issue_st_dpt<D>(s, dp, q_addr, do_addr, k_addr, v_addr);
    hw::wgmma_commit();
    hw::named_arrive(kTurn + 1 - wg, 256);
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    hw::fence_regs(dp);
    if (lane == 0) hw::mbar_arrive(empty + xv);
    if (wg == 1 && tid == 0 && 2 * i + 3 < n_loads) load(2 * i + 3);

    // ds = p (dp scale - delta scale) into dp (dl holds delta scale), p =
    // 2^(s scale log2 e - lse log2 e), 0 on masked pairs; this thread's
    // rows r0 and r0 + 8.
    auto softmax = [&](const bool masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          p_ds_fast(s[4 * j + e], dp[4 * j + e], lse2[r], dl[r], masked,
                    causal, r0 + 8 * r, k0 + 8 * j + 2 * t + (e & 1), S,
                    scale, scale_log2);
        }
      }
    };
    if (needs_mask(causal, row_q, 64, k0, T::kBK, S)) {
      softmax(true);
    } else {
      softmax(false);
    }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        da[kk][r] = pack_f32(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }

    // dq += ds.k; the k dimension is the kv rows, k read as an MN-major B
    // operand, half by half.
    hw::named_barrier(kTurn + wg, 256);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = kk * 16 * 128;
      hw::wgmma_rs(dq[0], da[kk], hw::sw128_desc(k_addr + off, kChunk, 1024));
      hw::wgmma_rs(dq[1], da[kk],
                   hw::sw128_desc(k_addr + 2 * kChunk + off, kChunk, 1024));
    }
    hw::wgmma_commit();
    if (wg == 0 || i + 1 < n_tiles) hw::named_arrive(kTurn + 1 - wg, 256);
    hw::wgmma_wait<0>();
    hw::fence_regs(dq[0]);
    hw::fence_regs(dq[1]);
    if (lane == 0) hw::mbar_arrive(empty + xk);
    if (wg == 1 && tid == 0 && 2 * i + 4 < n_loads) load(2 * i + 4);
  }

  // Epilogue: dq in bf16 through this warpgroup's q buffer (no longer
  // read), then one TMA store per chunk, which drops rows >= S.
  hw::store_acc_sw128(qw, dq[0]);
  hw::store_acc_sw128(qw + 2 * kChunk, dq[1]);
  hw::fence_async_shared();
  hw::named_barrier(1 + wg, 128);
  if (tid == 0) {
    if (row_q < S) {
      for (int c = 0; c < D / 64; ++c) {
        hw::tma_store_4d(&tm_dq, qw + c * kChunk, 64 * c, h, row_q, b);
      }
    }
    hw::tma_store_commit();
    hw::tma_store_wait_read();
  }
}

template <int D>
int launch_dq_wide(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int S, int Hq, int Hkv, int causal,
                   float scale, float scale_log2, cudaStream_t stream) {
  using T = DqWideTiles<D>;
  const int n_q = (S + T::kBQ - 1) / T::kBQ;
  if (n_q > 65535 || B > 65535) return cudaErrorInvalidValue;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(flash_bwd_dq_wgmma_wide<D>, T::kSmem, opted);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, 64);
  if (!err) err = hw::bshd_map(&tm_do, dout, B, S, Hq, D, 64);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dq, dq, B, S, Hq, D, 64);
  if (err) return err;
  flash_bwd_dq_wgmma_wide<D>
      <<<dim3(Hq, n_q, B), T::kThreads, T::kSmem, stream>>>(
          tm_q, tm_do, tm_k, tm_v, tm_dq, lse, delta, S, Hq, Hkv, causal,
          scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The D = 512 kernel's tiles and dynamic shared memory (a block's half of
// D, kCols columns): q and do (each 4 chunks of 64 rows, 8 KB a chunk: 64
// KB), then kStages stages of k and v (each 4 chunks of 32 rows, 4 KB a
// chunk: 32 KB a stage), then each warpgroup's buffer that receives the
// peer's partials, then each warpgroup's that stages its own (16 KB each),
// then the barriers; + 1024 bytes to align the base to a swizzle atom.
// Tile i lands in stage i % kStages and is read by warpgroup i % 2 alone,
// so its full barrier is i % kFulls: each barrier's tiles then go to one
// warpgroup, which waits for every phase of it in turn (with one barrier
// a stage, a warpgroup that had not seen tile i land could take the
// phase of tile i - 3 for that of tile i + 3).
struct DqClusterTiles {
  static constexpr int kCols = 256;  // a block's columns of D = 512
  static constexpr int kBQ = 64, kBK = 32, kStages = 3, kFulls = 2 * kStages;
  static constexpr int kChunkK = kBK * 128;           // a 32-row chunk: 4 KB
  static constexpr int kQ = kCols / 64 * kChunk;      // its q or do: 32 KB
  static constexpr int kKv = kCols / 64 * kChunkK;    // a tile's k or v: 16 KB
  static constexpr int kStageOffset = 2 * kQ;
  static constexpr int kX = kPartialBytes;  // a tile's s and dp
  static constexpr int kXOffset = kStageOffset + kStages * 2 * kKv;
  static constexpr int kYOffset = kXOffset + 2 * kX;
  static constexpr int kBarOffset = kYOffset + 2 * kX;
  static constexpr int kSmem = kBarOffset + (1 + kFulls + 4) * 8 + 1024;
  static constexpr int kThreads = kWideThreads;
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
  static_assert(kStages * 2 * kKv >= 64 * kCols * 4,
                "the stages hold a warpgroup's f32 dq at the end");
};

// The D = 512 kernel (see the header): a cluster of two blocks per (q
// tile of 64 rows, q head, batch), block r owning D's columns 256 r .. 256
// r + 255; warpgroup w takes the kv tiles i = w, w + 2, .. of 32 rows, from
// the causal diagonal down, and keeps its own 64 x 256 f32 dq.
template <>
__global__ void __launch_bounds__(DqClusterTiles::kThreads, 1)
flash_bwd_dq_wgmma_wide<512>(__grid_constant__ const CUtensorMap tm_q,
                             __grid_constant__ const CUtensorMap tm_do,
                             __grid_constant__ const CUtensorMap tm_k,
                             __grid_constant__ const CUtensorMap tm_v,
                             __grid_constant__ const CUtensorMap tm_dq,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta, int S, int Hq,
                             int Hkv, int causal, float scale,
                             float scale_log2) {
  using T = DqClusterTiles;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm;                      // the block's columns of q
  uint8_t* dos = sm + T::kQ;             // and of do
  uint8_t* kvs = sm + T::kStageOffset;   // stage st: k at 2 st kKv, then v
  uint8_t* xs = sm + T::kXOffset;        // warpgroup w's from the peer
  uint8_t* ys = sm + T::kYOffset;        // warpgroup w's to the peer
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + T::kBarOffset);
  uint64_t* full = q_full + 1;           // a tile's k and v landed
  uint64_t* xfull = full + T::kFulls;    // the peer's partials landed
  uint64_t* xempty = xfull + 2;          // the peer read this block's partials

  const uint32_t rank = hw::cluster_rank(), peer = rank ^ 1;
  const int col0 = static_cast<int>(rank) * T::kCols;
  const int h = blockIdx.x / 2, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kBQ;
  const int hk = h / (Hq / Hkv);
  const int n_tiles = causal ? (min(q0 + T::kBQ, S) - 1) / T::kBK + 1
                             : (S + T::kBK - 1) / T::kBK;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
    for (int f = 0; f < T::kFulls; ++f) hw::mbar_init(full + f, 1);
    for (int w = 0; w < 2; ++w) {
      hw::mbar_init(xfull + w, 1);     // the owner's expect_tx, + the copy
      hw::mbar_init(xempty + w, 128);  // every thread of the peer's warpgroup
    }
    hw::fence_barrier_init();
  }
  hw::cluster_sync();

  // Tile i (kv rows from (n_tiles - 1 - i) kBK: the diagonal, and the
  // tiles that need the mask, first) goes to stage i % kStages and
  // completes full barrier i % kFulls, whose phase's parity flips every
  // kFulls tiles.  Only warpgroup i % 2 reads it, so once that warpgroup's
  // dq += ds.k has read it, its first thread loads tile i + kStages there:
  // no empty barrier.
  auto load = [&](int i) {
    const int st = i % T::kStages;
    const int k0 = (n_tiles - 1 - i) * T::kBK;
    uint8_t* ks = kvs + 2 * st * T::kKv;
    uint64_t* bar = full + i % T::kFulls;
    hw::mbar_expect_tx(bar, 2 * T::kKv);
    for (int c = 0; c < T::kCols / 64; ++c) {
      hw::tma_load_4d(ks + c * T::kChunkK, &tm_k, bar, col0 + 64 * c, hk, k0,
                      b);
      hw::tma_load_4d(ks + T::kKv + c * T::kChunkK, &tm_v, bar, col0 + 64 * c,
                      hk, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    hw::prefetch_map(&tm_k);
    hw::prefetch_map(&tm_v);
    hw::mbar_expect_tx(q_full, 2 * T::kQ);
    for (int c = 0; c < T::kCols / 64; ++c) {
      hw::tma_load_4d(qs + c * kChunk, &tm_q, q_full, col0 + 64 * c, h, q0, b);
      hw::tma_load_4d(dos + c * kChunk, &tm_do, q_full, col0 + 64 * c, h, q0,
                      b);
    }
    for (int i = 0; i < min(T::kStages, n_tiles); ++i) load(i);
  }

  // Warps 0-3 are warpgroup 0, 4-7 warpgroup 1; the index goes through a
  // shuffle so that the compiler knows it is uniform across each warp.
  // Both hold the tile's 64 q rows; this thread's are r0 and r0 + 8.
  const int wg =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp + g;
  const size_t row_base = (static_cast<size_t>(b) * Hq + h) * S;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse2[r] = row < S ? lse[row_base + row] * kLog2e : 0.f;
    dl[r] = row < S ? delta[row_base + row] * scale : 0.f;
  }
  const uint32_t q_addr = hw::smem_addr(qs), do_addr = hw::smem_addr(dos);
  const uint32_t x_peer = hw::map_rank(hw::smem_addr(xs + wg * T::kX), peer);
  const uint32_t xfull_peer = hw::map_rank(hw::smem_addr(xfull + wg), peer);
  const uint32_t xempty_peer = hw::map_rank(hw::smem_addr(xempty + wg), peer);
  float dq[2][64];
#pragma unroll
  for (int n = 0; n < 64; ++n) dq[0][n] = dq[1][n] = 0.f;

  hw::mbar_wait(q_full, 0);
  for (int i = wg; i < n_tiles; i += 2) {
    const int st = i % T::kStages;
    const int k0 = (n_tiles - 1 - i) * T::kBK;
    const uint32_t k_addr = hw::smem_addr(kvs + 2 * st * T::kKv);
    const uint32_t v_addr = k_addr + T::kKv;
    hw::mbar_wait(full + i % T::kFulls, (i / T::kFulls) & 1);

    // Partial s = q.k^T and dp = do.v^T over the block's columns (64 q rows
    // x 32 kv columns), summed with the peer's.
    float s[16], dp[16];
    hw::wgmma_fence();
    issue_st_dpt<T::kCols, T::kBK>(s, dp, q_addr, do_addr, k_addr, v_addr);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(s);
    hw::fence_regs(dp);
    exchange_partials(s, dp, ys + wg * T::kX, xs + wg * T::kX, x_peer,
                      xfull + wg, xfull_peer, xempty + wg, xempty_peer,
                      (i / 2) & 1, 1 + wg);

    // ds = p (dp scale - delta scale) into dp (dl holds delta scale), p =
    // 2^(s scale log2 e - lse log2 e), 0 on masked pairs.
    auto softmax = [&](const bool masked) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          p_ds_fast(s[4 * j + e], dp[4 * j + e], lse2[r], dl[r], masked,
                    causal, r0 + 8 * r, k0 + 8 * j + 2 * t + (e & 1), S,
                    scale, scale_log2);
        }
      }
    };
    if (needs_mask(causal, q0, T::kBQ, k0, T::kBK, S)) {
      softmax(true);
    } else {
      softmax(false);
    }
    uint32_t da[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        da[kk][r] = pack_f32(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }

    // dq_h += ds.k_h; the k dimension is the 32 kv rows, k read as an
    // MN-major B operand (chunks of 32 rows), half by half.
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t off = kk * 16 * 128;
      hw::wgmma_rs(dq[0], da[kk],
                   hw::sw128_desc(k_addr + off, T::kChunkK, 1024));
      hw::wgmma_rs(dq[1], da[kk],
                   hw::sw128_desc(k_addr + 2 * T::kChunkK + off, T::kChunkK,
                                  1024));
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dq[0]);
    hw::fence_regs(dq[1]);
    if (i + T::kStages < n_tiles) {
      hw::named_barrier(1 + wg, 128);  // every warp's products have read it
      if (tid == 0) load(i + T::kStages);
    }
  }

  // Epilogue: warpgroup 0's dq + warpgroup 1's, in that order (the same
  // bits on every run), through the stages (no longer read: every tile's
  // products have completed), then in bf16 through the q buffer and one TMA
  // store a chunk, which drops rows >= S.
  hw::named_barrier(3, 256);
  float4* sum = reinterpret_cast<float4*>(kvs) + tid;
  if (wg == 1) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      sum[n * 128] = make_float4(dq[0][4 * n], dq[0][4 * n + 1],
                                 dq[0][4 * n + 2], dq[0][4 * n + 3]);
      sum[(16 + n) * 128] = make_float4(dq[1][4 * n], dq[1][4 * n + 1],
                                        dq[1][4 * n + 2], dq[1][4 * n + 3]);
    }
  }
  hw::named_barrier(3, 256);
  if (wg == 0) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float4 a = sum[n * 128], c = sum[(16 + n) * 128];
      dq[0][4 * n] += a.x;
      dq[0][4 * n + 1] += a.y;
      dq[0][4 * n + 2] += a.z;
      dq[0][4 * n + 3] += a.w;
      dq[1][4 * n] += c.x;
      dq[1][4 * n + 1] += c.y;
      dq[1][4 * n + 2] += c.z;
      dq[1][4 * n + 3] += c.w;
    }
    hw::store_acc_sw128(qs, dq[0]);
    hw::store_acc_sw128(qs + 2 * kChunk, dq[1]);
    hw::fence_async_shared();
    hw::named_barrier(1, 128);
    if (tid == 0) {
      for (int c = 0; c < T::kCols / 64; ++c) {
        hw::tma_store_4d(&tm_dq, qs + c * kChunk, col0 + 64 * c, h, q0, b);
      }
      hw::tma_store_commit();
      hw::tma_store_wait_read();
    }
  }
  hw::cluster_sync();
}

// The D = 512 kernel in clusters of two blocks along x (the pair of a q
// head's 64 q rows); a launch the card refuses returns its own error.
int launch_dq_cluster(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int S, int Hq, int Hkv, int causal,
                      float scale, float scale_log2, cudaStream_t stream) {
  using T = DqClusterTiles;
  constexpr int D = 512;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(flash_bwd_dq_wgmma_wide<D>, T::kSmem, opted);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_do, dout, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dq, dq, B, S, Hq, D, T::kBQ);
  if (err) return err;
  return launch_cluster_pair(flash_bwd_dq_wgmma_wide<D>,
                             dim3(2 * Hq, (S + T::kBQ - 1) / T::kBQ, B),
                             T::kSmem, stream, tm_q, tm_do, tm_k, tm_v, tm_dq,
                             lse, delta, S, Hq, Hkv, causal, scale,
                             scale_log2);
}

template <int D>
struct DqF32 {
  static constexpr int BQ = 16, BK = 32, LDK = D + 1;
  static constexpr size_t smem() {
    return (2 * BQ * D + 2 * BK * LDK) * sizeof(float);
  }
};

// dq on the CUDA cores: one block per (q tile of 16, q head, batch), looping
// over kv tiles of 32; warp w forms p and ds for q rows 4w..4w+3, one lane
// per kv column, and dq = ds.k with one lane per 32nd output column.  Elem
// is the storage type (storage.cuh), float at D 64, 128, 256 and 512 (192
// KB of tiles at 512; a lane holds 4 rows x 16 dq floats); ds is rounded to
// Elem before ds.k, and dq to Elem on the store.
template <typename Elem, int D>
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
  const Elem* qb = static_cast<const Elem*>(a.q) +
                   static_cast<size_t>(b) * S * q_rs + h * D;
  const Elem* dob = static_cast<const Elem*>(a.dout) +
                    static_cast<size_t>(b) * S * q_rs + h * D;
  const Elem* kb = static_cast<const Elem*>(a.k) +
                   static_cast<size_t>(b) * S * kv_rs + hk * D;
  const Elem* vb = static_cast<const Elem*>(a.v) +
                   static_cast<size_t>(b) * S * kv_rs + hk * D;

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < S;
    const size_t off = static_cast<size_t>(q0 + r) * q_rs + c;
    qs[i] = in ? tdx::to_f32(qb[off]) : 0.f;
    dos[i] = in ? tdx::to_f32(dob[off]) : 0.f;
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
      ks[r * LDK + c] = in ? tdx::to_f32(kb[off]) : 0.f;
      vs[r * LDK + c] = in ? tdx::to_f32(vb[off]) : 0.f;
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
      const float ds_q = tdx::round_to<Elem>(ds);  // ds in q's dtype
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        const float dsc = __shfl_sync(0xffffffffu, ds_q, c);
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
    Elem* out = static_cast<Elem*>(a.dq) +
                (static_cast<size_t>(b) * S + row) * q_rs + h * D + lane;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      out[32 * i] = tdx::from_f32<Elem>(acc[rr][i]);
    }
  }
}

static_assert(DqF32<512>::smem() <= kMaxSmem, "f32 dq tile too large");

template <typename Elem, int D>
int launch_dq(const BwdArgs& args, int B, cudaStream_t stream) {
  using T = DqF32<D>;
  return launch_dyn(bwd_dq_f32<Elem, D>,
                    dim3((args.S + T::BQ - 1) / T::BQ, args.Hq, B), T::smem(),
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (dtype == 1 && D == 64) {
    return launch_dq_bf16<64>(q, k, v, dout, lse_f, delta_f, dq, B, S, Hq,
                              Hkv, causal, scale, scale_log2, st);
  }
  if (dtype == 1 && D == 128) {
    return launch_dq_bf16<128>(q, k, v, dout, lse_f, delta_f, dq, B, S, Hq,
                               Hkv, causal, scale, scale_log2, st);
  }
  if (dtype == 1 && D == 256) {
    return launch_dq_wide<256>(q, k, v, dout, lse_f, delta_f, dq, B, S, Hq,
                               Hkv, causal, scale, scale_log2, st);
  }
  if (dtype == 1 && D == 512) {
    return launch_dq_cluster(q, k, v, dout, lse_f, delta_f, dq, B, S, Hq, Hkv,
                             causal, scale, scale_log2, st);
  }
  BwdArgs args{};
  args.q = q;
  args.k = k;
  args.v = v;
  args.dout = dout;
  args.lse = lse_f;
  args.delta = delta_f;
  args.dq = dq;
  args.S = S;
  args.Hq = Hq;
  args.Hkv = Hkv;
  args.causal = causal;
  args.scale = scale;
  args.scale_log2 = scale_log2;
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(args, B, st);
  if (dtype == 0 && D == 128) return launch_dq<float, 128>(args, B, st);
  if (dtype == 0 && D == 256) return launch_dq<float, 256>(args, B, st);
  if (dtype == 0 && D == 512) return launch_dq<float, 512>(args, B, st);
  return cudaErrorInvalidValue;
}
