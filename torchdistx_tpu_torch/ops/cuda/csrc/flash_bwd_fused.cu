// Fused flash-attention backward for Hopper (sm_90a): dq, dk and dv in one
// kernel, causal or not, with GQA.
//
// Replaces torchdistx_tpu/ops/pallas/flash_attention.py:_dqkv_fused_kernel,
// the Pallas TPU kernel launched by _fa_backward_fused_nk1, which the JAX
// backward takes when the padded sequence is at most _FUSED_BWD_MAX_KV
// (2048).  Same function: p and ds recomputed ONCE per (q, kv) pair from the
// saved lse (flash_bwd_common.cuh:p_ds_fast) and fed to all three products,
// dq = ds.k, dk = ds^T.q and dv = p^T.do, with the GQA group summed inside
// the block.
//
// The TPU premise does not carry over.  There, one grid step holds the whole
// kv extent in VMEM and a sequential grid axis carries dk/dv accumulators
// over (group, q block) steps, which leaves each q block's dq complete after
// its own step.  Here k and v at S = 2048, D = 128 are 512 KB each in bf16
// against 227 KB of shared memory a block, and blocks run in parallel in no
// order.  So a block owns a kv tile and keeps its dk and dv in f32
// registers, and dq, which sums over kv tiles held by different blocks,
// goes into an f32 buffer that the caller zeroes and casts to q's dtype.
// The TPU working-set cap (_FUSED_BWD_VMEM_CAP, with its fall back to the
// streamed pair) becomes the shared-memory budget, fixed per D and checked
// when the kernel is compiled (FusedTiles), so no shape exceeds it.
//
// bf16 (flash_bwd_fused_wgmma): the dk/dv kernel's design (flash_bwd_dkv.cu,
// on the same step functions of flash_bwd_common.cuh) with dq added and a
// persistent grid.  A block has two consumer warpgroups and one producer
// warp.  It walks its works (hopper.cuh:PairedWorks; a work is one kv tile
// of 64 rows of one kv head and batch; causal kv tiles n - 1 - p and p go
// together, so every block gets the same number of q steps; works go out
// head-major, so blocks side by side share q and do in L2).  The producer
// loads each work's k and v by TMA into one of two k/v buffers, so the next
// work's stream in during this one, and q and do tiles of 64 rows into a
// ring of kStages stages numbered across works, its lanes copying each
// stage's lse (times log2 e) and delta (times scale) with plain loads.
// Warpgroup 0 holds dv and warpgroup 1 dk (both would not fit in the 168
// registers that ptxas gives a thread of a 288-thread block).  The steps
// (GQA head, q tile) alternate between them: the owner of a step computes
// s^T and dp^T (m64n64k16), p and ds, and stores them by stmatrix into one
// of two p/ds buffers as a K-major operand (kv row r at byte r * 128); both
// warpgroups then accumulate the step in order, dv += p^T.do and dk +=
// ds^T.q, so dk and dv are the same bits on every run.  dq = ds.k is the
// owner's: it reads the same ds buffer as an MN-major A operand (the tile's
// transpose, by wgmma's transpose bit) and the k buffer as an MN-major B
// (m64nDk16), so nothing is copied or transposed; s^T and dp^T are dead by
// then, so the accumulator and dq hold 128 registers at D = 128.  The owner
// waits for dq, writes it in f32 into its own 128-byte-swizzled dq tile in
// shared memory, and one thread adds the tile to the f32 buffer by TMA's
// bulk tensor reduction (cp.reduce.async.bulk.tensor ... add), which drops
// rows >= S and runs off the warpgroups' path; the warpgroup's next dq
// waits until the reduction has read the tile.  The order of the additions
// across blocks, and so dq's last bits, varies from run to run.  TMA
// zero-fills rows >= S; p is still masked there.  A work's epilogue waits
// until neither warpgroup reads its k or v (the last dq reads k), writes dv
// and dk as bf16 through the v and k buffers and TMA stores (rows >= S
// dropped); the buffer goes back to the producer once the stores have read
// it, at the next work's start.
//
// Shared memory at D = 128: 2 x (k, v) 64 KB + 2 stages of (q, do) 64 KB +
// 2 p/ds buffers 32 KB + 2 dq tiles 64 KB = 224 KB of the 227 KB a block
// may use, so 2 stages (6 at D = 64).  Variants (patched copies of this
// file timed in turns with it, PERF.md section 6), device ms on an NVIDIA
// H100 80GB HBM3 at 700 W, at B 4, S 512, 32 heads, D 128, causal (in
// brackets B 2, S 1024, 64/8 heads): this design 0.130 (0.385; the
// warp-level-mma kernel it replaces took 0.348 in chip_smoke.py);
// dq added from registers, two columns an atomic (red.global.add.v2.f32)
// 0.146 (0.444), four after neighbouring lanes swap halves 0.150 (0.460);
// without the additions 0.096 (0.271), without dq 0.094 (0.260), so the
// 151 MB of additions into L2 are what dq costs; works pair-major instead
// of head-major 0.185 (0.404); one k/v buffer and 3 stages 0.125 (0.394;
// in 8 alternating pairs a tie on the train shape, 0.1302 against 0.1308,
// and 4.3 % slower on the longer GQA loops, 0.3993 against 0.3821, so the
// next work's k and v keep streaming in); one dq tile that the
// warpgroups hand over by an mbarrier, 3 stages, 0.127 (0.410).
//
// bf16 at D = 256 (flash_bwd_fused_wgmma_wide): a 64 x 256 f32
// accumulator is 128 registers a thread, so the design above (dk or dv
// beside dq and s^T, dp^T under 168 registers) does not fit.  It is
// flash_bwd_common.cuh's bwd_kv_wide, the D = 256 dk/dv kernel's body (256
// threads, no producer warp, 255 registers; warpgroup 0 holds dv and 1 dk
// whole) with dq: the step's owner forms dq = ds.k in two 64 x 128 halves,
// writes each in f32 into half of the step's stage once its q or do is
// dead, and adds it by a bulk tensor reduction (the header there has the
// design and the variants timed).  Not persistent: a block per (kv head,
// kv tile, batch), tile 0 (the most causal steps) first.  232 registers,
// no spills.  Device ms on an NVIDIA H100 80GB HBM3 at 700 W at B 2, S
// 1024, 16 heads, causal, through the wrapper (which zeroes and casts the
// f32 dq): 0.19, 0.185 on the device (the CUDA-core body it replaces
// 4.7); dk/dv alone 0.095, SDPA's whole backward 0.21 on the device
// (PERF.md).  What bounds it there: 5
// products, 43.5 us at the tensor rate; what holds it back is the 285 MB
// of f32 dq partials added in L2 (0.154 without the additions) and the
// two-stage ring, whose refill waits for those reductions.
//
// bf16 at D = 512 (flash_bwd_fused_wgmma_wide<512>): the D = 512 dk/dv
// kernel's body with dq, flash_bwd_common.cuh's bwd_kv_cluster<true>: two
// blocks of a cluster share 64 kv rows, each holding 256 of D's columns;
// steps of 32 q rows, whose partial s^T and dp^T the blocks exchange; the
// step's owner forms dq^T = k^T.ds^T over its columns in two passes (wgmma
// m64n32k16: a step's 32 q rows cannot be wgmma's 64) and adds each by
// bulk tensor reductions through the step's stage (the header there has
// the design).  It replaces a CUDA-core body that (1) ran every product as
// scalar FMAs from shared memory, bf16 widened to f32; (2) took 16-row kv
// tiles, one 128-thread block each, so 38 blocks at 2 x 300, 8/2 heads;
// (3) loaded each tile between two barriers, nothing in flight under the
// products; (4) added dq by one scalar atomic per element and 16-row kv
// tile.  Here (1) the products run on the tensor cores from bf16 tiles,
// (2) two blocks of 256 threads share each 64 kv rows, (3) TMA brings the
// next step's q and do while a step runs, and (4) dq goes out as 32 x 32
// f32 boxes by bulk reductions, 4 per pass, each 64 kv rows' sum.  What
// bounds it on an H100 SXM: at B 2, S 1024, 8 heads of 512, causal, 5
// products, 43.0 GFLOP, 0.0435 ms at the 989 TFLOP/s dense bf16 rate,
// against 118 MB of q, k, v, do, dq, dk, dv, lse and delta, 0.0351 ms at
// 3.35 TB/s: bound by operations (chip_smoke.py's _bwd_bound).  Device ms
// on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): 0.258
// there and 0.133 at B 2, S 300, 8/2 heads (the CUDA-core body 6.23 and
// 1.71; dk/dv alone 0.184 and 0.102; SDPA's whole backward 3.38 and
// 0.63).  Timed against it in turns (scripts/torch_d256_ab.py --d 512):
// dq added from registers by float4 atomics (a 4 x 4 shuffle transpose to
// four columns a lane, the stages refilled as in dk/dv) 10-17 % slower;
// knocked out, the exchange takes 19-22 % off and the dq reductions
// 10-12 %, so the exchange is the larger cost.
//
// f32 at D 64, 128, 256 and 512: CUDA cores, flash_bwd_kv_f32.cuh's
// bwd_kv_f32_tiled with kDq (the dk/dv body, dq = ds.k added to the f32
// buffer by 16-byte vector atomics); that header has the design and its
// bound.
//
// What bounds it on an H100 SXM: at the Llama-7B training shape (B 4, S 512,
// 32 heads, D 128, bf16, causal) it must read q, k, v, do and write dq, dk,
// dv (7 x 16.8 MB) plus lse and delta, 118 MB, 35 us at 3.35 TB/s, against
// 5 products of 2 D flops per causal pair, 21.5 GFLOP, 22 us at 989
// TFLOP/s: bound by bytes.  What this design leaves on the table: every
// block streams every q and do tile of its head from L2 (a 64-row kv tile
// per block), and adds a 64 x D f32 dq tile per step in L2 (4 x 512: 4,608
// steps, 151 MB of reductions, about 0.035 ms of the 0.130); the owner waits
// for its accumulation and dq before its next s^T and dp^T (dq would not
// fit beside them and the accumulator); a work of 4 x 512 has 4.5 steps on
// average, so each work's first p and ds and its epilogue weigh; and a
// step's critical path is one warpgroup's p and ds plus the accumulations,
// as in dk/dv.

#include <limits.h>

#include "flash_bwd_kv_f32.cuh"

namespace tdx_bwd {
namespace {

// Tiles and dynamic shared memory of the bf16 kernel: kKvBufs k/v buffers
// (k, then v: 64 rows x D / 64 chunks of 8 KB each), then per stage q and
// do (the same), then kPBufs buffers of p and ds (one chunk each), then
// each warpgroup's f32 dq tile (64 rows x D / 32 blocks of 8 KB), then per
// stage 64 lse and 64 delta values, then the barriers; + 1024 bytes to
// align the base to a swizzle atom.
template <int D>
struct FusedTiles {
  static constexpr int kBK = 64, kBQ = 64;
  static constexpr int kKvBufs = 2;
  static constexpr int kStages = D == 128 ? 2 : 6;
  static constexpr int kPBufs = 2;
  static constexpr int kTile = D / 64 * kChunk;  // one 64 x D bf16 tile
  static constexpr int kDqTile = kBQ * D * 4;    // one 64 x D f32 tile
  static constexpr int kQOffset = kKvBufs * 2 * kTile;
  static constexpr int kPOffset = kQOffset + 2 * kStages * kTile;
  static constexpr int kDqOffset = kPOffset + kPBufs * 2 * kChunk;
  static constexpr int kRowsOffset = kDqOffset + 2 * kDqTile;
  static constexpr int kBarOffset = kRowsOffset + 2 * kStages * kBQ * 4;
  static constexpr int kSmem =
      kBarOffset + (2 * kKvBufs + 2 * kStages) * 8 + 1024;
  static constexpr int kThreads = 288;  // 2 consumer warpgroups + 1 warp
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
};

template <int D>
__global__ void __launch_bounds__(FusedTiles<D>::kThreads, 1)
flash_bwd_fused_wgmma(__grid_constant__ const CUtensorMap tm_q,
                      __grid_constant__ const CUtensorMap tm_do,
                      __grid_constant__ const CUtensorMap tm_k,
                      __grid_constant__ const CUtensorMap tm_v,
                      __grid_constant__ const CUtensorMap tm_dk,
                      __grid_constant__ const CUtensorMap tm_dv,
                      __grid_constant__ const CUtensorMap tm_dq,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int B, int S, int Hq,
                      int Hkv, int causal, float scale, float scale_log2) {
  using T = FusedTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* kvs = sm;                 // buffer j: k at 2 j kTile, then v
  uint8_t* qds = sm + T::kQOffset;   // stage st: q at 2 st kTile, then do
  uint8_t* pds = sm + T::kPOffset;   // buffer j: p at 2 j kChunk, then ds
  uint8_t* dqs = sm + T::kDqOffset;  // warpgroup w's dq at w kDqTile
  float* lse_s = reinterpret_cast<float*>(sm + T::kRowsOffset);
  float* delta_s = lse_s + T::kStages * T::kBQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + T::kBarOffset);
  uint64_t* kv_empty = kv_full + T::kKvBufs;
  uint64_t* full = kv_empty + T::kKvBufs;
  uint64_t* empty = full + T::kStages;

  const int G = Hq / Hkv;
  const int n_kv = (S + T::kBK - 1) / T::kBK;  // also the number of q tiles

  if (threadIdx.x == 0) {
    for (int j = 0; j < T::kKvBufs; ++j) {
      hw::mbar_init(kv_full + j, 1);
      hw::mbar_init(kv_empty + j, 2);  // one arrival per consumer warpgroup
    }
    for (int st = 0; st < T::kStages; ++st) {
      hw::mbar_init(full + st, 32);  // every producer lane
      hw::mbar_init(empty + st, 8);  // every consumer warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  // Both roles walk the same works and number their steps, (group, q tile)
  // in order, across them: the block's i-th step uses stage i % kStages,
  // whose round's parity flips every kStages steps, and the j-th work's k
  // and v buffer j % kKvBufs, its parity flipping every kKvBufs works;
  // first-round empty waits pass.  Warps 0-7 are consumer warpgroups 0 and 1, warp 8
  // the producer; the index goes through a shuffle so that the compiler
  // knows it is uniform across each warp.
  const int warp =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int wg = warp / 4, lane = threadIdx.x % 32;
  if (wg == 2) {
    if (lane == 0) {
      hw::prefetch_map(&tm_q);
      hw::prefetch_map(&tm_do);
      hw::prefetch_map(&tm_k);
      hw::prefetch_map(&tm_v);
    }
    int i = 0;
    int j = 0;
    for (hw::PairedWorks w(n_kv, Hkv, B); !w.done(); w.next(), ++j) {
      const int k0 = w.tile() * T::kBK, hk = w.head(), b = w.batch();
      const int qt0 = causal ? w.tile() : 0;
      if (lane == 0) {
        const int kb = j % T::kKvBufs;
        uint8_t* ks = kvs + 2 * kb * T::kTile;
        hw::mbar_wait(kv_empty + kb, ((j / T::kKvBufs) & 1) ^ 1);
        hw::mbar_expect_tx(kv_full + kb, 2 * T::kTile);
        for (int c = 0; c < D / 64; ++c) {
          hw::tma_load_4d(ks + c * kChunk, &tm_k, kv_full + kb, 64 * c, hk, k0,
                          b);
          hw::tma_load_4d(ks + T::kTile + c * kChunk, &tm_v, kv_full + kb,
                          64 * c, hk, k0, b);
        }
      }
      for (int gi = 0; gi < G; ++gi) {
        const int h = hk * G + gi;
        const size_t row0 = (static_cast<size_t>(b) * Hq + h) * S;
        for (int qt = qt0; qt < n_kv; ++qt, ++i) {
          const int st = i % T::kStages, q0 = qt * T::kBQ;
          hw::mbar_wait(empty + st, ((i / T::kStages) & 1) ^ 1);
          for (int r = lane; r < T::kBQ; r += 32) {
            const int row = q0 + r;
            lse_s[st * T::kBQ + r] = row < S ? lse[row0 + row] * kLog2e : 0.f;
            delta_s[st * T::kBQ + r] =
                row < S ? delta[row0 + row] * scale : 0.f;
          }
          if (lane == 0) {
            uint8_t* qs = qds + 2 * st * T::kTile;
            hw::mbar_expect_tx(full + st, 2 * T::kTile);
            for (int c = 0; c < D / 64; ++c) {
              hw::tma_load_4d(qs + c * kChunk, &tm_q, full + st, 64 * c, h,
                              q0, b);
              hw::tma_load_4d(qs + T::kTile + c * kChunk, &tm_do, full + st,
                              64 * c, h, q0, b);
            }
          } else {
            hw::mbar_arrive(full + st);
          }
        }
      }
    }
  } else {
    // Step s of a work belongs to warpgroup s % 2 (see the header).  Named
    // barrier kReady + s % 2 hands step s's p and ds from its owner to the
    // other warpgroup; 3 + wg orders a warpgroup's own shared-memory writes;
    // kBoth holds a work's epilogue until neither warpgroup reads its k or
    // v.  Each step's stage goes back to the producer once this
    // warpgroup's accumulation of it has completed (one arrival per warp).
    constexpr int kReady = 1;  // ids 1 and 2
    constexpr int kBoth = 5;
    const int tid = threadIdx.x % 128;
    float acc[D / 2];
    int i0 = 0;  // the block's steps before this work
    int j = 0;
    for (hw::PairedWorks w(n_kv, Hkv, B); !w.done(); w.next(), ++j) {
      const int k0 = w.tile() * T::kBK, hk = w.head(), b = w.batch();
      const int qt0 = causal ? w.tile() : 0;
      const int n_per_group = n_kv - qt0, n_steps = G * n_per_group;
      const int kb = j % T::kKvBufs;
      uint8_t* ks = kvs + 2 * kb * T::kTile;
      uint8_t* vs = ks + T::kTile;
      const uint32_t k_addr = hw::smem_addr(ks), v_addr = hw::smem_addr(vs);
#pragma unroll
      for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;

      auto stage = [&](int s) { return (i0 + s) % T::kStages; };
      auto parity = [&](int s) { return ((i0 + s) / T::kStages) & 1; };
      // Issues step s's accumulation (not committed): p (warpgroup 0) or
      // ds (1) times do (0) or q (1).
      auto issue_step_acc = [&](int s) {
        issue_acc<D>(acc,
                     hw::smem_addr(pds + (s % T::kPBufs) * 2 * kChunk +
                                   wg * kChunk),
                     hw::smem_addr(qds + 2 * stage(s) * T::kTile +
                                   (1 - wg) * T::kTile));
      };
      auto wait_ready = [&](int s) {
        hw::named_barrier(kReady + s % 2, 256);
        hw::mbar_wait(full + stage(s), parity(s));
      };
      auto release = [&](int s) {
        if (lane == 0) hw::mbar_arrive(empty + stage(s));
      };

      // The previous work's dk/dv stores have read their k/v buffer: it
      // goes back to the producer.
      if (j > 0 && tid == 0) {
        hw::tma_store_wait_read();
        hw::mbar_arrive(kv_empty + (j - 1) % T::kKvBufs);
      }
      hw::mbar_wait(kv_full + kb, (j / T::kKvBufs) & 1);

      // Own step s: issue s^T and dp^T, then the other warpgroup's step
      // s - 1 accumulation once its p and ds are written, wait for both,
      // compute and write p and ds, then issue step s's accumulation and
      // dq, wait for them and add dq to the buffer.  Buffer s % kPBufs was
      // last read by step s - kPBufs's accumulations and dq, which both
      // warpgroups waited for before this warpgroup's wait for step s - 1.
      for (int s = wg; s < n_steps; s += 2) {
        const int st = stage(s);
        const int q0 = (qt0 + s % n_per_group) * T::kBQ;
        const uint32_t q_addr = hw::smem_addr(qds + 2 * st * T::kTile);
        const uint32_t do_addr = q_addr + T::kTile;
        hw::mbar_wait(full + st, parity(s));

        float sv[32], dp[32];
        hw::wgmma_fence();
        issue_st_dpt<D>(sv, dp, k_addr, v_addr, q_addr, do_addr);
        hw::wgmma_commit();
        // This warpgroup's last dq reduction has read its dq tile (ordered
        // before the tile's next writes by the barrier after p and ds).
        if (tid == 0) hw::tma_store_wait_read();
        if (s > 0) {
          wait_ready(s - 1);
          hw::wgmma_fence();
          issue_step_acc(s - 1);
          hw::wgmma_commit();
        }
        hw::wgmma_wait<0>();
        hw::fence_regs(sv);
        hw::fence_regs(dp);
        if (s > 0) release(s - 1);

        uint8_t* pb = pds + (s % T::kPBufs) * 2 * kChunk;
        p_ds_store(sv, dp, lse_s + st * T::kBQ, delta_s + st * T::kBQ,
                   needs_mask(causal, q0, T::kBQ, k0, T::kBK, S), causal, q0,
                   k0, S, scale, scale_log2, pb, warp, lane);
        hw::fence_async_shared();
        hw::named_barrier(3 + wg, 128);  // this warpgroup's writes are done
        hw::named_arrive(kReady + wg, 256);

        float dq[D / 2];
        hw::wgmma_fence();
        issue_step_acc(s);
        issue_dq<D>(dq, hw::smem_addr(pb + kChunk), k_addr);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(dq);
        release(s);
        uint8_t* dqw = dqs + wg * T::kDqTile;
        hw::store_acc_sw128_f32(dqw, dq);
        hw::fence_async_shared();
        hw::named_barrier(3 + wg, 128);
        if (tid == 0) {
          for (int c = 0; c < D / 32; ++c) {
            hw::tma_reduce_add_4d(&tm_dq, dqw + c * 8192, 32 * c,
                                  hk * G + s / n_per_group, q0, b);
          }
          hw::tma_store_commit();
        }
      }
      if ((n_steps - 1) % 2 != wg) {  // the last step is the other's
        wait_ready(n_steps - 1);
        hw::wgmma_fence();
        issue_step_acc(n_steps - 1);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        release(n_steps - 1);
      }
      hw::fence_regs(acc);

      // Epilogue: dv (warpgroup 0) through the v buffer, dk (1) through the
      // k buffer, in bf16, then one TMA store per chunk.
      hw::named_barrier(kBoth, 256);
      uint8_t* out = wg == 0 ? vs : ks;
      hw::store_acc_sw128(out, acc);
      hw::fence_async_shared();
      hw::named_barrier(3 + wg, 128);
      if (tid == 0) {
        const CUtensorMap* map = wg == 0 ? &tm_dv : &tm_dk;
        for (int c = 0; c < D / 64; ++c) {
          hw::tma_store_4d(map, out + c * kChunk, 64 * c, hk, k0, b);
        }
        hw::tma_store_commit();
      }
      i0 += n_steps;
    }
    if (tid == 0) hw::tma_store_wait_read();  // before the block exits
  }
}

template <int D>
int launch_fused_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      float* dq_acc, void* dk, void* dv, int B, int S, int Hq,
                      int Hkv, int causal, float scale, float scale_log2,
                      cudaStream_t stream) {
  using T = FusedTiles<D>;
  const int n_kv = (S + T::kBK - 1) / T::kBK;
  const long long n_units = static_cast<long long>(B) * Hkv * ((n_kv + 1) / 2);
  if (n_units > INT_MAX) return cudaErrorInvalidValue;
  static bool opted[hw::kMaxDevices];
  int n_sm = 0;
  int err = hw::smem_opt_in(flash_bwd_fused_wgmma<D>, T::kSmem, opted);
  if (!err) err = hw::sm_count(&n_sm);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, tm_dq;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_do, dout, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dk, dk, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dv, dv, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dq, dq_acc, B, S, Hq, D, T::kBQ, 4);
  if (err) return err;
  // One persistent block per SM, or one per unit of work (PairedWorks).
  const int grid = static_cast<int>(n_units < n_sm ? n_units : n_sm);
  flash_bwd_fused_wgmma<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, tm_dq, lse, delta, B, S, Hq, Hkv,
      causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The D = 256 kernel, flash_bwd_common.cuh's bwd_kv_wide with dq, and the
// D = 512 one, its bwd_kv_cluster with dq (launched as clusters of two
// blocks); dq is added to the f32 buffer through tm_dq by bulk tensor
// reductions.
template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_fused_wgmma_wide(__grid_constant__ const CUtensorMap tm_q,
                           __grid_constant__ const CUtensorMap tm_do,
                           __grid_constant__ const CUtensorMap tm_k,
                           __grid_constant__ const CUtensorMap tm_v,
                           __grid_constant__ const CUtensorMap tm_dk,
                           __grid_constant__ const CUtensorMap tm_dv,
                           __grid_constant__ const CUtensorMap tm_dq,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, int S, int Hq,
                           int Hkv, int causal, float scale,
                           float scale_log2) {
  if constexpr (D == 512) {
    bwd_kv_cluster<true>(&tm_q, &tm_do, &tm_k, &tm_v, &tm_dk, &tm_dv, &tm_dq,
                         lse, delta, S, Hq, Hkv, causal, scale, scale_log2);
  } else {
    bwd_kv_wide<D, true>(&tm_q, &tm_do, &tm_k, &tm_v, &tm_dk, &tm_dv, &tm_dq,
                         lse, delta, S, Hq, Hkv, causal, scale, scale_log2);
  }
}

template <int D>
int launch_fused_wide(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      float* dq_acc, void* dk, void* dv, int B, int S, int Hq,
                      int Hkv, int causal, float scale, float scale_log2,
                      cudaStream_t stream) {
  using T = KvWideTiles<D>;
  const int n_kv = (S + T::kBK - 1) / T::kBK;
  if (n_kv > 65535 || B > 65535) return cudaErrorInvalidValue;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(flash_bwd_fused_wgmma_wide<D>, T::kSmem, opted);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, tm_dq;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_do, dout, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dk, dk, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dv, dv, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dq, dq_acc, B, S, Hq, D, T::kBQ, 4);
  if (err) return err;
  flash_bwd_fused_wgmma_wide<D>
      <<<dim3(Hkv, n_kv, B), T::kThreads, T::kSmem, stream>>>(
          tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, tm_dq, lse, delta, S, Hq, Hkv,
          causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The D = 512 kernel in clusters of two blocks along x (the pair of a kv
// head's 64 kv rows); a launch the card refuses returns its own error.
int launch_fused_cluster(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, float* dq_acc, void* dk, void* dv,
                         int B, int S, int Hq, int Hkv, int causal, float scale,
                         float scale_log2, cudaStream_t stream) {
  using T = KvClusterTiles;
  constexpr int D = 512;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(flash_bwd_fused_wgmma_wide<D>, T::kSmem, opted);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, tm_dq;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_do, dout, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dk, dk, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dv, dv, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dq, dq_acc, B, S, Hq, D, T::kBQ, 4);
  if (err) return err;
  return launch_cluster_pair(flash_bwd_fused_wgmma_wide<D>,
                             dim3(2 * Hkv, (S + T::kBK - 1) / T::kBK, B),
                             T::kSmem, stream, tm_q, tm_do, tm_k, tm_v, tm_dk,
                             tm_dv, tm_dq, lse, delta, S, Hq, Hkv, causal,
                             scale, scale_log2);
}

}  // namespace
}  // namespace tdx_bwd

// Launches the fused backward on `stream`; returns cudaGetLastError() (0 on
// success).  dq_acc is f32 (B, S, Hq, D) and zeroed by the caller.  dtype:
// 0 = float32, 1 = bfloat16.  The caller checks shapes, contiguity and
// alignment; this checks only what selects a kernel.
extern "C" int tdx_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq_acc, void* dk,
                                   void* dv, int B, int S, int Hq, int Hkv,
                                   int D, int dtype, int causal, float scale,
                                   float scale_log2, void* stream) {
  using namespace tdx_bwd;
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  float* dq_f = static_cast<float*>(dq_acc);
  if (dtype == 1 && D == 64) {
    return launch_fused_bf16<64>(q, k, v, dout, lse_f, delta_f, dq_f, dk, dv,
                                 B, S, Hq, Hkv, causal, scale, scale_log2, st);
  }
  if (dtype == 1 && D == 128) {
    return launch_fused_bf16<128>(q, k, v, dout, lse_f, delta_f, dq_f, dk, dv,
                                  B, S, Hq, Hkv, causal, scale, scale_log2, st);
  }
  if (dtype == 1 && D == 256) {
    return launch_fused_wide<256>(q, k, v, dout, lse_f, delta_f, dq_f, dk, dv,
                                  B, S, Hq, Hkv, causal, scale, scale_log2, st);
  }
  if (dtype == 1 && D == 512) {
    return launch_fused_cluster(q, k, v, dout, lse_f, delta_f, dq_f, dk, dv, B,
                                S, Hq, Hkv, causal, scale, scale_log2, st);
  }
  BwdArgs args{};
  args.q = q;
  args.k = k;
  args.v = v;
  args.dout = dout;
  args.lse = lse_f;
  args.delta = delta_f;
  args.dq_acc = dq_f;
  args.dk = dk;
  args.dv = dv;
  args.S = S;
  args.Hq = Hq;
  args.Hkv = Hkv;
  args.causal = causal;
  args.scale = scale;
  args.scale_log2 = scale_log2;
  return launch_kv<true>(args, B, D, dtype, st);
}
