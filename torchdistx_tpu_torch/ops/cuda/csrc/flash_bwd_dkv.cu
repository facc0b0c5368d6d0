// Streamed flash-attention backward, dk/dv half, for Hopper (sm_90a),
// causal or not, with GQA.
//
// Replaces torchdistx_tpu/ops/pallas/flash_attention.py:_dkv_kernel, the
// Pallas TPU kernel that _fa_backward_streamed launches beside _dq_kernel
// for padded sequences above _FUSED_BWD_MAX_KV (2048).  Same function:
// dk = sum ds^T.q and dv = sum p^T.do per kv block over (GQA group, q block)
// pairs, p and ds recomputed from the saved lse (flash_bwd_common.cuh:p_ds),
// p cast to do's dtype and ds to q's before the products.
//
// The TPU grid's sequential (group, q block) axis, which carries dk/dv in
// VMEM scratch, becomes a loop inside one block per (kv tile of 64, kv head,
// batch) that starts at the causal diagonal (the TPU's _diag_clamp is DMA
// elision and reduces to that bound); dk and dv stay in f32 registers.
// Each block owns its dk/dv rows, so nothing is summed across blocks: no
// atomics, and the result is the same bits on every run.
//
// bf16 at D 64 and 128 (flash_bwd_dkv_wgmma), built from hopper.cuh: two
// consumer warpgroups and one producer warp.  The producer loads the tile's
// k and v once by TMA, then streams q and do tiles of 64 rows by TMA into a
// ring of
// kStages stages (4 at D = 128: 4 x 2 x 16 KB), each with a full and an
// empty mbarrier; its 32 lanes also copy the tile's lse (times log2 e) and
// delta (times scale) into the stage with plain loads (a (B, Hq, S) f32 row
// is 16-byte aligned only when S % 4 == 0, which TMA would need), guarded
// for rows >= S.  The dk and dv accumulators of 64 kv rows take 128
// registers a thread at D = 128; beside s^T and dp^T they do not fit in
// the 168 registers that ptxas gives a thread of a 288-thread block, so
// each warpgroup holds one: warpgroup 0 dv, warpgroup 1 dk.  The steps
// (GQA head, q tile) alternate between them: the owner of a step computes
// s^T = k.q^T and dp^T = v.do^T for the 64 kv rows and 64 q rows (wgmma
// m64n64k16, both operands K-major in shared memory as TMA lays them out),
// then p and ds (p_ds_fast: one FFMA, the special-function unit's exp2 and
// an FFMA and FMUL a pair; the mask only on tiles that cross the diagonal
// or S, needs_mask), and stores them in bf16 by stmatrix into one of two
// p/ds buffers, laid out as a K-major operand.  Then both warpgroups add
// the step, in step order: warpgroup 0 dv += p.do, warpgroup 1 dk += ds.q
// (wgmma m64nDk16, p or ds from the buffer, do or q from the stage as an
// MN-major B operand, so nothing is transposed).  One warpgroup's p and ds
// run while the other's products are on the tensor cores; named barriers
// pass each step's buffer from its owner to the other warpgroup.  TMA
// zero-fills rows >= S; p is still masked there (a zero q row gives p =
// exp2(-lse)).  The epilogue writes dv and dk as bf16 through the v and k
// buffers and TMA stores, which drop rows >= S.  Blocks launch heaviest
// first: kv tile 0 has the most causal q tiles, and the grid's x axis is
// the kv head, so all heads' tile 0 go first.
//
// The steps (s^T and dp^T, p and ds into the buffer, the accumulations)
// are flash_bwd_common.cuh's issue_st_dpt, p_ds_store and issue_acc, which
// the fused kernel runs too.  Built on them, this kernel gives the same
// bits as with the steps written out here, at the same time within 1 %
// and with one register more (163 at D = 128), no spills.
//
// bf16 at D = 256 (flash_bwd_dkv_wgmma_wide): dk and dv of 64 kv rows are
// 128 registers a thread each, which with s^T and dp^T (64) do not fit the
// 168 registers of a 288-thread block.  It runs flash_bwd_common.cuh's
// bwd_kv_wide, which the fused kernel runs with dq added: 256 threads (two
// warpgroups, no producer warp, so 255 registers; 232 used, no spills),
// warpgroup 0 holding dv and 1 dk whole, two stages of q and do in 231,480
// of 232,448 bytes of shared memory, mbarriers for the handoffs (the
// header there has the design).  The result is the same bits on every
// run, as below.
//
// bf16 at D = 512 (flash_bwd_dkv_wgmma_wide<512>): dk and dv of 64 kv rows
// are 2 x 64 x 512 f32, the whole register file of an SM, and 64 kv rows
// are the least a wgmma takes.  So two blocks of a cluster (neighbouring
// SMs, launched by cudaLaunchKernelEx with a cluster dimension of 2 along
// the grid's x, which pairs them per kv head) share the 64 kv rows, each
// holding 256 of D's columns of k, v, q, do, dk and dv: the body of
// bwd_kv_wide on 32-row q tiles (215 registers, no spills; 231,000 bytes
// of shared memory), with each step's s^T and dp^T summed from the two
// blocks' partials over their columns, exchanged through shared memory by
// bulk copies (flash_bwd_common.cuh's bwd_kv_cluster has the design).  The
// same bits on every run.  A launch the card refuses returns its error.
//
// f32 at D 64, 128, 256 and 512: CUDA cores, flash_bwd_kv_f32.cuh's
// bwd_kv_f32_tiled (register-blocked products, a cp.async ring of q and do
// tiles, a kv tile's steps split over a cluster whose blocks add their dk
// and dv partials in a fixed order), shared with the fused kernel; that
// header has the design and its bound.
//
// What bounds it on an H100 SXM: at Llama-7B's max_seq_len (B 1, S 4096, 32
// heads, D 128, bf16, causal) it does 4 products of 2 D flops per causal
// pair, 275 GFLOP, 278 us at the 989 TFLOP/s dense bf16 rate, against
// 202 MB of q, k, v, do, dk, dv, lse and delta, 60 us at 3.35 TB/s: bound
// by operations.  What this design leaves on the table: a warpgroup waits
// for its accumulation before its next p and ds (keeping it in flight over
// them spilled at the 168-register cap, or ran slower); the two
// warpgroups' p and ds alternate, so a step's critical path is one
// warpgroup's p and ds plus the two accumulations; a block of 64 kv rows
// streams every q and do tile of its head for 64 rows' work (128 rows
// would halve that, but their accumulators do not fit in registers); and
// s^T and dp^T are recomputed by the dq kernel (the price of two
// deterministic kernels).  At D = 256 (B 2, S 1024, 16 heads, causal: 34.4
// GFLOP, 35 us at the tensor rate) operations bound it too; with two
// stages a stage's next load waits for both accumulations of the step
// before, so a step's chain is a load, s^T and dp^T, p and ds and the
// accumulations.  At D = 512 (B 2, S 1024, 8 heads: the same 34.4 GFLOP)
// operations bound it as well; the design runs at about a fifth of that
// rate (PERF.md): a step's partials are m64n32k16 products, whose 64 x 16
// A tile is read from shared memory for 32 columns of work, and the
// exchange, knocked out, takes a third of the time off.

#include "flash_bwd_kv_f32.cuh"

namespace tdx_bwd {
namespace {

// Tiles and dynamic shared memory of the bf16 kernel: k and v (64 rows x
// D / 64 chunks of 8 KB each), then per stage q and do (the same), then
// kPBufs buffers of p and ds (one 64 x 64 chunk each), then per stage 64
// lse and 64 delta values, then the barriers; + 1024 bytes to align the
// base to a swizzle atom.
template <int D>
struct DkvTiles {
  static constexpr int kBK = 64, kBQ = 64;
  static constexpr int kStages = D == 128 ? 4 : 6;
  static constexpr int kPBufs = 2;
  static constexpr int kChunk = 64 * 128;        // one 64 x 64 chunk
  static constexpr int kTile = D / 64 * kChunk;  // one 64 x D tile
  static constexpr int kPOffset = (2 + 2 * kStages) * kTile;
  static constexpr int kRowsOffset = kPOffset + kPBufs * 2 * kChunk;
  static constexpr int kBarOffset = kRowsOffset + 2 * kStages * kBQ * 4;
  static constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
  static constexpr int kThreads = 288;  // 2 consumer warpgroups + 1 warp
  static_assert(kSmem <= 232448, "exceeds the 227 KB a block may use");
};

template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads, 1)
flash_bwd_dkv_wgmma(__grid_constant__ const CUtensorMap tm_q,
                    __grid_constant__ const CUtensorMap tm_do,
                    __grid_constant__ const CUtensorMap tm_k,
                    __grid_constant__ const CUtensorMap tm_v,
                    __grid_constant__ const CUtensorMap tm_dk,
                    __grid_constant__ const CUtensorMap tm_dv,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int S, int Hq, int Hkv,
                    int causal, float scale, float scale_log2) {
  using T = DkvTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = sm;
  uint8_t* vs = sm + T::kTile;
  uint8_t* qds = sm + 2 * T::kTile;  // stage st: q at 2 st kTile, then do
  uint8_t* pds = sm + T::kPOffset;   // buffer j: p at 2 j kChunk, then ds
  float* lse_s = reinterpret_cast<float*>(sm + T::kRowsOffset);
  float* delta_s = lse_s + T::kStages * T::kBQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + T::kBarOffset);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + T::kStages;

  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * T::kBK;
  const int G = Hq / Hkv;
  const int n_q = (S + T::kBQ - 1) / T::kBQ;
  const int qt0 = causal ? k0 / T::kBQ : 0;
  const int n_steps = G * (n_q - qt0);

  if (threadIdx.x == 0) {
    hw::mbar_init(kv_full, 1);
    for (int st = 0; st < T::kStages; ++st) {
      hw::mbar_init(full + st, 32);  // every producer lane
      hw::mbar_init(empty + st, 8);  // every consumer warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  // Both roles walk the same steps, (group, q tile) in order: step i uses
  // stage i % kStages, whose round's parity flips every kStages steps; the
  // first round's empty waits pass.  Warps 0-7 are consumer warpgroups 0
  // and 1, warp 8 the producer; the index goes through a shuffle so that
  // the compiler knows it is uniform across each warp.
  const int warp =
      __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int wg = warp / 4, lane = threadIdx.x % 32;
  if (wg == 2) {
    if (lane == 0) {
      hw::prefetch_map(&tm_q);
      hw::prefetch_map(&tm_do);
      hw::mbar_expect_tx(kv_full, 2 * T::kTile);
      for (int c = 0; c < D / 64; ++c) {
        hw::tma_load_4d(ks + c * T::kChunk, &tm_k, kv_full, 64 * c, hk, k0, b);
        hw::tma_load_4d(vs + c * T::kChunk, &tm_v, kv_full, 64 * c, hk, k0, b);
      }
    }
    int i = 0;
    for (int gi = 0; gi < G; ++gi) {
      const int h = hk * G + gi;
      const size_t row0 = (static_cast<size_t>(b) * Hq + h) * S;
      for (int qt = qt0; qt < n_q; ++qt, ++i) {
        const int st = i % T::kStages, q0 = qt * T::kBQ;
        hw::mbar_wait(empty + st, ((i / T::kStages) & 1) ^ 1);
        for (int r = lane; r < T::kBQ; r += 32) {
          const int row = q0 + r;
          lse_s[st * T::kBQ + r] = row < S ? lse[row0 + row] * kLog2e : 0.f;
          delta_s[st * T::kBQ + r] = row < S ? delta[row0 + row] * scale : 0.f;
        }
        if (lane == 0) {
          uint8_t* qs = qds + 2 * st * T::kTile;
          hw::mbar_expect_tx(full + st, 2 * T::kTile);
          for (int c = 0; c < D / 64; ++c) {
            hw::tma_load_4d(qs + c * T::kChunk, &tm_q, full + st, 64 * c, h,
                            q0, b);
            hw::tma_load_4d(qs + T::kTile + c * T::kChunk, &tm_do, full + st,
                            64 * c, h, q0, b);
          }
        } else {
          hw::mbar_arrive(full + st);
        }
      }
    }
  } else {
    // Step i belongs to warpgroup i % 2, which computes s^T and dp^T for
    // the tile's 64 kv rows and the step's 64 q rows, p and ds, and writes
    // them into p/ds buffer i % kPBufs.  Both warpgroups accumulate every
    // step, in order: warpgroup 0 dv += p.do, warpgroup 1 dk += ds.q.
    const int tid = threadIdx.x % 128;
    const uint32_t k_addr = hw::smem_addr(ks), v_addr = hw::smem_addr(vs);
    float acc[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;

    // Issues step j's accumulation (not committed): A is p (warpgroup 0)
    // or ds (1), K-major; B is do (0) or q (1), MN-major; k runs over the
    // step's 64 q rows.
    auto issue_step_acc = [&](int j) {
      issue_acc<D>(acc,
                   hw::smem_addr(pds + (j % T::kPBufs) * 2 * T::kChunk +
                                 wg * T::kChunk),
                   hw::smem_addr(qds + 2 * (j % T::kStages) * T::kTile +
                                 (1 - wg) * T::kTile));
    };
    // Step j's p and ds are written: its owner arrives on named barrier
    // kReady + j % 2, the other warpgroup waits there before it
    // accumulates step j.  Each waits for the other's previous step before
    // it writes its next one, so the two alternate and every barrier phase
    // gets 128 + 128 threads.
    constexpr int kReady = 1;  // ids 1 and 2; 3 and 4 are per warpgroup
    auto wait_ready = [&](int j) {
      hw::named_barrier(kReady + j % 2, 256);
      hw::mbar_wait(full + j % T::kStages, (j / T::kStages) & 1);
    };

    // Own step i: issue s^T and dp^T, then the other warpgroup's step
    // i - 1 accumulation once its p and ds are written, wait for s^T and
    // dp^T, compute and write p and ds, then issue step i's accumulation.
    // Steps whose accumulations have completed go back to the producer
    // (one arrival per warp and step).  Buffer i % kPBufs was last read by
    // step i - kPBufs's accumulations; both have completed, since each
    // warpgroup waits for them before it writes a later step, and this
    // warpgroup has waited for the other's.
    const int n_per_group = n_q - qt0;
    hw::mbar_wait(kv_full, 0);
    for (int i = wg; i < n_steps; i += 2) {
      const int st = i % T::kStages;
      const int q0 = (qt0 + i % n_per_group) * T::kBQ;
      const uint32_t q_addr = hw::smem_addr(qds + 2 * st * T::kTile);
      const uint32_t do_addr = q_addr + T::kTile;
      hw::mbar_wait(full + st, (i / T::kStages) & 1);

      float s[32], dp[32];
      hw::wgmma_fence();
      issue_st_dpt<D>(s, dp, k_addr, v_addr, q_addr, do_addr);
      hw::wgmma_commit();
      if (i > 0) {
        wait_ready(i - 1);
        hw::wgmma_fence();
        issue_step_acc(i - 1);
        hw::wgmma_commit();
      }
      hw::wgmma_wait<0>();
      hw::fence_regs(s);
      hw::fence_regs(dp);
      if (lane == 0) {
        for (int j = max(i - 2, 0); j < i; ++j) {
          hw::mbar_arrive(empty + j % T::kStages);
        }
      }

      p_ds_store(s, dp, lse_s + st * T::kBQ, delta_s + st * T::kBQ,
                 needs_mask(causal, q0, T::kBQ, k0, T::kBK, S), causal, q0, k0,
                 S, scale, scale_log2, pds + (i % T::kPBufs) * 2 * T::kChunk,
                 warp, lane);
      hw::fence_async_shared();
      hw::named_barrier(3 + wg, 128);  // this warpgroup's writes are done
      hw::named_arrive(kReady + wg, 256);
      hw::wgmma_fence();
      issue_step_acc(i);
      hw::wgmma_commit();
    }
    if ((n_steps - 1) % 2 != wg) {  // the last step is the other's
      wait_ready(n_steps - 1);
      hw::wgmma_fence();
      issue_step_acc(n_steps - 1);
      hw::wgmma_commit();
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);

    // Epilogue: dv (warpgroup 0) through the v buffer, dk (1) through the k
    // buffer, in bf16: each warpgroup has waited for the other's last p and
    // ds, so neither reads k or v any more.  Then one TMA store per chunk.
    uint8_t* out = wg == 0 ? vs : ks;
    hw::store_acc_sw128(out, acc);
    hw::fence_async_shared();
    hw::named_barrier(3 + wg, 128);
    if (tid == 0) {
      const CUtensorMap* map = wg == 0 ? &tm_dv : &tm_dk;
      for (int c = 0; c < D / 64; ++c) {
        hw::tma_store_4d(map, out + c * T::kChunk, 64 * c, hk, k0, b);
      }
      hw::tma_store_commit();
      hw::tma_store_wait_read();
    }
  }
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int S, int Hq, int Hkv,
                    int causal, float scale, float scale_log2,
                    cudaStream_t stream) {
  using T = DkvTiles<D>;
  const int n_kv = (S + T::kBK - 1) / T::kBK;
  if (n_kv > 65535 || B > 65535) return cudaErrorInvalidValue;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(flash_bwd_dkv_wgmma<D>, T::kSmem, opted);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_do, dout, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dk, dk, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dv, dv, B, S, Hkv, D, T::kBK);
  if (err) return err;
  flash_bwd_dkv_wgmma<D><<<dim3(Hkv, n_kv, B), T::kThreads, T::kSmem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, lse, delta, S, Hq, Hkv, causal,
      scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The D = 256 kernel, flash_bwd_common.cuh's bwd_kv_wide without dq, and
// the D = 512 one, its bwd_kv_cluster (launched as clusters of two blocks).
template <int D>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_bwd_dkv_wgmma_wide(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_do,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         __grid_constant__ const CUtensorMap tm_dk,
                         __grid_constant__ const CUtensorMap tm_dv,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, int S, int Hq,
                         int Hkv, int causal, float scale, float scale_log2) {
  if constexpr (D == 512) {
    bwd_kv_cluster<false>(&tm_q, &tm_do, &tm_k, &tm_v, &tm_dk, &tm_dv,
                          nullptr, lse, delta, S, Hq, Hkv, causal, scale,
                          scale_log2);
  } else {
    bwd_kv_wide<D, false>(&tm_q, &tm_do, &tm_k, &tm_v, &tm_dk, &tm_dv,
                          nullptr, lse, delta, S, Hq, Hkv, causal, scale,
                          scale_log2);
  }
}

template <int D>
int launch_dkv_wide(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int S, int Hq, int Hkv,
                    int causal, float scale, float scale_log2,
                    cudaStream_t stream) {
  using T = KvWideTiles<D>;
  const int n_kv = (S + T::kBK - 1) / T::kBK;
  if (n_kv > 65535 || B > 65535) return cudaErrorInvalidValue;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(flash_bwd_dkv_wgmma_wide<D>, T::kSmem, opted);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_do, dout, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dk, dk, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dv, dv, B, S, Hkv, D, T::kBK);
  if (err) return err;
  flash_bwd_dkv_wgmma_wide<D>
      <<<dim3(Hkv, n_kv, B), T::kThreads, T::kSmem, stream>>>(
          tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, lse, delta, S, Hq, Hkv,
          causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The D = 512 kernel in clusters of two blocks along x (the pair of a kv
// head's 64 kv rows).  A launch the card refuses (a grid dimension out of
// range, no room for a cluster) returns the launch's own error.
int launch_dkv_cluster(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int Hq, int Hkv,
                       int causal, float scale, float scale_log2,
                       cudaStream_t stream) {
  using T = KvClusterTiles;
  constexpr int D = 512;
  static bool opted[hw::kMaxDevices];
  int err = hw::smem_opt_in(flash_bwd_dkv_wgmma_wide<D>, T::kSmem, opted);
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv;
  if (!err) err = hw::bshd_map(&tm_q, q, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_do, dout, B, S, Hq, D, T::kBQ);
  if (!err) err = hw::bshd_map(&tm_k, k, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_v, v, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dk, dk, B, S, Hkv, D, T::kBK);
  if (!err) err = hw::bshd_map(&tm_dv, dv, B, S, Hkv, D, T::kBK);
  if (err) return err;
  return launch_cluster_pair(flash_bwd_dkv_wgmma_wide<D>,
                             dim3(2 * Hkv, (S + T::kBK - 1) / T::kBK, B),
                             T::kSmem, stream, tm_q, tm_do, tm_k, tm_v, tm_dk,
                             tm_dv, lse, delta, S, Hq, Hkv, causal, scale,
                             scale_log2);
}

}  // namespace
}  // namespace tdx_bwd

// Launches the dk/dv kernel on `stream`; returns cudaGetLastError() (0 on
// success).  dtype: 0 = float32, 1 = bfloat16.  The caller checks shapes,
// contiguity and alignment; this checks only what selects a kernel.
extern "C" int tdx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int S, int Hq, int Hkv, int D, int dtype,
                                 int causal, float scale, float scale_log2,
                                 void* stream) {
  using namespace tdx_bwd;
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (dtype == 1 && D == 64) {
    return launch_dkv_bf16<64>(q, k, v, dout, lse_f, delta_f, dk, dv, B, S,
                               Hq, Hkv, causal, scale, scale_log2, st);
  }
  if (dtype == 1 && D == 128) {
    return launch_dkv_bf16<128>(q, k, v, dout, lse_f, delta_f, dk, dv, B, S,
                                Hq, Hkv, causal, scale, scale_log2, st);
  }
  if (dtype == 1 && D == 256) {
    return launch_dkv_wide<256>(q, k, v, dout, lse_f, delta_f, dk, dv, B, S,
                                Hq, Hkv, causal, scale, scale_log2, st);
  }
  if (dtype == 1 && D == 512) {
    return launch_dkv_cluster(q, k, v, dout, lse_f, delta_f, dk, dv, B, S, Hq,
                              Hkv, causal, scale, scale_log2, st);
  }
  BwdArgs args{};
  args.q = q;
  args.k = k;
  args.v = v;
  args.dout = dout;
  args.lse = lse_f;
  args.delta = delta_f;
  args.dk = dk;
  args.dv = dv;
  args.S = S;
  args.Hq = Hq;
  args.Hkv = Hkv;
  args.causal = causal;
  args.scale = scale;
  args.scale_log2 = scale_log2;
  return launch_kv<false>(args, B, D, dtype, st);
}
