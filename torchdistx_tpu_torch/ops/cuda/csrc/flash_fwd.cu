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
// need no transpose.  Any S: the ragged edge is masked here, with no
// padding copies.  One block per (q tile, head, batch); blockIdx.x runs
// over q tiles so that neighbouring blocks share a kv head, heaviest causal
// tiles first.  The TPU grid's sequential kv axis becomes a loop over kv
// tiles, bounded at the causal diagonal (the Pallas kernel's _diag_clamp is
// DMA elision and reduces to that bound).
//
// bf16: 4 warps, 64 q rows (16 per warp), kv tiles of 64 staged in shared
// memory (32 KB at D = 128), both products on the tensor cores with
// mma.sync.m16n8k16 and f32 accumulation; the S tile's accumulator
// fragments are reused as the A fragments of P.V.  f32: CUDA cores, 16 q
// rows per block, kv tiles of 32, one warp lane per kv column for q.k and
// per output column for P.V.
//
// What bounds it on an H100 SXM: at the Llama-7B shape (B 4, S 512, 32
// heads, D 128, bf16, causal) q, k, v and out are 16.8 MB each, 67 MB in
// all, 20 us at 3.35 TB/s, against 4 B H D S(S+1)/2 = 8.6 GFLOP, 8.7 us at
// the 989 TFLOP/s dense bf16 tensor rate: bound by bytes at this length
// (by operations from S of about 1200 up, or with GQA).  What this
// simple design leaves on the table: mma.sync instead of wgmma (which alone
// reaches the full tensor rate), synchronous K/V staging with no
// cp.async/TMA double-buffering, V's B fragments gathered as single 16-bit
// loads (ldmatrix.trans would do it in one instruction), the mask computed
// on every tile instead of on diagonal and ragged tiles only, and no
// persistent scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b for a 16x16 (row) by 16x8 (col) bf16 tile, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
               int Hq, int Hkv, float scale_log2, int causal) {
  constexpr int BQ = 64, BK = 64, LD = D + 8;  // LD: padded smem row
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column
  const int row0 = q_tile * BQ + warp * 16 + g;  // this thread's rows:
  const int row1 = row0 + 8;                     // row0 and row0 + 8
  const size_t q_rs = static_cast<size_t>(Hq) * D;
  const size_t kv_rs = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * S * q_rs + h * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * S * kv_rs + hk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * S * kv_rs + hk * D;

  // q rows stay in registers as A fragments for the whole kv loop.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = row0 < S ? ld32(qb + row0 * q_rs + c) : 0u;
    qf[kk][1] = row1 < S ? ld32(qb + row1 * q_rs + c) : 0u;
    qf[kk][2] = row0 < S ? ld32(qb + row0 * q_rs + c + 8) : 0u;
    qf[kk][3] = row1 < S ? ld32(qb + row1 * q_rs + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};

  const int last_row = min(q_tile * BQ + BQ, S) - 1;
  const int n_tiles = causal ? last_row / BK + 1 : (S + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
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
    __syncthreads();

    // s = q . k^T: BK / 8 accumulator tiles of 16 x 8.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[j], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
    }

    // Scale into the log2 domain; mask the ragged edge and the causal
    // triangle.
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool keep = col < S && (!causal || col <= row);
        s[j][e] = keep ? s[j][e] * scale_log2 : kMask;
      }
    }

    // Online softmax; the four lanes of a quad share a row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_next);
          sum += s[j][e];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha + sum;
      m[r] = m_next;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // acc += p . v, with p cast to bf16: the s accumulator tiles 2kk and
    // 2kk + 1 are exactly the A fragment of the kk-th 16-wide slice.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vp = v0 + n * 8;
        mma_bf16(acc[n], a, pack_bf16(vp[0], vp[LD]),
                 pack_bf16(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= S) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow =
        o + (static_cast<size_t>(b) * S + row) * q_rs + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * r] / l_safe, acc[n][2 * r + 1] / l_safe);
    }
    if (t == 0) {
      lse[(static_cast<size_t>(b) * Hq + h) * S + row] =
          m[r] / kLog2e + logf(l_safe);
    }
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
    launch(flash_fwd_bf16<64>, 64, q, k, v, o, lse, B, S,
                              Hq, Hkv, scale_log2, causal, st);
  } else if (dtype == 1 && D == 128) {
    launch(flash_fwd_bf16<128>, 64, q, k, v, o, lse, B, S,
                               Hq, Hkv, scale_log2, causal, st);
  } else if (dtype == 0 && D == 64) {
    launch(flash_fwd_f32<64>, 16, q, k, v, o, lse, B, S, Hq, Hkv,
                      scale_log2, causal, st);
  } else if (dtype == 0 && D == 128) {
    launch(flash_fwd_f32<128>, 16, q, k, v, o, lse, B, S, Hq, Hkv,
                       scale_log2, causal, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
