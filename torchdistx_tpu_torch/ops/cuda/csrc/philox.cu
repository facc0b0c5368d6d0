// Counter-based random fills for Hopper (sm_90a): Philox4x32-10 written
// straight into any rectangular box of a tensor.
//
// Replaces no TPU kernel.  The JAX package draws its seeded initial values
// with threefry inside the one init program that XLA partitions, so every
// chip generates only its own shard (torchdistx_tpu/materialize.py,
// materialize_tensor_jax's rng_impl; models/llama.py init_sharded).  The
// port's seeded materializer (materialize.py) draws normal_, uniform_, randn
// and rand from this kernel for the same reason: an element's value is a
// function of (key, its index in the full tensor) alone, so a rank writes
// its shard in place, bit-equal to the same slice of the unsharded draw, and
// no rank ever holds the full tensor.  A plain PyTorch Philox cannot do that
// on the card within the shard's memory: its 32 x 32 -> 64-bit products need
// int64 temporaries several times the shard's size.
//
// The definition (the plain version, ops/cuda/philox.py, computes the same):
//   key     the op's 64-bit stream seed, split into (k0, k1) = (low, high)
//           words;
//   element g, its row-major index in the full tensor, takes lane g % 4 of
//           the Philox4x32-10 block at counter (g / 4, 0); a double takes
//           the same lane of the block at counter (g / 4, 1) as its second
//           word;
//   words   the raw 32-bit word (kind 0);
//   uniform u = (w >> 8) * 2^-24 in [0, 1), exact in float; a double takes
//           53 bits, ((w >> 5) << 26 | w' >> 6) * 2^-53; then lo + span * u,
//           span = hi - lo (kind 1);
//   normal  Box-Muller on the lane pairs (0, 1) and (2, 3): u1 from the even
//           lane in (0, 1] (((w >> 8) + 1) * 2^-24), u2 from the odd lane in
//           [0, 1), r = sqrt(-2 log u1), theta = 2 pi u2, the even lane
//           r cos(theta) and the odd lane r sin(theta); then mean + std * z
//           (kind 2).
// Everything is computed in float (double for a double tensor) and rounded
// once to the stored type.  Every product and sum is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, and the double forms), so nvcc cannot
// contract them into FMAs, and log, sqrt, cos and sin are CUDA's precise
// functions, which PyTorch's CUDA ops call too: the plain version run on
// the card gives the same bits.  The cosine and sine of a pair come from
// one sincosf (sincos for a double): one range reduction, the same bits as
// cosf and sinf (tests/test_torch_cuda.py checks all 2^24 float angles and
// radii against torch.cos / sin / log / sqrt on the card).
//
// Bound: the larger of the bytes it writes against 3.35 TB/s (it reads
// nothing) and Philox's 40 32-bit multiplies a block (two blocks a double)
// against 64 a clock on each SM; for bf16 the two coincide.  What sets its
// pace is the instructions it issues an element: ten rounds a block, and for
// the normal CUDA's precise log, sqrt and sincos a pair.  So the design
// spends no instruction it can avoid:
//   - a persistent grid (the SMs times the blocks the occupancy API fits on
//     one) walks the box's units with a grid-stride loop: a unit is 8
//     consecutive elements of the full tensor starting at a multiple of 8
//     (two Philox blocks; four for a double), and each row of the box
//     (its innermost dim) has the same number of units, so no lane idles
//     but at a row's ragged ends;
//   - each thread carries its (row, unit) forward by the grid's stride, so
//     the loop divides nothing; a row's start in the full tensor is one
//     multiply for a box of up to two dims (after the wrapper merges whole
//     dims) and 32-bit multiplicative divisions for more;
//   - the two blocks of a unit run their rounds side by side (independent
//     chains for the schedulers);
//   - a tiled box (every row starts at a unit's first element and spans
//     whole units, out 16-byte aligned: every parameter and shard of the
//     models here) takes a flat loop: its unit q is out's elements
//     [8 q, 8 q + 8), written with 16-byte stores, a warp's 32 units
//     through shared memory where a unit is wider than 16 bytes (f32, f64,
//     the words), so that every store of the warp writes 512 consecutive
//     bytes;
//   - any other box takes the general loop: a unit that lies wholly in its
//     row at a 16-byte-aligned address is written with 16-byte stores (one
//     for bf16 and f16, two for f32 and the words, four for f64); a row's
//     ragged head and tail, and rows narrower than a unit, store lane by
//     lane.
// Its times beside the bound, the parent design's and Tensor.normal_'s are
// in PERF.md.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tdx_philox {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;
constexpr int kUnit = 8;  // elements a thread computes a step: two Philox blocks
constexpr int kMaxDevices = 64;

// The launch plan (ops/cuda/philox.py's launch_plan mirrors it).
struct Box {
  int ndim;                     // 1..kMaxDims
  int fast;                     // row_start may divide in 32 bits
  int tiled;                    // every row a whole number of units from a unit's start
  long long rows;               // product of size[0 .. ndim - 2]
  long long len;                // size[ndim - 1]
  long long units;              // units a row: the most any row spans
  long long step_rows;          // the grid's stride in whole rows ...
  long long step_units;         // ... and units
  long long size[kMaxDims];     // the box's extent in each dim
  long long offset[kMaxDims];   // where it starts in the full tensor
  long long stride[kMaxDims];   // the full tensor's row-major strides
  uint32_t div_mul[kMaxDims];   // size[d]'s multiplicative inverse ...
  uint32_t div_shr[kMaxDims];   // ... and shift (div_mul 0: size 1)
};

// Two Philox4x32-10 blocks under one key, their rounds side by side.
__device__ __forceinline__ void philox2(uint32_t a[4], uint32_t b[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t ahi0 = __umulhi(0xD2511F53u, a[0]), alo0 = 0xD2511F53u * a[0];
    const uint32_t ahi1 = __umulhi(0xCD9E8D57u, a[2]), alo1 = 0xCD9E8D57u * a[2];
    const uint32_t bhi0 = __umulhi(0xD2511F53u, b[0]), blo0 = 0xD2511F53u * b[0];
    const uint32_t bhi1 = __umulhi(0xCD9E8D57u, b[2]), blo1 = 0xCD9E8D57u * b[2];
    a[0] = ahi1 ^ a[1] ^ k0;
    a[1] = alo1;
    a[2] = ahi0 ^ a[3] ^ k1;
    a[3] = alo0;
    b[0] = bhi1 ^ b[1] ^ k0;
    b[1] = blo1;
    b[2] = bhi0 ^ b[3] ^ k1;
    b[3] = blo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// The words of the blocks at counters (c, hi) and (c + 1, hi), lanes in
// order: w[0..3] the first block's, w[4..7] the second's.
__device__ __forceinline__ void unit_words(unsigned long long c, uint32_t hi, uint32_t k0,
                                           uint32_t k1, uint32_t w[8]) {
  const unsigned long long c1 = c + 1;
  w[0] = static_cast<uint32_t>(c);
  w[1] = static_cast<uint32_t>(c >> 32);
  w[2] = hi;
  w[3] = 0u;
  w[4] = static_cast<uint32_t>(c1);
  w[5] = static_cast<uint32_t>(c1 >> 32);
  w[6] = hi;
  w[7] = 0u;
  philox2(w, w + 4, k0, k1);
}

// Uniform variates of one word (float) or two (double).
__device__ __forceinline__ float unit_open_hi(uint32_t w) {  // [0, 1)
  return __fmul_rn(__uint2float_rn(w >> 8), 5.9604644775390625e-08f);
}
__device__ __forceinline__ float unit_open_lo(uint32_t w) {  // (0, 1]
  return __fmul_rn(__uint2float_rn((w >> 8) + 1u), 5.9604644775390625e-08f);
}
__device__ __forceinline__ unsigned long long bits53(uint32_t a, uint32_t b) {
  return (static_cast<unsigned long long>(a >> 5) << 26) | (b >> 6);
}
__device__ __forceinline__ double unit_open_hi2(uint32_t a, uint32_t b) {
  return __dmul_rn(__ull2double_rn(bits53(a, b)), 1.1102230246251565e-16);
}
__device__ __forceinline__ double unit_open_lo2(uint32_t a, uint32_t b) {
  return __dmul_rn(__ull2double_rn(bits53(a, b) + 1ull), 1.1102230246251565e-16);
}
__device__ __forceinline__ float unit_hi(uint32_t a, uint32_t, float) { return unit_open_hi(a); }
__device__ __forceinline__ float unit_lo(uint32_t a, uint32_t, float) { return unit_open_lo(a); }
__device__ __forceinline__ double unit_hi(uint32_t a, uint32_t b, double) {
  return unit_open_hi2(a, b);
}
__device__ __forceinline__ double unit_lo(uint32_t a, uint32_t b, double) {
  return unit_open_lo2(a, b);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Box-Muller's two halves, CUDA's precise functions (no fast-math), as
// PyTorch's CUDA ops call them: the radius sqrt(-2 log u1), and the cosine
// and sine of 2 pi u2 from one range reduction.
__device__ __forceinline__ float radius(float u1) {
  return sqrtf(__fmul_rn(-2.0f, logf(u1)));
}
__device__ __forceinline__ double radius(double u1) {
  return ::sqrt(__dmul_rn(-2.0, ::log(u1)));
}
__device__ __forceinline__ void angle(float u2, float* c, float* s) {
  sincosf(__fmul_rn(u2, 6.2831855f), s, c);
}
__device__ __forceinline__ void angle(double u2, double* c, double* s) {
  sincos(__dmul_rn(u2, 6.283185307179586), s, c);
}

template <typename T> struct Compute { using type = float; };
template <> struct Compute<double> { using type = double; };

// A value rounded once to the stored type (the second argument picks it).
__device__ __forceinline__ float store_as(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 store_as(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __half store_as(float x, __half) { return __float2half_rn(x); }
__device__ __forceinline__ double store_as(double x, double) { return x; }
__device__ __forceinline__ uint32_t store_as(uint32_t x, uint32_t) { return x; }

enum Kind { kWords = 0, kUniform = 1, kNormal = 2 };

// The row's first element in the full tensor.
__device__ __forceinline__ long long row_start(const Box& box, long long row) {
  const int nd = box.ndim;
  if (nd == 1) return box.offset[0];
  if (nd == 2) return box.offset[1] + (box.offset[0] + row) * box.stride[0];
  long long g0 = box.offset[nd - 1];
  if (box.fast) {  // rows < 2^31 and every size < 2^31
    uint32_t rest = static_cast<uint32_t>(row);
    for (int d = nd - 2; d >= 1; --d) {
      const uint32_t q = box.div_mul[d] ? __umulhi(rest, box.div_mul[d]) >> box.div_shr[d]
                                        : rest;
      const uint32_t idx = rest - q * static_cast<uint32_t>(box.size[d]);
      g0 += (box.offset[d] + idx) * box.stride[d];
      rest = q;
    }
    return g0 + (box.offset[0] + rest) * box.stride[0];
  }
  long long rest = row;
  for (int d = nd - 2; d >= 0; --d) {
    const long long idx = rest % box.size[d];
    rest /= box.size[d];
    g0 += (box.offset[d] + idx) * box.stride[d];
  }
  return g0;
}

// A value before its rounding to T: the compute type, or the raw word.
template <typename T, int K>
using Value = typename std::conditional<K == kWords, uint32_t, typename Compute<T>::type>::type;

// The 8 values of the unit at counters (c, c + 1).
template <typename T, int K>
__device__ __forceinline__ void unit_values(unsigned long long c, uint32_t k0, uint32_t k1,
                                            typename Compute<T>::type fa,
                                            typename Compute<T>::type fb,
                                            Value<T, K> v[kUnit]) {
  using F = typename Compute<T>::type;
  constexpr bool kWide = sizeof(F) == 8;
  uint32_t w[kUnit], w2[kUnit];
  unit_words(c, 0u, k0, k1, w);
  if constexpr (K == kWords) {
#pragma unroll
    for (int l = 0; l < kUnit; ++l) v[l] = w[l];
    return;
  } else {
    if constexpr (kWide) unit_words(c, 1u, k0, k1, w2);
    else {
#pragma unroll
      for (int l = 0; l < kUnit; ++l) w2[l] = 0u;
    }
    if constexpr (K == kUniform) {
#pragma unroll
      for (int l = 0; l < kUnit; ++l) v[l] = add_rn(fa, mul_rn(fb, unit_hi(w[l], w2[l], F{})));
    } else {
#pragma unroll
      for (int p = 0; p < kUnit / 2; ++p) {
        const F r = radius(unit_lo(w[2 * p], w2[2 * p], F{}));
        F cs, sn;
        angle(unit_hi(w[2 * p + 1], w2[2 * p + 1], F{}), &cs, &sn);
        v[2 * p] = add_rn(fa, mul_rn(fb, mul_rn(r, cs)));
        v[2 * p + 1] = add_rn(fa, mul_rn(fb, mul_rn(r, sn)));
      }
    }
  }
}

// Chunk s (16 bytes) of the unit's values rounded to T.
template <typename T, typename V>
__device__ __forceinline__ uint4 chunk(const V v[kUnit], int s) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte store
  alignas(16) T pack[kPer];
#pragma unroll
  for (int l = 0; l < kPer; ++l) pack[l] = store_as(v[s * kPer + l], T{});
  return *reinterpret_cast<const uint4*>(pack);
}

// The unit's values rounded to T and written by 16-byte stores at p
// (16-byte aligned, all kUnit elements inside the row).
template <typename T, typename V>
__device__ __forceinline__ void store_unit(T* p, const V v[kUnit]) {
#pragma unroll
  for (int s = 0; s < kUnit * static_cast<int>(sizeof(T)) / 16; ++s) {
    reinterpret_cast<uint4*>(p)[s] = chunk<T>(v, s);
  }
}

// Where a warp's chunk g of its 32 units' values sits in shared memory:
// lane l writes its chunks l kChunks .. l kChunks + kChunks - 1 and reads
// chunks l, 32 + l, ...; the swizzle puts each quarter-warp's 16-byte
// accesses on eight distinct bank groups both times (kChunks 2 or 4).
template <int kChunks>
__device__ __forceinline__ int staged(int g) {
  return g ^ ((g >> 3) & (kChunks - 1));
}

// out: the box, contiguous, box.rows x box.len.  (a, b): (lo, span) for the
// uniform, (mean, std) for the normal.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
philox_fill(T* __restrict__ out, Box box, uint32_t k0, uint32_t k1, double a, double b) {
  using F = typename Compute<T>::type;
  const F fa = static_cast<F>(a), fb = static_cast<F>(b);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long row = i / box.units, u = i % box.units;  // once; then carried
  if (box.tiled) {
    // Every row starts at a unit's first element and spans whole units, so
    // the box's unit q (row-major) is out's elements q kUnit .. q kUnit +
    // kUnit - 1, and a warp's 32 units are 32 kUnit consecutive elements.
    // A unit wider than 16 bytes (4- and 8-byte types) goes through shared
    // memory, so that each 16-byte store of the warp writes 512 consecutive
    // bytes, not every other 16 bytes of 1024 or 2048.
    constexpr int kChunks = kUnit * static_cast<int>(sizeof(T)) / 16;
    const int lane = static_cast<int>(threadIdx.x) & 31;
    const long long total = box.rows * box.units;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long q = i; q - lane < total; q += stride) {  // the same trips in a warp
      const bool live = q < total;
      Value<T, K> v[kUnit];
      if (live) {
        const long long e0 = row_start(box, row) + u * kUnit;
        unit_values<T, K>(static_cast<unsigned long long>(e0 >> 2), k0, k1, fa, fb, v);
      }
      if constexpr (kChunks > 1) {
        __shared__ uint4 stage[kThreads / 32][32 * kChunks];
        uint4* mine = stage[threadIdx.x >> 5];
        if (q - lane + 32 <= total) {  // the whole warp live
#pragma unroll
          for (int s = 0; s < kChunks; ++s) {
            mine[staged<kChunks>(lane * kChunks + s)] = chunk<T>(v, s);
          }
          __syncwarp();
          uint4* dst = reinterpret_cast<uint4*>(out + (q - lane) * kUnit);
#pragma unroll
          for (int s = 0; s < kChunks; ++s) {
            dst[s * 32 + lane] = mine[staged<kChunks>(s * 32 + lane)];
          }
          __syncwarp();
        } else if (live) {
          store_unit(out + q * kUnit, v);
        }
      } else if (live) {
        store_unit(out + q * kUnit, v);
      }
      u += box.step_units;
      row += box.step_rows;
      if (u >= box.units) {
        u -= box.units;
        ++row;
      }
    }
    return;
  }
  for (; row < box.rows; row += box.step_rows) {
    const long long g0 = row_start(box, row);
    const long long g1 = g0 + box.len;
    const long long e0 = ((g0 >> 3) + u) * kUnit;  // the unit's first element
    if (e0 < g1) {
      Value<T, K> v[kUnit];
      unit_values<T, K>(static_cast<unsigned long long>(e0 >> 2), k0, k1, fa, fb, v);
      T* p = out + (row * box.len + (e0 - g0));  // element e0's place
      if (e0 >= g0 && e0 + kUnit <= g1 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        store_unit(p, v);
      } else {
#pragma unroll
        for (int l = 0; l < kUnit; ++l) {
          if (e0 + l >= g0 && e0 + l < g1) p[l] = store_as(v[l], T{});
        }
      }
    }
    u += box.step_units;
    if (u >= box.units) {
      u -= box.units;
      ++row;
    }
  }
}

// CUTLASS's FastDivmod: n / d == umulhi(n, mul) >> shr for 0 <= n < 2^31.
void find_divisor(long long d, uint32_t* mul, uint32_t* shr) {
  if (d == 1) {
    *mul = 0u;
    *shr = 0u;
    return;
  }
  int log2 = 0;
  while ((1LL << log2) < d) ++log2;  // ceil(log2(d))
  const int p = 31 + log2;
  *mul = static_cast<uint32_t>(((1ULL << p) + static_cast<unsigned long long>(d) - 1) /
                               static_cast<unsigned long long>(d));
  *shr = static_cast<uint32_t>(p - 32);
}

template <typename T, int K>
int launch(void* out, Box& box, uint32_t k0, uint32_t k1, double a, double b,
           cudaStream_t stream) {
  static int resident[kMaxDevices];  // blocks an SM, by device (0: not read yet)
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int n = 0, m = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, philox_fill<T, K>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = m;
    resident[dev] = n > 0 ? n : 1;
  }
  const long long total = box.rows * box.units;
  const long long want = (total + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms[dev]) * resident[dev];
  const long long grid = want < most ? want : most;
  const long long stride = grid * kThreads;
  box.step_rows = stride / box.units;
  box.step_units = stride % box.units;
  philox_fill<T, K><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<T*>(out), box, k0, k1, a, b);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(void* out, int dtype, Box& box, uint32_t k0, uint32_t k1, double a, double b,
             cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<float, K>(out, box, k0, k1, a, b, stream);
    case 1: return launch<__nv_bfloat16, K>(out, box, k0, k1, a, b, stream);
    case 2: return launch<__half, K>(out, box, k0, k1, a, b, stream);
    case 3: return launch<double, K>(out, box, k0, k1, a, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

// A test entry: Box-Muller's halves on n given words (exhaustive over the
// float path's 2^24 u1 and u2, sampled for the double's 53 bits).
template <typename F>
__global__ void box_muller_parts(long long n, const uint32_t* __restrict__ wa,
                                 const uint32_t* __restrict__ wb, F* __restrict__ r,
                                 F* __restrict__ c, F* __restrict__ s) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const uint32_t x = wa[i], y = wb ? wb[i] : 0u;
    r[i] = radius(unit_lo(x, y, F{}));
    angle(unit_hi(x, y, F{}), c + i, s + i);
  }
}

}  // namespace tdx_philox

// Fill ``out`` (contiguous, the box's size) with the box of the full
// tensor of ``full_shape`` (row-major) that starts at ``offset`` and has
// ``size``.  dtype: 0 float, 1 bfloat16, 2 half, 3 double (kind 1 and 2),
// 4 int32 (kind 0, the raw words).  kind: 0 words, 1 uniform (a = lo,
// b = hi - lo), 2 normal (a = mean, b = std).  Returns a cudaError_t.
extern "C" int tdx_philox_fill(void* out, int dtype, int kind, int ndim,
                               const long long* full_shape, const long long* offset,
                               const long long* size, unsigned long long key, double a,
                               double b, void* stream) {
  using namespace tdx_philox;
  if (ndim < 1 || ndim > kMaxDims) return cudaErrorInvalidValue;
  Box box{};
  box.ndim = ndim;
  long long stride = 1;
  for (int d = ndim - 1; d >= 0; --d) {
    if (size[d] < 0 || offset[d] < 0 || offset[d] + size[d] > full_shape[d])
      return cudaErrorInvalidValue;
    box.size[d] = size[d];
    box.offset[d] = offset[d];
    box.stride[d] = stride;
    stride *= full_shape[d];
  }
  box.len = size[ndim - 1];
  box.rows = 1;
  for (int d = 0; d < ndim - 1; ++d) box.rows *= size[d];
  if (box.len == 0 || box.rows == 0) return 0;
  // Every row's start is offset[-1] modulo kUnit where the row stride is a
  // multiple of kUnit: then every row spans the same number of units; else
  // as many as the worst start (kUnit - 1) needs.
  const bool same_phase = ndim == 1 || full_shape[ndim - 1] % kUnit == 0;
  const long long phase = same_phase ? offset[ndim - 1] % kUnit : kUnit - 1;
  box.units = (phase + box.len - 1) / kUnit + 1;
  box.tiled = phase == 0 && box.len % kUnit == 0 &&
              (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  box.fast = box.rows < (1LL << 31);
  for (int d = 0; d < ndim; ++d) {
    box.fast = box.fast && size[d] < (1LL << 31);
    if (size[d] < (1LL << 31)) find_divisor(size[d], &box.div_mul[d], &box.div_shr[d]);
  }
  const uint32_t k0 = static_cast<uint32_t>(key), k1 = static_cast<uint32_t>(key >> 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kWords) {
    if (dtype != 4) return cudaErrorInvalidValue;
    return launch<uint32_t, kWords>(out, box, k0, k1, a, b, st);
  }
  if (kind == kUniform) return dispatch<kUniform>(out, dtype, box, k0, k1, a, b, st);
  if (kind == kNormal) return dispatch<kNormal>(out, dtype, box, k0, k1, a, b, st);
  return cudaErrorInvalidValue;
}

// For the card's tests only: Box-Muller's radius of u1 (words read as the
// even lane) and the cosine and sine of 2 pi u2 (the same words read as the
// odd lane), by the kernel's own device functions.  wide 0: float, one word
// an element (wb unused); 1: double, words wa[i] and wb[i].
extern "C" int tdx_philox_box_muller(int wide, long long n, const void* wa, const void* wb,
                                     void* r, void* c, void* s, void* stream) {
  using namespace tdx_philox;
  if (n <= 0) return 0;
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(want < 4096 ? want : 4096);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(wa);
  if (wide) {
    box_muller_parts<double><<<grid, kThreads, 0, st>>>(
        n, a, static_cast<const uint32_t*>(wb), static_cast<double*>(r),
        static_cast<double*>(c), static_cast<double*>(s));
  } else {
    box_muller_parts<float><<<grid, kThreads, 0, st>>>(
        n, a, nullptr, static_cast<float*>(r), static_cast<float*>(c), static_cast<float*>(s));
  }
  return static_cast<int>(cudaGetLastError());
}
