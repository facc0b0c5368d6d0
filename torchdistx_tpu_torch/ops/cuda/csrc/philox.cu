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
// the card gives the same bits.
//
// Bound: the bytes it writes, against 3.35 TB/s; it reads nothing (there is
// no operation count at a peak rate to set against them: its work is 32-bit
// integer multiplies and libm calls, not tensor-core products).  One thread
// computes one Philox block (two for a double) and writes the up to four
// elements of the box that fall in it; a box row (the innermost dim) runs
// along blockIdx.x, the rows along blockIdx.y.  Ten rounds of two 32-bit
// multiply pairs, and for the normal one log, one sqrt, one cos and one sin a
// pair, may keep it from that bound; its time beside the bound is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdx_philox {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

struct Box {
  int ndim;                     // 1..kMaxDims
  long long rows;               // product of size[0 .. ndim - 2]
  long long len;                // size[ndim - 1]
  long long size[kMaxDims];     // the box's extent in each dim
  long long offset[kMaxDims];   // where it starts in the full tensor
  long long stride[kMaxDims];   // the full tensor's row-major strides
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

__device__ __forceinline__ void block_words(unsigned long long ctr, uint32_t hi, uint32_t k0,
                                            uint32_t k1, uint32_t w[4]) {
  w[0] = static_cast<uint32_t>(ctr);
  w[1] = static_cast<uint32_t>(ctr >> 32);
  w[2] = hi;
  w[3] = 0u;
  philox4x32_10(w, k0, k1);
}

// Uniform variates of one word (float) or two (double).
__device__ __forceinline__ float unit_open_hi(uint32_t w, float) {  // [0, 1)
  return __fmul_rn(__uint2float_rn(w >> 8), 5.9604644775390625e-08f);
}
__device__ __forceinline__ float unit_open_lo(uint32_t w, float) {  // (0, 1]
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

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// CUDA's precise functions (no fast-math), as PyTorch's CUDA ops call them.
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return ::log(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return ::sqrt(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return ::cos(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return ::sin(x); }

template <typename T> struct Compute { using type = float; };
template <> struct Compute<double> { using type = double; };

template <typename T> __device__ __forceinline__ T store_as(float x);
template <> __device__ __forceinline__ float store_as<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half store_as<__half>(float x) {
  return __float2half_rn(x);
}

enum Kind { kWords = 0, kUniform = 1, kNormal = 2 };

// out: the box, contiguous, box.rows x box.len.  (a, b): (lo, span) for the
// uniform, (mean, std) for the normal.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
philox_fill(T* __restrict__ out, Box box, uint32_t k0, uint32_t k1, double a, double b) {
  using F = typename Compute<T>::type;
  constexpr bool kWide = sizeof(F) == 8;
  const F fa = static_cast<F>(a), fb = static_cast<F>(b);
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long row = blockIdx.y; row < box.rows; row += gridDim.y) {
    // The row's first element in the full tensor.
    long long rest = row, g0 = box.offset[box.ndim - 1];
    for (int d = box.ndim - 2; d >= 0; --d) {
      const long long idx = rest % box.size[d];
      rest /= box.size[d];
      g0 += (box.offset[d] + idx) * box.stride[d];
    }
    const long long first = g0 >> 2;
    const long long n_blocks = ((g0 + box.len - 1) >> 2) - first + 1;
    if (j >= n_blocks) continue;
    const unsigned long long ctr = static_cast<unsigned long long>(first + j);
    uint32_t w[4], w2[4];
    block_words(ctr, 0u, k0, k1, w);
    if (kWide && K != kWords) block_words(ctr, 1u, k0, k1, w2);
    F v[4] = {};
    if constexpr (K == kUniform) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        F u;
        if constexpr (kWide) u = unit_open_hi2(w[l], w2[l]);
        else u = unit_open_hi(w[l], F{});
        v[l] = add_rn(fa, mul_rn(fb, u));
      }
    } else if constexpr (K == kNormal) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        F u1, u2;
        if constexpr (kWide) {
          u1 = unit_open_lo2(w[2 * p], w2[2 * p]);
          u2 = unit_open_hi2(w[2 * p + 1], w2[2 * p + 1]);
        } else {
          u1 = unit_open_lo(w[2 * p], F{});
          u2 = unit_open_hi(w[2 * p + 1], F{});
        }
        const F r = sqrt_(mul_rn(static_cast<F>(-2), log_(u1)));
        const F theta = mul_rn(u2, kWide ? static_cast<F>(6.283185307179586)
                                         : static_cast<F>(6.2831855f));
        v[2 * p] = add_rn(fa, mul_rn(fb, mul_rn(r, cos_(theta))));
        v[2 * p + 1] = add_rn(fa, mul_rn(fb, mul_rn(r, sin_(theta))));
      }
    }
    const long long base = row * box.len - g0;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const long long g = 4 * static_cast<long long>(ctr) + l;
      if (g < g0 || g >= g0 + box.len) continue;
      if constexpr (K == kWords) {
        out[base + g] = static_cast<T>(w[l]);
      } else if constexpr (kWide) {
        out[base + g] = v[l];
      } else {
        out[base + g] = store_as<T>(v[l]);
      }
    }
  }
}

template <typename T, int K>
int launch(void* out, const Box& box, uint32_t k0, uint32_t k1, double a, double b,
           cudaStream_t stream) {
  const long long max_blocks = (box.len + 3) / 4 + 1;
  const long long gx = (max_blocks + kThreads - 1) / kThreads;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx),
                  static_cast<unsigned>(box.rows < kMaxGridY ? box.rows : kMaxGridY));
  philox_fill<T, K><<<grid, kThreads, 0, stream>>>(static_cast<T*>(out), box, k0, k1, a, b);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(void* out, int dtype, const Box& box, uint32_t k0, uint32_t k1, double a,
             double b, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<float, K>(out, box, k0, k1, a, b, stream);
    case 1: return launch<__nv_bfloat16, K>(out, box, k0, k1, a, b, stream);
    case 2: return launch<__half, K>(out, box, k0, k1, a, b, stream);
    case 3: return launch<double, K>(out, box, k0, k1, a, b, stream);
    default: return cudaErrorInvalidValue;
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
