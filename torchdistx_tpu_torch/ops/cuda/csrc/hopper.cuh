// Hopper (sm_90a) plumbing shared by the port's kernels: TMA tensor maps
// over the model's (B, S, H, D) bf16 tensors, mbarriers, named barriers, and
// wgmma shared-memory descriptors and instructions.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle and read
// by wgmma through descriptors of the same swizzle.  A tile is a stack of
// "chunks": 64 bf16 columns (128 bytes) of each of `rows` rows, row r at
// byte r * 128, its 16-byte groups permuted by XOR with r % 8.  A head of
// D columns arrives as D / 64 chunks (TMA's box is at most 128 bytes wide
// under this swizzle).  Every chunk starts on a 1024-byte boundary (one
// swizzle atom of 8 rows), which the descriptors' base offset of 0 assumes.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdx {
namespace hopper {

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; it is looked up through the
// runtime once, so the libraries need not link libcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a contiguous (B, S, H, D) bf16 tensor at `base`, as the
// 4-d tensor (D, H, S, B) (innermost first), loaded or stored in boxes of
// 64 columns x `rows` sequence positions of one head.  Positions >= S read
// as zeros and are not written.  Returns a cudaError_t (0 on success).
inline int bshd_map(CUtensorMap* map, const void* base, int B, int S, int H,
                    int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = static_cast<cuuint64_t>(H) * D * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row,
                                 row * static_cast<cuuint64_t>(S)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

// Opts `kernel` in to `bytes` of dynamic shared memory (above 48 KB only
// after this), once per device; `done` is the caller's record of the
// devices done, one per kernel.  Returns a cudaError_t (0 on success).
template <typename Kernel>
inline int smem_opt_in(Kernel kernel, int bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  int err = cudaGetDevice(&device);
  if (err) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    done[device] = true;
  }
  return 0;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to TMA before any use.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A
// wait that has not completed after about 2^34 cycles (some 10 s) traps, so
// a protocol fault fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > (1ll << 34)) {
      __trap();
    }
  }
}

// ---- TMA

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Global -> shared, one box at coordinates (c0, c1, c2, c3) of a 4-d map;
// completes `bar`'s transaction count with the box's bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared -> global, one box; out-of-bounds rows are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Orders this thread's shared-memory writes before later TMA (async proxy)
// reads of them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Commits the TMA stores issued since the last commit as one group.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until every committed store group has read its shared-memory
// source, so the block may reuse it or exit.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- named barriers

// Barrier among `threads` threads (a multiple of 32) under id 1..15; id 0
// is __syncthreads().
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrives on named barrier `id` without waiting for it.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma

// Descriptor of a 128-byte-swizzled operand at shared address `addr`.
// K-major (rows of the K extent, as TMA lays out q and k): `lbo` unused
// (16), `sbo` = 1024, the stride of 8-row groups; a step of 16 along K
// within a chunk adds 32 bytes to `addr`.  MN-major (v as the B operand of
// p.v, the MN extent along the rows' columns): `lbo` = the stride between
// 64-column chunks, `sbo` = 1024, the stride of 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;  // layout: 128-byte swizzle
}

// Before the first wgmma that reads registers written by other
// instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Pins an accumulator's registers after wgmma_wait: the compiler sees the
// wgmma as done when it is issued and could otherwise read them earlier.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The accumulator of m64nNk16 (f32, N / 2 registers per thread): warp w of
// the warpgroup holds rows 16w + lane / 4 (registers 4j, 4j + 1) and that
// row + 8 (4j + 2, 4j + 3), columns 8j + 2 (lane % 4) + {0, 1}.  The A
// fragment of a register-sourced m64k16 bf16 product has the same shape:
// {rows r, r + 8} x columns 2 (lane % 4) + {0, 1} and 8 + the same, so the
// accumulator's columns 16k .. 16k + 15 packed pairwise into bf16x2 are
// the A fragment of the k-th step of a following product.

#define TDX_ACC8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a . b^T for a 64 x 16 A and a 128 x 16 B, both K-major in shared
// memory; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TDX_ACC8(d, 0), TDX_ACC8(d, 8), TDX_ACC8(d, 16), TDX_ACC8(d, 24),
        TDX_ACC8(d, 32), TDX_ACC8(d, 40), TDX_ACC8(d, 48), TDX_ACC8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same for a 64 x 16 B (m64n64k16).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TDX_ACC8(d, 0), TDX_ACC8(d, 8), TDX_ACC8(d, 16), TDX_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

#define TDX_OUT8(d, i)                                                  \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),           \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])

// d = a . b^T for a 64 x 16 A and a 64 x 16 B, both K-major in shared
// memory (m64n64k16): d is only written, so it needs no value before, and
// ptxas sees each such d as a new definition by the wgmma.
__device__ __forceinline__ void wgmma_ss_init(float (&d)[32], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TDX_OUT8(d, 0), TDX_OUT8(d, 8), TDX_OUT8(d, 16), TDX_OUT8(d, 24)
      : "l"(a), "l"(b), "r"(0));
}

#undef TDX_OUT8

// d += a . b for a 64 x 16 A, K-major, and a 16 x 128 B, MN-major, both in
// shared memory.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63}"
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : TDX_ACC8(d, 0), TDX_ACC8(d, 8), TDX_ACC8(d, 16), TDX_ACC8(d, 24),
        TDX_ACC8(d, 32), TDX_ACC8(d, 40), TDX_ACC8(d, 48), TDX_ACC8(d, 56)
      : "l"(a), "l"(b), "r"(1));
}

// The same for a 16 x 64 B.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : TDX_ACC8(d, 0), TDX_ACC8(d, 8), TDX_ACC8(d, 16), TDX_ACC8(d, 24)
      : "l"(a), "l"(b), "r"(1));
}

// d += a . b for a 64 x 16 A in registers and a 16 x 128 B, MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TDX_ACC8(d, 0), TDX_ACC8(d, 8), TDX_ACC8(d, 16), TDX_ACC8(d, 24),
        TDX_ACC8(d, 32), TDX_ACC8(d, 40), TDX_ACC8(d, 48), TDX_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same for a 16 x 64 B.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TDX_ACC8(d, 0), TDX_ACC8(d, 8), TDX_ACC8(d, 16), TDX_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TDX_ACC8

// Stores four 8 x 8 bf16 matrices: register i of every lane holds row
// lane / 4, columns 2 (lane % 4) + {0, 1} of matrix i (the accumulator and
// A-fragment layout above), and lane l gives the shared address of row l % 8
// of matrix l / 8 (16 bytes).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// Writes a warpgroup's 64 x (2R) f32 accumulator (R registers a thread,
// the m64nNk16 layout above) as bf16 into a 64-row tile laid out as TMA's
// 128-byte swizzle expects: 64-column chunk c at tile + c * 8192, row r at
// byte r * 128 of its chunk, 16-byte group j at (j ^ r % 8) * 16.
template <int R>
__device__ __forceinline__ void store_acc_sw128(uint8_t* tile,
                                                const float (&acc)[R]) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
#pragma unroll
  for (int n = 0; n < R / 4; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;  // row % 8 == g
      uint8_t* dst =
          tile + (n / 8) * 8192 + row * 128 + ((n % 8) ^ g) * 16 + t * 4;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
  }
}

}  // namespace hopper
}  // namespace tdx
