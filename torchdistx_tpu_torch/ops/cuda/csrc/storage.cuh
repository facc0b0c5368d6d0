// Storage types of the CUDA-core flash bodies (flash_fwd_f32, bwd_kv_f32,
// bwd_dq_f32): they read float or __nv_bfloat16 tensors, widen them to f32
// on the load into shared memory and compute in f32, as the TPU kernel
// accumulates in f32 from storage-dtype operands.  A product that takes p or
// ds takes it rounded to the storage type first (round_to), as the TPU
// kernel casts them before its matmuls.  For float every helper is the
// identity, so the f32 instances compile as they did before bf16 was added.

#pragma once

#include <cuda_bf16.h>

namespace tdx {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename Elem>
__device__ __forceinline__ Elem from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x as a product reads it when it is stored in Elem.
template <typename Elem>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<Elem>(x));
}

}  // namespace tdx
