// Storage-type helpers of the CUDA-core flash bodies (flash_fwd_f32 and
// bwd_dq_f32), which take their tensors' element type as a template
// parameter: they widen it to f32 on the load into shared memory, compute
// in f32, and round p or ds to it before a product that takes them
// (round_to), as the TPU kernel casts them before its matmuls.  The port
// instantiates them for float only, where every helper is the identity:
// every bf16 kernel is on TMA + wgmma.

#pragma once

namespace tdx {

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename Elem>
__device__ __forceinline__ Elem from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// x as a product reads it when it is stored in Elem.
template <typename Elem>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<Elem>(x));
}

}  // namespace tdx
