// float32 <-> element-type conversions shared by the kernels: a value is
// read into float32, and stored (or rounded, to mirror a rounding point of
// the JAX reference) with round-to-nearest-even.
#pragma once
#include <cuda_bf16.h>

namespace vlt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and read back as float32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

}  // namespace vlt
