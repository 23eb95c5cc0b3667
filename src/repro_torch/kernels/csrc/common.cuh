// Shared helpers of the port's CUDA kernels: f32 <-> storage-type
// conversion, warp reductions, and the plain C error interface that the
// Python wrappers read through ctypes.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_NEG_INF (-1e30f)
#define RT_FULL_MASK 0xffffffffu

enum { RT_F32 = 0, RT_BF16 = 1 };

__device__ __forceinline__ float rt_to_f32(float x) { return x; }
__device__ __forceinline__ float rt_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T rt_from_f32(float x);
template <>
__device__ __forceinline__ float rt_from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 rt_from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float rt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(RT_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float rt_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(RT_FULL_MASK, v, o));
  return v;
}

// The wrappers raise with this text when a launch returns an error code.
extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
