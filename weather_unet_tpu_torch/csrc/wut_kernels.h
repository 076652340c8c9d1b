// Plain C interface of the port's CUDA kernels, loaded with ctypes
// (weather_unet_tpu_torch/kernels/_build.py).  Every pointer and the stream
// are passed as void*; every entry returns cudaGetLastError() after its
// launch (0 = launched), which the Python wrapper turns into an exception.
//
// Each csrc/*.cu is compiled on its own into one shared library and
// includes this header once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define WUT_API extern "C" __attribute__((visibility("default")))

// dtype codes shared with the Python wrappers
enum WutDtype { WUT_F32 = 0, WUT_BF16 = 1 };

WUT_API const char* wut_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace wut {

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
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// two floats -> two bf16 in one 32-bit word (lo first in memory), rounded
// to nearest even as __floats2bfloat162_rn, without taking a local's
// address (which can cost a stack frame)
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}
// the two bf16 of a 32-bit word as floats (exact)
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

}  // namespace wut
