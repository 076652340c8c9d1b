// K2: exact 2x bilinear upsample, align_corners=True, for Hopper (sm_90a).
//
// Replaces weather_unet_tpu/kernels/upsample_pallas.py::_upsample2x_impl (the
// five Pallas bodies _kernel_einsum/_loop/_blend/_blendmm/_shift are TPU
// layout variants of this one function).  For NCHW x (B, C, H, W):
//     out[b, c, oy, ox] = (1-fy) * ((1-fx) * x[i0, j0] + fx * x[i0, j1])
//                       +    fy  * ((1-fx) * x[i1, j0] + fx * x[i1, j1])
// with the 2-tap tables i0, i1, fy (rows) and j0, j1, fx (columns) of
// ops/resize.py::_x2_taps, passed by the wrapper (the same tables the fused
// upsample+conv kernel reads).  The blend runs in float32 and is rounded
// once.
//
// What bounds it on this card: bytes.  It reads x once and writes four times
// as much, 8 flops per output value.
//
// Design: one thread per PAIR of adjacent output columns of one output row
// (2W is always even), so a warp writes 64 consecutive output values as
// 4-byte (bf16) or 8-byte (float32) stores and reads the ~32 consecutive
// input values under them from two input rows; neighbouring threads share
// those reads through L1.  No shared memory: every input value is used by
// about four outputs of two adjacent rows, which L1/L2 serve.

#include "wut_kernels.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_kernel(const T* __restrict__ x, const int* __restrict__ tap_idx,
                const float* __restrict__ tap_frac, T* __restrict__ out,
                int H, int W, long long n_pairs) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_pairs) return;
  const int H2 = 2 * H, W2 = 2 * W;
  // tap tables: [i0 rows (2H) | i1 rows (2H) | i0 cols (2W) | i1 cols (2W)],
  // fractions [rows (2H) | cols (2W)]
  const int* h_i0 = tap_idx;
  const int* h_i1 = tap_idx + H2;
  const int* w_i0 = tap_idx + 2 * H2;
  const int* w_i1 = w_i0 + W2;
  const float* h_f = tap_frac;
  const float* w_f = tap_frac + H2;

  const int px = static_cast<int>(e % W);          // pair index in the row
  const long long row = e / W;                      // (b*C + c) * 2H + oy
  const int oy = static_cast<int>(row % H2);
  const long long plane = row / H2;
  const T* xp = x + plane * H * W;
  const T* r0 = xp + static_cast<long long>(h_i0[oy]) * W;
  const T* r1 = xp + static_cast<long long>(h_i1[oy]) * W;
  const float fy = h_f[oy];

  float v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ox = 2 * px + k;
    const int q0 = w_i0[ox], q1 = w_i1[ox];
    const float fx = w_f[ox];
    const float top = (1.f - fx) * wut::to_f32(r0[q0]) + fx * wut::to_f32(r0[q1]);
    const float bot = (1.f - fx) * wut::to_f32(r1[q0]) + fx * wut::to_f32(r1[q1]);
    v[k] = (1.f - fy) * top + fy * bot;
  }
  store2(out + row * W2 + 2 * px, v[0], v[1]);
}

template <typename T>
cudaError_t launch(const void* x, const void* tap_idx, const void* tap_frac,
                   void* out, long long planes, int H, int W,
                   cudaStream_t st) {
  const long long n_pairs = planes * 2 * H * W;
  const long long blocks = (n_pairs + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  upsample_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(tap_idx),
      static_cast<const float*>(tap_frac), static_cast<T*>(out), H, W,
      n_pairs);
  return cudaGetLastError();
}

}  // namespace

// x: (planes = B*C, H, W); tap_idx: int32, tap_frac: float32 (see the
// kernel); out: (planes, 2H, 2W).  All contiguous.
WUT_API int wut_upsample2x(int dtype, const void* x, const void* tap_idx,
                           const void* tap_frac, void* out, long long planes,
                           int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == WUT_F32)
    return launch<float>(x, tap_idx, tap_frac, out, planes, H, W, st);
  if (dtype == WUT_BF16)
    return launch<__nv_bfloat16>(x, tap_idx, tap_frac, out, planes, H, W, st);
  return cudaErrorInvalidValue;
}
