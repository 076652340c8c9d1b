// K1: fused AdaIN for Hopper (sm_90a), one launch per call.
//
// Replaces weather_unet_tpu/kernels/adain_pallas.py::_adain_pallas_impl
// (kernel body _adain_kernel): per (sample, channel) plane, two-pass float32
// mean and UNBIASED variance over H*W, then
//     out = (x - mean) * scale + y_mean,  scale = y_scale * rsqrt(var + eps)
// (the plain version's order: x * scale + (y_mean - mean * scale) would
// cancel where |mean| is large against the plane's spread),
// where y_mean and y_scale = sqrt(var4 + eps) are the mean and unbiased
// variance of the plane's 4 projected style values y_proj[b, 4c:4c+4]
// (ops/norm.py::_style_stats), computed here in float32 from y_proj as it
// comes (float32 or bf16).  The JAX wrapper rounds y_scale / y_mean to x's
// dtype before its launch (adain_pallas.py:102-103); this kernel keeps them
// in float32, as both packages' plain `adain` does, and is held to that.
//
// What bounds it on this card: bytes.  About 6 flops per element against
// the ~295 flops/byte the H100 needs before compute matters; the floor is
// one read of x and one write of out at 3.35 TB/s.
//
// Design (the shape comes from kernels/adain.py::plan_adain):
// - One launch, no PyTorch arithmetic around it: the style statistics are
//   the plane's own 4 values, read by every thread of the plane.
// - On chip: `wp` warps own a plane and hold it in registers, up to
//   kPerThread values a thread, loaded once with 16-byte loads (8 bf16 or 4
//   float32; 1 element where H*W is not a multiple of that).  The mean, the
//   sum of squared deviations from it (two-pass: never E[x^2] - mean^2,
//   which cancels in bf16) and the modulated output all come from those
//   registers, so x is read from device memory once.  Small planes (1024
//   values at the cUNet's 32x32 site) take one warp each, several planes a
//   block, and reduce with shuffles alone; a 128x128 plane takes a block of
//   16 warps, reduced through 2 x 16 floats of shared memory.
// - Planes beyond wp = 16 warps x 32 lanes x kPerThread values (16384) take
//   the re-reading path of the same kernel: a block of 16 warps per plane,
//   three passes over the plane in device memory (mean, deviations,
//   modulate).
//
// Split statistics (spatial partitioning, parallel/spatial.py): a shard
// holds some of each plane's rows, and the plane's statistics span the
// shards.  wut_adain_stats runs the same kernel up to the plane's local
// float32 mean and M2 (from registers, as above) and writes them; the
// shards merge them exactly (Chan's formula); wut_adain_apply modulates
// with the merged mean and variance in one pass.  Bytes again: x is read
// twice and out written once, against once and once unsplit.

#include "wut_kernels.h"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kPerThread = 32;  // values a thread holds on chip

// kVW consecutive elements of T as float32, one load (16 bytes, or one
// element when kVW == 1)
template <typename T, int kVW>
__device__ __forceinline__ void load(const T* p, float* v) {
  if constexpr (kVW == 1) {
    v[0] = wut::to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = wut::bf16_lo(u.x); v[1] = wut::bf16_hi(u.x);
    v[2] = wut::bf16_lo(u.y); v[3] = wut::bf16_hi(u.y);
    v[4] = wut::bf16_lo(u.z); v[5] = wut::bf16_hi(u.z);
    v[6] = wut::bf16_lo(u.w); v[7] = wut::bf16_hi(u.w);
  }
}

template <typename T, int kVW>
__device__ __forceinline__ void store(T* p, const float* v) {
  if constexpr (kVW == 1) {
    p[0] = wut::from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        wut::pack_bf16x2(v[0], v[1]), wut::pack_bf16x2(v[2], v[3]),
        wut::pack_bf16x2(v[4], v[5]), wut::pack_bf16x2(v[6], v[7]));
  }
}

// Sum of v over the wp warps of this thread's plane; every thread of the
// plane gets it.  buf holds one float a warp and is used once per launch.
__device__ __forceinline__ float plane_sum(float v, float* buf, int wp,
                                           int slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (wp == 1) return v;
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < wp; ++k) s += buf[slot * wp + k];
  return s;
}

// The plane's style statistics from its 4 projected values y_proj[4 plane
// .. 4 plane + 3]: float32, two-pass, unbiased over the 4 values.
__device__ __forceinline__ void style_stats(const void* y_proj, int y_bf16,
                                            long long plane, float eps,
                                            float* y_mean, float* y_scale) {
  float ys[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = plane * 4 + k;
    ys[k] = y_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(y_proj)[i])
                   : static_cast<const float*>(y_proj)[i];
  }
  const float m = (ys[0] + ys[1] + ys[2] + ys[3]) / 4.f;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) ss += (ys[k] - m) * (ys[k] - m);
  *y_mean = m;
  *y_scale = sqrtf(ss / 4.f * (4.f / 3.f) + eps);
}

// kMode: kWhole, the plane's statistics and its modulation in one launch;
// kStats, the plane's float32 (mean, M2) into stats[2 * plane] (y_proj and
// out unused); kApply, the modulation with the given float32 (mean,
// unbiased variance) of stats[2 * plane] (one pass, any plan).
enum Mode { kWhole = 0, kStats = 1, kApply = 2 };

template <typename T, int kVW, int kMode>
__global__ void __launch_bounds__(kMaxThreads, 2)
adain_kernel(const T* __restrict__ x, const void* __restrict__ y_proj,
             int y_bf16, T* __restrict__ out, float* __restrict__ stats,
             long long planes, long long hw, int wp, int ppb, int on_chip,
             float eps) {
  constexpr int kN = kPerThread / kVW;  // loads a thread holds on chip
  __shared__ float red[2][kMaxThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int slot = warp / wp;  // this warp's plane within the block
  const long long plane = static_cast<long long>(blockIdx.x) * ppb + slot;
  const bool live = plane < planes;  // dead warps still reach the barriers
  const int t = (warp - slot * wp) * 32 + (threadIdx.x & 31);
  const int nt = wp * 32;
  const long long nv = hw / kVW;
  const T* xp = x + (live ? plane : 0) * hw;
  T* op = out + (live ? plane : 0) * hw;

  if constexpr (kMode == kApply) {
    // given statistics: stream the plane once, any plan
    const long long sp = 2 * (live ? plane : 0);
    float y_mean, y_scale;
    style_stats(y_proj, y_bf16, live ? plane : 0, eps, &y_mean, &y_scale);
    const float mean = stats[sp];
    const float scale = y_scale * rsqrtf(stats[sp + 1] + eps);
    if (!live) return;
    float w[kVW];
#pragma unroll 4
    for (long long i = t; i < nv; i += nt) {
      load<T, kVW>(xp + i * kVW, w);
#pragma unroll
      for (int j = 0; j < kVW; ++j) w[j] = (w[j] - mean) * scale + y_mean;
      store<T, kVW>(op + i * kVW, w);
    }
    return;
  }

  float y_mean = 0.f, y_scale = 0.f;  // unused by kStats
  if constexpr (kMode == kWhole)
    style_stats(y_proj, y_bf16, live ? plane : 0, eps, &y_mean, &y_scale);
  const float inv_n = 1.f / static_cast<float>(hw);
  const float inv_n1 = 1.f / static_cast<float>(hw > 1 ? hw - 1 : 1);

  if (on_chip) {  // hw <= 16 x 32 x kPerThread: 32-bit indices
    const int nvi = static_cast<int>(nv);
    float v[kPerThread];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = t + k * nt;
      if (live && i < nvi) {
        load<T, kVW>(xp + i * kVW, v + k * kVW);
      } else {
#pragma unroll
        for (int j = 0; j < kVW; ++j) v[k * kVW + j] = 0.f;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) s += v[j];
    const float mean = plane_sum(s, red[0], wp, slot) * inv_n;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (t + k * nt < nvi) {
#pragma unroll
        for (int j = 0; j < kVW; ++j) {
          const float d = v[k * kVW + j] - mean;
          ss += d * d;
        }
      }
    }
    const float m2 = plane_sum(ss, red[1], wp, slot);
    if constexpr (kMode == kStats) {
      if (live && t == 0) {
        stats[2 * plane] = mean;
        stats[2 * plane + 1] = m2;
      }
      return;
    }
    const float var = m2 * inv_n1;
    const float scale = y_scale * rsqrtf(var + eps);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int i = t + k * nt;
      if (live && i < nvi) {
        float o[kVW];
#pragma unroll
        for (int j = 0; j < kVW; ++j)
          o[j] = (v[k * kVW + j] - mean) * scale + y_mean;
        store<T, kVW>(op + i * kVW, o);
      }
    }
    return;
  }

  // re-reading path: a block per plane, three passes over device memory
  float w[kVW];
  float s = 0.f;
#pragma unroll 4
  for (long long i = t; i < nv; i += nt) {
    load<T, kVW>(xp + i * kVW, w);
#pragma unroll
    for (int j = 0; j < kVW; ++j) s += w[j];
  }
  const float mean = plane_sum(s, red[0], wp, slot) * inv_n;
  float ss = 0.f;
#pragma unroll 4
  for (long long i = t; i < nv; i += nt) {
    load<T, kVW>(xp + i * kVW, w);
#pragma unroll
    for (int j = 0; j < kVW; ++j) ss += (w[j] - mean) * (w[j] - mean);
  }
  const float m2 = plane_sum(ss, red[1], wp, slot);
  if constexpr (kMode == kStats) {
    if (live && t == 0) {
      stats[2 * plane] = mean;
      stats[2 * plane + 1] = m2;
    }
    return;
  }
  const float var = m2 * inv_n1;
  const float scale = y_scale * rsqrtf(var + eps);
#pragma unroll 4
  for (long long i = t; i < nv; i += nt) {
    load<T, kVW>(xp + i * kVW, w);
#pragma unroll
    for (int j = 0; j < kVW; ++j) w[j] = (w[j] - mean) * scale + y_mean;
    store<T, kVW>(op + i * kVW, w);
  }
}

template <typename T, int kVW, int kMode>
cudaError_t launch(const void* x, const void* y, int y_bf16, void* out,
                   float* stats, long long planes, long long hw, int wp,
                   int ppb, int on_chip, float eps, cudaStream_t st) {
  const long long blocks = (planes + ppb - 1) / ppb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  adain_kernel<T, kVW, kMode><<<static_cast<unsigned>(blocks),
                                wp * ppb * 32, 0, st>>>(
      static_cast<const T*>(x), y, y_bf16, static_cast<T*>(out), stats,
      planes, hw, wp, ppb, on_chip, eps);
  return cudaGetLastError();
}

// the four instantiations of one mode by dtype and load width
template <int kMode>
cudaError_t dispatch(int dtype, int vec, const void* x, const void* y,
                     int y_bf16, void* out, float* stats, long long planes,
                     long long hw, int wp, int ppb, int on_chip, float eps,
                     cudaStream_t st) {
  if (dtype == WUT_F32) {
    if (vec) return launch<float, 4, kMode>(x, y, y_bf16, out, stats, planes,
                                            hw, wp, ppb, on_chip, eps, st);
    return launch<float, 1, kMode>(x, y, y_bf16, out, stats, planes, hw, wp,
                                   ppb, on_chip, eps, st);
  }
  if (dtype == WUT_BF16) {
    if (vec) return launch<__nv_bfloat16, 8, kMode>(
        x, y, y_bf16, out, stats, planes, hw, wp, ppb, on_chip, eps, st);
    return launch<__nv_bfloat16, 1, kMode>(x, y, y_bf16, out, stats, planes,
                                           hw, wp, ppb, on_chip, eps, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: (planes = B*C, hw) contiguous, 16-byte aligned when vec;
// y_proj: (B, 4C) contiguous, float32 (y_dtype 0) or bf16 (1).  vec, wp
// (warps a plane), ppb (planes a block) and on_chip come from
// kernels/adain.py::plan_adain.
WUT_API int wut_adain(int dtype, const void* x, const void* y_proj,
                      int y_dtype, void* out, long long planes, long long hw,
                      int vec, int wp, int ppb, int on_chip, float eps,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (wp < 1 || ppb < 1 || wp * ppb * 32 > kMaxThreads ||
      (on_chip && static_cast<long long>(wp) * 32 * kPerThread < hw) ||
      (!on_chip && ppb != 1) || (y_dtype != WUT_F32 && y_dtype != WUT_BF16))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch<kWhole>(dtype, vec, x, y_proj, y_dtype == WUT_BF16, out,
                          nullptr, planes, hw, wp, ppb, on_chip, eps, st);
}

// The split-statistics form (spatial partitioning, parallel/spatial.py):
// each plane of x holds a shard's rows of the image's plane.
// wut_adain_stats writes each plane's float32 local mean and M2 (the sum of
// squared deviations from that mean, two-pass, the plane read once where
// the plan holds it on chip) into stats (planes, 2); the shards merge them
// (ops/norm.py::merge_plane_stats).  wut_adain_apply modulates x with the
// merged float32 (mean, unbiased variance) in stats (planes, 2) and the
// style statistics of y_proj, in one streaming pass under any plan.
WUT_API int wut_adain_stats(int dtype, const void* x, void* stats,
                            long long planes, long long hw, int vec, int wp,
                            int ppb, int on_chip, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (wp < 1 || ppb < 1 || wp * ppb * 32 > kMaxThreads ||
      (on_chip && static_cast<long long>(wp) * 32 * kPerThread < hw) ||
      (!on_chip && ppb != 1))
    return cudaErrorInvalidValue;
  return dispatch<kStats>(dtype, vec, x, nullptr, 0, nullptr,
                          static_cast<float*>(stats), planes, hw, wp, ppb,
                          on_chip, 0.f, static_cast<cudaStream_t>(stream));
}

WUT_API int wut_adain_apply(int dtype, const void* x, const void* y_proj,
                            int y_dtype, const void* stats, void* out,
                            long long planes, long long hw, int vec, int wp,
                            int ppb, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (wp < 1 || ppb < 1 || wp * ppb * 32 > kMaxThreads ||
      (y_dtype != WUT_F32 && y_dtype != WUT_BF16))
    return cudaErrorInvalidValue;
  return dispatch<kApply>(dtype, vec, x, y_proj, y_dtype == WUT_BF16, out,
                          const_cast<float*>(static_cast<const float*>(stats)),
                          planes, hw, wp, ppb, 0, eps,
                          static_cast<cudaStream_t>(stream));
}
