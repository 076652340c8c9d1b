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
// shards exchange them; wut_adain_apply reads every shard's (mean, M2) of
// its plane, merges them in registers (Chan's formula, in the shard and
// operation order of ops/norm.py::merge_plane_stats, each float32
// operation rounded on its own, so the merged statistics are the plain
// merge's on the card bit for bit) and modulates in one pass.  A site is
// these two launches around the exchange, with no PyTorch arithmetic
// between them.  Bytes again: x is read twice and out written once,
// against once and once unsplit; the n shards' statistics (8 n bytes a
// plane) are read by lane k of each warp of the plane, and the merge holds
// two of them a lane, so the apply launch keeps the registers, and the
// occupancy, of a plain streaming pass.

#include "wut_kernels.h"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kPerThread = 32;  // values a thread holds on chip
constexpr int kMaxShards = 16;  // shards whose statistics kApply merges

// The shards kApply merges, passed by value: their number, each one's
// value count of a plane as a float, and the float32 reciprocals of the
// plane's count and of that count less one, computed on the host as
// PyTorch computes the reciprocal of a Python number it divides by.
struct Shards {
  int n;
  float count[kMaxShards];
  float inv_total;
  float inv_total1;
};

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

// The plane's float32 (mean, unbiased variance) from the n shards' local
// (mean, M2) stats[2 (k planes + plane)] over sh.count[k] values each:
// ops/norm.py::merge_plane_stats on the card, bit for bit.  Its Python sums
// start at 0 and add the shards in order; `count * t` multiplies by the
// count as a float; `t / total`, a tensor over a Python number, is
// PyTorch's multiply by the number's float32 reciprocal (sh.inv_total);
// `.square()` is d * d.  Every operation is an intrinsic rounded on its
// own, so nvcc contracts none into an FMA.  Lane k of the warp loads shard
// k's pair, so the loads are one round trip, and the sums take them in
// order by shuffles (the warp is whole: kApply retires only whole warps).
__device__ __forceinline__ void merge_stats(const float* __restrict__ stats,
                                            long long planes,
                                            long long plane, const Shards& sh,
                                            float* mean, float* var) {
  const int lane = threadIdx.x & 31;
  float lm = 0.f, lm2 = 0.f;
  if (lane < sh.n) {
    const long long i = 2 * (lane * planes + plane);
    lm = __ldg(stats + i);
    lm2 = __ldg(stats + i + 1);
  }
  float acc = 0.f, s2 = 0.f, dev = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxShards; ++k) {
    if (k < sh.n) {
      acc = __fadd_rn(acc,
                      __fmul_rn(sh.count[k], __shfl_sync(~0u, lm, k)));
      s2 = __fadd_rn(s2, __shfl_sync(~0u, lm2, k));
    }
  }
  const float mu = __fmul_rn(acc, sh.inv_total);
#pragma unroll
  for (int k = 0; k < kMaxShards; ++k) {
    if (k < sh.n) {
      const float d = __fsub_rn(__shfl_sync(~0u, lm, k), mu);
      dev = __fadd_rn(dev, __fmul_rn(sh.count[k], __fmul_rn(d, d)));
    }
  }
  *mean = mu;
  *var = __fmul_rn(__fadd_rn(s2, dev), sh.inv_total1);
}

// kMode: kWhole, the plane's statistics and its modulation in one launch;
// kStats, the plane's float32 (mean, M2) into stats[2 * plane] (y_proj and
// out unused); kApply, the merge of the sh.n shards' (mean, M2) in stats
// (sh.n, planes, 2), written to merged[2 * plane] where merged is not
// null, and the modulation with it (one pass, any plan).
enum Mode { kWhole = 0, kStats = 1, kApply = 2 };

template <typename T, int kVW, int kMode>
__global__ void __launch_bounds__(kMaxThreads, 2)
adain_kernel(const T* __restrict__ x, const void* __restrict__ y_proj,
             int y_bf16, T* __restrict__ out, float* __restrict__ stats,
             float* __restrict__ merged, Shards sh, long long planes,
             long long hw, int wp, int ppb, int on_chip, float eps) {
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
    // the shards' statistics merged, then stream the plane once, any plan
    if (!live) return;
    float y_mean, y_scale, mean, var;
    style_stats(y_proj, y_bf16, plane, eps, &y_mean, &y_scale);
    merge_stats(stats, planes, plane, sh, &mean, &var);
    if (merged != nullptr && t == 0) {
      merged[2 * plane] = mean;
      merged[2 * plane + 1] = var;
    }
    const float scale = y_scale * rsqrtf(var + eps);
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

// What a launch is given besides its plan: x, y_proj, out and the
// statistics' buffers, and the shards kApply merges.
struct Args {
  const void* x;
  const void* y;
  int y_bf16;
  void* out;
  float* stats;
  float* merged;
  Shards sh;
  float eps;
};

template <typename T, int kVW, int kMode>
cudaError_t launch(const Args& a, long long planes, long long hw, int wp,
                   int ppb, int on_chip, cudaStream_t st) {
  const long long blocks = (planes + ppb - 1) / ppb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  adain_kernel<T, kVW, kMode><<<static_cast<unsigned>(blocks),
                                wp * ppb * 32, 0, st>>>(
      static_cast<const T*>(a.x), a.y, a.y_bf16, static_cast<T*>(a.out),
      a.stats, a.merged, a.sh, planes, hw, wp, ppb, on_chip, a.eps);
  return cudaGetLastError();
}

// the four instantiations of one mode by dtype and load width
template <int kMode>
cudaError_t dispatch(int dtype, int vec, const Args& a, long long planes,
                     long long hw, int wp, int ppb, int on_chip,
                     cudaStream_t st) {
  if (dtype == WUT_F32) {
    if (vec) return launch<float, 4, kMode>(a, planes, hw, wp, ppb, on_chip,
                                            st);
    return launch<float, 1, kMode>(a, planes, hw, wp, ppb, on_chip, st);
  }
  if (dtype == WUT_BF16) {
    if (vec) return launch<__nv_bfloat16, 8, kMode>(a, planes, hw, wp, ppb,
                                                    on_chip, st);
    return launch<__nv_bfloat16, 1, kMode>(a, planes, hw, wp, ppb, on_chip,
                                           st);
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
  const Args a{x, y_proj, y_dtype == WUT_BF16, out, nullptr, nullptr, {},
               eps};
  return dispatch<kWhole>(dtype, vec, a, planes, hw, wp, ppb, on_chip,
                          static_cast<cudaStream_t>(stream));
}

// The split-statistics form (spatial partitioning, parallel/spatial.py):
// each plane of x holds a shard's rows of the image's plane.
// wut_adain_stats writes each plane's float32 local mean and M2 (the sum of
// squared deviations from that mean, two-pass, the plane read once where
// the plan holds it on chip) into stats (planes, 2); the shards exchange
// them.  wut_adain_apply takes every shard's in shard_stats (shards,
// planes, 2), contiguous, and their value counts of a plane in counts
// (shards of them, a host array; 1 <= shards <= 16), merges them
// (ops/norm.py::merge_plane_stats, bit for bit), writes the merged float32
// (mean, unbiased variance) into merged (planes, 2) unless it is null, and
// modulates x with them and the style statistics of y_proj, in one
// streaming pass under any plan.
WUT_API int wut_adain_stats(int dtype, const void* x, void* stats,
                            long long planes, long long hw, int vec, int wp,
                            int ppb, int on_chip, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (wp < 1 || ppb < 1 || wp * ppb * 32 > kMaxThreads ||
      (on_chip && static_cast<long long>(wp) * 32 * kPerThread < hw) ||
      (!on_chip && ppb != 1))
    return cudaErrorInvalidValue;
  const Args a{x, nullptr, 0, nullptr, static_cast<float*>(stats), nullptr,
               {}, 0.f};
  return dispatch<kStats>(dtype, vec, a, planes, hw, wp, ppb, on_chip,
                          static_cast<cudaStream_t>(stream));
}

WUT_API int wut_adain_apply(int dtype, const void* x, const void* y_proj,
                            int y_dtype, const void* shard_stats, int shards,
                            const long long* counts, void* merged, void* out,
                            long long planes, long long hw, int vec, int wp,
                            int ppb, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (wp < 1 || ppb < 1 || wp * ppb * 32 > kMaxThreads ||
      (y_dtype != WUT_F32 && y_dtype != WUT_BF16) || shards < 1 ||
      shards > kMaxShards)
    return cudaErrorInvalidValue;
  Shards sh{shards, {}, 0.f, 0.f};
  long long total = 0;
  for (int k = 0; k < shards; ++k) {
    if (counts[k] < 1) return cudaErrorInvalidValue;
    sh.count[k] = static_cast<float>(counts[k]);
    total += counts[k];
  }
  // PyTorch's CUDA division of a tensor by a CPU scalar b: a * (1.0f / b)
  sh.inv_total = 1.0f / static_cast<float>(total);
  sh.inv_total1 = 1.0f / static_cast<float>(total > 1 ? total - 1 : 1);
  const Args a{x, y_proj, y_dtype == WUT_BF16, out,
               const_cast<float*>(static_cast<const float*>(shard_stats)),
               static_cast<float*>(merged), sh, eps};
  return dispatch<kApply>(dtype, vec, a, planes, hw, wp, ppb, 0,
                          static_cast<cudaStream_t>(stream));
}
