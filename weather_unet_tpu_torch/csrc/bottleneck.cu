// K4: fused eval-mode ResNet identity bottleneck for Hopper (sm_90a).
//
// Replaces weather_unet_tpu/kernels/bottleneck_pallas.py::fused_bottleneck_eval
// (kernel body _kernel).  With every BatchNorm folded into the conv before it
// (kernels/bottleneck.py::fold_bottleneck) it computes, for NCHW x (B, C, H, W)
// and P mid channels:
//     t1  = relu(conv1x1(x,  w1) + b1)         (B, P, H, W), rounded to x's type
//     t2  = relu(conv3x3(t1, w2) + b2)         (B, P, H, W), rounded to x's type
//     out = relu(conv1x1(t2, w3) + b3 + x)     (B, C, H, W)
// in ONE launch: t1 and t2 never reach device memory.  The 3x3 pads t1 with
// zeros, so halo positions outside the image are written as 0 (never
// relu(b1), which a conv1x1 of a zero input would give).
//
// What bounds it on this card: operations in layers 2-4 (2*17*P^2 flops per
// pixel against 2*C values moved); layer 1 (P = 64) is near the ridge.
//
// Two kernels, chosen by the wrapper on dtype and shape alone
// (kernels/bottleneck.py::takes_tensor_cores):
//
//   * C and P multiples of 16 (in float32 also P >= 64): the tensor-core
//     kernel (bottleneck_tc.cuh, built as bottleneck_tc{32,64}{,c}.cu in
//     bf16 and bottleneck_f32tc16{,c}.cu in float32, one library per operand
//     type, size of its reduction chunks and cluster use, so that they
//     compile side by side).  The TPU kernel holds a whole image in VMEM; here a
//     block owns TH full rows of one image (the whole image where it fits)
//     and runs three matrix products back to back with mma.sync m16n8k16
//     (bf16 operands, float32 accumulators):
//       1. t1 on the (TH+2) x (W+2) halo region.  x is brought in by cp.async
//          as it lies: a channel's rows of the halo region are one contiguous
//          run of its NCHW plane, copied as the 16-byte pieces that cover it
//          (so each run starts at its own misalignment), 32 or 64 channels a
//          chunk, and repacked to [position][channel] bf16 in
//          shared memory (double-buffered, so the repack of chunk k+1 overlaps
//          the products of chunk k); the weights w1 (P, C) come through the
//          same cp.async ring.  The epilogue writes relu(acc + b1) as bf16 to
//          t1 [position][channel] in shared memory, and 0 at positions outside
//          the image and in the rows that pad M to a multiple of 16.
//       2. t2 on the tile: nine taps, each the same ldmatrix with the row
//          address moved by dy * (W + 2) + dx; weights (9, P, P) [tap][out]
//          [in] streamed through the ring.  t2 goes to shared memory as bf16.
//       3. the last product from t2, weights (C, P); the float32 sums plus b3
//          are staged in shared memory [channel][pixel], laid out as the tile
//          lies in a plane of the output (full rows: one contiguous run a
//          channel), so that the residual read of x (from L2: it was read a
//          moment ago) and the store are coalesced, 8 bytes a thread where
//          the runs are aligned.
//     The weights are packed once per model (pack_bottleneck: every operand
//     [column][k], k contiguous, which is what the B-operand ldmatrix wants)
//     and no thread reads a weight from global memory in an inner loop.  The
//     tile, the number of ring stages and the shared-memory layout are chosen
//     by a pure Python function (plan_bottleneck) and passed in: fewer, larger
//     tiles, so that the weights streamed for a tile serve many pixels (a 7x7
//     image is one tile with no recomputed halo).
//     Few, large tiles leave SMs idle (16 images of 7x7 are 16 tiles for 132
//     SMs), so a tile can be shared by a thread block cluster of 2 or 4
//     blocks: block r of the cluster computes columns [r N / CS, (r+1) N / CS)
//     of each of the three products from its own slice of the weights (so
//     each block streams 1 / CS of them), and writes its slice of t1 and of
//     t2 into the shared memory of every block of the cluster (distributed
//     shared memory: mapa + st.shared::cluster), with a cluster barrier after
//     phase 1 and after phase 2.  Every block stages all of x for phase 1;
//     t1 and t2 still never reach device memory.
//     Rounding: operands are bf16, sums float32, t1 and t2 rounded to bf16,
//     exactly as the plain version (bottleneck_eval_reference) does it; the
//     mma adds its products in another order than cuDNN's float32 kernels, so
//     the two differ by float32 reassociation and, where that flips the
//     rounding of t1, t2 or the output, by one bf16 step.  The measured error
//     is therefore no longer exactly 0; the bound stays 2^-6 * max(1, max|y|).
//     float32 runs the same kernel on split float32 operands (wut_mma.cuh):
//     each product is three TF32 mmas (lo.hi, hi.lo, hi.hi) of m16n8k8 on
//     the same ldmatrix byte addresses (a k8 step is 32 bytes, as a bf16
//     k16 step), the weights split once by pack_bottleneck(split=True) and
//     streamed as hi and lo through one ring slot, the activations split in
//     registers.  t1 and t2 stay float32 (no rounding point, as the plain
//     version), which doubles their bytes: the whole-image tiles of bf16 do
//     not fit, and float32 takes tiles of 1, 2 or 4 rows with a recomputed
//     halo (plan_bottleneck with esize=4), with 4 m-tiles a warp (the split
//     fragments need the registers) and chunks of 16 values.  A single TF32
//     product (10 mantissa bits) could not meet float32's bar of 1e-5 *
//     max|y|; the split one keeps each product within ~2^-21.
//
//   * bfloat16 shapes with C or P not a multiple of 16, float32 ones also
//     with P < 64: the CUDA-core kernel (the first version of this port, this
//     file): float32 fmaf over 4x4 register tiles.  float32 is held to 1e-5 *
//     max|y| of cuDNN with TF32 off.
//
// CUDA-core kernel.  A block owns a TH x TW tile of output pixels of one
// image, plus a 1-pixel halo for t1.  Three phases, separated by
// __syncthreads():
//   1. t1 on the (TH+2) x (TW+2) halo region, all P channels -> shared memory;
//   2. t2 on the tile, all P channels, from t1 in shared memory -> shared
//      memory;
//   3. the last product from t2 in shared memory, + b3 + x, ReLU -> device
//      memory.
// Each phase is a small matrix product [positions x K] . [K x channels]: a
// thread owns a register tile of 4 positions x 4 channels and loops over K;
// thread tiles are dealt round-robin to the 256 threads with the channel
// index fastest, so a warp reads 128 consecutive weights of one K row
// (coalesced, served by L1/L2) and broadcasts its 4 activations.  t1 and t2
// are rounded to x's type and kept in shared memory as float32.  The launcher
// picks the tile, the largest of 8x8, 4x8, 4x4, 2x4 that fits shared memory
// and still gives one block per SM, and opts in to more than 48 KB of dynamic
// shared memory.

#include "wut_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kR = 4;   // register tile: kR positions x kR channels

// 4 consecutive values -> float; p is aligned to 4 elements
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

// v rounded to T (round to nearest even), as a float
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return wut::to_f32(wut::from_f32<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ w3,
                  const float* __restrict__ b3, T* __restrict__ out, int C,
                  int P, int H, int W, int TH, int TW, int tiles_x,
                  int tiles_per_img) {
  extern __shared__ __align__(16) float smem[];
  const int HW2 = TW + 2;              // halo region width
  const int NH = (TH + 2) * HW2;       // halo region positions
  const int NT = TH * TW;              // tile positions
  float* t1s = smem;                             // [P][NH], rounded to T
  float* t2s = t1s + static_cast<size_t>(P) * NH;  // [P][NT], rounded to T

  const int b = blockIdx.x / tiles_per_img;
  const int tile = blockIdx.x % tiles_per_img;
  const int y0 = (tile / tiles_x) * TH;
  const int x0 = (tile % tiles_x) * TW;
  const int tid = threadIdx.x;
  const size_t hw = static_cast<size_t>(H) * W;
  const T* xb = x + static_cast<size_t>(b) * C * hw;
  const int nP = P / kR;               // channel tiles of phases 1 and 2

  // ---- phase 1: t1 = relu(x . w1 + b1) on the halo region, 0 outside the
  // image
  {
    const int total = ((NH + kR - 1) / kR) * nP;
    for (int tt = tid; tt < total; tt += kThreads) {
      const int n0 = (tt % nP) * kR;
      const int m0 = (tt / nP) * kR;
      int off[kR];
      bool ok[kR];
      bool any = false;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int m = m0 + i;
        const int yy = y0 - 1 + m / HW2, xx = x0 - 1 + m % HW2;
        ok[i] = m < NH && yy >= 0 && yy < H && xx >= 0 && xx < W;
        off[i] = ok[i] ? yy * W + xx : 0;
        any = any || ok[i];
      }
      float acc[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
      if (any) {
#pragma unroll 4
        for (int k = 0; k < C; ++k) {
          float wv[kR], xv[kR];
          load4(w1 + static_cast<size_t>(k) * P + n0, wv);
          const T* xc = xb + k * hw;
#pragma unroll
          for (int i = 0; i < kR; ++i)
            xv[i] = ok[i] ? wut::to_f32(xc[off[i]]) : 0.f;
#pragma unroll
          for (int i = 0; i < kR; ++i)
#pragma unroll
            for (int j = 0; j < kR; ++j)
              acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float bias = b1[n0 + j];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          if (m0 + i < NH) {
            const float v = ok[i] ? fmaxf(acc[i][j] + bias, 0.f) : 0.f;
            t1s[(n0 + j) * NH + m0 + i] = rounded<T>(v);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- phase 2: t2 = relu(conv3x3(t1, w2) + b2) on the tile
  {
    const int mrow = TW / kR;          // thread tiles per tile row
    const int total = TH * mrow * nP;
    for (int tt = tid; tt < total; tt += kThreads) {
      const int n0 = (tt % nP) * kR;
      const int mi = tt / nP;
      const int r = mi / mrow;
      const int c0 = (mi % mrow) * kR;
      float acc[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
      // thread tiles wholly outside the image feed only discarded outputs
      if (y0 + r < H && x0 + c0 < W) {
#pragma unroll 2
        for (int k = 0; k < P; ++k) {
          const float* trow = t1s + k * NH + r * HW2 + c0;
          const T* wk = w2 + static_cast<size_t>(k) * P + n0;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            float xv[kR + 2];
#pragma unroll
            for (int i = 0; i < kR + 2; ++i)
              xv[i] = trow[dy * HW2 + i];
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              float wv[kR];
              load4(wk + static_cast<size_t>(dy * 3 + dx) * P * P, wv);
#pragma unroll
              for (int i = 0; i < kR; ++i)
#pragma unroll
                for (int j = 0; j < kR; ++j)
                  acc[i][j] = fmaf(xv[i + dx], wv[j], acc[i][j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float bias = b2[n0 + j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
          t2s[(n0 + j) * NT + r * TW + c0 + i] =
              rounded<T>(fmaxf(acc[i][j] + bias, 0.f));
      }
    }
  }
  __syncthreads();

  // ---- phase 3: out = relu(t2 . w3 + b3 + x) on the tile
  {
    const int nC = C / kR;
    const int total = (NT / kR) * nC;
    T* ob = out + static_cast<size_t>(b) * C * hw;
    for (int tt = tid; tt < total; tt += kThreads) {
      const int n0 = (tt % nC) * kR;
      const int m0 = (tt / nC) * kR;   // kR pixels of one tile row
      const int yy = y0 + m0 / TW;
      const int xx0 = x0 + m0 % TW;
      if (yy >= H || xx0 >= W) continue;
      float acc[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < P; ++k) {
        float wv[kR], xv[kR];
        load4(w3 + static_cast<size_t>(k) * C + n0, wv);
        load4(t2s + k * NT + m0, xv);
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j)
            acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float bias = b3[n0 + j];
        const size_t base = (n0 + j) * hw + static_cast<size_t>(yy) * W;
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int xx = xx0 + i;
          if (xx < W) {
            const float v = acc[i][j] + bias + wut::to_f32(xb[base + xx]);
            ob[base + xx] = wut::from_f32<T>(fmaxf(v, 0.f));
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, void* out, int B, int C, int P, int H,
                   int W, int device, cudaStream_t st) {
  if (P % kR != 0 || C % kR != 0) return cudaErrorInvalidValue;
  int sms = 0, max_smem = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;

  // largest tile that fits shared memory and still gives every SM a block;
  // failing that, the smallest that fits
  const int cand[4][2] = {{8, 8}, {4, 8}, {4, 4}, {2, 4}};
  int TH = 0, TW = 0;
  size_t smem = 0;
  long long blocks = 0;
  for (int i = 0; i < 4; ++i) {
    const int th = cand[i][0], tw = cand[i][1];
    const size_t need =
        static_cast<size_t>(P) * ((th + 2) * (tw + 2) + th * tw) *
        sizeof(float);
    if (need > static_cast<size_t>(max_smem)) continue;
    TH = th; TW = tw; smem = need;
    blocks = static_cast<long long>(B) * ((H + th - 1) / th) *
             ((W + tw - 1) / tw);
    if (blocks >= sms) break;
  }
  if (TH == 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bottleneck_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_per_img = tiles_x * ((H + TH - 1) / TH);
  bottleneck_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<T*>(out), C, P, H, W, TH, TW,
      tiles_x, tiles_per_img);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, C, H, W); w1: (C, P); w2: (9, P, P) as [tap][in][out]; w3:
// (P, C), all of x's type; b1, b2: (P,), b3: (C,) float32.  All contiguous
// and 16-byte aligned; P and C multiples of 4.
WUT_API int wut_bottleneck(int dtype, const void* x, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           const void* w3, const void* b3, void* out, int B,
                           int C, int P, int H, int W, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == WUT_F32)
    return launch<float>(x, w1, b1, w2, b2, w3, b3, out, B, C, P, H, W, device,
                         st);
  if (dtype == WUT_BF16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, B, C, P, H, W,
                                 device, st);
  return cudaErrorInvalidValue;
}
