// K3: fused 2x align-corners upsample + 3x3 conv for Hopper (sm_90a).
//
// Replaces weather_unet_tpu/kernels/upconv_pallas.py::upsample2x_conv3x3
// (kernel body _upconv_kernel).  It computes, for NCHW x (B, C, H, W):
//     out = act(conv3x3_pad1(upsample2x_ac(x * scale + shift), w) + cb)
// with the optional per-(b, c) modulation scale/shift (float32), the optional
// skip-path conv output cb (B, O, 2H, 2W, bias included) and the optional
// ReLU.  Neither the upsampled nor the modulated tensor is written to device
// memory: each block builds the patch it needs in shared memory from the
// LOW-RES x.  The conv pads the modulated, upsampled tensor with zeros, so
// halo positions outside the image are 0 (never `shift`).
//
// What bounds it on this card: operations.  At the cUNet decoder sites it is
// 9.66 GFLOP an image against ~10 MB moved, thousands of flops per byte.
//
// Two kernels, chosen by the wrapper on dtype and shape alone
// (kernels/upconv.py::takes_tensor_cores):
//
//   * C a multiple of 16: the tensor-core kernel (namespace tc
//     below), an implicit GEMM with mma.sync m16n8k16 (bf16 operands, float32
//     accumulators).  A block owns M = TH x TW output pixels (8x16, or 16x16
//     where O <= 64) times NB = 128 or 64 output channels, so the patch is
//     built once or twice per tile; K runs over 9 taps x C in chunks of 16
//     channels.  Per chunk:
//       - the low-res rows the tile needs (about (TH/2+3) x (TW/2+3) pixels a
//         channel) arrive by cp.async "as they lie"
//         (wut_mma.cuh::stage_rows_async), two chunks ahead;
//       - the patch, (TH+2) x (TW+2) positions, is blended from them with the
//         2-tap align-corners tables, modulated and blended in float32 as in
//         the CUDA-core kernel, rounded once to bf16 and stored
//         [position][channel]; halo positions outside the image stay 0, after
//         modulation.  The per-position tap indices and fractions are worked
//         out once per block into shared memory, the modulation once per
//         block.  The patch is double-buffered: chunk k+1 is built while the
//         products of chunk k run;
//       - a tap (dy, dx) is the A-operand ldmatrix with the row address moved
//         by dy * (TW + 2) + dx: the nine taps reuse one patch;
//       - the weights, pre-arranged by the wrapper as (9, O, C) (k contiguous
//         for the B-operand ldmatrix), stream through a 3-stage cp.async ring
//         one row of taps (3 x NB x 16) at a time.
//     The epilogue stages the float32 sums in shared memory [channel][pixel],
//     adds cb, applies the ReLU and stores two pixels a thread, coalesced
//     along W.  Rounding the patch to bf16 is what the plain chain does after
//     its upsample, so the bf16 bound 2^-6 * max(1, max|y|) holds.  Output
//     channels beyond O are zero-filled rows of the weight ring.
//     float32 (tc::run<float>, wut_upconv_tc_f32) runs the same kernel on
//     split float32 operands (wut_mma.cuh): the patch is blended and
//     modulated in float32 and stored float32, split into TF32 hi and lo on
//     the A fragment; the weights come split by pack_upconv_weight(split=
//     True) as (2, 9, O, C) and stream as hi and lo through one ring slot; k
//     runs in chunks of 8 channels (a k8 step, 32 bytes a row, as bf16's
//     k16), each product three m16n8k8 TF32 mmas.  It takes the 16x16 x 64
//     tile at every O (measured faster than 8x16 x 128 at O = 128, 256) and
//     one block an SM (the split fragments need the registers).  A single
//     TF32 product (10 mantissa bits) could not meet float32's bar of 1e-5 *
//     max|y|; the split one keeps each product within ~2^-21.
//
//   * C not a multiple of 16: the CUDA-core kernel (the first version of
//     this port): a direct convolution, float32 fmaf.  float32 is held to
//     1e-5 * max|y| of cuDNN with TF32 off.
//
// CUDA-core kernel.  A block owns a 16x16 tile of output pixels times 64
// output channels.  For each chunk of 8 input channels it stages in shared
// memory
//   * the modulated, upsampled 18x18 patch (tile + 1-pixel halo), each value a
//     2x2 blend of low-res x with the 2-tap align-corners tables that the
//     wrapper passes (ops/resize.py::_x2_taps, float32), and
//   * the weights of those channels, w laid out (C, 3, 3, O) by the wrapper.
// Each thread accumulates 8 pixels x 8 output channels in float32 registers,
// reusing each patch row it loads for the three horizontal taps.  The
// epilogue adds cb, applies the ReLU and writes the tile once.

#include "wut_kernels.h"
#include "wut_mma.cuh"

namespace {

constexpr int kTile = 16;           // output tile edge, high-res pixels
constexpr int kPatch = kTile + 2;   // plus the 1-pixel conv halo
constexpr int kTO = 64;             // output channels per block
constexpr int kCC = 8;              // input channels per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kPX = 8;              // pixels per thread (one row segment)
constexpr int kOC = 8;              // output channels per thread
static_assert(kThreads == (kTile * kTile / kPX) * (kTO / kOC),
              "one thread per (row segment, output-channel group)");

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
upconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ cb, const float* __restrict__ scale,
              const float* __restrict__ shift,
              const int* __restrict__ tap_idx,
              const float* __restrict__ tap_frac, T* __restrict__ out, int C,
              int H, int W, int O, int relu, int tiles_x) {
  __shared__ float patch[kCC][kPatch][kPatch];
  __shared__ __align__(16) float wsm[kCC][9][kTO];

  const int H2 = 2 * H, W2 = 2 * W;
  // tap tables: [i0 rows (2H) | i1 rows (2H) | i0 cols (2W) | i1 cols (2W)],
  // fractions [rows (2H) | cols (2W)]
  const int* h_i0 = tap_idx;
  const int* h_i1 = tap_idx + H2;
  const int* w_i0 = tap_idx + 2 * H2;
  const int* w_i1 = w_i0 + W2;
  const float* h_f = tap_frac;
  const float* w_f = tap_frac + H2;

  const int oy0 = (blockIdx.x / tiles_x) * kTile;
  const int ox0 = (blockIdx.x % tiles_x) * kTile;
  const int o0 = blockIdx.y * kTO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tn = tid % (kTO / kOC);       // output channels o0 + tn*kOC + j
  const int tm = tid / (kTO / kOC);
  const int row = tm / (kTile / kPX);     // tile row of this thread
  const int col0 = (tm % (kTile / kPX)) * kPX;

  float acc[kPX][kOC];
#pragma unroll
  for (int i = 0; i < kPX; ++i)
#pragma unroll
    for (int j = 0; j < kOC; ++j) acc[i][j] = 0.f;

  const size_t hw = static_cast<size_t>(H) * W;
  const T* xb = x + static_cast<size_t>(b) * C * hw;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    __syncthreads();  // the previous chunk's products are done
    for (int e = tid; e < kCC * kPatch * kPatch; e += kThreads) {
      const int cc = e / (kPatch * kPatch);
      const int pr = (e / kPatch) % kPatch;
      const int pc = e % kPatch;
      const int c = c0 + cc;
      const int yy = oy0 - 1 + pr, xx = ox0 - 1 + pc;
      float v = 0.f;  // zero padding of the modulated, upsampled tensor
      if (c < C && yy >= 0 && yy < H2 && xx >= 0 && xx < W2) {
        const T* xc = xb + static_cast<size_t>(c) * hw;
        const int r0 = h_i0[yy] * W, r1 = h_i1[yy] * W;
        const int q0 = w_i0[xx], q1 = w_i1[xx];
        float a00 = wut::to_f32(xc[r0 + q0]), a01 = wut::to_f32(xc[r0 + q1]);
        float a10 = wut::to_f32(xc[r1 + q0]), a11 = wut::to_f32(xc[r1 + q1]);
        if (scale != nullptr) {
          const size_t bc = static_cast<size_t>(b) * C + c;
          const float s = scale[bc], t = shift[bc];
          a00 = a00 * s + t;
          a01 = a01 * s + t;
          a10 = a10 * s + t;
          a11 = a11 * s + t;
        }
        const float fy = h_f[yy], fx = w_f[xx];
        v = (1.f - fy) * ((1.f - fx) * a00 + fx * a01) +
            fy * ((1.f - fx) * a10 + fx * a11);
      }
      patch[cc][pr][pc] = v;
    }
    for (int e = tid; e < kCC * 9 * kTO; e += kThreads) {
      const int cc = e / (9 * kTO);
      const int k = (e / kTO) % 9;
      const int oo = e % kTO;
      const int c = c0 + cc, o = o0 + oo;
      wsm[cc][k][oo] =
          (c < C && o < O)
              ? wut::to_f32(w[(static_cast<size_t>(c) * 9 + k) * O + o])
              : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int cc = 0; cc < kCC; ++cc) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xv[kPX + 2];
#pragma unroll
        for (int i = 0; i < kPX + 2; ++i) xv[i] = patch[cc][row + dy][col0 + i];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wp =
              reinterpret_cast<const float4*>(&wsm[cc][dy * 3 + dx][tn * kOC]);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[kOC] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < kPX; ++i)
#pragma unroll
            for (int j = 0; j < kOC; ++j)
              acc[i][j] = fmaf(xv[i + dx], wv[j], acc[i][j]);
        }
      }
    }
  }

  const int oy = oy0 + row;
  if (oy >= H2) return;
#pragma unroll
  for (int j = 0; j < kOC; ++j) {
    const int o = o0 + tn * kOC + j;
    if (o >= O) break;
    const size_t base = ((static_cast<size_t>(b) * O + o) * H2 + oy) * W2;
#pragma unroll
    for (int i = 0; i < kPX; ++i) {
      const int ox = ox0 + col0 + i;
      if (ox < W2) {
        float v = acc[i][j];
        if (cb != nullptr) v += wut::to_f32(cb[base + ox]);
        if (relu) v = v > 0.f ? v : 0.f;
        out[base + ox] = wut::from_f32<T>(v);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* cb,
                   const void* scale, const void* shift, const void* tap_idx,
                   const void* tap_frac, void* out, int B, int C, int H, int W,
                   int O, int relu, cudaStream_t st) {
  const int tiles_x = (2 * W + kTile - 1) / kTile;
  const int tiles_y = (2 * H + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, (O + kTO - 1) / kTO, B);
  upconv_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(cb), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const int*>(tap_idx),
      static_cast<const float*>(tap_frac), static_cast<T*>(out), C, H, W, O,
      relu, tiles_x);
  return cudaGetLastError();
}

}  // namespace

// x: (B, C, H, W); w: (C, 3, 3, O); cb: (B, O, 2H, 2W) or null; scale, shift:
// (B, C) float32 or both null; tap_idx: int32 [4 * ...], tap_frac: float32
// (see the kernel); out: (B, O, 2H, 2W).  All contiguous.
WUT_API int wut_upconv(int dtype, const void* x, const void* w, const void* cb,
                       const void* scale, const void* shift,
                       const void* tap_idx, const void* tap_frac, void* out,
                       int B, int C, int H, int W, int O, int relu, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == WUT_F32)
    return launch<float>(x, w, cb, scale, shift, tap_idx, tap_frac, out, B, C,
                         H, W, O, relu, st);
  if (dtype == WUT_BF16)
    return launch<__nv_bfloat16>(x, w, cb, scale, shift, tap_idx, tap_frac,
                                 out, B, C, H, W, O, relu, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bfloat16, C a multiple of 16)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kMI = 4, kNI = 4;          // warp tile: 64 pixels x 32 channels
constexpr int kWarps = 8;
constexpr int kTcThreads = kWarps * 32;
constexpr int kS = 3;                    // stages of the weight ring

// Per operand type E (bf16, or float32 taken as split float32): the input
// channels of a chunk, one mma step of k (32 bytes: 16 bf16 or 8 float32),
// and the row stride of patch and weights (plus 16 bytes of padding).
template <typename E>
struct Chunk {
  static constexpr int kKC = wut::Operand<E>::kStep;
  static constexpr int kLDK = kKC + wut::Operand<E>::kPad;
};

// In float32 the weights (9, O, C) are followed by their lo part
// (pack_upconv_weight with split=True: (2, 9, O, C), hi then lo).
template <typename E>
struct Params {
  const E* x;
  const E* w;           // (9, O, C)  [tap][out][in]
  const E* cb;          // (B, O, 2H, 2W) or null
  const float* scale;   // (B, C) or null
  const float* shift;
  const int* tap_idx;
  const float* tap_frac;
  E* out;
  long long total;      // elements of x
  int C, H, W, O, relu;
  int TH, TW, tiles_x;
  int wgn;              // warps along N (32 channels each); 8 / wgn along M
  int LH, RS;           // rows and row stride of the staged low-res region
  int off_mod, off_patch, off_raw, off_w;   // byte offsets in shared memory
};

// two blocks an SM in bf16; one in float32, whose split fragments need the
// registers
template <typename E>
__global__ void __launch_bounds__(kTcThreads,
                                  wut::Operand<E>::kSplit ? 1 : 2)
upconv_tc_kernel(const Params<E> p) {
  using Op = wut::Operand<E>;
  constexpr int ES = sizeof(E);
  constexpr int kKC = Chunk<E>::kKC, kLDK = Chunk<E>::kLDK;
  constexpr int kParts = Op::kSplit ? 2 : 1;   // hi, and in float32 lo
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int C = p.C, H = p.H, W = p.W, O = p.O, TH = p.TH, TW = p.TW;
  const int HW = H * W, H2 = 2 * H, W2 = 2 * W;
  const int PW = TW + 2;                     // patch width
  const int NPOS = (TH + 2) * PW;            // patch positions
  const int M = TH * TW;                     // = (8 / wgn) * kMI * 16
  const int NB = p.wgn * 32;
  const int LH = p.LH, RS = p.RS;

  int* posi = reinterpret_cast<int*>(smem);               // [NPOS] tap rows/cols
  float2* posf = reinterpret_cast<float2*>(smem + ((NPOS * 4 + 7) & ~7));
  float2* smod = reinterpret_cast<float2*>(smem + p.off_mod);     // [C]
  E* patch = reinterpret_cast<E*>(smem + p.off_patch);      // [2][NPOS][kLDK]
  E* rawb = reinterpret_cast<E*>(smem + p.off_raw);         // [2][kKC][LH][RS]
  float* ostage = reinterpret_cast<float*>(smem + p.off_patch);   // [NB][M + 4]
  const int patch_buf = NPOS * kLDK;                      // elements
  const int raw_slot = kKC * LH * RS;
  const int w_part = 3 * NB * kLDK;       // one part of a ring slot
  const int w_slot = kParts * w_part;
  const uint32_t b_lo = static_cast<uint32_t>(w_part * ES);
  const uint32_t patch_addr = wut::smem_u32(patch);
  const uint32_t raw_addr = wut::smem_u32(rawb);
  const uint32_t w_addr = wut::smem_u32(smem + p.off_w);

  // tap tables: [i0 rows (2H) | i1 rows (2H) | i0 cols (2W) | i1 cols (2W)],
  // fractions [rows (2H) | cols (2W)]
  const int* h_i0 = p.tap_idx;
  const int* h_i1 = p.tap_idx + H2;
  const int* w_i0 = p.tap_idx + 2 * H2;
  const int* w_i1 = w_i0 + W2;
  const float* h_f = p.tap_frac;
  const float* w_f = p.tap_frac + H2;

  const int oy0 = (blockIdx.x / p.tiles_x) * TH;
  const int ox0 = (blockIdx.x % p.tiles_x) * TW;
  const int n0 = blockIdx.y * NB;
  const int b = blockIdx.z;
  const long long plane_b = static_cast<long long>(b) * C * HW;

  // the low-res region under the patch
  const int ya = oy0 > 0 ? oy0 - 1 : 0, yb = oy0 + TH < H2 ? oy0 + TH : H2 - 1;
  const int xa = ox0 > 0 ? ox0 - 1 : 0, xb = ox0 + TW < W2 ? ox0 + TW : W2 - 1;
  const int ly0 = h_i0[ya], lx0 = w_i0[xa];
  const int nrows = h_i1[yb] - ly0 + 1, ncols = w_i1[xb] - lx0 + 1;

  // once per block: per-position taps, the modulation, zeroed patch buffers
  // (positions outside the image are never written: zero after modulation)
  for (int pos = tid; pos < NPOS; pos += kTcThreads) {
    const int pr = pos / PW, pc = pos - pr * PW;
    const int yy = oy0 - 1 + pr, xx = ox0 - 1 + pc;
    int e = -1;
    float2 f = make_float2(0.f, 0.f);
    if (yy >= 0 && yy < H2 && xx >= 0 && xx < W2) {
      e = (h_i0[yy] - ly0) | ((h_i1[yy] - ly0) << 8) |
          ((w_i0[xx] - lx0) << 16) | ((w_i1[xx] - lx0) << 24);
      f = make_float2(h_f[yy], w_f[xx]);
    }
    posi[pos] = e;
    posf[pos] = f;
  }
  for (int c = tid; c < C; c += kTcThreads)
    smod[c] = p.scale != nullptr
                  ? make_float2(p.scale[static_cast<size_t>(b) * C + c],
                                p.shift[static_cast<size_t>(b) * C + c])
                  : make_float2(1.f, 0.f);
  for (int i = tid; i < 2 * patch_buf * ES / 4; i += kTcThreads)   // 2 buffers
    reinterpret_cast<uint32_t*>(patch)[i] = 0u;

  const int wn = warp % p.wgn, wm = warp / p.wgn;
  float acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  // tap (0, 0) of each of this lane's pixels
  uint32_t a_row[kMI];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
    const int m = (wm * kMI + mi) * 16 + wut::a_lane_row(lane);
    a_row[mi] = patch_addr + ((m / TW) * PW + m % TW) * kLDK * ES +
                wut::a_lane_k(lane) * 2;
  }
  const uint32_t b_lane =
      (wn * 32 + wut::b_lane_row(lane)) * kLDK * ES + wut::b_lane_k(lane) * 2;
  constexpr uint32_t kBPair = 16 * kLDK * ES;

  const int nchunks = C / kKC;
  const int nunits = 3 * nchunks;           // a unit: one row of taps of a chunk

  auto fetch_raw = [&](int k) {
    wut::stage_rows_async<E>(raw_addr + (k & 1) * raw_slot * ES, p.x, p.total,
                          plane_b + static_cast<long long>(k) * kKC * HW, HW,
                          W, kKC, ly0, nrows, lx0, ncols, LH, RS, tid,
                          kTcThreads);
  };
  auto fetch_w = [&](int u) {
    const int k = u / 3, dy = u - 3 * k;
    const uint32_t dst = w_addr + (u % kS) * w_slot * ES;
    constexpr int kP = Op::kPiece;
    // two 16-byte pieces a row, a part after the other
    for (int i = tid; i < kParts * 3 * NB * 2; i += kTcThreads) {
      const int pc = i & 1, row = (i >> 1) % (3 * NB);   // dx * NB + n
      const int part = (i >> 1) / (3 * NB);
      const int dx = row / NB, n = row - dx * NB;
      const bool ok = n0 + n < O;
      const E* src =
          ok ? p.w + static_cast<size_t>(part) * 9 * O * C +
                   (static_cast<size_t>(dy * 3 + dx) * O + n0 + n) * C +
                   k * kKC + pc * kP
             : p.w;
      wut::cp_async16(dst + part * b_lo + (row * kLDK + pc * kP) * ES, src,
                      ok ? 16 : 0);
    }
  };
  // chunk k: staged low-res rows -> modulated, upsampled patch [position][c]
  // kG warps across the chunk's channels (8 each, two a thread), the others
  // across the positions
  constexpr int kG = kKC / 8;
  auto build = [&](int k) {
    const int kk = (warp % kG) * 8 + 2 * (lane & 3);
    const int c = k * kKC + kk;
    const float2 m0 = smod[c], m1 = smod[c + 1];
    const unsigned pl0 =
        static_cast<unsigned>(plane_b) + static_cast<unsigned>(c) * HW;
    const unsigned pl1 = pl0 + HW;
    const E* r0 = rawb + (k & 1) * raw_slot + kk * LH * RS;
    const E* r1 = r0 + LH * RS;
    E* dst = patch + (k & 1) * patch_buf + kk;
    for (int pg = warp / kG; pg * 8 < NPOS; pg += kWarps / kG) {
      const int pos = pg * 8 + (lane >> 2);
      if (pos >= NPOS) continue;
      const int e = posi[pos];
      if (e < 0) continue;
      const float2 f = posf[pos];
      const int j0 = e & 255, j1 = (e >> 8) & 255;
      const int q0 = (e >> 16) & 255, q1 = (e >> 24) & 255;
      float v[2];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const E* r = ch ? r1 : r0;
        const unsigned pl = ch ? pl1 : pl0;
        const float2 md = ch ? m1 : m0;
        const E* ra = r + j0 * RS + wut::raw_phase<E>(pl, ly0 + j0, W, lx0);
        const E* rb = r + j1 * RS + wut::raw_phase<E>(pl, ly0 + j1, W, lx0);
        const float a00 = wut::to_f32(ra[q0]) * md.x + md.y;
        const float a01 = wut::to_f32(ra[q1]) * md.x + md.y;
        const float a10 = wut::to_f32(rb[q0]) * md.x + md.y;
        const float a11 = wut::to_f32(rb[q1]) * md.x + md.y;
        v[ch] = (1.f - f.x) * ((1.f - f.y) * a00 + f.y * a01) +
                f.x * ((1.f - f.y) * a10 + f.y * a11);
      }
      // rounded once to bf16, or kept in float32 (split on the A fragment)
      if constexpr (Op::kSplit)
        *reinterpret_cast<float2*>(dst + pos * kLDK) = make_float2(v[0], v[1]);
      else
        *reinterpret_cast<uint32_t*>(dst + pos * kLDK) =
            wut::pack_bf16x2(v[0], v[1]);
    }
  };

  // prologue: low-res rows of chunk 0, then weight units 0 and 1 (the rows of
  // chunk 1 ride with unit 0), then the patch of chunk 0
  __syncthreads();
  fetch_raw(0);
  wut::cp_async_commit();
  fetch_w(0);
  if (nchunks > 1) fetch_raw(1);
  wut::cp_async_commit();
  if (nunits > 1) fetch_w(1);
  wut::cp_async_commit();
  wut::cp_async_wait<2>();
  __syncthreads();
  build(0);
  for (int u = 0; u < nunits; ++u) {
    const int k = u / 3, dy = u - 3 * k;
    // unit u has landed (and with it whatever rode on earlier groups), the
    // last patch build is visible, everybody is done with unit u - 1
    wut::cp_async_wait<kS - 2>();
    __syncthreads();
    if (u + 2 < nunits) {
      fetch_w(u + 2);
      // the first unit of chunk k' carries the low-res rows of chunk k' + 1
      if ((u + 2) % 3 == 0 && (u + 2) / 3 + 1 < nchunks)
        fetch_raw((u + 2) / 3 + 1);
    }
    wut::cp_async_commit();
    if (dy == 0 && k + 1 < nchunks) build(k + 1);
    const uint32_t wb = w_addr + (u % kS) * w_slot * ES + b_lane;
    const uint32_t ab = (k & 1) * patch_buf * ES + dy * PW * kLDK * ES;
    // the fragments of tap dx + 1 are loaded before the products of tap dx
    if constexpr (!Op::kSplit) {
      wut::Frags<kMI, kNI> f[2];
      wut::load_frags(f[0], a_row, ab, kMI, wb, kBPair);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (dx < 2)
          wut::load_frags(f[(dx + 1) & 1], a_row, ab + (dx + 1) * kLDK * ES,
                          kMI, wb + (dx + 1) * NB * kLDK * ES, kBPair);
        wut::mma_frags(acc, f[dx & 1], kMI);
      }
    } else {
      wut::Frags3<kMI, kNI> f[2];
      wut::load_frags3(f[0], a_row, ab, kMI, wb, kBPair, b_lo);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (dx < 2)
          wut::load_frags3(f[(dx + 1) & 1], a_row, ab + (dx + 1) * kLDK * ES,
                           kMI, wb + (dx + 1) * NB * kLDK * ES, kBPair, b_lo);
        wut::mma_frags3(acc, f[dx & 1], kMI);
      }
    }
  }

  // epilogue: float32 sums -> stage [channel][pixel] (the rings are dead),
  // then + cb, ReLU and a coalesced store of two pixels a thread
  const int LDO = M + 4;
  __syncthreads();
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int nl = wn * 32 + ni * 8 + 2 * tig;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (wm * kMI + mi) * 16 + g + half * 8;
        ostage[nl * LDO + m] = acc[mi][ni][half * 2];
        ostage[(nl + 1) * LDO + m] = acc[mi][ni][half * 2 + 1];
      }
  }
  __syncthreads();
  int goff[4];                       // this lane's pixel pairs of the tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 2 * (lane + 32 * i);
    const int yy = oy0 + m / TW, xx = ox0 + m % TW;
    goff[i] = (m < M && yy < H2 && xx < W2) ? yy * W2 + xx : -1;
  }
  const int nvalid = O - n0 < NB ? O - n0 : NB;
  for (int nl = warp; nl < nvalid; nl += kWarps) {
    const size_t base = (static_cast<size_t>(b) * O + n0 + nl) * H2 * W2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (goff[i] < 0) continue;
      float2 v = *reinterpret_cast<const float2*>(
          ostage + nl * LDO + 2 * (lane + 32 * i));
      if constexpr (Op::kSplit) {
        if (p.cb != nullptr) {
          const float2 t =
              *reinterpret_cast<const float2*>(p.cb + base + goff[i]);
          v.x += t.x;
          v.y += t.y;
        }
        if (p.relu) {
          v.x = fmaxf(v.x, 0.f);
          v.y = fmaxf(v.y, 0.f);
        }
        *reinterpret_cast<float2*>(p.out + base + goff[i]) = v;
      } else {
        if (p.cb != nullptr) {
          const __nv_bfloat162 t =
              *reinterpret_cast<const __nv_bfloat162*>(p.cb + base + goff[i]);
          v.x += __low2float(t);
          v.y += __high2float(t);
        }
        if (p.relu) {
          v.x = fmaxf(v.x, 0.f);
          v.y = fmaxf(v.y, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + base + goff[i]) =
            __floats2bfloat162_rn(v.x, v.y);
      }
    }
  }
}

// x: (B, C, H, W) of E, C a multiple of the chunk (16 bf16, 8 float32); w:
// (9, O, C) as [tap][out][in] (pack_upconv_weight), in float32 (2, 9, O, C),
// hi then lo (split=True); cb, scale, shift, the tap tables and out as for
// wut_upconv.  All contiguous, x 16-byte aligned, cb 8-byte aligned.  The
// plan (kernels/upconv.py::plan_upconv): tile th x tw with tw even and th *
// tw = (8 / wgn) * 64, wgn warps along N, lh rows of rs elements of staged
// low-res x a channel, byte offsets of the shared-memory regions, total
// shared memory.
template <typename E>
int run(const void* x, const void* w, const void* cb, const void* scale,
        const void* shift, const void* tap_idx, const void* tap_frac,
        void* out, int B, int C, int H, int W, int O, int relu, int th,
        int tw, int wgn, int lh, int rs, int off_mod, int off_patch,
        int off_raw, int off_w, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int kKC = Chunk<E>::kKC, kP = wut::Operand<E>::kPiece;
  if (C % kKC || C < kKC || (wgn != 2 && wgn != 4) || tw % 2 ||
      th * tw != (kWarps / wgn) * kMI * 16 || lh < th / 2 + 3 ||
      rs % kP || rs < (tw / 2 + 3 + kP - 1 + kP - 1) / kP * kP ||
      off_mod % 16 || off_patch % 16 || off_raw % 16 || off_w % 16 ||
      B > 65535)
    return cudaErrorInvalidValue;
  Params<E> p;
  p.x = static_cast<const E*>(x);
  p.w = static_cast<const E*>(w);
  p.cb = static_cast<const E*>(cb);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.tap_idx = static_cast<const int*>(tap_idx);
  p.tap_frac = static_cast<const float*>(tap_frac);
  p.out = static_cast<E*>(out);
  p.total = static_cast<long long>(B) * C * H * W;
  p.C = C; p.H = H; p.W = W; p.O = O; p.relu = relu;
  p.TH = th; p.TW = tw;
  p.tiles_x = (2 * W + tw - 1) / tw;
  p.wgn = wgn; p.LH = lh; p.RS = rs;
  p.off_mod = off_mod; p.off_patch = off_patch;
  p.off_raw = off_raw; p.off_w = off_w;
  err = cudaFuncSetAttribute(upconv_tc_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nb = wgn * 32;
  const dim3 grid(p.tiles_x * ((2 * H + th - 1) / th), (O + nb - 1) / nb, B);
  upconv_tc_kernel<E><<<grid, kTcThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// The tensor-core kernels (tc::run): bfloat16, and float32 as split float32
// (three TF32 mmas a product).
WUT_API int wut_upconv_tc(const void* x, const void* w, const void* cb,
                          const void* scale, const void* shift,
                          const void* tap_idx, const void* tap_frac, void* out,
                          int B, int C, int H, int W, int O, int relu, int th,
                          int tw, int wgn, int lh, int rs, int off_mod,
                          int off_patch, int off_raw, int off_w, int smem,
                          int device, void* stream) {
  return tc::run<tc::bf16>(x, w, cb, scale, shift, tap_idx, tap_frac, out, B,
                           C, H, W, O, relu, th, tw, wgn, lh, rs, off_mod,
                           off_patch, off_raw, off_w, smem, device, stream);
}
WUT_API int wut_upconv_tc_f32(const void* x, const void* w, const void* cb,
                              const void* scale, const void* shift,
                              const void* tap_idx, const void* tap_frac,
                              void* out, int B, int C, int H, int W, int O,
                              int relu, int th, int tw, int wgn, int lh,
                              int rs, int off_mod, int off_patch, int off_raw,
                              int off_w, int smem, int device, void* stream) {
  return tc::run<float>(x, w, cb, scale, shift, tap_idx, tap_frac, out, B, C,
                        H, W, O, relu, th, tw, wgn, lh, rs, off_mod,
                        off_patch, off_raw, off_w, smem, device, stream);
}
