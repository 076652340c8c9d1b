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
// as much, 8 flops per output value; the floor is one read of x and one write
// of out at 3.35 TB/s.  So the design moves each byte once, in 16-byte
// pieces, with few instructions around it.
//
// Design (the block shape is chosen by kernels/upsample.py::plan_upsample):
// - A block owns a strip of `rows` output rows of one plane or, where a whole
//   plane is smaller than the block's share, `pb` whole planes (at the
//   cUNet's 32x32 site an output row is only 64 values).
// - Staging.  The input rows the strip needs (i0 of its first output row to
//   i1 of its last) are one contiguous run of x; the block copies the
//   16-byte pieces that cover it "as it lies" into shared memory (coalesced
//   16-byte loads; the run starts `mis` elements into its first piece).  A
//   piece never leaves the 16-byte granule of a byte of x, so it stays
//   inside x's allocation.
// - Column blend, once per input row.  Each staged input row is blended
//   along its columns into a float32 row of 2W values (hb) in shared memory:
//   a thread keeps its column taps in registers and walks down the rows.
//   Every input row is blended once, however many output rows read it.
// - Row blend and store.  An output row is (1-fy) * hb[i0] + fy * hb[i1]:
//   a thread reads 16-byte pieces of both hb rows and writes 8 bf16 or 4
//   float32 outputs with one 16-byte store.  Rows whose byte length is not a
//   multiple of 16 (bf16 W % 4 != 0, float32 W % 2 != 0) take the scalar
//   path of the same kernel: the same staging and blends, stores of one
//   element.
// Measured and dropped (PERF.md; H100 SXM, 700 W): evict-first stores
// (st.global.cs), though the output (67-268 MB at the cUNet's bf16 sites)
// exceeds the 50 MB L2 and is not read back (as fast in bf16, 6-10% slower in
// float32 than plain stores); hb rows split in halves so that the bf16
// 16-byte reads are free of bank conflicts (no change); persistent blocks
// that copy the next strip with cp.async while they blend the current one
// (slower: 57 registers a thread leave 4 blocks an SM).
// No integer division runs per element: the tables are read once per block
// (row taps into shared memory) or once per thread (column taps).
//
// Row windows (wut_upsample2x_rows): under spatial partitioning a shard
// holds h of the image's rows and writes its 2h rows of the whole image's
// output grid.  Its input is a slab of h + 2 rows (one halo row above and
// below, parallel/spatial.py) and its row taps are the whole image's,
// offset into the slab: the same kernel with Ho = 2h output rows.

#include <cstdint>

#include "wut_kernels.h"

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* x;
  const int* tap_idx;     // [i0 rows (Ho) | i1 rows (Ho) | j0 (2W) | j1 (2W)]
  const float* tap_frac;  // [fy (Ho) | fx (2W)]
  void* out;
  long long planes;
  int H, W;      // input rows and columns of a plane
  int Ho;        // output rows of a plane: 2H, or a row window's 2h
  int rows;      // output rows a block owns (Ho when it owns whole planes)
  int pb;        // planes a block owns (1 unless rows == Ho)
  int strips;    // blocks over one plane's rows: ceil(Ho / rows)
  int off_hb;    // byte offset of the float32 column-blended rows
  int off_taps;  // byte offset of the row taps (3 x rows 32-bit words)
};

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* v);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* v) {
  return make_uint4(
      wut::pack_bf16x2(v[0], v[1]), wut::pack_bf16x2(v[2], v[3]),
      wut::pack_bf16x2(v[4], v[5]), wut::pack_bf16x2(v[6], v[7]));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
upsample2x_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kV = 16 / sizeof(T);  // elements in 16 bytes
  const int H = p.H, W = p.W, H2 = p.Ho, W2 = 2 * W;
  const int* h_i0 = p.tap_idx;
  const int* h_i1 = h_i0 + H2;
  const int* w_i0 = h_i0 + 2 * H2;
  const int* w_i1 = w_i0 + W2;
  const float* h_f = p.tap_frac;
  const float* w_f = h_f + H2;

  const int g = blockIdx.x / p.strips;
  const int strip = blockIdx.x - g * p.strips;
  const long long p0 = static_cast<long long>(g) * p.pb;
  const int np = static_cast<int>(
      min(static_cast<long long>(p.pb), p.planes - p0));
  const int oy0 = strip * p.rows;
  const int ny = min(p.rows, H2 - oy0);
  // staged input rows: ra .. i1 of the last output row (np > 1 only with
  // whole planes: then the run starts at row ra of the first plane and
  // ends at the last plane's i1, every plane H rows apart)
  const int ra = __ldg(h_i0 + oy0);
  const int nr = (np - 1) * H + __ldg(h_i1 + oy0 + ny - 1) - ra + 1;

  // 1. stage the run of x, as it lies, in 16-byte pieces; row taps
  const T* src = static_cast<const T*>(p.x) + (p0 * H + ra) * W;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uint4* s16 = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const int mis = static_cast<int>((a & 15) / sizeof(T));
  const int n16 = (mis + nr * W + kV - 1) / kV;
  uint4* raw16 = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < n16; i += kThreads) raw16[i] = __ldg(s16 + i);
  int* t0 = reinterpret_cast<int*>(smem + p.off_taps);
  int* t1 = t0 + p.rows;
  float* tf = reinterpret_cast<float*>(t1 + p.rows);
  for (int i = threadIdx.x; i < ny; i += kThreads) {
    t0[i] = (__ldg(h_i0 + oy0 + i) - ra) * W2;  // offsets of hb rows
    t1[i] = (__ldg(h_i1 + oy0 + i) - ra) * W2;
    tf[i] = __ldg(h_f + oy0 + i);
  }
  __syncthreads();

  // 2. blend every staged row along its columns into hb (float32)
  const T* raw = reinterpret_cast<const T*>(smem) + mis;
  float* hb = reinterpret_cast<float*>(smem + p.off_hb);
  {
    const int nct = min(W2, kThreads);  // threads across the columns
    const int rstep = kThreads / nct;
    const int tc = threadIdx.x % nct, tr = threadIdx.x / nct;
    if (tr < rstep) {
      for (int ox = tc; ox < W2; ox += nct) {
        const int j0 = __ldg(w_i0 + ox), j1 = __ldg(w_i1 + ox);
        const float fx = __ldg(w_f + ox);
        for (int r = tr; r < nr; r += rstep) {
          const T* row = raw + r * W;
          hb[r * W2 + ox] = (1.f - fx) * wut::to_f32(row[j0])
                            + fx * wut::to_f32(row[j1]);
        }
      }
    }
  }
  __syncthreads();

  // 3. blend rows and store: kVW outputs a thread, one store each
  constexpr int kVW = kVec ? kV : 1;
  const int nseg = W2 / kVW;
  const int nst = min(nseg, kThreads);
  const int sstep = kThreads / nst;
  const int ts = threadIdx.x % nst, trow = threadIdx.x / nst;
  if (trow >= sstep) return;
  T* out = static_cast<T*>(p.out) + (p0 * H2 + oy0) * W2;
  for (int pl = 0; pl < np; ++pl) {
    const float* hbp = hb + pl * H * W2;
    T* op = out + static_cast<long long>(pl) * H2 * W2;
    for (int oy = trow; oy < ny; oy += sstep) {
      const float* top = hbp + t0[oy];
      const float* bot = hbp + t1[oy];
      const float fy = tf[oy];
      T* orow = op + static_cast<long long>(oy) * W2;
      for (int s = ts; s < nseg; s += nst) {
        if constexpr (kVec) {
          float v[kV];
#pragma unroll
          for (int k = 0; k < kV; k += 4) {
            const float4 u = *reinterpret_cast<const float4*>(top + s * kV + k);
            const float4 d = *reinterpret_cast<const float4*>(bot + s * kV + k);
            v[k] = (1.f - fy) * u.x + fy * d.x;
            v[k + 1] = (1.f - fy) * u.y + fy * d.y;
            v[k + 2] = (1.f - fy) * u.z + fy * d.z;
            v[k + 3] = (1.f - fy) * u.w + fy * d.w;
          }
          *reinterpret_cast<uint4*>(orow + s * kV) = pack16<T>(v);
        } else {
          orow[s] = wut::from_f32<T>((1.f - fy) * top[s] + fy * bot[s]);
        }
      }
    }
  }
}

template <typename T, bool kVec>
cudaError_t launch(const Params& p, unsigned grid, int smem, cudaStream_t st) {
  auto kern = upsample2x_kernel<T, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}


}  // namespace

namespace {

cudaError_t run(int dtype, const void* x, const void* tap_idx,
                const void* tap_frac, void* out, long long planes, int H,
                int Ho, int W, int vec, int rows, int pb, int off_hb,
                int off_taps, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows < 1 || pb < 1 || Ho < 1 || (pb > 1 && rows != Ho))
    return cudaErrorInvalidValue;
  const int strips = (Ho + rows - 1) / rows;
  const long long grid = (planes + pb - 1) / pb * strips;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Params p{x, static_cast<const int*>(tap_idx),
                 static_cast<const float*>(tap_frac), out, planes, H, W, Ho,
                 rows, pb, strips, off_hb, off_taps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  if (dtype == WUT_F32)
    return vec ? launch<float, true>(p, g, smem, st)
               : launch<float, false>(p, g, smem, st);
  if (dtype == WUT_BF16)
    return vec ? launch<__nv_bfloat16, true>(p, g, smem, st)
               : launch<__nv_bfloat16, false>(p, g, smem, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (planes = B*C, H, W); tap_idx: int32, tap_frac: float32 (see Params);
// out: (planes, 2H, 2W), all contiguous, out 16-byte aligned when vec.  The
// block shape (rows, pb, off_hb, off_taps, smem) and vec come from
// kernels/upsample.py::plan_upsample.
WUT_API int wut_upsample2x(int dtype, const void* x, const void* tap_idx,
                           const void* tap_frac, void* out, long long planes,
                           int H, int W, int vec, int rows, int pb,
                           int off_hb, int off_taps, int smem, int device,
                           void* stream) {
  return run(dtype, x, tap_idx, tap_frac, out, planes, H, 2 * H, W, vec,
             rows, pb, off_hb, off_taps, smem, device, stream);
}

// The row-window form (spatial partitioning, parallel/spatial.py): x is a
// shard's slab of H = h + 2 rows (its h rows and one halo row above and
// below), out its Ho = 2h rows of the WHOLE image's 2x grid; the row taps
// (Ho of each) index the slab and come from the whole image's tables
// (kernels/upsample.py::_tap_tables with a window).  The kernel is the one
// above: nothing but the output row count and the tables differ.
WUT_API int wut_upsample2x_rows(int dtype, const void* x, const void* tap_idx,
                                const void* tap_frac, void* out,
                                long long planes, int H, int Ho, int W,
                                int vec, int rows, int pb, int off_hb,
                                int off_taps, int smem, int device,
                                void* stream) {
  return run(dtype, x, tap_idx, tap_frac, out, planes, H, Ho, W, vec, rows,
             pb, off_hb, off_taps, smem, device, stream);
}
