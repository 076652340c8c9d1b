// Tensor-core and asynchronous-copy building blocks shared by the Hopper
// redesigns of K4 (bottleneck.cu) and K3 (upconv.cu).  Device code only; no
// library is involved: the PTX below is all there is.
//
//   * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 operands,
//     float32 accumulators, one warp per instruction.
//   * float32 operands as split float32 ("3xTF32"): a = hi + lo with
//     hi = tf32(a), lo = tf32(a - hi) (cvt.rna.tf32.f32), which leaves
//     |a - hi - lo| <~ 2^-22 |a|; a product a.b is taken as lo_a.hi_b +
//     hi_a.lo_b + hi_a.hi_b, three mma.sync.aligned.m16n8k8.row.col.f32.tf32
//     .tf32.f32 (each partial product of two 11-bit significands is exact;
//     the dropped lo_a.lo_b is ~2^-22 relative), so each product is within
//     ~2^-21 of the float32 product.  The tensor cores' own float32 sums
//     round toward zero: three mmas a k8 step into one running accumulator
//     drifted the sum by ~2e-5 of max|y| over a 2304-long reduction (an
//     H100, tools/compare_tc_kernels.py), twice float32's bar.  So each k8
//     step's three products go into a fresh accumulator, which is then
//     added to the running float32 sum with a rounded add: the truncation
//     is relative to one step's partial sum, and its sign varies from step
//     to step.
//   * ldmatrix.x4: four 8x8 bf16 matrices per instruction, in exactly the
//     register layout the mma wants.  Both operands are kept in shared memory
//     with the reduction index K contiguous: A as [row m][k], B as [column n]
//     [k] (the "col" operand), so neither needs .trans.  An 8x8 b16 matrix
//     is an 8x4 tile of 32-bit values, and the lane that receives b16
//     elements (r, 2c) and (r, 2c + 1) receives 32-bit element (r, c): the
//     same row addresses give the m16n8k8 tf32 fragments.  One k-step of
//     either mma is 32 bytes of a row (16 bf16 or 8 float32), so a fragment
//     load is the same instruction at the same byte addresses in both forms.
//   * cp.async (16 bytes a thread, commit/wait groups) for the operand rings.
//   * thread block clusters: a cluster barrier and stores into the other
//     blocks' shared memory (distributed shared memory), for K4.
//
// Bank conflicts: every operand row in shared memory is padded by 8 bf16 (16
// bytes), which makes its stride an odd multiple of 16 bytes whenever the
// unpadded row length is a multiple of 16 elements.  The 8 row addresses of
// one 8x8 matrix then fall into 8 different 16-byte slots of a 128-byte
// line, so ldmatrix is conflict-free without a swizzle.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wut {

constexpr int kPad = 8;   // bf16 elements of padding per operand row

// Per operand type E (bf16, or float32 taken as split float32): the row
// padding (16 bytes), the k values of one mma step (32 bytes), and the
// elements of a 16-byte piece.
template <typename E>
struct Operand {
  static constexpr int kPad = 16 / static_cast<int>(sizeof(E));
  static constexpr int kStep = 32 / static_cast<int>(sizeof(E));
  static constexpr int kPiece = 16 / static_cast<int>(sizeof(E));
  static constexpr bool kSplit = sizeof(E) == 4;   // three tf32 products
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes beyond src_bytes (0..16) are
// written as zeros, so src_bytes = 0 is a zero fill (src must still be a
// valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most `pending` (0..2) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending <= 0) cp_async_wait<0>();
  else if (pending == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// float32 -> tf32, rounded to nearest with ties away from zero (the low 13
// bits of the result are 0)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d (16x8, f32) += a (16x8, tf32, row) * b (8x8, tf32, col)
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane offsets of the ldmatrix.x4 row addresses.
//   A tile (16 rows m x 16 k) from [m][k]: matrices (m 0-7, k 0-7), (m 8-15,
//   k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15) = the mma's a0..a3.
//   B pair (16 columns n x 16 k) from [n][k]: matrices (n 0-7, k 0-7), (n 0-7,
//   k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) = b0, b1 of two n-tiles.
__device__ __forceinline__ int a_lane_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_lane_k(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int b_lane_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_lane_k(int lane) {
  return ((lane >> 3) & 1) << 3;
}

// The fragments of one k16 step of a warp tile of MI m-tiles x NI n-tiles
// (16 x 8 each).  Loads and products are separate calls so that the caller
// can start every ldmatrix of a step (or of two steps) before the first mma
// that needs one: the asm statements keep their order, and an mma placed
// right behind its own ldmatrix would wait out the load's latency each time.
template <int MI, int NI>
struct Frags {
  uint32_t a[MI][4];
  uint32_t b[NI / 2][4];
};

// a_row[mi] is this lane's ldmatrix address of m-tile mi (plus a_off, which
// carries the k offset), b_row that of the first n-tile pair; pairs lie
// b_pair bytes apart.  Only the first mi_cnt m-tiles (warp-uniform) are
// loaded.
template <int MI, int NI>
__device__ __forceinline__ void load_frags(Frags<MI, NI>& f,
                                           const uint32_t (&a_row)[MI],
                                           uint32_t a_off, int mi_cnt,
                                           uint32_t b_row, uint32_t b_pair) {
  static_assert(NI % 2 == 0, "n-tiles are loaded in pairs");
#pragma unroll
  for (int nj = 0; nj < NI / 2; ++nj)
    ldmatrix_x4(f.b[nj], b_row + nj * b_pair);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    if (mi < mi_cnt) ldmatrix_x4(f.a[mi], a_row[mi] + a_off);
}

// acc += a * b for the first mi_cnt m-tiles (warp-uniform)
template <int MI, int NI>
__device__ __forceinline__ void mma_frags(float (&acc)[MI][NI][4],
                                          const Frags<MI, NI>& f, int mi_cnt) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (mi < mi_cnt) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mma_bf16_16816(acc[mi][ni], f.a[mi], f.b[ni >> 1][(ni & 1) * 2],
                       f.b[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
}

// The fragments of one k8 step in split float32: A as float32 bits (split in
// registers by mma_frags3, once per m-tile, and reused across the n-tiles),
// B as its hi and lo parts, each loaded from its own copy of the weights
// (packed split on the host), b_lo bytes behind the hi copy.
template <int MI, int NI>
struct Frags3 {
  uint32_t a[MI][4];
  uint32_t bh[NI / 2][4];
  uint32_t bl[NI / 2][4];
};

template <int MI, int NI>
__device__ __forceinline__ void load_frags3(Frags3<MI, NI>& f,
                                            const uint32_t (&a_row)[MI],
                                            uint32_t a_off, int mi_cnt,
                                            uint32_t b_row, uint32_t b_pair,
                                            uint32_t b_lo) {
  static_assert(NI % 2 == 0, "n-tiles are loaded in pairs");
#pragma unroll
  for (int nj = 0; nj < NI / 2; ++nj) {
    ldmatrix_x4(f.bh[nj], b_row + nj * b_pair);
    ldmatrix_x4(f.bl[nj], b_row + b_lo + nj * b_pair);
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    if (mi < mi_cnt) ldmatrix_x4(f.a[mi], a_row[mi] + a_off);
}

// acc += a * b in split float32 for the first mi_cnt m-tiles (warp-uniform):
// lo.hi and hi.lo first, hi.hi last, in this fixed order, into a fresh
// accumulator that a rounded float32 add then puts into acc.  The asm
// statements keep their order, so the three products of a tile are issued
// a pass over the NI n-tiles apart: an mma never waits for the one just
// before it.
template <int MI, int NI>
__device__ __forceinline__ void mma_frags3(float (&acc)[MI][NI][4],
                                           const Frags3<MI, NI>& f,
                                           int mi_cnt) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (mi < mi_cnt) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __uint_as_float(f.a[mi][e]);
        hi[e] = tf32_rna(v);
        lo[e] = tf32_rna(v - __uint_as_float(hi[e]));
      }
      float t[NI][4];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) t[ni][e] = 0.f;
        mma_tf32_1688(t[ni], lo, f.bh[ni >> 1][(ni & 1) * 2],
                      f.bh[ni >> 1][(ni & 1) * 2 + 1]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mma_tf32_1688(t[ni], hi, f.bl[ni >> 1][(ni & 1) * 2],
                      f.bl[ni >> 1][(ni & 1) * 2 + 1]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        mma_tf32_1688(t[ni], hi, f.bh[ni >> 1][(ni & 1) * 2],
                      f.bh[ni >> 1][(ni & 1) * 2 + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += t[ni][e];
      }
    }
  }
}

// Thread block clusters: the rank of this block in its cluster, a barrier
// over all threads of the cluster (release/acquire, so that stores to other
// blocks' shared memory made before it are visible after it), and a 32-bit
// store to the same shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t rank,
                                               uint32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(remote), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster_u64(uint32_t addr, uint32_t rank,
                                               uint64_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.u64 [%0], %1;\n" ::"r"(remote), "l"(v)
               : "memory");
}

// Rows of an NCHW tensor of E (bf16 or float32) "as they lie": for channels
// kk in [0, kc) of the planes starting at element plane0 (= (b * C + c0) * H
// * W), rows [ylo, ylo + nrows) and columns [xlo, xlo + ncols) (all inside
// the image), copy the 16-byte aligned pieces (P = 16 / sizeof(E) elements)
// that cover each row segment to
//     raw[(kk * rows_alloc + j) * rs + ...]        (j = row - ylo)
// Element (row, col) then sits at offset raw_phase<E>(...) + (col - xlo) of
// its row: the segment's misalignment differs from row to row when W is not
// a multiple of P.  rs >= round_up(ncols + P - 1, P).  Pieces that would read
// past the end of the tensor (total elements) are cut short and zero-filled.
template <typename E>
__device__ __forceinline__ void stage_rows_async(
    uint32_t raw, const E* x, long long total, long long plane0, int HW,
    int W, int kc, int ylo, int nrows, int xlo, int ncols, int rows_alloc,
    int rs, int tid, int nthreads) {
  constexpr int kP = Operand<E>::kPiece;
  const int pieces = rs / kP;
  const int items = kc * nrows * pieces;
  for (int i = tid; i < items; i += nthreads) {
    const int pc = i % pieces;
    const int t = i / pieces;
    const int j = t % nrows;
    const int kk = t / nrows;
    const long long g0 = plane0 + static_cast<long long>(kk) * HW +
                         static_cast<long long>(ylo + j) * W + xlo;
    const long long ga = (g0 & ~static_cast<long long>(kP - 1)) + kP * pc;
    if (ga < g0 + ncols) {
      const long long left = total - ga;
      const int bytes = left >= kP ? 16
                                   : static_cast<int>(left * sizeof(E));
      cp_async16(raw + ((kk * rows_alloc + j) * rs + kP * pc) * sizeof(E),
                 x + ga, bytes);
    }
  }
}
// misalignment (0..P-1 elements) of the row segment staged by
// stage_rows_async<E>; plane_lo = low bits of plane0 + kk * HW
template <typename E>
__device__ __forceinline__ int raw_phase(unsigned plane_lo, int row, int W,
                                         int xlo) {
  return static_cast<int>((plane_lo + static_cast<unsigned>(row) * W + xlo) &
                          static_cast<unsigned>(Operand<E>::kPiece - 1));
}

}  // namespace wut
