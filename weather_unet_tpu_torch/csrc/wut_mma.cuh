// Tensor-core and asynchronous-copy building blocks shared by the Hopper
// redesigns of K4 (bottleneck.cu) and K3 (upconv.cu).  Device code only; no
// library is involved: the PTX below is all there is.
//
//   * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 operands,
//     float32 accumulators, one warp per instruction.
//   * ldmatrix.x4: four 8x8 bf16 matrices per instruction, in exactly the
//     register layout the mma wants.  Both operands are kept in shared memory
//     with the reduction index K contiguous: A as [row m][k], B as [column n]
//     [k] (the "col" operand), so neither needs .trans.
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

// Rows of an NCHW bf16 tensor "as they lie": for channels kk in [0, kc) of
// the planes starting at element plane0 (= (b * C + c0) * H * W), rows
// [ylo, ylo + nrows) and columns [xlo, xlo + ncols) (all inside the image),
// copy the 16-byte aligned pieces that cover each row segment to
//     raw[(kk * rows_alloc + j) * rs + ...]        (j = row - ylo)
// Element (row, col) then sits at offset raw_phase(...) + (col - xlo) of its
// row: the segment's misalignment differs from row to row when W is not a
// multiple of 8.  rs >= round_up(ncols + 7, 8).  Pieces that would read past
// the end of the tensor (total elements) are cut short and zero-filled.
__device__ __forceinline__ void stage_rows_async(
    uint32_t raw, const __nv_bfloat16* x, long long total, long long plane0,
    int HW, int W, int kc, int ylo, int nrows, int xlo, int ncols,
    int rows_alloc, int rs, int tid, int nthreads) {
  const int pieces = rs >> 3;
  const int items = kc * nrows * pieces;
  for (int i = tid; i < items; i += nthreads) {
    const int pc = i % pieces;
    const int t = i / pieces;
    const int j = t % nrows;
    const int kk = t / nrows;
    const long long g0 = plane0 + static_cast<long long>(kk) * HW +
                         static_cast<long long>(ylo + j) * W + xlo;
    const long long ga = (g0 & ~7LL) + 8 * pc;
    if (ga < g0 + ncols) {
      const long long left = total - ga;
      const int bytes = left >= 8 ? 16 : static_cast<int>(left) * 2;
      cp_async16(raw + ((kk * rows_alloc + j) * rs + 8 * pc) * 2, x + ga,
                 bytes);
    }
  }
}
// misalignment (0..7 elements) of the row segment staged by stage_rows_async;
// plane_lo = low bits of plane0 + kk * HW
__device__ __forceinline__ int raw_phase(unsigned plane_lo, int row, int W,
                                         int xlo) {
  return static_cast<int>((plane_lo + static_cast<unsigned>(row) * W + xlo) &
                          7u);
}

}  // namespace wut
