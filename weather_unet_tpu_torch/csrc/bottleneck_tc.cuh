// K4's tensor-core kernel (C and P multiples of 16); see bottleneck.cu for
// what K4 computes and for the design.  This header holds the kernel and its
// launcher as templates on the operand type E (bf16, or float32 taken as
// split float32: three TF32 mmas a product, wut_mma.cuh), on KC, the number
// of reduction values a staged chunk holds, and on whether a cluster shares
// a tile; bottleneck_tc{32,64}.cu (single blocks) and bottleneck_tc{32,64}c.cu
// (clusters) each build one of the four bf16 forms, bottleneck_f32tc16.cu and
// bottleneck_f32tc16c.cu the two float32 forms, into a library of their own,
// so that they compile side by side.
#pragma once

#include <type_traits>

#include "wut_kernels.h"
#include "wut_mma.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

// KC below: the reduction chunk, in bf16 32 or 64 channels (the plan's
// choice: 64 halves the barriers and waits where shared memory has the
// room), in float32 16; a staged chunk's rows are KC + Operand<E>::kPad long
constexpr int kMI = 6;                   // m-tiles a warp at most: 96 rows
constexpr int kMI32 = 4;                 // ... in float32 (registers: each
                                         // fragment is split in two)
constexpr int kNI = 4;                   // n-tiles a warp: 32 columns
constexpr int kWarps = 8;
constexpr int kTcThreads = kWarps * 32;
constexpr int kMaxNT = 256;              // tile pixels at most
constexpr int kPieces = 4;               // 16-byte pieces of a run a lane

// In float32 each weight array is followed by its lo part (pack_bottleneck
// with split=True: (2, P, C) etc., hi then lo), which the kernel streams
// beside the hi part into the same ring slot.
template <typename E>
struct Params {
  const E* x;
  const E* w1;       // (P, C)     [out][in]
  const E* w2;       // (9, P, P)  [tap][out][in]
  const E* w3;       // (C, P)     [out][in]
  const float* b1;
  const float* b2;
  const float* b3;
  E* out;
  long long total;   // elements of x
  int C, P, H, W;
  int TH;            // tile rows; a tile is TH full rows of the image
  int tiles_per_img;
  int S;             // ring stages (3 or 4)
  int RS;            // stride of a staged channel of x, elements
  int CS;            // blocks a cluster: each takes 1/CS of every phase's N
  int wgn12, wgn3;   // warps along N in phases 1-2 and in phase 3
  int offB, offW, offT;   // byte offsets of region B, the weight ring, the
                          // position table
};

__device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// one chunk of weights, rows [n0, n0 + NB) x columns [k0, k0 + KC) of a
// matrix whose rows are ldk long and which starts at element w_off of w, to
// dst [NB][KC + pad]; rows >= nvalid and columns >= kv are zero-filled.
// With KC / P pieces of P elements (16 bytes) a row, thread t copies piece
// t % (KC / P) of every (256 / (KC / P))-th row.
template <typename E, int KC>
__device__ __forceinline__ void fetch_w(uint32_t dst, const E* w, int w_off,
                                        int ldk, int n0, int nvalid, int NB,
                                        int k0, int kv, int tid) {
  constexpr int kP = wut::Operand<E>::kPiece;
  constexpr int kLDK = KC + wut::Operand<E>::kPad, kRowPieces = KC / kP;
  constexpr int kRows = kTcThreads / kRowPieces;     // rows a pass
  const int pcp = (tid % kRowPieces) * kP;
  const bool kok = pcp < kv;
  int n = tid / kRowPieces;
  int off = w_off + (n0 + n) * ldk + k0 + pcp;
  uint32_t d = dst + (n * kLDK + pcp) * sizeof(E);
  for (; n < NB; n += kRows) {
    const bool ok = kok && n < nvalid;
    wut::cp_async16(d, ok ? w + off : w, ok ? 16 : 0);
    off += kRows * ldk;
    d += kRows * kLDK * sizeof(E);
  }
}

// the products of one staged chunk (kv = one or more mma steps of k, up to
// KC values): the fragments of step s + 1 are loaded before the mma of step
// s.  A step is 32 bytes of a row in either form; in float32 the lo part of
// the weights lies b_lo bytes behind the hi part.
template <typename E, int MI, int KC>
__device__ __forceinline__ void mma_chunk(float (&acc)[MI][kNI][4],
                                          const uint32_t (&a_row)[MI],
                                          uint32_t a_off, int mi_cnt,
                                          uint32_t b_row, int kv,
                                          uint32_t b_lo) {
  constexpr int kStep = wut::Operand<E>::kStep;
  constexpr uint32_t kBPair =                        // n-tile pairs
      16 * (KC + wut::Operand<E>::kPad) * sizeof(E);
  const int steps = kv / kStep;
  if constexpr (!wut::Operand<E>::kSplit) {
    wut::Frags<MI, kNI> f[2];
    wut::load_frags(f[0], a_row, a_off, mi_cnt, b_row, kBPair);
#pragma unroll
    for (int ks = 0; ks < KC / kStep; ++ks) {
      if (ks < steps) {
        if (ks + 1 < steps)
          wut::load_frags(f[(ks + 1) & 1], a_row, a_off + (ks + 1) * 32,
                          mi_cnt, b_row + (ks + 1) * 32, kBPair);
        wut::mma_frags(acc, f[ks & 1], mi_cnt);
      }
    }
  } else {
    wut::Frags3<MI, kNI> f[2];
    wut::load_frags3(f[0], a_row, a_off, mi_cnt, b_row, kBPair, b_lo);
#pragma unroll
    for (int ks = 0; ks < KC / kStep; ++ks) {
      if (ks < steps) {
        if (ks + 1 < steps)
          wut::load_frags3(f[(ks + 1) & 1], a_row, a_off + (ks + 1) * 32,
                           mi_cnt, b_row + (ks + 1) * 32, kBPair, b_lo);
        wut::mma_frags3(acc, f[ks & 1], mi_cnt);
      }
    }
  }
}

// out = relu(stage + x) for the n-block's nvalid channels, stage [channel]
// [len] float32; a channel's tile is len consecutive elements of its plane,
// channel 0's from element base of x and out.  VEC elements a thread and
// step (1, or 4 where every run starts 8-byte aligned); four steps' residual
// loads are started before the first store.
template <typename E, int VEC>
__device__ __forceinline__ void store_tile(const float* stage,
                                           const E* __restrict__ x,
                                           E* __restrict__ out,
                                           long long base, int HW, int len,
                                           int nvalid, int tid) {
  const int vpc = len / VEC;                 // steps a channel
  const int q = kTcThreads / vpc, r = kTcThreads % vpc;
  const int total = nvalid * vpc;
  int ch = tid / vpc, e = tid - ch * vpc;
  for (int v = tid; v < total; v += 4 * kTcThreads) {
    long long g[4];
    int so[4];
    float res[4][VEC];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g[j] = base + static_cast<long long>(ch) * HW + e * VEC;
      so[j] = ch * len + e * VEC;
      const bool ok = v + j * kTcThreads < total;
      if constexpr (VEC == 4 && std::is_same_v<E, float>) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) t = *reinterpret_cast<const float4*>(x + g[j]);
        res[j][0] = t.x;
        res[j][1] = t.y;
        res[j][2] = t.z;
        res[j][3] = t.w;
      } else if constexpr (VEC == 4) {
        uint2 t = make_uint2(0u, 0u);
        if (ok) t = *reinterpret_cast<const uint2*>(x + g[j]);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
        res[j][0] = __low2float(lo);
        res[j][1] = __high2float(lo);
        res[j][2] = __low2float(hi);
        res[j][3] = __high2float(hi);
      } else {
        res[j][0] = ok ? wut::to_f32(x[g[j]]) : 0.f;
      }
      ch += q;
      e += r;
      if (e >= vpc) {
        e -= vpc;
        ++ch;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v + j * kTcThreads >= total) continue;
      if constexpr (VEC == 4 && std::is_same_v<E, float>) {
        const float4 sv = *reinterpret_cast<const float4*>(stage + so[j]);
        *reinterpret_cast<float4*>(out + g[j]) =
            make_float4(fmaxf(sv.x + res[j][0], 0.f),
                        fmaxf(sv.y + res[j][1], 0.f),
                        fmaxf(sv.z + res[j][2], 0.f),
                        fmaxf(sv.w + res[j][3], 0.f));
      } else if constexpr (VEC == 4) {
        const float4 sv = *reinterpret_cast<const float4*>(stage + so[j]);
        uint2 t;
        t.x = wut::pack_bf16x2(fmaxf(sv.x + res[j][0], 0.f),
                               fmaxf(sv.y + res[j][1], 0.f));
        t.y = wut::pack_bf16x2(fmaxf(sv.z + res[j][2], 0.f),
                               fmaxf(sv.w + res[j][3], 0.f));
        *reinterpret_cast<uint2*>(out + g[j]) = t;
      } else {
        out[g[j]] = wut::from_f32<E>(fmaxf(stage[so[j]] + res[j][0], 0.f));
      }
    }
  }
}

// CLUSTER = false is the single-block plan (p.CS == 1), compiled without the
// cluster's stores and barriers
template <typename E, int MI, bool CLUSTER, int KC>
__global__ void __launch_bounds__(kTcThreads, 1)
bottleneck_tc_kernel(const Params<E> p) {
  using Op = wut::Operand<E>;
  constexpr int ES = sizeof(E), kP = Op::kPiece;
  constexpr int kKC = KC, kLDK = KC + Op::kPad;
  // weights a ring slot holds: the hi part, and in float32 the lo part
  constexpr int kParts = Op::kSplit ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int C = p.C, P = p.P, H = p.H, W = p.W, TH = p.TH;
  const int HW = H * W;
  const int HW2 = W + 2;                    // halo region width
  const int NH = (TH + 2) * HW2;            // halo region positions
  const int NT = TH * W;                    // tile pixels
  const int MH = (NH + 15) & ~15, MT = (NT + 15) & ~15;
  const int LD1 = P + Op::kPad;             // row stride of t1 and t2
  const int S = p.S, RS = p.RS;

  // region A: t1 [MH][LD1] E; in phase 3 the output stage [NB][NT] f32
  // region B: t2 [MT][LD1] E; in phase 1 the repacked x [2][MH][kLDK] and
  //           the staged x [S][kKC][RS]: a channel's rows of the halo
  //           region as they lie in its plane, one contiguous run
  // region W: the weight ring [S][kParts][NBmax][kLDK]
  // region T: per halo position, where its x lies in a staged channel
  E* t1s = reinterpret_cast<E*>(smem);
  float* ostage = reinterpret_cast<float*>(smem);
  E* t2s = reinterpret_cast<E*>(smem + p.offB);
  E* abuf = t2s;
  E* rawb = abuf + 2 * MH * kLDK;
  int* postab = reinterpret_cast<int*>(smem + p.offT);
  const int raw_slot = kKC * RS;                            // elements
  // one part of a ring slot (elements); the lo part lies b_lo bytes behind
  const int w_part = (p.wgn12 > p.wgn3 ? p.wgn12 : p.wgn3) * 32 * kLDK;
  const int w_slot = kParts * w_part;
  const uint32_t b_lo = static_cast<uint32_t>(w_part * ES);
  const uint32_t t1_addr = wut::smem_u32(t1s);
  const uint32_t t2_addr = wut::smem_u32(t2s);
  const uint32_t abuf_addr = wut::smem_u32(abuf);
  const uint32_t raw_addr = wut::smem_u32(rawb);
  const uint32_t w_addr = wut::smem_u32(smem + p.offW);

  // the CS blocks of a cluster share one tile; block `rank` computes columns
  // [rank * N / CS, (rank + 1) * N / CS) of each phase from its own slice of
  // the weights, and writes its slice of t1 and t2 into every block's shared
  // memory, so that each holds all of t1 and t2 for its next product
  const int CS = CLUSTER ? p.CS : 1;
  const int rank = CLUSTER ? static_cast<int>(wut::cluster_ctarank()) : 0;
  const int tile_id = blockIdx.x / CS;
  const int b = tile_id / p.tiles_per_img;
  const int y0 = (tile_id % p.tiles_per_img) * TH;
  // two values to element `at` of t1 or t2, here and in the cluster's
  // others: rounded to bf16, or float32 as they are (no rounding point)
  auto put2 = [&](E* at, float v0, float v1) {
    if constexpr (Op::kSplit) {
      if constexpr (!CLUSTER) {
        *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
      } else {
        const uint32_t a = wut::smem_u32(at);
        const uint64_t u = static_cast<uint64_t>(__float_as_uint(v1)) << 32 |
                           __float_as_uint(v0);   // v0 at the lower address
        for (int d = 0; d < CS; ++d) wut::st_cluster_u64(a, d, u);
      }
    } else {
      const uint32_t v = wut::pack_bf16x2(v0, v1);
      if constexpr (!CLUSTER) {
        *reinterpret_cast<uint32_t*>(at) = v;
      } else {
        const uint32_t a = wut::smem_u32(at);
        for (int d = 0; d < CS; ++d) wut::st_cluster_u32(a, d, v);
      }
    }
  };
  const long long plane_b = static_cast<long long>(b) * C * HW;
  // the rows of the halo region that lie inside the image
  const int ylo = y0 > 0 ? y0 - 1 : 0;
  const int yhi = y0 + TH + 1 < H ? y0 + TH + 1 : H;
  const int nrows = yhi - ylo;

  // the lanes' ldmatrix offsets: a row, and 0 or 16 bytes along k
  const int a_lr = wut::a_lane_row(lane), a_lkb = wut::a_lane_k(lane) * 2;
  const uint32_t b_lane =
      wut::b_lane_row(lane) * kLDK * ES + wut::b_lane_k(lane) * 2;

  // once per block: the repacked-x buffers start as zeros (positions outside
  // the image are never written, so they multiply as zeros), and for every
  // halo position inside the image its offset in a staged channel's run
  // ((row - ylo) * W + column); the run starts at the channel's misalignment
  // (its first element's offset in x modulo kP: only whole 16-byte pieces
  // are copied)
  for (int i = tid; i < 2 * MH * kLDK * ES / 4; i += kTcThreads)
    reinterpret_cast<uint32_t*>(abuf)[i] = 0u;
  for (int pos = tid; pos < NH; pos += kTcThreads) {
    const int hy = pos / HW2, hx = pos - hy * HW2;
    const int y = y0 - 1 + hy, xx = hx - 1;
    postab[pos] =
        (y >= 0 && y < H && xx >= 0 && xx < W) ? (y - ylo) * W + xx : -1;
  }
  const int run = nrows * W;                 // elements of a channel's run
  const unsigned base_lo =                   // low bits of channel 0's run
      static_cast<unsigned>(plane_b) + static_cast<unsigned>(ylo) * W;
  // every block of the cluster runs before any writes into another
  if constexpr (CLUSTER) wut::cluster_sync();
  // rows [ylo, yhi) of channels [k0, k0 + kv) -> ring slot: a warp takes the
  // channels kk = warp + 8 i, a lane up to kPieces of the 16-byte pieces that
  // cover the channel's run
  auto stage_x = [&](int slot, int k0, int kv) {
    const uint32_t dst0 = raw_addr + slot * raw_slot * ES;
    for (int kk = warp; kk < kv; kk += kWarps) {
      const long long g0 =
          plane_b + static_cast<long long>(k0 + kk) * HW + ylo * W;
      const long long ga0 = g0 & ~static_cast<long long>(kP - 1);
#pragma unroll
      for (int s2 = 0; s2 < kPieces; ++s2) {
        const int pc = lane + 32 * s2;
        const long long ga = ga0 + kP * pc;
        if (ga < g0 + run) {
          const long long left = p.total - ga;
          wut::cp_async16(dst0 + (kk * RS + kP * pc) * ES, p.x + ga,
                          left >= kP ? 16 : static_cast<int>(left) * ES);
        }
      }
    }
  };

  // pipeline of phases 2 and 3, whose A operand already lies in shared
  // memory: chunk ch is multiplied while chunks ch+1 .. ch+S-2 are in flight.
  // fetch() and mma() are called once per chunk, in order, and keep their own
  // position.
  auto kloop = [&](int nchunks, auto&& fetch, auto&& mma) {
    __syncthreads();   // earlier readers of the ring and writers of A are done
    int islot = 0;
    for (int s = 0; s < S - 1; ++s) {
      if (s < nchunks) fetch(islot);
      wut::cp_async_commit();
      islot = islot + 1 == S ? 0 : islot + 1;
    }
    int mslot = 0;
    for (int ch = 0; ch < nchunks; ++ch) {
      wut::cp_async_wait_pending(S - 2);
      __syncthreads();
      // odd warps multiply first and copy after, even warps the other way
      // round: starting the copies stalls on the load/store queue, and this
      // way one half's stall runs beside the other half's products
      if (warp & 1) mma(mslot);
      if (ch + S - 1 < nchunks) fetch(islot);
      wut::cp_async_commit();
      islot = islot + 1 == S ? 0 : islot + 1;
      if (!(warp & 1)) mma(mslot);
      mslot = mslot + 1 == S ? 0 : mslot + 1;
    }
  };

  // ---- phase 1: t1 = relu(x . w1 + b1) on the halo region, 0 outside the
  // image
  {
    const int wgn = p.wgn12, wgm = kWarps / wgn, NB = wgn * 32;
    const int wn = warp % wgn, wm = warp / wgn;
    const int mtiles = MH / 16;
    const int n_mb = ceil_div(mtiles, wgm * MI);
    const int mi_cnt = ceil_div(mtiles, wgm * n_mb);
    const int nchunks = ceil_div(C, kKC);
    // repack: kRG warps across the channels, 8 channels each, this thread's
    // two of every kRG * 8; the other warps across the positions
    constexpr int kRG = (kKC < 32 ? kKC : 32) / 8;
    const int rk0 = (warp % kRG) * 8 + 2 * (lane & 3);
    const int nend = (rank + 1) * (P / CS);
    for (int n0 = rank * (P / CS); n0 < nend; n0 += NB) {
      for (int mb = 0; mb < n_mb; ++mb) {
        const int tile0 = (mb * wgm + wm) * mi_cnt;
        int my_cnt = mtiles - tile0;
        my_cnt = my_cnt < 0 ? 0 : (my_cnt > mi_cnt ? mi_cnt : my_cnt);
        float acc[MI][kNI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
        uint32_t a_row[MI];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)   // unused m-tiles point at tile 0
          a_row[mi] = abuf_addr +
                      ((mi < my_cnt ? tile0 + mi : 0) * 16 + a_lr) * kLDK *
                          ES + a_lkb;
        const int nvalid = nend - n0 < NB ? nend - n0 : NB;

        auto fetch = [&](int ch, int slot) {
          const int k0 = ch * kKC;
          const int kv = C - k0 < kKC ? C - k0 : kKC;
          const uint32_t dst = w_addr + slot * w_slot * ES;
          fetch_w<E, kKC>(dst, p.w1, 0, C, n0, nvalid, NB, k0, kv, tid);
          if constexpr (Op::kSplit)
            fetch_w<E, kKC>(dst + b_lo, p.w1 + P * C, 0, C, n0, nvalid, NB,
                            k0, kv, tid);
          stage_x(slot, k0, kv);
        };
        // staged rows of chunk ch (ring slot) -> abuf[buf] as [position][k]
        auto repack = [&](int ch, int slot, int buf) {
          const int kv = C - ch * kKC < kKC ? C - ch * kKC : kKC;
#pragma unroll
          for (int rk = rk0; rk < kKC; rk += kRG * 8) {
            if (rk >= kv) break;
            // the two channels' runs, each from its misalignment on
            constexpr unsigned kMis = kP - 1;
            const unsigned lo = base_lo + static_cast<unsigned>(rk) * HW;
            const E* r0 = rawb + slot * raw_slot + rk * RS + (lo & kMis);
            const E* r1 = r0 + RS - (lo & kMis) + ((lo + HW) & kMis);
            E* dst = abuf + buf * MH * kLDK + rk;
            for (int pos = (warp / kRG) * 8 + (lane >> 2); pos < NH;
                 pos += (kWarps / kRG) * 8) {
              const int at = postab[pos];
              if (at < 0) continue;
              if constexpr (Op::kSplit) {
                *reinterpret_cast<float2*>(dst + pos * kLDK) =
                    make_float2(r0[at], r1[at]);
              } else {
                const unsigned short v0 =
                    *reinterpret_cast<const unsigned short*>(r0 + at);
                const unsigned short v1 =
                    *reinterpret_cast<const unsigned short*>(r1 + at);
                *reinterpret_cast<uint32_t*>(dst + pos * kLDK) =
                    static_cast<uint32_t>(v0) |
                    (static_cast<uint32_t>(v1) << 16);
              }
            }
          }
        };

        __syncthreads();
        for (int s = 0; s < S - 1; ++s) {
          if (s < nchunks) fetch(s, s);
          wut::cp_async_commit();
        }
        wut::cp_async_wait_pending(S - 2);
        __syncthreads();
        repack(0, 0, 0);
        int islot = S - 1, mslot = 0;
        for (int ch = 0; ch < nchunks; ++ch) {
          // chunk ch+1 has landed (its rows are repacked below), chunk ch's
          // repack is visible, and everybody is done with chunk ch-1
          wut::cp_async_wait_pending(S - 3);
          __syncthreads();
          const int nslot = mslot + 1 == S ? 0 : mslot + 1;
          auto products = [&]() {
            if (my_cnt == 0) return;
            const int kv = C - ch * kKC < kKC ? C - ch * kKC : kKC;
            mma_chunk<E, MI, kKC>(acc, a_row, (ch & 1) * MH * kLDK * ES,
                                  my_cnt,
                                  w_addr + mslot * w_slot * ES +
                                      wn * 32 * kLDK * ES + b_lane,
                                  kv, b_lo);
          };
          if (warp & 1) products();            // see kloop
          if (ch + S - 1 < nchunks) fetch(ch + S - 1, islot);
          wut::cp_async_commit();
          islot = islot + 1 == S ? 0 : islot + 1;
          if (ch + 1 < nchunks) repack(ch + 1, nslot, (ch + 1) & 1);
          if (!(warp & 1)) products();
          mslot = nslot;
        }

        // epilogue: bias, ReLU, zero outside the image and in the padding rows
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if (mi >= my_cnt) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = (tile0 + mi) * 16 + g + half * 8;
            const bool in = m < NH && postab[m < NH ? m : 0] >= 0;
#pragma unroll
            for (int ni = 0; ni < kNI; ++ni) {
              const int n = n0 + wn * 32 + ni * 8 + 2 * tig;
              if (n >= nend) continue;
              const float v0 =
                  in ? fmaxf(acc[mi][ni][half * 2] + p.b1[n], 0.f) : 0.f;
              const float v1 =
                  in ? fmaxf(acc[mi][ni][half * 2 + 1] + p.b1[n + 1], 0.f)
                     : 0.f;
              put2(t1s + m * LD1 + n, v0, v1);
            }
          }
        }
      }
    }
  }

  // every block's slice of t1 is here
  if constexpr (CLUSTER) wut::cluster_sync();

  // ---- phase 2: t2 = relu(conv3x3(t1, w2) + b2) on the tile
  {
    const int wgn = p.wgn12, wgm = kWarps / wgn, NB = wgn * 32;
    const int wn = warp % wgn, wm = warp / wgn;
    const int mtiles = MT / 16;
    const int n_mb = ceil_div(mtiles, wgm * MI);
    const int mi_cnt = ceil_div(mtiles, wgm * n_mb);
    const int nck = ceil_div(P, kKC);
    const int nend = (rank + 1) * (P / CS);
    for (int n0 = rank * (P / CS); n0 < nend; n0 += NB) {
      for (int mb = 0; mb < n_mb; ++mb) {
        const int tile0 = (mb * wgm + wm) * mi_cnt;
        int my_cnt = mtiles - tile0;
        my_cnt = my_cnt < 0 ? 0 : (my_cnt > mi_cnt ? mi_cnt : my_cnt);
        float acc[MI][kNI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
        // tap (0, 0) of each pixel; rows that pad M read position 0 and are
        // never stored to the output
        uint32_t a_row[MI];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int m = (tile0 + mi) * 16 + a_lr;
          const int pos0 = m < NT ? (m / W) * HW2 + m % W : 0;
          a_row[mi] = t1_addr + pos0 * LD1 * ES + a_lkb;
        }
        const int nvalid = nend - n0 < NB ? nend - n0 : NB;
        int i_tap = 0, i_k0 = 0;            // next chunk to fetch
        int m_dy = 0, m_dx = 0, m_k0 = 0;   // next chunk to multiply
        kloop(
            9 * nck,
            [&](int slot) {
              const uint32_t dst = w_addr + slot * w_slot * ES;
              const int kv = P - i_k0 < kKC ? P - i_k0 : kKC;
              fetch_w<E, kKC>(dst, p.w2, i_tap * P * P, P, n0, nvalid, NB,
                              i_k0, kv, tid);
              if constexpr (Op::kSplit)
                fetch_w<E, kKC>(dst + b_lo, p.w2 + 9 * P * P, i_tap * P * P,
                                P, n0, nvalid, NB, i_k0, kv, tid);
              i_k0 += kKC;
              if (i_k0 >= P) {
                i_k0 = 0;
                ++i_tap;
              }
            },
            [&](int slot) {
              if (my_cnt > 0)
                mma_chunk<E, MI, kKC>(
                    acc, a_row, ((m_dy * HW2 + m_dx) * LD1 + m_k0) * ES,
                    my_cnt,
                    w_addr + slot * w_slot * ES + wn * 32 * kLDK * ES +
                        b_lane,
                    P - m_k0 < kKC ? P - m_k0 : kKC, b_lo);
              m_k0 += kKC;
              if (m_k0 >= P) {
                m_k0 = 0;
                if (++m_dx == 3) {
                  m_dx = 0;
                  ++m_dy;
                }
              }
            });
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * tig;
          if (n >= nend) continue;
          const float bias0 = p.b2[n], bias1 = p.b2[n + 1];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            if (mi >= my_cnt) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int m = (tile0 + mi) * 16 + g + half * 8;
              put2(t2s + m * LD1 + n,
                   fmaxf(acc[mi][ni][half * 2] + bias0, 0.f),
                   fmaxf(acc[mi][ni][half * 2 + 1] + bias1, 0.f));
            }
          }
        }
      }
    }
  }

  // every block's slice of t2 is here; no block writes into another after
  // this, so a block may finish while the others still run
  if constexpr (CLUSTER) wut::cluster_sync();

  // ---- phase 3: out = relu(t2 . w3 + b3 + x) on the tile
  {
    const int wgn = p.wgn3, wgm = kWarps / wgn, NB = wgn * 32;
    const int wn = warp % wgn, wm = warp / wgn;
    const int mtiles = MT / 16;
    const int n_mb = ceil_div(mtiles, wgm * MI);
    const int mi_cnt = ceil_div(mtiles, wgm * n_mb);
    const int nck = ceil_div(P, kKC);
    // the tile's rows inside the image: len consecutive elements of a plane
    const int len = (y0 + TH < H ? TH : H - y0) * W;
    const bool vec4 = len % 4 == 0 && HW % 4 == 0 && (y0 * W) % 4 == 0;
    const int nend = (rank + 1) * (C / CS);
    for (int n0 = rank * (C / CS); n0 < nend; n0 += NB) {
      for (int mb = 0; mb < n_mb; ++mb) {
        const int tile0 = (mb * wgm + wm) * mi_cnt;
        int my_cnt = mtiles - tile0;
        my_cnt = my_cnt < 0 ? 0 : (my_cnt > mi_cnt ? mi_cnt : my_cnt);
        float acc[MI][kNI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
        uint32_t a_row[MI];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)   // unused m-tiles point at tile 0
          a_row[mi] = t2_addr +
                      ((mi < my_cnt ? tile0 + mi : 0) * 16 + a_lr) * LD1 *
                          ES + a_lkb;
        const int nvalid = nend - n0 < NB ? nend - n0 : NB;
        int i_k0 = 0, m_k0 = 0;
        kloop(
            nck,
            [&](int slot) {
              const uint32_t dst = w_addr + slot * w_slot * ES;
              const int kv = P - i_k0 < kKC ? P - i_k0 : kKC;
              fetch_w<E, kKC>(dst, p.w3, 0, P, n0, nvalid, NB, i_k0, kv, tid);
              if constexpr (Op::kSplit)
                fetch_w<E, kKC>(dst + b_lo, p.w3 + C * P, 0, P, n0, nvalid,
                                NB, i_k0, kv, tid);
              i_k0 += kKC;
            },
            [&](int slot) {
              if (my_cnt > 0)
                mma_chunk<E, MI, kKC>(
                    acc, a_row, m_k0 * ES, my_cnt,
                    w_addr + slot * w_slot * ES + wn * 32 * kLDK * ES +
                        b_lane,
                    P - m_k0 < kKC ? P - m_k0 : kKC, b_lo);
              m_k0 += kKC;
            });
        // float32 sums + b3 -> the stage [channel][pixel] (t1 is dead by
        // now), laid out as the tile lies in a plane of the output
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const int nl = wn * 32 + ni * 8 + 2 * tig;
          if (n0 + nl >= nend) continue;
          const float bias0 = p.b3[n0 + nl], bias1 = p.b3[n0 + nl + 1];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            if (mi >= my_cnt) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int m = (tile0 + mi) * 16 + g + half * 8;
              if (m >= len) continue;
              ostage[nl * len + m] = acc[mi][ni][half * 2] + bias0;
              ostage[(nl + 1) * len + m] = acc[mi][ni][half * 2 + 1] + bias1;
            }
          }
        }
        if (mb + 1 < n_mb) continue;   // the stage fills over all m-blocks
        __syncthreads();
        const long long base =
            plane_b + static_cast<long long>(n0) * HW + y0 * W;
        if (vec4)
          store_tile<E, 4>(ostage, p.x, p.out, base, HW, len, nvalid, tid);
        else
          store_tile<E, 1>(ostage, p.x, p.out, base, HW, len, nvalid, tid);
      }
    }
  }
}

template <typename E, int MI, int KC, bool CLUSTER>
cudaError_t launch_tc(const Params<E>& p, int blocks, int smem,
                      cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_tc_kernel<E, MI, CLUSTER, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (!CLUSTER) {
    bottleneck_tc_kernel<E, MI, CLUSTER, KC>
        <<<blocks, kTcThreads, smem, st>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.CS);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bottleneck_tc_kernel<E, MI, CLUSTER, KC>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The entry of the tensor-core kernel with operands E and chunks of KC
// values, for clusters (cs > 1) or for single blocks (cs == 1).  x, out:
// (B, C, H, W) of E; bf16: w1 (P, C), w2 (9, P, P) as [tap][out][in], w3
// (C, P); float32: the same, each as (2, ...), its hi and lo parts
// (pack_bottleneck with split=True); b1, b2: (P,), b3: (C,) float32.  All
// contiguous and 16-byte aligned; C and P multiples of 16.  The plan
// (kernels/bottleneck.py::plan_bottleneck): a tile of th full rows (th * W <=
// 256 pixels), cs blocks a cluster that share a tile (1, 2, 4 or 8; C and P
// multiples of 32 * cs), kc = KC reduction values a chunk, ring stages (3 or
// 4), stride rs of a staged channel of x, warps along N in phases 1-2 and 3,
// byte offsets of shared-memory regions B, W and T, total shared memory.
template <typename E, int KC, bool CLUSTER>
int run(const void* x, const void* w1, const void* b1, const void* w2,
        const void* b2, const void* w3, const void* b3, void* out, int B,
        int C, int P, int H, int W, int th, int cs, int kc, int stages, int rs,
        int wgn12, int wgn3, int off_b, int off_w, int off_t, int smem,
        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto pow2_le8 = [](int v) {
    return v == 1 || v == 2 || v == 4 || v == 8;
  };
  constexpr int kP = wut::Operand<E>::kPiece;
  if (C % 16 || P % 16 || th < 1 || th * W > kMaxNT ||
      !pow2_le8(cs) || (cs > 1 && (C % (32 * cs) || P % (32 * cs))) ||
      kc != KC || (cs > 1) != CLUSTER || stages < 3 || stages > 4 ||
      rs % kP || rs < ((th + 2) * W + kP - 1 + kP - 1) / kP * kP ||
      rs / kP > 32 * kPieces || !pow2_le8(wgn12) || !pow2_le8(wgn3) ||
      off_b % 16 || off_w % 16 || off_t % 16)
    return cudaErrorInvalidValue;
  Params<E> p;
  p.x = static_cast<const E*>(x);
  p.w1 = static_cast<const E*>(w1);
  p.w2 = static_cast<const E*>(w2);
  p.w3 = static_cast<const E*>(w3);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.b3 = static_cast<const float*>(b3);
  p.out = static_cast<E*>(out);
  p.total = static_cast<long long>(B) * C * H * W;
  p.C = C; p.P = P; p.H = H; p.W = W;
  p.TH = th;
  p.CS = cs;
  p.tiles_per_img = (H + th - 1) / th;
  p.S = stages; p.RS = rs;
  p.wgn12 = wgn12; p.wgn3 = wgn3;
  p.offB = off_b; p.offW = off_w; p.offT = off_t;
  const long long blocks = static_cast<long long>(B) * p.tiles_per_img * cs;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kMIe = wut::Operand<E>::kSplit ? kMI32 : kMI;
  return launch_tc<E, kMIe, KC, CLUSTER>(p, static_cast<int>(blocks), smem,
                                         st);
}

}  // namespace tc
