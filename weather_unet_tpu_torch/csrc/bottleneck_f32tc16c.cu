// K4's tensor-core kernel in float32 (split float32, three TF32 mmas a
// product) with reduction chunks of 16 values, for
// thread block clusters (bottleneck_tc.cuh), as a library of its own.
#include "bottleneck_tc.cuh"

WUT_API int wut_bottleneck_tc(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* w3,
                              const void* b3, void* out, int B, int C, int P,
                              int H, int W, int th, int cs, int kc, int stages,
                              int rs, int wgn12, int wgn3, int off_b,
                              int off_w, int off_t, int smem, int device,
                              void* stream) {
  return tc::run<float, 16, true>(
      x, w1, b1, w2, b2, w3, b3, out, B, C, P, H, W, th, cs, kc, stages, rs,
      wgn12, wgn3, off_b, off_w, off_t, smem, device, stream);
}
