#!/usr/bin/env python3
"""Peak rate of `mma.sync.m16n8k16` (bf16 operands, f32 accumulators) on this
GPU, measured from registers: no shared or global memory in the loop.

    python3 tools/bench_mma_rate.py

Every SM runs `warps` warps, each issuing `tiles` independent accumulator
tiles per loop step from the repo's own wrapper
(`weather_unet_tpu_torch/csrc/wut_mma.cuh::mma_bf16_16816`).  Prints one JSON
line per (warps per SM, independent tiles) with the TFLOP/s reached, after the
card's name and power limit.  It is the yardstick for K3's and K4's
tensor-core kernels, which use the same instruction.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SRC = r'''
#include "wut_kernels.h"
#include "wut_mma.cuh"
template <int T>
__global__ void rate_kernel(float* out, int iters, unsigned seed) {
  float acc[T][4];
  uint32_t a[4], b0 = seed + threadIdx.x, b1 = seed * 3 + threadIdx.x;
  for (int i = 0; i < 4; ++i) a[i] = seed + i + threadIdx.x;
  for (int t = 0; t < T; ++t)
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < T; ++t) wut::mma_bf16_16816(acc[t], a, b0, b1);
  }
  float s = 0.f;
  for (int t = 0; t < T; ++t)
    for (int e = 0; e < 4; ++e) s += acc[t][e];
  if (s == 12345.678f) out[0] = s;
}
WUT_API int rate_launch(int tiles, int blocks, int threads, float* out,
                        int iters) {
  if (tiles == 4) rate_kernel<4><<<blocks, threads>>>(out, iters, 1u);
  else if (tiles == 8) rate_kernel<8><<<blocks, threads>>>(out, iters, 1u);
  else if (tiles == 24) rate_kernel<24><<<blocks, threads>>>(out, iters, 1u);
  else return 1;
  return cudaGetLastError();
}
'''


def main():
    from weather_unet_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("bench_mma_rate: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "rate.cu", Path(tmp) / "rate.so"
        cu.write_text(SRC)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                       capture_output=True)
        fn = ctypes.CDLL(str(so)).rate_launch
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
        out = torch.zeros(1, device="cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        iters = 20000
        for warps in (4, 8, 16):
            for tiles in (4, 8, 24):
                def run():
                    assert fn(tiles, sms, 32 * warps, out.data_ptr(),
                              iters) == 0
                run()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                run()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                flops = 4096.0 * tiles * iters * warps * sms
                print(json.dumps({"warps_per_sm": warps,
                                  "independent_tiles": tiles, "ms": ms,
                                  "tflops": flops / ms / 1e9}), flush=True)


if __name__ == "__main__":
    main()
