#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's cUNet serving forward on a GPU.

    python3 tools/profile_torch_serving.py [--batch 16] [--size 256]

For each configuration (plain, use_pallas, fuse_upconv) and dtype (bf16,
f32 with cuDNN's TF32 left at PyTorch's default), runs ``translate`` under
``torch.profiler`` and prints one JSON line: wall ms per forward, the
device's busy share (summed kernel time over wall time), device time by
kind of kernel (each of the port's kernels K1-K4 by its name, conv,
``F.interpolate``'s upsample, layout transpose, ...), and the kernels that
take the most device time, grouped by name.  Seeded random weights.
The first line is the card's name and power limit from nvidia-smi.  Needs a
CUDA device; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


CATEGORIES = (   # first match wins; the port's kernels by their names
    ("layout transpose", ("nchwToNhwc", "nhwcToNchw")),
    ("K1 adain", ("adain_kernel",)),
    ("K2 upsample", ("upsample2x_kernel",)),
    ("K3 upconv", ("upconv_kernel", "upconv_tc_kernel")),
    ("K4 bottleneck", ("bottleneck_kernel", "bottleneck_tc_kernel")),
    ("upsample (F.interpolate)", ("upsample",)),
    ("conv", ("xmma", "implicit_gemm", "conv", "cudnn", "gemm")),
    ("elementwise/reduce", ("elementwise", "reduce", "pool")),
)


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def kernel_rows(prof):
    """(name, device us, calls) of every GPU kernel, most expensive first."""
    rows = []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key, float(us), int(e.count)))
    return sorted(rows, key=lambda r: -r[1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serving: no CUDA device")
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.manual_seed(0)
    sd = ConditionalUNet(5).state_dict()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (args.batch, args.size, args.size,
                                             3)).astype(np.float32)).cuda()
    c = torch.from_numpy(np.eye(5, dtype=np.float32)[
        rng.integers(0, 5, args.batch)]).cuda()
    configs = {"plain": {}, "use_pallas": {"use_pallas": True},
               "fuse_upconv": {"fuse_upconv": True}}
    for dt in (torch.bfloat16, torch.float32):
        for name, kw in configs.items():
            model = ConditionalUNet(5, dtype=dt, **kw)
            model.load_state_dict(sd, strict=True)
            wt = WeatherTransfer(model, device="cuda")
            for _ in range(3):
                wt.translate(x, c)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    wt.translate(x, c)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            rows = kernel_rows(prof)
            busy_us = sum(r[1] for r in rows)
            by_cat = {}
            for k, us, _ in rows:
                by_cat[category(k)] = by_cat.get(category(k), 0.0) + us
            print(json.dumps({
                "config": name, "dtype": str(dt).split(".")[-1],
                "batch": args.batch, "size": args.size,
                "wall_ms_per_forward": wall_us / args.iters / 1e3,
                "device_ms_per_forward": busy_us / args.iters / 1e3,
                "device_busy_share": busy_us / wall_us,
                "category_ms_per_forward": {
                    k: v / args.iters / 1e3 for k, v in sorted(
                        by_cat.items(), key=lambda kv: -kv[1])},
                "top": [{"kernel": k[:90], "ms_per_forward": us / args.iters
                         / 1e3, "share": us / busy_us if busy_us else None,
                         "calls_per_forward": n / args.iters}
                        for k, us, n in rows[:args.top]]}), flush=True)


if __name__ == "__main__":
    main()
