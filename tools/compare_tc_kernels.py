#!/usr/bin/env python3
"""K4's (identity bottleneck) and K3's (upsample + conv) bfloat16
tensor-core kernels of an earlier commit's sources against today's, bit for
bit, on one GPU.

    python3 tools/compare_tc_kernels.py DIR

DIR holds an earlier ``csrc/`` (for example ``git archive <commit>
weather_unet_tpu_torch/csrc | tar -x -C DIR --strip-components=2`` into a
git-ignored directory); its ``bottleneck_tc{32,64}{,c}.cu`` and
``upconv.cu`` are built with the flags of ``kernels/_build.py`` and called
through today's wrappers on the same bfloat16 inputs, K4 under every plan at
every site of ``chip_smoke.K4_SITES``, K3 at every site of
``chip_smoke.K3_SITES`` that the rule sends to the tensor cores.  One JSON
line counts the calls and names those whose outputs differ in any bit.
The float32 forms are held to their plain versions and timed by
``chip_smoke.py`` phase ``kernel``.

Prints the card's name and power limit first.  Exits 1 if an output
differs.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    K3_SITES, K4_SITES, random_bottleneck_state)


def build_old(src_dir: Path, out_dir: Path) -> dict:
    from weather_unet_tpu_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    names = [f"bottleneck_tc{kc}{c}" for kc in (32, 64) for c in ("", "c")]
    procs = {}
    for name in names + ["upconv"]:
        so = out_dir / f"old_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
             str(so), str(src_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"old {name}.cu failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def old_entries(libs, k4, k3):
    """``_entry()`` tuples of the two modules with the old tensor-core
    entries in place of today's bfloat16 ones."""
    lib4, fn4, tc4 = k4._entry()
    tc4 = dict(tc4)
    for kc in (32, 64):
        for cluster in (False, True):
            e = libs[f"bottleneck_tc{kc}" + "c" * cluster].wut_bottleneck_tc
            e.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 17
                          + [ctypes.c_void_p])
            e.restype = ctypes.c_int
            tc4[2, kc, cluster] = e
    lib3, fn3, tc3 = k3._entry()
    e = libs["upconv"].wut_upconv_tc
    e.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 17 + [
        ctypes.c_void_p]
    e.restype = ctypes.c_int
    return (lib4, fn4, tc4), (lib3, fn3, {**tc3, 2: e})


def k3_inputs(site, dt, gen):
    b, c, h, w, o = K3_SITES[site]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = randn(b, c, h, w).to(dt)
    wt = (randn(o, c, 3, 3) / (9 * c) ** 0.5).to(dt)
    cb = randn(b, o, 2 * h, 2 * w).to(dt)
    sc = torch.rand(b, c, generator=gen, device="cuda") + 0.5
    sh = randn(b, c)
    return x, wt, cb, sc, sh


def k4_inputs(site, dt, gen):
    from weather_unet_tpu_torch.kernels import bottleneck as k4

    b, c, h, w = K4_SITES[site]
    x = torch.randn(b, c, h, w, generator=gen, device="cuda").to(dt)
    wts = k4.fold_bottleneck(random_bottleneck_state(c, c // 4, gen))
    return x, tuple(a.to(dt) if a.dim() > 1 else a for a in wts)


def bf16_bitwise(old_dir, failures):
    from weather_unet_tpu_torch.kernels import bottleneck as k4
    from weather_unet_tpu_torch.kernels import upconv as k3

    libs = build_old(old_dir, ROOT / "_chip_tmp" / "old_tc_build")
    old4, old3 = old_entries(libs, k4, k3)
    new4, new3 = k4._entry(), k3._entry()
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    calls, differ = 0, []
    try:
        for site, (b, c, h, w) in K4_SITES.items():
            x, wts = k4_inputs(site, dt, gen)
            packed = k4.pack_bottleneck(*wts, dt)
            for plan in k4.bottleneck_plans(b, c, c // 4, h, w):
                outs = []
                for entry in (old4, new4):
                    k4._entry = lambda e=entry: e
                    outs.append(k4.bottleneck_tc_kernel(x, packed, plan))
                calls += 1
                if not torch.equal(outs[0], outs[1]):
                    differ.append(f"bottleneck {site} {plan['name']}")
        for site in K3_SITES:
            x, wt, cb, sc, sh = k3_inputs(site, dt, gen)
            if not k3.takes_tensor_cores(dt, x.shape[1]):
                continue
            outs = []
            for entry in (old3, new3):
                k3._entry = lambda e=entry: e
                outs.append(k3.upconv_kernel(x, wt, cb, sc, sh, True))
            calls += 1
            if not torch.equal(outs[0], outs[1]):
                differ.append(f"upconv {site}")
    finally:
        k4._entry = lambda: new4
        k3._entry = lambda: new3
    print(json.dumps({"bf16_bitwise": {"calls": calls, "differ": differ}}),
          flush=True)
    failures += [f"{d}: bf16 output differs from the old sources"
                 for d in differ]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, help="an earlier commit's csrc/")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_tc_kernels: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    failures = []
    bf16_bitwise(args.old, failures)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
