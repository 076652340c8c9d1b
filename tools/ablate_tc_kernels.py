#!/usr/bin/env python3
"""What each part of the tensor-core kernels of K3 (csrc/upconv.cu) and K4
(csrc/bottleneck_tc.cuh) costs, on this GPU.

    python3 tools/ablate_tc_kernels.py

The sources ship no switch, so this script cuts a part out of a COPY of a
source (one textual patch per variant, asserted to apply), builds every copy
with the flags of `kernels/_build.py`, and times each at the main-path sites
(B=16, bfloat16; K3 at the cUNet's three decoder sites of a 256x256 input, K4
at one identity block per ResNet-101 layer of a 224x224 input).  A variant's
results are wrong by design; only its time is read: `base - variant` is what
the part costs where nothing else hides it.  Prints the card's name and power
limit, then one JSON line per site with the milliseconds of every variant.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# variant -> [(text in the source, its replacement)]
K3_VARIANTS = {
    "base": [],
    "no_patch_build": [
        ("if (dy == 0 && k + 1 < nchunks) build(k + 1);", ""),
        ("  build(0);\n", "")],
    "no_weight_copies": [
        ("auto fetch_w = [&](int u) {", "auto fetch_w = [&](int u) { return;")],
    "no_lowres_copies": [
        ("auto fetch_raw = [&](int k) {",
         "auto fetch_raw = [&](int k) { return;")],
    "no_products": [("wut::mma_frags(acc, f[dx & 1], kMI);", "")],
}
K4_VARIANTS = {
    "base": [],
    "no_x_staging": [
        ("auto stage_x = [&](int slot, int k0, int kv) {",
         "auto stage_x = [&](int slot, int k0, int kv) { return;"),
        ("auto repack = [&](int ch, int slot, int buf) {",
         "auto repack = [&](int ch, int slot, int buf) { return;")],
    "no_weight_copies": [
        ("int k0, int kv, int tid) {\n  constexpr int kLDK",
         "int k0, int kv, int tid) {\n  return;\n  constexpr int kLDK")],
    "no_products": [
        ("uint32_t b_row, int kv) {\n  constexpr",
         "uint32_t b_row, int kv) {\n  return;\n  constexpr")],
    "no_store": [
        ("store_tile<4>(ostage, p.x, p.out, base, HW, len, nvalid, tid);", ";"),
        ("store_tile<1>(ostage, p.x, p.out, base, HW, len, nvalid, tid);", ";")],
}


def time_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def build(tmp, patched, variants, sources):
    """One directory per variant: `patched` (a file of csrc/) with the
    variant's patches applied, beside copies of `sources` (the .cu files that
    include it, or `patched` itself); one library per (variant, source)."""
    from weather_unet_tpu_torch.kernels import _build

    text = (_build.CSRC / patched).read_text()
    procs = {}
    for name, patches in variants.items():
        src = text
        for old, new in patches:
            if old not in src:
                raise SystemExit(f"{patched}: patch of {name} does not apply")
            src = src.replace(old, new)
        vdir = tmp / f"{Path(patched).stem}_{name}"
        vdir.mkdir()
        (vdir / patched).write_text(src)
        for source in sources:
            if source != patched:
                (vdir / source).write_text((_build.CSRC / source).read_text())
            so = vdir / f"{Path(source).stem}.so"
            procs[name, source] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(vdir), "-I",
                 str(_build.CSRC), "-o", str(so), str(vdir / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, source), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{source} {name}: nvcc failed\n{log}")
        libs.setdefault(name, {})[source] = ctypes.CDLL(str(so))
    return libs


def main():
    from weather_unet_tpu_torch.kernels import bottleneck as k4, upconv as k3
    from weather_unet_tpu_torch.ops.resize import _tap_tables

    if not torch.cuda.is_available():
        raise SystemExit("ablate_tc_kernels: needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        libs3 = build(tmp, "upconv.cu", K3_VARIANTS, ["upconv.cu"])
        libs4 = build(tmp, "bottleneck_tc.cuh", K4_VARIANTS,
                      ["bottleneck_tc32.cu", "bottleneck_tc64.cu",
                       "bottleneck_tc32c.cu", "bottleneck_tc64c.cu"])
        for site, (b, c, h, w, o) in {
                "up3": (16, 512, 32, 32, 256), "up2": (16, 256, 64, 64, 128),
                "up1": (16, 128, 128, 128, 64)}.items():
            x = torch.randn(b, c, h, w, generator=gen, device="cuda").to(dt)
            wp = k3.pack_upconv_weight((torch.randn(
                o, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** .5).to(dt))
            cb = torch.randn(b, o, 2 * h, 2 * w, generator=gen,
                             device="cuda").to(dt)
            sc = torch.rand(b, c, generator=gen, device="cuda") + 0.5
            sh = torch.randn(b, c, generator=gen, device="cuda")
            idx, frac = _tap_tables(h, w, x.device)
            out = torch.empty_like(cb)
            pl = k3.plan_upconv(c, o)
            ms = {}
            for name, lib in libs3.items():
                fn = lib["upconv.cu"].wut_upconv_tc
                fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 17
                               + [ctypes.c_void_p])

                def run():
                    err = fn(x.data_ptr(), wp.data_ptr(), cb.data_ptr(),
                             sc.data_ptr(), sh.data_ptr(), idx.data_ptr(),
                             frac.data_ptr(), out.data_ptr(), b, c, h, w, o, 1,
                             pl["th"], pl["tw"], pl["wgn"], pl["lh"], pl["rs"],
                             pl["off_mod"], pl["off_patch"], pl["off_raw"],
                             pl["off_w"], pl["smem"], 0, stream)
                    assert err == 0, err
                ms[name] = time_ms(run)
            print(json.dumps({"kernel": "upconv", "site": site,
                              "plan": pl["name"], "ms": ms}), flush=True)
        for site, (b, c, h, w) in {
                "layer1": (16, 256, 56, 56), "layer2": (16, 512, 28, 28),
                "layer3": (16, 1024, 14, 14), "layer4": (16, 2048, 7, 7)}.items():
            p = c // 4
            x = torch.randn(b, c, h, w, generator=gen, device="cuda").to(dt)
            pk = k4.pack_bottleneck(
                torch.randn(c, p, generator=gen, device="cuda") / c ** .5,
                torch.rand(p, generator=gen, device="cuda"),
                torch.randn(9, p, p, generator=gen, device="cuda") / (9 * p) ** .5,
                torch.rand(p, generator=gen, device="cuda"),
                torch.randn(p, c, generator=gen, device="cuda") / p ** .5,
                torch.rand(c, generator=gen, device="cuda"), dt)
            out = torch.empty_like(x)
            pl = k4.plan_bottleneck(b, c, p, h, w)
            ms = {}
            for name, lib in libs4.items():
                fn = lib[f"bottleneck_tc{pl['kc']}" + "c" * (pl["cs"] > 1)
                         + ".cu"].wut_bottleneck_tc
                fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 17
                               + [ctypes.c_void_p])

                def run():
                    err = fn(x.data_ptr(), pk.w1.data_ptr(), pk.b1.data_ptr(),
                             pk.w2.data_ptr(), pk.b2.data_ptr(),
                             pk.w3.data_ptr(), pk.b3.data_ptr(), out.data_ptr(),
                             b, c, p, h, w, pl["th"], pl["cs"], pl["kc"],
                             pl["stages"], pl["rs"],
                             pl["wgn12"], pl["wgn3"], pl["off_b"], pl["off_w"],
                             pl["off_t"], pl["smem"], 0, stream)
                    assert err == 0, err
                ms[name] = time_ms(run)
            print(json.dumps({"kernel": "bottleneck", "site": site,
                              "plan": pl["name"], "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
