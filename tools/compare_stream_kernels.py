#!/usr/bin/env python3
"""K1 (AdaIN) and K2 (2x upsample): an earlier version of their CUDA sources
against the current one, on one GPU, in turns old, new, new, old.

    python3 tools/compare_stream_kernels.py --old DIR [--reps 20]
        [--bitwise | --split]

DIR holds the earlier ``adain.cu``, ``upsample.cu`` and ``wut_kernels.h``
with the plain C interface they had before plans (``wut_adain(dtype, x,
y_scale, y_mean, out, planes, hw, eps, device, stream)``, ``wut_upsample2x(
dtype, x, tap_idx, tap_frac, out, planes, H, W, device, stream)``), for
example from git, into a git-ignored directory::

    mkdir -p _chip_tmp/old
    git archive <commit> weather_unet_tpu_torch/csrc \\
        | tar -x -C _chip_tmp/old --strip-components=2

They are built here with the flags of ``kernels/_build.py``.  At the three
decoder sites of the cUNet (B=16, 256x256 input), in float32 and bfloat16,
each version is timed on the device (kernel durations from torch.profiler,
``chip_smoke.device_ms``; the mean of its two turns):
the old K1 kernel alone, the old K1 wrapper (its PyTorch style statistics
and the kernel), the new K1 (one kernel), the old and the new K2.  Prints
the card's name and power limit first, one JSON line per site and dtype,
and a last line with the sums over the three sites.  Needs a CUDA device.

With ``--bitwise`` DIR holds sources with today's C entries ``wut_adain``
and ``wut_upsample2x`` instead (a later commit's), and nothing is timed:
both versions are called through the current wrappers (``adain_kernel``,
``upsample_kernel``) on the same inputs under every plan (``adain_plans``,
``upsample_plans``) at the three sites and an odd shape, float32 and
bfloat16, and one JSON line gives the calls made and those whose outputs
differ in any bit.  Exits 1 if any does.

With ``--split`` DIR holds sources whose ``wut_adain_apply`` takes the
merged statistics (``wut_adain_apply(dtype, x, y_proj, y_dtype, stats,
out, planes, hw, vec, wp, ppb, eps, device, stream)``, before the apply
launch merged the shards' itself).  K1's split pair of each version, at
shard 0 of a 256x256, B=16 forward at degree 2 (``chip_smoke.SPLIT_SITES``)
and an odd shape, float32 and bfloat16: the old pair is its stats launch,
the exchange's stand-in (``torch.stack`` of two shards' statistics), the
plain ``merge_plane_stats`` and its apply launch; the new pair the stats
launch, the stand-in and the merging apply launch.  Their outputs must be
equal bit for bit under every plan (uneven counts); then, at the three
sites, each pair is timed in turns old, new, new, old: device ms of all
its kernels and of K1's two alone (torch.profiler), device kernels a call
and wall ms (CUDA events).  One JSON line a site and dtype, a last line
with the sums over the sites.  Exits 1 if any output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    K1_MODE, SPLIT_SITES, device_ms, kernel_records, per_call, time_ms)

SITES = {"3": (16, 512, 32, 32), "2": (16, 256, 64, 64),
         "1": (16, 128, 128, 128)}


def build_old(src_dir: Path, out_dir: Path) -> dict:
    from weather_unet_tpu_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("adain", "upsample"):
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


def old_entries(libs: dict) -> dict:
    """The pre-plan C entries of ``build_old``'s libraries."""
    fa = libs["adain"].wut_adain
    fa.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fa.restype = ctypes.c_int
    fu = libs["upsample"].wut_upsample2x
    fu.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fu.restype = ctypes.c_int
    return {"adain": fa, "upsample": fu}


def bitwise(libs: dict) -> int:
    """``--bitwise``: the current wrappers over ``libs``' entries against
    themselves over today's, bit for bit; 1 if any call differs."""
    from weather_unet_tpu_torch.kernels import adain as k1, upsample as k2

    current = {k1: k1._entry, k2: k2._entry}
    olds = {}
    for module, lib, name in ((k1, libs["adain"], "wut_adain"),
                              (k2, libs["upsample"], "wut_upsample2x")):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = (module._entry()[1].argtypes,
                                   module._entry()[1].restype)
        olds[module] = (lambda lib, fn: lambda: (lib, fn))(lib, fn)

    def both(module, call):
        module._entry = olds[module]
        try:
            old = call()
        finally:
            module._entry = current[module]
        return old, call()

    g = torch.Generator(device="cuda").manual_seed(0)
    calls, differ = 0, []
    for dt in (torch.float32, torch.bfloat16):
        for b, c, h, w in [*SITES.values(), (2, 8, 5, 7)]:
            x = torch.randn(b, c, h, w, generator=g, device="cuda").to(dt)
            y = torch.randn(b, 4 * c, generator=g, device="cuda").to(dt)
            runs = [("adain", plan, lambda p: k1.adain_kernel(x, y, 1e-5, p),
                     k1) for plan in k1.adain_plans(b, c, h, w, dt)]
            runs += [("upsample", plan, lambda p: k2.upsample_kernel(x, p),
                      k2) for plan in k2.upsample_plans(b, c, h, w, dt)]
            for kind, plan, call, module in runs:
                old, new = both(module, lambda: call(plan))
                calls += 1
                if not torch.equal(old, new):
                    differ.append(f"{kind} {b, c, h, w} {dt} "
                                  f"{plan['name']}")
    torch.cuda.synchronize()
    print(json.dumps({"calls": calls, "differ": differ}), flush=True)
    return 1 if differ else 0


def split(libs: dict, reps: int) -> int:
    """``--split``: K1's split pair over ``libs``' entries against today's
    (module docstring); 1 if any output differs."""
    from weather_unet_tpu_torch.kernels import _build, adain as k1
    from weather_unet_tpu_torch.ops.norm import merge_plane_stats

    lib = libs["adain"]
    old_stats = lib.wut_adain_stats
    old_stats.argtypes = k1._split_entries()[1].argtypes
    old_apply = lib.wut_adain_apply
    old_apply.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_longlong]
                          + [ctypes.c_int] * 3
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    old_stats.restype = old_apply.restype = ctypes.c_int
    eps = 1e-5

    def old_pair(x, y, other, counts, plan):
        b, c, h, w = x.shape
        vec, dev = int(plan["vec"] > 1), x.device.index
        st = _build.stream_of(x)
        stats = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
        assert old_stats(_build.DTYPE_CODES[x.dtype], x.data_ptr(),
                         stats.data_ptr(), b * c, h * w, vec, plan["wp"],
                         plan["ppb"], int(plan["on_chip"]), dev, st) == 0
        merged = merge_plane_stats(torch.stack([stats, other(stats)]),
                                   counts)
        out = torch.empty_like(x)
        assert old_apply(_build.DTYPE_CODES[x.dtype], x.data_ptr(),
                         y.data_ptr(), _build.DTYPE_CODES[y.dtype],
                         merged.data_ptr(), out.data_ptr(), b * c, h * w,
                         vec, plan["wp"], plan["ppb"], eps, dev, st) == 0
        return out

    def new_pair(x, y, other, counts, plan):
        stats = k1.adain_stats_kernel(x, plan)
        return k1.adain_apply_kernel(
            x, y, torch.stack([stats, other(stats)]), counts, eps, plan)

    g = torch.Generator(device="cuda").manual_seed(0)
    calls, differ = 0, []
    sums = {}
    shapes = {**SPLIT_SITES, "odd": (3, 5, 7, 9)}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for site, (b, c, h, w) in shapes.items():
            x = (torch.randn(b, c, h, w, generator=g, device="cuda") * 2
                 + 0.5).to(dt)
            y = torch.randn(b, 4 * c, generator=g, device="cuda").to(dt)
            shift = torch.tensor([0.25, 3.0], device="cuda")

            def uneven(stats):      # a second shard: other values, rows
                return stats * shift

            counts = [h * w, h * w + 2 * w]
            for plan in k1.adain_plans(b, c, h, w, dt):
                calls += 1
                if not torch.equal(old_pair(x, y, uneven, counts, plan),
                                   new_pair(x, y, uneven, counts, plan)):
                    differ.append(f"{site} {dname} {plan['name']}")
            if site == "odd":
                continue
            plan = k1.plan_adain(b, c, h, w, dt)

            def same(stats):        # the timed pair: a shard of the same
                return stats

            pairs = {"old": lambda: old_pair(x, y, same, [h * w] * 2, plan),
                     "new": lambda: new_pair(x, y, same, [h * w] * 2, plan)}
            rec = {"dtype": dname, "site": site, "shape": [b, c, h, w],
                   "turns": []}
            for name in ("old", "new", "new", "old"):
                for _ in range(2):
                    pairs[name]()
                kern = per_call(kernel_records(pairs[name], reps), reps)
                k1_ms = sum(ms for kn, (ms, _) in kern.items()
                            if K1_MODE.search(kn))
                rec["turns"].append({
                    "pair": name, "device_ms": sum(
                        ms for ms, _ in kern.values()),
                    "k1_device_ms": k1_ms,
                    "kernels_a_call": sum(n for _, n in kern.values()),
                    "wall_ms": time_ms(pairs[name], reps)})
            for name in ("old", "new"):
                turns = [t for t in rec["turns"] if t["pair"] == name]
                for key in ("device_ms", "k1_device_ms", "wall_ms"):
                    v = sum(t[key] for t in turns) / 2
                    rec[f"{name}_{key}"] = v
                    sums[f"{dname} {name}_{key}"] = sums.get(
                        f"{dname} {name}_{key}", 0.0) + v
                rec[f"{name}_kernels_a_call"] = turns[0]["kernels_a_call"]
            print(json.dumps(rec), flush=True)
    torch.cuda.synchronize()
    print(json.dumps({"calls": calls, "differ": differ,
                      "sum_over_sites": sums}), flush=True)
    return 1 if differ else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--bitwise", action="store_true",
                    help="DIR has today's C entries: compare bit for bit")
    ap.add_argument("--split", action="store_true",
                    help="DIR's apply launch takes merged statistics: "
                         "K1's split pairs, bit for bit, then timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_stream_kernels: no CUDA device")
    from weather_unet_tpu_torch.kernels import _build
    from weather_unet_tpu_torch.kernels import adain as k1, upsample as k2
    from weather_unet_tpu_torch.ops.norm import _style_stats
    from weather_unet_tpu_torch.ops.resize import _tap_tables

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_old(args.old, ROOT / "_chip_tmp" / "old_build")
    if args.bitwise:
        return bitwise(libs)
    if args.split:
        return split(libs, args.reps)
    old = old_entries(libs)
    _build.build_all()
    eps, dev = 1e-5, torch.device("cuda")

    def old_adain(x, y_scale, y_mean):
        out = torch.empty_like(x)
        b, c, h, w = x.shape
        err = old["adain"](_build.DTYPE_CODES[x.dtype], x.data_ptr(),
                           y_scale.data_ptr(), y_mean.data_ptr(),
                           out.data_ptr(), b * c, h * w, eps, dev.index or 0,
                           _build.stream_of(x))
        assert err == 0, err
        return out

    def old_adain_wrapper(x, y):
        y_mean, y_scale = _style_stats(y, x.shape[0], x.shape[1], eps)
        return old_adain(x, y_scale.contiguous(), y_mean.contiguous())

    def old_upsample(x):
        b, c, h, w = x.shape
        out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=dev)
        idx, frac = _tap_tables(h, w, dev)
        err = old["upsample"](_build.DTYPE_CODES[x.dtype], x.data_ptr(),
                              idx.data_ptr(), frac.data_ptr(), out.data_ptr(),
                              b * c, h, w, dev.index or 0,
                              _build.stream_of(x))
        assert err == 0, err
        return out

    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for site, (b, c, h, w) in SITES.items():
            x = torch.randn(b, c, h, w, generator=gen, device=dev).to(dt)
            y = torch.randn(b, 4 * c, generator=gen, device=dev).to(dt)
            y_mean, y_scale = _style_stats(y, b, c, eps)
            y_scale, y_mean = y_scale.contiguous(), y_mean.contiguous()
            cands = {
                "adain_old_kernel": lambda: old_adain(x, y_scale, y_mean),
                "adain_old_wrapper": lambda: old_adain_wrapper(x, y),
                "adain_new": lambda: k1.adain_fused(x, y),
                "upsample_old": lambda: old_upsample(x),
                "upsample_new": lambda: k2.upsample2x_fused(x)}
            # the versions agree before they are timed
            for a, b_ in (("adain_old_wrapper", "adain_new"),
                          ("upsample_old", "upsample_new")):
                diff = float((cands[a]().float() - cands[b_]().float())
                             .abs().max())
                assert diff <= 2.0 ** -6 * 8, (a, b_, diff)
            rec = {"dtype": dname, "site": site, "shape": [b, c, h, w]}
            for kind, (o, n) in {"adain": ("adain_old_wrapper", "adain_new"),
                                 "upsample": ("upsample_old",
                                              "upsample_new")}.items():
                turns = []
                for name in (o, n, n, o):
                    turns.append((name, device_ms(cands[name], args.reps)))
                rec[kind] = {"turns": turns}
                for name in (o, n):   # the mean of its two turns
                    rec[kind][name] = sum(t for nm, t in turns
                                          if nm == name) / 2
            rec["adain"]["adain_old_kernel"] = device_ms(
                cands["adain_old_kernel"], args.reps)
            rec["adain"]["wall_ms"] = {
                name: time_ms(cands[name]) for name in
                ("adain_old_wrapper", "adain_new")}
            print(json.dumps(rec), flush=True)
            for kind in ("adain", "upsample"):
                for name, v in rec[kind].items():
                    if isinstance(v, float):
                        key = f"{dname} {name}"
                        sums[key] = sums.get(key, 0.0) + v
    print(json.dumps({"sum_over_sites_device_ms": sums}), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
