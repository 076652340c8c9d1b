#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving, estimator and GAN training
paths, of its trainer and training CLI, of its data runtime and supervised
pretraining, of its serving entry points (msgpack checkpoints, the HTTP
server, the inference and eval CLIs), and of FID / IS and the exported
serving artifact, on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printing one JSON line (any failure raises and exits nonzero):

1. env      -- torch/CUDA versions, the card's name and power limit.
2. build    -- compiles csrc/*.cu with nvcc (kernels/_build.py), timed.
3. kernels  -- each kernel against its plain PyTorch version on the card, in
               float32 and bfloat16: K1 (AdaIN), K2 (2x upsample) and K3
               (upsample+conv) at the cUNet's decoder shapes (B=16, 256x256
               input) and one odd shape; K1 also at a plane too large to
               hold on chip (its re-reading path), K2 also at a full-width
               site whose rows are not 16-byte aligned (its scalar path);
               K1 and K2 under every plan (``adain_plans``,
               ``upsample_plans``), each timed on the device at the main
               sites, where each is also asserted (torch.profiler) to run
               exactly one device kernel a call.  K1/K2 records carry three times:
               "ms" the wall time of one wrapper call (CUDA events around
               the Python call, host time included), "device_ms" (=
               "launch_only_ms") the kernel's own duration from
               torch.profiler (CUPTI), "cold_l2_ms" the same while rotating
               among input copies of more than 64 MB (the 50 MB L2 cannot
               hold the input from one call to the next).  K3 in every
               combination of cb /
               scale+shift / relu; K4 (identity bottleneck) at one site per
               ResNet-101 layer (B=16, 224x224 input) and one odd shape,
               with folded weights from random running statistics and
               non-zero biases; one backward per autograd.Function.
               In bfloat16 K3 and K4 run their tensor-core kernels (asserted
               from their counters; the records name the plan that ran and
               the TFLOP/s reached), K4 also once under every other plan
               that fits the site (tile rows x width, "/n" for a cluster of n
               blocks sharing the tile, "k64" for reduction chunks of 64); in
               float32, and at the odd K3 shape, the CUDA-core kernels.
               Tolerances (max abs error):
                 K1, K2 and K4 also at the GAN step's sites (decoder at a
               224x224 input, batch 8; ResNet-101 at batch 8).
               float32:  1e-5 * max(1, max|plain|) -- float32 reassociation
                           over up to 4608 products (TF32 is off here);
                 bfloat16: 2^-6 * max(1, max|plain|) -- the plain chain
                           rounds to bf16 after each op, the kernel once (K4
                           and its plain version round at the same points
                           and differ by the order in which the tensor cores
                           sum, which can move a rounding by one bf16 step).
4. e2e      -- a seeded reference-format .pt bundle loaded through
               WeatherTransfer.load in the plain, use_pallas (K1 + K2) and
               fuse_upconv (K3) configurations; translate and translate_u8 at
               B=16, 256x256.  Asserts 3 launches per forward of each kernel
               of the configuration; float32 kernel configurations within
               MAE 1e-5 of the plain one; bfloat16 within MAE 1e-3 of its own
               float32;
               the plain configuration on the card within MAE 1e-5 of the
               same model on the CPU at a small input.  Prints img/s at B=16
               and batch-1 p50 latency of each configuration, and of the
               float32 ones again with cuDNN's TF32 on (PyTorch's default,
               what float32 serving gets).
5. serve    -- a Batcher(max_batch=16) over the fuse_upconv transfer answers
               24 uint8 224x224 requests from 8 threads, each within 1 uint8
               step of a direct translate_u8.
6. estimator -- a seeded ResNet-101 (random weights, random BatchNorm
               parameters and running statistics) saved as a state-dict .pt
               and loaded through load_estimator; fused_resnet_eval (K4)
               built from the same weights; B=16, 224x224.  Asserts 29 K4
               launches per fused forward, in bfloat16 all 29 of them on the
               tensor cores; float32 fused logits within
               2e-4 * max(1, max|logits|) of the module's eval forward;
               bfloat16 logits (plain and fused) within 0.25 * max(1,
               max|logits|) of the float32 module (bf16 keeps 8 bits
               through 101 layers of a random network), the fused ones no
               further from it than twice the plain ones; the plain module
               on the card within 2e-4 * max(1, max|logits|) of the same
               module on the CPU at 64x64.  Prints img/s of the plain
               forward under torch.inference_mode and with autograd on
               (load_estimator's apply as it is), and of the fused one.
               Then class_transfer_consistency over two batches of 8 at
               224x224 with the use_pallas transfer and the fused
               classifier (K1, K2 and K4 in one path): every prediction in
               range and equal to the plain classifier's except where the
               top two logits are closer than the tolerance.
7. gan      -- the GAN combined step (train/gan.py) at full width: the
               7.8 M-parameter cUNet, the SNDisc and the seeded ResNet-101
               of phase 6 through load_estimator; 224x224, batch 8, est mode
               (GanConfig's defaults), conditions from the estimator.
               The K4-routed estimator's logits (29 K4 launches without
               autograd, none with it) against the plain module's on one
               batch of 8, at phase 6's tolerances.
               Parity at dropout 0: one step from one seed in each of the
               eight configurations (float32 / bfloat16, plain / use_pallas
               generator -- K1 + K2, 6 launches each --, plain / K4-routed
               estimator), compared in pairs that differ in one thing.
               Float32 (TF32 off), use_pallas against plain under each
               route: losses within rel 1e-4; Adam's two moments (the
               gradient and its square) within 1e-4 of the network's
               largest element plus twice the float32 floor (how far the
               plain step's moments move when its images move by one or
               two roundings: G's gradient sums cancel, so ~1e-3 at full
               width); updated parameters within the Adam sign-flip bound
               (fewer than 0.5% of the elements beyond 5e-5, none beyond
               2.2 * lr); u within 1e-4.  The K4 route against the plain
               one (plain generator) to the same bars plus twice
               route_sensitivity (loss_con divides by the distance between
               a sample's two conditions, so the route's condition error
               moves the step by up to its ratio to that distance).
               Bfloat16: use_pallas against the float32 plain generator
               under the same route, no further from it than twice the
               bfloat16 plain generator is, plus 2^-7 (losses; the
               moments' relative L2 error); the K4 route against the plain
               one within that bar plus twice its bfloat16
               route_sensitivity.  The use_pallas step at 32x32, batch 2,
               with a depth-(1, 1, 1, 1) estimator on the card against the
               CPU, to the float32 use_pallas
               bars.  Steady state at
               dropout 0.3 in float32 and bfloat16 (float32 master
               weights), plain and use_pallas generator, plain and
               K4-routed estimator (its stop-gradient forwards through
               fused_resnet_eval, 58 K4 launches a step; the forward on G's
               output through the plain module): 2 warm-up, 5 timed, 1
               D-only and 1 profiled step each, asserting the launches of
               every step (6 K1 + 6 K2 a combined step, 3 + 3 a D-only
               one), finite losses, every u advanced and the step counts.
               Prints the median step ms (host clock around a synchronized
               step), img/s, peak memory, the device time of one step
               (union of its kernels from torch.profiler) over the median
               step, its kernel count and top kernels by device time, and
               the estimator's share (its two stop-gradient
               forwards and the forward + input backward on G's output,
               timed apart).  Then the evaluation step once at batch 8:
               finite metrics, fakes (8, 8, 3, 224, 224), u not moved.
8. train    -- the trainer (train/loops.py) and the est training CLI at
               full width, 224x224, batch 8, the seeded ResNet-101 through
               cli/common.py::load_step_estimator (K4 route in bfloat16, the
               module in float32).  First a line of what the host has
               (Pillow, pandas, TensorBoard, libjpeg).  Then: the trainer's
               first step at float32 (TF32 off), dropout 0, against
               make_gan_step called by hand on the same batches, to phase
               7's float32 bars; the trainer's launches a step (K1 6, K2 6,
               K4 58 in bfloat16 and 0 in float32 a combined step, K1 and
               K2 3 a D-only one); trainer img/s in bfloat16 and float32
               (10 steps over an in-memory BatchLoader) beside the bare
               step timed the same way on batches already on the card and
               beside phase 7's, and the device busy share of 3 profiled
               steps;
               one async checkpoint save (blocking and total ms, file size),
               restored bit for bit, and the export_torch bundle loaded
               through load_transfer (strict).  Where Pillow is present, on
               96 seeded 256x256 JPEGs: the est CLI in --image_only mode
               (bf16, --augmentation, 4 workers, 2 epochs of 8 steps,
               --export_torch) and, with pandas, in frame mode (one epoch,
               evaluation every 4 steps), counting launches and the
               trainer's own img/s windows; the loader alone (HostAugment,
               4 workers) in img/s and whether it keeps up with the bf16
               trainer; and the CLI in a child process stopped by SIGTERM
               once its step-3 checkpoint lands (exit 0, a checkpoint at the
               stop step), then relaunched in this process ("resumed
               from", the fast-forward, a final global step of 2 epochs x
               8).
               Without Pillow, fit() over the in-memory loaders instead.
               One bf16 trainer step with device_augment (both batches
               warped on the card, resized crop and jitter): K1 6, K2 6,
               K4 58, finite losses.
9. supervised -- the native runtime (a line of what the host has: c++,
               jpeglib.h, whether -ljpeg links, the build's mode and
               seconds; the runtime must be built), the decode cache, the
               device augment and supervised pretraining.  The native
               augment against the device augment on the card, same affine
               and factors, 257x257 -> 224x224, 8 images: max abs
               <= 1/255 + 1e-3 (uint8 rounding); the device augment on the
               card against the CPU with the same draws: <= 1e-5.
               augment_batch ms at B=64.  Loader img/s alone (96 seeded
               256x256 JPEGs, 257x257 decode, --augmentation, 4 threads):
               HostAugment, NativeAugment, CachedAugment(NativeAugment)
               filling (epoch 1) and reading (epoch 2, every read a hit).
               train_supervised card vs CPU: a depth-(1, 1, 1, 1) ResNet at
               32x32, B=4, float32, one classifier and one estimator step:
               losses rel 1e-4, BN statistics 1e-5, parameters within the
               Adam sign-flip bound.  The frozen backbone (--pre_trained):
               conv1-layer3 bit-identical after 3 bf16 steps of ResNet-101.
               Full width (ResNet-101, 5 outputs, 42.5 M parameters,
               224x224, B=64), bf16 and float32 (TF32 off), 2 warm-up and 5
               timed steps through train_supervised each: the estimator step
               over in-memory batches, the NativeAugment loader and the
               device warp (augment_cfg), the classifier step in memory;
               step ms (host clock, synchronized after each step), img/s,
               peak memory, and the device busy share (device time of one
               bare in-memory step over the step ms).  The estimator CLI
               on the JPEGs with a pandas frame (--decode_cache
               --augmentation --dtype bf16 -bs 8, 2 epochs of 8 steps),
               then in a child process stopped by SIGTERM after its third
               step and relaunched here ("resumed from", the fast-forward,
               final step 16); the classifier CLI over a class-path split
               (2 steps).  No K1-K4 launch anywhere in the phase.
10. serving_cli -- the serving entry points at full width (the 7.8
               M-parameter cUNet, phase 6's seeded ResNet-101), float32
               with TF32 off unless named, on a world of 32 seeded 256x256
               JPEGs, a Flickr frame over them (16 train, 16 test rows of
               one station) and an i2w split (5 classes x 4 test photos).
               Checkpoints: the cUNet as a reference .pt and as the JAX
               trainer's msgpack GAN layout (the port's flax-free writer),
               the ResNet-101 as a state-dict .pt and as msgpack; the
               state dicts that load_transfer / load_estimator read from
               the two files must be bit-equal; msgpack read ms and MiB.
               The HTTP server (cli/serve.py, 127.0.0.1, --input_size 224
               --max_batch 16, warmup on) on the msgpack file, float32 and
               --bf16: 96 POSTs of the JPEGs from 8 client threads (in a
               child process, off the server's interpreter lock) mixing
               class=<name>, class=<index> and cond=<vector>; every answer
               200, image/jpeg, 224x224; float32 answers within a mean of
               1 uint8 step of the same JPEG encode (quality 95) of the
               direct translate_u8; 400 for a bad cond, 404 for a bad
               route, 403 for /profile without --profile_dir, and with it
               a Chrome trace holding the traffic's kernels; K1 and K2
               launch 3 times per device forward, warmup included.
               Prints requests/s, client p50/p90 ms, the Batcher's
               batch_ms p50/p90 and mean batch size, and the device busy
               share (the same traffic again under torch.profiler).  The
               nine inference and eval CLIs in this process with real argv
               at --input_size 224: each ends without error, writes what
               its JAX counterpart writes and launches K1 and K2 3 times
               per cUNet forward (none in the estimator-only CLIs); prints
               each one's images/s.  inf_transfer_c and
               eval_class_transfer again with --device cpu on a 4-image
               subset: saved pictures within 1 uint8 step of the card's,
               labels equal where the top two logits are more than 1e-3
               apart.
11. eval_export -- FID and IS through Inception-v3 at full width (seeded
               random weights, BatchNorm calibrated on one batch), on two
               directories of 64 seeded 256x256 JPEGs: pool3 features at
               299x299 (resized in the model), batch 50, float32 (TF32 off)
               and bfloat16; the card's float32 features within a relative
               L2 error of 1e-4 of the CPU's (8 images), bfloat16 within
               0.25 of float32; FID finite in both.  Prints img/s (feature
               function and the network alone), peak memory, the device
               busy share of a forward, the host's sqrtm seconds and
               scipy's warnings.  The fid_score CLI over the two
               directories, --save-stats of one and that .npz against the
               other (the same FID to 1e-6), the inception_score CLI (input
               224, batch 32, 10 splits) on a torchvision-layout head; each
               one's images/s; no K1-K4 launch.  Then the use_pallas cUNet
               at full width, 256x256: export_serving --check in float32 and
               bfloat16 (export seconds, artifact MiB, load ms, every tensor
               of the programs on the card), ExportedTransfer at batches 1,
               3 and 16 against the live WeatherTransfer: MAE <= 1e-5
               against the live model in its dtype (the export must not
               change the function), a bfloat16 program no further from
               the live float32 model than the live bfloat16 model is
               (+1e-5; that distance itself is recorded), translate_u8
               within 1 step of the live model in its dtype;
               3 K1 + 3 K2 a program forward (counters, and kernel names
               under torch.profiler), img/s at batch 16 of the artifact and
               the live forward in turns; serve --artifact (float32) answers
               16 POSTs from 4 client threads of a child process (200,
               image/jpeg, within a mean of 1 step of the direct
               translate_u8 through the same encode, 3 K1 + 3 K2 a batch).
12. kernels -- the summary line of every ported kernel (launches on the main
               paths of phases 4-11; error, times and bound over one serving
               forward's sites and, under "gan_step_forward", over one GAN
               generator (K1, K2) or estimator (K4) forward's).

Every phase line carries "t_s", the seconds since the script started.
The last line is {"ok": true, "device": {...}}.  Float32 comparisons run
with TF32 off for cuDNN convs and matmuls (set at the start of the run).
"""

from __future__ import annotations

import contextlib
import copy
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SEED = 0
PEAK_BYTES_PER_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12,              # CUDA cores, no tensor cores
              torch.bfloat16: 989e12}            # tensor cores, dense
TOL_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
DTYPES = (torch.float32, torch.bfloat16)
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

# decoder sites of the cUNet at a 256x256 input, batch 16 (serving), and at
# a 224x224 input, batch 8 (the GAN step, "gan_*")
K1_SITES = {"adain3": (16, 512, 32, 32), "adain2": (16, 256, 64, 64),
            "adain1": (16, 128, 128, 128), "odd": (2, 8, 5, 7),
            "beyond_chip": (2, 8, 256, 256),   # re-reading path
            "gan_adain3": (8, 512, 28, 28), "gan_adain2": (8, 256, 56, 56),
            "gan_adain1": (8, 128, 112, 112)}
K3_SITES = {"up3": (16, 512, 32, 32, 256), "up2": (16, 256, 64, 64, 128),
            "up1": (16, 128, 128, 128, 64), "odd": (2, 8, 5, 7, 4)}
K2_SITES = {"upsample3": (16, 512, 32, 32), "upsample2": (16, 256, 64, 64),
            "upsample1": (16, 128, 128, 128), "odd": (2, 8, 5, 7),
            "unaligned": (16, 128, 128, 127),  # scalar path
            "gan_upsample3": (8, 512, 28, 28),
            "gan_upsample2": (8, 256, 56, 56),
            "gan_upsample1": (8, 128, 112, 112)}
# one identity block per ResNet-101 layer at a 224x224 input, batch 16
# (the estimator phase) and batch 8 (the GAN step's estimator, "gan_*")
K4_SITES = {"layer1": (16, 256, 56, 56), "layer2": (16, 512, 28, 28),
            "layer3": (16, 1024, 14, 14), "layer4": (16, 2048, 7, 7),
            "odd": (2, 64, 5, 7),
            "gan_layer1": (8, 256, 56, 56), "gan_layer2": (8, 512, 28, 28),
            "gan_layer3": (8, 1024, 14, 14), "gan_layer4": (8, 2048, 7, 7)}
# sites of each kernel on its main paths, with their count in one forward:
# serving (and the estimator phase) ...
MAIN_SITES = {"adain": {"adain3": 1, "adain2": 1, "adain1": 1},
              "upsample": {"upsample3": 1, "upsample2": 1, "upsample1": 1},
              "upconv": {"up3": 1, "up2": 1, "up1": 1},
              "bottleneck": {"layer1": 2, "layer2": 3, "layer3": 22,
                             "layer4": 2}}
# ... and the GAN step (K3 does not run in train mode)
GAN_SITES = {"adain": {"gan_adain3": 1, "gan_adain2": 1, "gan_adain1": 1},
             "upsample": {"gan_upsample3": 1, "gan_upsample2": 1,
                          "gan_upsample1": 1},
             "bottleneck": {"gan_layer1": 2, "gan_layer2": 3,
                            "gan_layer3": 22, "gan_layer4": 2}}
LOGIT_TOL = 2e-4      # float32 logits, relative to max(1, max|logits|)
# bfloat16 logits against the float32 module: the seeded random network
# amplifies a rounding error some 300x on its way to the logits (float32's
# 6e-8 arrives as 2e-5), so bfloat16's 2^-9 arrives as O(0.1)
LOGIT_TOL_BF16 = 0.25
START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:      # seconds since the script started
        obj = {**obj, "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
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


def device_kernels(fn, reps: int = 1, tries: int = 5):
    """(names, device ms per call) of the GPU work ``fn`` launches, from the
    kernel durations torch.profiler (CUPTI) records, no host time: per
    kernel name the median duration times its launches a call (rounded, at
    least 1), so a profile that loses some records still counts each
    kernel of the call once.  A profile can also come back with no device
    record at all (seen on the H100 after many profiles in a row); it is
    taken again, up to ``tries`` times.  ([], None) if every one was
    empty."""
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        if by_name:
            ms = sum(float(np.median(us)) * max(1, round(len(us) / reps))
                     for us in by_name.values()) / 1e3
            return [n for n, us in by_name.items() for _ in us], ms
    return [], None


def device_ms(fn, reps: int = 10, warmup: int = 2):
    for _ in range(warmup):
        fn()
    return device_kernels(fn, reps)[1]


def cold_l2_ms(fn, x, reps: int = 10):
    """Device ms of ``fn(x')`` rotating among copies x' of x that hold more
    than 64 MB together, so no call finds its input in the 50 MB L2."""
    copies = [x.clone() for _ in range(min(64, -(-(64 << 20)
                                                 // nbytes(x))))]
    it = itertools.cycle(copies)
    return device_ms(lambda: fn(next(it)), reps=max(reps, len(copies)))


def one_kernel(name, fn, failures, calls: int = 5, tries: int = 5):
    """The device kernels of ``calls`` calls of ``fn``, which must be one
    kernel a call.  A profile can lose records, so a profile passes with
    exactly ``calls`` records of one name, fails outright with a second
    name or more records, and is taken again with fewer."""
    for _ in range(tries):
        names = device_kernels(fn, calls)[0]
        if len(set(names)) > 1 or len(names) > calls:
            break
        if len(names) == calls:
            return names[:1]
    failures.append(f"{name}: {len(names)} device kernels in {calls} calls "
                    f"({sorted(set(names))}), expected 1 a call")
    return names


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: int, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def on_main_path(kernel, site) -> bool:
    return site in MAIN_SITES[kernel] or site in GAN_SITES.get(kernel, {})


def max_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def check(name, err, ref, dtype, failures) -> float:
    tol = TOL_REL[dtype] * max(1.0, float(ref.float().abs().max()))
    if not err <= tol:
        failures.append(f"{name}: max abs err {err} > tol {tol}")
    return tol


def phase_env():
    """Versions and the card; returns nvidia-smi's name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return smi


def phase_build():
    from weather_unet_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        regs = [ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{log.name}: " + " | ".join(regs), file=sys.stderr)
    emit({"phase": "build", "seconds": seconds, "libraries": sorted(libs)})


def phase_kernels():
    """Each kernel against its plain version.  Returns per-kernel, per-dtype
    summaries over the three main-path sites."""
    import torch.nn.functional as F

    from weather_unet_tpu_torch.kernels import (
        adain as k1, bottleneck as k4, upconv as k3, upsample as k2)

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    failures = []
    summary = {"adain": {}, "upsample": {}, "upconv": {}, "bottleneck": {}}
    for dt in DTYPES:
        for site, (b, c, h, w) in K1_SITES.items():
            x, y = randn(b, c, h, w, dtype=dt), randn(b, c * 4, dtype=dt)
            name = f"adain {site} {DT_NAME[dt]}"
            out = k1.adain_fused(x, y)
            ref = k1.adain_fused_ref(x, y)
            err = max_err(out, ref)
            tol = check(name, err, ref, dt, failures)
            main = on_main_path("adain", site)
            plan = k1.plan_adain(b, c, h, w, dt)
            plans = {}
            for pl in k1.adain_plans(b, c, h, w, dt):
                perr = max_err(k1.adain_kernel(x, y, 1e-5, pl), ref)
                check(f"{name} plan {pl['name']}", perr, ref, dt, failures)
                plans[pl["name"]] = {"max_abs_err": perr}
                if main:
                    plans[pl["name"]]["device_ms"] = device_ms(
                        lambda: k1.adain_kernel(x, y, 1e-5, pl), reps=5)
            rec = {"phase": "kernel", "kernel": "adain", "site": site,
                   "dtype": DT_NAME[dt], "shape": [b, c, h, w],
                   "plan": plan["name"], "max_abs_err": err, "tol": tol,
                   "device_kernels_per_call": one_kernel(
                       name, lambda: k1.adain_fused(x, y), failures)
                   if main else None,
                   "ms": time_ms(lambda: k1.adain_fused(x, y)),
                   "device_ms": device_ms(lambda: k1.adain_fused(x, y)),
                   "cold_l2_ms": cold_l2_ms(
                       lambda xx: k1.adain_fused(xx, y), x),
                   "plain_ms": time_ms(lambda: k1.adain_fused_ref(x, y)),
                   "library_ms": None, "plans": plans}
            rec["launch_only_ms"] = rec["device_ms"]
            rec["bound_ms"], rec["bound_by"] = bound(nbytes(x, y, out),
                                                     6.0 * x.numel(), dt)
            emit(rec)
            summary["adain"].setdefault(dt, {})[site] = rec
        for site, (b, c, h, w, o) in K3_SITES.items():
            x = randn(b, c, h, w, dtype=dt)
            wt = (randn(o, c, 3, 3) / (9 * c) ** 0.5).to(dt)
            cb = randn(b, o, 2 * h, 2 * w, dtype=dt)
            sc = torch.rand(b, c, generator=gen, device="cuda") + 0.5
            sh = randn(b, c)
            combos = {}
            for use_cb in (False, True):
                for use_mod in (False, True):
                    for relu in (False, True):
                        kw = dict(cb=cb if use_cb else None,
                                  scale=sc if use_mod else None,
                                  shift=sh if use_mod else None, relu=relu)
                        out = k3.upsample2x_conv3x3(x, wt, **kw)
                        ref = k3.upsample2x_conv3x3_ref(x, wt, **kw)
                        err = max_err(out, ref)
                        key = f"cb={int(use_cb)},mod={int(use_mod)},relu={int(relu)}"
                        check(f"upconv {site} {DT_NAME[dt]} {key}", err, ref,
                              dt, failures)
                        combos[key] = err
            tc_before = k3.tensor_core_launches
            out = k3.upconv_block_fused(x, wt, cb, sc, sh, True)
            on_tc = k3.tensor_core_launches == tc_before + 1
            if on_tc != k3.takes_tensor_cores(dt, c):
                failures.append(f"upconv {site} {DT_NAME[dt]}: tensor cores "
                                f"{on_tc}, the rule says otherwise")
            ref = k3.upconv_block_ref(x, wt, cb, sc, sh, True)
            err = max_err(out, ref)
            tol = check(f"upconv {site} {DT_NAME[dt]}", err, ref, dt, failures)
            ms = time_ms(lambda: k3.upconv_block_fused(x, wt, cb, sc, sh, True))
            launch_ms = time_ms(lambda: k3.upconv_kernel(x, wt, cb, sc, sh,
                                                         True))
            plain_ms = time_ms(lambda: k3.upconv_block_ref(x, wt, cb, sc, sh,
                                                           True))
            flops = 2.0 * b * o * 4 * h * w * (9 * c + 1)
            bms, by = bound(nbytes(x, wt, cb, sc, sh, out), flops, dt)
            rec = {"phase": "kernel", "kernel": "upconv", "site": site,
                   "dtype": DT_NAME[dt], "shape": [b, c, h, w, o],
                   "max_abs_err": err, "tol": tol, "combos_max_abs_err": combos,
                   "ms": ms, "launch_only_ms": launch_ms,
                   "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "gflop": flops / 1e9,
                   "tflops": flops / launch_ms / 1e9,
                   "variant": ("tensor cores " + k3.plan_upconv(c, o)["name"]
                               if on_tc else "cuda cores")}
            emit(rec)
            summary["upconv"].setdefault(dt, {})[site] = rec
        for site, (b, c, h, w) in K2_SITES.items():
            x = randn(b, c, h, w, dtype=dt)
            name = f"upsample {site} {DT_NAME[dt]}"
            # the plain result first, and alive while the kernel runs: the
            # kernel's output buffer cannot be memory that already held it
            ref = k2.upsample2x_fused_ref(x)
            out = k2.upsample2x_fused(x)
            err = max_err(out, ref)
            tol = check(name, err, ref, dt, failures)
            # a channels-last input is copied to NCHW by the wrapper
            err_cl = max_err(k2.upsample2x_fused(
                x.contiguous(memory_format=torch.channels_last)), ref)
            check(f"{name} channels_last", err_cl, ref, dt, failures)
            main = on_main_path("upsample", site)
            plan = k2.plan_upsample(b, c, h, w, dt)
            plans = {}
            for pl in k2.upsample_plans(b, c, h, w, dt):
                perr = max_err(k2.upsample_kernel(x, pl), ref)
                check(f"{name} plan {pl['name']}", perr, ref, dt, failures)
                plans[pl["name"]] = {"max_abs_err": perr, "smem": pl["smem"]}
                if main:
                    plans[pl["name"]]["device_ms"] = device_ms(
                        lambda: k2.upsample_kernel(x, pl), reps=5)
            rec = {"phase": "kernel", "kernel": "upsample", "site": site,
                   "dtype": DT_NAME[dt], "shape": [b, c, h, w],
                   "plan": plan["name"], "max_abs_err": err,
                   "channels_last_max_abs_err": err_cl, "tol": tol,
                   "device_kernels_per_call": one_kernel(
                       name, lambda: k2.upsample2x_fused(x), failures)
                   if main else None,
                   "ms": time_ms(lambda: k2.upsample2x_fused(x)),
                   "device_ms": device_ms(lambda: k2.upsample2x_fused(x)),
                   "cold_l2_ms": cold_l2_ms(k2.upsample2x_fused, x),
                   "plain_ms": time_ms(lambda: k2.upsample2x_fused_ref(x)),
                   "library_ms": time_ms(lambda: F.interpolate(
                       x, scale_factor=2, mode="bilinear",
                       align_corners=True)),
                   "plans": plans}
            rec["launch_only_ms"] = rec["device_ms"]
            rec["bound_ms"], rec["bound_by"] = bound(nbytes(x, out),
                                                     8.0 * out.numel(), dt)
            emit(rec)
            summary["upsample"].setdefault(dt, {})[site] = rec
        for site, (b, c, h, w) in K4_SITES.items():
            p = c // 4
            x = randn(b, c, h, w, dtype=dt)
            wts = k4.fold_bottleneck(random_bottleneck_state(c, p, gen))
            wts = tuple(a.to(dt) if a.dim() > 1 else a for a in wts)
            if not all(float(a.abs().min()) > 0 for a in wts[1::2]):
                raise AssertionError("bottleneck biases must be non-zero")
            ref = k4.bottleneck_eval_reference(x, *wts)
            on_tc = k4.takes_tensor_cores(dt, c, p, h, w)
            # the model packs the tensor-core kernel's weights once
            # (fused_resnet_eval), so the timed call takes them packed
            args = (k4.pack_bottleneck(*wts, dt),) if on_tc else wts
            tc_before = k4.tensor_core_launches
            out = k4.fused_bottleneck_eval(x, *wts)
            if (k4.tensor_core_launches - tc_before == 1) != on_tc:
                failures.append(f"bottleneck {site} {DT_NAME[dt]}: wrong "
                                f"kernel for the rule")
            err = max_err(out, ref)
            tol = check(f"bottleneck {site} {DT_NAME[dt]}", err, ref, dt,
                        failures)
            ms = time_ms(lambda: k4.fused_bottleneck_eval(x, *args))
            plain_ms = time_ms(lambda: k4.bottleneck_eval_reference(x, *wts))
            flops = 2.0 * b * h * w * (2 * c * p + 9 * p * p)
            bms, by = bound(nbytes(x, out, *wts), flops, dt)
            rec = {"phase": "kernel", "kernel": "bottleneck", "site": site,
                   "dtype": DT_NAME[dt], "shape": [b, c, h, w],
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "launch_only_ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": bms, "bound_by": by,
                   "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
                   "variant": "cuda cores",
                   "nonzero_share": float((out != 0).float().mean())}
            if on_tc:
                # every tile plan that fits, the chosen one first; the others
                # forced, checked, and timed at one repetition
                plans = k4.bottleneck_plans(b, c, p, h, w)
                rec["variant"] = "tensor cores " + plans[0]["name"]
                rec["plans"] = {}
                for plan in plans:
                    got = k4.bottleneck_tc_kernel(x, args[0], plan)
                    perr = max_err(got, ref)
                    check(f"bottleneck {site} plan {plan['name']}", perr, ref,
                          dt, failures)
                    rec["plans"][plan["name"]] = {
                        "max_abs_err": perr, "stages": plan["stages"],
                        "smem": plan["smem"],
                        "ms": ms if plan is plans[0] else time_ms(
                            lambda: k4.bottleneck_tc_kernel(x, args[0], plan),
                            reps=1, warmup=1)}
            emit(rec)
            summary["bottleneck"].setdefault(dt, {})[site] = rec
    failures += check_backward(k1, k2, k3)
    if failures:
        raise AssertionError("kernel checks failed:\n" + "\n".join(failures))
    return summary


def random_bottleneck_state(c, p, gen):
    """State dict of one identity bottleneck on the card: conv weights
    scaled to keep activations O(1), BatchNorm scale and running variance
    uniform in [0.5, 2), non-zero shift and running mean."""
    def randn(*shape, std=1.0):
        return std * torch.randn(*shape, generator=gen, device="cuda")

    def uniform(n):
        return torch.rand(n, generator=gen, device="cuda") * 1.5 + 0.5

    sd = {"conv1.weight": randn(p, c, 1, 1, std=(2.0 / c) ** 0.5),
          "conv2.weight": randn(p, p, 3, 3, std=(2.0 / (9 * p)) ** 0.5),
          "conv3.weight": randn(c, p, 1, 1, std=(2.0 / p) ** 0.5)}
    for name, n in (("bn1", p), ("bn2", p), ("bn3", c)):
        sd[f"{name}.weight"] = uniform(n)
        sd[f"{name}.bias"] = randn(n, std=0.3)
        sd[f"{name}.running_mean"] = randn(n, std=0.3)
        sd[f"{name}.running_var"] = uniform(n)
    return sd


def check_backward(k1, k2, k3):
    """Gradients through each autograd.Function (kernel forward, plain
    recompute backward) against autograd of the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def leaf(*shape, lo=None):
        t = torch.randn(*shape, generator=gen, device="cuda")
        if lo is not None:
            t = t.abs() + lo
        return t.requires_grad_()

    failures = []
    cases = {
        "adain": ((leaf(4, 64, 16, 16), leaf(4, 256)),
                  lambda a: k1.adain_fused(*a), lambda a: k1.adain_fused_ref(*a)),
        "upsample": ((leaf(2, 16, 9, 12),),
                     lambda a: k2.upsample2x_fused(*a),
                     lambda a: k2.upsample2x_fused_ref(*a)),
        "upconv": ((leaf(2, 16, 8, 12), leaf(8, 16, 3, 3),
                    leaf(2, 8, 16, 24), leaf(2, 16, lo=0.5), leaf(2, 16)),
                   lambda a: k3.upconv_block_fused(*a, True),
                   lambda a: k3.upconv_block_ref(*a, True)),
    }
    for name, (args, fused, plain) in cases.items():
        g1 = torch.autograd.grad(torch.sin(fused(args)).sum(), args)
        g2 = torch.autograd.grad(torch.sin(plain(args)).sum(), args)
        errs = [max_err(a, b) / max(1.0, float(b.abs().max()))
                for a, b in zip(g1, g2)]
        emit({"phase": "backward", "kernel": name, "rel_err": errs,
              "tol": 1e-4})
        if not max(errs) <= 1e-4:
            failures.append(f"{name} backward: rel err {errs} > 1e-4")
    return failures


def phase_e2e(path, counters, launch_totals):
    """The three configurations end to end; returns the transfers by
    (configuration, dtype) for the later phases."""
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet

    rng = np.random.default_rng(SEED)
    b, size = 16, 256
    u8 = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    conds = np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)]
    conds[::4] = rng.standard_normal((len(conds[::4]), 5)).astype(np.float32)
    xf = WeatherTransfer.preprocess(u8)
    x_dev, c_dev = xf.cuda(), torch.from_numpy(conds).cuda()
    sd = torch.load(path, weights_only=True)["inference"]

    def build(config, dt):
        if config == "use_pallas":
            model = ConditionalUNet(5, dtype=dt, use_pallas=True)
            model.load_state_dict(sd, strict=True)
            return WeatherTransfer(model, device="cuda")
        return WeatherTransfer.load(path, dtype=dt, device="cuda",
                                    fuse_upconv=(config == "fuse_upconv"),
                                    use_pallas=False)

    expect = {"plain": {}, "use_pallas": {"adain": 3, "upsample": 3},
              "fuse_upconv": {"upconv": 3}}
    outs, wts = {}, {}
    for dt in DTYPES:
        for config in ("plain", "use_pallas", "fuse_upconv"):
            wt = wts[config, dt] = build(config, dt)
            for k in counters:
                counters[k].launches = 0
            out_u8 = wt.translate_u8(u8, conds)
            out = wt.translate(xf, conds)
            torch.cuda.synchronize()
            got = {k: m.launches for k, m in counters.items()}
            want = {k: 2 * expect[config].get(k, 0) for k in counters}
            if got != want:
                raise AssertionError(f"{config} {DT_NAME[dt]}: launches {got}"
                                     f" != {want} (3 per forward)")
            for k in counters:
                launch_totals[k] += got[k]
            out_u8, out = out_u8.cpu().numpy(), out.float().cpu().numpy()
            if out.shape != (b, size, size, 3) or out_u8.shape != out.shape:
                raise AssertionError(f"{config}: shapes {out.shape} "
                                     f"{out_u8.shape}")
            if not np.isfinite(out).all():
                raise AssertionError(f"{config} {DT_NAME[dt]}: non-finite")
            step = np.abs(out_u8.astype(np.int16)
                          - WeatherTransfer.to_uint8(out).astype(np.int16))
            if step.max() > 1:
                raise AssertionError(f"{config}: translate_u8 differs from "
                                     f"to_uint8(translate) by {step.max()}")
            outs[config, dt] = (out, out_u8)
            ips, p50 = measure(wt, x_dev, c_dev, counters, launch_totals)
            rec = {"phase": "e2e", "config": config, "dtype": DT_NAME[dt],
                   "batch": b, "size": size, "launches_per_forward":
                   {k: v // 2 for k, v in got.items()},
                   "img_per_s": ips, "p50_ms_batch1": p50}
            if config != "plain":
                ref, ref_u8 = outs["plain", dt]
                rec["mae_vs_plain"] = float(np.abs(out - ref).mean())
                rec["u8_max_step_vs_plain"] = int(np.abs(
                    out_u8.astype(np.int16) - ref_u8.astype(np.int16)).max())
            if dt == torch.bfloat16:
                rec["mae_vs_own_float32"] = float(np.abs(
                    out - outs[config, torch.float32][0]).mean())
            emit(rec)
            if dt == torch.float32 and config != "plain" and not (
                    rec["mae_vs_plain"] <= 1e-5):
                raise AssertionError(f"{config} float32 MAE vs plain "
                                     f"{rec['mae_vs_plain']} > 1e-5")
            if dt == torch.bfloat16 and not rec["mae_vs_own_float32"] <= 1e-3:
                raise AssertionError(f"{config} bfloat16 MAE vs float32 "
                                     f"{rec['mae_vs_own_float32']} > 1e-3")
    # float32 serving as a user gets it: PyTorch's default lets cuDNN run
    # float32 convs in TF32 (the kernels never use TF32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        for config in ("plain", "use_pallas", "fuse_upconv"):
            ips, p50 = measure(wts[config, torch.float32], x_dev, c_dev,
                               counters, launch_totals)
            emit({"phase": "e2e_cudnn_tf32", "config": config,
                  "dtype": "float32", "batch": b, "size": size,
                  "img_per_s": ips, "p50_ms_batch1": p50})
    finally:
        torch.backends.cudnn.allow_tf32 = False
    check_card_vs_cpu(sd)
    return wts


def measure(wt, x_dev, c_dev, counters, launch_totals):
    """img/s at the batch of x_dev, and batch-1 p50 latency in ms (host clock
    around a synchronized call)."""
    before = {k: m.launches for k, m in counters.items()}
    for _ in range(2):
        wt.translate(x_dev, c_dev)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        wt.translate(x_dev, c_dev)
    torch.cuda.synchronize()
    ips = n * x_dev.shape[0] / (time.perf_counter() - t0)
    lat = []
    for _ in range(12):
        t0 = time.perf_counter()
        wt.translate(x_dev[:1], c_dev[:1]).cpu()
        lat.append(time.perf_counter() - t0)
    for k, m in counters.items():
        launch_totals[k] += m.launches - before[k]
    return ips, float(np.median(lat[2:]) * 1e3)


def check_card_vs_cpu(sd):
    """The plain configuration on the card against the same model on the
    CPU, at a small input."""
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet

    rng = np.random.default_rng(SEED + 2)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    c = np.eye(5, dtype=np.float32)[[0, 3]]
    outs = []
    for dev in ("cpu", "cuda"):
        model = ConditionalUNet(5)
        model.load_state_dict(sd, strict=True)
        outs.append(WeatherTransfer(model, device=dev).translate(x, c)
                    .float().cpu().numpy())
    mae = float(np.abs(outs[0] - outs[1]).mean())
    emit({"phase": "e2e_card_vs_cpu", "shape": [2, 64, 64, 3], "mae": mae,
          "tol": 1e-5})
    if not mae <= 1e-5:
        raise AssertionError(f"card vs CPU MAE {mae} > 1e-5")


def phase_serve(wt, counters, launch_totals):
    from weather_unet_tpu_torch.cli.serve import Batcher

    rng = np.random.default_rng(SEED + 3)
    n, size = 24, 224
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    conds = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    conds[1::3] = rng.standard_normal((len(conds[1::3]), 5)).astype(np.float32)
    direct = wt.translate_u8(imgs, conds).cpu().numpy()
    for m in counters.values():
        m.launches = 0
    batcher = Batcher(wt, max_batch=16)
    results = [None] * n

    def client(t):
        for i in range(t, n, 8):
            results[i] = batcher.submit(imgs[i], conds[i])

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads):
        raise AssertionError("Batcher clients did not finish in 300 s")
    stats = batcher.stats()
    batcher.close()
    for k, m in counters.items():
        launch_totals[k] += m.launches
    answered = sum(r is not None and r.shape == (size, size, 3)
                   and r.dtype == np.uint8 for r in results)
    worst = max(int(np.abs(r.astype(np.int16) - d.astype(np.int16)).max())
                for r, d in zip(results, direct))
    emit({"phase": "serve", "answered": answered, "of": n,
          "max_step_vs_direct": worst, "upconv_launches":
          counters["upconv"].launches, "stats": stats})
    if answered != n or worst > 1:
        raise AssertionError(f"Batcher: {answered}/{n} answered, max step "
                             f"{worst}")
    if counters["upconv"].launches != 3 * stats["batches"]:
        raise AssertionError("Batcher batches did not run K3 3 times each")


def make_estimator_checkpoint(path):
    """A seeded ResNet-101 saved as a state-dict .pt: random conv and fc
    weights, random BatchNorm scale and shift, and running statistics that
    are one batch's statistics (so activations stay O(1) through 101
    layers) perturbed at random per channel.  The last BatchNorm of each
    block gets a smaller scale, as zero-init-residual training leaves it:
    with scales around 1 there, float32 rounding alone moves this random
    network's logits by 2e-4 (against a float64 forward), the size of the
    bar the fused forward is held to."""
    from weather_unet_tpu_torch.models import Bottleneck, ResNet101
    from weather_unet_tpu_torch.models.common import BatchNorm2d

    gen = torch.Generator().manual_seed(SEED + 4)
    model = ResNet101(5, generator=gen)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.1, generator=gen)
            bn.momentum = 1.0           # running := this batch's statistics
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.uniform_(0.2, 0.6, generator=gen)
        model.cuda().train()
        model((torch.rand(16, 3, 224, 224, generator=gen) * 2 - 1).cuda())
        model.cpu().eval()
        for bn in bns:
            bn.momentum = 0.1
            n = bn.num_features
            bn.running_mean += (0.1 * bn.running_var.sqrt()
                                * torch.randn(n, generator=gen))
            bn.running_var *= torch.empty(n).uniform_(0.8, 1.25,
                                                      generator=gen)
    torch.save(model.state_dict(), path)


def ips_of(fn, batch, n=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return n * batch / (time.perf_counter() - t0)


def phase_estimator(path, transfer, counters, launch_totals):
    """The frozen ResNet-101 through load_estimator (plain module) and
    through fused_resnet_eval (K4), then the class-transfer consistency
    evaluation over the use_pallas transfer and the fused classifier."""
    from weather_unet_tpu_torch.cli.common import load_estimator
    from weather_unet_tpu_torch.evaluation.transfer import (
        class_transfer_consistency)
    from weather_unet_tpu_torch.kernels import bottleneck as k4
    from weather_unet_tpu_torch.kernels.bottleneck import fused_resnet_eval

    def counted(fn, want):
        for m in counters.values():
            m.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: m.launches for k, m in counters.items()}
        if got != {k: want.get(k, 0) for k in counters}:
            raise AssertionError(f"estimator path: launches {got} != {want}")
        for k in counters:
            launch_totals[k] += got[k]
        return out

    def rel(a, b):
        return max_err(a, b) / max(1.0, float(b.float().abs().max()))

    rng = np.random.default_rng(SEED + 5)
    b, size = 16, 224
    x = torch.from_numpy(rng.uniform(-1, 1, (b, size, size, 3))
                         .astype(np.float32)).cuda()
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    logits, fused_by_dt, plain_by_dt = {}, {}, {}
    for dt in DTYPES:
        plain = plain_by_dt[dt] = load_estimator(path, dtype=dt)
        fused = fused_by_dt[dt] = fused_resnet_eval(plain.model)
        got_plain = counted(lambda: plain(x), {})
        k4.tensor_core_launches = 0
        got_fused = counted(lambda: fused(x_nchw), {"bottleneck": 29})
        want_tc = 29 if dt == torch.bfloat16 else 0
        if k4.tensor_core_launches != want_tc:
            raise AssertionError(
                f"estimator {DT_NAME[dt]}: {k4.tensor_core_launches} of the "
                f"29 K4 launches ran on the tensor cores, expected {want_tc}")
        for name, t in (("plain", got_plain), ("fused", got_fused)):
            if t.shape != (b, 5) or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"estimator {name} {DT_NAME[dt]}: "
                                     f"shape {tuple(t.shape)} or non-finite")
        logits[dt] = got_plain
        ref = logits[torch.float32]
        rec = {"phase": "estimator", "dtype": DT_NAME[dt], "batch": b,
               "size": size, "k4_launches_per_forward": 29,
               "k4_tensor_core_launches_per_forward": want_tc,
               "max_abs_logit": float(ref.abs().max()),
               "fused_vs_plain_rel": rel(got_fused, got_plain)}
        # the plain module as a caller without a graph runs it (under
        # inference_mode) and with autograd on (what load_estimator's apply
        # does alone: nothing requires a gradient, so no graph is kept),
        # interleaved to show the spread between readings
        runs = {"inference_mode": [], "autograd_on": []}
        for mode in ("inference_mode", "autograd_on", "autograd_on",
                     "inference_mode"):
            with torch.inference_mode(mode == "inference_mode"):
                runs[mode].append(ips_of(lambda: plain(x), b))
        rec["img_per_s_plain"] = float(np.mean(runs["inference_mode"]))
        rec["img_per_s_plain_autograd_on"] = float(np.mean(
            runs["autograd_on"]))
        rec["img_per_s_plain_readings"] = runs
        before = counters["bottleneck"].launches
        rec["img_per_s_fused"] = ips_of(lambda: fused(x_nchw), b)
        launch_totals["bottleneck"] += (counters["bottleneck"].launches
                                        - before)
        if dt == torch.float32:
            rec["tol"] = LOGIT_TOL
            ok = rec["fused_vs_plain_rel"] <= LOGIT_TOL
        else:
            rec["plain_vs_float32_rel"] = rel(got_plain, ref)
            rec["fused_vs_float32_rel"] = rel(got_fused, ref)
            rec["tol"] = LOGIT_TOL_BF16
            ok = (max(rec["plain_vs_float32_rel"],
                      rec["fused_vs_float32_rel"]) <= LOGIT_TOL_BF16
                  and rec["fused_vs_float32_rel"]
                  <= 2 * rec["plain_vs_float32_rel"])
        emit(rec)
        if not ok:
            raise AssertionError(f"estimator {DT_NAME[dt]}: logits differ "
                                 f"beyond the tolerance: {rec}")

    # the plain module on the card against the same module on the CPU
    xs = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    on_cpu = load_estimator(path, device="cpu")(xs)
    on_card = plain_by_dt[torch.float32](xs).cpu()
    r = rel(on_card, on_cpu)
    emit({"phase": "estimator_card_vs_cpu", "shape": [2, 64, 64, 3],
          "rel_err": r, "tol": LOGIT_TOL})
    if not r <= LOGIT_TOL:
        raise AssertionError(f"estimator card vs CPU rel err {r}")

    # K1, K2 and K4 in one path: translate to every class, re-classify
    batches = [rng.uniform(-1, 1, (8, size, size, 3)).astype(np.float32)
               for _ in range(2)]
    seen = {"fused": [], "plain": []}

    def classifier(name, fn):
        def classify(images):
            out = fn(images)
            seen[name].append(out.float().cpu())
            return out
        return classify

    fused = fused_by_dt[torch.float32]
    y_true, y_fused = counted(
        lambda: class_transfer_consistency(
            transfer, classifier("fused", lambda im: fused(
                im.permute(0, 3, 1, 2))), batches),
        {"adain": 6, "upsample": 6, "bottleneck": 58})
    _, y_plain = class_transfer_consistency(
        transfer, classifier("plain", plain_by_dt[torch.float32]), batches)
    lp = torch.cat(seen["plain"])
    top2 = lp.topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    tol = 2 * LOGIT_TOL * max(1.0, float(lp.abs().max()))
    differ = y_fused != y_plain
    emit({"phase": "class_transfer_consistency", "labels": int(y_true.size),
          "agree_with_request": float((y_fused == y_true).mean()),
          "fused_differs_from_plain": int(differ.sum()),
          "logits_rel_err": rel(torch.cat(seen["fused"]), lp),
          "classes_predicted": sorted(set(y_fused.tolist()))})
    want_true = np.repeat(np.arange(5), 8).tolist() * 2
    if (y_fused.shape != (80,) or y_true.tolist() != want_true
            or y_fused.min() < 0 or y_fused.max() > 4):
        raise AssertionError("class_transfer_consistency: wrong labels")
    if (differ & (margin >= tol)).any():
        raise AssertionError("fused and plain classifiers disagree beyond "
                             "the logit tolerance")


GAN_PARITY_MOVE = 5e-5   # bulk bar of an updated parameter (half an update)
# float32 parity bar of two steps that differ in the generator's kernels
# (K1/K2 sum in another order than the plain chain): losses relative to each
# loss, Adam moments relative to the network's largest element
GAN_TOL = 1e-4
BF16_ULP = 2.0 ** -7      # floor of a bfloat16 comparison: two roundings


def counted_run(fn, counters, launch_totals, want=None, what=""):
    """Run ``fn`` with every launch count set to 0 just before it and read
    just after; the launches join the main-path totals.  With ``want``
    (kernel -> launches) any other count raises."""
    for m in counters.values():
        m.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {k: m.launches for k, m in counters.items()}
    for k in counters:
        launch_totals[k] += got[k]
    if want is not None and got != {k: want.get(k, 0) for k in counters}:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return out, got


def gan_snapshot(state, metrics):
    """What a parity check compares after one step, on the CPU: the losses;
    per network the updated parameters and Adam's two moments, flattened in
    parameter order (with beta1 = 0 the first moment after one step is the
    gradient itself, plus lr/20 of the parameter: the coupled L2); and the
    u vectors."""
    snap = {"losses": {k: float(v) for k, v in metrics.items()}}
    for net in ("gen", "disc"):
        ts = getattr(state, net)
        named = [(k, p) for k, p in ts.module.named_parameters()
                 if p in ts.optimizer.state]

        def flat(ts_):
            return torch.cat([t.detach().float().flatten()
                              for t in ts_]).cpu()

        snap[net] = {"names": [k for k, _ in named],
                     "params": flat(p for _, p in named),
                     "exp_avg": flat(ts.optimizer.state[p]["exp_avg"]
                                     for _, p in named),
                     "exp_avg_sq_root": flat(
                         ts.optimizer.state[p]["exp_avg_sq"]
                         for _, p in named).sqrt()}
    snap["u"] = {k: v.float().cpu()
                 for k, v in state.disc.module.state_dict().items()
                 if k.endswith("weight_u")}
    return snap


def snapshot_errs(a, b):
    """a against b: each loss's relative error, each network's moments' max
    abs error over the network's largest element and their relative L2
    error, the parameters' Adam sign-flip statistics, and u's max abs
    error."""
    rec = {"loss_rel_err": {
        k: abs(a["losses"][k] - v) / max(abs(v), 1e-30)
        for k, v in b["losses"].items()}}
    for net in ("gen", "disc"):
        if a[net]["names"] != b[net]["names"]:
            raise AssertionError(f"{net}: parameters updated differ")
        for key in ("exp_avg", "exp_avg_sq_root"):
            ref = b[net][key]
            rec[f"{net}_{key}_rel_err"] = float(
                (a[net][key] - ref).abs().max()) / float(ref.abs().max())
            rec[f"{net}_{key}_rel_l2"] = float(
                (a[net][key] - ref).norm() / ref.norm())
        diff = (a[net]["params"] - b[net]["params"]).abs()
        rec[f"{net}_loose_share"] = float((diff > GAN_PARITY_MOVE).float()
                                          .mean())
        rec[f"{net}_max_move_diff"] = float(diff.max())
    rec["u_max_abs_err"] = max(float((v - b["u"][k]).abs().max())
                               for k, v in a["u"].items())
    return rec


MOMENT_KEYS = [f"{net}_{key}_rel_err" for net in ("gen", "disc")
               for key in ("exp_avg", "exp_avg_sq_root")]
L2_KEYS = [k.replace("_rel_err", "_rel_l2") for k in MOMENT_KEYS]
# an input perturbation of one or two float32 roundings: the float32 floor
# of a GAN step's agreement (float32_floor)
ONE_ROUNDING = 2.0 ** -23


def float32_floor(run, x, against):
    """How far the plain float32 step moves when its images move by one or
    two roundings (x * (1 +- 2^-23)): per moment key the larger of the two
    errors against the unperturbed step ``against``.  Any two float32
    computations of the step that round differently split by about this
    much: the cUNet's gradient sums cancel (the biases before each AdaIN's
    mean subtraction), so G's moments move by ~1e-3 of the largest at full
    width.  ``run(images) -> snapshot``."""
    errs = [snapshot_errs(run(x * (1 + sign * ONE_ROUNDING)), against)
            for sign in (1, -1)]
    return {k: max(e[k] for e in errs) for k in MOMENT_KEYS}


def gan_states_agree(a, b, lr, tol, what, floor, extra=0.0):
    """Two float32 GAN steps from one state: losses within rel ``tol`` (plus
    ``extra``); Adam's moments (the gradient and the square root of its
    square) within ``tol`` of the network's largest element plus twice the
    step's float32 ``floor`` (plus ``extra``); updated parameters within
    the Adam sign-flip bound (fewer than 0.5% of the elements beyond 5e-5,
    none beyond 2.2 * lr: with beta1 = 0 an update is about lr * sign(g),
    so an element whose gradient lies below the float noise may step either
    way, and only the moments see a gradient of the wrong size); u within
    1e-4.  Returns the record."""
    rec = snapshot_errs(a, b)
    fails = [f"{k} rel err {v}" for k, v in rec["loss_rel_err"].items()
             if not v <= tol + extra]
    fails += [f"{k} {rec[k]} (floor {floor[k]})" for k in MOMENT_KEYS
              if not rec[k] <= tol + 2 * floor[k] + extra]
    for net in ("gen", "disc"):
        if not (rec[f"{net}_loose_share"] < 5e-3
                and rec[f"{net}_max_move_diff"] <= 2.2 * lr + 1e-6):
            fails.append(f"{net} parameters: {rec[f'{net}_loose_share']} "
                         f"loose, max {rec[f'{net}_max_move_diff']}")
    if not rec["u_max_abs_err"] <= 1e-4:
        fails.append(f"u max abs err {rec['u_max_abs_err']}")
    rec.update(tol=tol, extra=extra, float32_floor=floor)
    if fails:
        raise AssertionError(f"{what}: " + "; ".join(fails))
    return rec


def bf16_states_agree(cand, ref, base, base_ref, what, extra=0.0):
    """A bfloat16 step ``cand`` held to ``ref`` no worse than the bfloat16
    step ``base`` is to its float32 counterpart ``base_ref``: every loss
    within twice base's error plus two bfloat16 roundings of the loss (plus
    ``extra``), every moment's relative L2 error within twice base's plus
    two roundings (plus ``extra``; bfloat16 moves G's most cancelling
    gradient sums by their own size, so the largest element's error is
    noise, the L2 over millions is not), u within twice base's error
    plus 1e-4 (the third u update reads D's updated weights, and bfloat16
    gradients flip the sign of some of Adam's steps).  Returns the record
    of cand against ref, with base's errors beside it."""
    rec, rb = snapshot_errs(cand, ref), snapshot_errs(base, base_ref)
    fails = [f"{k} rel err {v} (bf16 plain {rb['loss_rel_err'][k]})"
             for k, v in rec["loss_rel_err"].items()
             if not v <= 2 * rb["loss_rel_err"][k] + BF16_ULP + extra]
    fails += [f"{k} {rec[k]} (bf16 plain {rb[k]})" for k in L2_KEYS
              if not rec[k] <= 2 * rb[k] + BF16_ULP + extra]
    if not rec["u_max_abs_err"] <= 2 * rb["u_max_abs_err"] + 1e-4:
        fails.append(f"u max abs err {rec['u_max_abs_err']} (bf16 plain "
                     f"{rb['u_max_abs_err']})")
    rec["extra"] = extra
    rec["bf16_plain_vs_float32"] = {k: rb[k] for k in
                                    ["loss_rel_err", *L2_KEYS,
                                     "u_max_abs_err"]}
    if fails:
        raise AssertionError(f"{what}: " + "; ".join(fails))
    return rec


def route_sensitivity(plain, routed, images, rand, eps):
    """How far the K4 route can move a float32 step: ``loss_con`` divides
    each sample's reconstruction error by the distance between its two
    conditions, mean_c |pred - rand| + eps, so a condition error delta
    moves that sample's weight, and its share of G's gradient, by up to
    (mean_c |d pred| + mean_c |d rand|) / distance.  The largest such ratio
    over the batch, from the two estimators' conditions on these images."""
    with torch.no_grad():
        pred_p, rand_p = plain(images).float(), plain(rand).float()
        pred_k, rand_k = routed(images).float(), routed(rand).float()
    delta = ((pred_k - pred_p).abs().mean(dim=1)
             + (rand_k - rand_p).abs().mean(dim=1))
    dist = (pred_p - rand_p).abs().mean(dim=1) + eps
    return float((delta / dist).max()), float(dist.min())


def u_vectors(disc):
    return {k: v.clone() for k, v in disc.state_dict().items()
            if k.endswith("weight_u") and v.numel() > 1}


def step_profile(fn, top=12):
    """One call of ``fn`` under torch.profiler (CUPTI): the device time (the
    union of its CUDA kernels' intervals; annotation ranges such as
    ``Optimizer.step#Adam.step`` are not kernels), the number of kernels,
    and the ``top`` kernel names by summed duration (ms)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_name = {}
    for e in kernels:
        by_name[e.name[:90]] = (by_name.get(e.name[:90], 0.0)
                                + e.time_range.elapsed_us() / 1e3)
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return busy / 1e3, len(kernels), dict(names)


def estimators(path, dt, route, cache):
    """The GAN step's estimator over NCHW images through the package's
    load_step_estimator with its route forced: ``plain`` is the module
    forward; ``k4`` sends the forwards that run without autograd (the
    stop-gradient conditions) through fused_resnet_eval and the one forward
    whose gradient reaches G through the module.  Kept in ``cache``."""
    from weather_unet_tpu_torch.cli.common import load_step_estimator

    if (dt, route) not in cache:
        cache[dt, route] = load_step_estimator(path, dtype=dt, device="cuda",
                                               route=route)
    return cache[dt, route]


def wall_ms(fn, n=3):
    """Median host-clock ms of ``n`` synchronized calls, after one warm-up."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_gan(est_path, counters, launch_totals):
    """The GAN combined step (train/gan.py) on the card at full width: the
    7.8 M-parameter cUNet (plain and use_pallas = K1 + K2), the SNDisc, and
    the seeded ResNet-101 through load_estimator (plain, or its no-grad
    forwards through K4); 224x224, batch 8, est mode (GanConfig's
    defaults)."""
    from weather_unet_tpu_torch.core.rng import train_generator
    from weather_unet_tpu_torch.models import ResNet
    from weather_unet_tpu_torch.train.gan import (
        GanConfig, build_gan_state, make_eval_step, make_gan_step)

    cfg = GanConfig()
    b, size = cfg.batch_size, cfg.input_size
    rng = np.random.default_rng(SEED + 6)

    def batch(bb, ss, device="cuda"):
        return torch.from_numpy(rng.uniform(-1, 1, (bb, 3, ss, ss)).astype(
            np.float32)).to(device)

    images, rand = batch(b, size), batch(b, size)
    zeros = torch.zeros(b, dtype=torch.long, device="cuda")

    # 0. the K4-routed estimator against the plain module on one batch of
    #    8 (comparison launches: they join no main-path total)
    est_cache = {}
    logits = {}
    for dt in DTYPES:
        plain = estimators(est_path, dt, "plain", est_cache)
        routed = estimators(est_path, dt, "k4", est_cache)
        with torch.no_grad():
            lp = plain(images)
            n0 = counters["bottleneck"].launches
            lr_ = routed(images)
            torch.cuda.synchronize()
            n_k4 = counters["bottleneck"].launches - n0
        n0 = counters["bottleneck"].launches
        routed(images)              # autograd on: the plain module
        torch.cuda.synchronize()
        n_k4_grad = counters["bottleneck"].launches - n0
        logits[dt] = lp
        ref = logits[torch.float32]
        rec = {"phase": "gan_estimator", "dtype": DT_NAME[dt], "batch": b,
               "k4_launches_no_grad": n_k4, "k4_launches_grad": n_k4_grad,
               "routed_vs_plain_rel": max_err(lr_, lp) / max(
                   1.0, float(lp.float().abs().max()))}
        if dt == torch.float32:
            rec["tol"] = LOGIT_TOL
            ok = rec["routed_vs_plain_rel"] <= LOGIT_TOL
        else:
            scale = max(1.0, float(ref.abs().max()))
            rec["plain_vs_float32_rel"] = max_err(lp, ref) / scale
            rec["routed_vs_float32_rel"] = max_err(lr_, ref) / scale
            rec["tol"] = LOGIT_TOL_BF16
            ok = (max(rec["plain_vs_float32_rel"],
                      rec["routed_vs_float32_rel"]) <= LOGIT_TOL_BF16
                  and rec["routed_vs_float32_rel"]
                  <= 2 * rec["plain_vs_float32_rel"])
        emit(rec)
        if not (ok and n_k4 == 29 and n_k4_grad == 0):
            raise AssertionError(f"gan estimator {DT_NAME[dt]}: {rec}")

    # 1. parity on the card, dropout 0, one combined step from one seed in
    #    each of the eight configurations, compared in pairs below
    def parity_step(dt, use_pallas, route, x=images, count=True):
        cfg0 = GanConfig(dropout_rate=0.0, dtype=dt)
        gen, disc, state = build_gan_state(cfg0, SEED, "cuda",
                                           use_pallas=use_pallas)
        step = make_gan_step(
            gen, disc, estimators(est_path, dt, route, est_cache), cfg0)

        def run():
            return step(state, x, zeros, rand, zeros,
                        train_generator(SEED, "cuda"), do_g=True)

        if count:
            want = {"adain": 6 * use_pallas, "upsample": 6 * use_pallas,
                    "bottleneck": 58 * (route == "k4")}
            (state, m), _ = counted_run(
                run, counters, launch_totals, want,
                f"gan parity {DT_NAME[dt]} use_pallas={use_pallas} "
                f"est={route}")
        else:
            state, m = run()
        return gan_snapshot(state, m)

    snaps = {(dt, use_pallas, route): parity_step(dt, use_pallas, route)
             for dt in DTYPES for use_pallas in (False, True)
             for route in ("plain", "k4")}
    # float32: pairs that differ in one thing -- the generator's kernels
    # under each estimator route at GAN_TOL plus twice the float32 floor,
    # and the route under the plain generator at that bar plus twice
    # route_sensitivity
    f32, bf = torch.float32, torch.bfloat16
    floor = float32_floor(
        lambda x: parity_step(f32, False, "plain", x, count=False), images,
        snaps[f32, False, "plain"])
    sens = {dt: route_sensitivity(
        estimators(est_path, dt, "plain", est_cache),
        estimators(est_path, dt, "k4", est_cache), images, rand,
        cfg.con_eps) for dt in DTYPES}
    pairs = [((f32, True, "plain"), (f32, False, "plain"), GAN_TOL),
             ((f32, True, "k4"), (f32, False, "k4"), GAN_TOL),
             ((f32, False, "k4"), (f32, False, "plain"), GAN_TOL)]
    # bfloat16: the use_pallas generator against the float32 plain one under
    # the same route, no further from it than the bfloat16 plain generator
    # is; the route under the plain generator within that bar plus twice
    # its bfloat16 route_sensitivity (the K4 route itself is held by its
    # logits above)
    pairs += [((bf, True, r), (f32, False, r), (bf, False, r))
              for r in ("plain", "k4")]
    pairs += [((bf, False, "k4"), (bf, False, "plain"), (bf, False, "plain"))]
    for cand, against, tol in pairs:
        what = (f"gan parity {DT_NAME[cand[0]]} use_pallas={cand[1]} "
                f"est={cand[2]} against {DT_NAME[against[0]]} "
                f"use_pallas={against[1]} est={against[2]}")
        if cand[0] == f32:
            extra = 2 * sens[f32][0] if cand[2] != against[2] else 0.0
            rec = gan_states_agree(snaps[cand], snaps[against], cfg.lr, tol,
                                   what, floor, extra)
        else:
            base = tol
            extra = 2 * sens[bf][0] if cand[2] != against[2] else 0.0
            rec = bf16_states_agree(snaps[cand], snaps[against], snaps[base],
                                    snaps[(f32,) + base[1:]], what, extra)
        if cand[2] != against[2]:
            (rec["route_sensitivity"],
             rec["min_condition_distance"]) = sens[cand[0]]
        emit({"phase": "gan_parity", "dtype": DT_NAME[cand[0]],
              "use_pallas": cand[1], "estimator": cand[2],
              "against": {"dtype": DT_NAME[against[0]],
                          "use_pallas": against[1], "estimator": against[2]},
              "batch": b, "size": size, "losses": snaps[cand]["losses"],
              **rec})
    del snaps

    # 2. the same step on the card against the CPU, 32x32, batch 2, a
    #    depth-(1, 1, 1, 1) estimator
    from weather_unet_tpu_torch.cli.common import load_estimator

    small = os.path.join(os.path.dirname(est_path), "estimator_small.pt")
    torch.save(ResNet((1, 1, 1, 1), 5, generator=torch.Generator()
                      .manual_seed(SEED + 7)).state_dict(), small)
    cfg_s = GanConfig(input_size=32, batch_size=2, dropout_rate=0.0)
    xs, rs = batch(2, 32, "cpu"), batch(2, 32, "cpu")
    def small_step(dev, x=xs, count=True):
        apply = load_estimator(small, device=dev)
        gen, disc, state = build_gan_state(cfg_s, SEED, dev, use_pallas=True)
        step = make_gan_step(gen, disc,
                             lambda im: apply(im.permute(0, 2, 3, 1)), cfg_s)
        z = torch.zeros(2, dtype=torch.long, device=dev)

        def run():
            return step(state, x.to(dev), z, rs.to(dev), z,
                        train_generator(SEED, dev), do_g=True)

        if count:
            want = {"adain": 6, "upsample": 6} if dev == "cuda" else {}
            (state, m), _ = counted_run(run, counters, launch_totals, want,
                                        f"gan small {dev}")
        else:
            state, m = run()
        return gan_snapshot(state, m)

    snaps = {dev: small_step(dev) for dev in ("cuda", "cpu")}
    floor = float32_floor(lambda x: small_step("cpu", x, count=False), xs,
                          snaps["cpu"])
    rec = gan_states_agree(snaps["cuda"], snaps["cpu"], cfg_s.lr, GAN_TOL,
                           "gan card vs CPU", floor)
    emit({"phase": "gan_card_vs_cpu", "batch": 2, "size": 32, **rec})
    del snaps

    # 3. steady state at dropout 0.3: f32 and bf16 (float32 master weights),
    #    plain and use_pallas generator, plain and K4-routed estimator
    n_warm, n_timed = 2, 5
    records = []
    for dt in DTYPES:
        for use_pallas in (False, True):
            for route in ("plain", "k4"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                cfg_d = GanConfig(dtype=dt)
                est = estimators(est_path, dt, route, est_cache)
                gen, disc, state = build_gan_state(cfg_d, SEED, "cuda",
                                                   use_pallas=use_pallas)
                step = make_gan_step(gen, disc, est, cfg_d)
                gen_rng = train_generator(SEED, "cuda")
                per = {"adain": 6 * use_pallas, "upsample": 6 * use_pallas,
                       "bottleneck": 58 * (route == "k4")}
                u0 = u_vectors(disc)
                what = (f"gan {DT_NAME[dt]} use_pallas={use_pallas} "
                        f"est={route}")

                def run(n, do_g=True):
                    times, metrics = [], []
                    for _ in range(n):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        _, m = step(state, images, zeros, rand, zeros,
                                    gen_rng, do_g=do_g)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        metrics.append(m)
                    return times, metrics

                counted_run(lambda: run(n_warm), counters, launch_totals,
                            {k: n_warm * v for k, v in per.items()}, what)
                (times, metrics), _ = counted_run(
                    lambda: run(n_timed), counters, launch_totals,
                    {k: n_timed * v for k, v in per.items()}, what)
                step_ms = float(np.median(times)) * 1e3
                (_, d_only), _ = counted_run(
                    lambda: run(1, do_g=False), counters, launch_totals,
                    {k: v // 2 if k != "bottleneck" else v
                     for k, v in per.items()}, what + " D only")
                (device_ms_step, n_kernels, top), _ = counted_run(
                    lambda: step_profile(lambda: run(1)), counters,
                    launch_totals, per, what + " profiled")
                steps = n_warm + n_timed + 2
                finite = all(bool(torch.isfinite(v)) for m in metrics
                             + d_only for v in m.values())
                moved = all(not torch.equal(u, disc.state_dict()[k])
                            for k, u in u0.items())
                if not (finite and moved and state.global_step == steps
                        and state.disc.step == steps
                        and state.gen.step == steps - 1):
                    raise AssertionError(
                        f"{what}: finite {finite}, u moved {moved}, steps "
                        f"{state.global_step}/{state.gen.step}/"
                        f"{state.disc.step}")
                # the estimator's share: its two stop-gradient forwards and
                # the forward + input backward on G's output, timed apart
                fake = gen(images, est(rand).detach(), train=True,
                           generator=gen_rng).detach().requires_grad_()

                def est_work():
                    with torch.no_grad():
                        est(images)
                        est(rand)
                    torch.autograd.grad(est(fake).sum(), fake)

                est_ms, _ = counted_run(lambda: wall_ms(est_work), counters,
                                        launch_totals)
                rec = {"phase": "gan_step", "dtype": DT_NAME[dt],
                       "use_pallas": use_pallas, "estimator": route,
                       "batch": b, "size": size, "dropout": cfg_d.dropout_rate,
                       "step_ms_median": step_ms,
                       "step_ms_all": [t * 1e3 for t in times],
                       "img_per_s": b / step_ms * 1e3,
                       "peak_mem_gib": torch.cuda.max_memory_allocated()
                       / 2 ** 30,
                       "device_ms_one_step": device_ms_step,
                       "device_busy_share": device_ms_step / step_ms,
                       "device_kernels_one_step": n_kernels,
                       "top_kernels_ms": top,
                       "estimator_ms": est_ms,
                       "estimator_share": est_ms / step_ms,
                       "launches_per_step": per,
                       "losses": {k: float(v) for k, v in metrics[-1].items()}}
                emit(rec)
                records.append(rec)
                last = (gen, disc, state, est, cfg_d)
                del step

    # 4. the evaluation step once, batch 8, on the last configuration (bf16,
    #    use_pallas, K4-routed estimator): 8 G forwards, 8 estimator forwards
    gen, disc, state, est, cfg_d = last
    refs = torch.eye(5, device="cuda")[torch.arange(b) % 5]
    labels = torch.eye(5, device="cuda")[(torch.arange(b) + 1) % 5]
    u0 = u_vectors(disc)
    (metrics, fakes), _ = counted_run(
        lambda: make_eval_step(gen, disc, est, cfg_d)(
            state, images, labels, refs, train_generator(SEED, "cuda")),
        counters, launch_totals,
        {"adain": 3 * b, "upsample": 3 * b, "bottleneck": 29 * b},
        "gan eval step")
    ok = (tuple(fakes.shape) == (b, b, 3, size, size)
          and all(bool(torch.isfinite(v)) for v in metrics.values())
          and bool(torch.isfinite(fakes).all())
          and all(torch.equal(u, disc.state_dict()[k])
                  for k, u in u0.items()))
    emit({"phase": "gan_eval", "dtype": DT_NAME[cfg_d.dtype],
          "fakes_shape": list(fakes.shape),
          "metrics": {k: float(v) for k, v in metrics.items()}, "ok": ok})
    if not ok:
        raise AssertionError("gan eval step: wrong shape, non-finite values "
                             "or u moved")
    return records


TRAIN_STEPS = 10          # timed trainer steps per dtype
PROFILED_STEPS = 3        # trainer steps under torch.profiler
N_JPEGS = 96              # synthetic 256x256 JPEGs for the CLI runs


def host_packages():
    """What the host offers the data path: Pillow, pandas, TensorBoard,
    scikit-learn and matplotlib (version, or None), and libjpeg's header
    and library (the native runtime's decode needs them; without them it
    builds augment-only and Pillow decodes)."""
    import ctypes.util
    import importlib

    out = {}
    for mod in ("PIL", "pandas", "tensorboard", "sklearn", "matplotlib"):
        try:
            out[mod.lower()] = importlib.import_module(mod).__version__
        except ImportError:
            out[mod.lower()] = None
    out["jpeglib_h"] = any(os.path.exists(os.path.join(d, "jpeglib.h"))
                           for d in ("/usr/include", "/usr/local/include"))
    out["libjpeg"] = ctypes.util.find_library("jpeg")
    return out


def write_jpegs(root, n, size=256, seed=SEED + 9):
    """``n`` seeded smooth-plus-noise RGB JPEGs of size x size; their
    paths."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    paths = []
    for i in range(n):
        base = rng.uniform(0, 255, 3) * (0.5 + 0.5 * np.sin(
            xx[..., None] / rng.uniform(8, 40)
            + yy[..., None] / rng.uniform(8, 40)))
        img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255)
        paths.append(os.path.join(root, f"{i:03d}.jpg"))
        Image.fromarray(img.astype(np.uint8)).save(paths[-1], quality=90)
    return paths


def state_equal(a, b):
    """Two GAN states hold bit-equal networks, Adam states and counters."""
    for net in ("gen", "disc"):
        ta, tb = getattr(a, net), getattr(b, net)
        sa, sb = ta.module.state_dict(), tb.module.state_dict()
        oa = ta.optimizer.state_dict()["state"]
        ob = tb.optimizer.state_dict()["state"]
        if (sa.keys() != sb.keys() or oa.keys() != ob.keys()
                or ta.step != tb.step
                or not all(torch.equal(v, sb[k]) for k, v in sa.items())
                or not all(torch.equal(v, ob[i][k]) for i in oa
                           for k, v in oa[i].items())):
            return False
    return (a.epoch, a.global_step) == (b.epoch, b.global_step)


def train_cli(argv, eval_every, windows):
    """``cli/train_transfer_est.py::main(argv)`` in this process with the
    trainer's checkpoint/evaluation cadence at ``eval_every`` steps and its
    summary window at 4; each window's ``perf/images_per_sec`` is appended
    to ``windows``."""
    from weather_unet_tpu_torch.cli.train_transfer_est import main
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer as T

    saved = (T.EVAL_PER_STEP, T.DISPLAY_PER_STEP, T.update_summary)

    def update_summary(self):
        saved[2](self)
        windows.append(self.scalar_dict.get("perf/images_per_sec"))

    T.EVAL_PER_STEP, T.DISPLAY_PER_STEP, T.update_summary = (
        eval_every, 4, update_summary)
    try:
        main(argv)
    finally:
        T.EVAL_PER_STEP, T.DISPLAY_PER_STEP, T.update_summary = saved


# the CLI in a child process, its cadence checkpoint every 3 steps so that
# the parent can send SIGTERM once training is under way
PREEMPT_CHILD = ("import sys\n"
                 "from weather_unet_tpu_torch.train.loops import "
                 "WeatherTransferTrainer\n"
                 "WeatherTransferTrainer.EVAL_PER_STEP = 3\n"
                 "from weather_unet_tpu_torch.cli.train_transfer_est import "
                 "main\n"
                 "main(sys.argv[1:])\n")


def run_child(argv, stop_when, timeout=240):
    """Run the CLI in a child process and send it SIGTERM once the file
    ``stop_when`` exists.  Returns (exit code, output, seconds).  The child
    never outlives the call."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", PREEMPT_CHILD, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        while (proc.poll() is None and not os.path.exists(stop_when)
               and time.perf_counter() - t0 < timeout):
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, time.perf_counter() - t0


def phase_train(est_path, counters, launch_totals, gan_records, smi):
    """The trainer loop (train/loops.py) on the card at full width, 224x224,
    batch 8: trainer = hand step (f32, dropout 0), launches per trainer
    step, trainer img/s in bf16 and f32 beside the bare step's, the device
    busy share, a checkpoint round trip and the reference export; then, on
    seeded JPEGs, the est CLI (--image_only, bf16, --augmentation, 4
    workers, 2 epochs; and the frame mode where pandas is present), the
    loader alone, and SIGTERM -> checkpoint -> resume in a child process."""
    from weather_unet_tpu_torch.cli.common import (
        load_step_estimator, load_transfer)
    from weather_unet_tpu_torch.core.rng import fold_seed
    from weather_unet_tpu_torch.data.datasets import ImagePathDataset
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.data.transforms import (
        HostAugment, normalize_batch)
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import (
        GanConfig, build_gan_state, make_gan_step)
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    t_phase = time.perf_counter()
    host = host_packages()
    emit({"phase": "train_host", **host,
          "note": None if host["pil"] else
          "no Pillow: the JPEG path is held on the CPU by the tests only"})
    f32, bf = torch.float32, torch.bfloat16
    b, size = 8, 224
    rng = np.random.default_rng(SEED + 8)
    # FlickrDataset's tuple layout, no decode and no transform
    mem = [(rng.integers(0, 256, (size, size, 3), np.uint8),
            np.zeros(5, np.float32), str(i))
           for i in range(2 * TRAIN_STEPS * b)]

    def loaders(n):
        """A content and a random loader of ``n`` batches each, over
        disjoint images: an image paired with itself puts its two
        conditions at distance 0, where loss_con divides by eps alone."""
        return (BatchLoader(mem[:n * b], b, shuffle=True, num_workers=4),
                BatchLoader(mem[-n * b:], b, shuffle=True, seed=1,
                            num_workers=4))

    ests = {dt: load_step_estimator(est_path, dtype=dt, device="cuda")
            for dt in (f32, bf)}
    per = {f32: {"adain": 6, "upsample": 6},
           bf: {"adain": 6, "upsample": 6, "bottleneck": 58}}
    rec = {"phase": "train", "card": smi, "batch": b, "size": size}
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(dt, name, **kw):
            return WeatherTransferTrainer(
                GanConfig(input_size=size, batch_size=b, dtype=dt, **kw),
                ests[dt],
                save_dir=os.path.join(tmp, "cp"), name=name,
                log_dir=os.path.join(tmp, "runs"), device="cuda")

        # 1. trainer = step: one combined step, f32 (TF32 off), dropout 0
        tr = trainer(f32, "parity", dropout_rate=0.0)
        counted_run(lambda: tr.train_epoch(*loaders(1)), counters,
                    launch_totals, per[f32], "trainer f32 step")
        got = gan_snapshot(tr.state, tr._last_metrics)
        x_u8, r_u8 = (next(iter(ld))[0] for ld in loaders(1))
        images = normalize_batch(torch.from_numpy(x_u8).cuda())
        rand = normalize_batch(torch.from_numpy(r_u8).cuda())
        zeros = torch.zeros(b, dtype=torch.long, device="cuda")

        def hand(x):
            cfg0 = GanConfig(input_size=size, batch_size=b, dropout_rate=0.0)
            gen, disc, state = build_gan_state(cfg0, 0, "cuda",
                                               use_pallas=True)
            g = torch.Generator("cuda").manual_seed(fold_seed(1, 1))
            state, m = make_gan_step(gen, disc, ests[f32], cfg0)(
                state, x, zeros, rand, zeros, g, do_g=True)
            return gan_snapshot(state, m)

        want = hand(images)
        floor = float32_floor(hand, images, want)
        # the card's own run-to-run split of the same step, for reference
        again = snapshot_errs(hand(images), want)
        rec["hand_step_twice"] = {k: again[k] for k in (
            "gen_loose_share", "gen_exp_avg_rel_err", "u_max_abs_err")}
        rec["trainer_vs_step"] = gan_states_agree(
            got, want, GanConfig().lr, GAN_TOL, "trainer vs hand step",
            floor)
        del tr, got, want

        # 2. throughput and launches a step, bf16 (K4 route) and f32
        for dt in (bf, f32):
            tr = trainer(dt, f"speed_{DT_NAME[dt]}")
            counted_run(lambda: tr.train_epoch(*loaders(2)), counters,
                        launch_totals, {k: 2 * v for k, v in per[dt].items()},
                        f"trainer {DT_NAME[dt]} warm-up")
            t0 = time.perf_counter()
            counted_run(lambda: tr.train_epoch(*loaders(TRAIN_STEPS)),
                        counters, launch_totals,
                        {k: TRAIN_STEPS * v for k, v in per[dt].items()},
                        f"trainer {DT_NAME[dt]}")
            step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
            # the bare step timed the same way (host clock around the same
            # number of unsynchronized steps) on two batches already
            # normalized on the card: no loader, prefetch or normalize
            bare_step = make_gan_step(tr.gen, tr.disc, ests[dt], tr.cfg)
            x, r = (normalize_batch(torch.from_numpy(np.stack(
                [m[0] for m in part])).cuda()) for part in (mem[:b],
                                                             mem[-b:]))
            z = torch.zeros(b, dtype=torch.long, device="cuda")
            g = torch.Generator("cuda")

            def bare_steps():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(TRAIN_STEPS):
                    g.manual_seed(i)
                    bare_step(tr.state, x, z, r, z, g, do_g=True)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / TRAIN_STEPS * 1e3

            bare_ms, _ = counted_run(
                bare_steps, counters, launch_totals,
                {k: TRAIN_STEPS * v for k, v in per[dt].items()},
                f"bare {DT_NAME[dt]} steps")
            (busy_ms, n_kernels, _), _ = counted_run(
                lambda: step_profile(
                    lambda: tr.train_epoch(*loaders(PROFILED_STEPS))),
                counters, launch_totals,
                {k: PROFILED_STEPS * v for k, v in per[dt].items()},
                f"trainer {DT_NAME[dt]} profiled")
            bare = [r for r in gan_records if r["dtype"] == DT_NAME[dt]
                    and r["use_pallas"] and r["estimator"]
                    == ("k4" if dt == bf else "plain")][0]
            rec[DT_NAME[dt]] = {
                "trainer_step_ms": step_ms,
                "trainer_img_per_s": b / step_ms * 1e3,
                "bare_step_same_window_ms": bare_ms,
                "bare_step_same_window_img_per_s": b / bare_ms * 1e3,
                "phase_gan_bare_step_img_per_s": bare["img_per_s"],
                "device_ms_per_step": busy_ms / PROFILED_STEPS,
                "device_busy_share": busy_ms / PROFILED_STEPS / step_ms,
                "kernels_per_step": n_kernels / PROFILED_STEPS,
                "launches_per_step": per[dt]}
            if dt == bf:
                last = tr
            else:
                del tr
        # a D-only step between two combined ones (GD_train_ratio 2)
        tr2 = trainer(bf, "d_only", gd_train_ratio=2)
        d_only = {"adain": 3, "upsample": 3, "bottleneck": 58}
        counted_run(lambda: tr2.train_epoch(*loaders(2)), counters,
                    launch_totals,
                    {k: v + d_only[k] for k, v in per[bf].items()},
                    "trainer bf16 D-only + combined")
        del tr2
        # the device augment: both batches warped on the card (resized
        # crop and jitter) in place of normalize_batch; the launches a
        # step do not change
        tr3 = WeatherTransferTrainer(
            GanConfig(input_size=size, batch_size=b, dtype=bf), ests[bf],
            save_dir=os.path.join(tmp, "cp"), name="device_augment",
            log_dir=os.path.join(tmp, "runs"), device="cuda",
            device_augment=True, augment=True)
        counted_run(lambda: tr3.train_epoch(*loaders(1)), counters,
                    launch_totals, per[bf], "trainer bf16 device_augment")
        losses = {k: float(v) for k, v in tr3._last_metrics.items()}
        rec["device_augment_step"] = {"losses": losses,
                                      "launches_per_step": per[bf]}
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"device_augment step: {losses}")
        del tr3

        # 3. checkpoint: async save of the bf16 trainer, round trip, export
        tree = ckpt.gan_tree(last.state, last.seed)
        torch.cuda.synchronize()
        saver = ckpt.AsyncCheckpointer()
        t0 = time.perf_counter()
        saver.save(tmp, "round_trip", last.state.global_step, tree)
        t1 = time.perf_counter()
        path = saver.wait()
        t2 = time.perf_counter()
        saver.close()
        _, _, fresh = build_gan_state(
            GanConfig(input_size=size, batch_size=b, dtype=bf), SEED + 1,
            "cuda", use_pallas=True)
        ckpt.restore_checkpoint(path, fresh)
        export = os.path.join(tmp, "export.pt")
        ckpt.export_torch_gan(export, last.gen, last.disc, last.state.epoch,
                              last.state.global_step)
        loaded = load_transfer(export, device="cuda").state_dict()
        exported = all(torch.equal(v, loaded[k])
                       for k, v in last.gen.state_dict().items())
        rec["checkpoint"] = {
            "blocking_ms": (t1 - t0) * 1e3, "total_ms": (t2 - t0) * 1e3,
            "file_mib": os.path.getsize(path) / 2 ** 20,
            "restored_bit_equal": state_equal(fresh, last.state),
            "export_loads_strict": exported}
        if not (rec["checkpoint"]["restored_bit_equal"] and exported):
            raise AssertionError(f"checkpoint round trip: {rec['checkpoint']}")
        del last, fresh, tree, loaded

        if not host["pil"]:
            # no JPEG decode here: fit() over the in-memory loaders
            tr = trainer(bf, "fit", num_epoch=2)
            counted_run(lambda: tr.fit(lambda: loaders(2)[0],
                                       lambda: loaders(2)[1]),
                        counters, launch_totals,
                        {k: 4 * v for k, v in per[bf].items()}, "fit")
            rec["seconds"] = time.perf_counter() - t_phase
            emit(rec)
            return

        # 4. the est CLI on seeded JPEGs: --image_only (70% of them train:
        #    67 images, 8 steps an epoch), 2 epochs, bf16, --augmentation,
        #    4 workers
        spe = int(N_JPEGS * 0.7) // b
        jpegs = os.path.join(tmp, "jpegs")
        os.makedirs(jpegs)
        paths = write_jpegs(jpegs, N_JPEGS)
        common = ["--estimator_path", est_path, "--image_root", jpegs,
                  "--device", "cuda",
                  "--dtype", "bf16", "--augmentation", "--num_workers", "4",
                  "--batch_size", str(b), "--input_size", str(size),
                  "--log_dir", os.path.join(tmp, "runs")]
        cli_dir = os.path.join(tmp, "cli")
        windows = []
        t0 = time.perf_counter()
        counted_run(lambda: train_cli(
            ["--image_only", "--num_epoch", "2", "--export_torch",
             "--save_dir", cli_dir, "--name", "image_only"] + common, 8,
            windows), counters, launch_totals,
            {k: 2 * spe * v for k, v in per[bf].items()},
            "est CLI image_only")
        cli_s = time.perf_counter() - t0
        final = torch.load(ckpt.latest_checkpoint(cli_dir, "image_only"),
                           weights_only=True)["global_step"]
        rec["cli_image_only"] = {
            "seconds": cli_s, "steps": final,
            "window_img_per_s": windows,
            "files": sorted(os.listdir(os.path.join(cli_dir, "image_only")))}
        if final != 2 * spe:
            raise AssertionError(f"est CLI image_only ended at step {final}")

        # the frame mode: 2/3 train rows (64: 8 steps), the rest test rows
        #    (the two cached test batches), one epoch, evaluation every 4
        #    steps
        if host["pandas"]:
            import pandas as pd

            frame = os.path.join(tmp, "frame.pkl")
            n_train = N_JPEGS * 2 // 3
            sig = rng.standard_normal((N_JPEGS, 5)) * 3 + 10
            pd.DataFrame({
                "photo": [f"{i:03d}" for i in range(N_JPEGS)],
                "mode": ["train"] * n_train + ["test"] * (N_JPEGS - n_train),
                **{c: sig[:, j] for j, c in enumerate(
                    ["clouds", "temp", "humidity", "pressure",
                     "windspeed"])},
                "condition2": ["Clear"] * N_JPEGS}).to_pickle(frame)
            evals = {"adain": 3 * b, "upsample": 3 * b,
                     "bottleneck": 29 * b}
            windows = []
            counted_run(lambda: train_cli(
                ["--pkl_path", frame, "--num_epoch", "1", "--save_dir",
                 cli_dir, "--name", "frame"] + common, 4, windows),
                counters, launch_totals,
                {k: n_train // b * v + n_train // b // 4 * evals[k]
                 for k, v in per[bf].items()},
                "est CLI frame mode")
            rec["cli_frame"] = {"window_img_per_s": windows, "files": sorted(
                os.listdir(os.path.join(cli_dir, "frame")))}

        # 5. the loader alone: HostAugment at 4 workers, two epochs
        aug = HostAugment(size, resized_crop=True, brightness=0.5,
                          contrast=0.3, saturation=0.3)
        ds = ImagePathDataset(paths[:int(N_JPEGS * 0.7)],
                              out_size=int(size * 1.15),
                              transform=aug)
        t0 = time.perf_counter()
        n = 0
        for epoch in range(2):
            ld = BatchLoader(ds, b, shuffle=True, num_workers=4)
            ld.set_epoch(epoch)
            n += sum(len(batch[0]) for batch in ld)
        loader_ips = n / (time.perf_counter() - t0)
        # a step takes two batches, one from each loader
        rec["loader"] = {
            "img_per_s": loader_ips, "workers": 4,
            "keeps_up_with_bf16_trainer":
                loader_ips >= 2 * rec["bfloat16"]["trainer_img_per_s"]}

        # 6. SIGTERM -> checkpoint -> resume: the CLI in a child process,
        #    stopped once its step-3 checkpoint lands, then relaunched here
        pre_dir = os.path.join(tmp, "preempt")
        argv = ["--image_only", "--num_epoch", "2", "--save_dir", pre_dir,
                "--name", "p"] + common
        rc1, out1, s1 = run_child(argv, stop_when=os.path.join(
            pre_dir, "p", f"ckpt_s{3:010d}.pt"))
        stop = re.search(r"checkpointing at step (\d+)", out1)
        stop_step = int(stop.group(1)) if stop else 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            counted_run(lambda: train_cli(argv, 3, []), counters,
                        launch_totals,
                        {k: (2 * spe - stop_step) * v
                         for k, v in per[bf].items()}, "est CLI resumed")
        out2 = buf.getvalue()
        final = torch.load(ckpt.latest_checkpoint(pre_dir, "p"),
                           weights_only=True)["global_step"]
        rec["preemption"] = {
            "stop_step": stop_step, "final_step": final,
            "child_exit": rc1, "child_s": s1,
            "resumed_s": time.perf_counter() - t0}
        # a stop on an epoch's last step resumes with nothing to skip
        ok = (rc1 == 0 and "preemption: signal 15" in out1
              and 0 < stop_step < 2 * spe
              and os.path.exists(ckpt.checkpoint_path(pre_dir, "p",
                                                      stop_step))
              and "resumed from" in out2
              and ("resume: fast-forwarding" in out2 or stop_step % spe == 0)
              and final == 2 * spe)
        if not ok:
            print(out1[-4000:], out2[-4000:], file=sys.stderr)
            raise AssertionError(f"preemption: {rec['preemption']}")
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)


SUP_BATCH = 64            # the supervised CLIs' default batch
SUP_SIZE = 224            # and input size
SUP_WARMUP, SUP_TIMED = 2, 5
AUG_TOL = 1 / 255 + 1e-3  # native (uint8) vs device augment
# the supervised CLI in a child process; the step wrapper touches the file
# argv[1] after the third step, so that the parent sends SIGTERM while the
# run is under way
PREEMPT_SUP_CHILD = (
    "import sys\n"
    "import weather_unet_tpu_torch.train.supervised as s\n"
    "make, mark = s.make_estimator_step, sys.argv[1]\n"
    "def marked():\n"
    "    step, n = make(), [0]\n"
    "    def run(*a):\n"
    "        out = step(*a)\n"
    "        n[0] += 1\n"
    "        if n[0] == 3:\n"
    "            open(mark, 'w').close()\n"
    "        return out\n"
    "    return run\n"
    "s.make_estimator_step = marked\n"
    "from weather_unet_tpu_torch.cli.train_estimator import main\n"
    "main(sys.argv[2:])\n")


class Labeled:
    """A dataset's images with other targets: ``(ds[i][0], targets[i])``."""

    def __init__(self, ds, targets):
        self.ds, self.targets = ds, targets

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, i):
        return self.ds[i][0], self.targets[i]


def loader_ips(ds, epochs=(0,), b=32):
    """img/s of a 4-thread BatchLoader over ``ds`` for the given epochs."""
    from weather_unet_tpu_torch.data.pipeline import BatchLoader

    t0 = time.perf_counter()
    n = 0
    for epoch in epochs:
        ld = BatchLoader(ds, b, shuffle=True, num_workers=4)
        ld.set_epoch(epoch)
        n += sum(len(batch[0]) for batch in ld)
    return n / (time.perf_counter() - t0)


def sup_run(state, kind, loader, counters, launch_totals, what,
            augment_cfg=None, test=()):
    """``train_supervised`` over ``loader`` (SUP_WARMUP + SUP_TIMED
    batches), one epoch, no kernel launched; the step synchronizes and
    stamps the host clock after each update.  Returns the median ms of the
    timed steps (the loop's time a step: loader wait, normalize or warp,
    step), the peak memory and the last metrics."""
    from weather_unet_tpu_torch.train import supervised as sup
    from weather_unet_tpu_torch.train.loops import train_supervised

    make = (sup.make_classifier_step if kind == "classifier"
            else sup.make_estimator_step)
    step, stamps, last = make(), [], {}

    def timed(*a):
        st, m = step(*a)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        last.update(m)
        return st, m

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(
            io.StringIO()):
        counted_run(lambda: train_supervised(
            timed, sup.make_eval_metrics(kind), lambda: loader,
            lambda: iter(test), state=state, num_epoch=1,
            input_size=SUP_SIZE,
            augment_cfg=augment_cfg, save_dir=tmp, name=what,
            save_per_epoch=1 << 30,
            target_dtype=torch.long if kind == "classifier"
            else torch.float32), counters, launch_totals, {}, what)
    if len(stamps) != SUP_WARMUP + SUP_TIMED:
        raise AssertionError(f"{what}: {len(stamps)} steps")
    ms = float(np.median(np.diff(stamps[SUP_WARMUP - 1:]))) * 1e3
    metrics = {k: float(v) for k, v in last.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{what}: metrics {metrics}")
    return {"step_ms": ms, "img_per_s": SUP_BATCH / ms * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "metrics": metrics}


def sup_params_agree(a, b, lr):
    """Parameters of two supervised states after one step from the same
    weights, over the whole network: the Adam sign-flip bound (fewer than
    0.5% beyond 5e-5, none beyond 2.2 * lr)."""
    pa = torch.cat([p.detach().float().cpu().ravel()
                    for p in a.module.parameters()])
    pb = torch.cat([p.detach().float().cpu().ravel()
                    for p in b.module.parameters()])
    d = (pa - pb).abs()
    return {"loose_share": float((d > 5e-5).float().mean()),
            "max_move_diff": float(d.max()),
            "ok": bool((d > 5e-5).float().mean() < 5e-3
                       and d.max() <= 2.2 * lr + 1e-6)}


def phase_supervised(counters, launch_totals, smi):
    """The native runtime, the decode cache, the device augment and
    supervised ResNet-101 pretraining on the card: the runtime's build; the
    native augment against the device augment (same affine and factors,
    257x257 -> 224x224) and the device augment on the card against the
    CPU; loader img/s of HostAugment, NativeAugment and the decode cache
    (fill, then all hits) on 96 seeded 256x256 JPEGs; augment_batch ms at
    B=64; train_supervised card vs CPU (depth-(1, 1, 1, 1), 32x32, B=4,
    float32), the frozen backbone, and full-width timing (ResNet-101, 5
    outputs, 224x224, B=64, bf16 and float32) over in-memory batches, the
    native-augment loader and the device warp; the estimator CLI with the
    decode cache, SIGTERM -> resume in a child process; the classifier
    CLI.  The supervised path launches none of K1-K4 (asserted)."""
    import shutil

    from weather_unet_tpu_torch import runtime
    from weather_unet_tpu_torch.data.cache import CachedAugment, DecodedCache
    from weather_unet_tpu_torch.data.datasets import ImagePathDataset
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.data.transforms import (
        AugmentConfig, HostAugment, NativeAugment, _affine_sample,
        _color_jitter, affine_from_uniforms, augment_batch,
        augment_from_uniforms, draw_uniforms, normalize_batch)
    from weather_unet_tpu_torch.models import ResNet, ResNet101
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train import supervised as sup
    from weather_unet_tpu_torch.train.loops import train_supervised

    t_phase = time.perf_counter()
    f32, bf = torch.float32, torch.bfloat16
    rt = runtime.load()
    if rt is None or not runtime.augment_available():
        raise AssertionError(f"native runtime: {runtime.build_error()}")
    emit({"phase": "supervised_host", "cxx": shutil.which("c++"),
          "jpeglib_h": any(os.path.exists(os.path.join(d, "jpeglib.h"))
                           for d in ("/usr/include", "/usr/local/include")),
          "jpeg_links": runtime.jpeg_found(), "runtime_mode": rt.mode,
          "runtime_build_s": rt.build_seconds, "runtime_so": rt.path.name})
    rec = {"phase": "supervised", "card": smi, "batch": SUP_BATCH,
           "size": SUP_SIZE, "runtime_mode": rt.mode}
    cfg = AugmentConfig(out_size=SUP_SIZE, resized_crop=True,
                        brightness=0.5, contrast=0.3, saturation=0.3)
    base = int(SUP_SIZE * 1.15)                       # 257

    # 1. native vs device augment, and the device augment card vs CPU
    rng = np.random.default_rng(SEED + 10)
    yy, xx = np.mgrid[:base, :base]
    imgs = np.stack([np.clip(rng.uniform(0, 255, 3) * (0.5 + 0.5 * np.sin(
        xx[..., None] / rng.uniform(8, 40) + yy[..., None]
        / rng.uniform(8, 40))) + rng.normal(0, 12, (base, base, 3)), 0, 255)
        for _ in range(8)]).astype(np.uint8)
    x = torch.from_numpy(imgs).cuda()
    u, fs = draw_uniforms(torch.Generator("cuda").manual_seed(SEED), 8, cfg)
    mats = affine_from_uniforms(u, base, base, cfg)
    dev = _color_jitter(_affine_sample(x, mats, SUP_SIZE), fs, cfg).cpu()
    nat_err = max(float((torch.from_numpy(rt.augment_u8(
        imgs[i], mats[i].cpu().numpy(), fs[i].cpu().numpy(),
        SUP_SIZE)).float() / 255.0 - dev[i]).abs().max()) for i in range(8))
    card_cpu_err = float((augment_from_uniforms(x, u, fs, cfg).cpu()
                          - augment_from_uniforms(x.cpu(), u.cpu(),
                                                  fs.cpu(), cfg)
                          ).abs().max())
    rec["augment_parity"] = {"native_vs_device_max_abs": nat_err,
                             "tol": AUG_TOL,
                             "card_vs_cpu_max_abs": card_cpu_err}
    if not (nat_err <= AUG_TOL and card_cpu_err <= 1e-5):
        raise AssertionError(f"augment parity: {rec['augment_parity']}")
    # augment_batch a B=64 batch at 257x257 on the card
    xb = torch.from_numpy(np.concatenate([imgs] * 8)).cuda()
    g = torch.Generator("cuda").manual_seed(SEED)
    rec["augment_batch_ms"] = time_ms(lambda: augment_batch(g, xb, cfg))

    with tempfile.TemporaryDirectory() as tmp:
        # 2. the loaders alone: 96 JPEGs, 257x257 decode, 4 threads
        jpegs = os.path.join(tmp, "jpegs")
        os.makedirs(jpegs)
        paths = write_jpegs(jpegs, N_JPEGS)
        aug_kw = dict(resized_crop=True, brightness=0.5, contrast=0.3,
                      saturation=0.3)
        loaders = {}
        loaders["host_augment"] = loader_ips(ImagePathDataset(
            paths, base, transform=HostAugment(SUP_SIZE, **aug_kw)))
        native = NativeAugment(SUP_SIZE, **aug_kw)
        loaders["native_augment"] = loader_ips(ImagePathDataset(
            paths, base, transform=native))
        cache = DecodedCache(os.path.join(tmp, "cache"), base, paths)
        cached = ImagePathDataset(paths, base, transform=CachedAugment(
            cache, NativeAugment(SUP_SIZE, **aug_kw)))
        loaders["cache_epoch1_fill"] = loader_ips(cached, (0,))
        fill = (cache.hits, cache.misses)
        loaders["cache_epoch2_hits"] = loader_ips(cached, (1,))
        hits = (cache.hits - fill[0], cache.misses - fill[1])
        loaders["cache_reads"] = {"epoch1": fill, "epoch2": hits}
        loaders["native_route"] = native.route
        if fill != (0, N_JPEGS) or hits != (N_JPEGS, 0):
            raise AssertionError(f"decode cache: {loaders['cache_reads']}")
        rec["loader_img_per_s"] = loaders

        # 3. train_supervised card vs CPU: depth-(1, 1, 1, 1), 32x32, B=4,
        #    float32 (TF32 off), one step of each kind from one init
        small = ResNet((1, 1, 1, 1), 5, generator=torch.Generator()
                       .manual_seed(SEED + 11))
        xs = rng.integers(0, 256, (4, 32, 32, 3), np.uint8)
        targets = {"classifier": rng.integers(0, 5, 4),
                   "estimator": rng.standard_normal((4, 5)).astype(
                       np.float32)}
        parity = {}
        for kind in ("classifier", "estimator"):
            out = {}
            for dev_name in ("cuda", "cpu"):
                model = ResNet((1, 1, 1, 1), 5)
                model.load_state_dict(small.state_dict())
                st = sup.build_supervised_state(model.to(dev_name), 1e-4,
                                                1e-5)
                with tempfile.TemporaryDirectory() as d:
                    make = (sup.make_classifier_step
                            if kind == "classifier"
                            else sup.make_estimator_step)
                    seen = {}

                    def step(*a, make=make, seen=seen):
                        st_, m = make()(*a)
                        seen.update({k: float(v) for k, v in m.items()})
                        return st_, m

                    run = lambda: train_supervised(  # noqa: E731
                        step, sup.make_eval_metrics(kind),
                        lambda: [(xs, targets[kind])], lambda: iter(()),
                        state=st, num_epoch=1, input_size=32, save_dir=d,
                        name="p", target_dtype=torch.long
                        if kind == "classifier" else torch.float32)
                    with contextlib.redirect_stdout(io.StringIO()):
                        if dev_name == "cuda":
                            counted_run(run, counters, launch_totals, {},
                                        f"supervised parity {kind}")
                        else:
                            run()
                out[dev_name] = (st, seen)
            (sc, mc), (sp, mp) = out["cuda"], out["cpu"]
            loss_rel = max(abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-12)
                           for k in mp if k != "accuracy")
            stats = max(float((a.float().cpu() - b.float()).abs().max())
                        for (n, a), b in zip(
                            sc.module.state_dict().items(),
                            sp.module.state_dict().values())
                        if n.endswith(("running_mean", "running_var")))
            parity[kind] = {"loss_rel_err": loss_rel,
                            "bn_stats_max_abs": stats,
                            **sup_params_agree(sc, sp, 1e-4)}
            if not (loss_rel <= 1e-4 and stats <= 1e-5
                    and parity[kind]["ok"]):
                raise AssertionError(f"supervised card vs CPU: {parity}")
        rec["card_vs_cpu"] = parity

        # 4. full width: ResNet-101, 5 outputs, 224x224, B=64
        mem = [(rng.integers(0, 256, (SUP_SIZE, SUP_SIZE, 3), np.uint8),
                rng.standard_normal(5).astype(np.float32))
               for _ in range(SUP_BATCH)]
        mem257 = [(imgs[i % 8], mem[i][1]) for i in range(SUP_BATCH)]
        order = list(range(SUP_BATCH)) * (SUP_WARMUP + SUP_TIMED)
        jpeg_targets = [mem[i % SUP_BATCH][1] for i in range(N_JPEGS)]
        jpeg_order = [i % N_JPEGS for i in range(
            SUP_BATCH * (SUP_WARMUP + SUP_TIMED))]
        # a full test batch and a partial one (padded and masked)
        test = [(np.stack([m[0] for m in part]), np.stack([m[1] for m in
                                                           part]))
                for part in (mem, mem[:48])]

        def batches(ds, idx):
            return BatchLoader(ds, SUP_BATCH, sampler=idx, num_workers=4)

        timing = {}
        for dt in (bf, f32):
            name = DT_NAME[dt]
            model = ResNet101(5, dtype=dt, param_dtype=f32,
                              generator=torch.Generator().manual_seed(SEED))
            st = sup.build_supervised_state(model.cuda(), 1e-4, 1e-5)
            rec["parameters"] = sum(p.numel() for p in model.parameters())
            res = {}
            res["estimator_memory"] = sup_run(
                st, "estimator", batches(mem, order), counters,
                launch_totals, f"est_mem_{name}", test=test)
            res["estimator_native_loader"] = sup_run(
                st, "estimator", batches(Labeled(ImagePathDataset(
                    paths, base,
                    transform=NativeAugment(SUP_SIZE, **aug_kw)),
                    jpeg_targets), jpeg_order), counters, launch_totals,
                f"est_native_{name}")
            res["estimator_device_warp"] = sup_run(
                st, "estimator", batches(mem257, order), counters,
                launch_totals, f"est_warp_{name}", augment_cfg=cfg)
            labels = [(m[0], i % 5) for i, m in enumerate(mem)]
            res["classifier_memory"] = sup_run(
                st, "classifier", batches(labels, order), counters,
                launch_totals, f"cls_mem_{name}")
            # device time of one bare estimator step on an in-memory batch
            xm = torch.from_numpy(np.stack([m[0] for m in mem])).cuda()
            tm = torch.from_numpy(np.stack([m[1] for m in mem])).cuda()
            bare = sup.make_estimator_step()
            busy, n_kernels, top = step_profile(
                lambda: bare(st, normalize_batch(xm), tm))
            for r in res.values():
                r["device_busy_share"] = busy / r["step_ms"]
            res["bare_step_device_ms"] = busy
            res["bare_step_kernels"] = n_kernels
            res["bare_step_top_kernels"] = top
            timing[name] = res
            if dt == bf:
                # the frozen backbone: 3 steps, conv1-layer3 bit-identical
                frozen_model = copy.deepcopy(model)
                fst = sup.build_supervised_state(frozen_model, 1e-4, 1e-5,
                                                 pre_trained=True)
                names = sup.resnet_pretrained_frozen(frozen_model)
                before = {n: p.detach().clone() for n, p in
                          frozen_model.named_parameters()}
                fstep = sup.make_estimator_step()
                counted_run(lambda: [fstep(fst, normalize_batch(xm), tm)
                                     for _ in range(3)], counters,
                            launch_totals, {}, "frozen backbone")
                after = dict(frozen_model.named_parameters())
                same = all(torch.equal(after[n], before[n]) for n in names)
                moved = all(not torch.equal(after[n], before[n])
                            for n in after if n not in names)
                rec["frozen_backbone"] = {
                    "frozen_tensors": len(names),
                    "bit_identical_after_3_steps": same,
                    "trainable_all_moved": moved}
                if not (same and moved):
                    raise AssertionError(f"frozen: {rec['frozen_backbone']}")
                del frozen_model, fst
            del model, st, xm, tm
            torch.cuda.empty_cache()
        rec["timing"] = timing

        # 5. the estimator CLI: 64 train rows (8 steps of 8), 32 test rows,
        #    --decode_cache --augmentation --dtype bf16, 2 epochs; then a
        #    child stopped by SIGTERM after its third step and relaunched
        import pandas as pd

        frame = os.path.join(tmp, "frame.pkl")
        sig = rng.standard_normal((N_JPEGS, 5)) * 3 + 10
        classes = ["Clear", "Clouds", "Rain", "Mist", "Snow"]
        pd.DataFrame({
            "photo": [f"{i:03d}" for i in range(N_JPEGS)],
            "mode": ["train"] * 64 + ["test"] * (N_JPEGS - 64),
            **{c: sig[:, j] for j, c in enumerate(
                ["clouds", "temp", "humidity", "pressure", "windspeed"])},
            "w_condition": [classes[i % 5] for i in range(N_JPEGS)],
            "condition2": [classes[i % 5] for i in range(N_JPEGS)]}
        ).to_pickle(frame)
        common = ["--image_root", jpegs, "--pkl_path", frame, "--device",
                  "cuda", "--decode_cache", os.path.join(tmp, "cli_cache"),
                  "--augmentation", "--dtype", "bf16", "-bs", "8",
                  "--num_epoch", "2", "--num_workers", "4", "--log_dir",
                  os.path.join(tmp, "runs")]
        from weather_unet_tpu_torch.cli.train_estimator import main as est
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            counted_run(lambda: est(common + ["--save_path", os.path.join(
                tmp, "cp"), "--name", "est"]), counters, launch_totals, {},
                "estimator CLI")
        cli_s = time.perf_counter() - t0
        final = torch.load(ckpt.latest_checkpoint(os.path.join(tmp, "cp"),
                                                  "est"),
                           weights_only=True)["global_step"]
        route = re.search(r"train augment: (.*)", buf.getvalue())
        rec["estimator_cli"] = {"seconds": cli_s, "final_step": final,
                                "augment": route.group(1) if route
                                else None}
        if final != 16 or "Done: training" not in buf.getvalue():
            raise AssertionError(f"estimator CLI: {rec['estimator_cli']}")

        pre = os.path.join(tmp, "pre")
        argv = common + ["--save_path", pre, "--name", "p"]
        mark = os.path.join(tmp, "step3")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", PREEMPT_SUP_CHILD, mark, *argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            while (proc.poll() is None and not os.path.exists(mark)
                   and time.perf_counter() - t0 < 240):
                time.sleep(0.02)
            proc.send_signal(__import__("signal").SIGTERM)
            out1, _ = proc.communicate(timeout=240)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        child_s = time.perf_counter() - t0
        stop = re.search(r"checkpointing at step (\d+)", out1)
        stop_step = int(stop.group(1)) if stop else 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            counted_run(lambda: est(argv), counters, launch_totals, {},
                        "estimator CLI resumed")
        out2 = buf.getvalue()
        final = torch.load(ckpt.latest_checkpoint(pre, "p"),
                           weights_only=True)["global_step"]
        rec["preemption"] = {"stop_step": stop_step, "final_step": final,
                             "child_exit": proc.returncode,
                             "child_s": child_s}
        ok = (proc.returncode == 0 and "preemption: signal 15" in out1
              and 0 < stop_step < 16
              and os.path.exists(ckpt.checkpoint_path(pre, "p", stop_step))
              and "resumed from" in out2
              and ("resume: fast-forwarding" in out2 or stop_step % 8 == 0)
              and final == 16)
        if not ok:
            print(out1[-4000:], out2[-4000:], file=sys.stderr)
            raise AssertionError(f"supervised preemption: "
                                 f"{rec['preemption']}")

        # 6. the classifier CLI over a class-path split: 16 train paths (2
        #    steps of 8), 8 test paths, one epoch
        split = {"train": [], "test": []}
        for i, p in enumerate(paths[:24]):
            d = os.path.join(tmp, "i2w", ["sunny", "cloudy", "rain", "snow",
                                          "foggy"][i % 5])
            os.makedirs(d, exist_ok=True)
            os.symlink(p, os.path.join(d, os.path.basename(p)))
            split["train" if i < 16 else "test"].append(
                os.path.join(d, os.path.basename(p)))
        pd.to_pickle(split, os.path.join(tmp, "split.pkl"))
        from weather_unet_tpu_torch.cli.train_classifier import main as cls
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            counted_run(lambda: cls(
                ["--pkl_path", os.path.join(tmp, "split.pkl"), "--device",
                 "cuda", "--augmentation", "--dtype", "bf16", "-bs", "8",
                 "--num_epoch", "1", "--num_workers", "4", "--save_path",
                 os.path.join(tmp, "cls"), "--name", "cls", "--log_dir",
                 os.path.join(tmp, "runs")]), counters, launch_totals, {},
                "classifier CLI")
        final = torch.load(ckpt.latest_checkpoint(os.path.join(tmp, "cls"),
                                                  "cls"),
                           weights_only=True)["global_step"]
        rec["classifier_cli_final_step"] = final
        if final != 2:
            raise AssertionError(f"classifier CLI ended at step {final}")
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)


SERVE_REQUESTS = 96       # HTTP requests per server run
SERVE_CLIENTS = 8         # client threads
N_CLI_JPEGS = 32          # seeded 256x256 JPEGs of the serving world


@contextlib.contextmanager
def recorded_saves():
    """Record the uint8 picture of every ``PIL.Image.save`` by path (the
    JPEG encoder is not continuous: a 1-step difference before it can move
    a decoded pixel further)."""
    from PIL import Image

    saved = {}
    save = Image.Image.save

    def record(self, fp, *args, **kw):
        saved[str(fp)] = np.asarray(self, np.int16)
        return save(self, fp, *args, **kw)

    Image.Image.save = record
    try:
        yield saved
    finally:
        Image.Image.save = save


def serving_world(root, size_jpeg=256):
    """32 seeded JPEGs named by photo id, a Flickr frame over them (16
    train, 16 test rows of one station, hourly, the signals and the class
    columns), a 16-photo directory for the demo, an i2w tree of 5 classes x
    6 photos split 2 train / 4 test, and a 1-photo-a-class split for the
    card-vs-CPU runs."""
    import pandas as pd
    import shutil

    from weather_unet_tpu_torch.data.datasets import (
        SIGNAL_COLUMNS, WEATHER_CLASSES_FLICKR, WEATHER_CLASSES_I2W)

    photos = os.path.join(root, "photos")
    os.makedirs(photos)
    paths = write_jpegs(photos, N_CLI_JPEGS, size=size_jpeg)
    rng = np.random.default_rng(SEED + 20)
    ids = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    df = pd.DataFrame({
        "photo": ids, "mode": ["train"] * 16 + ["test"] * 16,
        "name": "station", "s_unixtime": 1_600_000_000 + 3600 * np.arange(
            len(ids)),
        **{c: rng.standard_normal(len(ids)) * 3 + 10
           for c in SIGNAL_COLUMNS},
        "condition2": [WEATHER_CLASSES_FLICKR[i % 5]
                       for i in range(len(ids))],
        "w_condition": [WEATHER_CLASSES_FLICKR[i % 5]
                        for i in range(len(ids))]})
    frame = os.path.join(root, "frame.pkl")
    df.to_pickle(frame)
    demo_dir = os.path.join(root, "demo_photos")
    os.makedirs(demo_dir)
    for p in paths[:16]:
        shutil.copy(p, demo_dir)
    split = {"train": [], "test": []}
    for ci, cls in enumerate(WEATHER_CLASSES_I2W):
        d = os.path.join(root, "i2w", cls)
        os.makedirs(d)
        for j in range(6):
            dst = os.path.join(d, f"{j}.jpg")
            shutil.copy(paths[(6 * ci + j) % len(paths)], dst)
            split["train" if j < 2 else "test"].append(dst)
    split_pkl = os.path.join(root, "split.pkl")
    pd.to_pickle(split, split_pkl)
    subset_pkl = os.path.join(root, "split_subset.pkl")
    pd.to_pickle({"train": split["train"],
                  "test": [p for p in split["test"]
                           if p.endswith("2.jpg")][:4]}, subset_pkl)
    subset_dir = os.path.join(root, "subset")
    os.makedirs(subset_dir)
    for p in paths[:4]:
        shutil.copy(p, subset_dir)
    return {"photos": photos, "paths": paths, "frame": frame,
            "demo": demo_dir, "split": split_pkl, "subset_split": subset_pkl,
            "subset_dir": subset_dir, "ids": ids}


def serving_checkpoints(root, est_path, device):
    """The seeded cUNet as a reference .pt bundle and as the JAX trainer's
    msgpack GAN layout (written by the port's writer), the seeded ResNet-101
    as a state-dict .pt and as the JAX supervised loop's msgpack; each
    loaded through load_transfer / load_estimator from both files, whose
    state dicts must be bit-equal.  The weights go once through the JAX
    layout first, so the unused AdaIN embedding and BatchNorm's
    num_batches_tracked (which flax does not keep) are what the converters
    write on the way back."""
    from weather_unet_tpu_torch.cli.common import (
        load_estimator, load_transfer)
    from weather_unet_tpu_torch.compat import torch_io
    from weather_unet_tpu_torch.models import ConditionalUNet, SNDisc
    from weather_unet_tpu_torch.train import checkpoint as ckpt

    def tensors(sd):
        return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}

    gen = torch.Generator().manual_seed(SEED + 21)
    cunet = torch_io.cunet_state_dict_to_jax(
        ConditionalUNet(5, generator=gen).state_dict())
    disc = torch_io.sndisc_state_dict_to_jax(SNDisc(5, generator=gen)
                                             .state_dict())
    files = {"cunet_pt": os.path.join(root, "gan.pt"),
             "cunet_msgpack": os.path.join(root, "ckpt_s0000000100.msgpack"),
             "est_pt": os.path.join(root, "est.pt"),
             "est_msgpack": os.path.join(root, "est.msgpack")}
    torch.save({"inference": tensors(torch_io.cunet_state_dict_from_jax(
        cunet)), "epoch": 1, "global_step": 100}, files["cunet_pt"])
    ckpt.save_checkpoint_file(files["cunet_msgpack"], {
        "gen": {"params": cunet["params"], "step": 100},
        "disc": {"params": disc["params"], "step": 100},
        "spectral": disc["spectral"], "epoch": 1, "global_step": 100})
    est = torch_io.resnet_state_dict_to_jax(
        torch.load(est_path, map_location="cpu", weights_only=True))
    torch.save(tensors(torch_io.resnet_state_dict_from_jax(est)),
               files["est_pt"])
    ckpt.save_checkpoint_file(files["est_msgpack"], {
        "params": est["params"], "batch_stats": est["batch_stats"],
        "epoch": 1, "global_step": 100, "epoch_step": 0})
    rec = {"phase": "serving_checkpoints"}
    for name, path in files.items():
        rec[f"{name}_mib"] = os.path.getsize(path) / 2 ** 20
        if name.endswith("msgpack"):
            t0 = time.perf_counter()
            ckpt.restore_checkpoint(path)
            rec[f"{name}_read_ms"] = (time.perf_counter() - t0) * 1e3
    for kind, loader in (("cunet", lambda p: load_transfer(
            p, device=device).state_dict()), ("est", lambda p: load_estimator(
                p, device=device).model.state_dict())):
        t0 = time.perf_counter()
        from_msgpack = loader(files[f"{kind}_msgpack"])
        rec[f"{kind}_msgpack_load_ms"] = (time.perf_counter() - t0) * 1e3
        from_pt = loader(files[f"{kind}_pt"])
        rec[f"{kind}_bit_equal"] = (
            from_pt.keys() == from_msgpack.keys()
            and all(torch.equal(v, from_msgpack[k])
                    for k, v in from_pt.items()))
        rec[f"{kind}_tensors"] = len(from_pt)
    emit(rec)
    if not (rec["cunet_bit_equal"] and rec["est_bit_equal"]):
        raise AssertionError(f"msgpack and .pt loads differ: {rec}")
    return files


# the HTTP clients, in a process of their own so that they do not share the
# server's interpreter lock: argv[1] is a JSON file naming the server, the
# request bodies (files), queries and an output directory for the answers
HTTP_CLIENT_CHILD = r"""
import json, os, sys, threading, time, urllib.request
spec = json.load(open(sys.argv[1]))
bodies = [open(p, "rb").read() for p in spec["bodies"]]
n, k = len(bodies), spec["clients"]
status, ctype, lat = [None] * n, [None] * n, [None] * n
errors = {}
def client(t):
    for i in range(t, n, k):
        t0 = time.perf_counter()
        req = urllib.request.Request(spec["base"] + "/translate?"
                                     + spec["queries"][i], data=bodies[i],
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                body = r.read()
                status[i], ctype[i] = r.status, r.headers["Content-Type"]
        except Exception as e:   # reported whole by the parent, which fails
            errors[i] = f"{type(e).__name__}: {e}"
            continue
        lat[i] = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(spec["out"], f"{i}.jpg"), "wb") as f:
            f.write(body)
threads = [threading.Thread(target=client, args=(t,)) for t in range(k)]
t0 = time.perf_counter()
for th in threads:
    th.start()
for th in threads:
    th.join()
json.dump({"status": status, "ctype": ctype, "lat": lat, "errors": errors,
           "wall": time.perf_counter() - t0},
          open(os.path.join(spec["out"], "result.json"), "w"))
"""


def http_traffic(base, paths, queries, out, clients=SERVE_CLIENTS):
    """POST every (file, query) from ``clients`` threads of a child
    process; returns the answers (status, content type, bytes), the
    per-request latency ms and the wall seconds, both on the child's
    clock."""
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, "spec.json")
    with open(spec, "w") as f:
        json.dump({"base": base, "bodies": paths, "queries": queries,
                   "clients": clients, "out": out}, f)
    subprocess.run([sys.executable, "-c", HTTP_CLIENT_CHILD, spec],
                   check=True, timeout=600)
    with open(os.path.join(out, "result.json")) as f:
        res = json.load(f)
    if res["errors"]:
        raise AssertionError(f"{len(res['errors'])} of {len(paths)} requests "
                             f"failed: {res['errors']}")
    answers = []
    for i, (code, ctype) in enumerate(zip(res["status"], res["ctype"])):
        with open(os.path.join(out, f"{i}.jpg"), "rb") as f:
            answers.append((code, ctype, f.read()))
    return answers, res["lat"], res["wall"]


def http_refusals(base, body):
    """(code of a bad cond, of a bad route, of /profile)."""
    import urllib.error
    import urllib.request

    codes = []
    for url, data in ((f"{base}/translate?cond=1,2", body),
                      (f"{base}/nope", body),
                      (f"{base}/profile?seconds=0.2", b"")):
        try:
            urllib.request.urlopen(urllib.request.Request(
                url, data=data, method="POST"), timeout=60).close()
            codes.append(200)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
    return codes


def phase_http(files, world, counters, launch_totals, smi, device, size):
    """The HTTP server (cli/serve.py) on the msgpack checkpoint, in float32
    and bfloat16, under 8 client threads of a child process."""
    import urllib.request

    from PIL import Image

    from weather_unet_tpu_torch.cli import serve

    paths = [world["paths"][i % len(world["paths"])]
             for i in range(SERVE_REQUESTS)]
    bodies = [open(p, "rb").read() for p in paths]
    runs = os.path.join(os.path.dirname(world["frame"]), "http")
    rng = np.random.default_rng(SEED + 22)
    names = ["sunny", "cloudy", "rain", "snow", "foggy"]
    queries, conds = [], []
    for i in range(SERVE_REQUESTS):
        k = int(rng.integers(0, 5))
        if i % 3 == 0:
            queries.append(f"class={names[k]}")
            conds.append(np.eye(5, dtype=np.float32)[k])
        elif i % 3 == 1:
            queries.append(f"class={k}")
            conds.append(np.eye(5, dtype=np.float32)[k])
        else:
            v = rng.standard_normal(5).astype(np.float32)
            queries.append("cond=" + ",".join(repr(float(x)) for x in v))
            conds.append(v)
    for dt_flag in ([], ["--bf16"]):
        trace_dir = os.path.join(os.path.dirname(world["frame"]),
                                 f"traces{len(dt_flag)}")
        args = ["--cp_path", files["cunet_msgpack"], "--host", "127.0.0.1",
                "--port", "0", "--input_size", str(size), "--max_batch", "16",
                "--device", device] + dt_flag
        if dt_flag:
            args += ["--profile_dir", trace_dir]
        for m in counters.values():
            m.launches = 0
        t0 = time.perf_counter()
        server = serve.build_server(serve.build_parser().parse_args(args))
        warm_s = time.perf_counter() - t0
        warm = {k: m.launches for k, m in counters.items()}
        for k in counters:
            launch_totals[k] += warm[k]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        dtype = "bfloat16" if dt_flag else "float32"
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            for m in counters.values():
                m.launches = 0
            answers, lat, wall = http_traffic(
                base, paths, queries, f"{runs}/{dtype}")
            synchronize(device)
            got = {k: m.launches for k, m in counters.items()}
            stats = server.batcher.stats()
            for k in counters:
                launch_totals[k] += got[k]
            codes = http_refusals(base, bodies[0])
            for m in counters.values():
                m.launches = 0
            # the same traffic again under torch.profiler: the device busy
            # share of the serving window
            busy_ms = None
            if device == "cuda":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    _, _, wall_prof = http_traffic(
                        base, paths, queries, f"{runs}/{dtype}_profiled")
                    torch.cuda.synchronize()
                busy_ms = union_ms([e for e in prof.events()
                                    if e.device_type == DeviceType.CUDA])
            trace = None
            if dt_flag:   # POST /profile (--profile_dir) during 16 requests
                box = {}

                def take():
                    with urllib.request.urlopen(urllib.request.Request(
                            f"{base}/profile?seconds=1.5", data=b"",
                            method="POST"), timeout=120) as r:
                        box["trace"] = json.loads(r.read())["trace"]

                th = threading.Thread(target=take)
                th.start()
                time.sleep(0.3)
                http_traffic(base, paths[:16], queries[:16],
                             f"{runs}/{dtype}_trace")
                th.join(timeout=120)
                trace = box.get("trace")
            synchronize(device)
            for k, m in counters.items():
                launch_totals[k] += m.launches
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        ok = [a[0] == 200 and a[1] == "image/jpeg" for a in answers]
        outs = [np.asarray(Image.open(io.BytesIO(a[2])), np.int16)
                for a in answers]
        shapes_ok = all(o.shape == (size, size, 3) for o in outs)
        rec = {"phase": "serving_http", "dtype": dtype, "card": smi,
               "device": health["device"], "device_name":
               health["device_name"], "requests": SERVE_REQUESTS,
               "clients": SERVE_CLIENTS, "size": size,
               "warmup_s": warm_s, "warmup_launches": warm,
               "requests_per_s": SERVE_REQUESTS / wall,
               "client_p50_ms": float(np.percentile(lat, 50)),
               "client_p90_ms": float(np.percentile(lat, 90)),
               "batch_ms_p50": stats["batch_ms_p50"],
               "batch_ms_p90": stats["batch_ms_p90"],
               "readback_ms_p50": stats["readback_ms_p50"],
               "mean_batch_size": stats["mean_batch_size"],
               "batches": stats["batches"], "launches": got,
               "refusal_codes": codes}
        if busy_ms is not None:
            rec["device_busy_ms"] = busy_ms
            rec["device_busy_share"] = busy_ms / (wall_prof * 1e3)
            rec["requests_per_s_profiled"] = SERVE_REQUESTS / wall_prof
        # answers against the direct translate_u8 through the same encode
        # and what a request's host work costs alone (one thread): the
        # server's Pillow decode + resize of the body, the answer's encode
        direct = []
        t0 = time.perf_counter()
        x = np.stack([serve._decode_resize(b, size) for b in bodies])
        rec["host_decode_ms"] = (time.perf_counter() - t0) * 1e3 / len(x)
        c = np.stack(conds)
        for i in range(0, len(x), 16):
            direct.append(server.transfer.translate_u8(
                x[i:i + 16], c[i:i + 16]).cpu().numpy())
        direct = np.concatenate(direct)
        mean_steps, encoded = [], []
        t0 = time.perf_counter()
        for d in direct:
            encoded.append(io.BytesIO())
            Image.fromarray(d).save(encoded[-1], "JPEG", quality=95)
        rec["host_encode_ms"] = (time.perf_counter() - t0) * 1e3 / len(direct)
        for o, buf in zip(outs, encoded):
            want = np.asarray(Image.open(buf), np.int16)
            mean_steps.append(float(np.abs(o - want).mean()))
        rec["max_mean_step_vs_direct"] = max(mean_steps)
        if trace is not None:
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            rec["profile_trace_events"] = len(events)
            rec["profile_trace_kernels"] = sum(
                e.get("cat") == "kernel" for e in events)
        emit(rec)
        want_launch = {k: 0 for k in counters}
        want_launch.update(adain=3 * stats["batches"],
                           upsample=3 * stats["batches"])
        want_warm = {k: 0 for k in counters}
        n_warm = len(serve.warmup_buckets(16))
        want_warm.update(adain=3 * n_warm, upsample=3 * n_warm)
        if not (all(ok) and shapes_ok and codes == [400, 404,
                                                    403 if not dt_flag
                                                    else 200]):
            raise AssertionError(f"HTTP {dtype}: answers or codes wrong: "
                                 f"{sum(ok)}/{len(ok)} ok, codes {codes}")
        if device == "cuda" and (got != want_launch or warm != want_warm):
            raise AssertionError(f"HTTP {dtype}: launches {got} / warmup "
                                 f"{warm}, expected {want_launch} / "
                                 f"{want_warm} (3 K1 + 3 K2 a forward)")
        if dtype == "float32" and not rec["max_mean_step_vs_direct"] <= 1.0:
            raise AssertionError(f"HTTP float32 answers differ from "
                                 f"translate_u8: {rec['max_mean_step_vs_direct']}")
        if dt_flag and not (rec.get("profile_trace_events") and (
                device != "cuda" or rec["profile_trace_kernels"])):
            raise AssertionError(f"/profile wrote no trace of the traffic: "
                                 f"{trace}")
        if device == "cuda" and not busy_ms > 0:
            raise AssertionError("the profiled traffic ran no kernel")


def union_ms(kernels) -> float:
    """ms covered by the union of the kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def synchronize(device):
    if device == "cuda":
        torch.cuda.synchronize()


def phase_cli(files, world, counters, launch_totals, smi, device, size):
    """The nine inference and eval CLIs in this process, with real argv, on
    the card; each must end without error and write what its JAX
    counterpart writes.  Returns the pictures each saved, by path, for the
    card-vs-CPU check."""
    import importlib

    import pandas as pd

    out = os.path.dirname(world["frame"])
    cp, est = files["cunet_msgpack"], files["est_msgpack"]
    n, n_test, n_i2w_test = N_CLI_JPEGS, 16, 20
    dev = ["--device", device, "--input_size", str(size)]
    # (name, argv, images, forwards, what must exist afterwards)
    runs = [
        ("inf_transfer_c", ["--image_root", world["photos"], "--cp_path", cp,
                            "--image_only", "--output_dir",
                            f"{out}/inf_c"], 5 * n, -(-n // 16),
         lambda: len(os.listdir(f"{out}/inf_c")) == 5 * n),
        ("demo", ["--input_dir", world["demo"], "--cp_path", cp,
                  "--estimator_path", est, "--num_classes", "5",
                  "--batch_size", "8", "--num_frames", "5", "--output_dir",
                  f"{out}/demo"], 5 * 5 * 16, 2 * 5,
         lambda: sorted(os.listdir(f"{out}/demo")) == ["output0.gif",
                                                       "output1.gif"]),
        ("inf_transfer_e", ["--image_root", world["photos"], "--pkl_path",
                            world["frame"], "--cp_path", cp,
                            "--estimator_path", est, "--output_dir",
                            f"{out}/inf_e"], 8 * n_test, n_test // 8,
         lambda: len(os.listdir(f"{out}/inf_e")) == 8 * n_test),
        ("inf_1year_signals", ["--image_root", world["photos"], "--pkl_path",
                               world["frame"], "--photo_id",
                               world["ids"][3], "--cp_path", cp,
                               "--output_dir", f"{out}/year"], n,
         -(-n // 16), lambda: len(os.listdir(f"{out}/year")) == n),
        ("inf_classifier_i2w", ["--image_root", world["photos"], "--pkl_path",
                                world["frame"], "--classifier_path", est,
                                "--output_pkl", f"{out}/labeled.pkl"], n, 0,
         lambda: pd.read_pickle(f"{out}/labeled.pkl")["w_condition"]
         .notna().all()),
        ("eval_class_transfer", ["--pkl_path", world["split"], "--cp_path",
                                 cp, "--classifier_path", est,
                                 "--output_dir", f"{out}/ect"],
         5 * 16, 1, lambda: os.path.exists(f"{out}/ect/cm.pkl")),
        ("eval_estimator_transfer", ["--image_root", world["photos"],
                                     "--pkl_path", world["frame"],
                                     "--cp_path", cp, "--estimator_path",
                                     est], n_test * n_test, n_test,
         lambda: True),
        ("eval_classifier_i2w", ["--pkl_path", world["split"],
                                 "--classifier_path", est,
                                 "--copy_misclassified", "--output_dir",
                                 f"{out}/eci"], n_i2w_test, 0,
         lambda: os.path.exists(f"{out}/eci/cm.pkl")),
        ("eval_estimator", ["--image_root", world["photos"], "--pkl_path",
                            world["frame"], "--estimator_path", est,
                            "--plot", "--output_dir", f"{out}/ee"], n_test,
         0, lambda: os.path.exists(f"{out}/ee/errors.pkl")),
    ]
    with recorded_saves() as saved:
        for name, argv, images, forwards, wrote in runs:
            main_fn = importlib.import_module(
                f"weather_unet_tpu_torch.cli.{name}").main
            for m in counters.values():
                m.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as text:
                result = main_fn(argv + dev)
            synchronize(device)
            seconds = time.perf_counter() - t0
            got = {k: m.launches for k, m in counters.items()}
            for k in counters:
                launch_totals[k] += got[k]
            rec = {"phase": "serving_cli", "cli": name, "card": smi,
                   "size": size, "images": images, "seconds": seconds,
                   "img_per_s": images / seconds, "forwards": forwards,
                   "launches": got, "stdout_tail":
                   text.getvalue().strip().splitlines()[-1:]}
            if isinstance(result, dict) and "text" in result:
                rec["accuracy"] = result["report"].get("accuracy")
            elif isinstance(result, dict) and "signed_mean" in result:
                rec["finite"] = bool(np.isfinite(result["signed_mean"]).all())
            emit(rec)
            want = {k: 0 for k in counters}
            want.update(adain=3 * forwards, upsample=3 * forwards)
            if device == "cuda" and got != want:
                raise AssertionError(f"{name}: launches {got} != {want}")
            if not wrote() or rec.get("finite") is False:
                raise AssertionError(f"{name}: outputs missing or wrong")
    return saved


def phase_card_vs_cpu(files, world, card_saved, smi, device, size):
    """inf_transfer_c and eval_class_transfer on the CPU (--device cpu) on a
    4-image subset against the card: saved pictures within 1 uint8 step;
    labels equal where the CPU's top-two logits are more than 1e-3
    apart."""
    import weather_unet_tpu_torch.cli.common as common
    from weather_unet_tpu_torch.cli import eval_class_transfer, inf_transfer_c

    out = os.path.dirname(world["frame"])
    with recorded_saves() as saved, contextlib.redirect_stdout(io.StringIO()):
        inf_transfer_c.main(["--image_root", world["subset_dir"],
                             "--cp_path", files["cunet_msgpack"],
                             "--image_only", "--batch_size", "4",
                             "--input_size", str(size), "--device", "cpu",
                             "--output_dir", f"{out}/inf_c_cpu"])
    worst, n_pics = 0, 0
    for f in sorted(os.listdir(f"{out}/inf_c_cpu")):
        cpu = saved[os.path.join(out, "inf_c_cpu", f)]
        card = card_saved[os.path.join(out, "inf_c", f)]
        worst = max(worst, int(np.abs(cpu - card).max()))
        n_pics += 1

    logits = {}
    load = common.load_estimator

    def recording(path, *a, **kw):
        apply = load(path, *a, **kw)

        def rec(images):
            y = apply(images)
            logits[run].append(y.float().cpu())
            return y
        return rec

    common.load_estimator = recording
    try:
        for run in (device, "cpu_run"):
            logits[run] = []
            with contextlib.redirect_stdout(io.StringIO()):
                eval_class_transfer.main([
                    "--pkl_path", world["subset_split"], "--cp_path",
                    files["cunet_msgpack"], "--classifier_path",
                    files["est_msgpack"], "--batch_size", "4",
                    "--input_size", str(size), "--device",
                    "cpu" if run == "cpu_run" else device,
                    "--output_dir", f"{out}/ect_{run}"])
    finally:
        common.load_estimator = load
    card_l, cpu_l = torch.cat(logits[device]), torch.cat(logits["cpu_run"])
    top2 = cpu_l.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    differ = card_l.argmax(1) != cpu_l.argmax(1)
    rec = {"phase": "serving_card_vs_cpu", "card": smi, "size": size,
           "inf_transfer_c_pictures": n_pics, "max_step": worst,
           "labels": int(len(cpu_l)), "labels_differ": int(differ.sum()),
           "labels_differ_clear": int((differ & clear).sum()),
           "logits_max_abs": float((card_l - cpu_l).abs().max())}
    emit(rec)
    if n_pics != 20 or worst > 1 or rec["labels_differ_clear"]:
        raise AssertionError(f"card vs CPU CLIs disagree: {rec}")


def phase_serving_cli(est_path, counters, launch_totals, smi,
                      device="cuda", size=224):
    """Phase serving_cli: checkpoints, the HTTP server and the nine CLIs at
    full width (the 7.8 M-parameter cUNet, the seeded 42.5 M-parameter
    ResNet-101), float32 with TF32 off, through K1 and K2."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        world = serving_world(tmp)
        files = serving_checkpoints(tmp, est_path, device)
        phase_http(files, world, counters, launch_totals, smi, device, size)
        saved = phase_cli(files, world, counters, launch_totals, smi, device,
                          size)
        phase_card_vs_cpu(files, world, saved, smi, device, size)
    emit({"phase": "serving_cli_done",
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------- eval_export

FID_BATCH = 50            # fid_score's default --batch-size
N_FID_JPEGS = 64          # seeded 256x256 JPEGs in each FID directory
FEATURE_TOL = 1e-4        # card vs CPU pool3 features (float32), rel. L2
# bfloat16 pool3 features against float32, relative L2: the calibrated
# random network amplifies a rounding ~60x (tests/test_torch_inception.py),
# so bfloat16's 2^-9 arrives as O(0.05)
FEATURE_TOL_BF16 = 0.25
ART_SIZE = 256            # export_serving's default --input_size
ART_BATCHES = (1, 3, 16)
ART_REQUESTS, ART_CLIENTS = 16, 4


def inception_weights(path, seed, x, **kw):
    """A seeded Inception-v3 (``kw``: head and variant) with BatchNorm
    calibrated on the card on ``x`` (NCHW in [0, 1]), saved as a state-dict
    .pth at ``path``."""
    from weather_unet_tpu_torch.models.inception_fid import (
        InceptionV3FID, calibrate_batchnorm)

    model = InceptionV3FID(generator=torch.Generator().manual_seed(seed),
                           **kw).cuda()
    calibrate_batchnorm(model, x)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    return path


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def launches_of(counters):
    return {k: m.launches for k, m in counters.items()}


def reset(counters):
    for m in counters.values():
        m.launches = 0


def phase_fid_is(root, counters, smi):
    """Inception-v3 at full width on seeded random weights: the FID
    features at 299x299 (batch 50, float32 with TF32 off and bfloat16),
    card against CPU; the fid_score CLI over two directories, its
    --save-stats .npz against the other directory; the inception_score CLI
    over one directory.  No K1-K4 launch."""
    from weather_unet_tpu_torch.cli import fid_score, inception_score
    from weather_unet_tpu_torch.cli.common import list_images
    from weather_unet_tpu_torch.compat.torch_io import inception_state_dict
    from weather_unet_tpu_torch.evaluation import fid
    from weather_unet_tpu_torch.models.inception_fid import InceptionV3FID

    dirs = {}
    for i, name in enumerate(("a", "b")):
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])
        write_jpegs(dirs[name], N_FID_JPEGS, seed=SEED + 30 + i)
    batches = {k: list(fid._image_batches(list_images(d), FID_BATCH))
               for k, d in dirs.items()}
    calib = torch.from_numpy(batches["a"][0]).cuda().permute(0, 3, 1, 2)
    w_fid = inception_weights(os.path.join(root, "pt_inception.pth"),
                              SEED + 32, calib.contiguous(),
                              with_logits=True)                 # 1008-way
    w_tv = inception_weights(os.path.join(root, "inception_v3.pth"),
                             SEED + 33, calib.contiguous(), with_logits=True,
                             num_logits=1000, tf_variant=False)
    reset(counters)
    rec = {"phase": "eval_inception", "card": smi, "batch": FID_BATCH,
           "images": 2 * N_FID_JPEGS, "input": "256x256 JPEG -> 299x299"}
    acts, fids = {}, {}
    x_dev = torch.from_numpy(batches["a"][0]).cuda().permute(
        0, 3, 1, 2).contiguous()
    for dt in DTYPES:
        name = DT_NAME[dt]
        fn = fid.make_feature_fn(w_fid, dt, device="cuda")
        fn(batches["a"][0])     # cuDNN picks its algorithms: not timed
        t0 = time.perf_counter()
        acts[dt] = {k: fid.get_activations(iter(b), fn)
                    for k, b in batches.items()}
        rec[f"{name}_features_img_per_s"] = (
            2 * N_FID_JPEGS / (time.perf_counter() - t0))
        stats = [fid.compute_statistics(acts[dt][k]) for k in ("a", "b")]
        # the host's sqrtm (its seconds are the Frechet distance's); scipy
        # warns where 64 images leave the covariances singular
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            fids[dt] = fid.frechet_distance(*stats[0], *stats[1])
            rec[f"{name}_sqrtm_s"] = time.perf_counter() - t0
        rec[f"{name}_fid"] = fids[dt]
        rec[f"{name}_sqrtm_warnings"] = sorted({
            f"{w.category.__name__}: {str(w.message)[:60]}" for w in caught})
        # the network alone on a batch already on the card
        model = InceptionV3FID(dtype=dt)
        model.load_state_dict(inception_state_dict(
            torch.load(w_fid, weights_only=True), with_logits=False))
        model = model.cuda().eval()
        with torch.inference_mode():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ips = ips_of(lambda: model(x_dev), FID_BATCH)
            rec[f"{name}_img_per_s"] = ips
            rec[f"{name}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(x_dev)
                torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        rec[f"{name}_device_ms"] = union_ms(kernels)
        rec[f"{name}_kernels"] = len(kernels)
        rec[f"{name}_busy_share"] = union_ms(kernels) / (
            1e3 * FID_BATCH / ips)
        del model
    cpu_fn = fid.make_feature_fn(w_fid, device="cpu")
    cpu = cpu_fn(batches["a"][0][:8])
    card = acts[torch.float32]["a"][:8]
    rec["card_vs_cpu_rel_l2"] = rel_l2(card, cpu)
    rec["bf16_vs_f32_rel_l2"] = rel_l2(acts[torch.bfloat16]["a"],
                                       acts[torch.float32]["a"])
    rec["feature_scale"] = float(np.abs(card).mean())
    rec["launches"] = launches_of(counters)
    emit(rec)
    if not (rec["card_vs_cpu_rel_l2"] <= FEATURE_TOL
            and rec["bf16_vs_f32_rel_l2"] <= FEATURE_TOL_BF16
            and all(np.isfinite(v) for v in fids.values())
            and all(np.isfinite(a[k]).all() and a[k].shape == (
                N_FID_JPEGS, 2048) for a in acts.values() for k in a)):
        raise AssertionError(f"Inception features or FID wrong: {rec}")
    if any(rec["launches"].values()):
        raise AssertionError(f"the Inception path launched K1-K4: {rec}")

    # the CLIs as a user runs them (float32, batch 50, the card)
    cli = {"phase": "eval_clis", "card": smi}
    argv = [dirs["a"], dirs["b"], "--weights", w_fid, "--device", "cuda"]
    stats_npz = os.path.join(root, "a.npz")
    with contextlib.redirect_stdout(io.StringIO()) as text:
        t0 = time.perf_counter()
        cli["fid"] = fid_score.main(argv)
        cli["fid_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fid_score.main(argv + ["--save-stats", stats_npz])
        cli["save_stats_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli["fid_npz"] = fid_score.main([stats_npz, dirs["b"], "--weights",
                                         w_fid, "--device", "cuda"])
        cli["fid_npz_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli["is_mean"], cli["is_std"] = inception_score.main([
            "--image_dir", dirs["a"], "--weights", w_tv, "--device", "cuda"])
        cli["is_s"] = time.perf_counter() - t0
    cli["stdout"] = [ln for ln in text.getvalue().splitlines()
                     if ln.startswith(("FID", "IS", "saved", "FID inc",
                                       "torchvision"))]
    cli["fid_img_per_s"] = 2 * N_FID_JPEGS / cli["fid_s"]
    cli["save_stats_img_per_s"] = N_FID_JPEGS / cli["save_stats_s"]
    cli["is_img_per_s"] = N_FID_JPEGS / cli["is_s"]
    cli["launches"] = launches_of(counters)
    emit(cli)
    close = lambda a, b: abs(a - b) <= 1e-6 * max(1.0, abs(b))  # noqa: E731
    if not (close(cli["fid_npz"], cli["fid"])
            and close(cli["fid"], fids[torch.float32])
            and np.isfinite(cli["is_mean"]) and cli["is_mean"] >= 1.0):
        raise AssertionError(f"FID / IS CLIs disagree: {cli}")
    if any(cli["launches"].values()):
        raise AssertionError(f"the FID / IS CLIs launched K1-K4: {cli}")
    return dirs


def artifact_tensors_on(program) -> set:
    """Device types of an exported program's parameters and buffers (the
    weights and translate_u8's table)."""
    return {t.device.type for t in itertools.chain(program.parameters(),
                                                   program.buffers())}


def phase_export(root, dirs, counters, launch_totals, smi):
    """The use_pallas cUNet at full width exported through export_serving
    --check in float32 (TF32 off) and bfloat16; ExportedTransfer against
    the live WeatherTransfer at batches 1, 3 and 16; K1 and K2 3 times a
    forward of the program (counters and torch.profiler); img/s at batch
    16 against the live forward; then serve --artifact under 4 client
    threads of a child process."""
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.cli import export_serving
    from weather_unet_tpu_torch.core.export import ExportedTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet

    pt = os.path.join(root, "cunet.pt")
    torch.save({"inference": ConditionalUNet(
        5, generator=torch.Generator().manual_seed(SEED + 34)).state_dict(),
        "epoch": 0, "global_step": 0}, pt)
    arts, live, art_dirs = {}, {}, {}
    for dt in DTYPES:
        flag = "bf16" if dt == torch.bfloat16 else "f32"
        art_dirs[dt] = out = os.path.join(root, f"art_{flag}")
        rec = {"phase": "eval_export", "dtype": DT_NAME[dt], "card": smi,
               "size": ART_SIZE}
        reset(counters)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            export_serving.main(["--cp_path", pt, "--out", out,
                                 "--input_size", str(ART_SIZE), "--dtype",
                                 flag, "--device", "cuda", "--check"])
        rec["export_check_s"] = time.perf_counter() - t0
        rec["cli"] = json.loads(text.getvalue().strip().splitlines()[-1])
        rec["check_launches"] = launches_of(counters)     # 2 forwards, B=2
        for k in counters:
            launch_totals[k] += rec["check_launches"][k]
        rec["artifact_mib"] = sum(
            os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)
        ) / 2 ** 20
        t0 = time.perf_counter()
        arts[dt] = ExportedTransfer(out)
        rec["load_ms"] = (time.perf_counter() - t0) * 1e3
        rec["tensors_on"] = sorted(
            artifact_tensors_on(arts[dt]._translate)
            | artifact_tensors_on(arts[dt]._translate_u8))
        live[dt] = WeatherTransfer.load(pt, dtype=dt)
        emit(rec)
        want_check = {k: 0 for k in counters}
        want_check.update(adain=6, upsample=6)
        if not (rec["cli"]["checked"] and rec["tensors_on"] == ["cuda"]
                and rec["check_launches"] == want_check
                and live[dt].model.use_pallas):
            raise AssertionError(f"export {flag}: {rec}")

    rng = np.random.default_rng(SEED + 35)
    parity = {"phase": "eval_export_parity", "card": smi, "size": ART_SIZE}
    for b in ART_BATCHES:
        x = rng.uniform(-1, 1, (b, ART_SIZE, ART_SIZE, 3)).astype(np.float32)
        c = np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)]
        u8 = rng.integers(0, 256, (b, ART_SIZE, ART_SIZE, 3), dtype=np.uint8)
        f32 = live[torch.float32].translate(x, c).float()
        for dt in DTYPES:
            name = DT_NAME[dt]
            reset(counters)
            got = arts[dt].translate(x, c).float()
            got_u8 = arts[dt].translate_u8(u8, c)
            torch.cuda.synchronize()
            n = launches_of(counters)
            for k in counters:
                launch_totals[k] += n[k]
            same = live[dt].translate(x, c).float()
            # the export must not change the function: the program against
            # the live model in its dtype; and a bfloat16 program no
            # further from float32 than the live bfloat16 model is
            key = f"{name}_b{b}"
            parity[f"{key}_mae_vs_live"] = float((got - same).abs().mean())
            parity[f"{key}_mae_vs_live_f32"] = float((got - f32).abs().mean())
            parity[f"{key}_live_mae_vs_live_f32"] = float(
                (same - f32).abs().mean())
            parity[f"{key}_u8_max_step"] = int(
                (got_u8.int() - live[dt].translate_u8(u8, c).int()).abs()
                .max())
            parity[f"{key}_launches"] = n
            want = {k: 0 for k in counters}
            want.update(adain=6, upsample=6)     # translate + translate_u8
            if not (parity[f"{key}_mae_vs_live"] <= 1e-5
                    and parity[f"{key}_mae_vs_live_f32"]
                    <= parity[f"{key}_live_mae_vs_live_f32"] + 1e-5
                    and parity[f"{key}_u8_max_step"] <= 1
                    and n == want):
                raise AssertionError(f"artifact {name} at batch {b}: "
                                     f"{parity}")
    # kernel names of one forward of each program, and img/s at batch 16
    for dt in DTYPES:
        name = DT_NAME[dt]
        x16 = torch.from_numpy(rng.uniform(-1, 1, (16, ART_SIZE, ART_SIZE, 3))
                               .astype(np.float32)).cuda().to(dt)
        c16 = torch.eye(5, device="cuda")[torch.arange(16) % 5].to(dt)
        for _ in range(5):    # a profile can lose a short kernel's record
            names = device_kernels(lambda: arts[dt].translate(x16, c16))[0]
            seen = (sum("adain" in n for n in names),
                    sum("upsample2x" in n for n in names))
            if seen == (3, 3):
                break
        parity[f"{name}_profiled_k1_k2"] = seen
        if seen != (3, 3):
            raise AssertionError(f"artifact {name}: profiler saw K1, K2 "
                                 f"{seen} times, expected 3 each: {names}")
        for b in (4, 16):      # a server's typical group, and a full one
            runs = []
            for what in ("live", "artifact", "artifact", "live"):
                wt = live[dt] if what == "live" else arts[dt]
                runs.append((what, ips_of(
                    lambda: wt.translate(x16[:b], c16[:b]), b)))
            for what in ("live", "artifact"):
                parity[f"{name}_{what}_img_per_s_b{b}"] = [
                    v for w, v in runs if w == what]
    reset(counters)
    emit(parity)
    phase_serve_artifact(art_dirs[torch.float32], arts[torch.float32], pt,
                         dirs, counters, launch_totals, smi)


def phase_serve_artifact(art_dir, art, pt, dirs, counters, launch_totals,
                         smi):
    """serve --artifact (float32) answers 16 POSTs of 256x256 JPEGs from 4
    client threads of a child process; then the same traffic to a server
    of the live model (--cp_path) for comparison."""
    from PIL import Image

    from weather_unet_tpu_torch.cli import serve

    paths = sorted(os.path.join(dirs["a"], f)
                   for f in os.listdir(dirs["a"]))[:ART_REQUESTS]
    ks = [i % 5 for i in range(ART_REQUESTS)]
    queries = [f"class={k}" for k in ks]
    live_rps = {}
    for source in (["--cp_path", pt, "--input_size", str(ART_SIZE)],
                   ["--artifact", art_dir]):
        reset(counters)
        server = serve.build_server(serve.build_parser().parse_args(
            source + ["--host", "127.0.0.1", "--port", "0", "--max_batch",
                      "16", "--device", "cuda"]))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            for run in range(2):
                _, _, wall = http_traffic(
                    base, paths, queries, os.path.join(os.path.dirname(
                        art_dir), f"http_{source[0][2:]}_{run}"),
                    clients=ART_CLIENTS)
                live_rps.setdefault(source[0][2:], []).append(
                    ART_REQUESTS / wall)
            torch.cuda.synchronize()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        for k, n in launches_of(counters).items():
            launch_totals[k] += n
    reset(counters)
    t0 = time.perf_counter()
    args = serve.build_parser().parse_args([
        "--artifact", art_dir, "--host", "127.0.0.1", "--port", "0",
        "--max_batch", "16", "--device", "cuda"])
    server = serve.build_server(args)
    warm_s = time.perf_counter() - t0
    warm = launches_of(counters)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset(counters)
        answers, lat, wall = http_traffic(
            base, paths, queries, os.path.join(os.path.dirname(art_dir),
                                               "http_artifact"),
            clients=ART_CLIENTS)
        torch.cuda.synchronize()
        got = launches_of(counters)
        stats = server.batcher.stats()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for k in counters:
        launch_totals[k] += warm[k] + got[k]
    x = np.stack([serve._decode_resize(open(p, "rb").read(), args.input_size)
                  for p in paths])
    direct = art.translate_u8(x, np.eye(5, dtype=np.float32)[ks]).cpu()
    steps = []
    for (code, ctype, body), d in zip(answers, direct.numpy()):
        buf = io.BytesIO()
        Image.fromarray(d).save(buf, "JPEG", quality=95)
        o = np.asarray(Image.open(io.BytesIO(body)), np.int16)
        w = np.asarray(Image.open(buf), np.int16)
        steps.append(float(np.abs(o - w).mean()) if o.shape == w.shape
                     else float("inf"))
    rec = {"phase": "eval_serve_artifact", "card": smi, "dtype": "float32",
           "size": args.input_size, "requests": ART_REQUESTS,
           "clients": ART_CLIENTS, "warmup_s": warm_s,
           "warmup_launches": warm, "requests_per_s": ART_REQUESTS / wall,
           "client_p50_ms": float(np.percentile(lat, 50)),
           "client_p90_ms": float(np.percentile(lat, 90)),
           "batches": stats["batches"],
           "mean_batch_size": stats["mean_batch_size"],
           "batch_ms_p50": stats["batch_ms_p50"], "launches": got,
           "max_mean_step_vs_direct": max(steps),
           "requests_per_s_runs_live_vs_artifact": live_rps}
    emit(rec)
    want = {k: 0 for k in counters}
    want.update(adain=3 * stats["batches"], upsample=3 * stats["batches"])
    n_warm = len(serve.warmup_buckets(16))
    want_warm = {k: 0 for k in counters}
    want_warm.update(adain=3 * n_warm, upsample=3 * n_warm)
    if not (all(a[0] == 200 and a[1] == "image/jpeg" for a in answers)
            and rec["max_mean_step_vs_direct"] <= 1.0
            and got == want and warm == want_warm
            and args.input_size == ART_SIZE):
        raise AssertionError(f"serve --artifact: {rec}")


def phase_eval_export(counters, launch_totals, smi):
    """Phase eval_export: FID and IS through Inception-v3 at full width,
    then the exported serving artifact and serve --artifact."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = phase_fid_is(tmp, counters, smi)
        phase_export(tmp, dirs, counters, launch_totals, smi)
    emit({"phase": "eval_export_done",
          "seconds": time.perf_counter() - t_phase})


def kernels_line(summary, launch_totals):
    meta = {
        "adain": ("weather_unet_tpu_torch/csrc/adain.cu",
                  "weather_unet_tpu/kernels/adain_pallas.py:74"),
        "upsample": ("weather_unet_tpu_torch/csrc/upsample.cu",
                     "weather_unet_tpu/kernels/upsample_pallas.py:170"),
        "upconv": ("weather_unet_tpu_torch/csrc/upconv.cu",
                   "weather_unet_tpu/kernels/upconv_pallas.py:145"),
        "bottleneck": ("weather_unet_tpu_torch/csrc/bottleneck_tc.cuh",
                       "weather_unet_tpu/kernels/bottleneck_pallas.py:92"),
    }

    def totals(name, dt, sites):
        """One forward's worth of the kernel's records over ``sites``."""
        recs = [(summary[name][dt][s], n) for s, n in sites.items()]

        def total(key):
            if any(r.get(key) is None for r, _ in recs):
                return None
            return sum(n * r[key] for r, n in recs)

        out = {"max_abs_err": max(r["max_abs_err"] for r, _ in recs),
               "ms": total("ms"), "launch_only_ms": total("launch_only_ms"),
               "device_ms": total("device_ms"),
               "cold_l2_ms": total("cold_l2_ms"),
               "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
               "bound_by": max(recs, key=lambda rn: rn[1] * rn[0]["bound_ms"]
                               )[0]["bound_by"],
               "library_ms": total("library_ms")}
        if "gflop" in recs[0][0]:
            out["tflops"] = total("gflop") / out["launch_only_ms"]
            out["variant"] = {s: r["variant"]
                              for (r, _), s in zip(recs, sites)}
        return out

    entries = []
    for name, (source, replaces) in meta.items():
        per_dt = {}
        for dt in DTYPES:
            per_dt[DT_NAME[dt]] = totals(name, dt, MAIN_SITES[name])
            if name in GAN_SITES:
                per_dt[DT_NAME[dt]]["gan_step_forward"] = totals(
                    name, dt, GAN_SITES[name])
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launch_totals[name],
                 **per_dt["bfloat16"], "dtype": "bfloat16",
                 "sites": MAIN_SITES[name],
                 "gan_sites": GAN_SITES.get(name),
                 "float32": per_dt["float32"]}
        entries.append(entry)
    emit({"kernels": entries})


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; this "
                         "script runs the port on a GPU")
    from weather_unet_tpu_torch.kernels import (
        adain as k1, bottleneck as k4, upconv as k3, upsample as k2)
    from weather_unet_tpu_torch.models import ConditionalUNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"adain": k1, "upsample": k2, "upconv": k3, "bottleneck": k4}

    smi = phase_env()
    phase_build()
    summary = phase_kernels()

    launch_totals = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(SEED)
        path = os.path.join(tmp, "cunet.pt")
        torch.save({"inference": ConditionalUNet(5).state_dict(), "epoch": 0,
                    "global_step": 0}, path)
        wts = phase_e2e(path, counters, launch_totals)
        phase_serve(wts["fuse_upconv", torch.float32], counters,
                    launch_totals)
        est_path = os.path.join(tmp, "estimator.pt")
        make_estimator_checkpoint(est_path)
        phase_estimator(est_path, wts["use_pallas", torch.float32], counters,
                        launch_totals)
        gan_records = phase_gan(est_path, counters, launch_totals)
        phase_train(est_path, counters, launch_totals, gan_records, smi)
        phase_supervised(counters, launch_totals, smi)
        phase_serving_cli(est_path, counters, launch_totals, smi)
    phase_eval_export(counters, launch_totals, smi)
    for name, total in launch_totals.items():
        if total == 0:
            raise AssertionError(f"{name} kernel never ran on the main path")
    kernels_line(summary, launch_totals)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
