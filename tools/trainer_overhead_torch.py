#!/usr/bin/env python3
"""Where the GAN trainer's time goes beyond the bare step, on a GPU.

    python3 tools/trainer_overhead_torch.py

The trainer of ``train/loops.py`` at full width (224x224, batch 8, est
mode, dropout 0.3, the seeded ResNet-101 of ``chip_smoke.py`` through
``load_step_estimator``, K1 + K2 in the generator) in bfloat16 (K4 route)
and float32, timed as ``chip_smoke.py`` phase ``train`` times it: the host
clock around ``STEPS`` unsynchronized steps, synchronized at the end.  Each
variant adds one layer of the trainer to the one before:

  bare        the step on two batches already normalized on the card
  normalize   + normalize_batch of two uint8 batches already on the card
  prefetch    + device_prefetch of numpy batches (pinned copies on a side
              stream), no loader
  loader_w1   train_epoch over two BatchLoaders of 1 thread each
  loader_w4   the same with 4 threads each (the CLIs' default)

The variants run in turns, ``ROUNDS`` times, rotating which goes first; one
JSON line per dtype and variant gives the median ms a step and every round.
The first line is the card's name and power limit from nvidia-smi.  Needs
a CUDA device; imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from weather_unet_tpu_torch.cli.common import load_step_estimator  # noqa: E402
from weather_unet_tpu_torch.data.pipeline import (  # noqa: E402
    BatchLoader, device_prefetch)
from weather_unet_tpu_torch.data.transforms import normalize_batch  # noqa: E402
from weather_unet_tpu_torch.kernels import _build  # noqa: E402
from weather_unet_tpu_torch.train.gan import (  # noqa: E402
    GanConfig, make_gan_step)
from weather_unet_tpu_torch.train.loops import (  # noqa: E402
    WeatherTransferTrainer)

STEPS, ROUNDS, B, SIZE = 10, 3, 8, 224
VARIANTS = ("bare", "normalize", "prefetch", "loader_w1", "loader_w4")


def timed(fn) -> float:
    """ms a step of ``fn()``, which runs STEPS steps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEPS * 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    rng = np.random.default_rng(0)
    mem = [(rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8),
            np.zeros(5, np.float32), str(i)) for i in range(2 * STEPS * B)]
    content, rand = mem[:STEPS * B], mem[STEPS * B:]

    def collated(part):
        return [(np.stack([m[0] for m in part[i * B:(i + 1) * B]]),)
                for i in range(STEPS)]

    with tempfile.TemporaryDirectory() as tmp:
        est_path = os.path.join(tmp, "estimator.pt")
        cs.make_estimator_checkpoint(est_path)
        for dt in (torch.bfloat16, torch.float32):
            cfg = GanConfig(input_size=SIZE, batch_size=B, dtype=dt)
            est = load_step_estimator(est_path, dtype=dt, device="cuda")
            tr = WeatherTransferTrainer(
                cfg, est, save_dir=os.path.join(tmp, "cp"),
                log_dir=os.path.join(tmp, "runs"), device="cuda")
            step = make_gan_step(tr.gen, tr.disc, est, cfg)
            z = torch.zeros(B, dtype=torch.long, device="cuda")
            g = torch.Generator("cuda").manual_seed(0)
            u8 = [torch.from_numpy(c[0][0]).cuda()
                  for c in (collated(content), collated(rand))]
            x, r = (normalize_batch(t) for t in u8)
            host = (collated(content), collated(rand))

            def bare():
                for _ in range(STEPS):
                    step(tr.state, x, z, r, z, g, do_g=True)

            def normalize():
                for _ in range(STEPS):
                    step(tr.state, normalize_batch(u8[0]), z,
                         normalize_batch(u8[1]), z, g, do_g=True)

            def prefetch():
                for (a,), (b,) in zip(device_prefetch(host[0], "cuda"),
                                      device_prefetch(host[1], "cuda")):
                    step(tr.state, normalize_batch(a), z, normalize_batch(b),
                         z, g, do_g=True)

            def loader(workers):
                return lambda: tr.train_epoch(
                    BatchLoader(content, B, shuffle=True,
                                num_workers=workers),
                    BatchLoader(rand, B, shuffle=True, seed=1,
                                num_workers=workers))

            fns = {"bare": bare, "normalize": normalize, "prefetch": prefetch,
                   "loader_w1": loader(1), "loader_w4": loader(4)}
            for fn in fns.values():         # warm-up
                fn()
            times = {k: [] for k in VARIANTS}
            for rnd in range(ROUNDS):
                order = VARIANTS[rnd % len(VARIANTS):] + VARIANTS[
                    :rnd % len(VARIANTS)]
                for k in order:
                    times[k].append(timed(fns[k]))
            for k in VARIANTS:
                print(json.dumps({
                    "dtype": str(dt).replace("torch.", ""), "variant": k,
                    "batch": B, "size": SIZE, "steps": STEPS,
                    "ms_per_step_median": float(np.median(times[k])),
                    "ms_per_step_rounds": times[k]}), flush=True)
            del tr, step, est


if __name__ == "__main__":
    main()
