#!/usr/bin/env python3
"""How far the port's float32 GAN step splits its own gradients on a GPU.

    python3 tools/gan_gradient_floor_torch.py

One combined step (est mode, 224x224, batch 8, dropout 0, one seed) with
three estimators: the seeded ResNet-101 of ``chip_smoke.py``, a
depth-(1, 1, 1, 1) ResNet, and a linear head on mean-pooled pixels.  For
each, Adam's first moment after the step (with beta1 = 0, the gradient
itself) is compared between steps that differ in one thing:

  pallas_vs_plain       use_pallas generator (K1 + K2) against the plain one
  plain_vs_plain        the plain step run twice (cuDNN and
                        upsample_bilinear2d's backward are not deterministic)
  plain_det_vs_det      the same under torch.use_deterministic_algorithms
  plain_input_1e-7      the plain step with its images times (1 + 1e-7)
  pallas_vs_plain_det   use_pallas against the deterministic plain step

and one JSON line per comparison gives the losses' relative errors, each
network's moment error over its largest element, and the parameters whose
moments split the most.  Float32 with TF32 off.  The first line is the
card's name and power limit from nvidia-smi.  Needs a CUDA device; imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from weather_unet_tpu_torch.cli.common import load_estimator  # noqa: E402
from weather_unet_tpu_torch.core.rng import train_generator  # noqa: E402
from weather_unet_tpu_torch.kernels import _build  # noqa: E402
from weather_unet_tpu_torch.models import ResNet  # noqa: E402
from weather_unet_tpu_torch.train.gan import (  # noqa: E402
    GanConfig, build_gan_state, make_gan_step)


def estimators(tmp):
    """name -> NCHW estimator: the seeded ResNet-101, a depth-(1, 1, 1, 1)
    ResNet, a linear head."""
    big = os.path.join(tmp, "resnet101.pt")
    cs.make_estimator_checkpoint(big)
    small = os.path.join(tmp, "depth1.pt")
    torch.save(ResNet((1, 1, 1, 1), 5, generator=torch.Generator()
                      .manual_seed(7)).state_dict(), small)
    out = {}
    for name, path in (("resnet101", big), ("depth1", small)):
        apply = load_estimator(path, device="cuda")
        out[name] = (lambda a: lambda x: a(x.permute(0, 2, 3, 1)))(apply)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 5)).astype(np.float32)).cuda()
    out["linear"] = lambda x: x.mean(dim=(2, 3)) @ w
    return out


def step_snapshot(est, images, rand, use_pallas, deterministic=False):
    """chip_smoke.gan_snapshot of one step, with each network's parameter
    sizes beside their names."""
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    cfg = GanConfig(dropout_rate=0.0)
    gen, disc, state = build_gan_state(cfg, 0, "cuda", use_pallas=use_pallas)
    z = torch.zeros(images.shape[0], dtype=torch.long, device="cuda")
    state, m = make_gan_step(gen, disc, est, cfg)(
        state, images, z, rand, z, train_generator(0, "cuda"), do_g=True)
    snap = cs.gan_snapshot(state, m)
    for net in ("gen", "disc"):
        ts = getattr(state, net)
        snap[net]["sizes"] = [p.numel() for p in ts.module.parameters()
                              if p in ts.optimizer.state]
    torch.use_deterministic_algorithms(False)
    return snap


def worst(a, b, net, top):
    """The ``top`` parameters by moment error over the network's largest
    element: (error, name, the parameter's largest over the network's)."""
    diff = (a[net]["exp_avg"] - b[net]["exp_avg"]).abs()
    ref = b[net]["exp_avg"].abs()
    scale = float(ref.max())
    out, i = [], 0
    for name, n in zip(a[net]["names"], a[net]["sizes"]):
        out.append((float(diff[i:i + n].max()) / scale, name,
                    float(ref[i:i + n].max()) / scale))
        i += n
    return sorted(out, reverse=True)[:top]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gan_gradient_floor_torch: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    rng = np.random.default_rng(6)
    images, rand = (torch.from_numpy(rng.uniform(-1, 1, (8, 3, 224, 224))
                                     .astype(np.float32)).cuda()
                    for _ in range(2))
    with tempfile.TemporaryDirectory() as tmp:
        for name, est in estimators(tmp).items():
            plain = step_snapshot(est, images, rand, False)
            again = step_snapshot(est, images, rand, False)
            kern = step_snapshot(est, images, rand, True)
            det = step_snapshot(est, images, rand, False, True)
            det2 = step_snapshot(est, images, rand, False, True)
            moved = step_snapshot(est, images * (1 + 1e-7), rand, False)
            for label, a, b in (("pallas_vs_plain", kern, plain),
                                ("plain_vs_plain", again, plain),
                                ("plain_det_vs_det", det2, det),
                                ("plain_input_1e-7", moved, plain),
                                ("pallas_vs_plain_det", kern, det)):
                errs = cs.snapshot_errs(a, b)
                print(json.dumps({
                    "estimator": name, "compare": label,
                    "loss_rel_err": errs["loss_rel_err"],
                    **{k: errs[k] for k in cs.MOMENT_KEYS},
                    "gen_worst": worst(a, b, "gen", 5),
                    "disc_worst": worst(a, b, "disc", 3)}), flush=True)


if __name__ == "__main__":
    main()
