#!/usr/bin/env python3
"""``chip_smoke.py`` phase ``parallel`` (b) over several model seeds, on one
GPU: two gloo ranks of ``tools/dp_train_torch.py --mode gan`` (224², global
B=8, f32, TF32 off, cuDNN deterministic, dropout 0, K1, K2 and the
estimator by ``--route``) against the one-process step from the ranks' own
state, each step at the phase's bars (``chip_smoke.dp_gan_parity``).

    python3 tools/dp_parity_sweep.py [--seeds 0 1 2 3] [--route k4|plain]

Phase ``parallel`` runs seed 0 with the K4 route.  One JSON line a seed:
per step the largest moment error's share of its bar
(``worst_moment_share_of_bar``; above 1 fails the phase) and the two
float32 floors, or the failure.  First one line of how far B=8 lies from
two calls of B=4 (``batch_invariance``): K4 (the form the rule picks, and
the CUDA-core kernel), K1, K2, and the step's G, D and estimator module;
``--seeds`` with no value prints that line alone.  Prints the card's name
and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def halves(fn, *xs):
    """fn over the batch's two halves, concatenated."""
    import torch

    h = xs[0].shape[0] // 2
    return torch.cat([fn(*(x[:h].contiguous() for x in xs)),
                      fn(*(x[h:].contiguous() for x in xs))])


def batch_invariance(cs, k4, est_path, torch):
    """Max abs difference between B=8 and 2 x B=4 (f32, cuDNN
    deterministic) of K4 (the rule's form and the CUDA-core kernel) at the
    GAN step's ResNet-101 sites, K1 and K2 at its decoder sites, and the
    step's G, D and estimator module forwards at 224²."""
    from weather_unet_tpu_torch.core.rng import train_generator
    from weather_unet_tpu_torch.kernels import adain as k1, upsample as k2
    from weather_unet_tpu_torch.train.gan import GanConfig, build_gan_state

    gen = torch.Generator(device="cuda").manual_seed(0)

    def diff(fn, *xs):
        return float((fn(*xs) - halves(fn, *xs)).abs().max())

    rec = {}
    for site in ("gan_layer1", "gan_layer2", "gan_layer3", "gan_layer4"):
        b, c, h, w = cs.K4_SITES[site]
        x = torch.randn(b, c, h, w, generator=gen, device="cuda")
        wts = k4.fold_bottleneck(cs.random_bottleneck_state(c, c // 4, gen))
        rec[site] = {"rule_tensor_cores": k4.takes_tensor_cores(
            torch.float32, c, c // 4, h, w),
            "routed": diff(lambda a: k4.fused_bottleneck_eval(a, *wts), x),
            "cuda_cores": diff(lambda a: k4.bottleneck_kernel(a, *wts), x)}
    for site in ("gan_adain3", "gan_adain2", "gan_adain1"):
        b, c, h, w = cs.K1_SITES[site]
        rec[site] = diff(k1.adain_fused,
                         torch.randn(b, c, h, w, generator=gen, device="cuda"),
                         torch.randn(b, 4 * c, generator=gen, device="cuda"))
    for site in ("gan_upsample3", "gan_upsample2", "gan_upsample1"):
        rec[site] = diff(k2.upsample2x_fused, torch.randn(
            *cs.K2_SITES[site], generator=gen, device="cuda"))
    cfg = GanConfig(input_size=cs.DP_SIZE, batch_size=cs.DP_BATCH,
                    dropout_rate=0.0)
    x = torch.rand(cs.DP_BATCH, 3, cs.DP_SIZE, cs.DP_SIZE, generator=gen,
                   device="cuda") * 2 - 1
    cond = torch.rand(cs.DP_BATCH, 5, generator=gen, device="cuda")
    g_net, d_net, _ = build_gan_state(cfg, 0, "cuda", use_pallas=True)
    est = cs.estimators(est_path, torch.float32, "plain", {})
    with torch.no_grad():
        rec["gen"] = diff(lambda a, c: g_net(
            a, c, train=True, generator=train_generator(0, "cuda")), x, cond)
        rec["disc"] = diff(lambda a, c: d_net(a, c, update_stats=False)[0],
                           x, cond)
        rec["estimator_module"] = diff(est, x)
    print(json.dumps({"b8_against_2x_b4_max_abs_diff": rec}), flush=True)


def sweep(seeds, route):
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from weather_unet_tpu_torch.kernels import bottleneck as k4

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    torch.backends.cudnn.deterministic = True       # as the ranks run
    with tempfile.TemporaryDirectory() as tmp:
        est_path = os.path.join(tmp, "estimator.pt")
        cs.make_estimator_checkpoint(est_path)
        batch_invariance(cs, k4, est_path, torch)
        for seed in seeds:
            out = os.path.join(tmp, f"b{seed}")
            ranks = cs.dp_run(2, [
                "--out", out, "--save_dir", os.path.join(tmp, f"cp{seed}"),
                "--mode", "gan", "--size", str(cs.DP_SIZE), "--batch",
                str(cs.DP_BATCH), "--steps", str(cs.DP_STEPS),
                "--estimator_path", est_path, "--route", route,
                "--deterministic", "--seed", str(seed), "--snapshots",
                "--dump_inputs"], os.path.join(tmp, f"logs{seed}"),
                backend="gloo")
            rec = {"seed": seed, "route": route,
                   "b_metrics": ranks[0]["metrics"],
                   "ranks_refused_allocations": [
                       r["refused_allocations"] for r in ranks]}
            try:
                cs.dp_gan_parity(tmp, est_path, out, str(seed), route,
                                 rec=rec)
                rec["steps"] = [{
                    "worst_moment_share_of_bar":
                        st["worst_moment_share_of_bar"],
                    "float32_floors": st["float32_floors"]}
                    for st in rec.pop("b_parity")]
            except AssertionError as e:
                rec["failed"] = str(e)
            del rec["b_metrics"]
            print(json.dumps(rec), flush=True)
            cs.free_cuda()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--route", choices=["k4", "plain"], default="k4")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dp_parity_sweep: needs a CUDA device")
    sweep(args.seeds, args.route)


if __name__ == "__main__":
    main()
