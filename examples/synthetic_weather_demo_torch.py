"""End-to-end training demonstration on a synthetic weather task, through
the PyTorch port (``weather_unet_tpu_torch``): the same task, flags and
report lines as ``examples/synthetic_weather_demo.py``.

The frozen "estimator" is a fixed linear readout of mean image color
(signal = W^T mean_color), so weather-transfer success is directly
measurable: after training, the estimator's readback of G(x, c) should hit
the requested c far more closely than the untouched image does, while
staying close to the input (reconstruction).

Runs the port's training step (``train/gan.py::make_gan_step``: hinge GAN +
loss_con + weather consistency, spectral-norm discriminator, torch Adam);
on CUDA the generator's decoder runs K1 and K2 (``use_pallas``), as the
port's trainer does.

    python examples/synthetic_weather_demo_torch.py --steps 2000 --batch 32
    python examples/synthetic_weather_demo_torch.py --dtype bfloat16 \\
        --aot_cache /tmp/wut_aot        # the step as its CUDA graph
    python examples/synthetic_weather_demo_torch.py --device cpu --steps 20 \\
        --size 32 --batch 4

Each report window's batches are drawn (in the JAX example's order, from
the same numpy stream) and copied to the device before the window's clock
starts, so img/s is the training step's rate.  ``run()`` returns the
reports and every step's losses for a caller that compares two runs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_batch(rng, batch, size):
    """Smooth random images in [-1, 1]: mixture of color gradients + blobs
    (the JAX example's function, the same draws in the same order)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.empty((batch, size, size, 3), np.float32)
    for b in range(batch):
        base = rng.uniform(-0.6, 0.6, 3).astype(np.float32)
        gdir = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
        img = base + yy[..., None] * gdir[0] * 0.5 + xx[..., None] * gdir[1] * 0.5
        for _ in range(3):  # soft blobs
            cy, cx = rng.uniform(0.2, 0.8, 2)
            rad = rng.uniform(0.05, 0.25)
            amp = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
            mask = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * rad ** 2)))
            img = img + mask[..., None] * amp
        imgs[b] = np.clip(img, -1, 1)
    return imgs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--report_every", type=int, default=250)
    p.add_argument("--out", type=str, default=None, help="save sample grid jpg")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32", help="compute dtype (float32 master "
                   "weights either way)")
    p.add_argument("--aot_cache", type=str, default=None,
                   help="run the step through the AOT tier (core/aot.py): "
                        "on CUDA a CUDA graph of the whole step")
    return p


def run(argv=None, log=print) -> dict:
    """Train and report; returns ``{"base_err", "start_err", "reports",
    "losses", "final", "aot"}``: ``start_err`` the untrained generator's
    readback, ``reports`` one dict per report line (its ``img_per_s`` over
    the steps so far, the first one's capture included with
    ``--aot_cache``), ``losses`` every step's ``(d_loss, g_loss)``, ``aot``
    the tier's counters (``core/aot.py``; None without it)."""
    args = build_parser().parse_args(argv)

    import torch

    from weather_unet_tpu_torch._device import resolve_device
    from weather_unet_tpu_torch.core.optim import set_capturable
    from weather_unet_tpu_torch.ops import losses
    from weather_unet_tpu_torch.train.gan import (
        GanConfig, build_gan_state, make_gan_step)
    from weather_unet_tpu_torch.train.loops import _tiered_steps

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(
        device)

    def est_apply(images):  # frozen ground-truth weather readout (NCHW)
        return images.mean(dim=(2, 3)) @ w.to(images.dtype)

    def to_device(a):
        return torch.from_numpy(a).to(device).permute(0, 3, 1, 2).contiguous()

    cfg = GanConfig(input_size=args.size, batch_size=args.batch, lr=args.lr,
                    dtype=dtype)
    gen, disc, state = build_gan_state(cfg, 0, device,
                                       use_pallas=device.type == "cuda")
    step = make_gan_step(gen, disc, est_apply, cfg)
    cache = None
    if args.aot_cache is not None:
        programs = step.programs
        (programs[True], programs[False]), cache = _tiered_steps(
            [programs[True], programs[False]], args.aot_cache)
        for ts in (state.gen, state.disc):
            set_capturable(ts.optimizer, device.type == "cuda")

    @torch.no_grad()
    def readback_l1(images, conds):
        fake = gen(images, conds)
        err = (est_apply(fake).float() - conds).abs().mean()
        recon = losses.l1_loss(fake.float(), images)
        return float(err), float(recon)

    # fixed eval batch: images + conditions sampled from OTHER images' signals
    eval_imgs = to_device(synthetic_batch(rng, args.batch, args.size))
    eval_conds = est_apply(to_device(synthetic_batch(rng, args.batch,
                                                     args.size)))
    base_err = float((est_apply(eval_imgs) - eval_conds).abs().mean())
    log(f"baseline |est(x) - c| (no transfer): {base_err:.4f}")
    start_err, start_recon = readback_l1(eval_imgs, eval_conds)
    log(f"untrained G: readback|est(G(x,c))-c|={start_err:.4f} "
        f"recon L1={start_recon:.4f}")

    zeros = torch.zeros(args.batch, dtype=torch.long, device=device)
    generator = torch.Generator(device=device)
    reports, metrics, done, elapsed = [], [], 0, 0.0
    while done < args.steps:
        window = min(args.report_every - done % args.report_every,
                     args.steps - done)
        # float32 images whatever the compute dtype, as the port's trainer
        # feeds its step: the networks cast on entry
        batches = [(to_device(synthetic_batch(rng, args.batch, args.size)),
                    to_device(synthetic_batch(rng, args.batch, args.size)))
                   for _ in range(window)]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for imgs, rand_imgs in batches:
            done += 1
            generator.manual_seed(1000 + done)
            state, m = step(state, imgs, zeros, rand_imgs, zeros, generator,
                            do_g=True)
            metrics.append((m["d_loss"], m["g_loss"], m["g_loss_w"]))
        last = [float(v) for v in metrics[-1]]     # waits for the window
        elapsed += time.perf_counter() - t0
        err, recon = readback_l1(eval_imgs, eval_conds)
        rate = done * args.batch / elapsed
        reports.append({"step": done, "readback": err, "recon_l1": recon,
                        "d_loss": last[0], "g_w": last[2],
                        "img_per_s": rate})
        log(f"step {done:5d}: readback|est(G(x,c))-c|={err:.4f} "
            f"recon L1={recon:.4f} d_loss={last[0]:.3f} "
            f"g_w={last[2]:.4f} ({rate:.0f} img/s)")

    err, recon = readback_l1(eval_imgs, eval_conds)
    log(f"FINAL: weather-consistency improved {base_err:.4f} -> {err:.4f} "
        f"({(1 - err / base_err) * 100:.0f}% closer), recon L1 {recon:.4f}")

    if args.out:
        from weather_unet_tpu_torch.cli.common import save_image

        with torch.no_grad():
            fake = gen(eval_imgs[:8], eval_conds[:8])
        strip = torch.cat([eval_imgs[:8], fake.float()], dim=3)
        save_image(args.out, strip.permute(0, 2, 3, 1).cpu().numpy(), nrow=1)
        log(f"sample grid: {args.out}")
    losses_host = torch.stack([torch.stack([d.float(), g.float()])
                               for d, g, _ in metrics]).cpu().numpy()
    return {"base_err": base_err, "start_err": start_err, "reports": reports,
            "losses": losses_host, "final": {"readback": err,
                                             "recon_l1": recon},
            "aot": None if cache is None else dict(cache.stats)}


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
