"""GIF demo, each weather axis swept over a directory of photos -- the port
of ``weather_unet_tpu/cli/demo.py`` (reference ``demo.py:39-92``).

For each batch and each theta in [-pi/2, pi/2], the condition on one class
axis is ``sin(theta) * alpha`` with the frozen estimator's predictions on
the other axes (``WeatherTransfer.sweep``: one forward of classes x batch
images per theta); the frames are tabled (the source column, then one
column per axis) into a forward-and-back looping GIF per batch.  Runs on
CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="weather transfer GIF demo")
    p.add_argument("--gpu", type=int, default=0, help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="results")
    p.add_argument("--cp_path", type=str, required=True)
    p.add_argument("--estimator_path", type=str, required=True)
    p.add_argument("--input_size", type=int, default=244)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--num_classes", type=int, default=6)
    p.add_argument("--num_frames", type=int, default=10)
    p.add_argument("--alpha", type=int, default=2)
    return p


def gif_tables(batch, frames, num_classes: int) -> list:
    """(B, H, W, 3) inputs in [-1, 1] and (T, K, B, H, W, 3) frames -> one
    uint8 RGB table per theta: the inputs' column, then one column per
    axis (``make_grid`` of each, min-max per image)."""
    from weather_unet_tpu_torch.train.metrics import make_grid

    src_col = make_grid(batch, nrow=1)
    tables = []
    for t in range(frames.shape[0]):
        cols = [src_col] + [make_grid((frames[t, a] + 1.0) * 127.5, nrow=1)
                            for a in range(num_classes)]   # demo.py:80
        table = np.concatenate(cols, axis=1)
        tables.append((table * 255).clip(0, 255).astype(np.uint8))
    return tables


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.input_size % 8:
        # the cUNet's three 2x2 max-pools need three even halvings; the
        # reference demo's own 244 default fails the same way in its
        # decoder's concat
        raise SystemExit(
            f"--input_size {args.input_size} is not divisible by 8, which "
            f"the cUNet encoder/decoder requires (the reference demo's own "
            f"244 default is equally broken) — use e.g. 224 or 256")
    import torch
    from PIL import Image

    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.cli.common import (
        list_images, load_estimator, model_input)
    from weather_unet_tpu_torch.data.datasets import ImagePathDataset
    from weather_unet_tpu_torch.data.pipeline import (
        BatchLoader, device_prefetch)

    os.makedirs(args.output_dir, exist_ok=True)
    n_cls, nf = args.num_classes, args.num_frames
    wt = WeatherTransfer.load(args.cp_path, num_classes=n_cls,
                              device=args.device)
    est_apply = load_estimator(args.estimator_path, num_classes=n_cls,
                               device=wt.device)
    dataset = ImagePathDataset(list_images(args.input_dir),
                               out_size=args.input_size)
    loader = BatchLoader(dataset, batch_size=args.batch_size, drop_last=True,
                         num_workers=args.num_workers)
    for i, (imgs_u8, _) in enumerate(device_prefetch(loader, wt.device,
                                                     device_fields=[0])):
        with torch.inference_mode():
            batch = model_input(imgs_u8)
            frames = wt.sweep(batch, est_apply, num_frames=nf,
                              alpha=float(args.alpha))
        pil = [Image.fromarray(t).convert("RGB") for t in gif_tables(
            batch.float().cpu().numpy(), frames.float().cpu().numpy(),
            n_cls)]
        out_path = os.path.join(args.output_dir, f"output{i}.gif")
        pil[0].save(out_path, save_all=True,
                    append_images=pil[1:] + pil[1:-1][::-1],
                    duration=1000 // nf, loop=0)
        print(f"Save gif image: {out_path}")


if __name__ == "__main__":
    main()
