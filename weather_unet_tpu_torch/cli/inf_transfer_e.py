"""Soft-signal cross-conditioned translation -- the port of
``weather_unet_tpu/cli/inf_transfer_e.py`` (reference
``inference/inf_transfer_e.py``): for each test batch, every sample's
signal vector (from the frame, or from ``--estimator_path``) conditions the
whole batch (batch x batch images, one forward), saved as
``{photo}_cond-{cond_photo}.jpg`` with a per-image min-max stretch.  The
frame's signals are z-scored against ``--stats_pkl`` or itself.  Runs on
CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description="soft-signal weather transfer")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--pkl_path", type=str, required=True)
    p.add_argument("--stats_pkl", type=str, default=None,
                   help="dataframe to z-score the signal columns against "
                        "(the reference's without-outlier frame, "
                        "inf_transfer_e.py:66-75); default the --pkl_path "
                        "frame itself")
    p.add_argument("--output_dir", type=str, default="results_e")
    p.add_argument("--cp_path", type=str, required=True)
    p.add_argument("--estimator_path", type=str, default=None,
                   help="when set, conditions come from the estimator "
                        "instead of the dataframe")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--mode", type=str, default="test",
                   choices=["train", "val", "test"])
    return p


def cross_translate(wt, x, conds):
    """(B, H, W, 3) images x (B, C) conditions -> (B_cond, B_img, H, W, 3):
    each condition applied to the whole batch, in one forward."""
    b = x.shape[0]
    out = wt.translate(x.repeat(b, 1, 1, 1),
                       conds.repeat_interleave(b, dim=0), bucket=False)
    return out.reshape(b, b, *out.shape[1:])


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.cli.common import (
        load_estimator, load_flickr_frame, model_input, save_image)
    from weather_unet_tpu_torch.data.datasets import (
        SIGNAL_COLUMNS, FlickrDataset)
    from weather_unet_tpu_torch.data.pipeline import (
        BatchLoader, device_prefetch)

    os.makedirs(args.output_dir, exist_ok=True)
    wt = WeatherTransfer.load(args.cp_path, device=args.device)
    est_apply = (load_estimator(args.estimator_path, device=wt.device)
                 if args.estimator_path else None)

    df, _, _ = load_flickr_frame(args.pkl_path, stats_pkl=args.stats_pkl)
    if "mode" in df:
        df = df[df["mode"] == args.mode]
    dataset = FlickrDataset(args.image_root, df, SIGNAL_COLUMNS,
                            out_size=args.input_size)
    loader = BatchLoader(dataset, batch_size=args.batch_size, drop_last=True,
                         num_workers=args.num_workers)
    for imgs_u8, conds, pids in device_prefetch(loader, wt.device,
                                                device_fields=[0, 1]):
        with torch.inference_mode():
            x = model_input(imgs_u8)
            c = (est_apply(x) if est_apply is not None
                 else torch.as_tensor(conds).to(wt.device))
            outs = cross_translate(wt, x, c).float().cpu().numpy()
        for ci in range(outs.shape[0]):
            for bi in range(outs.shape[1]):
                name = f"{pids[bi]}_cond-{pids[ci]}.jpg"
                # per-image min-max like the reference's save_image
                # (inf_transfer_e.py:141)
                save_image(os.path.join(args.output_dir, name),
                           outs[ci, bi][None], nrow=1)
    print(f"Done: outputs in {args.output_dir}")


if __name__ == "__main__":
    main()
