"""Signal-transfer consistency eval -- the port of
``weather_unet_tpu/cli/eval_estimator_transfer.py`` (reference
``eval/eval_estimator_transfer.py``): for each reference sample the whole
batch is translated to that sample's signals (batch x batch
cross-conditioning, ``eval_estimator_transfer.py:48-61``), and the
estimator's per-column signed readback error (mean and std over the
per-reference rows) is reported, z-scored and de-normalized by the frame's
sigma -- the reference's printed ``l1`` / ``l1 std`` (``:129-138``).  Runs
on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="estimator-transfer consistency")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--pkl_path", type=str, required=True)
    p.add_argument("--stats_pkl", type=str, default=None)
    p.add_argument("--cp_path", type=str, required=True)
    p.add_argument("--estimator_path", type=str, required=True)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--mode", type=str, default="test")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.cli.common import (
        load_estimator, load_flickr_frame, model_input)
    from weather_unet_tpu_torch.data.datasets import (
        SIGNAL_COLUMNS, FlickrDataset)
    from weather_unet_tpu_torch.data.pipeline import (
        BatchLoader, device_prefetch)
    from weather_unet_tpu_torch.evaluation.transfer import (
        estimator_transfer_consistency)

    wt = WeatherTransfer.load(args.cp_path, device=args.device)
    estimate = load_estimator(args.estimator_path, device=wt.device)
    df, _, std = load_flickr_frame(args.pkl_path, stats_pkl=args.stats_pkl)
    if "mode" in df:
        df = df[df["mode"] == args.mode]
    ds = FlickrDataset(args.image_root, df, SIGNAL_COLUMNS,
                       out_size=args.input_size)
    loader = BatchLoader(ds, batch_size=args.batch_size, drop_last=True,
                         num_workers=args.num_workers)
    batches = ((model_input(b[0]), b[1])
               for b in device_prefetch(loader, wt.device,
                                        device_fields=[0, 1]))
    out = estimator_transfer_consistency(wt, estimate, batches,
                                         sigma=np.asarray(std))
    # the reference prints the signed mean/std and their denorms as 'l1' /
    # 'l1 std' (eval_estimator_transfer.py:129-138); abs stats follow
    for k in ("signed_mean", "signed_mean_denorm", "signed_std",
              "signed_std_denorm", "l1_mean", "l1_mean_denorm"):
        if k in out:
            vals = ", ".join(f"{c}={v:.4f}"
                             for c, v in zip(SIGNAL_COLUMNS, out[k]))
            print(f"{k}: {vals}")
    return out


if __name__ == "__main__":
    main()
