"""Estimator regression-quality eval -- the port of
``weather_unet_tpu/cli/eval_estimator.py`` (reference
``eval/eval_estimator.py``): per-signal signed L1 and MSE against the
ground truth, z-scored by the frame's train split and de-normalized by its
sigma, written to ``errors.pkl``; ``--plot`` adds per-signal histograms
(``hist.png``) where matplotlib is installed, and says why otherwise
(``eval_estimator.py:133-188``).  Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import pickle


def build_parser():
    p = argparse.ArgumentParser(description="estimator regression quality")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--pkl_path", type=str, required=True)
    p.add_argument("--estimator_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="eval_est_out")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--mode", type=str, default="test")
    p.add_argument("--plot", action="store_true")
    return p


def plot_histograms(path: str, signed_l1, columns) -> None:
    """One histogram of the signed error per signal; best-effort."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, len(columns), figsize=(20, 3))
        for i, c in enumerate(columns):
            axes[i].hist(signed_l1[:, i], bins=50)
            axes[i].set_title(c)
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    except Exception as e:  # plotting is best-effort
        print(f"{os.path.basename(path)} skipped: {type(e).__name__}: {e}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import pandas as pd

    from weather_unet_tpu_torch._device import resolve_device
    from weather_unet_tpu_torch.cli.common import load_estimator, model_input
    from weather_unet_tpu_torch.data.datasets import (
        SIGNAL_COLUMNS, FlickrDataset, zscore_columns)
    from weather_unet_tpu_torch.data.pipeline import (
        BatchLoader, device_prefetch)
    from weather_unet_tpu_torch.evaluation.transfer import estimator_errors

    os.makedirs(args.output_dir, exist_ok=True)
    device = resolve_device(args.device)
    estimate = load_estimator(args.estimator_path, device=device)
    df = pd.read_pickle(args.pkl_path)
    stats = df[df["mode"] == "train"] if "mode" in df else df
    df, _, std = zscore_columns(df, SIGNAL_COLUMNS, stats_df=stats)
    if "mode" in df:
        df = df[df["mode"] == args.mode]
    ds = FlickrDataset(args.image_root, df, SIGNAL_COLUMNS,
                       out_size=args.input_size)
    loader = BatchLoader(ds, batch_size=args.batch_size, drop_last=True,
                         num_workers=args.num_workers)
    batches = ((model_input(b[0]), b[1])
               for b in device_prefetch(loader, device, device_fields=[0, 1]))
    out = estimator_errors(estimate, batches, sigma=np.asarray(std))

    # the reference prints the signed per-column mean/std and their denorms
    # as 'l1' / 'l1 std' (eval_estimator.py:145-147,157-177); abs-mean and
    # mse follow
    for k in ("signed_mean", "signed_mean_denorm", "signed_std",
              "signed_std_denorm", "l1_mean", "l1_mean_denorm", "mse_mean"):
        if k in out:
            vals = ", ".join(f"{c}={v:.4f}"
                             for c, v in zip(SIGNAL_COLUMNS, out[k]))
            print(f"{k}: {vals}")
    with open(os.path.join(args.output_dir, "errors.pkl"), "wb") as f:
        pickle.dump(out, f)
    if args.plot:
        plot_histograms(os.path.join(args.output_dir, "hist.png"),
                        out["signed_l1"], SIGNAL_COLUMNS)
    return out


if __name__ == "__main__":
    main()
