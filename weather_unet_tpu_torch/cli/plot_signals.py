"""Signal-distribution histograms -- the port of
``weather_unet_tpu/cli/plot_signals.py`` (the reference's ``plot.py``): one
histogram a signal of a pickled (N, signals) ground-truth array (or the
``signed_l1`` of an ``errors.pkl``), optionally beside the predictions'.
matplotlib loads inside ``main``; where it is missing the CLI exits saying
so.

    python -m weather_unet_tpu_torch.cli.plot_signals --gt_pkl gt.pkl \\
        --pred_pkl pred.pkl --output signals_hist.png
"""

from __future__ import annotations

import argparse
import pickle


def build_parser():
    p = argparse.ArgumentParser(description="plot signal histograms")
    p.add_argument("--gt_pkl", type=str, required=True,
                   help="pickled (N, num_signals) ground-truth array or errors.pkl")
    p.add_argument("--pred_pkl", type=str, default=None)
    p.add_argument("--output", type=str, default="signals_hist.png")
    p.add_argument("--bins", type=int, default=50)
    return p


def _load(path):
    import numpy as np

    with open(path, "rb") as f:
        obj = pickle.load(f)
    if isinstance(obj, dict):
        obj = obj.get("signed_l1", next(iter(obj.values())))
    return np.asarray(obj)


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("matplotlib is not available in this environment")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from weather_unet_tpu_torch.data.datasets import SIGNAL_COLUMNS

    gt = _load(args.gt_pkl)
    pred = _load(args.pred_pkl) if args.pred_pkl else None
    n = gt.shape[1]
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    axes = axes[0]
    for i in range(n):
        axes[i].hist(gt[:, i], bins=args.bins, alpha=0.6, label="gt")
        if pred is not None:
            axes[i].hist(pred[:, i], bins=args.bins, alpha=0.6, label="pred")
        axes[i].set_title(SIGNAL_COLUMNS[i] if i < len(SIGNAL_COLUMNS) else str(i))
        axes[i].legend()
    fig.savefig(args.output, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
