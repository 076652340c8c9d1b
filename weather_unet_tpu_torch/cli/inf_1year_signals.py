"""Time-lapse inference, one photo through a year of hourly weather signals
-- the port of ``weather_unet_tpu/cli/inf_1year_signals.py`` (reference
``inference/inf_1year_signals.py``): the station's year of signals z-scored
against itself, the fixed photo translated per hour in batches of
``--batch_size`` (the last one padded), frames saved as
``%Y%m%d_%H%M%S.jpg`` (UTC).  Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="1-year weather-signal time lapse")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--pkl_path", type=str, required=True)
    p.add_argument("--photo_id", type=str, required=True)
    p.add_argument("--city", type=str, default=None,
                   help="station name override")
    p.add_argument("--output_dir", type=str, default="results_1year")
    p.add_argument("--cp_path", type=str, required=True)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=16)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.cli.common import (
        load_flickr_frame, model_input, save_image)
    from weather_unet_tpu_torch.data.datasets import (
        SIGNAL_COLUMNS, OneYearWeatherSignals)

    os.makedirs(args.output_dir, exist_ok=True)
    wt = WeatherTransfer.load(args.cp_path, device=args.device)
    # z-score the year frame against itself (inf_1year_signals.py:62-69)
    df, _, _ = load_flickr_frame(args.pkl_path)
    ds = OneYearWeatherSignals(args.image_root, df, SIGNAL_COLUMNS,
                               args.photo_id, out_size=args.input_size,
                               name=args.city)
    x1 = model_input(torch.tensor(ds.image[None], device=wt.device))
    bs, n = args.batch_size, len(ds)
    for start in range(0, n, bs):
        idx = range(start, min(start + bs, n))
        conds = np.zeros((bs, ds.conditions.shape[1]), np.float32)
        conds[:len(idx)] = ds.conditions[start:start + len(idx)]
        outs = wt.translate(x1.expand(bs, -1, -1, -1), conds, bucket=False)
        outs = outs.float().cpu().numpy()
        for j, i in enumerate(idx):
            ts = datetime.datetime.fromtimestamp(int(ds.s_times[i]),
                                                 datetime.timezone.utc)
            # per-image min-max like the reference's save_image
            # (inf_1year_signals.py:105)
            save_image(os.path.join(args.output_dir,
                                    ts.strftime("%Y%m%d_%H%M%S") + ".jpg"),
                       outs[j][None], nrow=1)
    print(f"Done: {n} frames in {args.output_dir}")


if __name__ == "__main__":
    main()
