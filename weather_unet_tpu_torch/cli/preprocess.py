"""Dataset preparation CLI -- the port of
``weather_unet_tpu/cli/preprocess.py`` (the reference's ``preprocesses/``
scripts) over ``data/preprocess.py``; the same flags, files and printout.

Subcommands:
  split-i2w       directory tree -> train/val/test path-list pickle
  split-flickr    dataframe pickle -> add per-class 'mode' column
  remove-gray     drop grayscale photos from a dataframe pickle

    python -m weather_unet_tpu_torch.cli.preprocess split-i2w \\
        --root i2w/ --output split.pkl --test_per_class 500
    python -m weather_unet_tpu_torch.cli.preprocess split-flickr \\
        --pkl_path frame.pkl --output frame_split.pkl --ratio 40 40 20
    python -m weather_unet_tpu_torch.cli.preprocess remove-gray \\
        --pkl_path frame.pkl --image_root photos/ --output frame_color.pkl
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="dataset preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    s1 = sub.add_parser("split-i2w")
    s1.add_argument("--root", required=True)
    s1.add_argument("--output", required=True)
    s1.add_argument("--test_per_class", type=int, default=500)
    s1.add_argument("--small_rate", type=float, default=1.0)

    s2 = sub.add_parser("split-flickr")
    s2.add_argument("--pkl_path", required=True)
    s2.add_argument("--output", required=True)
    s2.add_argument("--ent_th", type=float, default=None)
    s2.add_argument("--ratio", type=int, nargs=3, default=[40, 40, 20])

    s3 = sub.add_parser("remove-gray")
    s3.add_argument("--pkl_path", required=True)
    s3.add_argument("--image_root", required=True)
    s3.add_argument("--output", required=True)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from weather_unet_tpu_torch.data import preprocess as pp

    if args.cmd == "split-i2w":
        split = pp.split_i2w(args.root, args.test_per_class, args.small_rate)
        pp.save_split_pickle(split, args.output)
        print({k: len(v) for k, v in split.items()})
        return
    import pandas as pd

    df = pd.read_pickle(args.pkl_path)
    if args.cmd == "split-flickr":
        out = pp.split_flickr(df, per_class=args.ratio, ent_th=args.ent_th)
        out.to_pickle(args.output)
        print(out["mode"].value_counts().to_dict())
    else:
        out = pp.remove_gray(df, args.image_root)
        out.to_pickle(args.output)
        print(f"kept {len(out)}/{len(df)}")


if __name__ == "__main__":
    main()
