"""FID CLI -- the port of ``weather_unet_tpu/cli/fid_score.py`` (reference
``eval/fid_score.py:257-266``):

    python -m weather_unet_tpu_torch.cli.fid_score PATH1 PATH2 --weights W

where each path is an image directory or precomputed ``.npz`` statistics.
The Inception-v3 runs on CUDA unless ``--device cpu``; an ``.npz`` against
an ``.npz`` never builds it.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Fréchet Inception Distance")
    p.add_argument("path", type=str, nargs=2,
                   help="image dirs or .npz statistics files")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--dims", type=int, default=2048,
                   help="parity flag; pool3 (2048) is the supported block")
    p.add_argument("--gpu", type=str, default="", help="parity flag; ignored")
    p.add_argument("--weights", type=str, default=None,
                   help="local pt_inception .pth (TF-ported FID weights)")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="proceed WITHOUT real inception weights (random "
                        "init; FID values are meaningless vs published "
                        "numbers)")
    p.add_argument("--save-stats", type=str, default=None,
                   help="write stats of path[0] to this .npz and exit")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from weather_unet_tpu_torch.evaluation.fid import (
        frechet_distance, make_feature_fn, statistics_of_path)

    feature_fn = None
    needs_model = args.save_stats or any(
        not p.endswith(".npz")
        for p in args.path[: 1 if args.save_stats else 2])
    if needs_model:  # .npz-vs-.npz comparisons never build the network
        feature_fn = make_feature_fn(args.weights,
                                     allow_random=args.allow_random_weights,
                                     device=args.device)
    if args.save_stats:
        mu, sigma = statistics_of_path(args.path[0], feature_fn,
                                       args.batch_size)
        np.savez(args.save_stats, mu=mu, sigma=sigma)
        print(f"saved stats to {args.save_stats}")
        return
    m1, s1 = statistics_of_path(args.path[0], feature_fn, args.batch_size)
    m2, s2 = statistics_of_path(args.path[1], feature_fn, args.batch_size)
    fid = frechet_distance(m1, s1, m2, s2)
    print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
