"""Train the ResNet-101 5-class weather classifier -- the port of
``weather_unet_tpu/cli/train_classifier.py`` (reference ``classifier.py``,
flags ``classifier.py:10-22``).

Cross entropy on the i2w classes, Adam(1e-4, wd 1e-4), the imbalance
sampler, an eval sweep every 500 steps, a checkpoint every 5 epochs.  Runs
on CUDA unless ``--device cpu``.

    python -m weather_unet_tpu_torch.cli.train_classifier \\
        --pkl_path split.pkl --augmentation --dtype bf16
"""

from __future__ import annotations

import argparse

from weather_unet_tpu_torch.cli.train_estimator import (
    add_common_flags, run, setup, train_augment)


def build_parser():
    p = argparse.ArgumentParser(description="train weather classifier")
    p.add_argument("--image_root", type=str, default=None,
                   help="parity flag; paths come from the split pkl")
    p.add_argument("--pkl_path", type=str, required=True,
                   help="i2w split pickle {'train': paths, 'test': paths}")
    p.add_argument("--save_path", type=str, default="cp/classifier")
    p.add_argument("--name", type=str, default="noname-classifier")
    p.add_argument("--wd", type=float, default=1e-4)
    add_common_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    base, state = setup(args, num_classes=5, wd=args.wd)
    import pandas as pd
    import torch

    from weather_unet_tpu_torch.data.datasets import (
        ClassImageDataset, filter_i2w_paths)
    from weather_unet_tpu_torch.train.supervised import (
        make_classifier_step, make_eval_metrics)

    sep = pd.read_pickle(args.pkl_path)
    aug = train_augment(args, base, filter_i2w_paths(sep["train"]))
    train_set = ClassImageDataset(sep["train"], out_size=base, transform=aug)
    test_set = ClassImageDataset(sep["test"], out_size=args.input_size)
    run(args, train_set, test_set, state, make_classifier_step(),
        make_eval_metrics("classifier"), eval_per_iter=500,
        target_dtype=torch.long)


if __name__ == "__main__":
    main()
