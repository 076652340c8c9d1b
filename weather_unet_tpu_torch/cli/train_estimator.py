"""Train the ResNet-101 weather-signal estimator -- the port of
``weather_unet_tpu/cli/train_estimator.py`` (reference ``estimator.py``,
flags ``estimator.py:9-27``).

Per-column MSE with backward(ones) semantics, the imbalance sampler on the
train split, z-scoring by the train split's statistics, an eval sweep every
100 steps, a checkpoint every 5 epochs.  Runs on CUDA unless ``--device
cpu``.  Under ``parallel/launch.py`` the ranks train data-parallel
(``train/loops.py::train_supervised``); ``--multi`` is the JAX package's
parity flag.

    python -m weather_unet_tpu_torch.cli.train_estimator \\
        --image_root DIR --pkl_path frame.pkl --augmentation --dtype bf16
"""

from __future__ import annotations

import argparse

def add_common_flags(p: argparse.ArgumentParser) -> None:
    """The flags the estimator and classifier CLIs share."""
    p.add_argument("--log_dir", type=str, default="runs")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default=None,
                   help="torch device: cuda (default; this rank's card "
                        "under the launcher) or cpu")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num_epoch", type=int, default=100)
    p.add_argument("--batch_size", "-bs", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--augmentation", action="store_true")
    p.add_argument("--pre_trained", action="store_true",
                   help="freeze conv1, bn1 and layer1-3 "
                        "(estimator.py:145-153)")
    p.add_argument("--decode_cache", type=str, default=None,
                   help="decoded-image memmap cache dir: images decode once "
                        "(first epoch), later epochs only augment "
                        "(data/cache.py)")
    p.add_argument("--aot_cache", type=str, default=None,
                   help="AOT tier directory (core/aot.py): on CUDA each "
                        "step program runs as a CUDA graph captured at its "
                        "first step")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="compute dtype (parameters stay float32)")


def build_parser():
    p = argparse.ArgumentParser(description="train weather estimator")
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--pkl_path", type=str, required=True)
    p.add_argument("--save_path", type=str, default="cp/estimator/single")
    p.add_argument("--name", type=str, default="noname-estimator")
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--mode", type=str, default="T",
                   help="T (train split) or E (val split)")
    p.add_argument("--multi", action="store_true",
                   help="parity flag; data parallelism follows the process "
                        "group (python -m "
                        "weather_unet_tpu_torch.parallel.launch -n K)")
    add_common_flags(p)
    return p


def setup(args, num_classes: int, wd: float):
    """Join the process group where the launcher asks for it, then build
    the ResNet-101 train state on the device (seeded, float32 master
    weights, the backbone frozen with ``--pre_trained``).  Returns (the
    decode size the augmentation works from: 1.15x with ``--augmentation``,
    as the reference crops; state)."""
    from weather_unet_tpu_torch.parallel.launch import maybe_initialize

    maybe_initialize()
    import torch

    from weather_unet_tpu_torch._device import resolve_device
    from weather_unet_tpu_torch.models import ResNet101
    from weather_unet_tpu_torch.train.supervised import (
        build_supervised_state)

    device = resolve_device(args.device)
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = ResNet101(num_classes, dtype=dt, param_dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
    state = build_supervised_state(model.to(device), args.lr, wd,
                                   args.pre_trained)
    base = (int(args.input_size * 1.15) if args.augmentation
            else args.input_size)
    return base, state


def train_augment(args, base: int, paths):
    """The loader-thread train augmentation (``make_train_augment``: native
    where the runtime builds), wrapped in the decode cache with
    ``--decode_cache``; prints which route it takes."""
    from weather_unet_tpu_torch.cli.common import wrap_decode_cache
    from weather_unet_tpu_torch.data.transforms import make_train_augment

    aug = wrap_decode_cache(
        make_train_augment(args.input_size, resized_crop=args.augmentation,
                           brightness=0.5 if args.augmentation else 0.0,
                           contrast=0.3 if args.augmentation else 0.0,
                           saturation=0.3 if args.augmentation else 0.0),
        args.decode_cache, base, paths)
    print(f"train augment: {aug.route}", flush=True)
    return aug


def run(args, train_set, test_set, state, step_fn, eval_fn, **kw):
    """The supervised loop over the two sets: the imbalance sampler on the
    train split; the test split keeps its tail (padded and masked by the
    eval sweep, as the reference DataLoader's drop_last=False) in one
    process, and drops it with several ranks, which must all see the same
    number of eval batches.  Rank 0 alone writes summaries."""
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.data.sampler import ImbalancedSampler
    from weather_unet_tpu_torch.parallel.launch import (
        process_count, process_index)
    from weather_unet_tpu_torch.train.loops import train_supervised
    from weather_unet_tpu_torch.train.metrics import (
        SummaryWriter, run_comment)

    def train_loader():
        return BatchLoader(train_set, batch_size=args.batch_size,
                           sampler=ImbalancedSampler(train_set),
                           num_workers=args.num_workers, process_shard=True)

    def test_loader():
        return BatchLoader(test_set, batch_size=args.batch_size,
                           drop_last=process_count() > 1,
                           num_workers=args.num_workers, process_shard=True)

    writer = (SummaryWriter(log_dir=args.log_dir, comment=run_comment(
        args.lr, args.batch_size, args.num_epoch, args.name))
        if process_index() == 0 else None)
    try:
        train_supervised(step_fn, eval_fn, train_loader, test_loader,
                         state=state, num_epoch=args.num_epoch,
                         writer=writer, input_size=args.input_size,
                         save_dir=args.save_path, name=args.name,
                         batch_size=args.batch_size,
                         aot_cache=args.aot_cache, **kw)
    finally:
        if writer is not None:
            writer.close()
    print("Done: training", flush=True)


def main(argv=None):
    args = build_parser().parse_args(argv)
    splits = {"T": "train", "E": "val"}
    if args.mode not in splits:
        raise SystemExit(f"--mode must be T or E, not {args.mode!r}")
    base, state = setup(args, num_classes=5, wd=args.wd)
    import pandas as pd

    from weather_unet_tpu_torch.data.datasets import (
        FlickrDataset, SIGNAL_COLUMNS, flickr_image_path, zscore_columns)
    from weather_unet_tpu_torch.train.supervised import (
        make_estimator_step, make_eval_metrics)

    df = pd.read_pickle(args.pkl_path)
    df, _, _ = zscore_columns(df, SIGNAL_COLUMNS,
                              stats_df=df[df["mode"] == "train"])
    train_df = df[df["mode"] == splits[args.mode]]
    test_df = df[df["mode"] == "test"]
    aug = train_augment(args, base, [flickr_image_path(args.image_root, p)
                                     for p in train_df["photo"]])
    train_set = FlickrDataset(args.image_root, train_df, SIGNAL_COLUMNS,
                              out_size=base, class_id=None, imbalance=True,
                              transform=aug)
    test_set = FlickrDataset(args.image_root, test_df, SIGNAL_COLUMNS,
                             out_size=args.input_size)
    run(args, train_set, test_set, state, make_estimator_step(),
        make_eval_metrics("estimator"))


if __name__ == "__main__":
    main()
