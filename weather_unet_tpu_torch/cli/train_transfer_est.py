"""Semi-supervised GAN transfer training with the signal estimator -- the
port of ``weather_unet_tpu/cli/train_transfer_est.py`` (reference
``t_est_train.py``, flags ``t_est_train.py:4-30``).

Conditions are the 5 z-scored weather signals that a frozen ResNet-101
estimator predicts; a content loader and a random-condition loader over the
train split are zipped per step.  Runs on CUDA unless ``--device cpu``.
Under ``parallel/launch.py`` each rank trains on its rows of every batch
(data parallel, ``train/loops.py``); with ``--tensor_parallel T`` every T
ranks split the networks' double convs between them (``parallel/tp.py``)
and the data axis is the rest:

    python -m weather_unet_tpu_torch.parallel.launch -n 2 --cpu -- \\
        python -m weather_unet_tpu_torch.cli.train_transfer_est \\
        --tensor_parallel 2 --image_root DIR --estimator_path est.pt \\
        --image_only

    python -m weather_unet_tpu_torch.cli.train_transfer_est \\
        --image_root DIR --estimator_path est.pt --image_only --dtype bf16
"""

from __future__ import annotations

import argparse

def build_parser():
    p = argparse.ArgumentParser(
        description="train weather transfer (estimator)")
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--name", type=str, default="cUNet")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default=None,
                   help="torch device: cuda (default; this rank's card "
                        "under the launcher) or cpu")
    p.add_argument("--save_dir", type=str, default="cp/transfer")
    p.add_argument("--log_dir", type=str, default="runs")
    p.add_argument("--pkl_path", type=str, default=None,
                   help="dataframe pickle (required unless --image_only)")
    p.add_argument("--stats_pkl", type=str, default=None,
                   help="without-outlier frame for z-scoring "
                        "(t_est_train.py:126)")
    p.add_argument("--estimator_path", type=str, required=True,
                   help="frozen ResNet estimator, a state-dict .pt")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lmda", type=float, default=None)
    p.add_argument("--num_epoch", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--GD_train_ratio", type=int, default=1)
    p.add_argument("--sampler", action="store_true")
    p.add_argument("--augmentation", action="store_true")
    p.add_argument("--image_only", action="store_true")
    p.add_argument("--export_torch", action="store_true",
                   help="also write reference-format .pt checkpoints")
    p.add_argument("--nan_guard", action="store_true",
                   help="on non-finite metrics, roll back to the newest "
                        "checkpoint and retry with re-seeded dropout "
                        "(bounded; see WeatherTransferTrainer)")
    p.add_argument("--aot_cache", type=str, default=None,
                   help="AOT tier directory (core/aot.py): on CUDA each "
                        "step program runs as a CUDA graph captured at its "
                        "first step")
    p.add_argument("--decode_cache", type=str, default=None,
                   help="decoded-image memmap cache dir: images decode once "
                        "(first epoch), later epochs only augment "
                        "(data/cache.py)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="split every double conv over T ranks of the "
                        "launcher (parallel/tp.py); the data axis is the "
                        "ranks / T")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="compute dtype of the train step (parameters stay "
                        "float32)")
    return p


def tensor_parallel_plan(args, multiproc: bool, device):
    """The plan of ``--tensor_parallel T`` (None for 1): ``make_mesh(model=T,
    batch_size=...)`` over the launcher's ranks, or in one process over its
    one device, which ``make_mesh`` refuses with the JAX package's
    message."""
    if args.tensor_parallel <= 1:
        return None
    from weather_unet_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=None if multiproc else [device],
                     model=args.tensor_parallel,
                     batch_size=args.batch_size)


def augmentation(args):
    """The loader-thread train augmentation and the decode size it works
    from (the reference's ``--augmentation`` branch crops from 1.15x)."""
    from weather_unet_tpu_torch.data.transforms import make_train_augment

    aug = make_train_augment(
        args.input_size, resized_crop=args.augmentation,
        brightness=0.5 if args.augmentation else 0.0,
        contrast=0.3 if args.augmentation else 0.0,
        saturation=0.3 if args.augmentation else 0.0)
    base = (int(args.input_size * 1.15) if args.augmentation
            else args.input_size)
    return aug, base


def loader_fns(args, train_set, aug):
    """The content and random-condition loader factories.  The random loader
    reads a view of the train set on its own keyed RNG stream
    (``fork_stream``): one shared transform would make the per-path draw
    counter depend on thread scheduling."""
    from weather_unet_tpu_torch.data.datasets import with_transform
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.data.sampler import ImbalancedSampler
    from weather_unet_tpu_torch.data.transforms import fork_stream

    rand_set = with_transform(train_set, fork_stream(aug))

    def train_loader():
        return BatchLoader(train_set, batch_size=args.batch_size,
                           shuffle=True, num_workers=args.num_workers,
                           process_shard=True)

    def random_loader():
        if args.sampler:
            return BatchLoader(rand_set, batch_size=args.batch_size,
                               sampler=ImbalancedSampler(rand_set),
                               num_workers=args.num_workers,
                               process_shard=True)
        return BatchLoader(rand_set, batch_size=args.batch_size,
                           shuffle=True, seed=1,
                           num_workers=args.num_workers, process_shard=True)

    return train_loader, random_loader


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.image_only and args.pkl_path is None:
        raise SystemExit("--pkl_path is required unless --image_only")
    from weather_unet_tpu_torch.parallel.launch import maybe_initialize

    multiproc = maybe_initialize()
    import torch

    from weather_unet_tpu_torch._device import resolve_device
    from weather_unet_tpu_torch.cli.common import (
        list_images, load_flickr_frame, load_step_estimator,
        wrap_decode_cache)
    from weather_unet_tpu_torch.data.datasets import (
        FlickrDataset, ImagePathDataset, SIGNAL_COLUMNS, flickr_image_path)
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.data.transforms import normalize_batch
    from weather_unet_tpu_torch.train.gan import GanConfig
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    device = resolve_device(args.device)
    plan = tensor_parallel_plan(args, multiproc, device)
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    cfg = GanConfig(
        num_classes=len(SIGNAL_COLUMNS), lr=args.lr,
        input_size=args.input_size, batch_size=args.batch_size,
        gd_train_ratio=args.GD_train_ratio, mode="est", lmda=args.lmda,
        num_epoch=args.num_epoch, dtype=dt)
    aug, base = augmentation(args)

    if args.image_only:
        # a raw directory, 70/30 split (t_est_train.py:116-121); conditions
        # come entirely from the frozen estimator
        paths = list_images(args.image_root)
        pivot = int(len(paths) * 0.7)
        aug = wrap_decode_cache(aug, args.decode_cache, base, paths[:pivot])
        train_set = ImagePathDataset(paths[:pivot], out_size=base,
                                     transform=aug)
        test_df = None
    else:
        df, _, _ = load_flickr_frame(args.pkl_path, stats_pkl=args.stats_pkl)
        # every rank must draw the same shuffle: the loaders split each
        # batch by rank
        df = df.sample(frac=1, random_state=0 if multiproc else None)
        train_df = df[df["mode"] == "train"]
        test_df = df[df["mode"] == "test"]
        aug = wrap_decode_cache(
            aug, args.decode_cache, base,
            [flickr_image_path(args.image_root, pid)
             for pid in train_df["photo"]])
        train_set = FlickrDataset(args.image_root, train_df, SIGNAL_COLUMNS,
                                  out_size=base, transform=aug)
    print(f"train augment: {aug.route}", flush=True)
    train_loader, random_loader = loader_fns(args, train_set, aug)
    est_apply = load_step_estimator(args.estimator_path, dtype=dt,
                                    device=device)

    # two cached test batches (t_est_train.py:198-207)
    test_batches = None
    if test_df is not None and len(test_df) >= 2 * args.batch_size:
        test_set = FlickrDataset(args.image_root, test_df, SIGNAL_COLUMNS,
                                 out_size=args.input_size)
        it = iter(BatchLoader(test_set, batch_size=args.batch_size,
                              shuffle=True, num_workers=args.num_workers))
        tb = []
        for _ in range(2):
            imgs_u8, conds, _ = next(it)
            tb.append((normalize_batch(torch.from_numpy(imgs_u8).to(device)),
                       torch.from_numpy(conds).to(device)))
        it.close()      # stop the loader's threads now
        test_batches = tuple(tb)

    trainer = WeatherTransferTrainer(
        cfg, est_apply, save_dir=args.save_dir, name=args.name,
        log_dir=args.log_dir, export_torch=args.export_torch,
        nan_guard=args.nan_guard, aot_cache=args.aot_cache,
        device=device, plan=plan, tensor_parallel=plan is not None)
    trainer.fit(train_loader, random_loader, test_batches=test_batches)


if __name__ == "__main__":
    main()
