"""GAN transfer training with class conditions (classifier variant) -- the
port of ``weather_unet_tpu/cli/train_transfer_cls.py`` (reference
``t_cls_train.py``).

One-hot (``--supervised``) or classifier-softmax (semi-supervised)
conditions over 5 weather classes, on the i2w directory split, the Flickr
frame or a bare image directory (``t_cls_train.py:110-144``).  Runs on CUDA
unless ``--device cpu``; under ``parallel/launch.py`` data parallel, and
with ``--tensor_parallel T`` split over T ranks at a time
(``train_transfer_est.py``).
"""

from __future__ import annotations

import argparse

from weather_unet_tpu_torch.cli.train_transfer_est import (
    augmentation, loader_fns, tensor_parallel_plan)


def build_parser():
    p = argparse.ArgumentParser(
        description="train weather transfer (classifier)")
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--name", type=str, default="cUNet")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default=None,
                   help="torch device: cuda (default; this rank's card "
                        "under the launcher) or cpu")
    p.add_argument("--save_dir", type=str, default="cp/transfer")
    p.add_argument("--log_dir", type=str, default="runs")
    p.add_argument("--pkl_path", type=str, default=None,
                   help="dataframe / split pickle (required unless "
                        "--image_only)")
    p.add_argument("--estimator_path", type=str, required=True,
                   help="frozen classifier, a state-dict .pt")
    p.add_argument("--dataset", type=str, default="flicker",
                   choices=["flicker", "i2w"])
    p.add_argument("--supervised", action="store_true")
    p.add_argument("--cross_ent", action="store_true")
    p.add_argument("--one_hot", action="store_true",
                   help="parity flag; evaluation labels are always one-hot "
                        "(the reference's other branch crashes on int "
                        "labels, t_cls_train.py:330-337)")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lmda", type=float, default=None)
    p.add_argument("--num_epoch", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--GD_train_ratio", type=int, default=1)
    p.add_argument("--sampler", action="store_true")
    p.add_argument("--augmentation", action="store_true")
    p.add_argument("--image_only", action="store_true",
                   help="train from a raw image directory (no pkl), 70/30 "
                        "split, conditions entirely from the frozen "
                        "classifier; no evaluation, as in the reference "
                        "(t_cls_train.py:119,138-144,441)")
    p.add_argument("--export_torch", action="store_true")
    p.add_argument("--decode_cache", type=str, default=None,
                   help="decoded-image memmap cache dir: images decode once "
                        "(first epoch), later epochs only augment "
                        "(data/cache.py)")
    p.add_argument("--nan_guard", action="store_true",
                   help="on non-finite metrics, roll back to the newest "
                        "checkpoint and retry with re-seeded dropout "
                        "(bounded; see WeatherTransferTrainer)")
    p.add_argument("--aot_cache", type=str, default=None,
                   help="AOT tier directory (core/aot.py): on CUDA each "
                        "step program runs as a CUDA graph captured at its "
                        "first step")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="split every double conv over T ranks of the "
                        "launcher (parallel/tp.py); the data axis is the "
                        "ranks / T")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="compute dtype of the train step (parameters stay "
                        "float32)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.image_only:
        # a bare directory has no labels: supervised conditions and the
        # imbalance sampler need them (the reference would crash later)
        if args.supervised:
            raise SystemExit("--image_only has no dataset labels; "
                             "--supervised requires them")
        if args.sampler:
            raise SystemExit("--image_only has no class labels for the "
                             "imbalance sampler; drop --sampler")
    elif args.pkl_path is None:
        raise SystemExit("--pkl_path is required unless --image_only")
    from weather_unet_tpu_torch.parallel.launch import maybe_initialize

    multiproc = maybe_initialize()
    import torch

    from weather_unet_tpu_torch._device import resolve_device
    from weather_unet_tpu_torch.cli.common import (
        list_images, load_step_estimator, wrap_decode_cache)
    from weather_unet_tpu_torch.data.datasets import (
        ClassImageDataset, FlickrDataset, ImagePathDataset, SIGNAL_COLUMNS,
        filter_i2w_paths, flickr_image_path)
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.data.transforms import normalize_batch
    from weather_unet_tpu_torch.train.gan import GanConfig
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    device = resolve_device(args.device)
    plan = tensor_parallel_plan(args, multiproc, device)
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    cfg = GanConfig(
        num_classes=5, lr=args.lr, input_size=args.input_size,
        batch_size=args.batch_size, gd_train_ratio=args.GD_train_ratio,
        mode="cls", supervised=args.supervised, cross_ent=args.cross_ent,
        # a bare directory has no labels: cross-entropy targets come from
        # the classifier's argmax (the step's semi-supervised flicker branch)
        dataset="flicker" if args.image_only else args.dataset,
        lmda=args.lmda, num_epoch=args.num_epoch, dtype=dt)
    aug, base = augmentation(args)

    if args.image_only:
        paths = list_images(args.image_root)
        pivot = int(len(paths) * 0.7)
        aug = wrap_decode_cache(aug, args.decode_cache, base, paths[:pivot])
        train_set = ImagePathDataset(paths[:pivot], out_size=base,
                                     transform=aug)
        test_set = None
    elif args.dataset == "i2w":
        import pandas as pd

        sep = pd.read_pickle(args.pkl_path)   # {'train': [..], 'test': [..]}
        aug = wrap_decode_cache(aug, args.decode_cache, base,
                                filter_i2w_paths(sep["train"]))
        train_set = ClassImageDataset(sep["train"], out_size=base,
                                      transform=aug)
        test_set = ClassImageDataset(sep["test"], out_size=args.input_size)
    else:
        import pandas as pd

        # the same shuffle on every rank: the loaders split each batch
        df = pd.read_pickle(args.pkl_path).sample(
            frac=1, random_state=0 if multiproc else None)
        train_df = df[df["mode"] == "train"]
        aug = wrap_decode_cache(
            aug, args.decode_cache, base,
            [flickr_image_path(args.image_root, pid)
             for pid in train_df["photo"]])
        train_set = FlickrDataset(args.image_root, train_df, SIGNAL_COLUMNS,
                                  out_size=base, class_id=False,
                                  imbalance=args.sampler, transform=aug)
        test_set = FlickrDataset(args.image_root, df[df["mode"] == "test"],
                                 SIGNAL_COLUMNS, out_size=args.input_size,
                                 class_id=False)
    print(f"train augment: {aug.route}", flush=True)
    train_loader, random_loader = loader_fns(args, train_set, aug)
    # raw logits; the step applies the softmax
    est_apply = load_step_estimator(args.estimator_path, dtype=dt,
                                    device=device)

    test_batches = None
    if test_set is not None and len(test_set) >= 2 * args.batch_size:
        it = iter(BatchLoader(test_set, batch_size=args.batch_size,
                              shuffle=True, num_workers=args.num_workers))
        eye = torch.eye(5, device=device)
        tb = []
        for _ in range(2):
            imgs_u8, cls_ids = next(it)[:2]
            labels = eye[torch.from_numpy(cls_ids).to(device)]
            tb.append((normalize_batch(torch.from_numpy(imgs_u8).to(device)),
                       labels))                    # t_cls_train.py:327-329
        it.close()      # stop the loader's threads now
        test_batches = tuple(tb)

    trainer = WeatherTransferTrainer(
        cfg, est_apply, save_dir=args.save_dir, name=args.name,
        log_dir=args.log_dir, export_torch=args.export_torch,
        nan_guard=args.nan_guard, aot_cache=args.aot_cache,
        device=device, plan=plan, tensor_parallel=plan is not None)
    # image_only batches are (img, True) with no class ids: the step runs
    # fully semi-supervised
    trainer.fit(train_loader, random_loader, test_batches=test_batches,
                labeled=not args.image_only)


if __name__ == "__main__":
    main()
