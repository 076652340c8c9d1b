"""Pseudo-labeling: the weather classifier over a dataset, its softmax
predictions written back as a ``w_condition`` column -- the port of
``weather_unet_tpu/cli/inf_classifier_i2w.py`` (reference
``inference/inf_classifier_i2w.py:43-113``).

``flicker`` labels a dataframe pickle, ``i2w`` the split pickle's test
paths (i2w class names), ``raw`` a flat directory.  As in the JAX package,
partial final batches are labeled, every mode uses the canonical flickr /
i2w class order (the reference's pseudo-labeler swaps Snow and Mist), and a
photo whose file is unreadable gets ``w_condition`` None with a warning.
Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from weather_unet_tpu_torch.data.datasets import (
    WEATHER_CLASSES_FLICKR, WEATHER_CLASSES_I2W)


def build_parser():
    p = argparse.ArgumentParser(description="classifier pseudo-labeling")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--pkl_path", type=str, default=None)
    p.add_argument("--output_pkl", type=str, default=None)
    p.add_argument("--classifier_path", type=str, required=True)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--dataset", type=str, default="flicker",
                   choices=["flicker", "i2w", "raw"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.dataset in ("flicker", "i2w") and args.pkl_path is None:
        raise SystemExit(f"--pkl_path is required with --dataset "
                         f"{args.dataset} (flicker: dataframe pickle; i2w: "
                         f"train/test split pickle); use --dataset raw for "
                         f"a pickle-less image directory")
    import pandas as pd
    import torch

    from weather_unet_tpu_torch._device import resolve_device
    from weather_unet_tpu_torch.cli.common import (
        list_images, load_estimator, model_input)
    from weather_unet_tpu_torch.data.datasets import (
        SIGNAL_COLUMNS, FlickrDataset, ImagePathDataset)
    from weather_unet_tpu_torch.data.pipeline import (
        BatchLoader, device_prefetch)

    device = resolve_device(args.device)
    classify = load_estimator(args.classifier_path, softmax=True,
                              device=device)

    class_names = WEATHER_CLASSES_FLICKR
    if args.dataset == "flicker":
        df = pd.read_pickle(args.pkl_path)
        dataset = FlickrDataset(args.image_root, df, SIGNAL_COLUMNS,
                                out_size=args.input_size)
    elif args.dataset == "i2w":
        # the split pickle's test paths, i2w names (inf_classifier_i2w.py:
        # 70-78)
        split = pd.read_pickle(args.pkl_path)
        class_names = WEATHER_CLASSES_I2W
        dataset = ImagePathDataset(split["test"], out_size=args.input_size,
                                   with_path=True)
    else:
        dataset = ImagePathDataset(list_images(args.image_root),
                                   out_size=args.input_size, with_path=True)

    loader = BatchLoader(dataset, batch_size=args.batch_size, drop_last=False,
                         num_workers=args.num_workers)
    preds, keys = [], []
    for batch in device_prefetch(loader, device, device_fields=[0]):
        with torch.inference_mode():
            preds.append(classify(model_input(batch[0])).float().cpu()
                         .numpy())
        keys.extend(list(batch[-1]))
    probs = np.concatenate(preds, axis=0)
    labels = [class_names[i] for i in probs.argmax(axis=1)]

    if args.dataset == "flicker" and args.output_pkl:
        # an unreadable photo makes FlickrDataset substitute its neighbour,
        # so its own id never reaches the keys: its row gets None
        order = {pid: i for i, pid in enumerate(keys)}
        df = df.copy()
        missing = [p for p in df["photo"] if p not in order]
        df["w_condition"] = [labels[order[p]] if p in order else None
                             for p in df["photo"]]
        if missing:
            print(f"warning: {len(missing)} photo(s) had no prediction "
                  f"(unreadable image substituted during loading) — "
                  f"w_condition left None: {missing[:10]}"
                  + (" ..." if len(missing) > 10 else ""), flush=True)
        df.to_pickle(args.output_pkl)
        print(f"wrote {args.output_pkl}")
    elif args.output_pkl:
        # path modes: a paths -> label table (the reference writes
        # check_result.pkl with a w_condition column)
        pd.DataFrame({"paths": keys, "w_condition": labels}).to_pickle(
            args.output_pkl)
        print(f"wrote {args.output_pkl}")
    else:
        for k, lb, p in zip(keys, labels, probs):
            print(f"{k}\t{lb}\t{p.max():.3f}")


if __name__ == "__main__":
    main()
