"""Classifier accuracy eval -- the port of
``weather_unet_tpu/cli/eval_classifier_i2w.py`` (reference
``eval/eval_classifier_i2w.py``): classification report and confusion
matrix on the i2w test split (``cm.pkl``, ``pr_table.png``); with
``--copy_misclassified`` each misclassified image is copied as
``{true}-true_{file}_{pred}-pred.jpg`` (``eval_classifier_i2w.py:91-114``).
Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import shutil


def build_parser():
    p = argparse.ArgumentParser(description="classifier i2w accuracy")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--pkl_path", type=str, required=True)
    p.add_argument("--classifier_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="eval_cls_out")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--copy_misclassified", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import pandas as pd

    from weather_unet_tpu_torch._device import resolve_device
    from weather_unet_tpu_torch.cli.common import load_estimator, model_input
    from weather_unet_tpu_torch.data.datasets import (
        WEATHER_CLASSES_I2W, ClassImageDataset)
    from weather_unet_tpu_torch.data.pipeline import (
        BatchLoader, device_prefetch)
    from weather_unet_tpu_torch.evaluation.transfer import (
        classification_report_dict, classifier_accuracy,
        write_confusion_artifacts)

    os.makedirs(args.output_dir, exist_ok=True)
    device = resolve_device(args.device)
    classify = load_estimator(args.classifier_path, device=device)
    sep = pd.read_pickle(args.pkl_path)
    ds = ClassImageDataset(sep["test"], out_size=args.input_size, inf=True)
    loader = BatchLoader(ds, batch_size=args.batch_size, drop_last=False,
                         num_workers=args.num_workers)
    batches = ((model_input(b[0]), b[1], b[2])
               for b in device_prefetch(loader, device, device_fields=[0]))
    y_true, y_pred, paths = classifier_accuracy(classify, batches)

    out = classification_report_dict(y_true, y_pred, WEATHER_CLASSES_I2W)
    cm = out["confusion_matrix"]
    print(out["text"])
    print(cm)
    # the reference's on-disk artifacts (eval_classifier_i2w.py:106-114)
    write_confusion_artifacts(args.output_dir, cm, WEATHER_CLASSES_I2W)
    if args.copy_misclassified:
        for t, pr, path in zip(y_true, y_pred, paths):
            if t != pr:
                base = os.path.basename(path)
                name = (f"{WEATHER_CLASSES_I2W[t]}-true_{base}_"
                        f"{WEATHER_CLASSES_I2W[pr]}-pred.jpg")
                shutil.copy(path, os.path.join(args.output_dir, name))
    return {"y_true": y_true, "y_pred": y_pred, "confusion_matrix": cm}


if __name__ == "__main__":
    main()
