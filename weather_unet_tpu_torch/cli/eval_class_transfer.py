"""Class-transfer consistency eval -- the port of
``weather_unet_tpu/cli/eval_class_transfer.py`` (reference
``eval/eval_class_transfer.py``): the i2w test split translated to all 5
classes, the outputs re-classified by the frozen classifier; prints the
classification report and writes the confusion matrix (``cm.pkl``) and its
heatmap (``pr_table.png``, where matplotlib and seaborn are installed).
Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description="class-transfer consistency")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--image_root", type=str, default=None,
                   help="parity flag; ignored — the reference parses it and "
                        "never reads it either (eval_class_transfer.py:17; "
                        "the split pickle carries absolute paths)")
    p.add_argument("--pkl_path", type=str, required=True,
                   help="i2w split pickle (uses the 'test' list)")
    p.add_argument("--cp_path", type=str, required=True)
    p.add_argument("--classifier_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="eval_out")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import pandas as pd

    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.cli.common import load_estimator, model_input
    from weather_unet_tpu_torch.data.datasets import (
        WEATHER_CLASSES_I2W, ClassImageDataset)
    from weather_unet_tpu_torch.data.pipeline import (
        BatchLoader, device_prefetch)
    from weather_unet_tpu_torch.evaluation.transfer import (
        class_transfer_consistency, classification_report_dict,
        write_confusion_artifacts)

    os.makedirs(args.output_dir, exist_ok=True)
    wt = WeatherTransfer.load(args.cp_path, device=args.device)
    classify = load_estimator(args.classifier_path, device=wt.device)
    sep = pd.read_pickle(args.pkl_path)
    test_set = ClassImageDataset(sep["test"], out_size=args.input_size)
    loader = BatchLoader(test_set, batch_size=args.batch_size, drop_last=True,
                         num_workers=args.num_workers)
    batches = (model_input(b[0])
               for b in device_prefetch(loader, wt.device, device_fields=[0]))
    y_true, y_pred = class_transfer_consistency(wt, classify, batches)
    out = classification_report_dict(y_true, y_pred, WEATHER_CLASSES_I2W)
    print(out["text"])
    write_confusion_artifacts(args.output_dir, out["confusion_matrix"],
                              WEATHER_CLASSES_I2W)
    return out


if __name__ == "__main__":
    main()
