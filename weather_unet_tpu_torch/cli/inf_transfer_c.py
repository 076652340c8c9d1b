"""Class-conditional batch translation -- the port of
``weather_unet_tpu/cli/inf_transfer_c.py`` (reference
``inference/inf_transfer_c.py``): every test image translated to each of the
5 weather classes (one-hot conditions), saved per image as
``{src_class}_{photo}_{dst_class}.jpg`` with a per-image min-max stretch
(torchvision's ``save_image(normalize=True)``).  All classes of a batch run
as one forward of classes x batch images, on CUDA unless ``--device cpu``.

    python -m weather_unet_tpu_torch.cli.inf_transfer_c --image_root DIR \\
        --cp_path cp.pt --image_only
"""

from __future__ import annotations

import argparse
import os

from weather_unet_tpu_torch.data.datasets import WEATHER_CLASSES_I2W


def build_parser():
    p = argparse.ArgumentParser(description="one-hot class weather transfer")
    p.add_argument("--gpu", type=str, default="0", help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--image_root", type=str, required=True)
    p.add_argument("--pkl_path", type=str, default=None,
                   help="dataframe pickle (i2w path-list or flickr frame)")
    p.add_argument("--output_dir", type=str, default="results_c")
    p.add_argument("--cp_path", type=str, required=True)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--image_only", action="store_true",
                   help="translate a raw directory of images")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.cli.common import (
        list_images, model_input, save_image)
    from weather_unet_tpu_torch.data.datasets import (
        ClassImageDataset, ImagePathDataset)
    from weather_unet_tpu_torch.data.pipeline import (
        BatchLoader, device_prefetch)

    os.makedirs(args.output_dir, exist_ok=True)
    classes = WEATHER_CLASSES_I2W
    wt = WeatherTransfer.load(args.cp_path, num_classes=len(classes),
                              device=args.device)

    if args.image_only or args.pkl_path is None:
        dataset = ImagePathDataset(list_images(args.image_root),
                                   out_size=args.input_size, with_path=True)
        get_src = lambda meta: "img"
    else:
        import pandas as pd

        obj = pd.read_pickle(args.pkl_path)
        if isinstance(obj, dict):  # i2w split: {'train': paths, 'test': ...}
            paths = obj.get("test", next(iter(obj.values())))
        else:
            paths = list(obj)
        dataset = ClassImageDataset(paths, out_size=args.input_size, inf=True)
        get_src = lambda meta: meta.split(os.sep)[-2]
    get_name = lambda meta: os.path.splitext(os.path.basename(meta))[0]

    loader = BatchLoader(dataset, batch_size=args.batch_size, drop_last=False,
                         num_workers=args.num_workers)
    for batch in device_prefetch(loader, wt.device, device_fields=[0]):
        imgs_u8, metas = batch[0], batch[-1]
        with torch.inference_mode():
            outs = wt.translate_to_classes(model_input(imgs_u8))
        outs = outs.float().cpu().numpy()              # (K, B, H, W, 3)
        for ci, cname in enumerate(classes):
            for bi in range(outs.shape[1]):
                meta = metas[bi]
                name = f"{get_src(meta)}_{get_name(meta)}_{cname}.jpg"
                # per-image min-max, as the reference's save_image
                # (inf_transfer_c.py:119-121)
                save_image(os.path.join(args.output_dir, name),
                           outs[ci, bi][None], nrow=1)
    print(f"Done: outputs in {args.output_dir}")


if __name__ == "__main__":
    main()
