"""Inception Score CLI -- the port of
``weather_unet_tpu/cli/inception_score.py`` (reference
``eval/inception_score.py``).

The reference scores a directory with stock torchvision
``inception_v3(pretrained=True, transform_input=False)``: images resized to
``--input_size``, normalized to [-1, 1], upsampled to 299 (bilinear),
softmax over the 1000-way ImageNet head, IS over ``--splits`` chunks.

Weights must be a local file:

* a 1000-way torchvision ``inception_v3`` ``.pth`` -> the reference metric
  (stock graph: average pools that count the padding, Mixed_7c averaging);
* the 1008-way TF-ported FID checkpoint -> scored with the FID graph and
  labelled loudly: a different metric, not comparable to the reference's;
* none -> refused unless ``--allow-random-weights`` (a structural smoke run
  with seeded random weights), as FID refuses.

    python -m weather_unet_tpu_torch.cli.inception_score --image_dir DIR \
        --weights inception_v3.pth [--device cpu]
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Inception Score")
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--input_size", type=int, default=224,
                   help="pre-resize before the 299 upsample "
                        "(eval/inception_score.py:14,104-107)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--splits", type=int, default=10)
    p.add_argument("--weights", type=str, default=None,
                   help="local torchvision inception_v3 .pth (1000-way, "
                        "reference-comparable) or TF-ported FID checkpoint "
                        "(1008-way, labeled non-comparable)")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="permit structure-only smoke scoring with random "
                        "weights (meaningless as a metric)")
    p.add_argument("--gpu", type=str, default="", help="parity flag; ignored")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def load_model(args):
    """The Inception-v3 with its head that ``--weights`` /
    ``--allow-random-weights`` select, on the CPU."""
    import torch

    from weather_unet_tpu_torch.compat.torch_io import (
        inception_state_dict, load_torch_file)
    from weather_unet_tpu_torch.models.inception_fid import InceptionV3FID

    if args.weights:
        sd = load_torch_file(args.weights)
        if "fc.bias" not in sd:
            raise SystemExit(
                f"{args.weights} has no fc head; Inception Score needs class "
                "logits (a pool3-only checkpoint can score FID, not IS)")
        num_logits = sd["fc.bias"].shape[0]
        torchvision_stock = num_logits == 1000
        model = InceptionV3FID(with_logits=True, num_logits=num_logits,
                               tf_variant=not torchvision_stock)
        model.load_state_dict(inception_state_dict(sd, with_logits=True))
        if torchvision_stock:
            print("torchvision inception_v3 weights (1000-way): "
                  "reference-comparable Inception Score")
        else:
            print(f"WARNING: {num_logits}-way TF-variant head: scoring with "
                  "the FID graph. This is a DIFFERENT metric from the "
                  "reference's torchvision IS; numbers are not comparable.")
        return model
    if args.allow_random_weights:
        print("WARNING: random Inception weights; scores are structural "
              "smoke values only, meaningless as a metric")
        return InceptionV3FID(with_logits=True, num_logits=1000,
                              tf_variant=False,
                              generator=torch.Generator().manual_seed(0))
    raise SystemExit(
        "Inception Score with random weights is meaningless; provide a "
        "local checkpoint via --weights (torchvision inception_v3 .pth "
        "for the reference metric) or pass --allow-random-weights for a "
        "structure-only smoke run")


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from weather_unet_tpu_torch._device import resolve_device
    from weather_unet_tpu_torch.cli.common import list_images
    from weather_unet_tpu_torch.evaluation.fid import _image_batches
    from weather_unet_tpu_torch.evaluation.inception_score import (
        inception_score_from_probs)

    files = list_images(args.image_dir)
    model = load_model(args)
    dev = resolve_device(args.device)
    model = model.to(dev).eval()
    probs = []
    with torch.inference_mode():
        # [0, 1] input; the model's normalize_input is the reference's
        # Normalize(0.5) and its resize_input the nn.Upsample(299)
        # (align_corners=False), eval/inception_score.py:67,104-107
        for batch in _image_batches(files, args.batch_size,
                                    size=args.input_size):
            x = torch.from_numpy(batch).to(dev).permute(0, 3, 1, 2)
            logits = model(x.contiguous()).float()
            probs.append(torch.softmax(logits, dim=1).cpu().numpy())
    mean, std = inception_score_from_probs(np.concatenate(probs),
                                           splits=args.splits)
    print(f"IS: {mean:.4f} +/- {std:.4f}")
    return mean, std


if __name__ == "__main__":
    main()
