"""TensorBoard image summaries back to JPEGs -- the port of
``weather_unet_tpu/cli/write_image_summary.py`` (the reference's
``sh/write_image_summary.py``).  Reads the image events a run's
``train/metrics.py::SummaryWriter.add_image_grid`` wrote (TensorBoard
stores PNG bytes) and re-encodes each as ``<tag>_<step>_<index>.jpg``.

    python -m weather_unet_tpu_torch.cli.write_image_summary \\
        --event_path runs/<run> --output_dir summary_images
"""

from __future__ import annotations

import argparse
import io
import os


def build_parser():
    p = argparse.ArgumentParser(description="TB image summary -> jpg export")
    p.add_argument("--event_path", type=str, required=True,
                   help="event file or run directory")
    p.add_argument("--output_dir", type=str, default="summary_images")
    p.add_argument("--tag", type=str, default=None, help="only export this tag")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator)
    except ImportError:
        raise SystemExit("tensorboard is not available in this environment")
    from PIL import Image

    acc = EventAccumulator(args.event_path, size_guidance={"images": 0})
    acc.Reload()
    count = 0
    for tag in acc.Tags().get("images", []):
        if args.tag and tag != args.tag:
            continue
        for i, ev in enumerate(acc.Images(tag)):
            # the index keeps apart events of one step
            name = f"{tag.replace('/', '_')}_{ev.step}_{i}.jpg"
            img = Image.open(io.BytesIO(ev.encoded_image_string)).convert("RGB")
            img.save(os.path.join(args.output_dir, name), quality=95)
            count += 1
    print(f"wrote {count} images to {args.output_dir}")


if __name__ == "__main__":
    main()
