"""Export the serving forward to an artifact -- the port of
``weather_unet_tpu/cli/export_serving.py``.

The reference deploys by shipping ``.pt`` pickles and the whole source tree
(``demo.py:51-54`` rebuilds the nn.Module to load them); this CLI writes a
directory of ``torch.export`` programs (``core/export.py``) with the
weights inside and a symbolic batch dimension, which ``serve --artifact``
runs without the model code.  The cUNet is loaded with ``use_pallas`` on
(``load_transfer``'s default), so K1 and K2 are in the programs as the
registered ops ``wut::adain`` and ``wut::upsample2x``.

    python -m weather_unet_tpu_torch.cli.export_serving \\
        --cp_path ckpt.msgpack --out art/ --dtype bf16 --check
"""

from __future__ import annotations

import argparse
import json


def build_parser():
    p = argparse.ArgumentParser(description="export the serving artifact")
    p.add_argument("--cp_path", required=True,
                   help="msgpack checkpoint or reference .pt GAN bundle")
    p.add_argument("--out", required=True, help="artifact directory to write")
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--num_classes", type=int, default=5)
    p.add_argument("--dtype", choices=["f32", "bf16"], default="bf16")
    p.add_argument("--batch", type=int, default=None,
                   help="pin the batch dimension (default: symbolic -- the "
                        "artifact accepts any batch size)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the artifact runs on: cuda (default) "
                        "or cpu")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and verify it matches the live "
                        "model on a small batch before reporting success")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from weather_unet_tpu_torch.cli.common import load_transfer
    from weather_unet_tpu_torch.core.export import (
        export_transfer, load_artifact, save_artifact)

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = load_transfer(args.cp_path, num_classes=args.num_classes,
                          dtype=dtype, device=args.device)
    exps = export_transfer(model, size=args.input_size, batch=args.batch)
    save_artifact(args.out, exps, extra={
        "checkpoint": args.cp_path, "input_size": args.input_size,
        "num_classes": args.num_classes, "dtype": args.dtype})
    if args.check:
        b = args.batch or 2
        rng = np.random.default_rng(0)
        dev = next(model.parameters()).device
        x = torch.from_numpy(rng.standard_normal(
            (b, args.input_size, args.input_size, 3)).astype(np.float32)
            ).to(dev, dtype)
        c = torch.from_numpy(np.eye(args.num_classes, dtype=np.float32)[
            rng.integers(0, args.num_classes, b)]).to(dev, dtype)
        with torch.inference_mode():
            got = load_artifact(args.out, device=args.device)["translate"](
                x, c)
            want = model(x.permute(0, 3, 1, 2).contiguous(), c).permute(
                0, 2, 3, 1)
        mae = float((got.float() - want.float()).abs().max())
        if mae > 1e-5:
            raise SystemExit(f"export check FAILED: max abs diff {mae}")
    print(json.dumps({"artifact": args.out, "modules": sorted(exps),
                      "batch": args.batch or "symbolic",
                      "checked": bool(args.check)}))


if __name__ == "__main__":
    main()
