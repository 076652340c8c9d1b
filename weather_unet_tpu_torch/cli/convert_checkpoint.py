"""Checkpoint converter between the JAX package's flax msgpack files and
the reference PyTorch formats -- the port of
``weather_unet_tpu/cli/convert_checkpoint.py``, with the port's msgpack
reader and writer (``train/checkpoint.py``, no flax) and converters
(``compat/torch_io.py``).

Subcommands:
  to-torch    msgpack GAN / ResNet checkpoint -> .pt (reference layout)
  from-torch  reference .pt -> msgpack

    python -m weather_unet_tpu_torch.cli.convert_checkpoint to-torch \\
        --kind gan --input ckpt_s0000001000.msgpack --output gan.pt
    python -m weather_unet_tpu_torch.cli.convert_checkpoint from-torch \\
        --kind resnet --input est_resnet101.pt --output est.msgpack

``--output`` is the file written, literally.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="checkpoint format conversion")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("to-torch", "from-torch"):
        s = sub.add_parser(name)
        s.add_argument("--kind", choices=["gan", "resnet"], required=True)
        s.add_argument("--input", required=True)
        s.add_argument("--output", required=True)
    return p


def _tensors(sd) -> dict:
    import numpy as np
    import torch

    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from weather_unet_tpu_torch.compat import torch_io
    from weather_unet_tpu_torch.train import checkpoint as ckpt

    if args.cmd == "to-torch":
        state = ckpt.read_msgpack(args.input)
        if args.kind == "gan":
            gen = torch_io.cunet_state_dict_from_jax(
                {"params": state["gen"]["params"]})
            disc = torch_io.sndisc_state_dict_from_jax(
                {"params": state["disc"]["params"],
                 "spectral": state["spectral"]})
            torch.save({
                "inference": _tensors(gen),
                "discriminator": ckpt.reference_disc_state_dict(
                    _tensors(disc)),
                "epoch": int(np.asarray(state.get("epoch", 0))),
                "global_step": int(np.asarray(state.get("global_step", 0))),
            }, args.output)
        else:
            torch.save(_tensors(torch_io.resnet_state_dict_from_jax(
                {"params": state["params"],
                 "batch_stats": state["batch_stats"]})), args.output)
        print(f"wrote {args.output}")
        return
    obj = torch_io.load_torch_file(args.input)
    if args.kind == "gan":
        gen = torch_io.cunet_state_dict_to_jax(obj["inference"])
        disc = torch_io.sndisc_state_dict_to_jax(obj["discriminator"])
        tree = {"gen": {"params": gen["params"]},
                "disc": {"params": disc["params"]},
                "spectral": disc["spectral"],
                "epoch": int(obj.get("epoch", 0)),
                "global_step": int(obj.get("global_step", 0))}
    else:
        tree = torch_io.resnet_state_dict_to_jax(obj)
    path = ckpt.save_checkpoint_file(args.output, tree)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
