"""How far the bfloat16 cUNet forward lies from its own float32 forward, in
the port and in the JAX package, on the same weights and inputs.

The bar of the port's bfloat16 serving is <= 1e-3 pixel MAE from its own
float32 (``BASELINE.json``).  On the card, a seeded full-width model at
B=1, 256x256 came out at 1.0037e-3 (``ROADMAP.md`` §3).  This file holds
the port's distance at B=1 to the JAX package's own, so that it cannot
grow unseen: the JAX bfloat16 resize accumulates in bfloat16
(``weather_unet_tpu/ops/resize.py:60-61``), the port's in float32, and
JAX's distance is the larger one.  The test runs at 64x64; the same
measurement at the serving size prints with

    python -m tests.test_torch_bf16_distance [--size 256] [--batches 1 3]

(the port plain and ``use_pallas``, whose CPU path is K1's and K2's plain
versions, and the JAX package without its Pallas kernels; weights from
JAX's seeded init, and from the port's seeded init as ``chip_smoke.py``
makes them, each converted with ``compat/torch_io.py``).
"""

import argparse
import json

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.models import ConditionalUNet as JaxUNet
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.models import ConditionalUNet


def inputs(size, b):
    """``chip_smoke.py`` phase e2e's inputs (seed 0), the first ``b`` rows:
    uint8 images normalized to [-1, 1], one-hot conditions with every
    fourth row standard normal."""
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (16, size, size, 3), dtype=np.uint8)
    conds = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]
    conds[::4] = rng.standard_normal((len(conds[::4]), 5)).astype(np.float32)
    x = (u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    return x[:b], conds[:b]


def weights(init, size):
    """(JAX params, port state dict) of one seeded model: ``"jax"`` is the
    JAX package's init (key 0), ``"port"`` the port's (torch seed 0, as
    ``chip_smoke.py`` makes its serving checkpoint)."""
    if init == "jax":
        params = JaxUNet(num_classes=5).init(
            jax.random.key(0), jnp.zeros((1, size, size, 3)),
            jnp.zeros((1, 5)))["params"]
        sd = torch_io.cunet_state_dict_from_jax({"params": params})
        return params, {k: torch.from_numpy(np.array(v))
                        for k, v in sd.items()}
    torch.manual_seed(0)
    sd = ConditionalUNet(5).state_dict()
    return torch_io.cunet_state_dict_to_jax(sd)["params"], sd


def distances(size, b, init="jax", row=None) -> dict:
    """Pixel MAE between the bfloat16 and the float32 forward of each
    implementation, on one model and one batch (with ``row``, that one
    input alone)."""
    params, sd = weights(init, size)
    x, c = inputs(size, b if row is None else row + 1)
    if row is not None:
        x, c = x[row:], c[row:]
    out = {}
    for name, use_pallas in (("port_plain", False), ("port_use_pallas",
                                                      True)):
        ys = []
        for dt in (torch.float32, torch.bfloat16):
            model = ConditionalUNet(5, dtype=dt, use_pallas=use_pallas)
            model.load_state_dict(sd, strict=True)
            with torch.no_grad():
                ys.append(nhwc(model.eval()(nchw(x), torch.from_numpy(c))
                               .float()))
        out[name] = float(np.abs(ys[1] - ys[0]).mean())
    ys = [np.asarray(JaxUNet(num_classes=5, dtype=dt).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(c)), np.float32)
          for dt in (jnp.float32, jnp.bfloat16)]
    out["jax"] = float(np.abs(ys[1] - ys[0]).mean())
    return out


def test_port_bf16_distance_at_batch_1_within_jax_own():
    """64x64, B=1, both seeded inits: the port's bfloat16-vs-float32 MAE,
    plain and use_pallas, no larger than the JAX package's own."""
    for init in ("jax", "port"):
        d = distances(64, 1, init)
        assert d["port_plain"] <= d["jax"], (init, d)
        assert d["port_use_pallas"] <= d["jax"], (init, d)
        # the plain and the kernels' routes round at the same points
        assert abs(d["port_use_pallas"] - d["port_plain"]) <= (
            0.1 * d["port_plain"]), (init, d)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batches", type=int, nargs="*", default=[1, 3, 16])
    p.add_argument("--rows", type=int, nargs="*", default=[],
                   help="also each of these inputs alone (B=1): rows 0, 4, "
                        "8 and 12 carry standard-normal conditions, the "
                        "others one-hot ones")
    p.add_argument("--inits", nargs="+", default=["jax", "port"])
    args = p.parse_args()
    for init in args.inits:
        for b in args.batches:
            print(json.dumps({"init": init, "size": args.size, "batch": b,
                              **distances(args.size, b, init)}), flush=True)
        for row in args.rows:
            print(json.dumps({"init": init, "size": args.size, "row": row,
                              **distances(args.size, 1, init, row)}),
                  flush=True)
