"""Serving artifacts: the cUNet's serving forwards as ``torch.export``
programs -- the port of ``weather_unet_tpu/core/export.py``.

The serving forward is traced once with a symbolic batch dimension and
saved as an exported program.  One artifact then serves any batch size,
without the model code or the checkpoint: the weights are constants of the
program, which is what a frozen deployment snapshot wants.  The hand-written
kernels stay in the program as the registered ops ``wut::adain`` (K1) and
``wut::upsample2x`` (K2) of a ``use_pallas`` model, so the host that loads
an artifact imports the port's kernel registrations
(``kernels/adain.py``, ``kernels/upsample.py``) and nothing of its models.

Artifact layout (a directory):

    manifest.json      format, torch and package versions, the device type
                       the program was exported on, and per module its
                       geometry, batch mode, dtypes and input shapes
    translate.pt2      (b,H,W,3) float in [-1,1] + (b,C) -> (b,H,W,3)
    translate_u8.pt2   uint8 NHWC + (b,C) float32 -> uint8 NHWC
                       (normalize and denormalize inside the program)

Round trip::

    exps = export_transfer(model, size=256)          # symbolic batch
    save_artifact("art/", exps)
    art = load_artifact("art/")
    y = art["translate"](x, c)                       # any batch size

An artifact runs on the device type it was exported on (its constants live
there); ``load_artifact`` refuses another one before loading anything.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from weather_unet_tpu_torch import __version__
from weather_unet_tpu_torch._device import DeviceLike, resolve_device

FORMAT = "weather_unet_tpu_torch.export/1"
_MODULE_SUFFIX = ".pt2"
_RESERVED = ("format", "torch_version", "package_version", "device",
             "modules")


class _Translate(nn.Module):
    """The serving forward on the JAX package's layout: NHWC in and out."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, c):
        return self.model(x.permute(0, 3, 1, 2).contiguous(),
                          c).permute(0, 2, 3, 1)


class _TranslateU8(nn.Module):
    """``api.WeatherTransfer._fwd_u8`` as one program: the uint8 image
    gathers its normalized value from the 256-entry table that
    ``WeatherTransfer.preprocess`` computes on the host (a buffer of the
    program, on its device), and the result is denormalized to uint8."""

    def __init__(self, model: nn.Module, table: torch.Tensor):
        super().__init__()
        self.translate = _Translate(model)
        self.register_buffer("u8_norm", table)

    def forward(self, x_u8, c):
        y = self.translate(self.u8_norm[x_u8.long()], c)
        return ((y.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def export_transfer(model: nn.Module, *, size: int = 256,
                    batch: Optional[int] = None
                    ) -> Dict[str, "torch.export.ExportedProgram"]:
    """Export the serving forwards of a loaded cUNet (in eval mode, on the
    device the artifact will serve on).

    ``batch=None`` exports with a symbolic batch dimension (at least 1;
    traced at an example batch of 2, since ``torch.export`` specializes the
    sizes 0 and 1): the artifact takes any batch size.  A concrete
    ``batch`` pins the leading dimension instead.

    Returns ``{"translate": ..., "translate_u8": ...}``: float images in
    [-1, 1] in the model's dtype, and the uint8 wire path.
    """
    from weather_unet_tpu_torch.api import WeatherTransfer

    model = model.eval()
    dev = next(model.parameters()).device
    dtype, ncls = model.dtype, model.num_classes
    b = 2 if batch is None else batch
    dims = None
    if batch is None:
        bdim = torch.export.Dim("b", min=1)
        dims = ({0: bdim}, {0: bdim})
    table = WeatherTransfer.preprocess(np.arange(256, dtype=np.uint8))

    def spec(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    with torch.no_grad():
        return {
            "translate": torch.export.export(
                _Translate(model), (spec((b, size, size, 3), dtype),
                                    spec((b, ncls), dtype)),
                dynamic_shapes=dims),
            "translate_u8": torch.export.export(
                _TranslateU8(model, table.to(dev)),
                (spec((b, size, size, 3), torch.uint8),
                 spec((b, ncls), torch.float32)), dynamic_shapes=dims),
        }


def _tensor_meta(program) -> tuple:
    """(input (shape, dtype) pairs, output ones) of a program's user inputs
    and outputs; a symbolic dimension is the string ``"symbolic"``."""
    def meta(val):
        return ([d if isinstance(d, int) else "symbolic" for d in val.shape],
                str(val.dtype).replace("torch.", ""))

    sig = program.graph_signature
    nodes = {n.name: n for n in program.graph.nodes}
    ins = [meta(nodes[name].meta["val"]) for name in sig.user_inputs]
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    outs = [meta(v.meta["val"]) for v in out_node.args[0]]
    return ins, outs


def save_artifact(path: str, exports: Dict[str, object],
                  extra: Optional[dict] = None) -> str:
    """Write an artifact directory: one ``<name>.pt2`` per program and
    ``manifest.json`` (what a consumer checks before loading).  ``extra``
    adds top-level manifest keys; the reserved ones are refused."""
    manifest = {"format": FORMAT, "torch_version": torch.__version__,
                "package_version": __version__, "device": None,
                "modules": {}}
    if extra:
        clash = set(extra) & set(_RESERVED)
        if clash:
            raise ValueError(
                f"extra manifest keys {sorted(clash)} collide with reserved "
                "fields; pick different names")
        manifest.update(extra)
    os.makedirs(path, exist_ok=True)
    for name, program in exports.items():
        fp = os.path.join(path, name + _MODULE_SUFFIX)
        torch.export.save(program, fp)
        ins, outs = _tensor_meta(program)
        devices = {t.device.type for t in program.state_dict.values()}
        manifest["device"] = devices.pop() if len(devices) == 1 else None
        mod = manifest["modules"][name] = {
            "bytes": os.path.getsize(fp),
            "in_shapes": [s for s, _ in ins], "in_dtypes": [d for _, d in ins],
            "out_shapes": [s for s, _ in outs],
            "out_dtypes": [d for _, d in outs]}
        # geometry only for an (image NHWC, condition) signature
        if len(ins) == 2 and len(ins[0][0]) == 4 and len(ins[1][0]) == 2:
            (x_shape, x_dtype), (c_shape, _) = ins
            mod["batch"] = x_shape[0]
            mod["dtype"] = x_dtype
            if isinstance(x_shape[1], int):
                mod["input_size"] = x_shape[1]
            if isinstance(c_shape[1], int):
                mod["num_classes"] = c_shape[1]
    if manifest["device"] is None:
        raise ValueError("the programs' weights do not lie on one device "
                         "type; export the model from one device")
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(path, "manifest.json"))
    return path


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_artifact(path: str, names: Optional[Sequence[str]] = None,
                  device: DeviceLike = None) -> dict:
    """Load an artifact directory's programs: ``{name: callable}``.

    ``device`` (CUDA unless given) must be the device type the artifact was
    exported on: that is checked first, and a mismatch is refused with both
    names before any program is read.  A missing or malformed artifact
    raises FileNotFoundError / ValueError."""
    # the programs call wut::adain / wut::upsample2x (and wut::upconv for a
    # fuse_upconv model): register them
    from weather_unet_tpu_torch.kernels import (  # noqa: F401
        adain, upconv, upsample)

    manifest = load_manifest(path)
    if not str(manifest.get("format", "")).startswith(
            "weather_unet_tpu_torch.export/"):
        raise ValueError(f"{path}: not a weather_unet_tpu_torch export "
                         f"artifact (manifest format="
                         f"{manifest.get('format')!r})")
    dev = resolve_device(device)
    if manifest.get("device") != dev.type:
        raise ValueError(
            f"{path}: artifact was exported for device "
            f"{manifest.get('device')!r} but is loaded for {dev.type!r}; "
            "re-export it on that device")
    out = {}
    for name in (names or manifest["modules"].keys()):
        if name not in manifest["modules"]:
            raise ValueError(
                f"{path}: artifact has no module {name!r} (available: "
                f"{sorted(manifest['modules'])})")
        out[name] = torch.export.load(
            os.path.join(path, name + _MODULE_SUFFIX)).module()
    return out


class ExportedTransfer:
    """Serving facade over an artifact: the ``api.WeatherTransfer`` subset
    the HTTP server needs (``translate`` / ``translate_u8`` with
    power-of-two batch bucketing), backed by exported programs instead of
    model code and a checkpoint.  ``serve --artifact DIR`` serves a frozen
    snapshot this way.

    Needs a symbolic-batch artifact (the export default): bucketing
    dispatches several batch sizes through one program, so a pinned-batch
    artifact is refused up front.  The geometry comes from the module
    record."""

    def __init__(self, path: str, device: DeviceLike = None):
        self.manifest = load_manifest(path)
        meta = self.manifest.get("modules", {}).get("translate", {})
        self.num_classes = meta.get("num_classes")
        self.input_size = meta.get("input_size")
        if self.num_classes is None or self.input_size is None:
            raise ValueError(
                f"{path}: manifest records no input_size/num_classes for "
                "'translate' (serving needs concrete image and class "
                "dimensions; only the batch may be symbolic)")
        batch = meta.get("batch")
        if batch != "symbolic":
            raise ValueError(
                f"{path}: artifact has a pinned batch dimension ({batch}); "
                "serving needs the symbolic-batch export (omit --batch in "
                "export_serving)")
        self.device = resolve_device(device)
        self.dtype = getattr(torch, meta["dtype"])
        mods = load_artifact(path, ("translate", "translate_u8"), device)
        self._translate = mods["translate"]
        self._translate_u8 = mods["translate_u8"]

    @torch.inference_mode()
    def _bucketed(self, fn, x, c, bucket):
        b = x.shape[0]
        nb = 1 << max(b - 1, 0).bit_length()
        if bucket and 0 < b < nb:
            # pads where the input lives: host inputs cross to the device once
            x = torch.cat([x, x.new_zeros((nb - b,) + x.shape[1:])])
            c = torch.cat([c, c.new_zeros((nb - b,) + c.shape[1:])])
        return fn(x.to(self.device), c.to(self.device))[:b]

    def translate(self, images, conditions, *, bucket: bool = True):
        """(B,H,W,3) in [-1,1] + (B,num_classes) -> (B,H,W,3) in the
        artifact's dtype."""
        return self._bucketed(
            self._translate, torch.as_tensor(images).to(self.dtype),
            torch.as_tensor(conditions).to(self.dtype), bucket)

    def translate_u8(self, images_u8, conditions, *, bucket: bool = True):
        """uint8 NHWC in, uint8 NHWC out."""
        return self._bucketed(
            self._translate_u8, torch.as_tensor(images_u8),
            torch.as_tensor(conditions).to(torch.float32), bucket)
