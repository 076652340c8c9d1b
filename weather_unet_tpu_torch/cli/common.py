"""Shared CLI plumbing: checkpoint loading."""

from __future__ import annotations

import pickle

import torch

from weather_unet_tpu_torch._device import DeviceLike, resolve_device
from weather_unet_tpu_torch.compat.torch_io import (
    _infer_block_counts, load_torch_file, strip_module_prefix)
from weather_unet_tpu_torch.models import ConditionalUNet, ResNet


def load_transfer(cp_path: str, num_classes: int = 5,
                  dtype: torch.dtype = torch.float32, fuse_upconv="auto",
                  device: DeviceLike = None) -> ConditionalUNet:
    """Load a cUNet from a reference ``.pt`` GAN bundle (``sd['inference']``)
    onto ``device`` (CUDA unless given), in eval mode.

    ``fuse_upconv`` selects the fused upsample+conv decoder
    (``kernels/upconv.py``); ``"auto"`` resolves to off, as in the JAX
    package, until measurements on the GPU decide otherwise."""
    device = resolve_device(device)
    if not cp_path.endswith((".pt", ".pth")):
        raise ValueError(
            f"{cp_path}: msgpack checkpoints are not yet supported by the "
            f"port; convert to a reference .pt bundle")
    if fuse_upconv == "auto":
        fuse_upconv = False
    sd = load_torch_file(cp_path)["inference"]
    ncls_ckpt = int(sd["adain1.l1.weight"].shape[1])   # Linear is (out, in)
    if ncls_ckpt != num_classes:
        raise ValueError(
            f"checkpoint {cp_path} was trained with {ncls_ckpt} condition "
            f"classes but num_classes={num_classes} was requested — pass "
            f"num_classes={ncls_ckpt}")
    model = ConditionalUNet(num_classes=num_classes, dtype=dtype,
                            fuse_upconv=fuse_upconv)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def load_estimator(path: str, num_classes: int = 5,
                   dtype: torch.dtype = torch.float32, softmax: bool = False,
                   device: DeviceLike = None):
    """Load the frozen ResNet weather estimator/classifier from a state-dict
    ``.pt`` (torchvision ResNet names; ResNet-101 in the reference, the
    depth is read from the key names) onto ``device`` (CUDA unless given).
    Returns ``apply(images) -> (B, num_classes)`` for NHWC images in
    [-1, 1] (numpy or tensor): eval mode, running BN statistics, the plain
    module forward; with ``softmax`` the class probabilities.  The module
    itself is ``apply.model`` (``kernels.bottleneck.fused_resnet_eval`` takes
    it).

    The network is frozen (eval mode, no parameter requires a gradient), but
    ``apply`` is differentiable with respect to ``images``, as the JAX
    package's is: the GAN step's weather-consistency loss sends its gradient
    through ``apply(fake)`` into the generator.  Callers that want no graph
    run it under ``torch.no_grad()`` or ``torch.inference_mode()``.

    Only state dicts load.  The reference saves its estimators as
    whole-model pickles, which need torchvision to unpickle; convert such a
    file once where torchvision is installed."""
    device = resolve_device(device)
    if not path.endswith((".pt", ".pth")):
        raise ValueError(
            f"{path}: msgpack checkpoints are not yet supported by the "
            f"port; convert to a state-dict .pt")
    hint = (f"{path} is not a state dict. The port loads state-dict .pt "
            f"files only; a whole-model pickle (the reference's estimator "
            f"format) needs its defining package to unpickle. Convert it "
            f"once where torchvision is installed: torch.save(torch.load("
            f"path, weights_only=False).state_dict(), out_path)")
    try:
        sd = load_torch_file(path)
    except pickle.UnpicklingError as e:
        raise ValueError(hint) from e
    if isinstance(sd, dict):
        sd = strip_module_prefix(sd)
    if not isinstance(sd, dict) or "fc.weight" not in sd:
        raise ValueError(hint)
    ncls_ckpt = int(sd["fc.weight"].shape[0])
    if ncls_ckpt != num_classes:
        raise ValueError(
            f"checkpoint {path} has {ncls_ckpt} outputs but num_classes="
            f"{num_classes} was requested — pass num_classes={ncls_ckpt}")
    model = ResNet(_infer_block_counts(sd.keys(), "."), num_classes, dtype)
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval().requires_grad_(False)

    def apply(images):
        x = torch.as_tensor(images).to(device)
        out = model(x.permute(0, 3, 1, 2))
        return torch.softmax(out, dim=1) if softmax else out

    apply.model = model
    return apply
