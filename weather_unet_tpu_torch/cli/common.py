"""Shared CLI plumbing: checkpoint and estimator loading, image listing, the
Flickr frame."""

from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Optional, Sequence

import torch

from weather_unet_tpu_torch._device import DeviceLike, resolve_device
from weather_unet_tpu_torch.compat.torch_io import (
    _infer_block_counts, load_torch_file, strip_module_prefix)
from weather_unet_tpu_torch.data.datasets import SIGNAL_COLUMNS, zscore_columns
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


def load_step_estimator(path: str, num_classes: int = 5,
                        dtype: torch.dtype = torch.float32,
                        device: DeviceLike = None,
                        route: Optional[str] = None):
    """The frozen estimator as the GAN step takes it: ``apply(images NCHW)
    -> (B, num_classes)``, from ``load_estimator``'s module.

    Route ``"k4"``: the forwards that run without autograd (the step's
    stop-gradient conditions) go through ``fused_resnet_eval`` (K4), the
    forward whose gradient reaches G through the module; ``"plain"``: every
    forward through the module.  ``None`` picks K4 in bfloat16 on CUDA and
    the module otherwise: on an H100 in bf16 the K4 route took 82-164 ms a
    step against 97-246 with 2076 fewer launches, while in float32 K4's
    CUDA-core kernel adds 27-30 device ms and the step is no faster
    (``PERF.md`` §5, NVIDIA H100 80GB HBM3, 700 W)."""
    device = resolve_device(device)
    if route is None:
        route = ("k4" if device.type == "cuda" and dtype == torch.bfloat16
                 else "plain")
    if route not in ("k4", "plain"):
        raise ValueError(f"route must be 'k4', 'plain' or None, not {route!r}")
    apply = load_estimator(path, num_classes, dtype, device=device)

    def plain(images):
        return apply(images.permute(0, 2, 3, 1))

    if route == "plain":
        return plain
    from weather_unet_tpu_torch.kernels.bottleneck import fused_resnet_eval

    fused = fused_resnet_eval(apply.model)

    def k4_routed(images):
        return plain(images) if torch.is_grad_enabled() else fused(images)

    return k4_routed


def list_images(root: str) -> list:
    exts = (".jpg", ".jpeg", ".png")
    return sorted(p for p in glob(os.path.join(root, "*"))
                  if p.lower().endswith(exts))


def wrap_decode_cache(aug, cache_dir, base_size: int, paths):
    """``--decode_cache``: wrap a train augmentation so each source image is
    decoded once, at ``base_size``, into a memmap under ``cache_dir`` and
    only augmented every epoch (``data/cache.py``).  No-op when
    ``cache_dir`` is falsy."""
    if not cache_dir:
        return aug
    from weather_unet_tpu_torch.data.cache import CachedAugment, DecodedCache

    return CachedAugment(DecodedCache(cache_dir, base_size, paths), aug)


def load_flickr_frame(pkl_path: str, columns: Sequence[str] = SIGNAL_COLUMNS,
                      stats_pkl: Optional[str] = None):
    """Read a dataframe pickle and z-score the signal columns against
    ``stats_pkl`` (the reference's without-outlier frame,
    ``t_est_train.py:126-131``) or itself.  Returns (df, mean, std)."""
    import pandas as pd

    df = pd.read_pickle(pkl_path)
    stats_df = pd.read_pickle(stats_pkl) if stats_pkl else None
    return zscore_columns(df, columns, stats_df=stats_df)
