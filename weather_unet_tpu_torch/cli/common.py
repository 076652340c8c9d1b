"""Shared CLI plumbing: checkpoint and estimator loading (reference ``.pt``
and JAX-package msgpack), image saving, image listing, the Flickr frame."""

from __future__ import annotations

import os
import pickle
from glob import glob
from typing import Optional, Sequence

import numpy as np
import torch

from weather_unet_tpu_torch._device import DeviceLike, resolve_device
from weather_unet_tpu_torch.compat.torch_io import (
    _infer_block_counts, cunet_state_dict_from_jax, load_torch_file,
    resnet_state_dict_from_jax, strip_module_prefix)
from weather_unet_tpu_torch.data.datasets import SIGNAL_COLUMNS, zscore_columns
from weather_unet_tpu_torch.models import ConditionalUNet, ResNet
from weather_unet_tpu_torch.train.checkpoint import restore_checkpoint


def _msgpack_params(cp_path: str) -> dict:
    """The cUNet params of a JAX-package msgpack checkpoint: the GAN
    layout's ``state['gen']['params']``, or a bare ``{'params'}`` tree."""
    state = restore_checkpoint(cp_path)
    if "gen" in state:
        return state["gen"]["params"]
    if "params" in state:
        return state["params"]
    raise ValueError(
        f"unrecognized checkpoint layout in {cp_path}: expected a "
        f"GanTrainState dict or a params tree")


def load_transfer(cp_path: str, num_classes: int = 5,
                  dtype: torch.dtype = torch.float32, fuse_upconv="auto",
                  use_pallas="auto",
                  device: DeviceLike = None) -> ConditionalUNet:
    """Load a cUNet from a reference ``.pt`` GAN bundle (``sd['inference']``)
    or a JAX-package flax msgpack checkpoint (GAN layout or bare params;
    read without flax) onto ``device`` (CUDA unless given), in eval mode.

    ``use_pallas`` runs the decoder's AdaINs through K1 and the upsamples
    after them through K2 (``kernels/adain.py``, ``kernels/upsample.py``);
    ``"auto"`` resolves to on: on an NVIDIA H100 the ``use_pallas`` forward
    took 8.52 ms against the plain one's 16.47 in bfloat16 and 12.79
    against 19.77 in float32 at 256x256, B=16, within 1e-5 MAE of it in
    float32 (``PERF.md`` §5).  On the CPU the kernels' wrappers run their
    plain versions.  ``fuse_upconv`` selects the fused upsample+conv
    decoder (K3, ``kernels/upconv.py``); ``"auto"`` resolves to off, as in
    the JAX package: it ran 1644 img/s against ``use_pallas``'s 1957 on the
    H100 (``ROADMAP.md`` follow-up b)."""
    device = resolve_device(device)
    if use_pallas == "auto":
        use_pallas = True
    if fuse_upconv == "auto":
        fuse_upconv = False
    if cp_path.endswith((".pt", ".pth")):
        sd = load_torch_file(cp_path)["inference"]
        ncls_ckpt = int(sd["adain1.l1.weight"].shape[1])  # Linear: (out, in)
    else:
        params = _msgpack_params(cp_path)
        # flax Dense kernel is (in, out); the proj's in-dim = num_classes
        ncls_ckpt = int(params["adain1"]["proj"]["kernel"].shape[0])
        sd = {k: torch.from_numpy(np.array(v)) for k, v in
              cunet_state_dict_from_jax({"params": params}).items()}
    if ncls_ckpt != num_classes:
        raise ValueError(
            f"checkpoint {cp_path} was trained with {ncls_ckpt} condition "
            f"classes but num_classes={num_classes} was requested (e.g. the "
            f"demo CLI's reference-parity default is 6) — pass "
            f"--num_classes {ncls_ckpt} (num_classes={ncls_ckpt})")
    model = ConditionalUNet(num_classes=num_classes, dtype=dtype,
                            use_pallas=bool(use_pallas),
                            fuse_upconv=fuse_upconv)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def _estimator_state_dict(path: str) -> dict:
    """The ResNet state dict of a state-dict ``.pt`` or of a JAX-package
    msgpack checkpoint (``params`` + ``batch_stats``)."""
    if not path.endswith((".pt", ".pth")):
        state = restore_checkpoint(path)
        if "params" not in state or "batch_stats" not in state:
            raise ValueError(f"{path}: a msgpack estimator checkpoint holds "
                             f"'params' and 'batch_stats'")
        return {k: torch.from_numpy(np.array(v)) for k, v in
                resnet_state_dict_from_jax(state).items()}
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
    return sd


def load_estimator(path: str, num_classes: int = 5,
                   dtype: torch.dtype = torch.float32, softmax: bool = False,
                   device: DeviceLike = None):
    """Load the frozen ResNet weather estimator/classifier from a state-dict
    ``.pt`` (torchvision ResNet names; ResNet-101 in the reference, the
    depth is read from the key names) or a JAX-package msgpack checkpoint
    (``params`` + ``batch_stats``, read without flax) onto ``device`` (CUDA
    unless given).  Returns ``apply(images) -> (B, num_classes)`` for NHWC
    images in [-1, 1] (numpy or tensor): eval mode, running BN statistics,
    the plain module forward; with ``softmax`` the class probabilities.
    The module itself is ``apply.model`` (``kernels.bottleneck.
    fused_resnet_eval`` takes it).

    The network is frozen (eval mode, no parameter requires a gradient), but
    ``apply`` is differentiable with respect to ``images``, as the JAX
    package's is: the GAN step's weather-consistency loss sends its gradient
    through ``apply(fake)`` into the generator.  Callers that want no graph
    run it under ``torch.no_grad()`` or ``torch.inference_mode()``.

    Of ``.pt`` files only state dicts load.  The reference saves its
    estimators as whole-model pickles, which need torchvision to unpickle;
    convert such a file once where torchvision is installed."""
    device = resolve_device(device)
    sd = _estimator_state_dict(path)
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
    step against 97-246 with 2076 fewer launches.  In float32 K4 runs its
    split-float32 tensor-core form, and the step took 146.5-150.2 ms by the
    K4 route against 174.3-183.5 by the module (two runs; ``PERF.md`` §5,
    NVIDIA H100 80GB HBM3, 700 W); whether float32 should default to K4 is
    left to a benchmark cell.

    Either route's ``model`` is the module: marked by
    ``parallel/spatial.py::spatial_``, it takes a shard's rows, and the K4
    route gathers the rows once for each stop-gradient forward, which runs
    whole (as the JAX package's partitioner runs a Pallas call it cannot
    split)."""
    device = resolve_device(device)
    if route is None:
        route = ("k4" if device.type == "cuda" and dtype == torch.bfloat16
                 else "plain")
    if route not in ("k4", "plain"):
        raise ValueError(f"route must be 'k4', 'plain' or None, not {route!r}")
    apply = load_estimator(path, num_classes, dtype, device=device)

    def plain(images):
        return apply(images.permute(0, 2, 3, 1))

    plain.model = apply.model
    if route == "plain":
        return plain
    from weather_unet_tpu_torch.kernels.bottleneck import fused_resnet_eval
    from weather_unet_tpu_torch.parallel import spatial

    fused = fused_resnet_eval(apply.model)

    def k4_routed(images):
        if torch.is_grad_enabled():
            return plain(images)
        group = spatial.group_of(apply.model)
        return fused(images if group is None else group.gather_rows(images))

    k4_routed.model = apply.model
    return k4_routed


def save_image(path: str, images, nrow: int = 8, normalize: bool = True):
    """torchvision ``save_image`` for NHWC arrays or tensors: one min-max
    over the whole tensor when ``normalize`` (what the reference's
    ``save_image(normalize=True)`` does, ``inf_transfer_c.py:119-121``),
    ``make_grid`` with 2-pixel padding, then ``x * 255 + 0.5`` truncated to
    uint8."""
    from PIL import Image

    from weather_unet_tpu_torch.train.metrics import make_grid

    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    images = np.asarray(images, dtype=np.float32)
    grid = make_grid(images, nrow=min(nrow, len(images)),
                     normalize=normalize, scale_each=False)
    Image.fromarray((grid * 255.0 + 0.5).clip(0, 255).astype(np.uint8)).save(
        path)


def denorm_tanh(images) -> np.ndarray:
    """``(res + 1) * 127.5`` uint8 denorm (``demo.py:80``)."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    return ((np.asarray(images) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)


def model_input(images_u8) -> torch.Tensor:
    """A uint8 NHWC batch (numpy, or a tensor on any device) through the
    test transform (``data.transforms.normalize_batch``: /255, then
    Normalize(0.5, 0.5)) as the float32 NHWC view in [-1, 1] that
    ``WeatherTransfer`` and ``load_estimator``'s apply take (its memory is
    NCHW, the layout both models run in)."""
    from weather_unet_tpu_torch.data.transforms import normalize_batch

    return normalize_batch(images_u8).permute(0, 2, 3, 1)


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
