"""Fréchet Inception Distance -- the port of
``weather_unet_tpu/evaluation/fid.py`` (reference ``eval/fid_score.py``).

Batched Inception-v3 pool3 activations on the device
(``models/inception_fid.py``), mean and covariance on the host, and the
matrix-square-root Fréchet distance with scipy's ``sqrtm`` and the
reference's eps-jitter fallback for a singular product.  Paths are image
directories or precomputed ``.npz`` statistics, as in the reference CLI.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from weather_unet_tpu_torch._device import DeviceLike, resolve_device


def get_activations(images_iter, feature_fn) -> np.ndarray:
    """Run batches of [0, 1] float NHWC images through ``feature_fn`` and
    collect the pool3 activations on the host."""
    return np.concatenate([np.asarray(feature_fn(b)) for b in images_iter],
                          axis=0)


def compute_statistics(activations: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of the activation set (``fid_score.py:195-217``)."""
    return np.mean(activations, axis=0), np.cov(activations, rowvar=False)


def _sqrtm(m):
    from scipy import linalg

    try:
        out = linalg.sqrtm(m, disp=False)
    except TypeError:   # scipy >= 1.17 dropped disp/errest
        out = linalg.sqrtm(m)
    return out[0] if isinstance(out, tuple) else out


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with the
    reference's jitter fallback for a singular product
    (``fid_score.py:138-192``)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_activations(act1: np.ndarray, act2: np.ndarray) -> float:
    mu1, s1 = compute_statistics(act1)
    mu2, s2 = compute_statistics(act2)
    return frechet_distance(mu1, s1, mu2, s2)


def _image_batches(files, batch_size: int, size: Optional[int] = None):
    """Yield [0, 1] float32 NHWC batches from image files (the reference
    reads with imread / 255, ``fid_score.py:105-118``); ``size`` resizes
    each image first (Pillow, bilinear)."""
    from PIL import Image

    for i in range(0, len(files), batch_size):
        imgs = []
        for f in files[i:i + batch_size]:
            with Image.open(f) as im:
                im = im.convert("RGB")
                if size is not None:
                    im = im.resize((size, size), Image.BILINEAR)
                imgs.append(np.asarray(im, dtype=np.float32) / 255.0)
        yield np.stack(imgs)


def statistics_of_path(path: str, feature_fn, batch_size: int = 50,
                       size: Optional[int] = None):
    """Statistics of a directory of jpg/png, or a precomputed ``.npz`` with
    ``mu`` / ``sigma`` (``fid_score.py:220-231``)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    from weather_unet_tpu_torch.cli.common import list_images

    files = list_images(path)
    if not files:
        raise RuntimeError(f"no images found under {path}")
    return compute_statistics(get_activations(
        _image_batches(files, batch_size, size), feature_fn))


# First 8 hex digits of the canonical TF-ported FID checkpoint's sha256,
# from the torch-hub name of its download
# (pt_inception-2015-12-05-6726825d.pth, reference eval/inception.py:13).
FID_WEIGHTS_SHA256_PREFIX = "6726825d"

#: Offline conversion, on any host with network and torch: ``python -c
#: "import torch; sd = torch.hub.load_state_dict_from_url('https://github.
#: com/mseitzer/pytorch-fid/releases/download/fid_weights/pt_inception-
#: 2015-12-05-6726825d.pth'); torch.save(sd, 'pt_inception.pth')"``, then
#: pass the file with ``--weights`` (an untouched download keeps the
#: certified sha256).


def fingerprint_weights_file(path: str) -> str:
    """sha256 of the checkpoint file (hex)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_fid_weights(sd, model, *, path: Optional[str] = None) -> str:
    """Check an Inception state dict against ``model``'s architecture.

    Structure: every tensor the model defines must be present with its exact
    name and shape, and no other (torchvision's ``AuxLogits`` and
    ``num_batches_tracked`` aside; the ``fc`` head is ignored when the model
    has none, since converted checkpoints keep it for the Inception Score
    and its width differs by family).  Content: a file whose sha256 matches
    the canonical TF-ported checkpoint is ``'certified'``; anything else
    that passes the structural check is ``'converted'``.  Raises ValueError
    on any structural mismatch.
    """
    def tensors(d):
        return {k: tuple(v.shape) for k, v in d.items()
                if not k.startswith("AuxLogits.")
                and not k.endswith("num_batches_tracked")}

    expected = tensors(model.state_dict())
    got = tensors(sd)
    if not any(k.startswith("fc.") for k in expected):
        got = {k: v for k, v in got.items() if not k.startswith("fc.")}
    missing, extra = set(expected) - set(got), set(got) - set(expected)
    if missing or extra:
        raise ValueError(
            f"FID weights do not match the InceptionV3FID architecture: "
            f"{len(missing)} missing / {len(extra)} unexpected tensors "
            f"(e.g. {sorted(missing | extra)[:3]})")
    bad = sorted(k for k, shape in got.items() if shape != expected[k])
    if bad:
        raise ValueError(f"FID weight shape mismatch for {bad[:5]} "
                         f"({len(bad)} tensors total)")
    if path and fingerprint_weights_file(path).startswith(
            FID_WEIGHTS_SHA256_PREFIX):
        return "certified"
    return "converted"


def make_feature_fn(weights_path: Optional[str] = None, dtype=None, *,
                    allow_random: bool = False, device: DeviceLike = None):
    """A pool3 feature extractor on ``device`` (CUDA unless given): [0, 1]
    float NHWC numpy batches -> (B, 2048) float32 numpy.

    ``weights_path`` is a local copy of the TF-ported FID checkpoint; it is
    checked structurally (and sha256-certified when it is the canonical
    download) before use.  Without weights this refuses unless
    ``allow_random``: random-weight FID values look plausible and mean
    nothing against published ones.  Random weights are seeded (0)."""
    from weather_unet_tpu_torch.compat.torch_io import (
        inception_state_dict, load_torch_file)
    from weather_unet_tpu_torch.models.inception_fid import InceptionV3FID

    dev = resolve_device(device)
    dtype = dtype or torch.float32
    if weights_path:
        model = InceptionV3FID(dtype=dtype)
        sd = load_torch_file(weights_path)
        trust = verify_fid_weights(sd, model, path=weights_path)
        model.load_state_dict(inception_state_dict(sd, with_logits=False))
        print(f"FID inception weights: {trust} ({weights_path})")
    elif allow_random:
        model = InceptionV3FID(dtype=dtype,
                               generator=torch.Generator().manual_seed(0))
        print("WARNING: FID inception running with RANDOM weights "
              "(--allow-random-weights); distances are not comparable to "
              "published FID numbers")
    else:
        raise RuntimeError(
            "No FID inception weights provided. Pass a local TF-ported "
            "pt_inception .pth (see the offline-conversion note in "
            "weather_unet_tpu_torch/evaluation/fid.py), or pass "
            "allow_random=True / --allow-random-weights to proceed with "
            "meaningless random-init features.")
    model = model.to(dev).eval()

    @torch.inference_mode()
    def feature_fn(images):
        x = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
        return model(x.permute(0, 3, 1, 2).contiguous()).float().cpu().numpy()

    return feature_fn
