"""Loader-thread augmentation and device-side normalization -- the port of
``weather_unet_tpu/data/transforms.py``.

``HostAugment`` is the reference's CPU transform stack
(``t_cls_train.py:81-102``: RandomRotation(10) -> RandomResizedCrop |
Resize -> RandomHorizontalFlip -> optional ColorJitter) in Pillow, run in
the ``BatchLoader`` threads, each image on its own keyed RNG stream.
``normalize_batch`` turns a uint8 NHWC batch into the step's float NCHW
input in [-1, 1] on the device.

Not ported yet: the native C++ augment (``NativeAugment``) and the fully
on-device warp (``AugmentConfig`` / ``augment_batch``); ``ROADMAP.md`` lists
both.
"""

from __future__ import annotations

import copy
import hashlib
import math
import threading
from typing import Optional

import numpy as np
import torch

from weather_unet_tpu_torch.ops.resize import resize_bilinear_torch


class _KeyedRngMixin:
    """Per-sample RNG streams for loader-thread transforms.

    Bare ``__call__`` draws come from a lock-guarded ``(seed, counter)``
    stream: thread-safe, but with several loader threads which image gets
    which draw depends on scheduling.  The datasets' ``_load`` therefore
    uses the keyed path (``augment_keyed``): stream ``(seed, epoch,
    blake2b-128(path), k)``, ``k`` counting earlier draws of that path this
    epoch.  Sampling without replacement (the shuffle default) is then fully
    independent of scheduling, across runs and resumes; under a
    with-replacement sampler the epoch's multiset of (image, augmentation)
    is.  ``BatchLoader.set_epoch`` reaches here through the dataset's
    transform.
    """

    def _rng_init(self, seed: int):
        self.seed = seed
        self._lock = threading.Lock()
        self._counter = 0
        self._epoch = 0
        self._path_counts = {}

    def set_epoch(self, epoch: int):
        with self._lock:
            self._epoch = int(epoch)
            self._path_counts.clear()

    def _rng(self):
        with self._lock:
            self._counter += 1
            n = self._counter
        return np.random.default_rng((self.seed, n))

    def _rng_keyed(self, path: str):
        with self._lock:
            k = self._path_counts.get(path, 0)
            self._path_counts[path] = k + 1
            e = self._epoch
        # a 128-bit path hash: a 32-bit one gives about one colliding pair
        # in a 100k-image corpus, whose augmentations would be correlated
        h = int.from_bytes(hashlib.blake2b(
            path.encode("utf-8", "replace"), digest_size=16).digest(),
            "little")
        return np.random.default_rng((self.seed, e, h, k))


class HostAugment(_KeyedRngMixin):
    """Reference CPU augmentation (``t_cls_train.py:81-102``) in Pillow, for
    the loader threads.  RNG streams: see :class:`_KeyedRngMixin`."""

    def __init__(self, out_size: int, *, degrees: float = 10.0,
                 hflip: bool = True, resized_crop: bool = False,
                 crop_scale=(0.08, 1.0), crop_ratio=(3.0 / 4.0, 4.0 / 3.0),
                 brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, seed: int = 0):
        self.out_size = out_size
        self.degrees = degrees
        self.hflip = hflip
        self.resized_crop = resized_crop
        self.crop_scale = crop_scale
        self.crop_ratio = crop_ratio
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self._rng_init(seed)

    def _sample_crop(self, rng, w, h):
        """torchvision ``RandomResizedCrop.get_params``: 10 rejection
        attempts, then the center-crop fallback."""
        area = w * h
        for _ in range(10):
            target = area * rng.uniform(*self.crop_scale)
            ar = math.exp(rng.uniform(math.log(self.crop_ratio[0]),
                                      math.log(self.crop_ratio[1])))
            cw = int(round(math.sqrt(target * ar)))
            ch = int(round(math.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = int(rng.integers(0, w - cw + 1))
                y0 = int(rng.integers(0, h - ch + 1))
                return x0, y0, cw, ch
        in_ratio = w / h
        if in_ratio < self.crop_ratio[0]:
            cw, ch = w, int(round(w / self.crop_ratio[0]))
        elif in_ratio > self.crop_ratio[1]:
            cw, ch = int(round(h * self.crop_ratio[1])), h
        else:
            cw, ch = w, h
        return (w - cw) // 2, (h - ch) // 2, cw, ch

    def __call__(self, image_u8):
        """uint8 HWC -> augmented uint8 HWC at ``out_size`` (counter
        stream)."""
        return self._apply(image_u8, self._rng())

    def augment_keyed(self, image_u8, path: str):
        """The same on the ``(seed, epoch, path, k)`` stream; the datasets'
        ``_load`` calls this."""
        return self._apply(image_u8, self._rng_keyed(path))

    def _apply(self, image_u8, rng):
        from PIL import Image, ImageEnhance

        im = Image.fromarray(image_u8)
        if self.degrees:
            angle = rng.uniform(-self.degrees, self.degrees)
            im = im.rotate(angle, resample=Image.BILINEAR)
        if self.resized_crop:
            x0, y0, cw, ch = self._sample_crop(rng, im.width, im.height)
            im = im.resize((self.out_size, self.out_size), Image.BILINEAR,
                           box=(x0, y0, x0 + cw, y0 + ch))
        elif im.size != (self.out_size, self.out_size):
            im = im.resize((self.out_size, self.out_size), Image.BILINEAR)
        if self.hflip and rng.random() < 0.5:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        jitters = []
        if self.brightness:
            f = rng.uniform(max(0.0, 1 - self.brightness),
                            1 + self.brightness)
            jitters.append(
                lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast:
            f = rng.uniform(max(0.0, 1 - self.contrast), 1 + self.contrast)
            jitters.append(
                lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
        if self.saturation:
            f = rng.uniform(max(0.0, 1 - self.saturation),
                            1 + self.saturation)
            jitters.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
        rng.shuffle(jitters)        # torchvision shuffles the jitter order
        for j in jitters:
            im = j(im)
        return np.asarray(im, dtype=np.uint8)


def fork_stream(transform, offset: int = 1):
    """A copy of a keyed train transform on an independent stream (``seed +
    offset``).  The GAN trainers zip two loaders over one dataset; with one
    shared transform a path in flight in both races for the per-path draw
    counter ``k``, and the stream->image assignment depends on scheduling
    again.  The second loader gets a dataset view
    (``datasets.with_transform``) carrying this copy.  Other transforms
    (None, a plain callable) are returned as they are."""
    if isinstance(transform, _KeyedRngMixin):
        t = copy.copy(transform)
        t._rng_init(transform.seed + offset)
        return t
    return transform


def make_train_augment(out_size: int, *, resized_crop: bool = False,
                       brightness: float = 0.0, contrast: float = 0.0,
                       saturation: float = 0.0, seed: int = 0,
                       prefer_native: Optional[bool] = None):
    """The train augmentation: ``HostAugment``.  The JAX package picks its
    native C++ twin when that runtime is built; it is not ported, so
    ``prefer_native=True`` raises and ``None`` means Pillow."""
    if prefer_native:
        raise NotImplementedError(
            "the native augment runtime is not ported yet (ROADMAP.md queue "
            "1, the native runtime item)")
    return HostAugment(out_size, resized_crop=resized_crop,
                       brightness=brightness, contrast=contrast,
                       saturation=saturation, seed=seed)


def normalize_batch(images_u8, out_size: Optional[int] = None,
                    mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """Test-path transform on the device (``t_est_train.py:99-103``): uint8
    NHWC (a tensor, or numpy for the CPU) -> contiguous float32 NCHW,
    optionally resized to ``out_size`` (bilinear, align_corners=True, as the
    JAX package's ``resize_bilinear_torch`` default), then Normalize(0.5,
    0.5).  Float32 whatever the step's compute dtype, as the JAX trainer
    feeds its step: the networks cast on entry, the losses compare with
    these images."""
    x = torch.as_tensor(images_u8).permute(0, 3, 1, 2).contiguous()
    x = x.to(torch.float32) / 255.0
    if out_size is not None and x.shape[2] != out_size:
        x = resize_bilinear_torch(x, out_size, out_size)
    return (x - mean) / std
