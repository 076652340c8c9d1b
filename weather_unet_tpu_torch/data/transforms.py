"""Train augmentation and device-side normalization -- the port of
``weather_unet_tpu/data/transforms.py``.

Three ways to augment a training image, as in the JAX package:

* ``HostAugment``: the reference's CPU transform stack
  (``t_cls_train.py:81-102``: RandomRotation(10) -> RandomResizedCrop |
  Resize -> RandomHorizontalFlip -> optional ColorJitter) in Pillow, run in
  the ``BatchLoader`` threads;
* ``NativeAugment``: its C++ twin (``runtime/augment.cc``), one composed
  inverse-affine resample and the jitter in one call that releases the
  GIL, fused with the libjpeg decode where the runtime has it;
* ``augment_batch``: the same affine and jitter on the device, batched, from
  a ``torch.Generator`` on the images' device (``AugmentConfig``).

Each image of a loader transform draws from its own keyed RNG stream.
``normalize_batch`` turns a uint8 NHWC batch into the step's float NCHW
input in [-1, 1] on the device.

Distributional notes (as the JAX package's): the affine paths sample the
crop's scale and log-ratio once and clamp the box to the image
(torchvision rejection-samples 10 times, then center-crops), compose
rotation, crop and flip into one resample without antialiasing, and apply
the jitter in the fixed order brightness -> contrast -> saturation
(torchvision shuffles it).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import math
import os
import threading
from typing import Optional

import numpy as np
import torch

from weather_unet_tpu_torch.ops.resize import resize_bilinear_torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The train augmentation's parameters (the reference's train stacks,
    ``t_est_train.py:76-103``); the ``--augmentation`` branch sets
    ``resized_crop`` and the jitters 0.5 / 0.3 / 0.3."""

    out_size: int = 224
    degrees: float = 10.0          # RandomRotation(10)
    hflip: bool = True
    resized_crop: bool = False
    crop_scale: tuple = (0.08, 1.0)
    crop_ratio: tuple = (3.0 / 4.0, 4.0 / 3.0)
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    mean: float = 0.5
    std: float = 0.5


def affine_from_uniforms(u: torch.Tensor, in_h: int, in_w: int,
                         cfg: AugmentConfig) -> torch.Tensor:
    """Inverse affine maps, output pixel -> source pixel, from uniform draws
    ``u[..., :] = [rot, scale, log-ratio, pos-x, pos-y, flip]`` in [0, 1):
    (resize from the crop box) o (rotation about the center) o (optional
    hflip), as float32 ``(..., 2, 3)`` rows mapping ``(x, y, 1)``.

    The JAX package's formula (and ``runtime/augment.cc``'s), evaluated in
    float64 and rounded once, so the card and the CPU give the same
    matrices: in float32 their ``sin``/``exp`` and their divisions can
    differ by an ulp, which moves a coordinate near 256 by 3e-5.  JAX's
    float32 matrices are within an ulp of these."""
    u = u.to(torch.float64)
    if cfg.resized_crop:
        area = float(in_h * in_w)
        scale = cfg.crop_scale[0] + u[..., 1] * (cfg.crop_scale[1]
                                                 - cfg.crop_scale[0])
        lo, hi = math.log(cfg.crop_ratio[0]), math.log(cfg.crop_ratio[1])
        ratio = torch.exp(lo + u[..., 2] * (hi - lo))
        cw = torch.sqrt(area * scale * ratio).clamp(1.0, float(in_w))
        ch = torch.sqrt(area * scale / ratio).clamp(1.0, float(in_h))
        cx0 = u[..., 3] * (in_w - cw)
        cy0 = u[..., 4] * (in_h - ch)
    else:
        cw, ch = float(in_w), float(in_h)
        cx0 = cy0 = 0.0
    sx = cw / cfg.out_size
    sy = ch / cfg.out_size
    t = (-cfg.degrees + u[..., 0] * (2.0 * cfg.degrees)) * (math.pi / 180.0)
    cos, sin = torch.cos(t), torch.sin(t)
    cx, cy = (in_w - 1) / 2.0, (in_h - 1) / 2.0
    flip = (u[..., 5] < 0.5) & cfg.hflip
    one = torch.ones_like(t)
    fsign = torch.where(flip, -one, one)
    foff = torch.where(flip, (cfg.out_size - 1.0) * one, 0.0 * one)
    rows = (cos * fsign * sx, -sin * sy,
            cos * (foff * sx + cx0 - cx) - sin * (cy0 - cy) + cx,
            sin * fsign * sx, cos * sy,
            sin * (foff * sx + cx0 - cx) + cos * (cy0 - cy) + cy)
    rows = torch.broadcast_tensors(*rows)
    return torch.stack(rows, -1).unflatten(-1, (2, 3)).to(torch.float32)


def _affine_sample(images_u8: torch.Tensor, mats: torch.Tensor,
                   out_size: int) -> torch.Tensor:
    """Bilinear samples of uint8 NHWC ``images_u8`` at ``mats[n] @ (x, y,
    1)`` for every output pixel, zero outside the image: float32 NHWC in
    [0, 1].  The JAX package's 4-tap gather (clamped indices times the
    in-bounds mask), not ``grid_sample``, whose normalized coordinates and
    padding differ.

    The source coordinates are elementwise products and sums, not a matmul,
    so the card and the CPU round them alike: ``(a * x + b * y) + c`` in
    float32, which is how the JAX package's batched dot rounds them under
    ``augment_batch``'s ``vmap``."""
    n, h, w, c = images_u8.shape
    r = torch.arange(out_size, dtype=torch.float32, device=images_u8.device)
    xs, ys = r.view(1, 1, -1), r.view(1, -1, 1)
    m = mats.to(torch.float32).reshape(n, 6, 1, 1).unbind(1)
    sx = (m[0] * xs + m[1] * ys) + m[2]                      # (N, O, O)
    sy = (m[3] * xs + m[4] * ys) + m[5]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = images_u8.reshape(n, h * w, c)

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = torch.gather(flat, 1, idx.reshape(n, -1, 1).expand(-1, -1, c))
        vals = vals.reshape(n, out_size, out_size, c).to(torch.float32)
        return (vals / 255.0) * inb[..., None]

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _luma(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma of NHWC RGB, torchvision's ``rgb_to_grayscale``."""
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _color_jitter(img: torch.Tensor, factors: torch.Tensor,
                  cfg: AugmentConfig) -> torch.Tensor:
    """ColorJitter on float NHWC in [0, 1] with per-image ``factors[:, 0:3]``
    (brightness, contrast, saturation), each applied where ``cfg`` enables
    it, in that order; the contrast mean is taken of the brightened
    image."""
    f = factors.to(torch.float32).reshape(-1, 3, 1, 1, 1).unbind(1)
    if cfg.brightness:
        img = img * f[0]
    if cfg.contrast:
        gray_mean = _luma(img).mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
        img = f[1] * img + (1 - f[1]) * gray_mean
    if cfg.saturation:
        img = f[2] * img + (1 - f[2]) * _luma(img)[..., None]
    return img.clamp(0.0, 1.0)


def _jitter_ranges(cfg: AugmentConfig):
    """ColorJitter's factor ranges U(max(0, 1 - j), 1 + j)."""
    js = (cfg.brightness, cfg.contrast, cfg.saturation)
    return [max(0.0, 1 - j) for j in js], [1 + j for j in js]


def draw_uniforms(generator: torch.Generator, n: int, cfg: AugmentConfig):
    """Per-image draws on the generator's device: the six affine uniforms
    ``(n, 6)`` in [0, 1) and the three jitter factors ``(n, 3)`` in their
    ColorJitter ranges (drawn whether or not ``cfg`` enables a jitter)."""
    dev = generator.device
    u = torch.rand((n, 6), generator=generator, device=dev)
    r = torch.rand((n, 3), generator=generator, device=dev)
    lo, hi = (torch.tensor(v, device=dev) for v in _jitter_ranges(cfg))
    return u, lo + (hi - lo) * r


def augment_from_uniforms(images_u8: torch.Tensor, u: torch.Tensor,
                          factors: torch.Tensor,
                          cfg: AugmentConfig) -> torch.Tensor:
    """The deterministic core of ``augment_batch``: uint8 NHWC -> affine
    resample -> jitter -> Normalize(mean, std), as contiguous float32 NCHW
    (the port's step input, like ``normalize_batch``)."""
    _, h, w, _ = images_u8.shape
    mats = affine_from_uniforms(u, h, w, cfg)
    out = _color_jitter(_affine_sample(images_u8, mats, cfg.out_size),
                        factors, cfg)
    out = (out - cfg.mean) / cfg.std
    return out.permute(0, 3, 1, 2).contiguous()


def augment_batch(generator: torch.Generator, images_u8,
                  cfg: AugmentConfig) -> torch.Tensor:
    """uint8 NHWC batch -> augmented, normalized float32 NCHW in [-1, 1], on
    the generator's device, with fresh draws from ``generator`` (the JAX
    package's threefry draws are not reproduced; the core given the draws
    is, ``augment_from_uniforms``)."""
    x = torch.as_tensor(images_u8, device=generator.device)
    u, factors = draw_uniforms(generator, x.shape[0], cfg)
    return augment_from_uniforms(x, u, factors, cfg)

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

    route = "Pillow"

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


class NativeAugment(_KeyedRngMixin):
    """The C++ twin of the device augment (``runtime/augment.cc``): one
    composed affine resample (rotation o resized crop o hflip) and the
    jitter in one call that releases the GIL, so the loader threads run in
    parallel.  Same affine (``affine_from_uniforms``) and jitter formulas as
    ``augment_batch``; the deviations from torchvision are the module
    docstring's.  RNG streams: see :class:`_KeyedRngMixin`; the drawn
    uniforms parameterize the C affine, so runs are deterministic.

    ``from_path`` decodes and augments a JPEG.  With a libjpeg runtime that
    is one fused call, which decodes at the smallest M/8 DCT scale keeping
    twice the output size (``jpeg_loader.cc:103-112``).  Where the runtime
    has no decode (a host without libjpeg), Pillow decodes the file at full
    size and the native ``augment_u8`` runs on that: Pillow cannot scale by
    M/8 (its ``draft`` scales by 1/2^k), so where the libjpeg route would
    downscale, this route's pixels differ from it.  ``route`` names the
    path taken.  ``runtime`` defaults to ``runtime.load()``; without a
    buildable runtime the constructor raises with the compiler's output.
    """

    def __init__(self, out_size: int, *, degrees: float = 10.0,
                 hflip: bool = True, resized_crop: bool = False,
                 crop_scale=(0.08, 1.0), crop_ratio=(3.0 / 4.0, 4.0 / 3.0),
                 brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, seed: int = 0, runtime=None):
        from weather_unet_tpu_torch import runtime as native

        if runtime is None:
            runtime = native.load()
        if runtime is None:
            raise RuntimeError("the native augment runtime could not be "
                               f"built:\n{native.build_error()}")
        self._runtime = runtime
        self.route = ("native (libjpeg decode)" if runtime.decode_available()
                      else "native (Pillow decode)")
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

    def _draw(self, rng):
        """(uniforms[6], jitter factors[3]); a factor of -1 disables its
        jitter."""
        u = rng.random(6).astype(np.float32)
        fs = [rng.uniform(max(0.0, 1 - j), 1 + j) if j else -1.0
              for j in (self.brightness, self.contrast, self.saturation)]
        return u, np.asarray(fs, dtype=np.float32)

    def _cfg_kwargs(self):
        return dict(degrees=self.degrees, resized_crop=self.resized_crop,
                    crop_scale=self.crop_scale, crop_ratio=self.crop_ratio,
                    hflip=self.hflip, out_size=self.out_size)

    def from_path(self, path: str):
        """Decode and augment on the keyed stream; raises OSError on a bad
        file, so the datasets' skip-on-corrupt retry engages."""
        u, jit = self._draw(self._rng_keyed(path))
        if self._runtime.decode_available():
            out = self._runtime.decode_augment_file(path, u, jit,
                                                    **self._cfg_kwargs())
            if out is None:
                raise OSError(f"native decode failed for {path}")
            return out
        from weather_unet_tpu_torch.data.datasets import _decode

        return self._augment_arr(_decode(path, None, prefer_native=False),
                                 u, jit)

    def __call__(self, image_u8):
        """Augment a decoded uint8 HWC image (counter stream)."""
        return self._augment_arr(image_u8, *self._draw(self._rng()))

    def augment_keyed(self, image_u8, path: str):
        """Augment a decoded image on the keyed stream (the decode cache's
        and the non-JPEG ``_load`` paths)."""
        return self._augment_arr(image_u8, *self._draw(self._rng_keyed(path)))

    def _augment_arr(self, image_u8, u, jit):
        h, w = image_u8.shape[:2]
        mat = self._runtime.make_affine(h, w, u, **self._cfg_kwargs())
        return self._runtime.augment_u8(image_u8, mat, jit, self.out_size)


def fork_stream(transform, offset: int = 1):
    """A copy of a keyed train transform on an independent stream (``seed +
    offset``).  The GAN trainers zip two loaders over one dataset; with one
    shared transform a path in flight in both races for the per-path draw
    counter ``k``, and the stream->image assignment depends on scheduling
    again.  The second loader gets a dataset view
    (``datasets.with_transform``) carrying this copy; a decode-cache wrapper
    is re-wrapped around the same cache.  Other transforms (None, a plain
    callable) are returned as they are."""
    from weather_unet_tpu_torch.data.cache import CachedAugment

    if isinstance(transform, CachedAugment):
        return CachedAugment(transform.cache,
                             fork_stream(transform.augment, offset))
    if isinstance(transform, _KeyedRngMixin):
        t = copy.copy(transform)
        t._rng_init(transform.seed + offset)
        return t
    return transform


def make_train_augment(out_size: int, *, resized_crop: bool = False,
                       brightness: float = 0.0, contrast: float = 0.0,
                       saturation: float = 0.0, seed: int = 0,
                       prefer_native: Optional[bool] = None):
    """The loader-thread train augmentation: ``NativeAugment`` or Pillow's
    ``HostAugment``.  ``prefer_native=None`` picks the native one where the
    runtime builds, unless ``WUT_NATIVE_AUGMENT=0``, as the JAX package
    does; True requires it (raising with the compiler's output where it
    cannot be built); False picks Pillow.  The result's ``route`` says which
    path was taken."""
    from weather_unet_tpu_torch import runtime

    if prefer_native is None:
        prefer_native = (os.environ.get("WUT_NATIVE_AUGMENT", "1") != "0"
                         and runtime.augment_available())
    kw = dict(resized_crop=resized_crop, brightness=brightness,
              contrast=contrast, saturation=saturation, seed=seed)
    if prefer_native:
        return NativeAugment(out_size, **kw)
    return HostAugment(out_size, **kw)


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
