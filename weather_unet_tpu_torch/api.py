"""High-level library API: load once, translate many.

    wt = WeatherTransfer.load("ckpt.pt")            # or msgpack; CUDA unless
                                                    # device= given
    out = wt.translate(images, conditions)          # NHWC [-1,1] -> [-1,1]
    u8o = wt.translate_u8(u8_images, conditions)    # uint8 wire fast path
    outs = wt.translate_to_classes(images)          # all one-hot classes
    frames = wt.sweep(images, estimator)            # demo-style theta sweep
    u8 = wt.to_uint8(out)                           # (x+1)*127.5 denorm

The public layout is the JAX package's: images NHWC (float in [-1, 1] or
uint8), conditions ``(B, num_classes)``; results are tensors on the model's
device.  The model itself runs NCHW.

With ``aot_cache`` (a directory or ``core.aot.AotCache``), ``translate``,
``translate_u8`` and ``translate_to_classes`` go through the AOT tier: one
program per input shape (bucketing keeps them to the power-of-two
batches), on a CUDA device the eager forward captured as a CUDA graph that
reads the model's weights where they lie (``core/aot.py``).  Nothing is
kept on disk: a restart captures again.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from weather_unet_tpu_torch._device import DeviceLike, resolve_device


class WeatherTransfer:
    """A conditional U-Net on one device with translation entry points."""

    def __init__(self, model, device: DeviceLike = None, aot_cache=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # preprocess() of every uint8 value, computed on the host: the device
        # path gathers from it, so both normalize bit-identically (a CUDA
        # division by a scalar multiplies by its reciprocal, which differs
        # from the host's division by 1 ulp on some values)
        self._u8_norm = self.preprocess(
            np.arange(256, dtype=np.uint8)).to(self.device)
        self.aot = None
        self._translate = self._fwd
        self._translate_u8 = self._fwd_u8
        self._translate_all = self._fwd_all
        if aot_cache is not None:
            self._tier(aot_cache)

    def _tier(self, aot_cache) -> None:
        """Route the three entry points through ``AotJit``: one program per
        input shape, a CUDA graph of the eager forward on the card."""
        from weather_unet_tpu_torch.core.aot import AotCache, AotJit

        self.aot = (aot_cache if isinstance(aot_cache, AotCache)
                    else AotCache(aot_cache))
        self._translate = AotJit(self._fwd, self.aot)
        self._translate_u8 = AotJit(self._fwd_u8, self.aot)
        self._translate_all = AotJit(self._fwd_all, self.aot)

    @classmethod
    def load(cls, cp_path: str, num_classes: int = 5,
             dtype: torch.dtype = torch.float32, fuse_upconv="auto",
             use_pallas="auto", device: DeviceLike = None, aot_cache=None):
        """Load from a reference ``.pt`` GAN bundle or a JAX-package msgpack
        checkpoint (``cli.common.load_transfer``).  ``use_pallas``: K1 + K2
        in the decoder, ``"auto"`` resolves to on; ``fuse_upconv``: the
        fused upsample+conv decoder kernel, ``"auto"`` resolves to off.
        ``aot_cache``: a directory (or ``AotCache``) for the AOT tier, each
        bucket a CUDA graph on the card."""
        from weather_unet_tpu_torch.cli.common import load_transfer

        device = resolve_device(device)
        model = load_transfer(cp_path, num_classes=num_classes, dtype=dtype,
                              fuse_upconv=fuse_upconv, use_pallas=use_pallas,
                              device=device)
        return cls(model, device, aot_cache=aot_cache)

    def _fwd(self, x, c):
        """NHWC in, NHWC out, on the device."""
        x = x.permute(0, 3, 1, 2).contiguous()
        return self.model(x, c).permute(0, 2, 3, 1)

    def _fwd_u8(self, x_u8, c):
        # normalize like preprocess() and denormalize like to_uint8(), but on
        # the device: the host<->device wire carries uint8 both ways
        y = self._fwd(self._u8_norm[x_u8.long()], c)
        return ((y.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)

    def translate(self, images, conditions, *, bucket: bool = True):
        """(B,H,W,3) in [-1,1] + (B,num_classes) conditions -> translated
        (B,H,W,3) in the model's dtype.  ``bucket=True`` pads the batch with
        zero rows up to the next power of two (rows are independent in eval;
        the JAX package does this to bound its compiled shapes, the port to
        keep the same batch sizes reaching the kernels)."""
        return self._bucketed(self._translate, images, conditions, bucket)

    def translate_u8(self, images_u8, conditions, *, bucket: bool = True):
        """uint8 NHWC in, uint8 NHWC out, with normalize/denormalize on the
        device: same formulas as ``to_uint8(translate(preprocess(u8)))``."""
        return self._bucketed(self._translate_u8, images_u8, conditions,
                              bucket)

    @torch.inference_mode()
    def _bucketed(self, fn, images, conditions, bucket):
        x = torch.as_tensor(images)
        c = torch.as_tensor(conditions)
        b = x.shape[0]
        nb = 1 << max(b - 1, 0).bit_length()
        if bucket and 0 < b < nb:
            # pads where the input lives: host inputs cross to the device once
            x = torch.cat([x, x.new_zeros((nb - b,) + x.shape[1:])])
            c = torch.cat([c, c.new_zeros((nb - b,) + c.shape[1:])])
        return fn(x.to(self.device), c.to(self.device))[:b]

    def _fwd_all(self, x):
        b, k = x.shape[0], self.model.num_classes
        c = torch.eye(k, device=self.device).repeat_interleave(b, dim=0)
        out = self._fwd(x.repeat(k, 1, 1, 1), c)
        return out.reshape(k, b, *out.shape[1:])

    @torch.inference_mode()
    def translate_to_classes(self, images):
        """All one-hot class translations: -> (num_classes, B, H, W, 3)."""
        return self._translate_all(torch.as_tensor(images).to(self.device))

    @torch.inference_mode()
    def sweep(self, images, estimate: Callable, num_frames: int = 10,
              alpha: float = 2.0):
        """demo theta sweep: (T, num_classes, B, H, W, 3) frames where axis
        k's condition is sin(theta)*alpha with estimator predictions
        elsewhere.  Each call runs on the model's current weights."""
        thetas = np.arange(-np.pi / 2, np.pi / 2 + np.pi / num_frames,
                           np.pi / (num_frames - 1)).astype(np.float32)
        x = torch.as_tensor(images).to(self.device)
        pred = torch.as_tensor(estimate(x)).to(self.device, torch.float32)
        b, k = x.shape[0], self.model.num_classes
        eye = torch.eye(k, device=self.device)
        xs = x.repeat(k, 1, 1, 1)
        frames = []
        for theta in torch.from_numpy(thetas):
            c = ((torch.sin(theta) * alpha * eye)[:, None, :]
                 + (1.0 - eye)[:, None, :] * pred[None])      # (K, B, K)
            out = self._fwd(xs, c.reshape(k * b, k))
            frames.append(out.reshape(k, b, *out.shape[1:]))
        return torch.stack(frames)

    @staticmethod
    def to_uint8(images) -> np.ndarray:
        """``(x + 1) * 127.5`` denormalization, clipped then truncated."""
        if isinstance(images, torch.Tensor):
            images = images.detach().float().cpu().numpy()
        return ((np.asarray(images) + 1.0) * 127.5).clip(0, 255).astype(
            np.uint8)

    @staticmethod
    def preprocess(images_u8):
        """uint8 -> normalized [-1,1] float32 on the host (the test
        transform, ``Normalize(0.5, 0.5)``)."""
        x = torch.as_tensor(images_u8).float() / 255.0
        return (x - 0.5) / 0.5
