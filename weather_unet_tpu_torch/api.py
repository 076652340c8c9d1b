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

With ``plan`` (``parallel/mesh.py::make_mesh``) the model is replicated
once on each of the plan's local devices, each bucketed batch is split
evenly over the replicas (padded as the buckets are) and their results
are concatenated in order on the first device; each replica runs K1 and K2
under ``use_pallas``.  The cUNet has no coupling between samples in eval
mode, so no collective runs.  With ``tensor_parallel`` the plan's devices
form data rows of ``model`` devices: each row holds one shard of the
model on each of its devices (``parallel/tp.py``, every double conv split
Megatron-style), takes an equal share of the rows, and runs its shards in
threads of their own that sum each pair's partial outputs in host order;
every shard runs the replicated layers, K1 and K2 among them.  A plan may
name one card several times.

With ``aot_cache`` (a directory or ``core.aot.AotCache``), ``translate``,
``translate_u8`` and ``translate_to_classes`` go through the AOT tier: one
program per input shape (bucketing keeps them to the power-of-two
batches), on a CUDA device the eager forward captured as a CUDA graph that
reads the model's weights where they lie (``core/aot.py``).  Nothing is
kept on disk: a restart captures again.  With ``tensor_parallel`` each
shape's program is the eager split forward, the tier's CPU form (a CUDA
graph cannot hold the shards' threads meeting in host memory): the tier
counts its programs and captures none, and the results are the untiered
split's bit for bit, as the JAX package serves its split forwards
through its tier.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable

import numpy as np
import torch

from weather_unet_tpu_torch._device import DeviceLike, resolve_device


class WeatherTransfer:
    """A conditional U-Net with translation entry points, on one device or,
    with ``plan``, replicated on each of the plan's local devices
    (``self.model`` and ``self.device`` are the first replica's), or with
    ``tensor_parallel`` split over each data row of them (``self.model`` is
    then the first row's shard 0)."""

    def __init__(self, model, device: DeviceLike = None, aot_cache=None,
                 plan=None, tensor_parallel: bool = False):
        from weather_unet_tpu_torch.parallel.mesh import require_model_axis

        self.plan = plan
        if tensor_parallel:
            require_model_axis(plan, "a MeshPlan")
        if plan is None:
            devices = [resolve_device(device)]
        else:
            if getattr(model, "fuse_levels", ()):
                raise ValueError(
                    "fuse_upconv serving is single-device; rebuild the model "
                    "with fuse_upconv=False when passing a MeshPlan")
            devices = list(plan.devices)
        self.tensor_parallel = tensor_parallel
        # the devices by data row; a row is one replica, or one shard each
        rows = plan.rows() if tensor_parallel else [[d] for d in devices]
        self.device = devices[0]
        self._devices = devices
        self._row_devices = [r[0] for r in rows]
        self.model = model.to(self.device).eval()
        whole = copy.deepcopy(self.model) if tensor_parallel else None
        self._replicas = [self.model] + [
            copy.deepcopy(whole if tensor_parallel else self.model).to(
                d).eval() for d in devices[1:]]
        self._groups = []
        if tensor_parallel:
            from weather_unet_tpu_torch.parallel import tp

            specs = tp.tp_specs(whole, plan.n_model)
            tp.require_split([specs], plan.n_model)
            for r, row in enumerate(rows):
                group = tp.ThreadShards(row)
                for j in range(len(row)):
                    tp.shard_(self._replicas[r * len(row) + j], group,
                              specs, index=j)
                self._groups.append(group)
            del whole
        # preprocess() of every uint8 value, computed on the host: the device
        # path gathers from it, so both normalize bit-identically (a CUDA
        # division by a scalar multiplies by its reciprocal, which differs
        # from the host's division by 1 ulp on some values)
        table = self.preprocess(np.arange(256, dtype=np.uint8))
        self._u8_norm = [table.to(d) for d in devices]
        self.aot = None
        # each entry point's program on each data row
        self._fns = {name: [functools.partial(self._row, i, fn)
                            for i in range(len(rows))]
                     for name, fn in (("translate", self._fwd),
                                      ("translate_u8", self._fwd_u8),
                                      ("translate_all", self._fwd_all))}
        if aot_cache is not None:
            self._tier(aot_cache)

    def _row(self, i, fn, *args):
        """``fn(j, *args)`` for data row ``i``: on its replica ``j = i``, or
        on each of its shards ``j`` at once (each given the inputs on its
        device), returning shard 0's result."""
        if not self._groups:
            return fn(i, *args)
        group = self._groups[i]
        base = i * group.n
        return group.run(lambda k, dev: fn(
            base + k, *(a.to(dev) for a in args)))[0]

    # the first replica's programs (the only ones without a plan)
    _translate = property(lambda self: self._fns["translate"][0])
    _translate_u8 = property(lambda self: self._fns["translate_u8"][0])
    _translate_all = property(lambda self: self._fns["translate_all"][0])

    def _tier(self, aot_cache) -> None:
        """Route the three entry points of each replica through ``AotJit``:
        one program per input shape, a CUDA graph of the eager forward on
        the card (the eager forward itself under ``tensor_parallel``)."""
        from weather_unet_tpu_torch.core.aot import AotCache, AotJit

        self.aot = (aot_cache if isinstance(aot_cache, AotCache)
                    else AotCache(aot_cache))
        capture = not self.tensor_parallel
        self._fns = {name: [AotJit(f, self.aot, capture=capture)
                            for f in fns]
                     for name, fns in self._fns.items()}

    @classmethod
    def load(cls, cp_path: str, num_classes: int = 5,
             dtype: torch.dtype = torch.float32, fuse_upconv="auto",
             use_pallas="auto", device: DeviceLike = None, aot_cache=None,
             plan=None, tensor_parallel: bool = False):
        """Load from a reference ``.pt`` GAN bundle or a JAX-package msgpack
        checkpoint (``cli.common.load_transfer``).  ``use_pallas``: K1 + K2
        in the decoder, ``"auto"`` resolves to on; ``fuse_upconv``: the
        fused upsample+conv decoder kernel, ``"auto"`` resolves to off (and
        is refused with a ``plan``).  ``aot_cache``: a directory (or
        ``AotCache``) for the AOT tier, each bucket a CUDA graph on the
        card.  ``plan``: one replica on each of its local devices, or with
        ``tensor_parallel`` one shard (the JAX package's guard: the plan's
        model axis must be at least 2)."""
        from weather_unet_tpu_torch.cli.common import load_transfer

        device = (resolve_device(device) if plan is None
                  else plan.devices[0])
        model = load_transfer(cp_path, num_classes=num_classes, dtype=dtype,
                              fuse_upconv=fuse_upconv, use_pallas=use_pallas,
                              device=device)
        return cls(model, device, aot_cache=aot_cache, plan=plan,
                   tensor_parallel=tensor_parallel)

    def _fwd(self, i, x, c):
        """Replica ``i``: NHWC in, NHWC out, on its device."""
        x = x.permute(0, 3, 1, 2).contiguous()
        return self._replicas[i](x, c).permute(0, 2, 3, 1)

    def _fwd_u8(self, i, x_u8, c):
        # normalize like preprocess() and denormalize like to_uint8(), but on
        # the device: the host<->device wire carries uint8 both ways
        y = self._fwd(i, self._u8_norm[i][x_u8.long()], c)
        return ((y.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)

    def _split(self, fns, *arrays, dim: int = 0):
        """Replica i's ``fns[i]`` on the i-th of equal row chunks of
        ``arrays`` (each moved to its device); the results concatenated in
        order along ``dim`` on the first device.  The launches of every
        replica are queued before any result is gathered."""
        if len(fns) == 1:
            return fns[0](*(a.to(self.device) for a in arrays))
        chunks = zip(*(a.chunk(len(fns)) for a in arrays))
        outs = [fn(*(a.to(d) for a in chunk))
                for fn, d, chunk in zip(fns, self._row_devices, chunks)]
        return torch.cat([o.to(self.device) for o in outs], dim=dim)

    def translate(self, images, conditions, *, bucket: bool = True):
        """(B,H,W,3) in [-1,1] + (B,num_classes) conditions -> translated
        (B,H,W,3) in the model's dtype.  ``bucket=True`` pads the batch with
        zero rows up to the next power of two (rows are independent in eval;
        the JAX package does this to bound its compiled shapes, the port to
        keep the same batch sizes reaching the kernels); with a plan, up to
        a multiple of the replicas (or data rows of shards) too, each
        taking an equal share."""
        return self._bucketed(self._fns["translate"], images, conditions,
                              bucket)

    def translate_u8(self, images_u8, conditions, *, bucket: bool = True):
        """uint8 NHWC in, uint8 NHWC out, with normalize/denormalize on the
        device: same formulas as ``to_uint8(translate(preprocess(u8)))``."""
        return self._bucketed(self._fns["translate_u8"], images_u8,
                              conditions, bucket)

    @torch.inference_mode()
    def _bucketed(self, fns, images, conditions, bucket):
        x = torch.as_tensor(images)
        c = torch.as_tensor(conditions)
        b, n = x.shape[0], len(fns)
        nb = 1 << max(b - 1, 0).bit_length() if bucket else b
        nb = -(-nb // n) * n                  # an equal share per replica
        if 0 < b < nb:
            # pads where the input lives: host inputs cross to the device once
            x = torch.cat([x, x.new_zeros((nb - b,) + x.shape[1:])])
            c = torch.cat([c, c.new_zeros((nb - b,) + c.shape[1:])])
        return self._split(fns, x, c)[:b]

    def _fwd_all(self, i, x):
        b, k = x.shape[0], self.model.num_classes
        c = torch.eye(k, device=x.device).repeat_interleave(b, dim=0)
        out = self._fwd(i, x.repeat(k, 1, 1, 1), c)
        return out.reshape(k, b, *out.shape[1:])

    @torch.inference_mode()
    def translate_to_classes(self, images):
        """All one-hot class translations: -> (num_classes, B, H, W, 3);
        with a plan the batch is split over the replicas."""
        return self._split(self._fns["translate_all"],
                           torch.as_tensor(images), dim=1)

    @torch.inference_mode()
    def sweep(self, images, estimate: Callable, num_frames: int = 10,
              alpha: float = 2.0):
        """demo theta sweep: (T, num_classes, B, H, W, 3) frames where axis
        k's condition is sin(theta)*alpha with estimator predictions
        elsewhere.  Each call runs on the model's current weights; with a
        plan each frame's batch is split over the replicas."""
        thetas = np.arange(-np.pi / 2, np.pi / 2 + np.pi / num_frames,
                           np.pi / (num_frames - 1)).astype(np.float32)
        x = torch.as_tensor(images).to(self.device)
        pred = torch.as_tensor(estimate(x)).to(self.device, torch.float32)
        b, k = x.shape[0], self.model.num_classes
        eye = torch.eye(k, device=self.device)

        def frame(i, xs, cs):
            bi = xs.shape[0]
            out = self._fwd(i, xs.repeat(k, 1, 1, 1), cs.transpose(
                0, 1).reshape(k * bi, k))
            return out.reshape(k, bi, *out.shape[1:])

        fns = [functools.partial(self._row, i, frame)
               for i in range(len(self._row_devices))]
        frames = []
        for theta in torch.from_numpy(thetas):
            c = ((torch.sin(theta) * alpha * eye)[:, None, :]
                 + (1.0 - eye)[:, None, :] * pred[None])      # (K, B, K)
            frames.append(self._split(fns, x, c.transpose(0, 1), dim=1))
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
