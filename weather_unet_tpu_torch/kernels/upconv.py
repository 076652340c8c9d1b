"""K3: fused 2x align-corners upsample + 3x3 conv (``csrc/upconv.cu``), the
port of ``weather_unet_tpu/kernels/upconv_pallas.py``.

``upsample2x_conv3x3(x, w, cb=, scale=, shift=, relu=)`` computes
``act(conv3x3_pad1(upsample2x_ac(x * scale + shift), w) + cb)`` without
writing the upsampled or the modulated tensor, NCHW in and out, OIHW
weights, no bias (in the decoder the bias rides on the skip-path conv
``cb``).  The plain version ``upsample2x_conv3x3_ref`` is that chain in
PyTorch ops.  Gradients recompute through the plain version, as the JAX
package's VJPs do.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from weather_unet_tpu_torch.kernels import _build
from weather_unet_tpu_torch.ops.convs import conv2d
from weather_unet_tpu_torch.ops.resize import (
    _tap_tables, upsample_bilinear_align_corners)

launches = 0   # kernel launches so far (plain-version calls do not count)


def upsample2x_conv3x3_ref(x, weight, *, cb=None, scale=None, shift=None,
                           relu: bool = False):
    """Plain version: modulate -> upsample -> conv (+ cb) (-> relu)."""
    if scale is not None:
        x = (x.float() * scale[:, :, None, None]
             + shift[:, :, None, None]).to(x.dtype)
    y = conv2d(upsample_bilinear_align_corners(x), weight.to(x.dtype), None,
               padding=1)
    if cb is not None:
        y = y + cb
    return F.relu(y) if relu else y


def upconv_block_ref(x, weight, cb, scale, shift, relu: bool = True):
    """Plain version of the whole fused decoder-block entry."""
    return upsample2x_conv3x3_ref(x, weight, cb=cb, scale=scale, shift=shift,
                                  relu=relu)


@functools.cache
def _entry():
    lib = _build.library("upconv")
    fn = lib.wut_upconv
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def upconv_kernel(x, weight, cb=None, scale=None, shift=None,
                  relu: bool = False) -> torch.Tensor:
    """Launch K3 on CUDA tensors.  x (B, C, H, W) and cb (B, O, 2H, 2W)
    contiguous, weight (O, C, 3, 3), all of one dtype (float32/bfloat16);
    scale, shift (B, C) float32 contiguous, both or neither."""
    global launches
    if x.dim() != 4 or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"upconv kernel takes a 4-D float32/bfloat16 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    o = weight.shape[0]
    if weight.shape != (o, c, 3, 3) or weight.dtype != x.dtype:
        raise ValueError(f"weight must be {x.dtype} of shape (O, {c}, 3, 3), "
                         f"got {tuple(weight.shape)} {weight.dtype}")
    if (scale is None) != (shift is None):
        raise ValueError("pass scale and shift together")
    checks = [("x", x, x.shape, x.dtype), ("weight", weight, weight.shape,
                                           x.dtype)]
    if cb is not None:
        checks.append(("cb", cb, (b, o, 2 * h, 2 * w), x.dtype))
    if scale is not None:
        checks += [("scale", scale, (b, c), torch.float32),
                   ("shift", shift, (b, c), torch.float32)]
    for name, t, shape, dtype in checks:
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)},"
                             f" got {tuple(t.shape)} {t.dtype}")
    for name, t, _, _ in checks:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("upconv kernel inputs must share one CUDA device")
        if name != "weight" and not t.is_contiguous():
            raise ValueError(f"upconv kernel input {name} must be contiguous")
    out = torch.empty((b, o, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    w_t = weight.permute(1, 2, 3, 0).contiguous()     # (C, 3, 3, O)
    idx, frac = _tap_tables(h, w, x.device)
    lib, fn = _entry()
    err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), w_t.data_ptr(),
             _ptr(cb), _ptr(scale), _ptr(shift), idx.data_ptr(),
             frac.data_ptr(), out.data_ptr(), b, c, h, w, o, int(relu),
             x.device.index, _build.stream_of(x))
    _build.check_launch(lib, err, "upconv")
    launches += 1
    return out


class _UpConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, cb, scale, shift, relu):
        ctx.save_for_backward(x, weight, cb, scale, shift)
        ctx.relu = relu
        if not _build.is_cuda(x):
            return upsample2x_conv3x3_ref(x, weight, cb=cb, scale=scale,
                                          shift=shift, relu=relu)
        return upconv_kernel(x, weight, cb, scale, shift, relu)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            args = [None if t is None else t.detach().requires_grad_(n)
                    for t, n in zip(ctx.saved_tensors, needs)]
            out = upsample2x_conv3x3_ref(args[0], args[1], cb=args[2],
                                         scale=args[3], shift=args[4],
                                         relu=ctx.relu)
            wrt = [a for a, n in zip(args, needs) if n]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(grads) if n else None for n in needs) + (None,)


def upsample2x_conv3x3(x, weight, *, cb=None, scale=None, shift=None,
                       relu: bool = False):
    """``conv3x3_pad1(upsample_2x_align_corners(x))`` without the upsample;
    optional modulation ``scale/shift`` (B, C), skip-path term ``cb`` and
    ReLU.  K3 on CUDA tensors, the plain version on CPU tensors;
    differentiable either way."""
    return _UpConv.apply(x, weight, cb, scale, shift, relu)


def upconv_block_fused(x, weight, cb, scale, shift, relu: bool = True):
    """Fused decoder-block entry: modulate + upsample + conv + cb + ReLU."""
    return upsample2x_conv3x3(x, weight, cb=cb, scale=scale, shift=shift,
                              relu=relu)
