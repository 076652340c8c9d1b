"""K2: exact 2x bilinear upsample, align_corners=True (``csrc/upsample.cu``),
the port of ``weather_unet_tpu/kernels/upsample_pallas.py::upsample2x_fused``.

Drop-in for ``ops.resize.upsample_bilinear_align_corners(x)`` (its plain
version), NCHW in and out: one pass that reads ``x`` once and writes the
result once, blending in float32 with the 2-tap tables of
``ops/resize.py::_x2_taps`` and rounding once.  The op is linear; its
backward applies the transposed interpolation matrices in plain PyTorch, as
the JAX package's VJP does in plain XLA.

``variant`` names one of the JAX package's five kernel bodies.  They are TPU
layout variants of this one function, so the port checks the name and
otherwise ignores it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from weather_unet_tpu_torch.kernels import _build
from weather_unet_tpu_torch.ops.resize import (
    _interp_matrix_np, _tap_tables, upsample_bilinear_align_corners)

launches = 0   # kernel launches so far (plain-version calls do not count)

VARIANTS = ("einsum", "loop", "blend", "blendmm", "shift")

upsample2x_fused_ref = upsample_bilinear_align_corners   # the plain version


@functools.cache
def _entry():
    lib = _build.library("upsample")
    fn = lib.wut_upsample2x
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def upsample_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch K2 on a CUDA tensor: x (B, C, H, W) float32/bfloat16
    contiguous -> (B, C, 2H, 2W)."""
    global launches
    if x.dim() != 4 or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"upsample kernel takes a 4-D float32/bfloat16 x, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_cuda:
        raise ValueError("upsample kernel input must be a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("upsample kernel input must be contiguous")
    b, c, h, w = x.shape
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    idx, frac = _tap_tables(h, w, x.device)
    lib, fn = _entry()
    err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), idx.data_ptr(),
             frac.data_ptr(), out.data_ptr(), b * c, h, w, x.device.index,
             _build.stream_of(x))
    _build.check_launch(lib, err, "upsample")
    launches += 1
    return out


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, device: torch.device) -> torch.Tensor:
    """(2n, n) float32 interpolation matrix on ``device``."""
    return torch.from_numpy(_interp_matrix_np(2 * n_in, n_in, True)).to(device)


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.hw = x.shape[2:]
        if not _build.is_cuda(x):
            return upsample_bilinear_align_corners(x)
        # the kernel reads one dense NCHW plane after another: a strided or
        # channels-last input is copied into that layout first
        return upsample_kernel(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.hw
        mh = _interp_matrix(h, g.device).to(g.dtype)      # (2H, H)
        mw = _interp_matrix(w, g.device).to(g.dtype)      # (2W, W)
        return torch.einsum("oh,bcop,pw->bchw", mh, g, mw)


def upsample2x_fused(x: torch.Tensor, variant: str = "shift"):
    """Exact 2x align_corners bilinear upsample (B, C, H, W) -> (B, C, 2H,
    2W): the K2 kernel on CUDA tensors (a non-contiguous input is made
    contiguous first), the plain version on CPU tensors; differentiable
    either way."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    return _Upsample2x.apply(x)
