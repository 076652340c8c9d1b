"""Bilinear 2x upsample with PyTorch ``align_corners=True`` semantics, and
the general bilinear resize (``resize_bilinear_torch``) in either convention.

The reference U-Net upsamples with ``nn.Upsample(scale_factor=2,
mode='bilinear', align_corners=True)``; the plain form here is that same
call, ``F.interpolate`` (a PyTorch kernel, memory-bound, no dense matmul).
Output row ``i`` reads source coordinate ``i * (n_in - 1) / (n_out - 1)``.

The numpy tables below are the JAX package's, copied: ``_x2_taps`` gives the
2-tap indices and float32 weights that ``_tap_tables`` ships to the device
for the upsample kernel (``kernels/upsample.py``) and the fused
upsample+conv kernel (``kernels/upconv.py``); ``_interp_matrix_np`` is the
dense form of the same weights (the upsample kernel's backward uses it) and
``_x2_shift_weights`` their even/odd-phase form (the tests hold all three to
one another and to the JAX package).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _interp_matrix_np(n_out: int, n_in: int,
                      align_corners: bool = True) -> np.ndarray:
    """(n_out, n_in) row-stochastic bilinear weights.  ``align_corners=True``:
    src = i*(n_in-1)/(n_out-1); ``False``: half-pixel src clamped."""
    m = np.zeros((n_out, n_in), dtype=np.float64)
    if align_corners:
        if n_out == 1 or n_in == 1:
            src = np.zeros(n_out)
        else:
            src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    else:
        scale = n_in / n_out
        src = np.clip((np.arange(n_out) + 0.5) * scale - 0.5, 0.0, n_in - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    frac = src - i0
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1.0 - frac)
    np.add.at(m, (rows, i1), frac)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _x2_taps(n_in: int):
    """Gather indices ``i0, i1`` (int32) and blend weight ``f`` (float32) of
    each output position of an exact 2x align-corners upsample:
    ``out[p] = (1 - f[p]) * x[i0[p]] + f[p] * x[i1[p]]``."""
    n_out = 2 * n_in
    if n_in == 1:
        src = np.zeros(n_out)
    else:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(src).astype(np.int32), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    f = (src - i0).astype(np.float32)
    return i0, i1, f


@functools.lru_cache(maxsize=64)
def _x2_shift_weights(n_in: int):
    """Even/odd decomposition of the 2x align-corners taps.  Even outputs
    p=2m blend x[m-1] (weight a=m/(2n-1)) with x[m]; odd outputs p=2m+1
    blend x[m] with x[m+1] (weight b=(n-1-m)/(2n-1)).  Boundary weights are
    exactly 0, so clamped shifts are exact."""
    m = np.arange(n_in, dtype=np.float64)
    a = m / (2 * n_in - 1)
    b = (n_in - 1 - m) / (2 * n_in - 1)
    return a.astype(np.float32), b.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _tap_tables(h: int, w: int, device: torch.device):
    """The kernels' tap tables of an (h, w) -> (2h, 2w) upsample on
    ``device``: int32 ``[i0 rows | i1 rows | i0 cols | i1 cols]`` and float32
    ``[f rows | f cols]``."""
    hi0, hi1, hf = _x2_taps(h)
    wi0, wi1, wf = _x2_taps(w)
    idx = np.concatenate([hi0, hi1, wi0, wi1]).astype(np.int32)
    frac = np.concatenate([hf, wf]).astype(np.float32)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(frac).to(device))


def upsample_bilinear_align_corners(x: torch.Tensor, scale: int = 2):
    """``(B, C, H, W) -> (B, C, scale*H, scale*W)``, align_corners=True."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=True)


def resize_bilinear_torch(x: torch.Tensor, out_h: int, out_w: int, *,
                          align_corners: bool = True) -> torch.Tensor:
    """NCHW bilinear resize, ``F.interpolate`` in either convention (the JAX
    package's ``resize_bilinear_torch`` computes the same on NHWC with the
    dense weights of ``_interp_matrix_np``).  Returns ``x`` itself when the
    size already matches."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=align_corners)
