"""Bilinear 2x upsample with PyTorch ``align_corners=True`` semantics, and
the general bilinear resize (``resize_bilinear_torch``) in either convention.

The reference U-Net upsamples with ``nn.Upsample(scale_factor=2,
mode='bilinear', align_corners=True)``; the plain form here is that same
call, ``F.interpolate`` (a PyTorch kernel, memory-bound, no dense matmul).
Output row ``i`` reads source coordinate ``i * (n_in - 1) / (n_out - 1)``.

``upsample_x2_rows`` is the row-window form of spatial partitioning
(``parallel/spatial.py``): a shard's rows, one halo row above and below,
to its rows of the whole image's output, with ``_x2_window_taps``.

The numpy tables below are the JAX package's, copied: ``_x2_taps`` gives the
2-tap indices and float32 weights that ``_tap_tables`` ships to the device
for the upsample kernel (``kernels/upsample.py``) and the fused
upsample+conv kernel (``kernels/upconv.py``); ``_interp_matrix_np`` is the
dense form of the same weights (the upsample kernel's backward uses it) and
``_x2_shift_weights`` their even/odd-phase form (the tests hold all three to
one another and to the JAX package).

``upsample_x2_gather`` and ``upsample_x2_shift`` are the JAX package's two
other plain forms of the same 2x upsample, the ``impl=`` choices of
``upsample_bilinear_align_corners``: two gathers and a blend per axis in x's
dtype, and shifted-slice blends in float32 rounded after each axis.  No
model path calls them; ``impl="matmul"`` (the default) is ``F.interpolate``.
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


@functools.lru_cache(maxsize=256)
def _tap_tables(h: int, w: int, device: torch.device, window=None):
    """The kernels' tap tables of an (h, w) -> (2h, 2w) upsample on
    ``device``: int32 ``[i0 rows | i1 rows | i0 cols | i1 cols]`` and float32
    ``[f rows | f cols]``.  With ``window = (n_in, start)`` the row taps are
    those of ``_x2_window_taps(n_in, start, h)``: ``h`` rows of an image of
    ``n_in``, read from a slab of ``h + 2``."""
    hi0, hi1, hf = (_x2_taps(h) if window is None
                    else _x2_window_taps(window[0], window[1], h))
    wi0, wi1, wf = _x2_taps(w)
    idx = np.concatenate([hi0, hi1, wi0, wi1]).astype(np.int32)
    frac = np.concatenate([hf, wf]).astype(np.float32)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(frac).to(device))


@functools.lru_cache(maxsize=256)
def _x2_window_taps(n_in: int, start: int, h: int):
    """The row taps of output rows ``[2 start, 2 (start + h))`` of an exact
    2x align-corners upsample of ``n_in`` rows, indexing a slab of ``h +
    2`` rows whose row 0 is input row ``start - 1`` (one halo row above
    the shard's ``h`` rows and one below): ``(i0, i1, f)`` as
    ``_x2_taps``.  The taps reach one row above the shard's rows at most,
    and one below (slab rows 0 and h + 1), none beyond the image."""
    i0, i1, f = _x2_taps(n_in)
    win = slice(2 * start, 2 * (start + h))
    off = start - 1
    j0, j1 = i0[win] - off, i1[win] - off
    if j0.min() < 0 or j1.max() > h + 1:
        raise ValueError(f"rows [{start}, {start + h}) of {n_in}: the taps "
                         f"leave the one-row halo")
    return j0.astype(np.int32), j1.astype(np.int32), f[win]


@functools.lru_cache(maxsize=256)
def _window_matrix_np(n_in: int, start: int, h: int) -> np.ndarray:
    """(2h, h + 2) float32 weights of the window's output rows over its
    slab (``_x2_window_taps``), dense: the rows of ``_interp_matrix_np(2
    n_in, n_in)`` for the window, over the slab's columns (the halo rows
    beyond the image carry weight 0)."""
    full = _interp_matrix_np(2 * n_in, n_in, True)
    m = np.zeros((2 * h, h + 2), np.float32)
    lo, hi = max(start - 1, 0), min(start + h + 1, n_in)
    m[:, lo - (start - 1):hi - (start - 1)] = full[2 * start:2 * (start + h),
                                                   lo:hi]
    return m


def upsample_x2_rows(slab: torch.Tensor, n_in: int,
                     start: int) -> torch.Tensor:
    """The row-window form of the exact 2x align-corners upsample (spatial
    partitioning): ``slab`` (B, C, h + 2, W) holds input rows ``[start - 1,
    start + h + 1)`` of an image of ``n_in`` rows (zeros where they leave
    it); returns output rows ``[2 start, 2 (start + h))`` of the whole
    image's (B, C, 2 n_in, 2W), which equal its ``upsample_bilinear_
    align_corners`` there.  Columns then rows, blended in float32 with the
    whole image's taps and rounded once, as K2's kernel does."""
    h, w = slab.shape[2] - 2, slab.shape[3]
    i0, i1, f = (torch.from_numpy(a).to(slab.device)
                 for a in _x2_window_taps(n_in, start, h))
    j0, j1, g = (torch.from_numpy(a).to(slab.device) for a in _x2_taps(w))
    xf = slab.float()
    cols = (xf.index_select(3, j0.long()) * (1 - g)
            + xf.index_select(3, j1.long()) * g)
    fr = f[:, None]
    out = (cols.index_select(2, i0.long()) * (1 - fr)
           + cols.index_select(2, i1.long()) * fr)
    return out.to(slab.dtype)


def upsample_x2_gather(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x align-corners upsample, NCHW, as two gathers and a blend per
    axis (H, then W), all in x's dtype: in bfloat16 each product and each
    sum rounds, as in the JAX package."""
    h, w = x.shape[2:]
    i0, i1, f = (torch.from_numpy(a).to(x.device) for a in _x2_taps(h))
    fh = f.to(x.dtype)[:, None]
    y = (x.index_select(2, i0.long()) * (1 - fh)
         + x.index_select(2, i1.long()) * fh)
    j0, j1, g = (torch.from_numpy(a).to(x.device) for a in _x2_taps(w))
    gw = g.to(x.dtype)
    return (y.index_select(3, j0.long()) * (1 - gw)
            + y.index_select(3, j1.long()) * gw)


def upsample_x2_shift(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x align-corners upsample, NCHW, as shifted-slice blends and an
    interleave: per axis, ``even = prev * a + x * (1 - a)`` and ``odd = x *
    (1 - b) + next * b`` (``_x2_shift_weights``; the clamped edges carry
    weight 0), stacked beside the axis and merged by a reshape.  Each axis
    pass runs in float32 and rounds back to x's dtype."""

    def axis_pass(t, dim):
        size = t.shape[dim]
        shape = [1, 1, 1, 1]
        shape[dim] = size
        a, b = (torch.from_numpy(v).to(t.device).reshape(shape)
                for v in _x2_shift_weights(size))
        tf = t.float()
        prev = torch.cat([tf.narrow(dim, 0, 1), tf.narrow(dim, 0, size - 1)],
                         dim)
        nxt = torch.cat([tf.narrow(dim, 1, size - 1),
                         tf.narrow(dim, size - 1, 1)], dim)
        even = prev * a + tf * (1.0 - a)
        odd = tf * (1.0 - b) + nxt * b
        out_shape = list(t.shape)
        out_shape[dim] = 2 * size
        return torch.stack([even, odd], dim + 1).reshape(out_shape).to(
            t.dtype)

    return axis_pass(axis_pass(x, 2), 3)


IMPLS = ("matmul", "gather", "shift")


def upsample_bilinear_align_corners(x: torch.Tensor, scale: int = 2, *,
                                    impl: str = "matmul"):
    """``(B, C, H, W) -> (B, C, scale*H, scale*W)``, align_corners=True.
    ``impl="matmul"`` (the JAX package's name for its dense-weight form) is
    ``F.interpolate``; at scale 2, ``"gather"`` and ``"shift"`` are
    ``upsample_x2_gather`` and ``upsample_x2_shift``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if scale == 2 and impl == "gather":
        return upsample_x2_gather(x)
    if scale == 2 and impl == "shift":
        return upsample_x2_shift(x)
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
