"""K2: exact 2x bilinear upsample, align_corners=True (``csrc/upsample.cu``),
the port of ``weather_unet_tpu/kernels/upsample_pallas.py::upsample2x_fused``.

Drop-in for ``ops.resize.upsample_bilinear_align_corners(x)`` (its plain
version), NCHW in and out: one pass that reads ``x`` once and writes the
result once, blending in float32 with the 2-tap tables of
``ops/resize.py::_x2_taps`` and rounding once.  ``plan_upsample`` gives the
kernel's block shape (rows and planes a block owns, vector width, shared
memory layout); ``staged_rows`` mirrors which input rows a block stages.
The op is linear; its backward applies the transposed interpolation
matrices in plain PyTorch, as the JAX package's VJP does in plain XLA.  It
is registered with ``torch.library`` as ``wut::upsample2x`` (CUDA: the
kernel; CPU: the plain version; a fake implementation for tracing, so
``torch.export`` keeps it as one op; the plan is chosen inside the CUDA
implementation), its backward as ``wut::upsample2x_backward``.

The row-window form serves spatial partitioning (``parallel/spatial.py``):
``wut::upsample2x_rows`` (``upsample_rows_kernel``) takes a shard's rows
with one halo row above and below and writes the shard's rows of the
whole image's output grid, with the whole image's row taps offset into
the slab (``plan_upsample`` / ``staged_rows`` with ``window``); its
launches are counted apart (``rows_launches``) and its backward
(``wut::upsample2x_rows_backward``) applies the window's matrix.

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
    _interp_matrix_np, _tap_tables, _window_matrix_np, _x2_taps,
    _x2_window_taps, upsample_bilinear_align_corners, upsample_x2_rows)

launches = 0   # kernel launches so far (plain-version calls do not count)
rows_launches = 0   # launches of the row-window form (spatial partitioning)

VARIANTS = ("einsum", "loop", "blend", "blendmm", "shift")

upsample2x_fused_ref = upsample_bilinear_align_corners   # the plain version

SMEM_LIMIT = 227 * 1024     # dynamic shared memory a block may use (H100)
# output values a block writes: enough work to amortize its two barriers,
# small enough that several blocks share an SM and keep loads in flight
OUT_PER_BLOCK = 8192


def staged_rows(h: int, rows: int, window=None):
    """Mirror of the kernel's staging: for each strip of ``rows`` output rows
    of a plane with ``h`` input rows, the first and last input row the block
    stages (i0 of the strip's first output row, i1 of its last).  With
    ``window = (n_in, start)`` the plane is a shard's ``h`` rows of an image
    of ``n_in`` and the rows are the slab's (``h + 2``, one halo row above
    at 0 and one below at ``h + 1``)."""
    i0, i1, _ = (_x2_taps(h) if window is None
                 else _x2_window_taps(window[0], window[1], h))
    return [(int(i0[s]), int(i1[min(s + rows, 2 * h) - 1]))
            for s in range(0, 2 * h, rows)]


@functools.lru_cache(maxsize=256)
def plan_upsample(b: int, c: int, h: int, w: int, dtype,
                  out_per_block: int = OUT_PER_BLOCK,
                  vec_ok: bool = True, window=None) -> dict:
    """The kernel's block shape for x (b, c, h, w): output rows a block owns
    (``rows``), planes it owns (``pb``, more than 1 only when it owns whole
    planes), the staged input rows it may need (``staged``), the vector
    width of its stores (``vec`` elements, 1 = the scalar path, taken when
    an output row is not a multiple of 16 bytes or ``vec_ok`` is False), and
    its shared memory: the staged run of x at 0, the float32
    column-blended rows at ``off_hb``, the row taps at ``off_taps``.
    ``window = (n_in, start)``: the row-window form, x a shard's ``h`` rows
    of an image of ``n_in`` as a slab of ``h + 2`` (``staged_rows``).
    Mirrors csrc/upsample.cu."""
    esize = torch.empty((), dtype=dtype).element_size()
    kv = 16 // esize
    planes, ho, wo = b * c, 2 * h, 2 * w
    vec = kv if vec_ok and (wo * esize) % 16 == 0 else 1
    if ho * wo <= out_per_block:
        rows, pb = ho, max(1, min(planes, out_per_block // (ho * wo)))
    else:
        rows, pb = max(1, min(ho, out_per_block // wo)), 1
    while True:
        if pb > 1:
            staged = pb * (h if window is None else h + 2)
        else:
            staged = max(z - a + 1 for a, z in staged_rows(h, rows, window))
        off_hb = 16 * -(-(kv - 1 + staged * w) // kv)
        off_taps = off_hb + staged * wo * 4
        smem = off_taps + 12 * rows
        if smem <= SMEM_LIMIT:
            break
        if pb > 1:
            pb //= 2
        elif rows > 1:
            rows //= 2
        else:
            raise ValueError(f"upsample kernel: one output row of width {wo} "
                             f"needs {smem} bytes of shared memory, over "
                             f"{SMEM_LIMIT}")
    strips = -(-ho // rows)
    name = f"{rows}r" + (f"x{pb}p" if pb > 1 else "") + f" v{vec}"
    return {"name": name, "rows": rows, "pb": pb, "strips": strips,
            "staged": staged, "vec": vec,
            "off_hb": off_hb, "off_taps": off_taps, "smem": smem,
            "grid": -(-planes // pb) * strips}


def upsample_plans(b: int, c: int, h: int, w: int, dtype) -> list:
    """Every plan the kernel takes for this shape, the chosen one first:
    blocks of 2048 to 32768 outputs, and the scalar path."""
    plans = [plan_upsample(b, c, h, w, dtype)]
    plans += [plan_upsample(b, c, h, w, dtype, opb)
              for opb in (2048, 4096, 16384, 32768)]
    plans.append(plan_upsample(b, c, h, w, dtype, vec_ok=False))
    seen, out = set(), []
    for pl in plans:
        if pl["name"] not in seen:
            seen.add(pl["name"])
            out.append(pl)
    return out


@functools.cache
def _entry():
    lib = _build.library("upsample")
    fn = lib.wut_upsample2x
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong] + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def upsample_kernel(x: torch.Tensor, plan: dict = None) -> torch.Tensor:
    """Launch K2 on a CUDA tensor: x (B, C, H, W) float32/bfloat16
    contiguous -> (B, C, 2H, 2W), under ``plan`` (default
    ``plan_upsample``; one of ``upsample_plans`` to force another)."""
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
    if plan is None:
        plan = plan_upsample(b, c, h, w, x.dtype)
    if plan["vec"] > 1 and out.data_ptr() % 16:
        raise ValueError("upsample kernel output must be 16-byte aligned")
    idx, frac = _tap_tables(h, w, x.device)
    lib, fn = _entry()
    err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), idx.data_ptr(),
             frac.data_ptr(), out.data_ptr(), b * c, h, w,
             int(plan["vec"] > 1), plan["rows"], plan["pb"], plan["off_hb"],
             plan["off_taps"], plan["smem"], x.device.index,
             _build.stream_of(x))
    _build.check_launch(lib, err, "upsample")
    with _build.COUNT_LOCK:
        launches += 1
    return out


@functools.cache
def _rows_entry():
    lib = _build.library("upsample")
    fn = lib.wut_upsample2x_rows
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong] + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def upsample_rows_kernel(slab: torch.Tensor, n_in: int, start: int,
                         plan: dict = None) -> torch.Tensor:
    """Launch K2's row-window form on a CUDA tensor: ``slab`` (B, C, h + 2,
    W) float32/bfloat16 contiguous, a shard's rows ``[start, start + h)``
    of an image of ``n_in`` rows with one halo row above and below ->
    (B, C, 2h, 2W), the shard's rows of the whole image's output
    (``ops.resize.upsample_x2_rows``).  ``plan`` defaults to
    ``plan_upsample(..., window=(n_in, start))``."""
    global rows_launches
    if slab.dim() != 4 or slab.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"upsample rows kernel takes a 4-D float32/bfloat16 "
                         f"slab, got {tuple(slab.shape)} {slab.dtype}")
    if not slab.is_cuda or not slab.is_contiguous():
        raise ValueError("upsample rows kernel takes a contiguous CUDA slab")
    b, c, hs, w = slab.shape
    h = hs - 2
    if h < 1 or start < 0 or start + h > n_in:
        raise ValueError(f"a slab of {hs} rows is not rows [{start}, "
                         f"{start + h}) of {n_in} with a halo row each side")
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=slab.dtype,
                      device=slab.device)
    if out.numel() == 0:
        return out
    window = (n_in, start)
    if plan is None:
        plan = plan_upsample(b, c, h, w, slab.dtype, window=window)
    if plan["vec"] > 1 and out.data_ptr() % 16:
        raise ValueError("upsample rows kernel output must be 16-byte "
                         "aligned")
    idx, frac = _tap_tables(h, w, slab.device, window)
    lib, fn = _rows_entry()
    err = fn(_build.DTYPE_CODES[slab.dtype], slab.data_ptr(), idx.data_ptr(),
             frac.data_ptr(), out.data_ptr(), b * c, hs, 2 * h, w,
             int(plan["vec"] > 1), plan["rows"], plan["pb"], plan["off_hb"],
             plan["off_taps"], plan["smem"], slab.device.index,
             _build.stream_of(slab))
    _build.check_launch(lib, err, "upsample rows")
    with _build.COUNT_LOCK:
        rows_launches += 1
    return out


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, device: torch.device) -> torch.Tensor:
    """(2n, n) float32 interpolation matrix on ``device``."""
    return torch.from_numpy(_interp_matrix_np(2 * n_in, n_in, True)).to(device)


@torch.library.custom_op("wut::upsample2x", mutates_args=(),
                         device_types="cuda")
def upsample2x_op(x: torch.Tensor) -> torch.Tensor:
    """K2 on a CUDA tensor; the kernel reads one dense NCHW plane after
    another, so a strided or channels-last input is copied into that layout
    first."""
    return upsample_kernel(x.contiguous())


@upsample2x_op.register_kernel("cpu")
def _upsample2x_cpu(x):
    return upsample_bilinear_align_corners(x)


@upsample2x_op.register_fake
def _upsample2x_fake(x):
    b, c, h, w = x.shape
    return x.new_empty((b, c, 2 * h, 2 * w))


@torch.library.custom_op("wut::upsample2x_backward", mutates_args=())
def upsample2x_backward_op(g: torch.Tensor) -> torch.Tensor:
    """K2's VJP on any device, g (B, C, 2H, 2W) -> (B, C, H, W): the
    transposed interpolation matrices, built on the host for the concrete
    sizes, applied in plain PyTorch.  An op of its own, so that a traced
    backward holds it as one node (its fake implementation gives the
    shape) instead of tracing into the host-built tables."""
    h, w = g.shape[2] // 2, g.shape[3] // 2
    mh = _interp_matrix(h, g.device).to(g.dtype)      # (2H, H)
    mw = _interp_matrix(w, g.device).to(g.dtype)      # (2W, W)
    return torch.einsum("oh,bcop,pw->bchw", mh, g, mw)


@upsample2x_backward_op.register_fake
def _upsample2x_backward_fake(g):
    b, c, h2, w2 = g.shape
    return g.new_empty((b, c, h2 // 2, w2 // 2))


upsample2x_op.register_autograd(
    lambda ctx, g: upsample2x_backward_op(g))


def upsample2x_fused(x: torch.Tensor, variant: str = "shift"):
    """Exact 2x align_corners bilinear upsample (B, C, H, W) -> (B, C, 2H,
    2W): the K2 kernel on CUDA tensors (a non-contiguous input is made
    contiguous first), the plain version on CPU tensors; differentiable
    either way."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    _build.is_cuda(x)          # refuses a device that is neither
    return upsample2x_op(x)


# --------------------------------------------------------- row-window form

@torch.library.custom_op("wut::upsample2x_rows", mutates_args=(),
                         device_types="cuda")
def upsample2x_rows_op(slab: torch.Tensor, n_in: int,
                       start: int) -> torch.Tensor:
    """K2's row-window form on a CUDA tensor (made contiguous)."""
    return upsample_rows_kernel(slab.contiguous(), n_in, start)


@upsample2x_rows_op.register_kernel("cpu")
def _upsample2x_rows_cpu(slab, n_in, start):
    return upsample_x2_rows(slab, n_in, start)


@upsample2x_rows_op.register_fake
def _upsample2x_rows_fake(slab, n_in, start):
    b, c, hs, w = slab.shape
    return slab.new_empty((b, c, 2 * (hs - 2), 2 * w))


@functools.lru_cache(maxsize=256)
def _window_matrix(n_in: int, start: int, h: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_window_matrix_np(n_in, start, h)).to(device)


@torch.library.custom_op("wut::upsample2x_rows_backward", mutates_args=())
def upsample2x_rows_backward_op(g: torch.Tensor, n_in: int,
                                start: int) -> torch.Tensor:
    """The row-window form's VJP on any device, g (B, C, 2h, 2W) -> the
    slab's (B, C, h + 2, W): the window's interpolation matrix over the
    slab (``ops/resize.py::_window_matrix_np``) and the column matrix,
    transposed, in plain PyTorch.  The halo rows' gradients go back to
    their owners through the halo exchange's backward."""
    h, w = g.shape[2] // 2, g.shape[3] // 2
    mh = _window_matrix(n_in, start, h, g.device).to(g.dtype)   # (2h, h+2)
    mw = _interp_matrix(w, g.device).to(g.dtype)                # (2W, W)
    return torch.einsum("oh,bcop,pw->bchw", mh, g, mw)


@upsample2x_rows_backward_op.register_fake
def _upsample2x_rows_backward_fake(g, n_in, start):
    b, c, h2, w2 = g.shape
    return g.new_empty((b, c, h2 // 2 + 2, w2 // 2))


def _rows_setup(ctx, inputs, output):
    ctx.n_in, ctx.start = inputs[1], inputs[2]


upsample2x_rows_op.register_autograd(
    lambda ctx, g: (upsample2x_rows_backward_op(g, ctx.n_in, ctx.start),
                    None, None), setup_context=_rows_setup)


def upsample2x_rows_fused(slab: torch.Tensor, n_in: int, start: int):
    """The row-window 2x upsample (``ops.resize.upsample_x2_rows``): K2 on
    CUDA tensors, the plain version on CPU tensors; differentiable either
    way."""
    _build.is_cuda(slab)       # refuses a device that is neither
    return upsample2x_rows_op(slab, n_in, start)
