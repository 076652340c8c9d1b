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
    _interp_matrix_np, _tap_tables, _x2_taps, upsample_bilinear_align_corners)

launches = 0   # kernel launches so far (plain-version calls do not count)

VARIANTS = ("einsum", "loop", "blend", "blendmm", "shift")

upsample2x_fused_ref = upsample_bilinear_align_corners   # the plain version

SMEM_LIMIT = 227 * 1024     # dynamic shared memory a block may use (H100)
# output values a block writes: enough work to amortize its two barriers,
# small enough that several blocks share an SM and keep loads in flight
OUT_PER_BLOCK = 8192


def staged_rows(h: int, rows: int):
    """Mirror of the kernel's staging: for each strip of ``rows`` output rows
    of a plane with ``h`` input rows, the first and last input row the block
    stages (i0 of the strip's first output row, i1 of its last)."""
    i0, i1, _ = _x2_taps(h)
    return [(int(i0[s]), int(i1[min(s + rows, 2 * h) - 1]))
            for s in range(0, 2 * h, rows)]


@functools.lru_cache(maxsize=256)
def plan_upsample(b: int, c: int, h: int, w: int, dtype,
                  out_per_block: int = OUT_PER_BLOCK,
                  vec_ok: bool = True) -> dict:
    """The kernel's block shape for x (b, c, h, w): output rows a block owns
    (``rows``), planes it owns (``pb``, more than 1 only when it owns whole
    planes), the staged input rows it may need (``staged``), the vector
    width of its stores (``vec`` elements, 1 = the scalar path, taken when
    an output row is not a multiple of 16 bytes or ``vec_ok`` is False), and
    its shared memory: the staged run of x at 0, the float32
    column-blended rows at ``off_hb``, the row taps at ``off_taps``.
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
            staged = pb * h
        else:
            staged = max(z - a + 1 for a, z in staged_rows(h, rows))
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
