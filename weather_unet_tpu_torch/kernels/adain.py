"""K1: fused AdaIN (``csrc/adain.cu``), the port of
``weather_unet_tpu/kernels/adain_pallas.py::adain_fused``.

Same semantics as ``ops.norm.adain`` (its plain version): per-(b, c) float32
mean and unbiased variance over H*W, modulated by the style statistics of
the 4 projected values of each channel.  One launch per call: the kernel
reads ``y_proj`` (B, 4C) itself and computes each plane's style statistics
(``y_mean``, ``y_scale = sqrt(var4 + eps)``) in float32, so the wrapper does
no PyTorch arithmetic on a CUDA tensor.  ``plan_adain`` gives the kernel's
shape: warps per plane, planes per block, and whether a plane is held on
chip or re-read.  Gradients recompute through the plain ``adain`` -- the JAX
package's own VJP.

The op is registered with ``torch.library`` as ``wut::adain``: its CUDA
implementation launches the kernel, its CPU implementation is the plain
version, its fake implementation gives the shape and dtype only (the plan,
which reads pointer alignment, is chosen inside the CUDA implementation),
so ``torch.export`` can trace a model that calls it and a program that
holds it runs wherever this module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from weather_unet_tpu_torch.kernels import _build
from weather_unet_tpu_torch.ops.norm import adain

launches = 0   # kernel launches so far (plain-version calls do not count)

adain_fused_ref = adain   # the plain version

MAX_THREADS = 512    # a block of the kernel (csrc/adain.cu kMaxThreads)
PER_THREAD = 32      # values a thread holds on chip (kPerThread)
BLOCK_WARPS = 8      # warps a block aims at when planes are small


@functools.lru_cache(maxsize=256)
def plan_adain(b: int, c: int, h: int, w: int, dtype, vec_ok: bool = True,
               warps: int = 0, on_chip: bool = True) -> dict:
    """The kernel's shape for x (b, c, h, w): ``vec`` elements a load (16
    bytes, or 1 where H*W is not a multiple of that or ``vec_ok`` is False),
    ``wp`` warps a plane (at least enough to hold the plane in registers at
    ``PER_THREAD`` values a thread, or ``warps`` if larger), ``ppb`` planes a
    block, and ``on_chip``: the plane is held in registers and read once;
    otherwise (a plane beyond 16 warps, or ``on_chip=False``) a block of 16
    warps re-reads it from device memory.  Mirrors csrc/adain.cu."""
    esize = torch.empty((), dtype=dtype).element_size()
    hw = h * w
    vec = 16 // esize if vec_ok and hw % (16 // esize) == 0 else 1
    need = max(1, -(-hw // (32 * PER_THREAD)))
    wp = max(need, warps)
    max_wp = MAX_THREADS // 32
    if on_chip and wp <= max_wp:
        ppb = max(1, min(b * c, BLOCK_WARPS // wp))
    else:
        wp, ppb, on_chip = max_wp, 1, False
    name = (f"{wp}w" + (f"x{ppb}p" if ppb > 1 else "") + f" v{vec}"
            + ("" if on_chip else " reread"))
    return {"name": name, "vec": vec, "wp": wp, "ppb": ppb,
            "on_chip": on_chip, "threads": 32 * wp * ppb,
            "smem": 2 * max_wp * 4, "grid": -(-(b * c) // ppb)}


def adain_plans(b: int, c: int, h: int, w: int, dtype) -> list:
    """Every plan the kernel takes for this shape, the chosen one first:
    twice the warps a plane, the re-reading path, and the scalar loads."""
    plans = [plan_adain(b, c, h, w, dtype)]
    for vec_ok in (True, False):
        wp = plans[0]["wp"]
        plans += [plan_adain(b, c, h, w, dtype, vec_ok, wp),
                  plan_adain(b, c, h, w, dtype, vec_ok, 2 * wp),
                  plan_adain(b, c, h, w, dtype, vec_ok, on_chip=False)]
    seen, out = set(), []
    for pl in plans:
        if pl["name"] not in seen:
            seen.add(pl["name"])
            out.append(pl)
    return out


@functools.cache
def _entry():
    lib = _build.library("adain")
    fn = lib.wut_adain
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def adain_kernel(x: torch.Tensor, y_proj: torch.Tensor, eps: float,
                 plan: dict = None) -> torch.Tensor:
    """Launch K1 on CUDA tensors: x (B, C, H, W) float32/bfloat16
    contiguous; y_proj (B, 4C) float32/bfloat16 contiguous.  ``plan``
    defaults to ``plan_adain``; one of ``adain_plans`` forces another."""
    global launches
    if x.dim() != 4 or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"adain kernel takes a 4-D float32/bfloat16 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    if y_proj.shape != (b, 4 * c) or y_proj.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"y_proj must be float32/bfloat16 of shape "
                         f"{(b, 4 * c)}, got {tuple(y_proj.shape)} "
                         f"{y_proj.dtype}")
    for t in (x, y_proj):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("adain kernel inputs must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError("adain kernel inputs must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if plan is None:
        plan = plan_adain(b, c, h, w, x.dtype,
                          vec_ok=x.data_ptr() % 16 == 0)
    if plan["vec"] > 1 and (x.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("adain kernel's 16-byte loads need 16-byte aligned "
                         "x and out")
    lib, fn = _entry()
    err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), y_proj.data_ptr(),
             _build.DTYPE_CODES[y_proj.dtype], out.data_ptr(), b * c, h * w,
             int(plan["vec"] > 1), plan["wp"], plan["ppb"],
             int(plan["on_chip"]), eps, x.device.index, _build.stream_of(x))
    _build.check_launch(lib, err, "adain")
    launches += 1
    return out


@torch.library.custom_op("wut::adain", mutates_args=(), device_types="cuda")
def adain_op(x: torch.Tensor, y_proj: torch.Tensor,
             eps: float) -> torch.Tensor:
    """K1 on CUDA tensors; a strided input is copied into the dense NCHW
    layout the kernel reads."""
    return adain_kernel(x.contiguous(), y_proj.contiguous(), eps)


@adain_op.register_kernel("cpu")
def _adain_cpu(x, y_proj, eps):
    return adain(x, y_proj, eps)


@adain_op.register_fake
def _adain_fake(x, y_proj, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _adain_setup(ctx, inputs, output):
    x, y_proj, eps = inputs
    ctx.save_for_backward(x, y_proj)
    ctx.eps = eps


def _adain_backward(ctx, g):
    x, y_proj = ctx.saved_tensors
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        yy = y_proj.detach().requires_grad_()
        gx, gy = torch.autograd.grad(adain(xx, yy, ctx.eps), (xx, yy), g)
    return gx, gy, None


adain_op.register_autograd(_adain_backward, setup_context=_adain_setup)


def adain_fused(x: torch.Tensor, y_proj: torch.Tensor, eps: float = 1e-5):
    """Drop-in for ``ops.norm.adain``: the K1 kernel on CUDA tensors, the
    plain version on CPU tensors; differentiable either way."""
    _build.is_cuda(x)          # refuses a device that is neither
    return adain_op(x, y_proj, eps)
