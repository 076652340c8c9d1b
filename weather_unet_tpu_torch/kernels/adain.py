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

The split-statistics form serves spatial partitioning
(``parallel/spatial.py``), where a plane's rows lie on several shards:
``wut::adain_stats`` (``adain_stats_kernel``) writes each plane's float32
local mean and M2 from one read of the plane, the shards exchange them,
and ``wut::adain_apply`` (``adain_apply_kernel``) merges every shard's
statistics itself, as ``ops/norm.py::merge_plane_stats`` does and bit for
bit on the card, and modulates; ``adain_split_fused`` composes them, so a
site is two launches around the exchange.  Their launches are counted
apart (``stats_launches``, ``apply_launches``) and their gradients
recompute through the plain pieces.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import torch

from weather_unet_tpu_torch.kernels import _build
from weather_unet_tpu_torch.ops.norm import (
    adain, adain_from_shard_stats, adain_split, plane_stats)

launches = 0   # kernel launches so far (plain-version calls do not count)
# launches of the split-statistics form (spatial partitioning): the local
# statistics and the modulation with given statistics
stats_launches = 0
apply_launches = 0

adain_fused_ref = adain   # the plain version

MAX_THREADS = 512    # a block of the kernel (csrc/adain.cu kMaxThreads)
PER_THREAD = 32      # values a thread holds on chip (kPerThread)
MAX_SHARDS = 16      # shards whose statistics the apply kernel merges
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
    with _build.COUNT_LOCK:
        launches += 1
    return out


@functools.cache
def _split_entries():
    lib = _build.library("adain")
    st = lib.wut_adain_stats
    st.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    st.restype = ctypes.c_int
    ap = lib.wut_adain_apply
    ap.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    ap.restype = ctypes.c_int
    return lib, st, ap


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4 or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{what} takes a 4-D float32/bfloat16 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous CUDA x")


def adain_stats_kernel(x: torch.Tensor, plan: dict = None) -> torch.Tensor:
    """K1's split form, first launch: each plane's float32 local ``(mean,
    M2)`` (``ops.norm.plane_stats``) of a CUDA x (B, C, H, W), as (B, C,
    2).  ``plan`` defaults to ``plan_adain`` (one of ``adain_plans``
    forces another)."""
    global stats_launches
    _check_x(x, "adain stats kernel")
    b, c, h, w = x.shape
    stats = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return stats
    if plan is None:
        plan = plan_adain(b, c, h, w, x.dtype, vec_ok=x.data_ptr() % 16 == 0)
    if plan["vec"] > 1 and x.data_ptr() % 16:
        raise ValueError("adain stats kernel's 16-byte loads need a 16-byte "
                         "aligned x")
    lib, fn, _ = _split_entries()
    err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), stats.data_ptr(),
             b * c, h * w, int(plan["vec"] > 1), plan["wp"], plan["ppb"],
             int(plan["on_chip"]), x.device.index, _build.stream_of(x))
    _build.check_launch(lib, err, "adain stats")
    with _build.COUNT_LOCK:
        stats_launches += 1
    return stats


def _check_shards(shard_stats: torch.Tensor, counts, planes: tuple) -> list:
    """``counts`` as a list of ints after checking it against
    ``shard_stats``: float32 (n, *planes, 2) with n = len(counts), 1 <= n
    <= ``MAX_SHARDS``, every count at least 1.  More shards than the
    kernel merges is refused."""
    counts = [int(n) for n in counts]
    if not 1 <= len(counts) <= MAX_SHARDS:
        raise ValueError(f"the adain apply kernel merges 1 to {MAX_SHARDS} "
                         f"shards, got {len(counts)}")
    if min(counts) < 1:
        raise ValueError(f"shard counts must be positive, got {counts}")
    want = (len(counts), *planes, 2)
    if shard_stats.shape != want or shard_stats.dtype != torch.float32:
        raise ValueError(f"shard_stats must be float32 of shape {want}, got "
                         f"{tuple(shard_stats.shape)} {shard_stats.dtype}")
    return counts


def adain_apply_kernel(x: torch.Tensor, y_proj: torch.Tensor,
                       shard_stats: torch.Tensor, counts, eps: float,
                       plan: dict = None, merged: bool = False):
    """K1's split form, second launch, on CUDA tensors: the n shards' local
    float32 ``(mean, M2)`` ``shard_stats`` (n, B, C, 2) over ``counts[k]``
    values of a plane each, merged in the kernel
    (``ops.norm.merge_plane_stats``, bit for bit), and x (B, C, H, W)
    modulated with them and the style statistics of ``y_proj`` (B, 4C)
    (``ops.norm.adain_from_shard_stats``).  Returns the output, and with
    ``merged`` also the merged float32 ``(mean, unbiased variance)`` (B,
    C, 2) the kernel modulated with."""
    global apply_launches
    counts = _check_shards(shard_stats, counts, tuple(x.shape[:2]))
    _check_x(x, "adain apply kernel")
    b, c, h, w = x.shape
    if y_proj.shape != (b, 4 * c) or y_proj.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"y_proj must be float32/bfloat16 of shape "
                         f"{(b, 4 * c)}, got {tuple(y_proj.shape)} "
                         f"{y_proj.dtype}")
    for t in (y_proj, shard_stats):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("adain apply kernel inputs must be contiguous "
                             "on x's device")
    out = torch.empty_like(x)
    stats = (torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
             if merged else None)
    if x.numel() == 0:
        return (out, stats) if merged else out
    if plan is None:
        plan = plan_adain(b, c, h, w, x.dtype, vec_ok=x.data_ptr() % 16 == 0)
    if plan["vec"] > 1 and (x.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("adain apply kernel's 16-byte loads need 16-byte "
                         "aligned x and out")
    lib, _, fn = _split_entries()
    err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), y_proj.data_ptr(),
             _build.DTYPE_CODES[y_proj.dtype], shard_stats.data_ptr(),
             len(counts), (ctypes.c_longlong * len(counts))(*counts),
             stats.data_ptr() if merged else None, out.data_ptr(), b * c,
             h * w, int(plan["vec"] > 1), plan["wp"], plan["ppb"], eps,
             x.device.index, _build.stream_of(x))
    _build.check_launch(lib, err, "adain apply")
    with _build.COUNT_LOCK:
        apply_launches += 1
    return (out, stats) if merged else out


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


# --------------------------------------------------- split-statistics form

@torch.library.custom_op("wut::adain_stats", mutates_args=(),
                         device_types="cuda")
def adain_stats_op(x: torch.Tensor) -> torch.Tensor:
    """K1's local plane statistics on a CUDA tensor (made contiguous)."""
    return adain_stats_kernel(x.contiguous())


@adain_stats_op.register_kernel("cpu")
def _adain_stats_cpu(x):
    return plane_stats(x)


@adain_stats_op.register_fake
def _adain_stats_fake(x):
    return x.new_empty((x.shape[0], x.shape[1], 2), dtype=torch.float32)


def _stats_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _stats_backward(ctx, g):
    (x,) = ctx.saved_tensors
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        (gx,) = torch.autograd.grad(plane_stats(xx), (xx,), g)
    return gx


adain_stats_op.register_autograd(_stats_backward, setup_context=_stats_setup)


@torch.library.custom_op("wut::adain_apply", mutates_args=(),
                         device_types="cuda")
def adain_apply_op(x: torch.Tensor, y_proj: torch.Tensor,
                   shard_stats: torch.Tensor, counts: List[int],
                   eps: float) -> torch.Tensor:
    """K1's merge of the shards' statistics and its modulation with them on
    CUDA tensors (made contiguous)."""
    return adain_apply_kernel(x.contiguous(), y_proj.contiguous(),
                              shard_stats.contiguous(), counts, eps)


@adain_apply_op.register_kernel("cpu")
def _adain_apply_cpu(x, y_proj, shard_stats, counts, eps):
    return adain_from_shard_stats(x, y_proj, shard_stats, counts, eps)


@adain_apply_op.register_fake
def _adain_apply_fake(x, y_proj, shard_stats, counts, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _apply_setup(ctx, inputs, output):
    x, y_proj, shard_stats, counts, eps = inputs
    ctx.save_for_backward(x, y_proj, shard_stats)
    ctx.counts, ctx.eps = counts, eps


def _apply_backward(ctx, g):
    x, y_proj, shard_stats = ctx.saved_tensors
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (x, y_proj, shard_stats)]
        grads = torch.autograd.grad(
            adain_from_shard_stats(*xs, ctx.counts, ctx.eps), xs, g)
    return (*grads, None, None)


adain_apply_op.register_autograd(_apply_backward, setup_context=_apply_setup)


def adain_split_fused(x: torch.Tensor, y_proj: torch.Tensor, eps: float,
                      exchange, counts):
    """``ops.norm.adain_split`` through K1's split form: the local
    statistics and the merge with the modulation are K1's two launches on
    CUDA tensors (their plain versions on CPU tensors), the exchange alone
    between them; the gradients recompute through the plain pieces."""
    _build.is_cuda(x)          # refuses a device that is neither
    return adain_split(x, y_proj, eps, exchange, counts,
                       stats=adain_stats_op, modulate=adain_apply_op)
