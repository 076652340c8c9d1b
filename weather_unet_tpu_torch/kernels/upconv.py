"""K3: fused 2x align-corners upsample + 3x3 conv (``csrc/upconv.cu``), the
port of ``weather_unet_tpu/kernels/upconv_pallas.py``.

``upsample2x_conv3x3(x, w, cb=, scale=, shift=, relu=)`` computes
``act(conv3x3_pad1(upsample2x_ac(x * scale + shift), w) + cb)`` without
writing the upsampled or the modulated tensor, NCHW in and out, OIHW
weights, no bias (in the decoder the bias rides on the skip-path conv
``cb``).  The plain version ``upsample2x_conv3x3_ref`` is that chain in
PyTorch ops.  Gradients recompute through the plain version, as the JAX
package's VJPs do.

On CUDA tensors one of two kernels runs, by a rule on dtype and shape alone
(``takes_tensor_cores``): ``C`` a multiple of 16 goes to the tensor-core
kernel (an implicit GEMM with ``mma.sync``, the weights pre-arranged by
``pack_upconv_weight``, the tile chosen by ``plan_upconv``), other channel
counts to the CUDA-core kernel.  bfloat16 runs bf16 operands, k in steps of
16; float32 runs split float32 ("3xTF32", ``kernels/bottleneck.py::
split_tf32``), k in steps of 8: the patch is blended and modulated in
float32 and stays float32, split on the A fragment, and the weights are
split by ``pack_upconv_weight(..., split=True)``; three TF32 mmas a product
keep it within ~2^-21 of the float32 product, inside float32's bar of 1e-5
* max|y|, which a single TF32 product (2^-11) would miss.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from weather_unet_tpu_torch.kernels import _build
from weather_unet_tpu_torch.kernels.bottleneck import split_tf32
from weather_unet_tpu_torch.ops.convs import conv2d
from weather_unet_tpu_torch.ops.resize import (
    _tap_tables, upsample_bilinear_align_corners)

launches = 0   # kernel launches so far (plain-version calls do not count)
tensor_core_launches = 0   # those of them that ran the tensor-core kernel
f32_tensor_core_launches = 0   # ... and of those, the float32 (3xTF32) form

SMEM_LIMIT = 232_448   # bytes of shared memory a block can opt in to (sm_90)


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


def takes_tensor_cores(dtype, c: int) -> bool:
    """The rule that picks the CUDA kernel: bfloat16 and float32 with ``C``
    a multiple of 16 run on the tensor cores, other channel counts on the
    CUDA cores."""
    return (dtype in (torch.bfloat16, torch.float32) and c >= 16
            and c % 16 == 0)


def pack_upconv_weight(weight: torch.Tensor,
                       split: bool = False) -> torch.Tensor:
    """OIHW ``(O, C, 3, 3)`` -> the tensor-core kernel's ``(9, O, C)`` as
    [tap][out][in], the reduction index contiguous: a permutation.  With
    ``split`` (float32) ``(2, 9, O, C)``: the hi and lo parts of
    ``split_tf32``, which the float32 tensor-core kernel streams."""
    o, c = weight.shape[:2]
    packed = weight.permute(2, 3, 0, 1).reshape(9, o, c).contiguous()
    if split:
        if weight.dtype != torch.float32:
            raise ValueError(f"split weights are float32, not {weight.dtype}")
        packed = torch.stack(split_tf32(packed))
    return packed


def unpack_upconv_weight(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_upconv_weight``: split weights come back as
    ``hi + lo``."""
    if packed.dim() == 4:
        packed = packed[0] + packed[1]
    _, o, c = packed.shape
    return packed.reshape(3, 3, o, c).permute(2, 3, 0, 1).contiguous()


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


@functools.lru_cache(maxsize=128)
def plan_upconv(c: int, o: int, smem_limit: int = SMEM_LIMIT,
                esize: int = 2, wide: Optional[bool] = None) -> dict:
    """The tensor-core kernel's plan for ``C`` input and ``O`` output
    channels of ``esize``-byte elements (2: bf16, 4: float32): 8 warps of
    64 pixels x 32 channels each.  A wide block owns 8x16 pixels x 128
    channels (the patch is built ``ceil(O / 128)`` times per tile), a narrow
    one 16x16 pixels x 64 channels (less halo per pixel).  By default
    (``wide=None``) bf16 takes the wide block where O > 64, and float32
    always the narrow one: at the cUNet's decoder sites (256x256 input, B=16)
    it measured 4.56 against 5.05 ms (O = 256) and 4.70 against 5.18 (O =
    128) on an H100 (tools/compare_tc_kernels.py).  A chunk of k is one mma
    step, 32 bytes: 16 bf16 or 8 float32 channels; float32's weight ring
    holds hi and lo.  Mirrors csrc/upconv.cu."""
    piece = 16 // esize                # elements of 16 bytes: a row's pad
    kc = 2 * piece                     # tc::Chunk<E>::kKC
    ldk = kc + piece                   # ... kLDK, padded row of patch, ring
    parts = 2 if esize == 4 else 1     # weight copies in the ring
    if wide is None:
        wide = o > 64 and esize == 2
    th, tw, wgn = (8, 16, 4) if wide else (16, 16, 2)
    nb, m, npos = 32 * wgn, th * tw, (th + 2) * (tw + 2)
    lh, rs = th // 2 + 3, _round_up(tw // 2 + 3 + piece - 1, piece)
    off_mod = _round_up(_round_up(npos * 4, 8) + npos * 8, 16)
    off_patch = _round_up(off_mod + c * 8, 128)
    off_raw = off_patch + 2 * npos * ldk * esize
    off_w = off_raw + 2 * kc * lh * rs * esize
    smem = max(off_w + 3 * 3 * nb * ldk * esize * parts,
               off_patch + nb * (m + 4) * 4)
    if smem > smem_limit:
        raise ValueError(f"the upconv kernel's tile needs {smem} bytes of "
                         f"shared memory at C={c}, over {smem_limit}")
    return {"name": f"{th}x{tw}x{nb}", "th": th, "tw": tw, "wgn": wgn,
            "nb": nb, "kc": kc, "esize": esize, "lh": lh, "rs": rs,
            "off_mod": off_mod,
            "off_patch": off_patch, "off_raw": off_raw, "off_w": off_w,
            "smem": smem}


@functools.cache
def _entry():
    lib = _build.library("upconv")
    fn = lib.wut_upconv
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tc = {}   # element size -> the tensor-core entry
    for esize, entry in ((2, lib.wut_upconv_tc), (4, lib.wut_upconv_tc_f32)):
        entry.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 17
                          + [ctypes.c_void_p])
        entry.restype = ctypes.c_int
        tc[esize] = entry
    return lib, fn, tc


def _ptr(t):
    return None if t is None else t.data_ptr()


def upconv_kernel(x, weight, cb=None, scale=None, shift=None,
                  relu: bool = False, plan: Optional[dict] = None,
                  cuda_cores: bool = False) -> torch.Tensor:
    """Launch K3 on CUDA tensors.  x (B, C, H, W) and cb (B, O, 2H, 2W)
    contiguous, weight (O, C, 3, 3), all of one dtype (float32/bfloat16);
    scale, shift (B, C) float32 contiguous, both or neither.  C a multiple
    of 16 runs the tensor-core kernel (float32 as split float32), other
    channel counts the CUDA-core kernel (``takes_tensor_cores``).  ``plan``
    (a ``plan_upconv`` at x's element size) forces the tensor-core kernel's
    tile; ``cuda_cores`` runs the CUDA-core kernel at any shape (to time
    the kernel a tensor-core form replaces)."""
    global launches, tensor_core_launches, f32_tensor_core_launches
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
    idx, frac = _tap_tables(h, w, x.device)
    lib, fn, tc = _entry()
    if takes_tensor_cores(x.dtype, c) and not cuda_cores:
        f32 = x.dtype == torch.float32
        esize = 4 if f32 else 2
        if x.data_ptr() % 16 or (cb is not None
                                 and cb.data_ptr() % (2 * esize)):
            raise ValueError("upconv kernel inputs must be 16-byte aligned")
        if plan is None:
            plan = plan_upconv(c, o, esize=esize)
        if plan["esize"] != esize:
            raise ValueError(f"plan {plan['name']} is for {plan['esize']}-"
                             f"byte elements, x has {esize}")
        w_t = pack_upconv_weight(weight, f32)   # (9, O, C), (2, 9, O, C)
        err = tc[esize](x.data_ptr(), w_t.data_ptr(), _ptr(cb), _ptr(scale),
                 _ptr(shift), idx.data_ptr(), frac.data_ptr(), out.data_ptr(),
                 b, c, h, w, o, int(relu), plan["th"], plan["tw"],
                 plan["wgn"], plan["lh"], plan["rs"], plan["off_mod"],
                 plan["off_patch"], plan["off_raw"], plan["off_w"],
                 plan["smem"], x.device.index, _build.stream_of(x))
        _build.check_launch(lib, err, "upconv (tensor cores)")
        tensor_core_launches += 1
        f32_tensor_core_launches += f32
    else:
        w_t = weight.permute(1, 2, 3, 0).contiguous()     # (C, 3, 3, O)
        err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), w_t.data_ptr(),
                 _ptr(cb), _ptr(scale), _ptr(shift), idx.data_ptr(),
                 frac.data_ptr(), out.data_ptr(), b, c, h, w, o, int(relu),
                 x.device.index, _build.stream_of(x))
        _build.check_launch(lib, err, "upconv")
    launches += 1
    return out


@torch.library.custom_op("wut::upconv", mutates_args=(), device_types="cuda")
def upconv_op(x: torch.Tensor, weight: torch.Tensor,
              cb: Optional[torch.Tensor], scale: Optional[torch.Tensor],
              shift: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """K3 on CUDA tensors, a registered op so that ``torch.export`` keeps
    it as one node (``core/aot.py`` exports the ``fuse_upconv`` forward);
    strided x, cb, scale and shift are copied into the dense layout the
    kernel reads."""
    def dense(t):
        return None if t is None else t.contiguous()

    return upconv_kernel(x.contiguous(), weight, dense(cb), dense(scale),
                         dense(shift), relu)


@upconv_op.register_kernel("cpu")
def _upconv_cpu(x, weight, cb, scale, shift, relu):
    return upsample2x_conv3x3_ref(x, weight, cb=cb, scale=scale, shift=shift,
                                  relu=relu)


@upconv_op.register_fake
def _upconv_fake(x, weight, cb, scale, shift, relu):
    b, _, h, w = x.shape
    return x.new_empty((b, weight.shape[0], 2 * h, 2 * w))


def _upconv_setup(ctx, inputs, output):
    x, weight, cb, scale, shift, relu = inputs
    ctx.save_for_backward(x, weight, cb, scale, shift)
    ctx.relu = relu


def _upconv_backward(ctx, g):
    """Gradients recompute through the plain version."""
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


upconv_op.register_autograd(_upconv_backward, setup_context=_upconv_setup)


def upsample2x_conv3x3(x, weight, *, cb=None, scale=None, shift=None,
                       relu: bool = False):
    """``conv3x3_pad1(upsample_2x_align_corners(x))`` without the upsample;
    optional modulation ``scale/shift`` (B, C), skip-path term ``cb`` and
    ReLU.  K3 on CUDA tensors, the plain version on CPU tensors;
    differentiable either way (the registered op ``wut::upconv``)."""
    _build.is_cuda(x)          # refuses a device that is neither
    return upconv_op(x, weight, cb, scale, shift, relu)


def upconv_block_fused(x, weight, cb, scale, shift, relu: bool = True):
    """Fused decoder-block entry: modulate + upsample + conv + cb + ReLU."""
    return upsample2x_conv3x3(x, weight, cb=cb, scale=scale, shift=shift,
                              relu=relu)
