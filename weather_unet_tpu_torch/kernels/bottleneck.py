"""K4: fused eval-mode ResNet identity bottleneck (``csrc/bottleneck.cu``),
the port of ``weather_unet_tpu/kernels/bottleneck_pallas.py``.

``fused_bottleneck_eval(x, w1, b1, w2, b2, w3, b3)`` computes
``relu(conv1x1(relu(conv3x3(relu(conv1x1(x) + b1)) + b2)) + b3 + x)`` for
NCHW ``x`` in one launch, the two ``P``-channel intermediates staying on
chip.  The weights come from ``fold_bottleneck``, which folds each eval-mode
BatchNorm into the conv before it; products run in ``x``'s type, biases and
accumulators in float32, and the intermediates are rounded to ``x``'s type
before the next product.  ``bottleneck_eval_reference`` is the plain version:
the same arithmetic, rounding at the same points, in PyTorch ops.

``fused_resnet_eval(model)`` runs a whole frozen ResNet with every identity
block through the kernel and the stem, the four stride/projection blocks
and the head on folded convs (cuDNN), as the JAX package leaves them to
XLA.  Forward only: the frozen estimator takes no gradients.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from weather_unet_tpu_torch.kernels import _build
from weather_unet_tpu_torch.ops.convs import conv2d, max_pool

launches = 0   # kernel launches so far (plain-version calls do not count)


def fold_bn(weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Eval-mode BatchNorm as per-channel ``(scale, bias)``, float32:
    ``bn(z) = z * s + t`` with ``s = gamma / sqrt(var + eps)``,
    ``t = beta - mean * s``."""
    s = weight.float() / torch.sqrt(running_var.float() + eps)
    return s, bias.float() - running_mean.float() * s


def _fold_bn_of(sd: Mapping[str, torch.Tensor], name: str, eps: float):
    return fold_bn(sd[f"{name}.weight"], sd[f"{name}.bias"],
                   sd[f"{name}.running_mean"], sd[f"{name}.running_var"], eps)


def fold_bottleneck(sd: Mapping[str, torch.Tensor], eps: float = 1e-5):
    """State dict of one identity ``Bottleneck`` (keys ``conv{1,2,3}.weight``,
    ``bn{1,2,3}.{weight,bias,running_mean,running_var}``) -> the kernel's
    float32 weights ``(w1 (C, P), b1 (P,), w2 (9, P, P) as [tap][in][out],
    b2 (P,), w3 (P, C), b3 (C,))`` with each BN folded into the conv before
    it."""
    s1, t1 = _fold_bn_of(sd, "bn1", eps)
    s2, t2 = _fold_bn_of(sd, "bn2", eps)
    s3, t3 = _fold_bn_of(sd, "bn3", eps)
    k1 = sd["conv1.weight"].float()                 # (P, C, 1, 1) OIHW
    k2 = sd["conv2.weight"].float()                 # (P, P, 3, 3)
    k3 = sd["conv3.weight"].float()                 # (C, P, 1, 1)
    p = k2.shape[0]
    w1 = (k1[:, :, 0, 0] * s1[:, None]).t().contiguous()
    w2 = (k2 * s2[:, None, None, None]).permute(2, 3, 1, 0).reshape(9, p, p)
    w3 = (k3[:, :, 0, 0] * s3[:, None]).t().contiguous()
    return w1, t1, w2.contiguous(), t2, w3, t3


def bottleneck_eval_reference(x, w1, b1, w2, b2, w3, b3):
    """Plain version of the kernel: float32 products of operands rounded to
    ``x``'s type, the intermediates rounded to ``x``'s type, zero padding of
    ``t1``."""
    dt = x.dtype
    p = w1.shape[1]

    def rounded(w):
        return w.to(dt).float()

    def bias(b):
        return b.float()[None, :, None, None]

    k1 = rounded(w1).t()[:, :, None, None]                    # (P, C, 1, 1)
    k2 = rounded(w2).reshape(3, 3, p, p).permute(3, 2, 0, 1)  # (P, P, 3, 3)
    k3 = rounded(w3).t()[:, :, None, None]                    # (C, P, 1, 1)
    xf = x.float()
    t1 = F.relu(conv2d(xf, k1, padding=0) + bias(b1)).to(dt)
    t2 = F.relu(conv2d(t1.float(), k2, padding=1) + bias(b2)).to(dt)
    y = conv2d(t2.float(), k3, padding=0) + bias(b3) + xf
    return F.relu(y).to(dt)


@functools.cache
def _entry():
    lib = _build.library("bottleneck")
    fn = lib.wut_bottleneck
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def bottleneck_kernel(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Launch K4 on CUDA tensors: x (B, C, H, W) float32/bfloat16; w1 (C, P),
    w2 (9, P, P), w3 (P, C) of x's type; b1, b2 (P,), b3 (C,) float32; all
    contiguous; P and C multiples of 4."""
    global launches
    if x.dim() != 4 or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"bottleneck kernel takes a 4-D float32/bfloat16 x, "
                         f"got {tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    p = w1.shape[-1]
    if p % 4 or c % 4:
        raise ValueError(f"bottleneck kernel needs C and P to be multiples "
                         f"of 4, got C={c}, P={p}")
    checks = [("x", x, x.shape, x.dtype), ("w1", w1, (c, p), x.dtype),
              ("b1", b1, (p,), torch.float32), ("w2", w2, (9, p, p), x.dtype),
              ("b2", b2, (p,), torch.float32), ("w3", w3, (p, c), x.dtype),
              ("b3", b3, (c,), torch.float32)]
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)},"
                             f" got {tuple(t.shape)} {t.dtype}")
    for name, t, _, _ in checks:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("bottleneck kernel inputs must share one CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"bottleneck kernel input {name} must be "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"bottleneck kernel input {name} must be "
                             f"16-byte aligned")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib, fn = _entry()
    err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
             b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
             b3.data_ptr(), out.data_ptr(), b, c, p, h, w, x.device.index,
             _build.stream_of(x))
    _build.check_launch(lib, err, "bottleneck")
    launches += 1
    return out


def fused_bottleneck_eval(x, w1, b1, w2, b2, w3, b3):
    """``relu(bn3(conv3(relu(bn2(conv2(relu(bn1(conv1(x)))))))) + x)`` with
    all BNs folded (eval mode), NCHW; weights from ``fold_bottleneck``, cast
    to ``x``'s type here if they are not yet.  K4 on CUDA tensors, the plain
    version on CPU tensors."""
    if not _build.is_cuda(x):
        return bottleneck_eval_reference(x, w1, b1, w2, b2, w3, b3)
    dt = x.dtype
    return bottleneck_kernel(
        x.contiguous(), w1.to(dt), b1.float(), w2.to(dt), b2.float(),
        w3.to(dt), b3.float())


def _folded_conv(x, weight, bias, *, stride=1, padding=0, relu=True):
    """Conv with the eval BN folded into its weight (x's type) and a float32
    bias added to the result."""
    y = conv2d(x, weight, None, stride=stride, padding=padding).float()
    y = y + bias[None, :, None, None]
    return (F.relu(y) if relu else y).to(x.dtype)


class _FoldedBottleneck:
    """A stride/projection (or unfused identity) block on folded convs."""

    def __init__(self, block, dtype):
        sd = block.state_dict()

        def fold(conv, bn):
            s, t = _fold_bn_of(sd, bn, 1e-5)
            k = sd[f"{conv}.weight"].float() * s[:, None, None, None]
            return k.to(dtype), t

        self.stride = block.conv2.stride[0]
        self.convs = [fold(f"conv{i}", f"bn{i}") for i in (1, 2, 3)]
        self.down = (fold("downsample.0", "downsample.1")
                     if block.downsample is not None else None)

    def __call__(self, x):
        (k1, t1), (k2, t2), (k3, t3) = self.convs
        out = _folded_conv(x, k1, t1)
        out = _folded_conv(out, k2, t2, stride=self.stride, padding=1)
        out = _folded_conv(out, k3, t3, relu=False)
        idn = x
        if self.down is not None:
            idn = _folded_conv(x, *self.down, stride=self.stride, relu=False)
        return F.relu(out.float() + idn.float()).to(x.dtype)


class _FusedBottleneck:
    """An identity block through ``fused_bottleneck_eval``."""

    def __init__(self, block, dtype):
        self.weights = tuple(
            a.to(dtype) if a.dim() > 1 else a
            for a in fold_bottleneck(block.state_dict()))

    def __call__(self, x):
        return fused_bottleneck_eval(x, *self.weights)


def fused_resnet_eval(model, fuse_layers: Sequence[int] = (1, 2, 3, 4)):
    """Frozen (eval-mode) ResNet forward with every identity bottleneck of
    the layers in ``fuse_layers`` running the fused kernel, and the stem,
    the stride/projection blocks and the head on folded convs.

    The weights are folded here, once, from ``model``'s current parameters
    and running statistics, on the device they lie on.  Returns
    ``apply(images) -> logits`` for NCHW images; it matches
    ``model.eval()(images)``."""
    dt = model.dtype
    sd = model.state_dict()
    s, t = _fold_bn_of(sd, "bn1", 1e-5)
    stem = ((sd["conv1.weight"].float() * s[:, None, None, None]).to(dt), t)
    blocks = []
    for li, layer in enumerate(model.layers):
        for block in layer:
            fuse = block.downsample is None and li + 1 in fuse_layers
            blocks.append((_FusedBottleneck if fuse else _FoldedBottleneck)(
                block, dt))
    fc_w, fc_b = model.fc.weight.detach(), model.fc.bias.detach()

    @torch.inference_mode()
    def apply(images):
        x = _folded_conv(images.to(dt), *stem, stride=2, padding=3)
        x = max_pool(x, window=3, stride=2, padding=1)
        for block in blocks:
            x = block(x)
        return F.linear(x.mean(dim=(2, 3)), fc_w, fc_b)

    return apply
