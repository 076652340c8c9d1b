"""Shared building blocks with the reference's parameter layout (OIHW conv
weights, ``(out, in)`` linear weights) and PyTorch default init.

The dense layer is ``nn.Linear`` itself: the JAX package's ``TorchDense``
rebuilds exactly its init and ``x @ W.T + b``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from weather_unet_tpu_torch.kernels.upconv import upconv_block_fused
from weather_unet_tpu_torch.ops.convs import conv2d


class TorchConv(nn.Conv2d):
    """``nn.Conv2d`` whose forward also runs the decoder's split-concat form.

    With ``skip`` the weight spans ``Cx + Cskip`` input channels, ordered
    ``[x, skip]`` like the reference's ``cat([x, skip], 1)``, and is applied as
    ``conv(x, W[:, :Cx]) + conv(skip, W[:, Cx:])`` -- the same sum without
    materializing the concat.  The bias rides on the x-part conv, as in the
    JAX package.

    ``fused_upsample`` (3x3, stride 1, pad 1, needs ``skip``): ``x`` is the
    LOW-RES map before the 2x upsample, ``mod`` the ``(scale, shift)`` float32
    (B, Cx) AdaIN modulation, and the block entry runs through the fused
    kernel (``kernels/upconv.py``) -- ``conv(concat(upsample(x*scale+shift),
    skip))`` followed by the block's ReLU, all in the kernel, so the result
    is post-activation.  There the bias rides on the skip conv ``cb`` the
    kernel adds.
    """

    def forward(self, x, skip=None, fused_upsample: bool = False, mod=None):
        if skip is None:
            return conv2d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding)
        cx = x.shape[1]
        w = self.weight
        if fused_upsample:
            if (self.kernel_size != (3, 3) or self.stride != (1, 1)
                    or self.padding != (1, 1)):
                raise ValueError("fused_upsample requires a 3x3/stride-1/"
                                 "pad-1 conv")
            cb = conv2d(skip, w[:, cx:], self.bias, padding=1)
            scale, shift = mod
            return upconv_block_fused(x, w[:, :cx], cb, scale, shift,
                                      relu=True)
        out = conv2d(x, w[:, :cx], self.bias, stride=self.stride,
                     padding=self.padding)
        return out + conv2d(skip, w[:, cx:], None, stride=self.stride,
                            padding=self.padding)


class BatchNorm2d(nn.Module):
    """BatchNorm2d over NCHW with the JAX module's (= torch's) semantics and
    ``nn.BatchNorm2d``'s parameter and buffer names.

    Eval mode (``module.eval()``) normalizes with the running statistics.
    Train mode normalizes with the *biased* batch variance, computed in two
    passes (``mean((x - mean)^2)``: the one-pass form cancels for
    near-constant channels), and blends the *unbiased* one into
    ``running_var``: ``new = (1 - momentum) * old + momentum * batch``.
    Statistics and the normalization run in float32 whatever the input
    type; the result is cast back to it.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        xf = x.float()
        if self.training:
            n = x.shape[0] * x.shape[2] * x.shape[3]
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / max(n - 1, 1)))
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        inv = torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * inv[:, None, None]
        if self.weight is not None:
            y = (y * self.weight.float()[:, None, None]
                 + self.bias.float()[:, None, None])
        return y.to(x.dtype)
