"""FID Inception-v3 -- the port of ``weather_unet_tpu/models/inception_fid.py``
(the TTUR / pytorch-fid network, reference ``eval/inception.py``).

The patched torchvision Inception-v3 of the original TF FID code:

* the pool branches of blocks A, C and E divide by the number of valid
  window elements (``count_include_pad=False``),
* Mixed_7c pools its last branch with *max* where torchvision averages,
* the input (a float batch in [0, 1]) is resized to 299x299 (bilinear,
  align_corners=False) and mapped to [-1, 1] inside the forward,
* features are the 2048-d pool3 activations; ``with_logits`` adds the fc
  head (1008-way in the TF-ported FID checkpoint, 1000-way in torchvision's
  ImageNet weights).

``tf_variant=False`` is stock torchvision ``inception_v3``
(``transform_input=False``): every average pool counts the padding and
Mixed_7c averages too -- the network of the reference Inception Score.

Every conv is bias-free, followed by BatchNorm (eps 1e-3) and ReLU
(``BasicConv2d``).  Parameter names are pytorch-fid's and torchvision's
(``Mixed_5b.branch1x1.conv.weight``, ``...bn.running_mean``, ``fc.weight``),
so their state dicts load with ``strict=True`` (``compat/torch_io.py::
inception_state_dict`` drops torchvision's training-only ``AuxLogits``).
Modules run NCHW.  ``dtype`` is the compute type: conv and fc weights stay
float32 and are cast as each layer runs; BatchNorm computes in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from weather_unet_tpu_torch.models.common import BatchNorm2d, TorchConv
from weather_unet_tpu_torch.ops import inits
from weather_unet_tpu_torch.ops.convs import global_avg_pool, max_pool
from weather_unet_tpu_torch.ops.resize import resize_bilinear_torch


def avg_pool_3x3_s1(x: torch.Tensor, count_include_pad: bool):
    """3x3 stride-1 pad-1 average pool; ``count_include_pad=False`` divides
    by the number of valid (non-padding) window elements (TF semantics)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1,
                        count_include_pad=count_include_pad)


class BasicConv2d(nn.Module):
    """Bias-free conv, BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = TorchConv(in_ch, out_ch, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = BatchNorm2d(out_ch, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int,
                 tf_variant: bool = True):
        super().__init__()
        self.tf_variant = tf_variant
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_3x3_s1(x, not self.tf_variant))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int,
                 tf_variant: bool = True):
        super().__init__()
        c7 = channels_7x7
        self.tf_variant = tf_variant
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_3x3_s1(x, not self.tf_variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, max_pool(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_kind`` 'avg' (Mixed_7b, FIDInceptionE_1) or 'max' (Mixed_7c in
    the FID network, FIDInceptionE_2)."""

    def __init__(self, in_ch: int, pool_kind: str = "avg",
                 tf_variant: bool = True):
        super().__init__()
        self.pool_kind, self.tf_variant = pool_kind, tf_variant
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_kind == "avg":
            bp = avg_pool_3x3_s1(x, not self.tf_variant)
        else:
            bp = max_pool(x, 3, 1, 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """Pool3 (2048-d) feature extractor; ``with_logits=True`` returns the fc
    head's ``num_logits`` logits instead.  Takes NCHW float images in
    [0, 1]: ``resize_input`` resizes them to 299x299, ``normalize_input``
    maps them to [-1, 1].  ``generator`` seeds the init (PyTorch's default
    distributions, ``ops/inits.py``); BatchNorm starts at scale 1, shift 0,
    running mean 0 and variance 1, as in the JAX package."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True,
                 with_logits: bool = False, num_logits: int = 1008,
                 tf_variant: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.with_logits = with_logits
        self.tf_variant = tf_variant
        self.dtype = dtype
        tf = tf_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, tf)
        self.Mixed_5c = InceptionA(256, 64, tf)
        self.Mixed_5d = InceptionA(288, 64, tf)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, tf)
        self.Mixed_6c = InceptionC(768, 160, tf)
        self.Mixed_6d = InceptionC(768, 160, tf)
        self.Mixed_6e = InceptionC(768, 192, tf)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", tf)
        self.Mixed_7c = InceptionE(2048, "max" if tf else "avg", tf)
        if with_logits:
            self.fc = nn.Linear(2048, num_logits)
        if generator is not None:
            self._init_from(generator)

    @torch.no_grad()
    def _init_from(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(inits.torch_kernel_init(m.weight.shape,
                                                       generator))
                if m.bias is not None:
                    m.bias.copy_(inits.torch_bias_init_for(
                        m.weight[0].numel())(m.bias.shape, generator))

    def forward(self, x):
        """x: (B, 3, H, W) float in [0, 1] -> (B, 2048) pool3 features, or
        (B, num_logits) logits, in ``dtype``."""
        if self.resize_input:
            # the reference resizes with align_corners=False
            # (eval/inception.py:146-150)
            x = resize_bilinear_torch(x, 299, 299, align_corners=False)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = x.to(self.dtype)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        feats = global_avg_pool(x)
        if self.with_logits:
            return F.linear(feats, self.fc.weight.to(feats.dtype),
                            self.fc.bias.to(feats.dtype))
        return feats


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, x: torch.Tensor) -> nn.Module:
    """Set every BatchNorm's running statistics to those of one batch ``x``
    (train-mode forward with momentum 1), then return the model in eval
    mode.  A random deep network with BatchNorm at its initial statistics
    shrinks or grows its activations layer by layer; calibrated, they stay
    near unit scale, so comparisons of its outputs mean something."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    try:
        model(x)
    finally:
        for bn, m in zip(bns, momenta):
            bn.momentum = m
        model.eval()
    return model
