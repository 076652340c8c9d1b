"""ResNet in torchvision's layout -- the port of
``weather_unet_tpu/models/resnet.py``, the reference's weather estimator and
classifier backbone (``torchvision.models.resnet101``).

ResNet v1.5: conv7x7/2 -> BN -> ReLU -> maxpool3x3/2 -> layers [3, 4, 23, 3]
of bottlenecks (stride on the 3x3 conv) -> global average pool -> fc.
Written by hand (torchvision is not a dependency) with torchvision's
state_dict names (``conv1``, ``bn1``, ``layer{1..4}.{i}.conv{1,2,3}``,
``.bn{1,2,3}``, ``.downsample.0/.1``, ``fc``), so a reference state dict
loads with ``strict=True``.

Modules run NCHW.  ``module.eval()`` / ``module.train()`` select running or
batch statistics (``models/common.py::BatchNorm2d``).  ``dtype`` is the
type of the activations, and of the conv and fc weights unless
``param_dtype`` is given (training passes float32: a bfloat16 model then
trains on float32 master weights cast as each layer runs, like the JAX
package's ``param_dtype``); the BatchNorm parameters and statistics stay
float32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from weather_unet_tpu_torch.models.common import BatchNorm2d, TorchConv
from weather_unet_tpu_torch.ops.convs import max_pool


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int, padding: int,
          generator: Optional[torch.Generator]) -> TorchConv:
    """Bias-free conv with torchvision's ``kaiming_normal_(mode='fan_out',
    nonlinearity='relu')`` init drawn from ``generator``."""
    conv = TorchConv(in_ch, out_ch, kernel, stride=stride, padding=padding,
                     bias=False)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu",
                            generator=generator)
    return conv


class Bottleneck(nn.Module):
    """torchvision Bottleneck (expansion 4, stride on the 3x3 conv)."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _conv(in_ch, planes, 1, 1, 0, generator)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1, generator)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, out_ch, 1, 1, 0, generator)
        self.bn3 = BatchNorm2d(out_ch)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                _conv(in_ch, out_ch, 1, stride, 0, generator),
                BatchNorm2d(out_ch))

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Generic torchvision-style bottleneck ResNet.  ``generator`` seeds the
    conv and fc init (the global generator when None)."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 23, 3),
                 num_classes: int = 5, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.block_counts = tuple(block_counts)
        self.num_classes = num_classes
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3, generator)
        self.bn1 = BatchNorm2d(64)
        in_ch, planes = 64, 64
        for li, n_blocks in enumerate(self.block_counts):
            stride = 1 if li == 0 else 2
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(
                    in_ch, planes, stride=stride if bi == 0 else 1,
                    downsample=(bi == 0), generator=generator))
                in_ch = planes * Bottleneck.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.fc = nn.Linear(in_ch, num_classes)
        # nn.Linear's default init, redrawn from the explicit generator
        nn.init.kaiming_uniform_(self.fc.weight, a=math.sqrt(5),
                                 generator=generator)
        bound = 1.0 / math.sqrt(in_ch)
        with torch.no_grad():
            self.fc.bias.uniform_(-bound, bound, generator=generator)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(dtype if param_dtype is None else param_dtype)

    @property
    def layers(self):
        return tuple(getattr(self, f"layer{li + 1}")
                     for li in range(len(self.block_counts)))

    def forward(self, x, *, features_only: bool = False):
        """x: images (B, 3, H, W); returns logits (B, num_classes), or the
        pooled (B, 2048) features with ``features_only``."""
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, window=3, stride=2, padding=1)
        for layer in self.layers:
            x = layer(x)
        x = x.mean(dim=(2, 3))          # adaptive avg pool (1, 1)
        if features_only:
            return x
        return F.linear(x, self.fc.weight.to(x.dtype),
                        self.fc.bias.to(x.dtype))


def ResNet101(num_classes: int = 5, dtype: torch.dtype = torch.float32,
              generator: Optional[torch.Generator] = None,
              param_dtype: Optional[torch.dtype] = None) -> ResNet:
    """ResNet-101, the reference's estimator/classifier backbone."""
    return ResNet((3, 4, 23, 3), num_classes, dtype, generator, param_dtype)


def ResNet50(num_classes: int = 5, dtype: torch.dtype = torch.float32,
             generator: Optional[torch.Generator] = None,
             param_dtype: Optional[torch.dtype] = None) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, dtype, generator, param_dtype)
