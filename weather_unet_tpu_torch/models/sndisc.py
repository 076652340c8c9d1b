"""Spectral-norm projection discriminator -- the port of
``weather_unet_tpu/models/sndisc.py`` (reference ``disc.py:8-38``).

Four ``SNDoubleConv`` stages (SN conv3x3 stride 1 -> SN conv3x3 stride 2 ->
LeakyReLU(0.2), no activation between the two convs) at 3->64->128->256->512,
a global *sum* pool, an SN linear 512->1 (``l``), and projection-cGAN
conditioning ``out += sum(embed(c) * phi(x))`` with an SN linear
num_classes->512 (``embed``).  Conv weights are xavier-uniform with gain
sqrt(2), the two heads with gain 1.

The power-iteration ``u`` vectors are the modules' ``weight_u`` buffers and
advance once per forward with ``update_stats=True`` (3 D forwards per
combined GAN step); a forward without it reads them and changes nothing
(the GAN evaluation step).  Parameters stay float32; ``dtype`` is the
compute dtype.  Modules run NCHW; state_dict names are the reference's
(``conv{1..4}.{0,1}.weight_orig/bias/weight_u/weight_v``, ``l.*``,
``embed.*``).

Returns ``(out, [c1, c2, c3, c4])``: the logits (B, 1) and the per-stage
feature maps the reference exposes for feature matching.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from weather_unet_tpu_torch.models.common import SNConv, SNDense
from weather_unet_tpu_torch.ops.convs import global_sum_pool


class SNDoubleConv(nn.Sequential):
    """SN conv3x3 s1 (C -> C) -> SN conv3x3 s2 (C -> F) -> LeakyReLU(0.2), in
    the reference's ``nn.Sequential`` layout (convs at indices 0 and 1)."""

    def __init__(self, in_ch: int, features: int,
                 generator: Optional[torch.Generator] = None):
        gain = math.sqrt(2.0)
        super().__init__(
            SNConv(in_ch, in_ch, 3, 1, 1, gain=gain, generator=generator),
            SNConv(in_ch, features, 3, 2, 1, gain=gain, generator=generator),
            nn.LeakyReLU(0.2))

    def forward(self, x, update_stats: bool = False):
        conv1, conv2, act = self
        return act(conv2(conv1(x, update_stats), update_stats))


class SNDisc(nn.Module):
    """Projection discriminator with explicit spectral-norm state.  Marked by
    ``parallel/spatial.py::spatial_`` (``sp``), x holds a shard's rows and
    the global sum pool sums over the shards, so the logits are the whole
    image's on every shard (the feature maps stay the shard's rows)."""

    sp = None

    def __init__(self, num_classes: int = 5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.conv1 = SNDoubleConv(3, 64, generator)
        self.conv2 = SNDoubleConv(64, 128, generator)
        self.conv3 = SNDoubleConv(128, 256, generator)
        self.conv4 = SNDoubleConv(256, 512, generator)
        self.l = SNDense(512, 1, gain=1.0, generator=generator)
        self.embed = SNDense(num_classes, 512, gain=1.0, generator=generator)

    def forward(self, x, c, *, update_stats: bool = False):
        """x: images (B, 3, H, W); c: conditions (B, num_classes)."""
        x = x.to(self.dtype)
        c1 = self.conv1(x, update_stats)
        c2 = self.conv2(c1, update_stats)
        c3 = self.conv3(c2, update_stats)
        c4 = self.conv4(c3, update_stats)
        feat = global_sum_pool(c4)                        # (B, 512)
        if self.sp is not None:
            feat = self.sp.sum(feat)
        out = self.l(feat, update_stats)
        e_c = self.embed(c.to(self.dtype), update_stats)
        out = out + (e_c * feat).sum(dim=1, keepdim=True)
        return out, [c1, c2, c3, c4]
