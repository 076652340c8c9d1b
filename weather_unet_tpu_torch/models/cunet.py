"""Conditional U-Net generator -- the port of
``weather_unet_tpu/models/cunet.py`` (reference ``cunet.py``).

* encoder: 4 x ``RDoubleConv`` (conv3x3+ReLU x2) at 3->64->128->256->512 with
  2x2 max-pool between stages,
* each decoder stage: AdaIN conditioned on the weather vector, bilinear 2x
  upsample (align_corners=True), dropout (train mode only), skip-concat in
  ``[x, skip]`` order, then ``RDoubleConv``,
* 1x1 conv to 3 channels + tanh.

Modules run NCHW; parameter names are the reference state_dict's
(``dconv_down{1..4}``, ``dconv_up{3,2,1}``, ``adain{i}.l1``, ``adain{i}.emb``,
``conv_last``), so a reference ``.pt`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from weather_unet_tpu_torch.kernels.adain import adain_fused
from weather_unet_tpu_torch.kernels.upsample import upsample2x_fused
from weather_unet_tpu_torch.models.common import BatchNorm2d, TorchConv
from weather_unet_tpu_torch.ops import inits
from weather_unet_tpu_torch.ops.convs import max_pool_2x2
from weather_unet_tpu_torch.ops.dropout import make_dropout
from weather_unet_tpu_torch.ops.norm import adain, adain_scale_shift
from weather_unet_tpu_torch.ops.resize import upsample_bilinear_align_corners


class RDoubleConv(nn.Sequential):
    """(conv3x3 -> ReLU) x 2, padding 1 -- reference ``nn.Sequential`` layout
    (parameters at indices 0 and 2).  With ``skip`` the first conv runs in
    split-concat form; with ``fused_upsample`` it runs through the fused
    upsample+conv kernel, ReLU included."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(TorchConv(in_ch, features, 3, padding=1), nn.ReLU(),
                         TorchConv(features, features, 3, padding=1),
                         nn.ReLU())

    def forward(self, x, skip=None, fused_upsample: bool = False,
                scale_shift=None):
        conv1, _, conv2, _ = self
        if fused_upsample:
            x = conv1(x, skip, fused_upsample=True, scale_shift=scale_shift)
        else:
            x = F.relu(conv1(x, skip))
        return F.relu(conv2(x))


class DoubleConvDown(nn.Module):
    """The reference's ``double_conv``: 3x3 conv (in -> in), 3x3 stride-2
    conv (in -> features), affine-less BatchNorm, LeakyReLU(0.2).  No model
    path uses it; the JAX package keeps it for the reference's surface.
    ``generator`` seeds the convs' init as ``ConditionalUNet``'s does."""

    def __init__(self, in_channels: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = TorchConv(in_channels, in_channels, 3, padding=1)
        self.conv2 = TorchConv(in_channels, features, 3, stride=2, padding=1)
        self.bn = BatchNorm2d(features, affine=False)
        if generator is not None:
            with torch.no_grad():
                for conv in (self.conv1, self.conv2):
                    conv.weight.copy_(inits.torch_kernel_init(
                        conv.weight.shape, generator))
                    conv.bias.copy_(inits.torch_bias_init_for(
                        conv.weight[0].numel())(conv.bias.shape, generator))

    def forward(self, x, *, train: bool = False):
        x = self.conv2(self.conv1(x))
        return F.leaky_relu(self.bn(x, train=train), 0.2)


class UpsampleBox(nn.Module):
    """The reference's ``upsample_box``: 2x bilinear upsample
    (align_corners), then affine-less BatchNorm.  ``use_pallas`` runs the
    upsample through K2 (``kernels/upsample.py``), as in
    ``ConditionalUNet``.  No model path uses it."""

    def __init__(self, num_features: int, use_pallas: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        self.bn = BatchNorm2d(num_features, affine=False)

    def forward(self, x, *, train: bool = False):
        up = (upsample2x_fused if self.use_pallas
              else upsample_bilinear_align_corners)
        return self.bn(up(x), train=train)


class AdaINBlock(nn.Module):
    """AdaIN conditioned on the weather vector: ``Linear(num_classes ->
    C*4)`` then the reference statistics (``ops/norm.py``).  ``emb`` is the
    reference's ``nn.Embedding(num_classes, num_classes)``, never used in its
    forward, kept so the state_dict matches.  The projection runs in the
    condition's dtype (its weights are cast to it).  Under spatial
    partitioning (``sp``) x holds a shard's rows and the plane statistics
    span the shards (``parallel/spatial.py``)."""

    sp = None

    def __init__(self, num_classes: int, channels: int, eps: float = 1e-5,
                 use_pallas: bool = False):
        super().__init__()
        self.eps = eps
        self.use_pallas = use_pallas
        self.l1 = nn.Linear(num_classes, channels * 4)
        self.emb = nn.Embedding(num_classes, num_classes)

    def forward(self, x, c, return_scale_shift: bool = False):
        y = F.linear(c, self.l1.weight.to(c.dtype), self.l1.bias.to(c.dtype))
        if return_scale_shift:
            # factored form for the fused upsample+conv kernel
            return adain_scale_shift(x, y, self.eps)
        if self.sp is not None:
            return self.sp.adain(x, y, self.eps, self.use_pallas)
        if self.use_pallas:
            return adain_fused(x, y, self.eps)
        return adain(x, y, self.eps)


class ConditionalUNet(nn.Module):
    """4-down/3-up conditional U-Net.

    ``use_pallas`` switches the unfused decoder entries to the hand-written
    kernels: the AdaINs run through K1 (``kernels/adain.py``) and the 2x
    upsamples after them through K2 (``kernels/upsample.py``).  This is the
    one place where the port's flag does more than the JAX package's, which
    turns on its AdaIN kernel only and leaves the upsample to XLA; the
    result is the same within the float32 tolerance either way.
    ``fuse_upconv`` routes decoder entries through the K3 kernel
    (``kernels/upconv.py``), which contains both: ``True`` fuses every
    level, a tuple of level indices (3 = coarsest .. 1 = finest) a subset.
    The names follow the JAX package.  In train mode the fused entries are
    off, as in the JAX package: dropout sits between the upsample and the
    conv, so K3 serves eval forwards only.

    ``dtype`` is the compute dtype, ``param_dtype`` the parameters' (``dtype``
    by default, as serving runs; training passes float32, so a bfloat16 model
    trains on float32 master weights cast to bfloat16 as each layer runs,
    like the JAX package's ``param_dtype``).  ``dropout_rate`` is the
    training-time dropout (``ops/dropout.py::make_dropout``).
    ``generator`` seeds the init (PyTorch's default distributions, drawn
    with ``ops/inits.py``); without it the layers keep their default init
    from the global generator.

    Marked by ``parallel/spatial.py::spatial_`` (``sp``), the forward takes
    a shard's rows: the convs take halos, the AdaINs split statistics
    (K1's split form under ``use_pallas``), the upsamples row windows
    (K2's row-window form), and dropout keeps the whole mask's rows.
    """

    sp = None

    def __init__(self, num_classes: int = 5, dropout_rate: float = 0.3,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 fuse_upconv=False,
                 param_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.fuse_levels = (tuple(fuse_upconv)
                            if isinstance(fuse_upconv, (tuple, list))
                            else ((1, 2, 3) if fuse_upconv else ()))
        self.dconv_down1 = RDoubleConv(3, 64)
        self.dconv_down2 = RDoubleConv(64, 128)
        self.dconv_down3 = RDoubleConv(128, 256)
        self.dconv_down4 = RDoubleConv(256, 512)
        self.dconv_up3 = RDoubleConv(512 + 256, 256)
        self.dconv_up2 = RDoubleConv(256 + 128, 128)
        self.dconv_up1 = RDoubleConv(128 + 64, 64)
        self.adain3 = AdaINBlock(num_classes, 512, use_pallas=use_pallas)
        self.adain2 = AdaINBlock(num_classes, 256, use_pallas=use_pallas)
        self.adain1 = AdaINBlock(num_classes, 128, use_pallas=use_pallas)
        self.conv_last = TorchConv(64, 3, 1, padding=0)
        if generator is not None:
            self._init_from(generator)
        self.to(dtype if param_dtype is None else param_dtype)

    @torch.no_grad()
    def _init_from(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(inits.torch_kernel_init(m.weight.shape,
                                                       generator))
                m.bias.copy_(inits.torch_bias_init_for(fan_in)(
                    m.bias.shape, generator))
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, x, c, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: images (B, 3, H, W) in [-1, 1]; c: conditions (B, num_classes).
        ``train`` turns on dropout after each decoder upsample, its masks
        drawn from ``generator`` (required when ``dropout_rate > 0``; a
        generator on x's device).  Returns (B, 3, H, W) in ``dtype``."""
        if train and self.dropout_rate > 0 and generator is None:
            raise ValueError("train=True with dropout needs a generator for "
                             "the masks (core/rng.py::train_generator)")
        drop = make_dropout(self.dropout_rate, not train)
        fuse_levels = () if train else self.fuse_levels
        sp = self.sp
        if sp is not None and fuse_levels:
            raise ValueError("fuse_upconv does not run split")
        x = x.to(self.dtype)
        c = c.to(self.dtype)
        conv1 = self.dconv_down1(x)
        conv2 = self.dconv_down2(max_pool_2x2(conv1))
        conv3 = self.dconv_down3(max_pool_2x2(conv2))
        h = self.dconv_down4(max_pool_2x2(conv3))
        for idx, skip in ((3, conv3), (2, conv2), (1, conv1)):
            blk = getattr(self, f"adain{idx}")
            up = getattr(self, f"dconv_up{idx}")
            if idx in fuse_levels:
                # (not "mod": torch.export's module-call wrapper takes
                # that name for itself)
                scale_shift = blk(h, c, return_scale_shift=True)
                h = up(h, skip=skip, fused_upsample=True,
                       scale_shift=scale_shift)
            elif sp is not None:
                u = sp.upsample(blk(h, c), self.use_pallas)
                h = up(drop(u, generator, rows=sp.level(u.shape[2])),
                       skip=skip)
            else:
                upsample = (upsample2x_fused if self.use_pallas
                            else upsample_bilinear_align_corners)
                h = up(drop(upsample(blk(h, c)), generator), skip=skip)
        return torch.tanh(self.conv_last(h))
