"""Shared building blocks with the reference's parameter layout (OIHW conv
weights, ``(out, in)`` linear weights) and PyTorch default init.

The dense layer is ``nn.Linear`` itself: the JAX package's ``TorchDense``
rebuilds exactly its init and ``x @ W.T + b``.  ``SNConv`` / ``SNDense`` are
the spectral-normalized conv and linear of the discriminator, with the
reference's spectral-norm state_dict names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from weather_unet_tpu_torch.kernels.upconv import upconv_block_fused
from weather_unet_tpu_torch.ops import inits
from weather_unet_tpu_torch.ops.convs import conv2d
from weather_unet_tpu_torch.parallel.mesh import (
    all_reduce_sum, data_parallel)
from weather_unet_tpu_torch.ops.spectral import (
    power_iteration, spectral_normalize, weight_matrix)


class TorchConv(nn.Conv2d):
    """``nn.Conv2d`` whose forward also runs the decoder's split-concat form.

    With ``skip`` the weight spans ``Cx + Cskip`` input channels, ordered
    ``[x, skip]`` like the reference's ``cat([x, skip], 1)``, and is applied as
    ``conv(x, W[:, :Cx]) + conv(skip, W[:, Cx:])`` -- the same sum without
    materializing the concat.  The bias rides on the x-part conv, as in the
    JAX package.

    ``fused_upsample`` (3x3, stride 1, pad 1, needs ``skip``): ``x`` is the
    LOW-RES map before the 2x upsample, ``scale_shift`` the ``(scale,
    shift)`` float32 (B, Cx) AdaIN modulation, and the block entry runs
    through the fused
    kernel (``kernels/upconv.py``) -- ``conv(concat(upsample(x*scale+shift),
    skip))`` followed by the block's ReLU, all in the kernel, so the result
    is post-activation.  There the bias rides on the skip conv ``cb`` the
    kernel adds.

    The weight and bias are cast to x's dtype (a no-op when they already
    have it): float32 master weights serve a bfloat16 forward, as the JAX
    package's ``param_dtype`` does.

    ``tp`` (set by ``parallel/tp.py::shard_`` on a split pair's members):
    a column-parallel conv1 holds its shard of the output channels and
    takes its replicated inputs through the split's backward sum; a
    row-parallel conv2 holds its shard of the input channels, runs
    bias-free and returns the sum over the shards plus its bias.

    ``sp`` (set by ``parallel/spatial.py::spatial_`` on a 3x3 conv): x (and
    ``skip``) hold a shard's rows; each takes its halo rows and the conv
    pads the width only.
    """

    tp = None
    sp = None

    def forward(self, x, skip=None, fused_upsample: bool = False,
                scale_shift=None):
        w = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        padding = self.padding
        if self.sp is not None:
            if fused_upsample:
                raise ValueError("fuse_upconv does not run split")
            x, skip, padding = self.sp.conv_input(x, skip, self.stride[0],
                                                  padding)
        if self.tp is not None:
            if fused_upsample:
                raise ValueError("fuse_upconv does not run split")
            x, skip = self.tp.inputs(x, skip)
            if self.tp.kind == "row":
                return self.tp.output(conv2d(
                    x, w, None, stride=self.stride, padding=self.padding),
                    self.bias)
        if skip is None:
            return conv2d(x, w, bias, stride=self.stride, padding=padding)
        cx = x.shape[1]
        if fused_upsample:
            if (self.kernel_size != (3, 3) or self.stride != (1, 1)
                    or self.padding != (1, 1)):
                raise ValueError("fused_upsample requires a 3x3/stride-1/"
                                 "pad-1 conv")
            cb = conv2d(skip, w[:, cx:], bias, padding=1)
            scale, shift = scale_shift
            return upconv_block_fused(x, w[:, :cx], cb, scale, shift,
                                      relu=True)
        out = conv2d(x, w[:, :cx], bias, stride=self.stride, padding=padding)
        return out + conv2d(skip, w[:, cx:], None, stride=self.stride,
                            padding=padding)


class BatchNorm2d(nn.Module):
    """BatchNorm2d over NCHW with the JAX module's (= torch's) semantics and
    ``nn.BatchNorm2d``'s parameter and buffer names.

    Eval mode (``module.eval()``) normalizes with the running statistics.
    Train mode normalizes with the *biased* batch variance, computed in two
    passes (``mean((x - mean)^2)``: the one-pass form cancels for
    near-constant channels), and blends the *unbiased* one into
    ``running_var``: ``new = (1 - momentum) * old + momentum * batch``.
    Statistics and the normalization run in float32 whatever the input
    type; the result is cast back to it.  ``forward(x, train=...)`` picks
    the mode for one call, as the JAX module's ``use_running_average``
    does (the modules that own an affine-less one take ``train``).

    ``sync`` (set by :func:`sync_batchnorm`; off by default): under a
    process group train mode computes the moments of the global batch, as
    the JAX package's SPMD step does over its sharded batch axis, in the
    same two passes -- the ranks' sums and counts all-reduced for the
    mean, then their sums of squared deviations from it -- with the
    all-reduce in the gradient too, and the unbiased variance over the
    global count in ``running_var``.
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
        self.sync = False

    def _global_moments(self, xf):
        """(mean, biased var, count) of the global batch: two all-reduces
        of per-channel sums over the ranks."""
        c = xf.shape[1]
        n_local = xf.shape[0] * xf.shape[2] * xf.shape[3]
        s = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                      xf.new_full((1,), n_local)]))
        n = s[c].detach()
        mean = s[:c] / n
        ssd = all_reduce_sum(
            (xf - mean[:, None, None]).square().sum(dim=(0, 2, 3)))
        return mean, ssd / n, n

    def forward(self, x, train: Optional[bool] = None):
        xf = x.float()
        if self.training if train is None else train:
            if self.sync and data_parallel():
                mean, var, n = self._global_moments(xf)
            else:
                n = x.shape[0] * x.shape[2] * x.shape[3]
                mean = xf.mean(dim=(0, 2, 3))
                var = (xf - mean[:, None, None]).square().mean(
                    dim=(0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (
                    n / ((n - 1).clamp(min=1) if isinstance(n, torch.Tensor)
                         else max(n - 1, 1))))
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        inv = torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * inv[:, None, None]
        if self.weight is not None:
            y = (y * self.weight.float()[:, None, None]
                 + self.bias.float()[:, None, None])
        return y.to(x.dtype)


def sync_batchnorm(module: nn.Module, on: bool = True) -> nn.Module:
    """Set ``sync`` on every ``BatchNorm2d`` of ``module``: under a process
    group their train-mode moments are the global batch's."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.sync = on
    return module


class ConditionalNorm(nn.Module):
    """Class-conditional BatchNorm (the reference's ``ConditionalNorm``): an
    affine-less ``BatchNorm2d`` (``bn``), then per-class gamma and beta
    looked up in ``embed`` (num_classes, 2C), whose gamma columns start at
    1 and beta columns at 0.  No model path uses it; the JAX package keeps
    it for the reference's surface, and so does the port."""

    def __init__(self, num_features: int, num_classes: int = 5):
        super().__init__()
        self.bn = BatchNorm2d(num_features, affine=False)
        self.embed = nn.Parameter(torch.cat(
            [torch.ones(num_classes, num_features),
             torch.zeros(num_classes, num_features)], dim=1))

    def forward(self, x, class_id, train: bool = False):
        """x (B, C, H, W), class_id (B,) integer classes; ``train`` uses and
        updates the batch statistics."""
        c = x.shape[1]
        out = self.bn(x, train=train).float()
        gb = self.embed.float()[class_id]               # (B, 2C)
        gamma, beta = gb[:, :c], gb[:, c:]
        return (gamma[:, :, None, None] * out
                + beta[:, :, None, None]).to(x.dtype)


class _SpectralNorm(nn.Module):
    """Shared state of ``SNConv`` / ``SNDense``: the parameter
    ``weight_orig``, ``bias``, and the float32 power-iteration buffers
    ``weight_u`` (out,) and ``weight_v`` (in * kh * kw,) -- the names of
    ``torch.nn.utils.spectral_norm``, so a reference discriminator state
    dict loads with ``strict=True``.  A state dict that also carries the
    normalized ``weight`` (the JAX package's ``sndisc_to_torch`` writes it)
    loads too: the key is dropped, as torch's spectral-norm load hook does.

    ``weight_orig`` is normalized in float32 and cast to the input's dtype.
    ``update_stats=True`` advances ``u`` (and stores ``v``) once; without it
    the forward reads ``u`` and changes nothing.  Split by
    ``parallel/tp.py`` (``tp``), the layer holds its shard and the power
    iteration is the whole weight's (``ops/spectral.py``).  Under spatial
    partitioning (``sp``, a 3x3 conv) the weight is whole and the input a
    shard's rows, which take their halo.
    """

    tp = None
    sp = None

    def _init_sn(self, shape, gain: float, fan_in: int,
                 generator: Optional[torch.Generator]):
        self.weight_orig = nn.Parameter(
            inits.xavier_uniform(gain)(shape, generator))
        self.bias = nn.Parameter(
            inits.torch_bias_init_for(fan_in)((shape[0],), generator))
        u = inits.normal_unit((shape[0],), generator)
        _, u, v = power_iteration(weight_matrix(self.weight_orig), u, False)
        self.register_buffer("weight_u", u)
        self.register_buffer("weight_v", v)

    def normalized_weight(self, dtype, update_stats: bool) -> torch.Tensor:
        w_bar, u, v = spectral_normalize(self.weight_orig.float(),
                                         self.weight_u, update_stats,
                                         split=self.tp)
        if update_stats:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return w_bar.to(dtype)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "weight", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class SNConv(_SpectralNorm):
    """Spectral-normalized ``Conv2d`` (reference ``nets.py:26-33``),
    xavier-uniform weight with ``gain``, PyTorch's default bias init."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, gain: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self._init_sn((out_ch, in_ch, kernel_size, kernel_size), gain,
                      in_ch * kernel_size * kernel_size, generator)

    def forward(self, x, update_stats: bool = False):
        w = self.normalized_weight(x.dtype, update_stats)
        padding = self.padding
        if self.sp is not None:
            x, _, padding = self.sp.conv_input(x, None, self.stride, padding)
        if self.tp is not None:
            (x,) = self.tp.inputs(x)
            if self.tp.kind == "row":
                return self.tp.output(conv2d(
                    x, w, None, stride=self.stride, padding=self.padding),
                    self.bias)
        return conv2d(x, w, self.bias.to(x.dtype), stride=self.stride,
                      padding=padding)


class SNDense(_SpectralNorm):
    """Spectral-normalized ``Linear`` (reference ``disc.py:21-25``),
    xavier-uniform weight with ``gain``, PyTorch's default bias init."""

    def __init__(self, in_features: int, out_features: int,
                 gain: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._init_sn((out_features, in_features), gain, in_features,
                      generator)

    def forward(self, x, update_stats: bool = False):
        w = self.normalized_weight(x.dtype, update_stats)
        return F.linear(x, w, self.bias.to(x.dtype))
