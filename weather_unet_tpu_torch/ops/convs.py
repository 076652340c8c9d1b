"""Convolution and pooling in NCHW/OIHW -- PyTorch's own layout, so these are
the library calls (cuDNN on the GPU), as the JAX package leaves its convs
to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, *, stride=1,
           padding=1):
    """Cross-correlation with symmetric zero padding (``nn.Conv2d``)."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


def max_pool_2x2(x: torch.Tensor):
    """MaxPool2d(kernel=2, stride=2), floor mode."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0):
    """General max pool, floor mode; the padding counts as -inf (ResNet's
    3x3/2 pool with padding 1)."""
    return F.max_pool2d(x, kernel_size=window, stride=stride, padding=padding)


def global_sum_pool(x: torch.Tensor):
    """Sum over the spatial dims: (B, C, H, W) -> (B, C)."""
    return x.sum(dim=(2, 3))


def global_avg_pool(x: torch.Tensor):
    """Mean over the spatial dims: (B, C, H, W) -> (B, C)
    (``nn.AdaptiveAvgPool2d(1)``, flattened)."""
    return x.mean(dim=(2, 3))
