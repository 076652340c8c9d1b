"""AdaIN with the reference's exact (quirky) numerics, NCHW.

The reference AdaIN projects the condition vector through ``Linear(
num_classes, C*4)``, views both the feature map and the projection as
``(B, C, -1)`` and takes per-channel mean/std of each -- so the "style"
statistics come from only 4 values per channel, with *unbiased* variance
(ddof=1) and ``var + eps`` inside the sqrt.  ``nn.InstanceNorm2d`` (biased
variance, no 4-value style stats) is not this function.

``instance_whiten``, ``batch_whiten`` and ``conditional_norm`` are the rest
of the JAX module's surface, which no model path calls.
"""

from __future__ import annotations

import math

import torch


def _mean_var_unbiased(x: torch.Tensor, dim):
    """Mean and unbiased (ddof=1) variance along ``dim``, in float32, with the
    two-pass formula ``mean((x - mean)^2)`` (non-negative by construction;
    the one-pass ``E[x^2] - mean^2`` cancels catastrophically in bf16)."""
    dims = dim if isinstance(dim, tuple) else (dim,)
    n = math.prod(x.shape[d] for d in dims)
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims) * (n / max(n - 1, 1))
    return mean.squeeze(dims), var


def _style_stats(y_proj: torch.Tensor, b: int, c: int, eps: float):
    """(y_mean, y_std) of shape (B, C) from the channel-major (B, C, 4) view
    of the projected condition."""
    y_mean, y_var = _mean_var_unbiased(y_proj.reshape(b, c, 4), 2)
    return y_mean, torch.sqrt(y_var + eps)


def adain(x: torch.Tensor, y_proj: torch.Tensor, eps: float = 1e-5):
    """Adaptive instance norm, reference semantics.

    Args:
      x: features ``(B, C, H, W)``.
      y_proj: projected condition ``(B, C*4)`` (output of the Linear layer).
      eps: added to each *variance* before the sqrt.
    """
    b, c = x.shape[:2]
    x_mean, x_var = _mean_var_unbiased(x, (2, 3))
    y_mean, y_std = _style_stats(y_proj, b, c, eps)
    x_std = torch.sqrt(x_var + eps)
    out = ((x.float() - x_mean[:, :, None, None]) / x_std[:, :, None, None]
           * y_std[:, :, None, None] + y_mean[:, :, None, None])
    return out.to(x.dtype)


def plane_stats(x: torch.Tensor) -> torch.Tensor:
    """Each (b, c) plane's float32 ``(mean, M2)`` over its H x W values,
    two-pass: ``M2 = sum((x - mean)^2)``.  Returns (B, C, 2)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    m2 = (xf - mean).square().sum(dim=(2, 3))
    return torch.stack([mean.squeeze((2, 3)), m2], dim=-1)


def merge_plane_stats(stats: torch.Tensor, counts) -> torch.Tensor:
    """Merge the shards' plane statistics: ``stats`` (n, B, C, 2) holds
    shard k's ``(mean, M2)`` over its ``counts[k]`` values of each plane.
    Chan's formula, in float32, the shards in order:
    ``mean = sum_k n_k mean_k / N`` and ``M2 = sum_k M2_k + sum_k n_k
    (mean_k - mean)^2``.  Returns (B, C, 2): the plane's mean and its
    unbiased (ddof=1) variance ``M2 / (N - 1)``."""
    total = sum(counts)
    means, m2s = stats[..., 0], stats[..., 1]
    mean = sum(n * means[k] for k, n in enumerate(counts)) / total
    m2 = sum(m2s[k] for k in range(len(counts))) + sum(
        n * (means[k] - mean).square() for k, n in enumerate(counts))
    return torch.stack([mean, m2 / max(total - 1, 1)], dim=-1)


def adain_from_stats(x: torch.Tensor, y_proj: torch.Tensor,
                     stats: torch.Tensor, eps: float = 1e-5):
    """``adain`` with each plane's float32 ``(mean, unbiased variance)``
    given in ``stats`` (B, C, 2) instead of taken from x."""
    b, c = x.shape[:2]
    y_mean, y_std = _style_stats(y_proj, b, c, eps)
    x_mean, x_var = stats[..., 0], stats[..., 1]
    x_std = torch.sqrt(x_var + eps)
    out = ((x.float() - x_mean[:, :, None, None]) / x_std[:, :, None, None]
           * y_std[:, :, None, None] + y_mean[:, :, None, None])
    return out.to(x.dtype)


def adain_from_shard_stats(x: torch.Tensor, y_proj: torch.Tensor,
                           shard_stats: torch.Tensor, counts,
                           eps: float = 1e-5):
    """``adain_from_stats`` with the statistics merged from the shards'
    local ``(mean, M2)`` ``shard_stats`` (n, B, C, 2), as the exchange
    returns them, over ``counts`` (``merge_plane_stats``): the plain version
    of K1's apply launch, which merges them itself."""
    return adain_from_stats(x, y_proj, merge_plane_stats(shard_stats, counts),
                            eps)


def adain_split(x: torch.Tensor, y_proj: torch.Tensor, eps: float,
                exchange, counts, stats=plane_stats,
                modulate=adain_from_shard_stats):
    """``adain`` of a plane whose rows lie on several shards, x being this
    shard's rows: each shard's local ``stats(x)``, exchanged
    (``exchange(t) -> (n, *t.shape)``, every shard's in order, its gradient
    summed back), then ``modulate(x, y_proj, shard_stats, counts, eps)``,
    which merges them the same way on every shard (``merge_plane_stats``
    over ``counts``, each shard's values a plane) and modulates.  The
    result equals ``adain`` of the whole plane's rows within float32
    reassociation; differentiable where ``exchange`` is.  K1's split form
    passes its two kernels as ``stats`` and ``modulate``
    (``kernels/adain.py::adain_split_fused``)."""
    return modulate(x, y_proj, exchange(stats(x)), counts, eps)


def adain_scale_shift(x: torch.Tensor, y_proj: torch.Tensor,
                      eps: float = 1e-5):
    """AdaIN factored as a per-(sample, channel) affine: float32 ``(scale,
    shift)`` of shape (B, C) with ``adain(x, y) == (x_f32 * scale +
    shift).to(x.dtype)`` up to float32 reassociation.  Lets the fused
    upsample+conv kernel apply the modulation itself."""
    b, c = x.shape[:2]
    x_mean, x_var = _mean_var_unbiased(x, (2, 3))
    y_mean, y_std = _style_stats(y_proj, b, c, eps)
    scale = y_std / torch.sqrt(x_var + eps)
    shift = y_mean - x_mean * scale
    return scale, shift


def instance_whiten(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel whitening over H x W (no affine), unbiased
    variance; float32 statistics, cast back to x's dtype."""
    mean, var = _mean_var_unbiased(x, (2, 3))
    out = ((x.float() - mean[:, :, None, None])
           / torch.sqrt(var + eps)[:, :, None, None])
    return out.to(x.dtype)


def batch_whiten(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's custom ``BatchNorm``: per-*sample* whitening over all
    of C, H, W flattened, unbiased variance; float32 statistics, cast back
    to x's dtype."""
    b = x.shape[0]
    mean, var = _mean_var_unbiased(x.reshape(b, -1), 1)
    shape = (b,) + (1,) * (x.dim() - 1)
    out = ((x.float() - mean.reshape(shape))
           / torch.sqrt(var + eps).reshape(shape))
    return out.to(x.dtype)


def conditional_norm(x: torch.Tensor, batch_mean: torch.Tensor,
                     batch_var: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Class-conditional BatchNorm core: affine-less BN with the given
    per-channel ``batch_mean`` / ``batch_var`` (C,), then the per-sample
    ``gamma`` / ``beta`` (B, C) the caller looked up by class; in float32,
    cast back to x's dtype."""
    inv = 1.0 / torch.sqrt(batch_var.float() + eps)
    out = (x.float() - batch_mean.float()[:, None, None]) * inv[:, None, None]
    return (gamma.float()[:, :, None, None] * out
            + beta.float()[:, :, None, None]).to(x.dtype)
