"""Loss functions of the GAN training step -- the port of
``weather_unet_tpu/ops/losses.py`` (reference ``ops.py:14-83``).

``group`` (``parallel/spatial.py::SpatialGroup``): the images hold a
shard's rows, and the pixel means span the shards."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def l1_loss(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """Mean absolute error."""
    if group is not None:
        return group.pixel_mean((a - b).abs(), tuple(range(a.dim())))
    return (a - b).abs().mean()


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error -- the reference's ``adv_loss``."""
    return (a - b).square().mean()


adv_loss = mse_loss


def feat_loss(feats_a: Sequence[torch.Tensor],
              feats_b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean of the per-layer L1s (feature matching)."""
    return torch.stack([l1_loss(a, b) for a, b in zip(feats_a, feats_b)]
                       ).mean()


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """``nn.CrossEntropyLoss()``: softmax cross entropy against integer
    labels, mean over the batch."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def pred_loss(preds: torch.Tensor, labels: torch.Tensor,
              one_hot: bool = False) -> torch.Tensor:
    """Weather-consistency loss: cross entropy for class labels, MSE for soft
    signal conditions."""
    if one_hot:
        return cross_entropy_loss(preds, labels)
    return mse_loss(preds, labels)


def dis_hinge(dis_fake: torch.Tensor, dis_real: torch.Tensor) -> torch.Tensor:
    """Hinge discriminator loss."""
    return F.relu(1.0 - dis_real).mean() + F.relu(1.0 + dis_fake).mean()


def gen_hinge(dis_fake: torch.Tensor) -> torch.Tensor:
    """Hinge generator loss."""
    return (-dis_fake).mean()


def reconstruction_con_loss(fake: torch.Tensor, real: torch.Tensor,
                            pred_labels: torch.Tensor,
                            rand_labels: torch.Tensor,
                            eps: float = 1e-7, group=None) -> torch.Tensor:
    """Distance-weighted reconstruction penalty ``loss_con`` (eps 1e-7
    semi-supervised, 1e-2 supervised):

      mean_b [ mean_pix |fake - real| / (mean_c |pred - rand| + eps) ]
    """
    if group is not None:
        diff = group.pixel_mean((fake - real).abs(), (1, 2, 3))
    else:
        diff = (fake - real).abs().mean(dim=(1, 2, 3))
    dist = (pred_labels - rand_labels).abs().mean(dim=1)
    return (diff / (dist + eps)).mean()


def soft_transform(x: torch.Tensor, std: float = 0.05,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Gaussian label smoothing: ``x + std * N(0, 1)``."""
    noise = torch.randn(x.shape, generator=generator, device=x.device,
                        dtype=torch.float32).to(x.dtype)
    return x + std * noise
