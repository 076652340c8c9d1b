"""Optimizers with the reference's torch.optim semantics -- the port of
``weather_unet_tpu/core/optim.py``, which rebuilds them in optax.

The reference GAN trainers use ``Adam(lr, betas=(0.0, 0.999),
weight_decay=lr/20)``.
torch Adam's ``weight_decay`` is *coupled* L2 -- ``wd * p`` is added to the
gradient before the moment updates, not AdamW's decoupled decay -- which is
exactly what the JAX package's chain reproduces, so here it is
``torch.optim.Adam`` itself.
"""

from __future__ import annotations

from typing import Iterable

import torch


def torch_adam(params: Iterable, lr: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0) -> torch.optim.Adam:
    """``torch.optim.Adam`` (coupled L2 weight decay)."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def gan_adam(params: Iterable, lr: float) -> torch.optim.Adam:
    """The reference GAN optimizer: betas (0.0, 0.999), wd = lr/20."""
    return torch_adam(params, lr, b1=0.0, b2=0.999, weight_decay=lr / 20.0)
