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


def set_capturable(optimizer: torch.optim.Optimizer, on: bool) -> None:
    """Switch an Adam between its eager form and its ``capturable`` one,
    whose step count lives on the parameters' device so a CUDA graph can
    capture the whole update (``core/aot.py``).  Existing step counts move
    to where that form keeps them; a restore from a checkpoint written by
    the other form takes the flag from the file, so callers set it again
    after each restore.  The capturable update sums in another order than
    the eager one (its bias corrections are device tensors): equal to
    rounding, not bit for bit."""
    for group in optimizer.param_groups:
        group["capturable"] = on
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                state["step"] = state["step"].to(
                    device=p.device if on else "cpu", dtype=torch.float32)
