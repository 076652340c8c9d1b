"""Train-state containers -- the port of ``weather_unet_tpu/core/state.py``.

In the JAX package a train state is a pytree of parameters and optimizer
moments threaded through a pure step.  In PyTorch the module holds its
parameters and the optimizer its moments, so a state names the two; the
discriminator's spectral-norm ``u`` vectors live in its buffers
(``weight_u``), the step counters here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    """A module, the optimizer over its parameters, and its update count."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass
class GanTrainState:
    """Paired generator/discriminator states plus the epoch and the count of
    combined steps."""

    gen: TrainState
    disc: TrainState
    epoch: int = 0
    global_step: int = 0
