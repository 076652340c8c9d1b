"""Parameter initializers with PyTorch's default distributions, each drawn
from an explicit ``torch.Generator`` -- the port of
``weather_unet_tpu/ops/inits.py``.

* ``nn.Conv2d`` / ``nn.Linear`` default: kaiming_uniform(a=sqrt(5)) on the
  weight and U(-1/sqrt(fan_in), 1/sqrt(fan_in)) on the bias -- both reduce to
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
* The discriminator uses ``xavier_uniform_`` with gain sqrt(2) on its conv
  weights and gain 1 on its linear heads.

Shapes are the port's: conv weights OIHW, linear weights ``(out, in)``.
An initializer is ``init(shape, generator=None, dtype=torch.float32,
device=None) -> Tensor``; ``generator=None`` draws from PyTorch's global
generator.
"""

from __future__ import annotations

import math

import torch


def _fan_in_out(shape):
    if len(shape) == 4:     # OIHW
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    if len(shape) == 2:     # (out, in)
        return shape[1], shape[0]
    raise ValueError(f"unsupported shape {tuple(shape)}")


def _uniform(shape, bound, generator, dtype, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(-bound, bound, generator=generator)
    return t.to(dtype)


def torch_kernel_init(shape, generator=None, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """PyTorch's default Conv2d/Linear weight: U(-1/sqrt(fan_in), +)."""
    fan_in, _ = _fan_in_out(shape)
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator, dtype, device)


def torch_bias_init_for(fan_in: int):
    """PyTorch's default bias init for a layer of ``fan_in`` inputs."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0

    def init(shape, generator=None, dtype=torch.float32, device=None):
        return _uniform(shape, bound, generator, dtype, device)

    return init


def xavier_uniform(gain: float = 1.0):
    """``nn.init.xavier_uniform_`` with ``gain``."""

    def init(shape, generator=None, dtype=torch.float32, device=None):
        fan_in, fan_out = _fan_in_out(shape)
        bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(shape, bound, generator, dtype, device)

    return init


def normal_unit(shape, generator=None, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """N(0, 1) scaled to unit l2 norm (eps 1e-12): the spectral-norm ``u``
    vectors start this way."""
    v = torch.empty(shape, dtype=torch.float32, device=device)
    v.normal_(0.0, 1.0, generator=generator)
    return (v / (torch.linalg.vector_norm(v) + 1e-12)).to(dtype)
