"""Small utilities from the reference's ``utils.py`` / ``ops.py`` -- the port
of ``weather_unet_tpu/ops/utils_misc.py``, NCHW.

No model path calls them; they are part of the reference's public surface.
Where the JAX functions take a key, these take a ``torch.Generator``; the
random streams differ from JAX's, the rules do not.  Functions that make a
tensor from nothing take ``device`` (``None`` is the GPU, as for the port's
entry points; ``"cpu"`` runs on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from weather_unet_tpu_torch._device import DeviceLike, resolve_device


def _one_hot(ind: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (ind[..., None] == torch.arange(n, device=ind.device)).to(dtype)


def make_one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The argmax over the *whole* tensor (as the reference's ``MakeOneHot``
    takes it) -> an int32 one-hot vector of ``num_classes``."""
    return _one_hot(torch.argmax(x), num_classes, torch.int32)


def vector_to_one_hot(vec: torch.Tensor) -> torch.Tensor:
    """Argmax along dim 0 -> one-hot of ``vec.shape[0]`` in vec's dtype."""
    return _one_hot(torch.argmax(vec, dim=0), vec.shape[0], vec.dtype)


def half_dropout(x: torch.Tensor, rate: float = 0.3,
                 deterministic: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dropout on the first half of the channels (dim 1) only: kept values
    scaled by ``1 / (1 - rate)``, the second half untouched."""
    if deterministic or rate == 0.0:
        return x
    half = x.shape[1] // 2
    a, b = x[:, :half], x[:, half:]
    keep = torch.rand(a.shape, generator=generator, device=x.device) < (
        1.0 - rate)
    a = torch.where(keep, a / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    return torch.cat([a, b], dim=1)


def denormalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Invert ``Normalize(mean, std)`` and clamp to [0, 1]; a per-channel
    ``mean`` / ``std`` broadcasts over dim 1 (NCHW)."""

    def per_channel(v):
        t = torch.as_tensor(v, dtype=x.dtype, device=x.device)
        return t.reshape(-1, 1, 1) if t.dim() == 1 else t

    return torch.clamp(x * per_channel(std) + per_channel(mean), 0.0, 1.0)


def get_rand_labels(num_classes: int, batch_size: int,
                    generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """A (batch_size, num_classes) float32 condition batch, uniform in
    [-1, 1) (the reference's ``one_hot`` branch crashes and is omitted, as
    in the JAX package)."""
    dev = resolve_device(device)
    return torch.rand((batch_size, num_classes), generator=generator,
                      device=dev) * 2.0 - 1.0


def get_sequential_labels(num_classes: int, batch_size: int,
                          one_hot: bool = False,
                          device: DeviceLike = None) -> torch.Tensor:
    """Cycling labels 0, 1, ..., num_classes - 1, 0, ... (float32), or their
    one-hot rows."""
    dev = resolve_device(device)
    ind = torch.arange(batch_size, device=dev) % num_classes
    if one_hot:
        return _one_hot(ind, num_classes, torch.float32)
    return ind.to(torch.float32)


def const_batch(value: float, batch_size: int,
                device: DeviceLike = None) -> torch.Tensor:
    """A constant (batch_size, 1) float32 tensor (real / fake targets)."""
    return torch.full((batch_size, 1), value, dtype=torch.float32,
                      device=resolve_device(device))


def lmda_ramp(global_step, all_step, fixed=None):
    """The reference's linear lambda ramp: ``fixed`` if given, else
    ``global_step / max(all_step, 1)``."""
    if fixed:
        return fixed
    return global_step / max(all_step, 1)
