"""Train-time random generators -- the port of
``weather_unet_tpu/core/rng.py``.

Train-time randomness (dropout masks) is drawn from an explicit, seeded
``torch.Generator`` on the device that uses it.  The JAX package's
``WUT_PRNG_IMPL`` picks between JAX key implementations (``rbg``, which
lowers bit generation to the TPU's hardware RNG, or ``threefry2x32``); a
CUDA or CPU ``torch.Generator`` has one implementation (Philox on CUDA), so
that knob has no counterpart here and the port reads no such variable.

``fold_seed`` stands in for ``jax.random.fold_in``: the trainer seeds each
step's dropout generator with ``fold_seed(base, global_step)``, so a resumed
run draws the masks that a run that was not interrupted draws.
"""

from __future__ import annotations

import numpy as np
import torch

from weather_unet_tpu_torch._device import DeviceLike, resolve_device


def train_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (CUDA unless given), seeded with
    ``seed``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def fold_seed(seed: int, n: int) -> int:
    """A 63-bit seed that is a function of ``(seed, n)`` only (both
    non-negative), from numpy's ``SeedSequence``."""
    state = np.random.SeedSequence((seed, n)).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))
