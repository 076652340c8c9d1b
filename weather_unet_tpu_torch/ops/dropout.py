"""Dropout from 16-bit random words -- the port of
``weather_unet_tpu/ops/dropout.py``'s ``bits_dropout`` and ``make_dropout``.

``bits_dropout`` keeps an element when its 16-bit random word is below
``thresh = round((1 - rate) * 65536)``: the keep probability is quantized to
1/65536 steps (rate 0.3 keeps 45875/65536), and kept values are scaled by
``65536 / thresh`` in x's dtype, so in float32 E[output] == x.  Words are
drawn as int16 in [-32768, 32768) and compared with ``thresh - 32768``: the
same rule on a tensor of half the bytes of int32 words.

``packed_dropout`` (and the module ``PackedDropout``) is the JAX package's
8-bit form, which it rejected as a default and keeps as an opt-in: one
32-bit random word per 4 channels, split into 4 8-bit lanes along the
channel axis (dim 1 here; word ``j``'s lane ``k`` decides channel ``4j +
k``); an element is kept when its lane is below ``thresh = round((1 - rate)
* 256)``, and kept values are scaled by ``256 / thresh``.  Channel counts
not divisible by 4, and rates whose ``thresh`` is 0 or 256, fall back to
the Bernoulli rule.

Masks carry no cross-framework parity duty (the reference's ``nn.Dropout``;
parity runs at rate 0), so the random streams differ from JAX's; the keep
rules and the scales do not.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import torch
import torch.nn as nn

_VALID = ("bits16", "torch")


def _drawn(x: torch.Tensor, rows):
    """The shape a mask for ``x`` is drawn at, and how to cut x's part out of
    it: x's own, or with ``rows = (start, total)`` (spatial partitioning:
    x holds rows ``[start, start + x.shape[2])`` of ``total``) the whole
    image's, of which x keeps its rows, so that every shard keeps the rows
    of the one mask an unsharded step draws."""
    if rows is None:
        return x.shape, lambda t: t
    start, total = rows
    shape = x.shape[:2] + (total,) + x.shape[3:]
    return shape, lambda t: t.narrow(2, start, x.shape[2])


def _bernoulli_dropout(x: torch.Tensor, rate: float,
                       generator: Optional[torch.Generator],
                       rows=None) -> torch.Tensor:
    """``nn.Dropout``'s rule: keep with probability ``1 - rate`` (a float32
    uniform draw), scale kept values by ``1 / (1 - rate)``."""
    keep = 1.0 - rate
    shape, cut = _drawn(x, rows)
    mask = cut(torch.rand(shape, generator=generator, device=x.device)
               < keep)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


@functools.lru_cache(maxsize=64)
def _keep_scale(thresh: int, dtype: torch.dtype, device: torch.device,
                levels: int = 65536) -> torch.Tensor:
    """``levels / thresh`` rounded to ``dtype``, on ``device``: made once, at
    first use, so a step captured as a CUDA graph copies nothing from the
    host (a CUDA graph cannot capture a host-to-device copy).  Rounding to
    x's dtype matters: a Python-float scale would multiply in float32 and
    move bf16 results."""
    with torch.inference_mode(False):
        return torch.tensor(levels / thresh, dtype=dtype, device=device)


def bits_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator] = None,
                 rows=None) -> torch.Tensor:
    """Inverted dropout from 16-bit random words (module docstring).  Falls
    back to the Bernoulli rule when a 16-bit threshold cannot express the
    rate.  ``rows = (start, total)``: x is a shard's rows of the image, and
    its mask those rows of the whole image's."""
    if rate <= 0.0:
        return x
    thresh = round((1.0 - rate) * 65536.0)
    if not 0 < thresh < 65536:
        return _bernoulli_dropout(x, rate, generator, rows)
    shape, cut = _drawn(x, rows)
    words = cut(torch.randint(-32768, 32768, shape, generator=generator,
                              device=x.device, dtype=torch.int16))
    mask = words < thresh - 32768
    scale = _keep_scale(thresh, x.dtype, x.device)
    return torch.where(mask, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def packed_dropout(x: torch.Tensor, rate: float,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Inverted dropout over an NCHW (or any (B, C, ...)) x from 8-bit lanes
    of 32-bit random words, 4 lanes a word along dim 1 (module
    docstring)."""
    if rate <= 0.0:
        return x
    b, c = x.shape[:2]
    thresh = round((1.0 - rate) * 256.0)
    if c % 4 != 0 or not 0 < thresh < 256:
        return _bernoulli_dropout(x, rate, generator)
    words = torch.randint(-2 ** 31, 2 ** 31, (b, c // 4, 1) + x.shape[2:],
                          generator=generator, device=x.device,
                          dtype=torch.int32)
    shifts = (8 * torch.arange(4, dtype=torch.int32, device=x.device)
              ).reshape((1, 1, 4) + (1,) * (x.dim() - 2))
    lanes = (words >> shifts) & 0xFF                # (B, C // 4, 4, ...)
    mask = lanes.reshape(x.shape) < thresh
    scale = _keep_scale(thresh, x.dtype, x.device, 256)
    return torch.where(mask, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


class PackedDropout(nn.Module):
    """``packed_dropout`` as a module: the identity when ``deterministic``
    or at rate 0, else ``packed_dropout(x, rate, generator)``."""

    def __init__(self, rate: float, deterministic: bool = False):
        super().__init__()
        self.rate = rate
        self.deterministic = deterministic

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.deterministic or self.rate == 0.0:
            return x
        return packed_dropout(x, self.rate, generator)


def default_impl() -> str:
    """``WUT_DROPOUT``: ``bits16`` (default) or ``torch`` (the Bernoulli
    rule of ``nn.Dropout``); anything else raises, since a typo falling
    through to the default would draw another mask stream than asked."""
    impl = os.environ.get("WUT_DROPOUT", "bits16")
    if impl not in _VALID:
        raise ValueError(f"WUT_DROPOUT={impl!r}: expected 'bits16' or "
                         f"'torch'")
    return impl


def make_dropout(rate: float, deterministic: bool) -> Callable:
    """The default dropout as ``drop(x, generator, rows=None) -> Tensor``:
    the identity when ``deterministic`` or ``rate == 0``, else
    ``bits_dropout`` or, with ``WUT_DROPOUT=torch``, the Bernoulli rule
    (``rows`` as ``bits_dropout``'s)."""
    impl = default_impl()
    if deterministic or rate == 0.0:
        return lambda x, generator=None, rows=None: x
    if impl == "torch":
        return lambda x, generator=None, rows=None: _bernoulli_dropout(
            x, rate, generator, rows)
    return lambda x, generator=None, rows=None: bits_dropout(
        x, rate, generator, rows)
