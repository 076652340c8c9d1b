"""Class-imbalance sampler -- the port of ``weather_unet_tpu/data/sampler.py``
(reference ``sampler.py:8-57``).

Inverse-class-frequency weighted sampling with replacement, the numpy form of
``torch.multinomial(weights, n, replacement=True)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class ImbalancedSampler:
    """Yields dataset indices with probability inverse to class frequency."""

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 num_samples: Optional[int] = None, seed: int = 0):
        self.indices = (list(range(len(dataset))) if indices is None
                        else list(indices))
        self.num_samples = (len(self.indices) if num_samples is None
                            else num_samples)

        labels = [dataset.get_class(i) for i in self.indices]
        counts: dict = {}
        for lb in labels:
            counts[lb] = counts.get(lb, 0) + 1
        weights = np.asarray([1.0 / counts[lb] for lb in labels],
                             dtype=np.float64)
        self.probs = weights / weights.sum()
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int):
        """Reseed the draw for ``epoch``: fresh draws every epoch,
        deterministic in ``(seed, epoch)``."""
        self._rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, epoch)))

    def __iter__(self):
        draw = self._rng.choice(len(self.indices), size=self.num_samples,
                                replace=True, p=self.probs)
        return iter(self.indices[i] for i in draw)

    def __len__(self):
        return self.num_samples
