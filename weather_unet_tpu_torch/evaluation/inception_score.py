"""Inception Score -- the port of
``weather_unet_tpu/evaluation/inception_score.py`` (reference
``eval/inception_score.py:35-113``).

IS = exp(E_x KL(p(y|x) || p(y))) over ``splits`` chunks of an ImageNet
classifier's softmax.  The classifier runs on the device; the split
statistics are small and stay on the host, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def inception_score_from_probs(probs: np.ndarray, splits: int = 10
                               ) -> Tuple[float, float]:
    """Mean and std of the per-split scores (``inception_score.py:78-95``)."""
    n = probs.shape[0]
    scores = []
    for k in range(splits):
        part = probs[k * (n // splits):(k + 1) * (n // splits)]
        if len(part) == 0:
            continue
        py = np.mean(part, axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(float(np.exp(np.mean(np.sum(kl, axis=1)))))
    return float(np.mean(scores)), float(np.std(scores))
