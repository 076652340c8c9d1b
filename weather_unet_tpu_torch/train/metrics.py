"""Scalar and image summaries -- the port of
``weather_unet_tpu/train/metrics.py``.

The reference's tag scheme: scalars grouped ``losses/<name>`` with
``train``/``test`` sub-tags, image grids under ``io/train`` / ``images/test``
(``t_est_train.py:336-345``), run names ``_lr-..._bs-..._ne-..._name-...``
(``t_est_train.py:68``).  TensorBoard when it imports; otherwise scalars go
to ``scalars.jsonl`` and images to PNG (Pillow) or, without Pillow, ``.npy``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


def run_comment(lr: float, batch_size: int, num_epoch: int, name: str) -> str:
    """Reference run-naming convention (``t_est_train.py:68``)."""
    return f"_lr-{lr}_bs-{batch_size}_ne-{num_epoch}_name-{name}"


class SummaryWriter:
    """Grouped scalar/image writer: TensorBoard if importable, else JSONL."""

    def __init__(self, log_dir: str = "runs", comment: str = ""):
        self.log_dir = os.path.join(
            log_dir, time.strftime("%b%d_%H-%M-%S") + comment)
        os.makedirs(self.log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TB
        except ImportError:
            self._jsonl = open(os.path.join(self.log_dir, "scalars.jsonl"),
                               "a")
        else:
            self._tb = TB(log_dir=self.log_dir)

    def add_scalars(self, scalar_dict: Dict[str, float], step: int) -> None:
        """Keys like ``losses/g_loss/train`` are split into group
        ``losses/g_loss`` + sub-tag ``train`` (``t_est_train.py:338-340``)."""
        if self._tb is not None:
            grouped: Dict[str, Dict[str, float]] = {}
            for k, v in scalar_dict.items():
                group, _, sub = k.rpartition("/")
                grouped.setdefault(group or k, {})[sub or "value"] = float(v)
            for group, subs in grouped.items():
                self._tb.add_scalars(group, subs, step)
        else:
            rec = {"step": step,
                   **{k: float(v) for k, v in scalar_dict.items()}}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def add_image_grid(self, tag: str, images: np.ndarray, step: int,
                       nrow: int = 1) -> None:
        """NHWC float images -> one grid, each image min-max normalized
        (torchvision ``make_grid(normalize=True, scale_each=True)``)."""
        grid = make_grid(images, nrow=nrow, normalize=True, scale_each=True)
        if self._tb is not None:
            self._tb.add_image(tag, np.transpose(grid, (2, 0, 1)), step)
            return
        stem = os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}")
        try:
            from PIL import Image
        except ImportError:
            np.save(stem + ".npy", grid)
        else:
            Image.fromarray((grid * 255).astype(np.uint8)).save(stem + ".png")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


def make_grid(images: np.ndarray, nrow: int = 1, normalize: bool = True,
              scale_each: bool = True, pad: int = 2) -> np.ndarray:
    """Minimal torchvision-``make_grid`` equivalent for NHWC arrays."""
    images = np.asarray(images, dtype=np.float32)
    if normalize:
        if scale_each:
            flat = images.reshape(images.shape[0], -1)
            lo = flat.min(axis=1)[:, None, None, None]
            hi = flat.max(axis=1)[:, None, None, None]
        else:
            lo, hi = images.min(), images.max()
        images = (images - lo) / np.maximum(hi - lo, 1e-12)
    n, h, w, c = images.shape
    ncol = nrow
    nrow_eff = -(-n // ncol)
    grid = np.zeros((nrow_eff * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    dtype=np.float32)
    for i in range(n):
        r, cl = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + cl * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    return grid


def image_table(images: np.ndarray, results) -> np.ndarray:
    """Reference ``ops.make_table_img`` (``ops.py:77-84``): the input batch
    stacked above each result batch along height (NHWC axis 1).
    ``results`` is one array or a list of result batches."""
    if isinstance(results, np.ndarray):
        results = [results]
    return np.concatenate(
        [np.asarray(images)] + [np.asarray(r) for r in results], axis=1)
