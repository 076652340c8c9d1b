"""Offline dataset preparation -- the port of
``weather_unet_tpu/data/preprocess.py`` (the reference's
``preprocesses/spliter.py``, ``spliter_flicker.py`` and ``remove_gray.py``).

The draws are the JAX package's: ``random.Random(seed)`` shuffles each i2w
class, ``np.random.default_rng(seed)`` each Flickr class, so one seed gives
the same lists and the same ``mode`` column.  Pillow and pandas load only
inside the functions that need them.
"""

from __future__ import annotations

import os
import pickle
import random
from glob import glob
from typing import Dict, List, Optional, Sequence

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def split_i2w(root: str, test_per_class: int = 500, small_rate: float = 1.0,
              seed: int = 0) -> Dict[str, List[str]]:
    """An i2w directory tree (one directory a class; ``z-other`` skipped) ->
    ``{'train', 'val', 'test'}`` path lists.  Per class, in sorted order:
    the image files are shuffled, ``small_rate`` subsamples *first* (so the
    test set keeps its size), ``test_per_class`` go to test and the rest is
    halved into train and val.  Only image files are listed."""
    rng = random.Random(seed)
    out: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d))
                     and "z-other" not in d)
    for cls in classes:
        paths = sorted(p for p in glob(os.path.join(root, cls, "*"))
                       if p.lower().endswith(IMAGE_EXTS) and os.path.isfile(p))
        rng.shuffle(paths)
        if small_rate < 1.0:
            paths = paths[: int(len(paths) * small_rate)]
        rest = paths[test_per_class:]
        half = len(rest) // 2
        out["test"].extend(paths[:test_per_class])
        out["train"].extend(rest[:half])
        out["val"].extend(rest[half:])
    return out


def split_flickr(df, per_class: Sequence[int] = (40, 40, 20),
                 ent_th: Optional[float] = None, class_col: str = "condition2",
                 seed: int = 0):
    """A copy of the frame with a ``mode`` column: per class (in sorted
    order) the shuffled rows go train / val / test in the ``per_class``
    percentages (train and val rounded down, test the rest).  With
    ``ent_th`` and an ``ent_label`` column, rows at or above it go first."""
    import numpy as np

    df = df.copy()
    if ent_th is not None and "ent_label" in df:
        df = df[df["ent_label"] < ent_th]
    rng = np.random.default_rng(seed)
    modes = np.empty(len(df), dtype=object)
    labels = df[class_col].to_numpy()
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        n_train = len(idx) * per_class[0] // 100
        n_val = len(idx) * per_class[1] // 100
        modes[idx[:n_train]] = "train"
        modes[idx[n_train:n_train + n_val]] = "val"
        modes[idx[n_train + n_val:]] = "test"
    df["mode"] = modes
    return df


def remove_gray(df, image_root: str, photo_col: str = "photo",
                sample_px: int = 64):
    """The frame without its grayscale photos (R == G == B at every pixel of
    a ``sample_px``-square Pillow resize); a photo that cannot be read
    counts as gray and is dropped."""
    import numpy as np
    from PIL import Image

    from weather_unet_tpu_torch.data.datasets import flickr_image_path

    keep = []
    for pid in df[photo_col]:
        try:
            with Image.open(flickr_image_path(image_root, pid)) as im:
                arr = np.asarray(im.convert("RGB").resize(
                    (sample_px, sample_px)), dtype=np.int16)
            gray = bool(np.all(arr[..., 0] == arr[..., 1])
                        and np.all(arr[..., 1] == arr[..., 2]))
        except (OSError, ValueError, Image.DecompressionBombError):
            gray = True
        keep.append(not gray)
    return df[keep]


def save_split_pickle(split: Dict[str, List[str]], path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(split, f)
