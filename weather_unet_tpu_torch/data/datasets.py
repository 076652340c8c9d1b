"""Host-side datasets -- the port of ``weather_unet_tpu/data/datasets.py``
(reference loaders, ``dataset.py``).

Datasets are plain indexable objects returning numpy records (uint8 HWC
images); decode (Pillow, imported where it is used, or the native runtime's
libjpeg loader) happens in the loader's threads; augmentation beyond decode
and resize is the dataset's ``transform`` (``data/transforms.py``:
``HostAugment``, ``NativeAugment``, or ``data/cache.py::CachedAugment``
around one), normalization runs on the device
(``transforms.normalize_batch``).

As in the JAX package: unreadable images raise after a bounded number of
fallbacks to the next index (the reference retries the same index forever,
``dataset.py:62-66``), and ``FlickrDataset`` keeps the three return arities
keyed on ``class_id in {None, True, False}`` (``dataset.py:72-79``).
"""

from __future__ import annotations

import copy
import os
from typing import Optional, Sequence

import numpy as np

WEATHER_CLASSES_I2W = ["sunny", "cloudy", "rain", "snow", "foggy"]
WEATHER_CLASSES_FLICKR = ["Clear", "Clouds", "Rain", "Mist", "Snow"]
SIGNAL_COLUMNS = ["clouds", "temp", "humidity", "pressure", "windspeed"]

_MAX_BAD_FILES = 16


def class_id_from_string(name: str) -> int:
    """i2w class name -> id (``dataset.py:20-24``)."""
    return WEATHER_CLASSES_I2W.index(name)


def zscore_columns(df, columns, stats_df=None):
    """Z-score ``columns`` of ``df`` against ``stats_df``'s (or ``df``'s own)
    mean and std (``t_est_train.py:126-131``).  Returns (df, mean, std)."""
    src = stats_df if stats_df is not None else df
    ref = src.loc[:, columns].fillna(0)
    mean, std = ref.mean(), ref.std()
    df = df.copy()
    df.loc[:, columns] = (df.loc[:, columns].fillna(0) - mean) / std
    return df, mean, std


def _decode(path: str, out_size: Optional[int],
            prefer_native: Optional[bool] = None) -> np.ndarray:
    """Image decode + optional square resize -> uint8 HWC.

    With ``prefer_native`` (default: ``WUT_NATIVE_DECODE=1``), a JPEG with
    an ``out_size`` decodes through the native runtime's libjpeg loader
    (``runtime/jpeg_loader.cc``: DCT-domain downscale, plain bilinear
    resize without antialiasing; no GIL held), where the runtime has a
    decode; otherwise, and for every other file, Pillow decodes (bilinear
    resize).  The decode cache passes True: its fill is the decode-heavy
    stage and feeds training only."""
    if prefer_native is None:
        prefer_native = os.environ.get("WUT_NATIVE_DECODE") == "1"
    if (out_size is not None and prefer_native
            and path.lower().endswith((".jpg", ".jpeg"))):
        from weather_unet_tpu_torch import runtime

        if runtime.decode_available():
            img = runtime.decode_file(path, out_size)
            if img is not None:
                return img
            raise OSError(f"native decode failed for {path}")
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if out_size is not None:
            im = im.resize((out_size, out_size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def _load(path: str, out_size: Optional[int], transform) -> np.ndarray:
    """Decode + transform one sample.  A transform with ``from_path`` takes
    the file itself (``NativeAugment``'s fused decode + augment) when it is
    a JPEG, or any file when the transform sets ``from_path_any`` (the
    decode cache); otherwise decode here, then augment on the transform's
    keyed per-path RNG stream when it has one
    (``transforms._KeyedRngMixin``)."""
    if (transform is not None and hasattr(transform, "from_path")
            and (path.lower().endswith((".jpg", ".jpeg"))
                 or getattr(transform, "from_path_any", False))):
        return transform.from_path(path)
    image = _decode(path, out_size)
    if transform is not None:
        keyed = getattr(transform, "augment_keyed", None)
        image = keyed(image, path) if keyed is not None else transform(image)
    return image


def with_transform(dataset, transform):
    """Shallow view of ``dataset`` with another ``transform``, sharing its
    path and label lists: gives a second loader over the same data its own
    keyed RNG stream (``transforms.fork_stream``)."""
    d = copy.copy(dataset)
    d.transform = transform
    return d


def flickr_image_path(image_root: str, photo_id) -> str:
    """``<root>/<photo>.jpg``: the one definition of a Flickr photo's path."""
    return os.path.join(image_root, str(photo_id) + ".jpg")


class FlickrDataset:
    """Flickr weather-DB dataset (``dataset.py:27-79``): a pandas frame with
    a ``photo`` column (image id), the z-scored signal columns, and a class
    column (``condition2``, or ``w_condition`` when ``imbalance``)."""

    def __init__(self, image_root: str, df, columns: Sequence[str],
                 out_size: Optional[int] = None,
                 class_id: Optional[bool] = None, imbalance: bool = False,
                 transform=None):
        self.root = image_root
        self.transform = transform
        self.columns = list(columns)
        self.photo_ids = df["photo"].to_list()
        self.conditions = df.loc[:, self.columns].fillna(0).to_numpy(
            np.float32)
        label_col = "w_condition" if imbalance else "condition2"
        self.labels = df[label_col].to_list() if label_col in df else None
        self.class_id = class_id
        self.num_classes = len(self.columns)
        self.out_size = out_size

    def __len__(self):
        return len(self.photo_ids)

    def get_class(self, idx: int) -> int:
        return WEATHER_CLASSES_FLICKR.index(self.labels[idx])

    def get_condition(self, idx: int) -> np.ndarray:
        return self.conditions[idx]

    def __getitem__(self, idx: int):
        for attempt in range(_MAX_BAD_FILES):
            i = (idx + attempt) % len(self)
            path = flickr_image_path(self.root, self.photo_ids[i])
            try:
                image = _load(path, self.out_size, self.transform)
                break
            except OSError:
                continue
        else:
            raise OSError(f"more than {_MAX_BAD_FILES} consecutive "
                          f"unreadable images at {idx}")
        cond = self.get_condition(i)
        if self.class_id is None:
            return image, cond, self.photo_ids[i]
        if self.class_id:
            return image, cond, self.get_class(i), self.photo_ids[i]
        return image, self.get_class(i)


class ImagePathDataset:
    """Plain path-list dataset (reference ``ImageLoader``,
    ``dataset.py:81-102``)."""

    def __init__(self, paths: Sequence[str], out_size: Optional[int] = None,
                 with_path: bool = False, transform=None):
        self.paths = list(paths)
        self.out_size = out_size
        self.with_path = with_path
        self.transform = transform

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int):
        for attempt in range(_MAX_BAD_FILES):
            i = (idx + attempt) % len(self)
            try:
                image = _load(self.paths[i], self.out_size, self.transform)
                break
            except OSError:
                continue
        else:
            raise OSError(f"more than {_MAX_BAD_FILES} consecutive "
                          f"unreadable images at {idx}")
        if self.with_path:
            return image, self.paths[i]
        return image, True


def filter_i2w_paths(paths: Sequence[str]) -> list:
    """Drop the reference's skipped ``z-other`` class (``dataset.py:115``)."""
    return [p for p in paths if "z-other" not in p]


class ClassImageDataset:
    """i2w dataset: class = parent directory name, fixed class list, skips
    ``z-other`` (reference ``ClassImageLoader``, ``dataset.py:105-136``)."""

    def __init__(self, paths: Sequence[str], out_size: Optional[int] = None,
                 inf: bool = False, transform=None):
        self.transform = transform
        self.paths = filter_i2w_paths(paths)
        self.classes = WEATHER_CLASSES_I2W
        self.num_classes = len(self.classes)
        self.out_size = out_size
        self.inf = inf

    def __len__(self):
        return len(self.paths)

    def get_class(self, idx: int) -> int:
        return class_id_from_string(self.paths[idx].split(os.sep)[-2])

    def __getitem__(self, idx: int):
        image = _load(self.paths[idx], self.out_size, self.transform)
        target = self.get_class(idx)
        if self.inf:
            return image, target, self.paths[idx]
        return image, target
