"""Synthetic worlds shared by the port's tests and ``chip_smoke.py``
-- the port of ``weather_unet_tpu/testing.py``: the same i2w class tree,
split pickle and reference-format classifier file, so the port and the JAX
package are exercised on one world.

Reference layout being mirrored: the i2w class tree consumed by
``ClassImageLoader`` (``dataset.py:93-121``) and the train/test split pickle
``t_cls_train.py`` loads (``t_cls_train.py:117-124``).
"""

from __future__ import annotations

import os
import pickle

#: The reference's five i2w weather classes, in its fixed order
#: (t_cls_train.py:105 ``['sunny','cloudy','rain','snow','foggy']``).
I2W_CLASSES = ("sunny", "cloudy", "rain", "snow", "foggy")


def build_i2w_world(root, *, classes=I2W_CLASSES, per_class: int = 3,
                    train_per_class: int = 2, size: int = 40,
                    rng=None) -> dict:
    """Build a tiny i2w world: ``root/i2w/<class>/<j>.jpg`` + a train/test
    split pickle (``{"train": [paths...], "test": [paths...]}``).

    Returns ``{"i2w_dir", "split_pkl", "paths"}``.  ``rng`` is a
    ``numpy.random.Generator`` (fresh seed-0 generator when omitted).
    """
    import numpy as np
    from PIL import Image

    if rng is None:
        rng = np.random.default_rng(0)
    root = str(root)
    i2w = os.path.join(root, "i2w")
    paths = {"train": [], "test": []}
    for cls in classes:
        d = os.path.join(i2w, cls)
        os.makedirs(d, exist_ok=True)
        for j in range(per_class):
            p = os.path.join(d, f"{j}.jpg")
            Image.fromarray(
                rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(p)
            paths["train" if j < train_per_class else "test"].append(p)
    split_pkl = os.path.join(root, "split.pkl")
    with open(split_pkl, "wb") as f:
        pickle.dump(paths, f)
    return {"i2w_dir": i2w, "split_pkl": split_pkl, "paths": paths}


def build_random_classifier_pt(path, *, num_classes: int = 5,
                               input_size: int = 32, seed: int = 0) -> str:
    """Random full-depth ResNet-101 classifier in the reference's ``.pt``
    format (what ``t_cls_train.py:126-133`` torch-loads as the frozen
    weather classifier): a torchvision-named state dict, initialized on the
    CPU from ``seed``.  ``input_size`` is the JAX function's init shape; a
    PyTorch module needs none, so it changes nothing here."""
    import torch

    from weather_unet_tpu_torch.models import ResNet101

    del input_size
    model = ResNet101(num_classes,
                      generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), str(path))
    return str(path)
