"""Transfer-consistency evaluation -- the compute functions of
``weather_unet_tpu/evaluation/transfer.py`` (rebuilds of the reference's
``eval/eval_class_transfer.py``, ``eval_estimator_transfer.py``,
``eval_classifier_i2w.py`` and ``eval_estimator.py``).

Each takes a ``WeatherTransfer`` and a ``classify`` / ``estimate`` callable
(``cli.common.load_estimator`` returns one) over NHWC images in [-1, 1].
The translate + re-classify / re-estimate compute runs on the transfer's
device, without autograd (the callables may be differentiable); the results
come back as numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


@torch.no_grad()
def class_transfer_consistency(transfer, classify: Callable,
                               batches: Iterable, num_classes: int = 5):
    """Translate every batch to each class, re-classify the outputs, and
    return ``(y_true = requested class, y_pred = classifier readback)``."""
    if num_classes != transfer.model.num_classes:
        raise ValueError(f"num_classes={num_classes} but the transfer model "
                         f"has {transfer.model.num_classes} classes")
    y_true, y_pred = [], []
    for batch in batches:
        fakes = transfer.translate_to_classes(batch)        # (K, B, H, W, 3)
        k, b = fakes.shape[:2]
        logits = torch.as_tensor(classify(fakes.reshape(k * b,
                                                        *fakes.shape[2:])))
        preds = logits.argmax(dim=1).reshape(k, b).cpu().numpy()
        for ci in range(k):
            y_true.extend([ci] * b)
            y_pred.extend(preds[ci].tolist())
    return np.asarray(y_true), np.asarray(y_pred)


@torch.no_grad()
def estimator_transfer_consistency(transfer, estimate: Callable,
                                   batches: Iterable, *,
                                   sigma: Optional[np.ndarray] = None) -> Dict:
    """CROSS-conditioned transfer consistency: for each reference sample j of
    a ``(images, conds)`` batch, the WHOLE batch is translated to j's
    signals and one row ``mean_over_batch(estimate(fake) - conds[j])`` is
    appended -- B rows per batch, each SIGNED per column.

    One reference condition at a time: B whole-batch forwards at once would
    hold B^2 images of activations.

    Returns per-column stats over the rows: ``signed_mean`` / ``signed_std``,
    abs-error stats ``l1_mean`` / ``l1_std``, de-normalized twins when
    ``sigma`` is given, and the raw ``rows``."""
    rows = []
    for batch, conds in batches:
        x = torch.as_tensor(batch).to(transfer.device)
        conds = torch.as_tensor(conds).to(transfer.device)
        for c in conds:
            cc = c[None, :].expand(x.shape[0], -1)
            fake = transfer.translate(x, cc, bucket=False)
            est = torch.as_tensor(estimate(fake)).to(transfer.device)
            rows.append(_np((est.float() - cc.float()).mean(dim=0)))
    e = np.stack(rows, axis=0)
    out = {"signed_mean": e.mean(axis=0), "signed_std": e.std(axis=0),
           "l1_mean": np.abs(e).mean(axis=0), "l1_std": np.abs(e).std(axis=0),
           "rows": e}
    if sigma is not None:
        s = np.asarray(sigma)
        out["signed_mean_denorm"] = out["signed_mean"] * s
        out["signed_std_denorm"] = out["signed_std"] * s
        out["l1_mean_denorm"] = out["l1_mean"] * s
        out["l1_std_denorm"] = out["l1_std"] * s
    return out


@torch.no_grad()
def classifier_accuracy(classify: Callable, batches: Iterable):
    """``(y_true, y_pred, paths)`` over labeled batches ``(images, labels)``
    or ``(images, labels, paths)``; ``paths`` is empty when never given."""
    y_true, y_pred, paths = [], [], []
    for batch in batches:
        x, labels = batch[0], batch[1]
        p = torch.as_tensor(classify(x)).argmax(dim=1).cpu().numpy()
        y_pred.extend(p.tolist())
        y_true.extend(_np(labels).astype(int).tolist())
        if len(batch) > 2:
            paths.extend(list(batch[2]))
    return np.asarray(y_true), np.asarray(y_pred), paths


@torch.no_grad()
def estimator_errors(estimate: Callable, batches: Iterable, *,
                     sigma: Optional[np.ndarray] = None) -> Dict:
    """Per-column estimator-vs-ground-truth errors over ``(images, signals)``
    batches: the SIGNED mean (``pred - signals``) with a std over per-sample
    rows, both also de-normalized by ``sigma``; abs-mean and mse as extra
    info."""
    errs = []
    for batch, signals in batches:
        errs.append(_np(estimate(batch)) - _np(signals))
    e = np.concatenate(errs, axis=0)
    out = {"signed_l1": e,
           "signed_mean": e.mean(axis=0), "signed_std": e.std(axis=0),
           "l1_mean": np.abs(e).mean(axis=0),
           "mse_mean": (e ** 2).mean(axis=0)}
    if sigma is not None:
        s = np.asarray(sigma)
        out["signed_mean_denorm"] = out["signed_mean"] * s
        out["signed_std_denorm"] = out["signed_std"] * s
        out["l1_mean_denorm"] = out["l1_mean"] * s
    return out
