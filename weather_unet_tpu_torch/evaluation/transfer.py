"""Transfer-consistency evaluation -- the compute functions of
``weather_unet_tpu/evaluation/transfer.py`` (rebuilds of the reference's
``eval/eval_class_transfer.py``, ``eval_estimator_transfer.py``,
``eval_classifier_i2w.py`` and ``eval_estimator.py``).

Each takes a ``WeatherTransfer`` and a ``classify`` / ``estimate`` callable
(``cli.common.load_estimator`` returns one) over NHWC images in [-1, 1].
The translate + re-classify / re-estimate compute runs on the transfer's
device, without autograd (the callables may be differentiable); the results
come back as numpy arrays.  The classification report and confusion matrix
that the JAX package takes from scikit-learn are computed here in numpy
(the GPU host has no scikit-learn), with its formulas and its text layout.
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


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (scikit-learn's ``zero_division=0``)."""
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    out = np.zeros(np.broadcast(num, den).shape)
    np.divide(num, den, out=out, where=den != 0)
    return out


def _prf(tp, pred_sum, true_sum):
    """precision, recall, F1 (``2 tp / (true + pred)``) with zero_division
    0, as scikit-learn's ``precision_recall_fscore_support`` forms them."""
    return (_safe_div(tp, pred_sum), _safe_div(tp, true_sum),
            _safe_div(2 * tp, true_sum + pred_sum))


def classification_report_dict(y_true, y_pred, class_names) -> Dict:
    """scikit-learn's ``classification_report`` over labels
    ``0..len(class_names)-1`` with ``zero_division=0`` (the dict and the
    printable ``text``, two digits) and its ``confusion_matrix``
    (``eval_class_transfer.py:126-143``).  Rows are the true label,
    columns the prediction."""
    y_true = np.asarray(y_true).astype(np.int64).ravel()
    y_pred = np.asarray(y_pred).astype(np.int64).ravel()
    names = list(class_names)
    k = len(names)
    inside = ((y_true >= 0) & (y_true < k) & (y_pred >= 0) & (y_pred < k))
    cm = np.zeros((k, k), dtype=np.int64)
    np.add.at(cm, (y_true[inside], y_pred[inside]), 1)
    tp = np.diag(cm)
    true_sum = np.array([(y_true == i).sum() for i in range(k)])
    pred_sum = np.array([(y_pred == i).sum() for i in range(k)])
    p, r, f1 = _prf(tp, pred_sum, true_sum)
    headers = ["precision", "recall", "f1-score", "support"]
    report = {n: dict(zip(headers, map(float, (p[i], r[i], f1[i],
                                               true_sum[i]))))
              for i, n in enumerate(names)}
    # the micro average is the accuracy when every label seen is listed
    micro_is_accuracy = bool(inside.all())
    micro = _prf(tp.sum(), pred_sum.sum(), true_sum.sum())
    weights = true_sum if true_sum.sum() else None
    averages = [
        ("accuracy" if micro_is_accuracy else "micro avg", micro),
        ("macro avg", (p.mean(), r.mean(), f1.mean())),
        ("weighted avg", tuple(
            float(np.average(v, weights=weights)) if weights is not None
            else 0.0 for v in (p, r, f1)))]
    support = int(true_sum.sum())

    width = max(max(len(n) for n in names), len("weighted avg"), 2)
    text = ("{:>{width}s} " + " {:>9}" * 4).format("", *headers,
                                                   width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.2f}" * 3 + " {:>9}\n"
    for i, n in enumerate(names):
        text += row_fmt.format(n, p[i], r[i], f1[i], int(true_sum[i]),
                               width=width)
    text += "\n"
    for heading, (ap, ar, af) in averages:
        report[heading] = dict(zip(headers, map(float, (ap, ar, af,
                                                        support))))
        if heading == "accuracy":
            text += ("{:>{width}s} " + " {:>9}" * 2 + " {:>9.2f} {:>9}\n"
                     ).format(heading, "", "", float(af), support,
                              width=width)
        else:
            text += row_fmt.format(heading, ap, ar, af, support, width=width)
    if micro_is_accuracy:
        report["accuracy"] = report["accuracy"]["precision"]
    return {"report": report, "text": text, "confusion_matrix": cm}


def write_confusion_artifacts(output_dir: str, cm, class_names) -> None:
    """The reference evals' on-disk artifacts: ``cm.pkl`` (a pandas
    DataFrame with class-named axes) and the ``pr_table.png`` heatmap
    (``eval_classifier_i2w.py:106-114``, ``eval_class_transfer.py:126-143``).
    Plotting is best-effort: without matplotlib and seaborn it prints why it
    was skipped."""
    import os

    import pandas as pd

    names = list(class_names)
    df = pd.DataFrame(np.asarray(cm), index=names, columns=names)
    df.to_pickle(os.path.join(output_dir, "cm.pkl"))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns

        fig, ax = plt.subplots(figsize=(6, 5))
        sns.heatmap(df, square=True, annot=True, fmt="d", ax=ax)
        ax.set_xlabel("predicted")
        ax.set_ylabel("true/requested")
        fig.savefig(os.path.join(output_dir, "pr_table.png"),
                    bbox_inches="tight")
        plt.close(fig)
    except Exception as e:  # plotting is best-effort
        print(f"pr_table.png skipped: {type(e).__name__}: {e}")


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
