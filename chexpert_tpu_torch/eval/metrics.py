"""Evaluation metrics: per-class ROC curve, AUC, precision-recall, mean loss.

The port's copy of chexpert_tpu/eval/metrics.py: pure numpy with
sklearn-identical outputs (sklearn's roc_curve/auc/precision_recall_curve
are what the reference uses, chexpert.py:130-146); the card host has no
sklearn.

compute_metrics returns the same JSON-serializable dict shape the reference
saves to eval_results_step_N.json and later re-plots: fpr/tpr/aucs/precision/
recall keyed by class index + per-class mean loss. AUC is NaN when a class
has a single ground-truth value (reference relies on sklearn's NaN +
np.nanmean at chexpert.py:189 — preserve NaN tolerance).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Cumulative TPs/FPs at decreasing score thresholds (sklearn internals)."""
    if y_true.size == 0:
        raise ValueError("empty y_true passed to a classification curve")
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]
    # indices of distinct score values
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true: np.ndarray, y_score: np.ndarray, drop_intermediate: bool = True):
    """sklearn.metrics.roc_curve parity (fpr, tpr, thresholds)."""
    y_true = np.asarray(y_true).astype(np.float64)
    y_score = np.asarray(y_score).astype(np.float64)
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)

    if drop_intermediate and len(fps) > 2:
        optimal = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps, tps, thresholds = fps[optimal], tps[optimal], thresholds[optimal]

    # prepend (0, 0) point
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]

    if fps[-1] <= 0:
        fpr = np.full_like(fps, np.nan, dtype=np.float64)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        tpr = np.full_like(tps, np.nan, dtype=np.float64)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under curve (sklearn.metrics.auc parity)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.size < 2 or np.any(np.isnan(x)) or np.any(np.isnan(y)):
        return float("nan")
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1.0
        else:
            return float("nan")
    return float(direction * np.trapezoid(y, x))


def precision_recall_curve(y_true: np.ndarray, y_score: np.ndarray):
    """sklearn.metrics.precision_recall_curve parity."""
    y_true = np.asarray(y_true).astype(np.float64)
    y_score = np.asarray(y_score).astype(np.float64)
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps, dtype=np.float64), where=ps != 0)
    if tps[-1] == 0:  # no positives: recall defined as 1 everywhere
        recall = np.ones_like(tps, dtype=np.float64)
    else:
        recall = tps / tps[-1]
    # reverse so recall is decreasing; append the (precision 1, recall 0) end
    return np.r_[precision[::-1], 1], np.r_[recall[::-1], 0], thresholds[::-1]


def compute_metrics(
    outputs: np.ndarray, targets: np.ndarray, losses: np.ndarray
) -> Dict:
    """Reference-shaped metrics dict (chexpert.py:130-146)."""
    outputs = np.asarray(outputs)
    targets = np.asarray(targets)
    losses = np.asarray(losses)
    n_classes = outputs.shape[1]
    fpr, tpr, aucs, precision, recall = {}, {}, {}, {}, {}
    for i in range(n_classes):
        f, t, _ = roc_curve(targets[:, i], outputs[:, i])
        fpr[i], tpr[i] = f.tolist(), t.tolist()
        aucs[i] = auc(f, t)
        p, r, _ = precision_recall_curve(targets[:, i], outputs[:, i])
        precision[i], recall[i] = p.tolist(), r.tolist()
    return {
        "fpr": fpr,
        "tpr": tpr,
        "aucs": aucs,
        "precision": precision,
        "recall": recall,
        "loss": dict(enumerate(losses.mean(0).tolist())),
    }


def avg_auc(metrics: Dict) -> float:
    """np.nanmean over per-class AUCs (reference chexpert.py:189)."""
    return float(np.nanmean(list(metrics["aucs"].values())))


def sum_loss(metrics: Dict) -> float:
    return float(np.sum(list(metrics["loss"].values())))
