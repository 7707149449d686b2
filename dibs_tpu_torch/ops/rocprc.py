"""ROC / precision-recall metrics with numpy sort+cumsum on the host
(copy of ``dibs_tpu/ops/rocprc.py``, which is already free of JAX; these run
post-hoc on tiny ``d*d`` score vectors). Conventions match
``sklearn.metrics``:

  * ``roc_curve``: points at each distinct threshold (descending), with the
    (0, 0) origin prepended; no intermediate dropping.
  * ``precision_recall_curve``: curve truncated once full recall is attained,
    returned in increasing-threshold order with the terminal
    ``(recall=0, precision=1)`` point appended.
  * ``average_precision_score``: step-function area ``sum (R_n - R_{n-1}) P_n``.
  * ``auc``: trapezoidal area; handles monotonically decreasing ``x``.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "roc_curve",
    "precision_recall_curve",
    "auc",
    "average_precision_score",
]


def _binary_curve_counts(y_true, y_score):
    """Cumulative TP/FP counts at each distinct descending threshold."""
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score).astype(np.float64).ravel()

    order = np.argsort(-y_score, kind="stable")
    y_true = y_true[order]
    y_score = y_score[order]

    # indices of the last occurrence of each distinct score
    distinct = np.where(np.diff(y_score))[0]
    threshold_idx = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idx]
    fps = 1 + threshold_idx - tps
    thresholds = y_score[threshold_idx]
    return fps, tps, thresholds


def roc_curve(y_true, y_score):
    """Returns ``(fpr, tpr, thresholds)`` with the (0, 0) origin prepended."""
    fps, tps, thresholds = _binary_curve_counts(y_true, y_score)
    fps = np.r_[0.0, fps]
    tps = np.r_[0.0, tps]
    thresholds = np.r_[np.inf, thresholds]

    n_pos = tps[-1]
    n_neg = fps[-1]
    tpr = tps / n_pos if n_pos > 0 else np.zeros_like(tps)
    fpr = fps / n_neg if n_neg > 0 else np.zeros_like(fps)
    return fpr, tpr, thresholds


def precision_recall_curve(y_true, y_score):
    """Returns ``(precision, recall, thresholds)`` with sklearn conventions."""
    fps, tps, thresholds = _binary_curve_counts(y_true, y_score)

    n_pos = tps[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tps + fps > 0, tps / (tps + fps), 0.0)
    recall = tps / n_pos if n_pos > 0 else np.ones_like(tps)

    # truncate once full recall is reached (sklearn behavior)
    last_ind = int(np.searchsorted(tps, tps[-1]))
    precision = precision[: last_ind + 1]
    recall = recall[: last_ind + 1]
    thresholds = thresholds[: last_ind + 1]

    # reverse to increasing-threshold order, append terminal (R=0, P=1)
    return (
        np.r_[precision[::-1], 1.0],
        np.r_[recall[::-1], 0.0],
        thresholds[::-1],
    )


def auc(x, y):
    """Trapezoidal area under ``y(x)`` for monotonic ``x`` (either direction)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    dx = np.diff(x)
    if dx.size == 0:
        raise ValueError("auc requires at least 2 points")
    direction = 1.0
    if np.all(dx <= 0):
        direction = -1.0
    elif not np.all(dx >= 0):
        raise ValueError("x is neither increasing nor decreasing")
    # np.trapezoid is numpy >= 2.0; older installs only have np.trapz
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(direction * trapezoid(y, x))


def average_precision_score(y_true, y_score):
    """AP = sum over thresholds of ``(R_n - R_{n-1}) * P_n``."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    # curve is in decreasing-recall order after the conventions above
    return float(-np.sum(np.diff(recall) * precision[:-1]))
