"""Frame-level AUC-ROC, NumPy-only.

Standalone equivalent of sklearn.metrics.roc_auc_score for binary labels
(the reference's final metric, models/mocodad.py:428), via the
rank-statistic (Mann-Whitney U) identity with average-rank tie handling —
exactly equal to the trapezoidal ROC integral sklearn computes.
"""

from __future__ import annotations

import numpy as np


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based average ranks with ties sharing their mean rank."""
    _, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
    csum = np.cumsum(counts)
    start = csum - counts + 1
    return ((start + csum) / 2.0)[inv]


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, dtype=np.float64)
    if y_true.shape != y_score.shape or y_true.ndim != 1:
        raise ValueError('y_true and y_score must be 1-D of equal length')
    if np.isnan(y_score).any():
        # match sklearn: a NaN score must fail loudly — np.unique sorts
        # NaN last, so it would otherwise silently rank as the MAXIMAL
        # anomaly score and corrupt the reported AUC
        raise ValueError('Input contains NaN')
    pos = y_true > 0
    n_pos = int(pos.sum())
    n_neg = int(y_true.shape[0] - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError(
            'Only one class present in y_true. ROC AUC score is not defined.')
    ranks = _average_ranks(y_score)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """(fpr, tpr, thresholds) over the distinct score values, descending —
    sklearn-equivalent for binary labels (used by the ROC plot helper,
    ref: utils/eval_utils.py:116-130)."""
    y_true = np.asarray(y_true) > 0
    y_score = np.asarray(y_score, dtype=np.float64)
    if y_true.all() or not y_true.any():
        # consistent with roc_auc_score above: a single-class y_true has
        # no defined curve (silently returning zeros would render a
        # bogus flat ROC plot)
        raise ValueError('roc_curve is undefined for single-class y_true')
    order = np.argsort(-y_score, kind='mergesort')
    ys, yt = y_score[order], y_true[order]
    distinct = np.where(np.diff(ys))[0]
    idx = np.r_[distinct, yt.size - 1]
    tps = np.cumsum(yt)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    thresholds = ys[idx]
    return (np.r_[0.0, fpr], np.r_[0.0, tpr],
            np.r_[thresholds[0] + 1, thresholds])
