"""Evaluation metrics (counterpart of snsde/train/metrics.py, the port's
own numpy copy): accuracy, confusion matrix, AUROC, average precision,
weighted F1, masked MSE. They run on the host on numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

__all__ = ["ClassificationMetrics", "classification_metrics", "auroc",
           "average_precision", "confusion_matrix", "masked_mse"]


def auroc(y_true, y_score) -> float:
    """Rank-based AUROC (Mann–Whitney), ties handled by average rank."""
    y_true = np.asarray(y_true).astype(np.int64).ravel()
    y_score = np.asarray(y_score, np.float64).ravel()
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks for ties
    i = 0
    r = np.arange(1, y_score.size + 1, dtype=np.float64)
    while i < y_score.size:
        j = i
        while j + 1 < y_score.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = r[i : j + 1].mean()
        i = j + 1
    sum_pos = ranks[y_true == 1].sum()
    return float((sum_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def average_precision(y_true, y_score) -> float:
    y_true = np.asarray(y_true).astype(np.int64).ravel()
    y_score = np.asarray(y_score, np.float64).ravel()
    if y_true.sum() == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    tp = np.cumsum(y)
    precision = tp / np.arange(1, y.size + 1)
    return float((precision * y).sum() / y_true.sum())


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    y_true = np.asarray(y_true).astype(np.int64).ravel()
    y_pred = np.asarray(y_pred).astype(np.int64).ravel()
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


@dataclass
class ClassificationMetrics:
    accuracy: float
    loss: float
    confusion: np.ndarray
    dataset_size: int
    auroc: Optional[float] = None
    average_precision: Optional[float] = None
    f1_weighted: Optional[float] = None

    def as_dict(self) -> Dict:
        d = {
            "accuracy": self.accuracy,
            "loss": self.loss,
            "confusion": self.confusion.tolist(),
            "dataset_size": self.dataset_size,
        }
        if self.auroc is not None:
            d["auroc"] = self.auroc
        if self.average_precision is not None:
            d["average_precision"] = self.average_precision
        if self.f1_weighted is not None:
            d["f1_weighted"] = self.f1_weighted
        return d


def weighted_f1(cm: np.ndarray) -> float:
    """Weighted-average F1 from a confusion matrix (UEA robustness metric,
    reference model_run.py:270)."""
    support = cm.sum(axis=1)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)
    total = support.sum()
    if total == 0:
        return float("nan")
    return float((f1 * support).sum() / total)


def classification_metrics(y_true, logits, loss: float,
                           num_classes: int) -> ClassificationMetrics:
    """Binary: logits [N] (threshold at 0, AUROC/AP on raw logits, matching
    the reference). Multiclass: logits [N, C] (argmax)."""
    y_true = np.asarray(y_true)
    logits = np.asarray(logits)
    if num_classes == 2 and (logits.ndim == 1 or logits.shape[-1] == 1):
        # single-logit binary head (reference classification harness)
        logits = logits.reshape(-1)
        pred = (logits > 0).astype(np.int64)
    else:
        # softmax head (torch-ists style, incl. 2-class CE)
        pred = np.argmax(logits, axis=-1)
        if num_classes == 2:
            logits = logits[..., 1] - logits[..., 0]  # score for AUROC/AP
    cm = confusion_matrix(y_true, pred, num_classes)
    acc = float((pred.ravel() == y_true.ravel()).mean())
    m = ClassificationMetrics(
        accuracy=acc,
        loss=float(loss),
        confusion=cm,
        dataset_size=int(y_true.shape[0]),
        f1_weighted=weighted_f1(cm),
    )
    if num_classes == 2:
        m.auroc = auroc(y_true, logits)
        m.average_precision = average_precision(y_true, logits)
    return m


def masked_mse(truth, pred, mask) -> float:
    """Interpolation metric: MSE over observed entries only
    (reference benchmark_interpolation/utils.py:34-37)."""
    truth = np.asarray(truth, np.float64)
    pred = np.asarray(pred, np.float64)
    mask = np.asarray(mask, np.float64)
    denom = mask.sum()
    if denom == 0:
        return float("nan")
    return float(((truth - pred) ** 2 * mask).sum() / denom)
