"""Evaluation metrics (counterpart of ``mvfnet_tpu/utils/metrics.py``).

Same math as the reference's accuracy module
(``codes/core/evaluation/accuracy.py:4-124``): top-k accuracy,
confusion-matrix mean-class accuracy, numerically-stable softmax, and weighted
late score fusion. Implemented vectorized in numpy (the reference loops per
sample); results are identical.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Union

import numpy as np


def softmax(x: np.ndarray, axis: int = 1) -> np.ndarray:
    e_x = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return e_x / e_x.sum(axis=axis, keepdims=True)


def top_k_accuracy(scores: Union[Sequence[np.ndarray], np.ndarray],
                   labels: Sequence[int],
                   k: Iterable[int] = (1,)) -> List[float]:
    """Fraction of samples whose true label is within the top-k scores.

    Ties broken identically to ``np.argsort`` (stable, last-k slice) to match
    the reference's ``top_k_hit`` (``accuracy.py:77-79``).
    """
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    order = np.argsort(scores, axis=1)  # ascending
    res = []
    for kk in k:
        topk = order[:, -kk:]
        hits = (topk == labels[:, None]).any(axis=1)
        res.append(float(np.mean(hits)))
    return res


def confusion_matrix(y_pred: np.ndarray, y_real: np.ndarray) -> np.ndarray:
    """Confusion matrix over the union of observed labels (rows=real)."""
    y_pred = np.asarray(y_pred, dtype=np.int64)
    y_real = np.asarray(y_real, dtype=np.int64)
    label_set = np.unique(np.concatenate((y_pred, y_real)))
    index = {label: i for i, label in enumerate(label_set)}
    n = len(label_set)
    mat = np.zeros((n, n), dtype=np.int64)
    for r, p in zip(y_real, y_pred):
        mat[index[r], index[p]] += 1
    return mat


def mean_class_accuracy(scores: Union[Sequence[np.ndarray], np.ndarray],
                        labels: Sequence[int]) -> float:
    scores = np.asarray(scores)
    pred = np.argmax(scores, axis=1)
    cf = confusion_matrix(pred, np.asarray(labels)).astype(float)
    cls_cnt = cf.sum(axis=1)
    cls_hit = np.diag(cf)
    accs = [hit / cnt if cnt else 0.0 for cnt, hit in zip(cls_cnt, cls_hit)]
    return float(np.mean(accs))


def get_weighted_score(score_list: Sequence[Sequence[np.ndarray]],
                       coeff_list: Sequence[float]) -> List[np.ndarray]:
    """Late fusion: sum_i coeff_i * score_i, per sample."""
    assert len(score_list) == len(coeff_list)
    scores = np.array(score_list)          # (n, num_samples, num_classes)
    coeff = np.array(coeff_list)           # (n,)
    weighted = np.tensordot(coeff, scores, axes=(0, 0))
    return list(weighted)
