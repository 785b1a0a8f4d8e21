"""Evaluation metrics (counterpart of auformer/metrics/metrics.py; reference
metrics/accf1.py, metrics/cccmetric.py), in numpy: accumulate on the host,
reduce at epoch end.

EX: macro F1 + accuracy with class 7 ignored. AU: per-column binary F1
averaged over the 12 AUs, accuracy over the total labelled-cell count. VA:
CCC with the biased std and the post-mask length. ``composite_scores``
gives the challenge scores (train.py:162-164).

``f1_score`` and ``accuracy_score`` compute what sklearn.metrics' functions
of those names compute for these arguments, sklearn being absent on the
card's machine: the F-score of a label is 2 tp / (true + predicted) in
float64 and 0 where both counts are 0 (sklearn's ``zero_division="warn"``
value, without the warning); a macro average runs over the sorted union of
the labels in ``y_true`` and ``y_pred``; ``average="binary"`` scores label 1
and refuses more than two labels, or two without label 1; an empty input
raises, as sklearn does.
"""
from __future__ import annotations

import numpy as np


def _check_inputs(y_true: np.ndarray, y_pred: np.ndarray) -> None:
    if y_true.shape != y_pred.shape:
        raise ValueError(f"inconsistent numbers of samples: {y_true.shape} "
                         f"and {y_pred.shape}")
    if y_true.size == 0:
        raise ValueError("Found empty input array (e.g., `y_true` or "
                         "`y_pred`) while a minimum of 1 sample is required.")


def f1_score(y_true, y_pred, average: str = "macro") -> float:
    """sklearn.metrics.f1_score for ``average`` "macro" or "binary"
    (pos_label 1) on label vectors."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    _check_inputs(y_true, y_pred)
    labels = np.union1d(y_true, y_pred)
    if average == "binary":
        if len(labels) > 2:
            raise ValueError("Target is multiclass but average='binary'. "
                             "Please choose another average setting.")
        if len(labels) == 2 and 1 not in labels:
            raise ValueError(f"pos_label=1 is not a valid label. It should "
                             f"be one of {labels}")
        labels = np.array([1])
    elif average != "macro":
        raise NotImplementedError(f"average={average!r}")
    is_true = y_true[None, :] == labels[:, None]
    is_pred = y_pred[None, :] == labels[:, None]
    tp = (is_true & is_pred).sum(axis=1).astype(np.float64)
    denom = (is_true.sum(axis=1) + is_pred.sum(axis=1)).astype(np.float64)
    f = np.where(denom > 0, 2.0 * tp / np.where(denom > 0, denom, 1.0), 0.0)
    return float(np.average(f))


def accuracy_score(y_true, y_pred, normalize: bool = True) -> float:
    """sklearn.metrics.accuracy_score: the share (or, with ``normalize``
    False, the count) of equal labels."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    _check_inputs(y_true, y_pred)
    equal = y_true == y_pred
    return float(np.average(equal)) if normalize else float(equal.sum())


def acc_f1_score(y_true, y_pred, ignore_index=None, normalize=False,
                 average="macro"):
    """Multi-class f1 + accuracy over non-ignored labels
    (reference accf1.py:5-17)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    keep = (y_true != ignore_index if ignore_index is not None
            else np.ones_like(y_true, dtype=bool))
    y_true = y_true[keep]
    y_pred = y_pred[keep]
    f1 = f1_score(y_true, y_pred, average=average)
    acc = accuracy_score(y_true, y_pred, normalize=normalize)
    return acc, f1


class AccF1Metric:
    """EX metric (reference accf1.py:20-42)."""

    def __init__(self, ignore_index, average="macro"):
        self.ignore_index = ignore_index
        self.average = average
        self.clear()

    def update(self, y_pred, y_true):
        self.y_pred.append(np.asarray(y_pred).reshape(-1))
        self.y_true.append(np.asarray(y_true).reshape(-1))

    def clear(self):
        self.y_pred, self.y_true = [], []

    def get(self):
        return acc_f1_score(y_true=np.concatenate(self.y_true),
                            y_pred=np.concatenate(self.y_pred),
                            average=self.average, normalize=True,
                            ignore_index=self.ignore_index)


class MultiLabelAccF1:
    """AU metric (reference accf1.py:45-77): per-AU binary F1 averaged;
    acc = sum of per-column correct counts / total labelled cells."""

    def __init__(self, ignore_index=None, average="binary"):
        self.ignore_index = ignore_index
        self.average = average
        self.clear()

    def update(self, y_pred, y_true):
        self.y_pred.append(np.asarray(y_pred))
        self.y_true.append(np.asarray(y_true))

    def clear(self):
        self.y_pred, self.y_true = [], []

    def get(self):
        y_true = np.vstack(self.y_true)
        y_pred = np.vstack(self.y_pred)
        labeled = np.sum(y_true != self.ignore_index)
        acc = 0.0
        f1s = []
        for i in range(y_pred.shape[1]):
            acc_i, f1_i = acc_f1_score(
                y_true=y_true[:, i], y_pred=y_pred[:, i],
                average=self.average, normalize=False,
                ignore_index=self.ignore_index)
            acc += acc_i
            f1s.append(f1_i)
        acc = acc / labeled if labeled else 0.0
        return acc, float(np.mean(f1s))


def ccc(y_true, y_pred, ignore=-5.0):
    """Lin's CCC with biased std and post-mask batch size
    (reference cccmetric.py:4-34)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    keep = y_true != ignore
    y_true = y_true[keep]
    y_pred = y_pred[keep]
    if len(y_true) <= 1:
        return 0.0
    n = len(y_pred)
    x_m, y_m = np.mean(y_pred), np.mean(y_true)
    x_std, y_std = np.std(y_true), np.std(y_pred)   # biased, as reference
    s_xy = np.sum((y_pred - x_m) * (y_true - y_m))
    denom = x_std ** 2 + y_std ** 2 + (x_m - y_m) ** 2 + 1e-8
    return float(2 * s_xy / (denom * n))


def cccva(y_true, y_pred, ignore=-5.0):
    """(N,2) V/A CCC pair + mean (reference cccmetric.py:37-51)."""
    ccc_v = ccc(y_true[:, 0], y_pred[:, 0], ignore)
    ccc_a = ccc(y_true[:, 1], y_pred[:, 1], ignore)
    return ccc_v, ccc_a, (ccc_v + ccc_a) / 2


class CCCMetric:
    """VA metric accumulator (reference cccmetric.py:72-89)."""

    def __init__(self, ignore_index=-5.0):
        self.ignore = ignore_index
        self.clear()

    def update(self, y_pred, y_true):
        self.y_pred.append(np.asarray(y_pred))
        self.y_true.append(np.asarray(y_true))

    def clear(self):
        self.y_pred, self.y_true = [], []

    def get(self):
        return cccva(np.vstack(self.y_true), np.vstack(self.y_pred),
                     ignore=self.ignore)


def composite_scores(metric_ex: AccF1Metric, metric_au: MultiLabelAccF1,
                     metric_va: CCCMetric) -> dict:
    """Challenge composite scores (reference train.py:160-164)."""
    acc_ex, f1_ex = metric_ex.get()
    acc_au, f1_au = metric_au.get()
    ccc_v, ccc_a, ccc_m = metric_va.get()
    return {
        "EX": {"acc": acc_ex, "f1": f1_ex,
               "score": 0.67 * f1_ex + 0.33 * acc_ex},
        "AU": {"acc": acc_au, "f1": f1_au,
               "score": 0.5 * f1_au + 0.5 * acc_au},
        "VA": {"ccc_v": ccc_v, "ccc_a": ccc_a, "score": ccc_m},
    }
