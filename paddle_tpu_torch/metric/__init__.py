"""Metrics — port of ``paddle_tpu/metric/__init__.py``: the ``Metric``
base, ``Accuracy`` (top-k), ``Precision``, ``Recall`` and ``Auc``.

They implement the ``compute``/``update``/``accumulate``/``reset``/``name``
contract that ``hapi.Model`` calls (``prepare(metrics=...)``, then
``evaluate``). The counting runs on the host in numpy, as the
reference's does: a tensor on the card is copied back first (bfloat16
read as float32).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-processing of (pred, label) before ``update``
        (host-side, as in the reference)."""
        return args


class Accuracy(Metric):
    """top-k accuracy (reference: metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        order = np.argsort(-pred, axis=-1)[..., :self.maxk]
        if label.ndim == pred.ndim and label.shape[-1] == 1:
            label = label[..., 0]  # paddle's [N, 1] class-index labels
        elif label.ndim == pred.ndim:  # one-hot / soft labels
            label = label.argmax(-1)
        correct = order == label[..., None]
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        for i, k in enumerate(self.topk):
            num = correct[..., :k].sum()
            self.total[i] += num
            self.count[i] += correct[..., :1].size
        acc = self.total / np.maximum(self.count, 1)
        return acc[0] if len(self.topk) == 1 else acc

    def accumulate(self):
        acc = self.total / np.maximum(self.count, 1)
        return float(acc[0]) if len(self.topk) == 1 else acc.tolist()

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision over probability predictions (reference semantics:
    pred > 0.5 counts positive)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds).ravel() > 0.5).astype(np.int64)
        y = _np(labels).ravel().astype(np.int64)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fp += int(((p == 1) & (y == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds).ravel() > 0.5).astype(np.int64)
        y = _np(labels).ravel().astype(np.int64)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fn += int(((p == 0) & (y == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via the reference's thresholded-bucket accumulation
    (metrics.py Auc: num_thresholds bins, trapezoid area)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        n = self._num_thresholds + 1
        self._stat_pos = np.zeros(n)
        self._stat_neg = np.zeros(n)

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]  # prob of the positive class
        preds = preds.ravel()
        labels = _np(labels).ravel().astype(np.int64)
        idx = np.clip((preds * self._num_thresholds).astype(np.int64), 0,
                      self._num_thresholds)
        np.add.at(self._stat_pos, idx[labels == 1], 1)
        np.add.at(self._stat_neg, idx[labels == 0], 1)

    def accumulate(self):
        # walk thresholds high→low accumulating TP/FP; trapezoid area
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = np.concatenate([[0.0], tp / tot_pos])
        fpr = np.concatenate([[0.0], fp / tot_neg])
        # the trapezoid rule written out (np.trapezoid needs numpy >= 2)
        return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2))

    def name(self):
        return self._name
