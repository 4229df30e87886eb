"""Metrics (the counterpart of ``paddle_tpu/metric/__init__.py``):
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and the
functional ``accuracy``.

``Accuracy.compute`` runs ``torch.topk`` where the predictions are (on
the card for a model there); ``update`` and the others accumulate on the
host in numpy, with the JAX package's arithmetic, so the same
predictions and labels give the same numbers in both packages.  Reading
a metric waits for the card, as it does in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


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
        """What ``update`` takes, computed where the predictions are; the
        identity by default."""
        return args


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """A (N, maxk) f32 tensor: 1 where the i-th highest prediction is
        the label (an index, a (N, 1) index or a one-hot row)."""
        pred, label = _tensor(pred), _tensor(label)
        idx = torch.topk(pred, self.maxk, dim=-1).indices
        lab = label.to(idx.device)
        if lab.dim() == idx.dim():
            lab = lab[..., 0] if lab.shape[-1] == 1 else lab.argmax(-1)
        return (idx == lab[..., None]).to(torch.float32)

    def update(self, correct, *args):
        c = _numpy(correct)
        num = c.shape[0] if c.ndim else 1
        for i, k in enumerate(self.topk):
            self.total[i] += c[..., :k].sum()
        self.count += num
        out = [t / max(self.count, 1) for t in self.total]
        return out[0] if len(out) == 1 else out

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        out = [t / max(self.count, 1) for t in self.total]
        return out[0] if len(out) == 1 else out

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of predictions thresholded at 0.5."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_pos = (_numpy(preds) > 0.5).astype(np.int64).ravel()
        lab = _numpy(labels).ravel()
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fp += int(((pred_pos == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of predictions thresholded at 0.5."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_pos = (_numpy(preds) > 0.5).astype(np.int64).ravel()
        lab = _numpy(labels).ravel()
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fn += int(((pred_pos == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` + 1 buckets of the positive
    class's score (the second column of a (N, 2) prediction)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _numpy(preds)
        lab = _numpy(labels).ravel()
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.ravel()
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        pos = lab.astype(bool)
        np.add.at(self._stat_pos, idx[pos], 1)
        np.add.at(self._stat_neg, idx[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate from the highest threshold down
        pos = self._stat_pos[::-1].cumsum()
        neg = self._stat_neg[::-1].cumsum()
        return float(np.trapezoid(pos / tot_pos, neg / tot_neg))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` highest
    predictions, a 0-d f32 tensor where ``input`` is."""
    input, label = _tensor(input), _tensor(label)
    idx = torch.topk(input, k, dim=-1).indices
    lab = label.to(idx.device)
    if lab.dim() == idx.dim():
        lab = lab[..., 0]
    return (idx == lab[..., None]).any(dim=-1).to(torch.float32).mean()
