"""Metrics (``paddle_tpu.metric`` counterpart): ``accuracy``, ``Metric``,
``Accuracy``, ``Precision``, ``Recall``. Inputs are the port's
``Tensor``s, torch tensors or arrays; the metrics accumulate on the host
in numpy, as the JAX package's do."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "accuracy"]


def _np(x):
    if isinstance(x, Tensor):
        x = x._value
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu() if x.dtype == torch.bfloat16 else \
            x.detach().cpu()
        return x.numpy()
    return np.asarray(x)


def accuracy(input, label, k=1):
    """Top-k accuracy: the share of rows whose label is among the k
    largest logits (ties broken as a descending stable sort breaks
    them), on the logits' device."""
    logits = input._value if isinstance(input, Tensor) else input
    lab = (label._value if isinstance(label, Tensor) else label).reshape(-1)
    # JAX's argsort(...)[::-1]: among equal logits the later index first
    idx = torch.argsort(logits.flip(-1), dim=-1, descending=True,
                        stable=True)
    topk = logits.shape[-1] - 1 - idx[..., :k]
    correct = (topk == lab[:, None]).any(dim=-1).float()
    # XLA's mean: the sum times the fp32 reciprocal of the count
    inv = torch.tensor(1.0 / correct.numel(), dtype=torch.float32,
                       device=correct.device)
    return Tensor(correct.sum() * inv)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()


class Accuracy(Metric):
    def __init__(self, topk=(1,), name="acc"):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        pred_np = _np(pred)
        lab = _np(label).reshape(-1)
        maxk = max(self.topk)
        idx = np.argsort(-pred_np, axis=-1)[:, :maxk]
        correct = idx == lab[:, None]
        return Tensor(torch.from_numpy(np.asarray(correct, np.float32)))

    def update(self, correct):
        c = _np(correct)
        for i, k in enumerate(self.topk):
            self.total[i] += c[:, :k].any(axis=-1).sum()
            self.count[i] += c.shape[0]
        return self.accumulate()

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds) > 0.5
        l = _np(labels).astype(bool)
        self.tp += int((p & l).sum())
        self.fp += int((p & ~l).sum())

    def accumulate(self):
        ap = self.tp + self.fp
        return self.tp / ap if ap else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds) > 0.5
        l = _np(labels).astype(bool)
        self.tp += int((p & l).sum())
        self.fn += int((~p & l).sum())

    def accumulate(self):
        al = self.tp + self.fn
        return self.tp / al if al else 0.0

    def name(self):
        return self._name
