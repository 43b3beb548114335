"""Evaluation metrics: ``Accuracy``, ``TopKAccuracy``, ``CrossEntropy``,
``CompositeEvalMetric`` and ``create``.

The JAX package's contract: ``update(labels, preds)`` over lists of
NDArrays, ``get() -> (name, value)``, ``sum_metric`` / ``num_inst``.
Each update computes its batch total on the predictions' device and
queues it there; reading the metric (``get``, ``sum_metric``) fetches
every queued total at once, so a training step on the card is not held
up by a copy to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "CrossEntropy",
           "CompositeEvalMetric", "create", "check_label_shapes"]

_REGISTRY = {}


def _register(*names):
    def deco(cls):
        for n in names:
            _REGISTRY[n] = cls
        return cls
    return deco


def check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise ValueError(f"labels {len(labels)} and predictions "
                         f"{len(preds)} do not match")


def _pair(label, pred):
    """(label, pred) as tensors on the prediction's device."""
    p = pred.astorch() if isinstance(pred, NDArray) \
        else torch.as_tensor(np.asarray(pred))
    lab = label.astorch() if isinstance(label, NDArray) \
        else torch.as_tensor(np.asarray(label))
    return lab.to(p.device), p.detach()


class EvalMetric:
    """A running (sum, count) with a named readout."""

    def __init__(self, name):
        self.name = name
        self.reset()

    def reset(self):
        self._sum_metric, self._num_inst = 0.0, 0
        self._pending = []          # (device scalar total, count)

    def _accumulate(self, total, count):
        self._pending.append((total, count))

    def _flush(self):
        pend, self._pending = self._pending, []
        for total, count in pend:
            self._sum_metric += float(total)
            self._num_inst += int(count)

    @property
    def sum_metric(self):
        self._flush()
        return self._sum_metric

    @property
    def num_inst(self):
        self._flush()
        return self._num_inst

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        self._flush()
        return self.name, (self._sum_metric / self._num_inst
                           if self._num_inst else float("nan"))

    def get_name_value(self):
        names, values = self.get()
        if not isinstance(names, list):
            names, values = [names], [values]
        return list(zip(names, values))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    """Fan an update out to several child metrics."""

    def __init__(self, metrics=None, name="composite"):
        self.metrics = [create(m) for m in (metrics or [])]
        super().__init__(name)

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        out = [m.get() for m in self.metrics]
        return [n for n, _ in out], [v for _, v in out]


@_register("acc", "accuracy")
class Accuracy(EvalMetric):
    """Fraction of argmax predictions equal to the integer label."""

    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab, p = _pair(label, pred)
            if p.ndim > 1 and p.shape != lab.shape:
                p = p.argmax(dim=-1)
            lab = lab.to(torch.int32).reshape(-1)
            self._accumulate((p.to(torch.int32).reshape(-1) == lab).sum(),
                             lab.numel())


@_register("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """Label among the k highest-scoring classes (ties: whichever k
    ``torch.topk`` picks)."""

    def __init__(self, top_k=1):
        if top_k <= 1:
            raise ValueError("top_k must exceed 1 (use Accuracy otherwise)")
        super().__init__(f"top_k_accuracy_{top_k}")
        self.top_k = top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab, p = _pair(label, pred)
            lab = lab.to(torch.int64).reshape(-1)
            if p.ndim == 1:
                hits = (p.to(torch.int64) == lab).sum()
            else:
                top = p.topk(min(self.top_k, p.shape[1]), dim=1).indices
                hits = (top == lab[:, None]).any(dim=1).sum()
            self._accumulate(hits, lab.numel())


@_register("ce", "cross-entropy")
class CrossEntropy(EvalMetric):
    """Mean -log p(target) over per-class probability rows."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, prob in zip(labels, preds):
            lab, p = _pair(label, prob)
            lab = lab.to(torch.int64).reshape(-1)
            if lab.shape[0] != p.shape[0]:
                raise ValueError(f"{lab.shape[0]} labels for {p.shape[0]} "
                                 "rows of probabilities")
            p_t = p[torch.arange(lab.shape[0], device=p.device), lab]
            self._accumulate(-torch.log(p_t + self.eps).sum(), lab.numel())


def create(metric, **kwargs):
    """Resolve a metric from a name, an instance or a list."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m, **kwargs))
        return out
    try:
        return _REGISTRY[metric.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None
