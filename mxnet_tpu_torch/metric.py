"""Evaluation metrics of the port (counterpart of ``mxnet_tpu/metric.py``;
reference: python/mxnet/metric.py).

``Accuracy`` and ``Perplexity`` compute their per-batch statistic with
torch ops on the predictions' device and add it into a running tensor
there, as the JAX package accumulates on the device: nothing waits for
the card until :meth:`EvalMetric.get` (once per epoch in ``fit``).
``CrossEntropy`` and the composite metric complete what ``create``
offers in this slice; F1, MAE/MSE/RMSE, TopK, Loss and custom metrics
wait for ROADMAP A4.
"""
from __future__ import annotations

import torch

from .base import string_types
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "Perplexity",
           "CrossEntropy", "create"]


def _tensor(x, device=None):
    t = x.data if isinstance(x, NDArray) else torch.as_tensor(x)
    return t.detach() if device is None else t.detach().to(device)


def check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(len(labels), len(preds)))


class EvalMetric:
    """Base class: ``sum_metric / num_inst``."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def get(self):
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [x / y if y != 0 else float("nan")
                  for x, y in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class _DeviceSumMetric(EvalMetric):
    """A metric whose per-update statistic is a tensor ``[sum, count]``
    added into a running tensor per device; folded on :meth:`get`."""

    def reset(self):
        super().reset()
        self._acc = {}

    def _add(self, stat):
        acc = self._acc.get(stat.device)
        self._acc[stat.device] = stat if acc is None else acc + stat

    def get(self):
        for acc in self._acc.values():
            s, n = acc.double().cpu().tolist()
            self.sum_metric += s
            self.num_inst += int(round(n))
        self._acc = {}
        return super().get()


class Accuracy(_DeviceSumMetric):
    """Classification accuracy; predictions are argmaxed over ``axis`` when
    their shape differs from the labels'."""

    def __init__(self, axis=1, name="accuracy"):
        super().__init__(name)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _tensor(pred)
            lab = _tensor(label, p.device)
            if p.dim() > 1 and tuple(p.shape) != tuple(lab.shape):
                p = torch.argmax(p, dim=self.axis)
            ids = p.reshape(-1).to(torch.int32)
            lab = lab.reshape(-1).to(torch.int32)
            if ids.numel() != lab.numel():
                raise ValueError("Shape of labels %d does not match shape of "
                                 "predictions %d" % (lab.numel(), ids.numel()))
            hits = (ids == lab).sum().to(torch.float64)
            self._add(torch.stack([hits, hits.new_tensor(float(lab.numel()))]))


class Perplexity(_DeviceSumMetric):
    """exp(mean negative log-likelihood), averaged per update weighted by
    its token count, as the reference: each update adds
    ``exp(nll / n) * n`` and ``n``. Labels equal to ``ignore_label`` count
    neither in the loss nor in ``n``."""

    def __init__(self, ignore_label, axis=-1, name="Perplexity"):
        super().__init__(name)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("labels and preds differ in length")
        nll = None
        n = None
        for label, pred in zip(labels, preds):
            p = _tensor(pred)
            lab = _tensor(label, p.device).reshape(-1).to(torch.int64)
            if lab.numel() * p.shape[-1] != p.numel():
                raise ValueError("shape mismatch: %s vs. %s"
                                 % (tuple(lab.shape), tuple(p.shape)))
            # a clamped index: an ignored label such as -1 must not read
            # outside the row on the card
            probs = p.reshape(-1, p.shape[-1]).gather(
                1, lab.clamp(0, p.shape[-1] - 1)[:, None])[:, 0]
            cnt = torch.tensor(float(lab.numel()), device=p.device)
            if self.ignore_label is not None:
                ign = lab == int(self.ignore_label)
                cnt = cnt - ign.sum()
                probs = torch.where(ign, 1.0, probs)
            loss = -torch.log(torch.clamp_min(probs, 1e-10)).sum()
            nll = loss if nll is None else nll + loss
            n = cnt if n is None else n + cnt
        # the exp over the update's totals in float64, as the host path of
        # the JAX package folds into Python floats
        n = torch.clamp_min(n, 1.0).to(torch.float64)
        nll = nll.to(torch.float64)
        self._add(torch.stack([torch.exp(nll / n) * n, n]))


class CrossEntropy(EvalMetric):
    """Mean of -log p[label] (+ eps), on the host."""

    def __init__(self, eps=1e-12, name="cross-entropy"):
        super().__init__(name)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab = _tensor(label, "cpu").reshape(-1).to(torch.int64)
            p = _tensor(pred, "cpu")
            prob = p[torch.arange(lab.shape[0]), lab]
            self.sum_metric += float((-torch.log(prob + self.eps)).sum())
            self.num_inst += lab.shape[0]


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite", **kwargs)
        self.metrics = [create(m) if isinstance(m, str) else m for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str) else metric)

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, results = [], []
        for metric in self.metrics:
            name, result = metric.get()
            if isinstance(name, string_types):
                name, result = [name], [result]
            names.extend(name)
            results.extend(result)
        return (names, results)


def create(metric, **kwargs):
    """A metric by name, an EvalMetric as it is, or a composite of a list."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    metrics = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
               "perplexity": Perplexity}
    try:
        return metrics[metric.lower()](**kwargs)
    except (KeyError, AttributeError):
        raise ValueError("Metric must be in {}".format(sorted(metrics))) from None
