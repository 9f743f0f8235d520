"""Evaluation metrics of the port (counterpart of ``mxnet_tpu/metric.py``;
reference: python/mxnet/metric.py).

``Accuracy``, ``TopKAccuracy`` and ``Perplexity`` compute their
per-batch statistic with torch ops on the predictions' device and add it
into a running tensor there, as the JAX package accumulates on the
device: nothing waits for the card until :meth:`EvalMetric.get` (once
per epoch in ``fit``), so a CUDA graph step reads no logits to the host.
``F1``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``, ``Loss`` (and its
``Torch``/``Caffe`` names) and ``CustomMetric`` (``np``) compute on the
host, as the JAX package does, and so does ``MApMetric`` (VOC mean
average precision of ``MultiBoxDetection`` rows, the JAX package's
matching protocol).
"""
from __future__ import annotations

import math

import numpy
import torch

from .base import string_types
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy", "Loss",
           "Torch", "Caffe", "CustomMetric", "MApMetric", "np", "create"]


def _tensor(x, device=None):
    t = x.data if isinstance(x, NDArray) else torch.as_tensor(x)
    return t.detach() if device is None else t.detach().to(device)


def _host(x):
    """An NDArray, tensor or array-like as a numpy array."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
    return numpy.asarray(x)


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))


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


class TopKAccuracy(_DeviceSumMetric):
    """Share of samples whose label is among the ``top_k`` highest
    predictions (``torch.topk`` on the predictions' device; 1-d
    predictions are class ids)."""

    def __init__(self, top_k=1, name="top_k_accuracy"):
        super().__init__(name)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more than 1")
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _tensor(pred)
            if p.dim() > 2:
                raise ValueError("Predictions should be no more than 2 dims")
            lab = _tensor(label, p.device).reshape(-1).to(torch.int32)
            if lab.numel() != p.shape[0]:
                raise ValueError("Shape of labels %d does not match shape of "
                                 "predictions %d" % (lab.numel(), p.shape[0]))
            if p.dim() == 1:
                hits = p.to(torch.int32) == lab
            else:
                k = min(p.shape[1], self.top_k)
                top = torch.topk(p.float(), k, dim=1).indices.to(torch.int32)
                hits = (top == lab[:, None]).any(dim=1)
            hits = hits.sum().to(torch.float64)
            self._add(torch.stack([hits, hits.new_tensor(float(p.shape[0]))]))


class F1(EvalMetric):
    """Binary F1 of the argmax predictions, averaged over updates."""

    def __init__(self, name="f1"):
        super().__init__(name)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred_label = numpy.argmax(_host(pred), axis=1)
            label_np = _host(label).astype("int32")
            check_label_shapes(label_np, pred_label)
            if len(numpy.unique(label_np)) > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            tp = float(numpy.sum((pred_label == 1) & (label_np == 1)))
            fp = float(numpy.sum((pred_label == 1) & (label_np == 0)))
            fn = float(numpy.sum((pred_label == 0) & (label_np == 1)))
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            if precision + recall > 0:
                f1_score = 2 * precision * recall / (precision + recall)
            else:
                f1_score = 0.0
            self.sum_metric += f1_score
            self.num_inst += 1


class _Regression(EvalMetric):
    """Mean of a per-update error of (label, pred), 1-d labels as a
    column."""

    def _error(self, label, pred):
        raise NotImplementedError()

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label_np = _host(label)
            if len(label_np.shape) == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            self.sum_metric += self._error(label_np, _host(pred))
            self.num_inst += 1


class MAE(_Regression):
    def __init__(self, name="mae"):
        super().__init__(name)

    def _error(self, label, pred):
        return numpy.abs(label - pred).mean()


class MSE(_Regression):
    def __init__(self, name="mse"):
        super().__init__(name)

    def _error(self, label, pred):
        return ((label - pred) ** 2.0).mean()


class RMSE(_Regression):
    def __init__(self, name="rmse"):
        super().__init__(name)

    def _error(self, label, pred):
        return numpy.sqrt(((label - pred) ** 2.0).mean())


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


class Loss(EvalMetric):
    """Mean of the raw outputs (for ``MakeLoss`` nets)."""

    def __init__(self, name="loss"):
        super().__init__(name)

    def update(self, _, preds):
        for pred in preds:
            p = _host(pred)
            self.sum_metric += numpy.sum(p)
            self.num_inst += p.size


class Torch(Loss):
    def __init__(self, name="torch"):
        super().__init__(name)


class Caffe(Loss):
    def __init__(self, name="caffe"):
        super().__init__(name)


class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays: a value per update, or a
    (sum, count) pair."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_host(label), _host(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


class MApMetric(EvalMetric):
    """Mean average precision for detection, VOC-style.

    (Reference: example/ssd/evaluate/eval_metric.py MApMetric — same
    update contract and matching protocol.)

    ``update(labels, preds)``:

    * ``labels[0]``: ``(batch, max_objects, >=5)`` ground truth, rows
      ``[cls, x0, y0, x1, y1, (difficult)]``, ``cls < 0`` = padding —
      exactly what ``ImageDetRecordIter`` emits;
    * ``preds[pred_idx]``: ``(batch, num_dets, 6)`` rows
      ``[cls, score, x0, y0, x1, y1]`` — ``MultiBoxDetection`` output,
      ``cls < 0`` = suppressed.

    Per-class AP uses VOC07 11-point interpolation by default
    (``voc07=False`` switches to all-points precision-envelope
    integration). With ``class_names``, ``get()`` returns each class AP
    plus the mean; otherwise just the mean.
    """

    def __init__(self, ovp_thresh=0.5, use_difficult=False,
                 class_names=None, pred_idx=0, voc07=True,
                 score_thresh=0.0):
        self.ovp_thresh = float(ovp_thresh)
        self.use_difficult = bool(use_difficult)
        self.class_names = list(class_names) if class_names else None
        self.pred_idx = int(pred_idx)
        self.voc07 = bool(voc07)
        self.score_thresh = float(score_thresh)
        super().__init__("mAP")

    def reset(self):
        # per class: list of (score, is_tp); ground-truth count
        self._records = {}
        self._npos = {}
        self._img = 0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        gts = _host(labels[0])
        dets = _host(preds[self.pred_idx])
        for i in range(gts.shape[0]):
            gt = gts[i][gts[i, :, 0] >= 0]
            difficult = (gt[:, 5] > 0 if gt.shape[1] > 5
                         else numpy.zeros(gt.shape[0], bool))
            if self.use_difficult:
                difficult = numpy.zeros(gt.shape[0], bool)
            for c in numpy.unique(gt[:, 0]).astype(int):
                mask = gt[:, 0] == c
                self._npos[c] = (self._npos.get(c, 0)
                                 + int((mask & ~difficult).sum()))
            det = dets[i][(dets[i, :, 0] >= 0)
                          & (dets[i, :, 1] >= self.score_thresh)]
            # VOC protocol: each detection (best score first) matches its
            # HIGHEST-IoU same-class gt; a second match of a taken gt is a
            # false positive, not a match of the next-best gt
            taken = numpy.zeros(gt.shape[0], bool)
            for row in det[numpy.argsort(-det[:, 1])]:
                c = int(row[0])
                cand = numpy.where(gt[:, 0] == c)[0]
                best_iou, best_j = 0.0, -1
                if cand.size:
                    g = gt[cand]
                    iw = (numpy.minimum(row[4], g[:, 3])
                          - numpy.maximum(row[2], g[:, 1]))
                    ih = (numpy.minimum(row[5], g[:, 4])
                          - numpy.maximum(row[3], g[:, 2]))
                    inter = numpy.maximum(iw, 0.0) * numpy.maximum(ih, 0.0)
                    union = ((row[4] - row[2]) * (row[5] - row[3])
                             + (g[:, 3] - g[:, 1]) * (g[:, 4] - g[:, 2])
                             - inter)
                    iou = numpy.where(union > 0, inter / union, 0.0)
                    k = int(iou.argmax())
                    best_iou, best_j = float(iou[k]), int(cand[k])
                rec = self._records.setdefault(c, [])
                if best_j >= 0 and best_iou >= self.ovp_thresh:
                    if difficult[best_j]:
                        continue  # matched a difficult gt: ignore entirely
                    if taken[best_j]:
                        rec.append((float(row[1]), 0))  # duplicate: FP
                    else:
                        taken[best_j] = True
                        rec.append((float(row[1]), 1))
                else:
                    rec.append((float(row[1]), 0))
            self._img += 1
        self.num_inst = self._img

    def _class_ap(self, c):
        npos = self._npos.get(c, 0)
        if npos == 0:
            return float("nan")
        rec = sorted(self._records.get(c, []), key=lambda r: -r[0])
        tp = numpy.cumsum([r[1] for r in rec]) if rec else numpy.zeros(0)
        n = numpy.arange(1, len(rec) + 1)
        recall = tp / npos if len(rec) else numpy.zeros(0)
        precision = tp / n if len(rec) else numpy.zeros(0)
        if self.voc07:
            ap = 0.0
            for k in range(11):
                # t - 1e-9: recall==k/10 computed as tp/npos must not miss
                # its own threshold to float error
                hit = recall >= (k / 10.0 - 1e-9)
                ap += (precision[hit].max() if hit.any() else 0.0) / 11.0
            return float(ap)
        # all-points: integrate the precision envelope over recall
        mrec = numpy.concatenate([[0.0], recall, [1.0]])
        mpre = numpy.concatenate([[0.0], precision, [0.0]])
        for k in range(len(mpre) - 2, -1, -1):
            mpre[k] = max(mpre[k], mpre[k + 1])
        idx = numpy.where(mrec[1:] != mrec[:-1])[0]
        return float(numpy.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

    def get(self):
        classes = sorted(self._npos)
        aps = [self._class_ap(c) for c in classes]
        mean = (float(numpy.nanmean(aps))
                if aps and not all(math.isnan(a) for a in aps)
                else float("nan"))
        if self.class_names is None:
            return (self.name, mean)
        by_c = dict(zip(classes, aps))
        names = self.class_names + ["mAP"]
        values = [by_c.get(i, float("nan"))
                  for i in range(len(self.class_names))] + [mean]
        return (names, values)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A CustomMetric from a numpy ``feval(label, pred)``."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


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
    """A metric by name, an EvalMetric as it is, a CustomMetric of a
    callable, or a composite of a list."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    metrics = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
               "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
               "top_k_accuracy": TopKAccuracy, "topkaccuracy": TopKAccuracy,
               "perplexity": Perplexity, "loss": Loss, "torch": Torch,
               "caffe": Caffe, "map": MApMetric, "mapmetric": MApMetric}
    try:
        return metrics[metric.lower()](**kwargs)
    except (KeyError, AttributeError):
        raise ValueError("Metric must be in {}".format(sorted(metrics))) from None
