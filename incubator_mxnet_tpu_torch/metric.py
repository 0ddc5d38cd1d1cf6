"""Evaluation metrics.

Counterpart of ``incubator_mxnet_tpu/metric.py`` (ref: python/mxnet/metric.py
— EvalMetric base + registry, CompositeEvalMetric, Accuracy, TopKAccuracy,
F1, MCC, Perplexity, MAE/MSE/RMSE, CrossEntropy, NegativeLogLikelihood,
PearsonCorrelation, Loss, CustomMetric/np).

When every input of an update is an NDArray, the update's reduction runs
in torch on the arrays' device and its scalar is queued; the queue is read
back in one transfer at ``get()``, so per-batch updates do not wait for the
card. Host inputs (numpy, lists) are reduced eagerly in numpy, with the
reference's host semantics. Both paths are NaN-safe: a non-finite update
is counted in ``num_nan`` and dropped with its count.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import registry_get
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
           "CustomMetric", "np", "create", "register"]

_REG = registry_get("metric")


def register(klass):
    _REG.register(klass)
    return klass


def create(metric, *args, **kwargs):
    """(ref: metric.py create) Accepts name, callable, instance, or list."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if isinstance(metric, EvalMetric):
        return metric
    return _REG.create(metric, *args, **kwargs)


def _dev_data(*xs):
    """The tensors when EVERY input is an NDArray (moved to the first one's
    device), else None: the host path."""
    if not all(isinstance(x, NDArray) for x in xs):
        return None
    dev = xs[0]._data.device
    return [x._data.to(dev) for x in xs]


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def _align_rank(label, pred):
    """(N,) vs (N, 1) compare elementwise, not broadcast to (N, N)."""
    if label.ndim == 1:
        label = label.reshape(label.shape[0], 1)
    if pred.ndim == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label, pred


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if isinstance(labels, NDArray):
        labels = [labels]
    if isinstance(preds, NDArray):
        preds = [preds]
    if len(labels) != len(preds):
        raise ValueError(f"Shape of labels {len(labels)} does not match shape "
                         f"of predictions {len(preds)}")
    return labels, preds


def _binary_counts(p, l):
    """(tp, fp, fn, tn) of {0, 1} predictions and labels, float32."""
    p1, l1 = p.reshape(-1) == 1, l.reshape(-1) == 1
    return torch.stack([(p1 & l1).sum(), (p1 & ~l1).sum(),
                        (~p1 & l1).sum(), (~p1 & ~l1).sum()]).float()


class EvalMetric:
    """Base metric (ref: metric.py:68)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.num_nan = 0
        self._dev = []        # queued (sum, count) device scalars

    def _host_accum(self, value, n=1):
        if math.isfinite(value):
            self.sum_metric += value
            self.num_inst += n
        else:
            self.num_nan += 1

    def _dev_accum(self, s, n):
        """Queue a device scalar sum and its count (an int or a scalar)."""
        self._dev.append((s, n))

    def _drain(self):
        """Read every queued device scalar back in one transfer."""
        if not self._dev:
            return
        vals = torch.stack([torch.stack([torch.as_tensor(s).double().cpu(),
                                         torch.as_tensor(n).double().cpu()])
                            for s, n in self._dev]).tolist()
        self._dev = []
        for s, n in vals:
            self._host_accum(s, int(n))

    def get(self):
        self._drain()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": type(self).__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    """(ref: metric.py:278)"""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register
class Accuracy(EvalMetric):
    """(ref: metric.py:440)"""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            dev = _dev_data(label, pred)
            if dev is not None:
                lab, p = dev
                # any shape difference means pred still carries a class axis
                if p.shape != lab.shape:
                    p = torch.argmax(p, dim=self.axis)
                p = p.reshape(-1).to(torch.int32)
                lab = lab.reshape(-1).to(torch.int32)
                if p.numel() != lab.numel():
                    raise ValueError(
                        f"Accuracy: {p.numel()} predictions vs "
                        f"{lab.numel()} labels after argmax/flatten")
                self._dev_accum((p == lab).sum(), lab.numel())
                continue
            label, pred = _as_np(label), _as_np(pred)
            if pred.shape != label.shape:
                pred = _np.argmax(pred, axis=self.axis)
            pred = pred.astype(_np.int32).flatten()
            label = label.astype(_np.int32).flatten()
            if len(pred) != len(label):
                raise ValueError(
                    f"Accuracy: {len(pred)} predictions vs {len(label)} "
                    "labels after argmax/flatten")
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    """(ref: metric.py:TopKAccuracy)"""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            dev = _dev_data(label, pred)
            if dev is not None:
                lab, p = dev
                assert p.dim() == 2, \
                    "Predictions should be no more than 2 dims"
                idx = torch.topk(p, self.top_k, dim=1).indices
                hits = (idx == lab.to(torch.int64)[:, None]).any(dim=1)
                self._dev_accum(hits.sum(), lab.shape[0])
                continue
            label, pred = _as_np(label), _as_np(pred)
            assert pred.ndim == 2, "Predictions should be no more than 2 dims"
            topk_idx = _np.argpartition(pred, -self.top_k,
                                        axis=1)[:, -self.top_k:]
            label = label.astype(_np.int32)
            hits = (topk_idx == label[:, None]).any(axis=1)
            self.sum_metric += float(hits.sum())
            self.num_inst += len(label)


class _BinaryCounts(EvalMetric):
    """F1 and MCC: per-batch (tp, fp, fn, tn) counts, macro (a score per
    batch, averaged) or micro (one score of the running counts)."""

    def __init__(self, name, output_names, label_names, average):
        self.average = average
        super().__init__(name, output_names, label_names, average=average)

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = self.tn = 0.0
        self._dev_counts = []

    def _score(self, tp, fp, fn, tn):
        raise NotImplementedError

    def _apply_counts(self, tp, fp, fn, tn):
        if self.average == "micro":
            self.tp += tp
            self.fp += fp
            self.fn += fn
            self.tn += tn
            self.sum_metric = self._score(self.tp, self.fp, self.fn, self.tn)
            self.num_inst = 1
        else:
            self.sum_metric += self._score(tp, fp, fn, tn)
            self.num_inst += 1

    def _drain(self):
        if getattr(self, "_dev_counts", None):
            counts = torch.stack([c.cpu() for c in self._dev_counts]).tolist()
            self._dev_counts = []
            for tp, fp, fn, tn in counts:
                self._apply_counts(tp, fp, fn, tn)
        super()._drain()

    def _check_host_labels(self, label):
        pass

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            dev = _dev_data(label, pred)
            if dev is not None:
                lab, p = dev
                if p.dim() > 1:
                    p = torch.argmax(p, dim=1)
                self._dev_counts.append(_binary_counts(p, lab))
                continue
            label, pred = _as_np(label).flatten(), _as_np(pred)
            if pred.ndim > 1:
                pred = _np.argmax(pred, axis=1)
            pred = pred.flatten()
            self._check_host_labels(label)
            tp = float(((pred == 1) & (label == 1)).sum())
            fp = float(((pred == 1) & (label == 0)).sum())
            fn = float(((pred == 0) & (label == 1)).sum())
            tn = float(((pred == 0) & (label == 0)).sum())
            self._apply_counts(tp, fp, fn, tn)


@register
class F1(_BinaryCounts):
    """Binary F1 (ref: metric.py:F1; average='macro'|'micro')."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)

    def _score(self, tp, fp, fn, tn):
        prec = tp / max(tp + fp, 1e-12)
        rec = tp / max(tp + fn, 1e-12)
        return 2 * prec * rec / max(prec + rec, 1e-12)

    def _check_host_labels(self, label):
        assert set(_np.unique(label)) <= {0, 1}, \
            "F1 currently only supports binary classification."


@register
class MCC(_BinaryCounts):
    """Matthews correlation coefficient (ref: metric.py:MCC)."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)

    def _score(self, tp, fp, fn, tn):
        denom = math.sqrt(max((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn),
                              1e-12))
        return (tp * tn - fp * fn) / denom


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-likelihood of the labels (ref:
    metric.py:Perplexity); the word LM's metric."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            dev = _dev_data(label, pred)
            if dev is not None:
                lab, p = dev
                lab = lab.reshape(-1).to(torch.int64)
                probs = torch.gather(p.reshape(-1, p.shape[-1]), 1,
                                     lab[:, None])[:, 0]
                n = torch.tensor(lab.shape[0], device=lab.device)
                if self.ignore_label is not None:
                    ign = lab == self.ignore_label
                    probs = torch.where(ign, torch.ones_like(probs), probs)
                    n = n - ign.sum()
                s = -torch.log(torch.clamp(probs, min=1e-10)).sum()
                self._dev_accum(s, n)
                continue
            label = _as_np(label).astype(_np.int64).reshape(-1)
            pred = _as_np(pred).reshape(-1, _as_np(pred).shape[-1])
            probs = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= float(_np.sum(_np.log(_np.maximum(1e-10, probs))))
            num += label.shape[0]
        if num:
            self._host_accum(loss, num)

    def get(self):
        self._drain()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


class _Regression(EvalMetric):
    """MAE, MSE, RMSE: one value per (label, pred) pair, averaged."""

    @staticmethod
    def _value(d):
        raise NotImplementedError

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            dev = _dev_data(label, pred)
            if dev is not None:
                lab, p = _align_rank(*dev)
                self._dev_accum(self._value(lab.float() - p.float()), 1)
                continue
            label, pred = _align_rank(_as_np(label), _as_np(pred))
            self._host_accum(float(self._value(label - pred)))


@register
class MAE(_Regression):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _value(d):
        return abs(d).mean()


@register
class MSE(_Regression):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _value(d):
        return (d * d).mean()


@register
class RMSE(_Regression):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _value(d):
        return (d * d).mean() ** 0.5


@register
class CrossEntropy(EvalMetric):
    """(ref: metric.py:1278)"""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            dev = _dev_data(label, pred)
            if dev is not None:
                lab, p = dev
                assert lab.numel() == p.shape[0]
                prob = torch.gather(p, 1, lab.reshape(-1, 1).to(torch.int64))
                self._dev_accum(-torch.log(prob + self.eps).sum(), p.shape[0])
                continue
            label = _as_np(label).ravel().astype(_np.int64)
            pred = _as_np(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), label]
            self._host_accum(float((-_np.log(prob + self.eps)).sum()),
                             label.shape[0])


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


_REG.register(NegativeLogLikelihood, "nll_loss")


@register
class PearsonCorrelation(EvalMetric):
    """(ref: metric.py:PearsonCorrelation)"""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            dev = _dev_data(label, pred)
            if dev is not None:
                lab, p = dev
                both = torch.stack([lab.reshape(-1).float(),
                                    p.reshape(-1).float()])
                self._dev_accum(torch.corrcoef(both)[0, 1], 1)
                continue
            label, pred = _as_np(label).ravel(), _as_np(pred).ravel()
            self._host_accum(float(_np.corrcoef(label, pred)[0, 1]))


@register
class Loss(EvalMetric):
    """Mean of a loss output (ref: metric.py:Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            if isinstance(pred, NDArray):
                self._dev_accum(pred._data.sum(), pred._data.numel())
                continue
            loss = float(_as_np(pred).sum())
            self._host_accum(loss, _as_np(pred).size)


class CustomMetric(EvalMetric):
    """Wrap fn(label, pred) -> float (ref: metric.py:CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label, pred = _as_np(label), _as_np(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Create a CustomMetric from a numpy function (ref: metric.py:np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


@register
class Torch(Loss):
    """Deprecated alias of Loss (ref: metric.py:Torch)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Torch):
    """Deprecated alias of Loss (ref: metric.py:Caffe)."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


_REG.register(Accuracy, "acc")
_REG.register(TopKAccuracy, "top_k_accuracy")
_REG.register(TopKAccuracy, "top_k_acc")
_REG.register(CrossEntropy, "ce")
_REG.register(NegativeLogLikelihood, "nll-loss")
_REG.register(PearsonCorrelation, "pearsonr")
