"""Evaluation metrics (counterpart of `mxnet_tpu/gluon/metric.py`): the
`EvalMetric` base, its registry (`create`, `register`) and 21 metrics,
computed as the reference computes them.  A metric's state lives on
the host in numpy: ``update`` copies its tensors to the host (one
device-to-host read per tensor), since training loops read metrics in
Python.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import registry

__all__ = [
    "EvalMetric", "create", "register", "CompositeEvalMetric", "Accuracy",
    "TopKAccuracy", "F1", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy",
    "NegativeLogLikelihood", "PearsonCorrelation", "Perplexity", "Loss",
    "CustomMetric", "Fbeta", "BinaryAccuracy", "MeanPairwiseDistance",
    "MeanCosineSimilarity", "PCC", "np",
]


def _as_numpy(x):
    """A host numpy copy of a tensor (bf16/f16 widened to f32), or
    ``onp.asarray(x)``."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return onp.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": type(self).__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):  # pragma: no cover - abstract
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
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


register = registry.get_register_func(EvalMetric, "metric")


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric  # reference create(): instances pass through
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return registry.get_registry("metric").create(metric, *args, **kwargs)


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = metrics if metrics is not None else []

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

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
            names.append(name)
            values.append(value)
        return names, values


def _to_lists(labels, preds):
    if isinstance(labels, (torch.Tensor, onp.ndarray)):
        labels = [labels]
    if isinstance(preds, (torch.Tensor, onp.ndarray)):
        preds = [preds]
    return labels, preds


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = onp.argmax(pred, axis=self.axis)
            pred = pred.astype(onp.int32).reshape(-1)
            label = label.astype(onp.int32).reshape(-1)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names,
                         top_k=top_k)
        self.top_k = top_k
        if top_k <= 1:
            raise ValueError("use Accuracy for top_k=1")

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(onp.int32)
            pred = _as_numpy(pred)
            if pred.ndim != 2:
                raise ValueError(f"TopKAccuracy takes (batch, classes) "
                                 f"predictions; got {pred.shape}")
            topk = onp.argpartition(pred, -self.top_k, axis=1)[:, -self.top_k:]
            hits = (topk == label.reshape(-1, 1)).any(axis=1)
            self.sum_metric += float(hits.sum())
            self.num_inst += len(label)


class _BinaryClassificationCounts:
    def __init__(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred_label):
        self.tp += int(((pred_label == 1) & (label == 1)).sum())
        self.fp += int(((pred_label == 1) & (label == 0)).sum())
        self.tn += int(((pred_label == 0) & (label == 0)).sum())
        self.fn += int(((pred_label == 0) & (label == 1)).sum())

    @property
    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def fscore(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def mcc(self):
        import math
        d = math.sqrt((self.tp + self.fp) * (self.tp + self.fn) *
                      (self.tn + self.fp) * (self.tn + self.fn))
        if d == 0:
            return 0.0
        return (self.tp * self.tn - self.fp * self.fn) / d

    @property
    def total(self):
        return self.tp + self.fp + self.tn + self.fn


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro", threshold=0.5, **kwargs):
        self.average = average
        self.threshold = threshold
        self._counts = _BinaryClassificationCounts()
        super().__init__(name, output_names, label_names, average=average,
                         threshold=threshold, **kwargs)

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).reshape(-1).astype(onp.int32)
            pred = _as_numpy(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred_label = onp.argmax(pred, axis=-1).reshape(-1)
            else:
                pred_label = (pred.reshape(-1) > self.threshold).astype(onp.int32)
            self._counts.update(label, pred_label)

    def reset(self):
        if hasattr(self, "_counts"):
            self._counts = _BinaryClassificationCounts()

    def get(self):
        if self._counts.total == 0:
            return (self.name, float("nan"))
        return (self.name, self._counts.fscore)


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None,
                 threshold=0.5):
        self.threshold = threshold
        self._counts = _BinaryClassificationCounts()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).reshape(-1).astype(onp.int32)
            pred = _as_numpy(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred_label = onp.argmax(pred, axis=-1).reshape(-1)
            else:
                pred_label = (pred.reshape(-1) > self.threshold).astype(onp.int32)
            self._counts.update(label, pred_label)

    def reset(self):
        if hasattr(self, "_counts"):
            self._counts = _BinaryClassificationCounts()

    def get(self):
        if self._counts.total == 0:
            return (self.name, float("nan"))
        return (self.name, self._counts.mcc)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred).reshape(label.shape)
            self.sum_metric += float(onp.abs(label - pred).mean()) * len(label)
            self.num_inst += len(label)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred).reshape(label.shape)
            self.sum_metric += float(((label - pred) ** 2).mean()) * len(label)
            self.num_inst += len(label)


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, (self.sum_metric / self.num_inst) ** 0.5)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype(onp.int64)
            pred = _as_numpy(pred)
            prob = pred[onp.arange(label.shape[0]), label]
            self.sum_metric += float((-onp.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype(onp.int64)
            pred = _as_numpy(pred).reshape(-1, _as_numpy(pred).shape[-1])
            prob = pred[onp.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                prob = onp.where(ignore, 1.0, prob)
                num -= int(ignore.sum())
            loss += -onp.log(onp.maximum(1e-10, prob)).sum()
            num += label.shape[0]
        self.sum_metric += float(loss)
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(onp.exp(self.sum_metric / self.num_inst)))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        self._labels = []
        self._preds = []
        super().reset()

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            self._labels.append(_as_numpy(label).ravel())
            self._preds.append(_as_numpy(pred).ravel())
            self.num_inst += len(self._labels[-1])

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        label = onp.concatenate(self._labels)
        pred = onp.concatenate(self._preds)
        return (self.name, float(onp.corrcoef(label, pred)[0, 1]))


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _labels, preds):
        if isinstance(preds, (torch.Tensor, onp.ndarray)):
            preds = [preds]
        for pred in preds:
            loss = _as_numpy(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 output_names=None, label_names=None):
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                num, value = reval
                self.sum_metric += value
                self.num_inst += num
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", "feval")
    return CustomMetric(feval, name, allow_extra_outputs)


@register
class Fbeta(F1):
    """F-beta score (reference metric.py Fbeta): recall weighted beta^2
    over precision."""

    def __init__(self, name="fbeta", output_names=None, label_names=None,
                 beta=1.0, threshold=0.5):
        super().__init__(name, output_names, label_names, beta=beta,
                         threshold=threshold)
        self.beta = beta

    def get(self):
        if self._counts.total == 0:
            return (self.name, float("nan"))
        p, r = self._counts.precision, self._counts.recall
        b2 = self.beta ** 2
        d = b2 * p + r
        return (self.name, (1 + b2) * p * r / d if d else 0.0)


@register
class BinaryAccuracy(EvalMetric):
    """Accuracy over thresholded binary predictions (reference
    metric.py BinaryAccuracy)."""

    def __init__(self, name="binary_accuracy", output_names=None,
                 label_names=None, threshold=0.5):
        super().__init__(name, output_names, label_names,
                         threshold=threshold)
        self.threshold = threshold

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).reshape(-1)
            pred_label = (_as_numpy(pred).reshape(-1) > self.threshold)
            self.sum_metric += float(
                (pred_label == (label > 0.5)).sum())
            self.num_inst += len(label)


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean p-norm distance between prediction and label vectors
    (reference metric.py MeanPairwiseDistance)."""

    def __init__(self, name="mpd", output_names=None, label_names=None,
                 p=2):
        super().__init__(name, output_names, label_names, p=p)
        self.p = p

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred).reshape(label.shape)
            d = (onp.abs(pred - label) ** self.p).sum(-1) ** (1.0 / self.p)
            self.sum_metric += float(d.sum())
            self.num_inst += d.size


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis (reference metric.py
    MeanCosineSimilarity)."""

    def __init__(self, name="cos_sim", output_names=None, label_names=None,
                 eps=1e-12):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred).reshape(label.shape)
            num = (label * pred).sum(-1)
            den = onp.linalg.norm(label, axis=-1) * \
                onp.linalg.norm(pred, axis=-1)
            sim = num / onp.maximum(den, self.eps)
            self.sum_metric += float(sim.sum())
            self.num_inst += sim.size


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation via the confusion matrix (reference
    metric.py PCC — the k-category generalization of MCC)."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self._cm = None

    def reset(self):
        self._cm = None
        super().reset()

    def update(self, labels, preds):
        labels, preds = _to_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).reshape(-1).astype(onp.int64)
            pred = _as_numpy(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred_label = onp.argmax(pred, axis=-1).reshape(-1)
            else:
                pred_label = (pred.reshape(-1) > 0.5).astype(onp.int64)
            k = int(max(label.max(), pred_label.max())) + 1
            if self._cm is None:
                self._cm = onp.zeros((k, k), onp.float64)
            elif self._cm.shape[0] < k:
                grown = onp.zeros((k, k), onp.float64)
                grown[:self._cm.shape[0], :self._cm.shape[1]] = self._cm
                self._cm = grown
            onp.add.at(self._cm, (label, pred_label), 1)
            self.num_inst = 1  # get() computes from the matrix

    def get(self):
        if self._cm is None:
            return (self.name, float("nan"))
        cm = self._cm
        n = cm.sum()
        t = cm.sum(axis=1)  # true counts
        p = cm.sum(axis=0)  # predicted counts
        c = onp.trace(cm)
        num = c * n - (t * p).sum()
        den = onp.sqrt(n * n - (p * p).sum()) * \
            onp.sqrt(n * n - (t * t).sum())
        return (self.name, float(num / den) if den else 0.0)
