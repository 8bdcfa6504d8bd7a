"""Loss functions (counterpart of `mxnet_tpu/gluon/loss.py`): the `Loss`
base and its 14 losses, in the reference's formulas.  As in the
reference, ``sample_weight`` multiplies the per-element losses, then
``weight``, and the result is averaged over every axis but
``batch_axis``."""
from __future__ import annotations

import math

import torch

from .. import numpy_extension as npx
from .block import HybridBlock

__all__ = [
    "Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
    "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "KLDivLoss",
    "CTCLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss", "LogisticLoss",
    "TripletLoss", "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss",
]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label if label.shape == pred.shape else label.reshape(pred.shape)


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    return loss.mean(dim=axes) if axes else loss


def _softplus_neg_abs(x):
    """log(1 + exp(-|x|)), as the reference spells it."""
    return torch.log(1.0 + torch.exp(-torch.abs(x)))


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L1Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.abs(label - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of sigmoid(pred) (``from_sigmoid``: pred is
    already a probability), ``pos_weight`` scaling the positive term."""

    def __init__(self, from_sigmoid=False, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    _softplus_neg_abs(pred)
            else:
                log_w = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_w * (
                    _softplus_neg_abs(pred) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label +
                         torch.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight +
                         torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy of softmax(pred) along ``axis``: with
    ``sparse_label`` the label is the class index and the loss picks
    that class's log-probability; otherwise the label is a distribution
    of pred's shape.  ``from_logits`` takes pred as log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = npx.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -npx.pick(pred, label, axis=self._axis)
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = npx.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


def _ctc_nll(logits_tnc, labels_nl, in_len, lab_len):
    """The reference's CTC recursion: log-space alpha over the
    blank-interleaved labels (blank 0, -1e30 for log 0), in f32, each
    sample's alpha frozen once t reaches its ``in_len``; the loss is
    -log(alpha[2L] + alpha[max(2L - 1, 0)]) at the end, so an empty
    label counts its one path twice (log 2 below torch's
    ``ctc_loss``), as the reference's does."""
    t_max, n, c = logits_tnc.shape
    l_max = labels_nl.shape[1]
    dev = logits_tnc.device
    logp = torch.log_softmax(logits_tnc.float(), dim=-1)
    s = 2 * l_max + 1
    ext = torch.zeros((n, s), dtype=torch.long, device=dev)
    ext[:, 1::2] = labels_nl.long()
    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    in_len = in_len.to(dev).long()
    lab_len = lab_len.to(dev).long()
    first = torch.gather(logp[0], 1, ext[:, 1:2])[:, 0]
    alpha = torch.cat([logp[0, :, :1],
                       torch.where(lab_len > 0, first, neg_inf)[:, None],
                       neg_inf.expand(n, s - 2)], dim=1)
    same_as_prev2 = torch.cat([torch.ones((n, 2), dtype=torch.bool,
                                          device=dev),
                               ext[:, 2:] == ext[:, :-2]], dim=1)
    ext_c = ext.clamp(0, c - 1)
    for t in range(1, t_max):
        a1 = torch.cat([neg_inf.expand(n, 1), alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg_inf.expand(n, 2), alpha[:, :-2]], dim=1)
        a2 = torch.where(same_as_prev2, neg_inf, a2)
        merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
        new = merged + torch.gather(logp[t], 1, ext_c)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    end1 = 2 * lab_len
    end0 = (end1 - 1).clamp_min(0)
    ll = torch.logaddexp(torch.gather(alpha, 1, end1[:, None])[:, 0],
                         torch.gather(alpha, 1, end0[:, None])[:, 0])
    return -ll


class CTCLoss(Loss):
    """Connectionist temporal classification over pred's class axis
    (blank is class 0), in the reference's recursion (`_ctc_nll`), one
    step of a loop over time per frame."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"layout must be NTC or TNC, got {layout!r}")
        if label_layout not in ("NT", "TN"):
            raise ValueError(f"label_layout must be NT or TN, got "
                             f"{label_layout!r}")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"))

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.swapaxes(0, 1)
        if self._label_layout == "TN":
            label = label.swapaxes(0, 1)
        t_max, n = pred.shape[0], pred.shape[1]
        if pred_lengths is None:
            pred_lengths = torch.full((n,), t_max, dtype=torch.int32)
        if label_lengths is None:
            label_lengths = torch.full((n,), label.shape[1],
                                       dtype=torch.int32)
        loss = _ctc_nll(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.abs(label - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.relu(self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(torch.relu(self._margin - pred * label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        if label_format not in ("signed", "binary"):
            raise ValueError(f"bad label_format {label_format}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softplus_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        axes = tuple(range(1, pred.ndim))
        loss = (torch.square(positive - pred) -
                torch.square(negative - pred)).sum(dim=axes)
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood, averaged over every element;
    ``compute_full`` adds Stirling's term where the target exceeds 1."""

    def __init__(self, weight=1.0, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + 1e-12) - target + \
                0.5 * torch.log(2 * math.pi * (target + 1e-12))
            stirling = torch.where(target <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """1 - cos(input1, input2) where the label is 1, else
    relu(cos - margin).  input1 is reshaped like input2, as upstream
    MXNet does; the JAX package's ``_reshape_like(input1, input2)``
    returns input2 itself there, so its loss compares input2 with
    itself (ROADMAP, queue C)."""

    def __init__(self, weight=1.0, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        cos = (input1 * input2).sum(dim=-1) / (
            torch.sqrt(torch.square(input1).sum(dim=-1)) *
            torch.sqrt(torch.square(input2).sum(dim=-1)) + 1e-12)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss: each x1[i] should be nearest
    to x2[i] among the batch, with labels smoothed by
    ``smoothing_parameter``."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    def forward(self, x1, x2):
        batch_size = x1.shape[0]
        gold = torch.eye(batch_size, dtype=x1.dtype, device=x1.device)
        labels = gold * (1 - self.smoothing_parameter) + \
            (1 - gold) * self.smoothing_parameter / (batch_size - 1)
        distances = torch.square(x1[:, None, :] - x2[None, :, :]).sum(dim=2)
        log_probabilities = npx.log_softmax(-distances, axis=1)
        return self.kl_loss(log_probabilities, labels) * batch_size
