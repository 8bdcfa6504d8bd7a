"""Loss functions (counterpart of the subset of `mxnet_tpu/gluon/loss.py`
that the ResNet path uses): the `Loss` base and
`SoftmaxCrossEntropyLoss`.  As in the reference, ``sample_weight``
multiplies the per-element losses, then ``weight``, and the result is
averaged over every axis but ``batch_axis``."""
from __future__ import annotations

from .. import numpy_extension as npx
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


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


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis


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
