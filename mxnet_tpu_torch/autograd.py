"""Train/predict mode scopes (counterpart of `mxnet_tpu/autograd.py`).

Gradients are torch's own autograd; what the reference's module adds on
top — the train/predict mode that switches dropout on and off — lives
here as context managers over the thread-local flags in `ops/invoke.py`.
"""
from __future__ import annotations

import contextlib

from .ops.invoke import (is_training, set_training, set_generator,
                         set_backward_expected)

__all__ = ["train_mode", "predict_mode", "is_training", "set_training"]


@contextlib.contextmanager
def train_mode(generator=None):
    """Forward passes inside run in training mode (dropout active).
    ``generator`` is the ``torch.Generator`` that dropout masks and the
    flash kernel's dropout seed words are drawn from."""
    prev = set_training(True)
    prev_gen = set_generator(generator)
    prev_bwd = set_backward_expected(True)
    try:
        yield
    finally:
        set_training(prev)
        set_generator(prev_gen)
        set_backward_expected(prev_bwd)


@contextlib.contextmanager
def predict_mode():
    """Forward passes inside run in inference mode (dropout off)."""
    prev = set_training(False)
    prev_bwd = set_backward_expected(False)
    try:
        yield
    finally:
        set_training(prev)
        set_backward_expected(prev_bwd)
