"""Autograd user API (counterpart of `mxnet_tpu/autograd.py`).

Gradients are torch's own autograd.  What the reference's module adds on
top lives here as scopes over the thread-local flags in `ops/invoke.py`:
``record()`` (recording and, by default, train mode), ``pause()``,
``train_mode()`` and ``predict_mode()``.  Recording and train mode are
separate flags, as in the reference.  ``record`` also turns torch's
gradient recording on and ``pause`` turns it off; outside either, torch's
own setting holds.

Train-mode randomness (dropout masks, the flash kernels' dropout seed
words) draws from an explicit CPU ``torch.Generator`` passed as
``generator=``: each draw takes a seed from it on the host and makes the
mask on the data's device, so a training step on the card neither syncs
nor copies masks.  A scope without a generator keeps the enclosing one.
"""
from __future__ import annotations

import contextlib

import torch

from .ops.invoke import (is_recording, is_training, set_backward_expected,
                         set_generator, set_recording, set_training)

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward"]


def _check_generator(generator):
    if generator is not None and (
            not isinstance(generator, torch.Generator) or
            generator.device.type != "cpu"):
        raise ValueError("train-mode randomness takes a CPU torch.Generator "
                         f"(its seeds are drawn on the host); got "
                         f"{generator!r}")


@contextlib.contextmanager
def _scope(recording, training, generator, backward, grad_enabled):
    _check_generator(generator)
    prev_rec = set_recording(recording) if recording is not None else None
    prev_train = set_training(training) if training is not None else None
    prev_gen = set_generator(generator) if generator is not None else None
    prev_bwd = set_backward_expected(backward) if backward is not None \
        else None
    try:
        if grad_enabled is None:
            yield
        else:
            with torch.set_grad_enabled(grad_enabled):
                yield
    finally:
        if recording is not None:
            set_recording(prev_rec)
        if training is not None:
            set_training(prev_train)
        if generator is not None:
            set_generator(prev_gen)
        if backward is not None:
            set_backward_expected(prev_bwd)


def record(train_mode=True, generator=None):
    """Scope in which forward passes are recorded for ``backward()``, in
    train mode by default (dropout active, drawing from ``generator``)."""
    return _scope(True, train_mode, generator, None, True)


def pause(train_mode=False):
    """Scope in which nothing is recorded (predict mode by default)."""
    return _scope(False, train_mode, None, None, False)


def train_mode(generator=None):
    """Forward passes inside run in training mode (dropout active),
    drawing from ``generator``; a backward pass is expected."""
    return _scope(None, True, generator, True, None)


def predict_mode():
    """Forward passes inside run in inference mode (dropout off)."""
    return _scope(None, False, None, False, None)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):
    """Backward from ``heads`` (a tensor or a list of them) into the
    gradients of the parameters they depend on.  ``head_grads`` default
    to ones, as in the reference (so a non-scalar head needs none)."""
    heads = [heads] if isinstance(heads, torch.Tensor) else list(heads)
    if head_grads is None:
        head_grads = [torch.ones_like(h) for h in heads]
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    torch.autograd.backward(heads, head_grads, retain_graph=retain_graph,
                            create_graph=create_graph)
