"""Mode flags (counterpart of the flag half of `mxnet_tpu/ops/invoke.py`).

The reference's invoke module also owns the imperative tape; in the port
autograd is torch's own, so only the thread-local mode flags remain:
``is_recording`` (inside ``autograd.record()``), ``is_training``
(dropout active) and ``is_backward_expected`` (a backward pass will run
through this forward — what the flash auto policy's training crossover
reads).  ``generator`` is the explicit CPU ``torch.Generator`` that
train-mode randomness draws its seeds from, and ``seed_table`` the
`ops.seeds.SeedTable` that hands the draws their device slots while a
step is captured (None otherwise).
"""
from __future__ import annotations

import threading

__all__ = ["is_recording", "set_recording", "is_training", "set_training",
           "is_backward_expected", "set_backward_expected",
           "current_generator", "set_generator", "current_seed_table",
           "set_seed_table"]

_state = threading.local()


def is_recording():
    return getattr(_state, "recording", False)


def set_recording(flag):
    prev = is_recording()
    _state.recording = bool(flag)
    return prev


def is_training():
    return getattr(_state, "training", False)


def set_training(flag):
    prev = is_training()
    _state.training = bool(flag)
    return prev


def is_backward_expected():
    """True when a backward pass will follow: explicitly flagged, or the
    forward is recorded or runs in train mode."""
    return (getattr(_state, "backward", False) or is_recording() or
            is_training())


def set_backward_expected(flag):
    prev = getattr(_state, "backward", False)
    _state.backward = bool(flag)
    return prev


def current_generator():
    """The CPU ``torch.Generator`` train-mode randomness draws its seeds
    from (None outside ``autograd.record`` / ``autograd.train_mode`` with
    a ``generator``)."""
    return getattr(_state, "generator", None)


def set_generator(gen):
    prev = current_generator()
    _state.generator = gen
    return prev


def current_seed_table():
    """The `ops.seeds.SeedTable` installed on this thread, or None."""
    return getattr(_state, "seed_table", None)


def set_seed_table(table):
    prev = current_seed_table()
    _state.seed_table = table
    return prev
