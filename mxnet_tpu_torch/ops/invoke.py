"""Mode flags (counterpart of the flag half of `mxnet_tpu/ops/invoke.py`).

The reference's invoke module also owns the imperative tape; in the port
autograd is torch's own, so only the thread-local mode flags remain:
``is_recording`` (inside ``autograd.record()``), ``is_training``
(dropout active) and ``is_backward_expected`` (a backward pass will run
through this forward — what the flash auto policy's training crossover
reads).  ``generator`` is the explicit CPU ``torch.Generator`` that
train-mode randomness draws its seeds from, and ``seed_table`` the
`ops.seeds.SeedTable` that hands the draws their device slots while a
step is captured (None otherwise).  ``draw_tapes`` is the stack of
`ops.seeds.DrawTape`s of the `npx.remat` boundaries the forward is in.
`modes` / `set_modes` save and restore the three mode flags at once, for
a boundary whose recompute runs on another thread (autograd's).
``is_tracing`` is True inside `tracing()`: the body of a
`gluon.FusedTrainStep` (every call, its eager first one too), the
forward of a hybridized block and a serving cache's function, the
counterparts of the reference's traced programs.  There a remat
boundary differentiates the parameters a function closes over, and
`ops.control_flow` takes the traced contract (``while_loop`` runs
``max_iterations`` masked steps, ``cond`` selects on the device), as
the reference's traces do.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["is_recording", "set_recording", "is_training", "set_training",
           "is_backward_expected", "set_backward_expected",
           "current_generator", "set_generator", "current_seed_table",
           "set_seed_table", "draw_tapes", "modes", "set_modes",
           "is_tracing", "set_tracing", "tracing"]

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


def draw_tapes():
    """This thread's stack of `ops.seeds.DrawTape`s, innermost last."""
    tapes = getattr(_state, "draw_tapes", None)
    if tapes is None:
        tapes = _state.draw_tapes = []
    return tapes


def modes():
    """The recording, training and backward-expected flags, as set."""
    return (is_recording(), is_training(), getattr(_state, "backward", False))


def set_modes(flags):
    """Set the three flags of `modes`; returns the previous ones."""
    prev = modes()
    _state.recording, _state.training, _state.backward = \
        (bool(f) for f in flags)
    return prev


def is_tracing():
    return getattr(_state, "tracing", False)


def set_tracing(flag):
    prev = is_tracing()
    _state.tracing = bool(flag)
    return prev


@contextlib.contextmanager
def tracing():
    """Scope (on this thread) in which `is_tracing` is True."""
    prev = set_tracing(True)
    try:
        yield
    finally:
        set_tracing(prev)
