"""Device contexts (counterpart of `mxnet_tpu/context.py`).

A context is a plain ``torch.device``, so every caller that places
tensors on one context gets the device it passes to torch.  ``gpu()``
is the default: an entry point that is given no device runs on the
card, and raises when there is none.  Nothing falls back to the CPU on
its own — a caller that wants the CPU passes ``cpu()`` (or ``"cpu"``)
explicitly, as the CPU tests do.

Contexts are also the keys of a parameter's copies (data parallelism
over a list of contexts, `gluon.Parameter`), so they stay distinct:

- ``cpu(0)`` is ``torch.device("cpu")``; ``cpu(i)`` for ``i > 0`` is
  ``torch.device("cpu", i)``.  Torch allocates a plain CPU tensor on
  any of them, so ``cpu(0)`` ... ``cpu(3)`` are four host copies whose
  tensors all say ``device == cpu``, as the reference's tests use four
  host devices;
- ``gpu(i)`` is ``torch.device("cuda", i)``, never equal to a CPU one.

`as_context` puts any spelling (``"cpu:0"``, ``torch.device("cuda")``)
into that one form.

The current context is a per-thread stack: `context_scope(ctx)` pushes
``ctx`` for the length of a ``with`` block and `current_context()`
reads its top, else ``gpu(0)``.  ``Block.__call__`` enters its input's
context (`tensor_context`), so a parameter with several copies hands
out the copy of the context its input belongs to.  A CUDA tensor's
context is its device.  A CPU tensor cannot say which host copy it
belongs to, so `split_and_load` marks each slice with its context
(`mark_context`) and a block's outputs carry the mark on; an unmarked
CPU tensor keeps the current CPU context, or is ``cpu(0)``.  (``with
ctx:`` on a ``torch.device`` is torch's own default-device mode, not
this scope.)
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "num_gpus", "current_context", "resolve_device",
           "resolve_contexts", "as_context", "context_scope",
           "tensor_context", "mark_context"]

_CPU = torch.device("cpu")
_MARK = "_mx_context"


class _Stack(threading.local):
    def __init__(self):
        self.items = []


_stack = _Stack()


def cpu(device_id=0):
    """The host CPU; ``cpu(i)`` for ``i > 0`` is a distinct context over
    the same memory (a copy of its own)."""
    return _CPU if int(device_id) == 0 else torch.device("cpu",
                                                         int(device_id))


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def num_gpus():
    return torch.cuda.device_count()


def as_context(ctx):
    """``ctx`` (a ``torch.device`` or its string) as the context key:
    ``cpu:0`` is ``cpu``, ``cuda`` is the current card."""
    dev = torch.device(ctx)
    if dev.type == "cpu":
        return cpu(dev.index or 0)
    if dev.type == "cuda" and dev.index is None:
        return gpu(torch.cuda.current_device()
                   if torch.cuda.is_available() else 0)
    return dev


def current_context():
    """The innermost `context_scope` on this thread, else the first
    card."""
    items = _stack.items
    return items[-1] if items else gpu(0)


@contextlib.contextmanager
def context_scope(ctx):
    """Make ``ctx`` the current context inside the ``with`` block (the
    reference's ``with ctx:``)."""
    _stack.items.append(as_context(ctx))
    try:
        yield
    finally:
        _stack.items.pop()


def mark_context(tensor, ctx):
    """Record on a CPU tensor the host copy it belongs to (CUDA tensors
    carry their context as their device); returns the tensor."""
    if tensor.device.type == "cpu":
        setattr(tensor, _MARK, as_context(ctx))
    return tensor


def tensor_context(tensor):
    """The context ``tensor`` belongs to: its device on a card, else its
    mark, else None (an unmarked CPU tensor)."""
    if tensor.device.type == "cuda":
        return tensor.device
    return getattr(tensor, _MARK, None)


def resolve_device(ctx=None):
    """``torch.device`` for one context ``ctx`` (None ->
    ``current_context()``).  A list or tuple of one context, as
    ``initialize(ctx=[gpu(0)])`` passes it, is that context; several
    raise here, where one device is meant (copies over several contexts
    are taken by `resolve_contexts`).  Raises :class:`MXNetError` for a
    CUDA device when no card is visible, naming the explicit CPU
    opt-in."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(
                f"{len(ctx)} contexts {list(ctx)} where one device is "
                "meant; this call runs on one device (a step over copies "
                "in one process is ROADMAP queue A item A7b-rest; ranks, "
                "one device each, start with tools/launch.py); pass one")
        ctx = ctx[0]
    dev = current_context() if ctx is None else torch.device(ctx)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{dev} requested but CUDA is not available; pass "
                "ctx=mx.cpu() (or device='cpu') to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise MXNetError(f"{dev} out of range: only "
                             f"{torch.cuda.device_count()} card(s)")
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return as_context(dev)


def resolve_contexts(ctx=None):
    """The list of contexts a parameter keeps copies on: ``ctx`` a
    context or a non-empty list of distinct ones (None -> the current
    one), each checked as `resolve_device` checks it."""
    ctxs = list(ctx) if isinstance(ctx, (list, tuple)) else [ctx]
    if not ctxs:
        raise MXNetError("an empty list of contexts: pass at least one")
    out = [resolve_device(c) for c in ctxs]
    if len(set(out)) != len(out):
        raise MXNetError(f"contexts {out} name one context twice")
    return out
