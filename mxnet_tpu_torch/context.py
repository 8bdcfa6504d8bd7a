"""Device contexts (counterpart of `mxnet_tpu/context.py`).

A context is a plain ``torch.device``.  ``gpu()`` is the default: an
entry point that is given no device runs on the card, and raises when
there is none.  Nothing falls back to the CPU on its own — a caller that
wants the CPU passes ``cpu()`` (or ``"cpu"``) explicitly, as the CPU
tests do.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "num_gpus", "current_context", "resolve_device"]


def cpu(device_id=0):
    """The host CPU (``device_id`` is accepted for the reference's
    signature; torch has one CPU device)."""
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def num_gpus():
    return torch.cuda.device_count()


def current_context():
    """The default context: the first card."""
    return gpu(0)


def resolve_device(ctx=None):
    """``torch.device`` for ``ctx`` (None -> ``current_context()``).  A
    list or tuple of one context, as ``initialize(ctx=[gpu(0)])`` passes
    it, is that context; several raise, since the port places every
    parameter on one device.  Raises :class:`MXNetError` for a CUDA
    device when no card is visible, naming the explicit CPU opt-in."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(
                f"{len(ctx)} contexts {list(ctx)}: the port places each "
                "parameter on one device (data parallelism over several "
                "is ROADMAP queue A item A7, distribution); pass one")
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
    return dev
