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

``grad`` returns gradients without touching ``.grad``;
``mark_variables`` attaches caller-owned gradient buffers that each
later backward writes or adds into; `Function` is the reference's
custom differentiable function, its forward and backward written over
tensors and run under ``pause()``.
"""
from __future__ import annotations

import contextlib

import torch

from .ops.invoke import (is_recording, is_training, set_backward_expected,
                         set_generator, set_recording, set_training)

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "Function"]


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


def _as_list(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    a list (zeros for a variable the heads do not depend on) and not
    written to ``.grad``.  ``head_grads`` default to ones;
    ``retain_graph`` defaults to ``create_graph``, which records the
    gradients for a further backward (second order)."""
    heads = _as_list(heads)
    variables = _as_list(variables)
    if head_grads is None:
        head_grads = [torch.ones_like(h) for h in heads]
    else:
        head_grads = _as_list(head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    grads = torch.autograd.grad(heads, variables, head_grads,
                                retain_graph=retain_graph,
                                create_graph=create_graph, allow_unused=True)
    return [torch.zeros_like(v) if g is None else g
            for v, g in zip(variables, grads)]


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach the caller's gradient buffers: each later backward that
    reaches ``variables[i]`` (a leaf tensor, made to require grad)
    writes its gradient into ``gradients[i]`` (``'write'``), adds it
    there (``'add'``) or drops it (``'null'``), in place; ``.grad``
    stays empty.  Marking a variable again replaces its buffer."""
    variables = _as_list(variables)
    gradients = _as_list(gradients)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    if not len(variables) == len(gradients) == len(grad_reqs):
        raise ValueError("variables, gradients and grad_reqs differ in "
                         "length")
    for var, buf, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write, add or null; got "
                             f"{req!r}")
        if var.grad_fn is not None:
            raise ValueError("mark_variables takes leaf tensors")
        old = getattr(var, "_mx_grad_hook", None)
        if old is not None:
            old.remove()
        var.requires_grad_(True)
        var._mx_grad_hook = var.register_post_accumulate_grad_hook(
            _buffer_writer(buf, req))


def _buffer_writer(buf, req):
    def hook(var):
        # runs once per backward, after torch summed every path into .grad
        with torch.no_grad():
            if req == "write":
                buf.copy_(var.grad)
            elif req == "add":
                buf.add_(var.grad)
        var.grad = None
    return hook


class _FunctionNode(torch.autograd.Function):
    """The torch node of one `Function` call: ``func`` is the user's
    instance, its saved tensors kept by torch between the passes."""

    @staticmethod
    def forward(ctx, func, *inputs):
        with pause():
            outputs = func.forward(*inputs)
        single = isinstance(outputs, torch.Tensor)
        outs = [outputs] if single else list(outputs)
        # an output that is an input, or a view of one, becomes a copy:
        # torch's node may not hand out its inputs' storage
        storages = {i.untyped_storage().data_ptr() for i in inputs
                    if isinstance(i, torch.Tensor)}
        outs = [o.clone() if o.untyped_storage().data_ptr() in storages
                else o for o in outs]
        saved = func._saved or ()
        func._saved = None
        ctx.func = func
        ctx.save_for_backward(*saved)
        return outs[0] if single else tuple(outs)

    @staticmethod
    def backward(ctx, *output_grads):
        func = ctx.func
        func._saved = ctx.saved_tensors
        with pause():
            in_grads = func.backward(*output_grads)
        in_grads = _as_list(in_grads) if in_grads is not None else []
        needs = ctx.needs_input_grad[1:]
        if len(in_grads) != len(needs):
            raise ValueError(f"{type(func).__name__}.backward returned "
                             f"{len(in_grads)} gradients for {len(needs)} "
                             "inputs")
        return (None,) + tuple(g if need else None
                               for g, need in zip(in_grads, needs))


class Function:
    """A differentiable function written by the user (reference
    `autograd.Function`): subclass, write ``forward`` and ``backward``
    over tensors, and call an instance, ``y = MyFn()(x)``.

    ``forward`` runs under ``pause()`` (nothing recorded, predict mode,
    as in the reference) and may ``save_for_backward`` tensors, which
    ``backward`` reads as ``saved_tensors``.  ``backward`` takes one
    gradient per output and returns one per input; a gradient for an
    input that needs none (an integer label) is dropped.  Saved tensors
    are kept by torch's node for each call, so an instance may be
    called again before the first call's backward."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        return _FunctionNode.apply(self, *inputs)
