"""Gluon Parameter (counterpart of `mxnet_tpu/gluon/parameter.py`).

A parameter holds one ``torch.Tensor`` on each of its contexts: one
copy in the common case, several for data parallelism in one process
(``initialize(ctx=[gpu(0), gpu(1)])``; the reference keeps one copy per
context too).  ``_data`` is the first copy's tensor and the others sit
in ``_copies`` beside it, keyed by context.  `data` and `grad` hand out
the copy of the current context (`context.current_context`, which
``Block.__call__`` sets to its input's), or the only one; `list_data`,
`list_grad` and `list_ctx` list every copy in context order.

Initial values are drawn by an `initializer.Initializer` from an
explicit ``torch.Generator``, once, into the first copy, and copied to
the others, so every copy starts equal.  A parameter created with
``allow_deferred_init`` may leave dimensions unknown (0): `initialize`
then only records the initializer, the contexts and the generator, and
the layer that owns it sets the shape at its first forward and calls
`finish_deferred_init`, which draws the values then.  Layers run in a
fixed order, so two models initialized from one seed draw identical
values.

Each copy is a leaf of torch's autograd that requires grad unless
``grad_req='null'`` (always so for ``differentiable=False``, as the
BatchNorm running statistics are) or its dtype is not floating point;
`set_data` and `cast` keep it a leaf.  ``grad_req='write'`` (the
default) makes each backward replace the stored gradient, as the
reference's does: a hook on each leaf drops that leaf's old gradient
just before torch would add the new one into it, so a parameter reached
along several paths in one backward (a tied embedding) still gets their
sum.  ``'add'`` keeps torch's accumulation across backward passes until
`zero_grad`.  Optimizers update the tensors in place, outside autograd.

Each time a new tensor is bound (`initialize`, `set_data`, `cast`,
`reset_ctx`, a change of ``grad_req``, `load_parameters`) the parameter
takes a new ``generation``: a CUDA graph captured over the old tensor
(`gluon.FusedTrainStep`) sees the change and captures again, where an
in-place copy into the tensor (`Trainer.load_states`, ``data()[...] =``)
keeps the graph valid.

Inside `constant_parameters()`, `Parameter.data` hands out its tensor
detached: the forward inside treats every parameter as a constant, as a
function closed over parameters is treated at an `npx.remat` boundary.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import weakref

import torch

from ..context import (as_context, current_context, mark_context,
                       resolve_contexts)
from .. import initializer

__all__ = ["Parameter", "DeferredInitializationError", "to_torch_dtype",
           "constant_parameters"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64}
_GRAD_REQS = ("write", "add", "null")
_GENERATIONS = itertools.count(1)
_CONSTANT = threading.local()


@contextlib.contextmanager
def constant_parameters():
    """A scope (on this thread) in which `Parameter.data` returns its
    tensor detached, so no gradient reaches a parameter."""
    prev = getattr(_CONSTANT, "on", False)
    _CONSTANT.on = True
    try:
        yield
    finally:
        _CONSTANT.on = prev


def to_torch_dtype(dtype):
    """``torch.dtype`` for a dtype name, numpy dtype or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    if name not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


class DeferredInitializationError(RuntimeError):
    """A parameter's shape is still unknown (reference
    `DeferredInitializationError`)."""




class Parameter:
    def __init__(self, name="weight", grad_req="write", shape=None,
                 dtype="float32", lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self._name = name
        self._shape = (shape,) if isinstance(shape, int) else (
            None if shape is None else tuple(shape))
        self.dtype = to_torch_dtype(dtype)
        self.init = initializer.resolve(init)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._deferred_init = None  # (init, contexts, default_init, generator)
        self._grad_req = None
        self._data = None            # the first copy
        self._ctx_list = None        # the copies' contexts, the first's first
        self._copies = {}            # context -> tensor, for the others
        self.generation = 0
        self.grad_req = grad_req
        self._structure_name = None  # dotted name, set by collect_params

    @property
    def name(self):
        return self._structure_name or self._name

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        old = self._shape
        if old is not None and (
                len(old) != len(new_shape) or
                any(s not in (0, ns) for s, ns in zip(old, new_shape))):
            raise ValueError(f"Expected shape {self._shape} is incompatible "
                             f"with given shape {new_shape} for Parameter "
                             f"{self.name}")
        self._shape = new_shape

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    # -- grad_req ---------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise ValueError(f"grad_req must be one of {_GRAD_REQS}; got "
                             f"{req!r}")
        self._grad_req = req if self._differentiable else "null"
        if self._data is not None:
            self._bind(self.list_data(), self._ctx_list)

    def _bind(self, tensors, ctx_list):
        """Make ``tensors`` (one per context of ``ctx_list``, on its
        final device and dtype) this parameter's copies, each a leaf
        requiring grad as ``grad_req`` says."""
        leaves = [self._leaf(t) for t in tensors]
        self._ctx_list = list(ctx_list)
        self._data = leaves[0]
        self._copies = dict(zip(self._ctx_list[1:], leaves[1:]))
        self.generation = next(_GENERATIONS)

    def _leaf(self, tensor):
        tensor = tensor.detach()
        if self._grad_req != "null" and tensor.is_floating_point():
            tensor.requires_grad_(True)
            tensor.register_hook(functools.partial(
                self._before_accumulate, weakref.ref(tensor)))
        return tensor

    def _before_accumulate(self, leaf, grad):
        # runs once per backward for each copy, with the summed gradient
        # of every path into that leaf, just before torch adds it to the
        # leaf's .grad
        tensor = leaf()
        if self._grad_req == "write" and tensor is not None:
            tensor.grad = None
        return grad

    # -- initialization ---------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Allocate and fill the tensor on ``ctx`` (None = the card; a
        list of contexts keeps one copy on each), drawing from
        ``generator`` (a CPU ``torch.Generator``); with an unknown shape
        and ``allow_deferred_init``, record all of that for
        `finish_deferred_init`."""
        if self._data is not None and not force_reinit:
            return
        ctx_list = resolve_contexts(ctx)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx_list, default_init,
                                       generator)
                return
            raise ValueError(
                f"Cannot initialize Parameter {self.name} because it has "
                f"invalid shape {self._shape}; use allow_deferred_init=True "
                "or specify in_units/in_channels.")
        self._finish_init(init, ctx_list, default_init, generator)

    def _finish_init(self, init, ctx_list, default_init, generator):
        # drawn once and copied, so every copy starts equal
        self._deferred_init = None
        data = torch.empty(self._shape, dtype=self.dtype, device=ctx_list[0])
        fill = init or self.init or default_init or initializer.Uniform()
        fill(initializer.InitDesc(self.name), data, generator)
        self._bind([data] + [data.to(c, copy=True) for c in ctx_list[1:]],
                   ctx_list)

    def finish_deferred_init(self):
        """Draw the values of a deferred parameter, now that its layer
        has set the shape."""
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape {self._shape}")
        self._finish_init(*self._deferred_init)

    def _check_init(self):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has not been initialized yet "
                    "because initialization was deferred. Actual "
                    "initialization happens during the first forward pass.")
            raise RuntimeError(
                f"Parameter {self.name} has not been initialized. You "
                "should initialize parameters with Block.initialize().")

    def _copy_of(self, ctx):
        """The copy on ``ctx`` (None: the only copy, else the current
        context's), or None where the parameter has no copy there."""
        if ctx is None:
            if not self._copies:
                return self._data
            ctx = current_context()
        ctx = as_context(ctx)
        if ctx == self._ctx_list[0]:
            return self._data
        return self._copies.get(ctx)

    def data(self, ctx=None):
        """The copy on ``ctx``; None: the only copy, or with several the
        current context's."""
        self._check_init()
        tensor = self._copy_of(ctx)
        if tensor is None:
            raise RuntimeError(
                f"Parameter {self.name} was not initialized on context "
                f"{ctx if ctx is not None else current_context()}; it "
                f"lives on {self._ctx_list}.")
        if getattr(_CONSTANT, "on", False):
            return tensor.detach()
        return tensor

    def list_data(self):
        """Every copy, in context order."""
        self._check_init()
        return [self._data] + list(self._copies.values())

    def list_ctx(self):
        if self._data is None and self._deferred_init is not None:
            return list(self._deferred_init[1])
        self._check_init()
        return list(self._ctx_list)

    def reset_ctx(self, ctx):
        """Keep the parameter's copies on ``ctx`` (a context or a list),
        or, while deferred, allocate them there later: a context the
        parameter already lives on keeps its copy's values, a new one
        takes the first copy's."""
        ctx_list = resolve_contexts(ctx)
        if self._data is not None:
            if len(ctx_list) == 1 and not self._copies:
                tensors = [self._data.to(ctx_list[0])]
            else:
                tensors = [self._copy_of(c) for c in ctx_list]
                tensors = [self._data.to(c, copy=True) if t is None else t
                           for c, t in zip(ctx_list, tensors)]
            self._bind(tensors, ctx_list)
        elif self._deferred_init is not None:
            self._deferred_init = (self._deferred_init[0], ctx_list,
                                   *self._deferred_init[2:])

    @property
    def device(self):
        return None if self._data is None else self._data.device

    # -- gradients --------------------------------------------------------
    def grad(self, ctx=None):
        """The gradient of the copy on ``ctx`` (as `data` picks it) from
        the last backward ('write'), or the sum since the last
        `zero_grad` ('add'); zeros before any backward.  A context the
        parameter does not live on raises ``KeyError``, as the
        reference's lookup does."""
        self._check_init()
        if self._grad_req == "null":
            raise RuntimeError(
                f"Cannot get gradient array for Parameter {self.name} "
                "because grad_req='null'")
        tensor = self._copy_of(ctx)
        if tensor is None:
            raise KeyError(ctx if ctx is not None else current_context())
        if tensor.grad is None:
            tensor.grad = torch.zeros_like(tensor)
        # a host copy's gradient carries its context, as the kvstore
        # decides by contexts whether copies ride a ring
        return mark_context(tensor.grad, self._context_of(tensor))

    def _context_of(self, tensor):
        if tensor is self._data:
            return self._ctx_list[0]
        return next(c for c, t in self._copies.items() if t is tensor)

    def list_grad(self):
        """Every copy's gradient, in context order ([] for
        ``grad_req='null'``)."""
        if self._grad_req == "null":
            return []
        return [self.grad(c) for c in self.list_ctx()]

    def zero_grad(self):
        if self._data is not None:
            for tensor in self.list_data():
                tensor.grad = None

    # -- mutation ---------------------------------------------------------
    def set_data(self, data):
        """Replace the values of every copy (any array-like of this
        parameter's shape), keeping its dtype and contexts.  A deferred
        parameter takes its shape from ``data`` and is allocated on its
        recorded contexts, without drawing from its generator."""
        src = torch.as_tensor(data)
        if self._data is None and self._deferred_init is not None:
            self.shape = src.shape
            ctx_list = self._deferred_init[1]
            self._deferred_init = None
        else:
            self._check_init()
            ctx_list = self._ctx_list
        if tuple(src.shape) != self._shape:
            raise ValueError(f"Parameter {self.name}: shape "
                             f"{tuple(src.shape)} != {self._shape}")
        self._bind([src.to(device=c, dtype=self.dtype).clone()
                    for c in ctx_list], ctx_list)

    def cast(self, dtype):
        self.dtype = to_torch_dtype(dtype)
        if self._data is not None:
            self._bind([t.to(self.dtype) for t in self.list_data()],
                       self._ctx_list)
