"""Gluon Parameter (counterpart of `mxnet_tpu/gluon/parameter.py`).

A parameter holds one ``torch.Tensor`` on one device.  Initial values
are drawn by an `initializer.Initializer` from an explicit
``torch.Generator``.  A parameter created with ``allow_deferred_init``
may leave dimensions unknown (0): `initialize` then only records the
initializer, the device and the generator, and the layer that owns it
sets the shape at its first forward and calls `finish_deferred_init`,
which draws the values then.  Layers run in a fixed order, so two
models initialized from one seed draw identical values.

The tensor is a leaf of torch's autograd that requires grad unless
``grad_req='null'`` (always so for ``differentiable=False``, as the
BatchNorm running statistics are) or its dtype is not floating point;
`set_data` and `cast` keep it a leaf.  ``grad_req='write'`` (the default) makes
each backward replace the stored gradient, as the reference's does:
a hook on the leaf drops the old gradient just before torch would add
the new one into it, so a parameter reached along several paths in one
backward (a tied embedding) still gets their sum.  ``'add'`` keeps
torch's accumulation across backward passes until `zero_grad`.
Optimizers update the tensor in place, outside autograd.

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
import itertools
import threading

import torch

from ..context import resolve_device
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
        self._deferred_init = None   # (init, device, default_init, generator)
        self._grad_req = None
        self._data = None
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
            self._bind(self._data)

    def _bind(self, tensor):
        """Make ``tensor`` (detached, on its final device and dtype) this
        parameter's leaf, requiring grad as ``grad_req`` says."""
        tensor = tensor.detach()
        if self._grad_req != "null" and tensor.is_floating_point():
            tensor.requires_grad_(True)
            tensor.register_hook(self._before_accumulate)
        self._data = tensor
        self.generation = next(_GENERATIONS)

    def _before_accumulate(self, grad):
        # runs once per backward, with the summed gradient of every path
        # into the leaf, just before torch adds it to .grad
        if self._grad_req == "write":
            self._data.grad = None
        return grad

    # -- initialization ---------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Allocate and fill the tensor on ``ctx`` (None = the card),
        drawing from ``generator`` (a CPU ``torch.Generator``); with an
        unknown shape and ``allow_deferred_init``, record all of that for
        `finish_deferred_init`."""
        if self._data is not None and not force_reinit:
            return
        device = resolve_device(ctx)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init, generator)
                return
            raise ValueError(
                f"Cannot initialize Parameter {self.name} because it has "
                f"invalid shape {self._shape}; use allow_deferred_init=True "
                "or specify in_units/in_channels.")
        self._finish_init(init, device, default_init, generator)

    def _finish_init(self, init, device, default_init, generator):
        self._deferred_init = None
        data = torch.empty(self._shape, dtype=self.dtype, device=device)
        fill = init or self.init or default_init or initializer.Uniform()
        fill(initializer.InitDesc(self.name), data, generator)
        self._bind(data)

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

    def data(self):
        self._check_init()
        if getattr(_CONSTANT, "on", False):
            return self._data.detach()
        return self._data

    def list_ctx(self):
        if self._data is None and self._deferred_init is not None:
            return [self._deferred_init[1]]
        return [self.data().device]

    def reset_ctx(self, ctx):
        """Move the parameter (or, while deferred, the device it will be
        allocated on) to ``ctx``."""
        device = resolve_device(ctx)
        if self._data is not None:
            self._bind(self._data.to(device))
        elif self._deferred_init is not None:
            self._deferred_init = (self._deferred_init[0], device,
                                   *self._deferred_init[2:])

    @property
    def device(self):
        return None if self._data is None else self._data.device

    # -- gradients --------------------------------------------------------
    def grad(self):
        """The gradient of the last backward ('write'), or the sum since
        the last `zero_grad` ('add'); zeros before any backward."""
        self._check_init()
        if self._grad_req == "null":
            raise RuntimeError(
                f"Cannot get gradient array for Parameter {self.name} "
                "because grad_req='null'")
        if self._data.grad is None:
            self._data.grad = torch.zeros_like(self._data)
        return self._data.grad

    def list_grad(self):
        return [] if self._grad_req == "null" else [self.grad()]

    def zero_grad(self):
        if self._data is not None and self._data.grad is not None:
            self._data.grad = None

    # -- mutation ---------------------------------------------------------
    def set_data(self, data):
        """Replace the values (any array-like of this parameter's shape),
        keeping its dtype and device.  A deferred parameter takes its
        shape from ``data`` and is allocated on its recorded device,
        without drawing from its generator."""
        src = torch.as_tensor(data)
        if self._data is None and self._deferred_init is not None:
            self.shape = src.shape
            device = self._deferred_init[1]
            self._deferred_init = None
        else:
            device = self.data().device
        if tuple(src.shape) != self._shape:
            raise ValueError(f"Parameter {self.name}: shape "
                             f"{tuple(src.shape)} != {self._shape}")
        self._bind(src.to(device=device, dtype=self.dtype).clone())

    def cast(self, dtype):
        self.dtype = to_torch_dtype(dtype)
        if self._data is not None:
            self._bind(self._data.to(self.dtype))
