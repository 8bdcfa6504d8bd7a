"""Legacy Python custom operators (counterpart of
`mxnet_tpu/operator.py`; upstream `python/mxnet/operator.py`).

A `CustomOpProp` registered under an ``op_type`` describes the operator
(arguments, outputs, shape and type inference) and creates its
`CustomOp`, whose ``forward`` and ``backward`` write into tensors they
are handed; ``mx.nd.Custom(*data, op_type=...)`` runs it.  As in the
JAX package there is no worker-thread bridge: the op runs eagerly, and
its backward is one node of torch's autograd through
`autograd.Function`.  Outputs and input gradients are allocated as
zeros on the inputs' device, from ``infer_shape`` and ``infer_type``
(numpy or torch dtypes); ``forward`` and ``backward`` see torch dtypes.
A ``CustomOp`` may launch user kernels (`rtc.CudaKernel`) on them.
"""
from __future__ import annotations

import torch

from . import autograd
from .gluon.parameter import to_torch_dtype
from .ops.invoke import is_training

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "invoke_custom"]

_REGISTRY = {}


class CustomOp:
    """Base class of a custom operator's computation (upstream
    `operator.py:434`)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    @staticmethod
    def assign(dst, req, src):
        """Write ``src`` into ``dst`` in place as ``req`` says:
        ``'write'`` copies, ``'add'`` adds, ``'null'`` does nothing."""
        with torch.no_grad():
            if req == "write":
                dst.copy_(src)
            elif req == "add":
                dst.add_(src)
            elif req != "null":
                raise ValueError(f"req must be write, add or null; got "
                                 f"{req!r}")


class CustomOpProp:
    """A custom operator's description (upstream `operator.py:487`).
    ``need_top_grad`` says whether ``backward`` reads the output
    gradients (a loss head's does not); it is kept for the reference's
    API, and the output gradients are passed either way."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Class decorator registering a `CustomOpProp` under ``reg_name``,
    the ``op_type`` that ``mx.nd.Custom`` takes."""
    def wrapper(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return wrapper


def get_all_registered():
    return dict(_REGISTRY)


class _CustomFunction(autograd.Function):
    def __init__(self, op, prop, is_train):
        super().__init__()
        self._op = op
        self._prop = prop
        # read before Function's call pauses, which leaves train mode
        self._is_train = is_train

    def forward(self, *inputs):
        _, out_shapes, _ = self._prop.infer_shape(
            [list(i.shape) for i in inputs])
        _, out_types, _ = self._prop.infer_type([i.dtype for i in inputs])
        device = inputs[0].device
        outs = [torch.zeros(tuple(s), dtype=to_torch_dtype(t), device=device)
                for s, t in zip(out_shapes, out_types)]
        self._op.forward(self._is_train, ["write"] * len(outs),
                         list(inputs), outs, [])
        self.save_for_backward(*inputs, *outs)
        self._n_in = len(inputs)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def backward(self, *output_grads):
        inputs = self.saved_tensors[:self._n_in]
        outs = self.saved_tensors[self._n_in:]
        in_grads = [torch.zeros_like(i) for i in inputs]
        self._op.backward(["write"] * len(in_grads), list(output_grads),
                          list(inputs), list(outs), in_grads, [])
        return in_grads


def invoke_custom(*data, op_type, **kwargs):
    """``mx.nd.Custom``: run the operator registered as ``op_type`` on
    the tensors ``data``; keyword arguments go to its prop's constructor
    as strings, as upstream passes them."""
    prop_cls = _REGISTRY.get(op_type)
    if prop_cls is None:
        raise ValueError(f"custom op {op_type!r} is not registered "
                         f"(known: {sorted(_REGISTRY)})")
    str_kwargs = {k: str(v) for k, v in kwargs.items()}
    prop = prop_cls(**str_kwargs)
    op = prop.create_operator(data[0].device, [list(d.shape) for d in data],
                              [d.dtype for d in data])
    return _CustomFunction(op, prop, is_training())(*data)
