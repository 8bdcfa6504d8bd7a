"""Gluon Parameter (counterpart of `mxnet_tpu/gluon/parameter.py`).

A parameter holds one ``torch.Tensor`` on one device.  Its shape is
known when it is created (the reference's deferred shape inference is
not ported: layers take their input widths).  Initial values are drawn
by an `initializer.Initializer` from an explicit ``torch.Generator``.
The tensor does not require grad: the port serves only, and training
(with its own gradient plumbing) comes later.
"""
from __future__ import annotations

import torch

from ..context import resolve_device
from .. import initializer

__all__ = ["Parameter", "to_torch_dtype"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64}


def to_torch_dtype(dtype):
    """``torch.dtype`` for a dtype name, numpy dtype or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    if name not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


class Parameter:
    def __init__(self, name="weight", shape=None, dtype="float32", init=None):
        self._name = name
        self._shape = (shape,) if isinstance(shape, int) else (
            None if shape is None else tuple(shape))
        self.dtype = to_torch_dtype(dtype)
        self.init = initializer.resolve(init)
        self._data = None
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

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Allocate and fill the tensor on ``ctx`` (None = the card),
        drawing from ``generator`` (a CPU ``torch.Generator``)."""
        if self._data is not None and not force_reinit:
            return
        device = resolve_device(ctx)
        if not self._shape_known():
            raise ValueError(
                f"Cannot initialize Parameter {self.name} because it has "
                f"invalid shape {self._shape}; specify in_units/in_channels.")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        data = torch.empty(self._shape, dtype=self.dtype, device=device)
        fill = init or self.init or default_init or initializer.Uniform()
        fill(initializer.InitDesc(self.name), data, generator)
        self._data = data

    def data(self):
        if self._data is None:
            raise RuntimeError(
                f"Parameter {self.name} has not been initialized. You "
                "should initialize parameters with Block.initialize().")
        return self._data

    @property
    def device(self):
        return None if self._data is None else self._data.device

    def set_data(self, data):
        """Replace the values (any array-like of this parameter's shape),
        keeping its dtype and device."""
        src = torch.as_tensor(data)
        if tuple(src.shape) != self._shape:
            raise ValueError(f"Parameter {self.name}: shape "
                             f"{tuple(src.shape)} != {self._shape}")
        self._data = src.to(device=self.data().device,
                            dtype=self.dtype).clone()

    def cast(self, dtype):
        self.dtype = to_torch_dtype(dtype)
        if self._data is not None:
            self._data = self._data.to(self.dtype)
