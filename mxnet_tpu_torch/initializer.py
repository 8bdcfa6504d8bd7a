"""Weight initializers (counterpart of `mxnet_tpu/initializer.py`).

Each initializer fills a tensor in place, drawing from an explicit
``torch.Generator``.  Draws run on the CPU in float32 and are then cast
and copied to the parameter's device, so the same generator seed gives
the same weights on every device.  The values are not the JAX package's
(threefry keys and torch's generator differ); the tests carry weights
across with `utils.convert.load_reference_params` instead.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .base import registry

__all__ = ["Initializer", "register", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "InitDesc", "resolve"]


class InitDesc(str):
    """Name of what is being initialized (reference InitDesc)."""


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr, generator):
        """Fill ``arr`` in place; ``generator`` is a CPU
        ``torch.Generator``."""
        name = str(desc).lower()
        if name.endswith(("bias", "beta", "running_mean", "moving_mean")):
            arr.zero_()
        elif name.endswith(("gamma", "running_var", "moving_var")):
            arr.fill_(1.0)
        else:
            self._init_weight(desc, arr, generator)

    def _init_weight(self, desc, arr, generator):  # pragma: no cover
        raise NotImplementedError

    @staticmethod
    def _copy_in(arr, values):
        arr.copy_(values.to(dtype=arr.dtype, device=arr.device))

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


register = registry.get_register_func(Initializer, "initializer")


@register
class Zero(Initializer):
    def _init_weight(self, desc, arr, generator):
        arr.zero_()


registry.get_registry("initializer").register(Zero, "zeros")


@register
class One(Initializer):
    def _init_weight(self, desc, arr, generator):
        arr.fill_(1.0)


registry.get_registry("initializer").register(One, "ones")


@register
class Constant(Initializer):
    """Every element ``value`` (a number, or a tensor broadcast to the
    parameter's shape)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr, generator):
        if isinstance(self.value, torch.Tensor):
            self._copy_in(arr, self.value.broadcast_to(arr.shape))
        else:
            arr.fill_(self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr, generator):
        u = torch.rand(arr.shape, generator=generator, dtype=torch.float32)
        self._copy_in(arr, (u * 2.0 - 1.0) * self.scale)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr, generator):
        n = torch.randn(arr.shape, generator=generator, dtype=torch.float32)
        self._copy_in(arr, n * self.sigma)


@register
class Xavier(Initializer):
    """Xavier / Glorot (reference `initializer.py` Xavier): uniform in
    [-s, s] or gaussian with deviation s, s = sqrt(magnitude / fan), the
    fan averaged over in and out, or either alone; the kernel's spatial
    size multiplies both fans."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr, generator):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise ValueError(f"Xavier initializer needs >= 2D shape, got "
                             f"{shape} for {desc}")
        hw_scale = float(onp.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            u = torch.rand(shape, generator=generator, dtype=torch.float32)
            self._copy_in(arr, (u * 2.0 - 1.0) * scale)
        elif self.rnd_type == "gaussian":
            n = torch.randn(shape, generator=generator, dtype=torch.float32)
            self._copy_in(arr, n * scale)
        else:
            raise ValueError(f"unknown rnd_type {self.rnd_type!r}")


def resolve(init):
    """An Initializer from None, an instance, or a registered name."""
    if init is None or isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        return registry.get_registry("initializer").get(init)()
    raise TypeError(f"cannot interpret {init!r} as an initializer")
