"""Convolution and pooling layers (counterpart of the subset of
`mxnet_tpu/gluon/nn/conv_layers.py` that ResNet uses): Conv2D, the max,
average and global average 2-d pools, and the space-to-depth ResNet
stem.  Channels-first layout (NCHW); ``in_channels=0`` defers the
weight's input width to the first forward."""
from __future__ import annotations

from ... import numpy_extension as npx
from ...initializer import resolve as _resolve_init
from ..block import HybridBlock
from ..parameter import Parameter
from .basic_layers import Activation

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D",
           "SpaceToDepthStem"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32"):
        super().__init__()
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _pair(kernel_size)
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = groups
        self._layout = layout
        wshape = (channels, in_channels // groups if in_channels else 0) + \
            self._kernel
        self.weight = Parameter("weight", shape=wshape, dtype=dtype,
                                init=_resolve_init(weight_initializer),
                                allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(channels,), dtype=dtype,
                              init=_resolve_init(bias_initializer),
                              allow_deferred_init=True) if use_bias else None
        self.act = Activation(activation) if activation else None

    def forward(self, x):
        if self.weight.shape[1] == 0:
            in_c = x.shape[self._layout.index("C")]
            self.weight.shape = (self._channels, in_c // self._groups) + \
                self._kernel
        if self.weight._data is None:
            self.weight.finish_deferred_init()
        if self.bias is not None and self.bias._data is None:
            self.bias.finish_deferred_init()
        out = npx.convolution(
            x, self.weight.data(),
            None if self.bias is None else self.bias.data(),
            kernel=self._kernel, stride=self._strides, dilate=self._dilation,
            pad=self._padding, num_filter=self._channels,
            num_group=self._groups, layout=self._layout)
        return out if self.act is None else self.act(out)

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}")


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype)


class SpaceToDepthStem(HybridBlock):
    """The 7x7/stride-2 ResNet stem in space-to-depth form.

    Takes the packed input, ``space_to_depth(x, 2)`` applied once in the
    input pipeline, and runs the equivalent 4x4/stride-1 conv with the
    7x7 kernel folded (`ops/stem.py`): on the card through the B2
    kernel.  Bias-free: the stem feeds a BatchNorm.  The weight keeps the
    ``(channels, in_channels, 7, 7)`` layout, so it exchanges 1:1 with a
    ``Conv2D(channels, 7, strides=2, padding=3)`` stem and gradients flow
    through the fold."""

    def __init__(self, channels, in_channels=3, weight_initializer=None,
                 dtype="float32"):
        super().__init__()
        self._channels = channels
        self._in_channels = in_channels
        self.weight = Parameter("weight", shape=(channels, in_channels, 7, 7),
                                dtype=dtype,
                                init=_resolve_init(weight_initializer),
                                allow_deferred_init=True)

    def forward(self, x):
        if x.shape[1] != 4 * self._in_channels:
            raise ValueError(
                f"SpaceToDepthStem wants the packed (B, "
                f"{4 * self._in_channels}, H/2, W/2) input (space_to_depth "
                f"block 2 of {self._in_channels} channels), got "
                f"{tuple(x.shape)}: apply space_to_depth(x, 2) in the input "
                "pipeline")
        if self.weight._data is None:
            self.weight.finish_deferred_init()
        return npx.stem_conv(x, self.weight.data())

    def extra_repr(self):
        return f"{self._channels}, in_channels={self._in_channels}"


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, count_include_pad=True, ceil_mode=False):
        super().__init__()
        self._kernel = _pair(pool_size)
        self._strides = _pair(strides if strides is not None else pool_size)
        self._padding = _pair(padding)
        self._global = global_pool
        self._pool_type = pool_type
        self._layout = layout
        self._count_include_pad = count_include_pad
        self._ceil_mode = ceil_mode

    def forward(self, x):
        return npx.pooling(
            x, kernel=self._kernel, pool_type=self._pool_type,
            stride=self._strides, pad=self._padding,
            global_pool=self._global,
            count_include_pad=self._count_include_pad, layout=self._layout,
            pooling_convention="full" if self._ceil_mode else "valid")

    def extra_repr(self):
        return (f"size={self._kernel}, stride={self._strides}, "
                f"padding={self._padding}")


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", count_include_pad=True, ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ceil_mode=ceil_mode)


class GlobalAvgPool2D(_Pool):
    def __init__(self, layout="NCHW"):
        super().__init__(1, None, 0, True, "avg", layout)
