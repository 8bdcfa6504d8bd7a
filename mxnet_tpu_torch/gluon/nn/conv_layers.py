"""Convolution and pooling layers (counterpart of
`mxnet_tpu/gluon/nn/conv_layers.py`): the 1-3 d convolutions and
transposed convolutions, the max, average and global pools, reflection
padding, pixel shuffles, deformable convolution and the space-to-depth
ResNet stem.  Every layout the reference takes (NCW/NWC, NCHW/NHWC,
NCDHW/NDHWC); weights are (out, in / groups, *kernel) in all of them,
(in, out / groups, *kernel) for the transposed ones, so they come
across from the reference as they are.  ``in_channels=0`` defers the
input width to the first forward."""
from __future__ import annotations

import torch

from ... import numpy as mxnp
from ... import numpy_extension as npx
from ...initializer import resolve as _resolve_init
from ..block import HybridBlock
from ..parameter import Parameter
from .basic_layers import Activation

__all__ = [
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
    "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
    "GlobalMaxPool3D", "GlobalAvgPool1D", "GlobalAvgPool2D",
    "GlobalAvgPool3D", "ReflectionPad2D", "PixelShuffle1D", "PixelShuffle2D",
    "PixelShuffle3D", "DeformableConvolution", "SpaceToDepthStem",
]


def _pair(v, n=2):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32", ndim=2,
                 transpose=False, output_padding=0):
        super().__init__()
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _pair(kernel_size, ndim)
        self._strides = _pair(strides, ndim)
        self._padding = _pair(padding, ndim)
        self._dilation = _pair(dilation, ndim)
        self._groups = groups
        self._layout = layout
        self._transpose = transpose
        self._output_padding = _pair(output_padding, ndim)
        if transpose:
            wshape = (in_channels, channels // groups) + self._kernel
        else:
            wshape = (channels, in_channels // groups if in_channels else 0) \
                + self._kernel
        self.weight = Parameter("weight", shape=wshape, dtype=dtype,
                                init=_resolve_init(weight_initializer),
                                allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(channels,), dtype=dtype,
                              init=_resolve_init(bias_initializer),
                              allow_deferred_init=True) if use_bias else None
        self.act = Activation(activation) if activation else None

    def forward(self, x):
        in_c = x.shape[self._layout.index("C")]
        if self._transpose:
            if self.weight.shape[0] == 0:
                self.weight.shape = (in_c, self._channels // self._groups) \
                    + self._kernel
        elif self.weight.shape[1] == 0:
            self.weight.shape = (self._channels, in_c // self._groups) + \
                self._kernel
        if self.weight._data is None:
            self.weight.finish_deferred_init()
        if self.bias is not None and self.bias._data is None:
            self.bias.finish_deferred_init()
        bias = None if self.bias is None else self.bias.data()
        if self._transpose:
            out = npx.deconvolution(
                x, self.weight.data(), bias, kernel=self._kernel,
                stride=self._strides, dilate=self._dilation,
                pad=self._padding, adj=self._output_padding,
                num_filter=self._channels, num_group=self._groups,
                layout=self._layout)
        else:
            out = npx.convolution(
                x, self.weight.data(), bias, kernel=self._kernel,
                stride=self._strides, dilate=self._dilation,
                pad=self._padding, num_filter=self._channels,
                num_group=self._groups, layout=self._layout)
        return out if self.act is None else self.act(out)

    def extra_repr(self):
        return (f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._strides}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=1)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=2)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=3)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=1,
                         transpose=True, output_padding=output_padding)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=2,
                         transpose=True, output_padding=output_padding)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=3,
                         transpose=True, output_padding=output_padding)


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
                 layout, count_include_pad=True, ndim=2, ceil_mode=False):
        super().__init__()
        self._kernel = _pair(pool_size, ndim)
        self._strides = _pair(strides if strides is not None else pool_size,
                              ndim)
        self._padding = _pair(padding, ndim)
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


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ndim=1, ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ndim=2, ceil_mode=ceil_mode)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         ndim=3, ceil_mode=ceil_mode)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 count_include_pad=True, ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ndim=1, ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", count_include_pad=True, ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ndim=2, ceil_mode=ceil_mode)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", count_include_pad=True, ceil_mode=False):
        super().__init__(pool_size, strides, padding, False, "avg", layout,
                         count_include_pad, ndim=3, ceil_mode=ceil_mode)


class GlobalMaxPool1D(_Pool):
    def __init__(self, layout="NCW"):
        super().__init__(1, None, 0, True, "max", layout, ndim=1)


class GlobalMaxPool2D(_Pool):
    def __init__(self, layout="NCHW"):
        super().__init__(1, None, 0, True, "max", layout, ndim=2)


class GlobalMaxPool3D(_Pool):
    def __init__(self, layout="NCDHW"):
        super().__init__(1, None, 0, True, "max", layout, ndim=3)


class GlobalAvgPool1D(_Pool):
    def __init__(self, layout="NCW"):
        super().__init__(1, None, 0, True, "avg", layout, ndim=1)


class GlobalAvgPool2D(_Pool):
    def __init__(self, layout="NCHW"):
        super().__init__(1, None, 0, True, "avg", layout, ndim=2)


class GlobalAvgPool3D(_Pool):
    def __init__(self, layout="NCDHW"):
        super().__init__(1, None, 0, True, "avg", layout, ndim=3)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the last two axes of an NCHW input: an int,
    (h, w), or (top, bottom, left, right)."""

    def __init__(self, padding=0):
        super().__init__()
        self._padding = _pair(padding, 2)

    def forward(self, x):
        p = self._padding
        if len(p) == 2:
            pads = ((0, 0), (0, 0), (p[0], p[0]), (p[1], p[1]))
        else:
            pads = ((0, 0), (0, 0), (p[0], p[1]), (p[2], p[3]))
        return mxnp.pad(x, pads, mode="reflect")


class PixelShuffle1D(HybridBlock):
    """(N, C*f, W) -> (N, C, W*f)."""

    def __init__(self, factor):
        super().__init__()
        self._factor = int(factor)

    def forward(self, x):
        f = self._factor
        n, cf, w = x.shape
        c = cf // f
        return x.reshape(n, c, f, w).permute(0, 1, 3, 2).reshape(n, c, w * f)

    def extra_repr(self):
        return f"factor={self._factor}"


class PixelShuffle2D(HybridBlock):
    """(N, C*fh*fw, H, W) -> (N, C, H*fh, W*fw)."""

    def __init__(self, factor):
        super().__init__()
        self._fh, self._fw = _pair(factor, 2)

    def forward(self, x):
        fh, fw = self._fh, self._fw
        n, cff, h, w = x.shape
        c = cff // (fh * fw)
        x = x.reshape(n, c, fh, fw, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c, h * fh, w * fw)

    def extra_repr(self):
        return f"factor=({self._fh}, {self._fw})"


class PixelShuffle3D(HybridBlock):
    """(N, C*fd*fh*fw, D, H, W) -> (N, C, D*fd, H*fh, W*fw)."""

    def __init__(self, factor):
        super().__init__()
        self._fd, self._fh, self._fw = _pair(factor, 3)

    def forward(self, x):
        fd, fh, fw = self._fd, self._fh, self._fw
        n, cf, d, h, w = x.shape
        c = cf // (fd * fh * fw)
        x = x.reshape(n, c, fd, fh, fw, d, h, w)
        x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
        return x.reshape(n, c, d * fd, h * fh, w * fw)

    def extra_repr(self):
        return f"factor=({self._fd}, {self._fh}, {self._fw})"


class DeformableConvolution(HybridBlock):
    """Deformable convolution v1 (reference `DeformableConvolution`): a
    regular conv (``offset``) predicts two offsets per kernel tap and
    output position, and the main conv samples its receptive field at
    the shifted positions by bilinear interpolation (zeros outside the
    image), as the reference builds it: the sampled columns gathered
    with plain indexing, then one product with the weight.  NCHW."""

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(1, 1), num_deformable_group=1, in_channels=0,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", activation=None):
        super().__init__()
        if num_deformable_group != 1:
            raise ValueError("num_deformable_group>1 is not supported")
        self._channels = channels
        self._kernel = _pair(kernel_size)
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        kh, kw = self._kernel
        self.offset = Conv2D(2 * kh * kw, kernel_size=self._kernel,
                             strides=self._strides, padding=self._padding,
                             in_channels=in_channels,
                             weight_initializer=offset_weight_initializer,
                             bias_initializer=offset_bias_initializer)
        self.weight = Parameter("weight",
                                shape=(channels, in_channels, kh, kw),
                                init=_resolve_init(weight_initializer),
                                allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(channels,),
                              init=_resolve_init(bias_initializer),
                              allow_deferred_init=True) if use_bias else None
        self.act = Activation(activation) if activation else None

    def forward(self, x):
        off = self.offset(x)
        if self.weight.shape[1] == 0:
            self.weight.shape = (self._channels, x.shape[1]) + self._kernel
        if self.weight._data is None:
            self.weight.finish_deferred_init()
        if self.bias is not None and self.bias._data is None:
            self.bias.finish_deferred_init()
        kh, kw = self._kernel
        sh, sw = self._strides
        ph, pw = self._padding
        n, c, h, w = x.shape
        oh, ow = off.shape[2], off.shape[3]
        dev = x.device
        oy = torch.arange(oh, device=dev) * sh - ph
        ox = torch.arange(ow, device=dev) * sw - pw
        ky, kx = torch.meshgrid(torch.arange(kh, device=dev),
                                torch.arange(kw, device=dev), indexing="ij")
        # (N, K, OH, OW) sampling positions: output position * stride -
        # pad + kernel tap + the predicted offset
        off = off.reshape(n, kh * kw, 2, oh, ow)
        ys = (oy[None, :, None] + ky.reshape(-1, 1, 1)) + off[:, :, 0]
        xs = (ox[None, None, :] + kx.reshape(-1, 1, 1)) + off[:, :, 1]
        y0 = torch.floor(ys)
        x0 = torch.floor(xs)
        wy = ys - y0
        wx = xs - x0
        y0 = y0.long()
        x0 = x0.long()
        flat = x.reshape(n, c, h * w)

        def gather(yy, xx):
            # (N, C, K, OH, OW), zeros outside the image
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(
                n, 1, -1).expand(n, c, -1)
            vals = torch.gather(flat, 2, idx).reshape(
                (n, c) + tuple(yy.shape[1:]))
            return torch.where(valid[:, None], vals, 0.0)

        wx_, wy_ = wx[:, None], wy[:, None]
        top = gather(y0, x0) * (1 - wx_) + gather(y0, x0 + 1) * wx_
        bot = gather(y0 + 1, x0) * (1 - wx_) + gather(y0 + 1, x0 + 1) * wx_
        cols = top * (1 - wy_) + bot * wy_
        wgt = self.weight.data()
        out = torch.einsum("nckhw,ock->nohw", cols,
                           wgt.reshape(wgt.shape[0], c, kh * kw))
        if self.bias is not None:
            out = out + self.bias.data()[None, :, None, None]
        return self.act(out) if self.act is not None else out
