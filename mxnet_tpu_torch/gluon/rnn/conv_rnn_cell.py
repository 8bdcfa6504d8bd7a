"""Convolutional RNN cells (counterpart of
`mxnet_tpu/gluon/rnn/conv_rnn_cell.py`): recurrent cells whose
input-to-hidden and hidden-to-hidden projections are convolutions over
spatial state maps (Shi et al., "Convolutional LSTM"), in 1, 2 and 3
spatial dimensions (NCW, NCHW, NCDHW), through `npx.convolution`.
"""
from __future__ import annotations

import torch

from ... import numpy_extension as npx
from ...initializer import resolve as _resolve_init
from ..parameter import Parameter
from .rnn_cell import RecurrentCell

__all__ = ["ConvRNNCell", "ConvLSTMCell", "ConvGRUCell",
           "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _pair(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _BaseConvRNNCell(RecurrentCell):
    def __init__(self, input_shape, hidden_channels, num_gates,
                 i2h_kernel, h2h_kernel, i2h_pad=(0, 0), activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout="NCHW"):
        super().__init__()
        if conv_layout not in ("NCW", "NCHW", "NCDHW"):
            raise ValueError(f"unsupported conv_layout {conv_layout!r}")
        self._layout = conv_layout
        ndim = len(conv_layout) - 2
        self._ndim = ndim
        self._input_shape = tuple(input_shape)  # (C, *spatial)
        self._hc = hidden_channels
        self._ng = num_gates
        self._i2h_kernel = _pair(i2h_kernel, ndim)
        self._h2h_kernel = _pair(h2h_kernel, ndim)
        self._i2h_pad = _pair(i2h_pad, ndim)
        for nm, t in (("i2h_kernel", self._i2h_kernel),
                      ("h2h_kernel", self._h2h_kernel),
                      ("i2h_pad", self._i2h_pad)):
            if len(t) != ndim:
                raise ValueError(
                    f"{nm}={t} has {len(t)} dims but conv_layout "
                    f"{conv_layout!r} implies {ndim}")
        if len(self._input_shape) != ndim + 1:
            raise ValueError(
                f"input_shape={input_shape} must be (C, *{ndim} spatial "
                f"dims) for conv_layout {conv_layout!r}")
        if not all(k % 2 == 1 for k in self._h2h_kernel):
            raise ValueError("h2h_kernel must be odd to preserve the state "
                             "shape")
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        self._activation = activation

        in_c = self._input_shape[0]
        ng = num_gates
        self.i2h_weight = Parameter(
            "i2h_weight", shape=(ng * hidden_channels, in_c) +
            self._i2h_kernel,
            init=_resolve_init(i2h_weight_initializer))
        self.h2h_weight = Parameter(
            "h2h_weight", shape=(ng * hidden_channels, hidden_channels) +
            self._h2h_kernel,
            init=_resolve_init(h2h_weight_initializer))
        self.i2h_bias = Parameter(
            "i2h_bias", shape=(ng * hidden_channels,),
            init=_resolve_init(i2h_bias_initializer))
        self.h2h_bias = Parameter(
            "h2h_bias", shape=(ng * hidden_channels,),
            init=_resolve_init(h2h_bias_initializer))

    def _state_shape(self):
        spatial = self._input_shape[1:]
        out = tuple(s + 2 * p - k + 1 for s, k, p in
                    zip(spatial, self._i2h_kernel, self._i2h_pad))
        return (self._hc,) + out

    def state_info(self, batch_size=0):
        shape = (batch_size,) + self._state_shape()
        return [{"shape": shape, "__layout__": self._layout}
                for _ in range(len(self._state_names))]

    def _proj(self, x, states):
        i2h = npx.convolution(x, self.i2h_weight.data(),
                              self.i2h_bias.data(),
                              kernel=self._i2h_kernel, pad=self._i2h_pad,
                              num_filter=self._ng * self._hc,
                              layout=self._layout)
        h2h = npx.convolution(states[0], self.h2h_weight.data(),
                              self.h2h_bias.data(),
                              kernel=self._h2h_kernel, pad=self._h2h_pad,
                              num_filter=self._ng * self._hc,
                              layout=self._layout)
        return i2h, h2h

    def _act(self, x):
        if self._activation in ("relu", "tanh", "sigmoid", "softrelu"):
            return npx.activation(x, act_type=self._activation)
        return getattr(npx, self._activation)(x)


class ConvRNNCell(_BaseConvRNNCell):
    _state_names = ["h"]

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1), activation="tanh",
                 **kwargs):
        super().__init__(input_shape, hidden_channels, 1, i2h_kernel,
                         h2h_kernel, i2h_pad, activation, **kwargs)

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        out = self._act(i2h + h2h)
        return out, [out]


class ConvLSTMCell(_BaseConvRNNCell):
    _state_names = ["h", "c"]

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1), activation="tanh",
                 **kwargs):
        super().__init__(input_shape, hidden_channels, 4, i2h_kernel,
                         h2h_kernel, i2h_pad, activation, **kwargs)

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        gates = i2h + h2h
        hc = self._hc
        i = torch.sigmoid(gates[:, :hc])
        f = torch.sigmoid(gates[:, hc:2 * hc])
        c_in = self._act(gates[:, 2 * hc:3 * hc])
        o = torch.sigmoid(gates[:, 3 * hc:])
        next_c = f * states[1] + i * c_in
        next_h = o * self._act(next_c)
        return next_h, [next_h, next_c]


class ConvGRUCell(_BaseConvRNNCell):
    _state_names = ["h"]

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1), activation="tanh",
                 **kwargs):
        super().__init__(input_shape, hidden_channels, 3, i2h_kernel,
                         h2h_kernel, i2h_pad, activation, **kwargs)

    def forward(self, inputs, states):
        i2h, h2h = self._proj(inputs, states)
        hc = self._hc
        r = torch.sigmoid(i2h[:, :hc] + h2h[:, :hc])
        z = torch.sigmoid(i2h[:, hc:2 * hc] + h2h[:, hc:2 * hc])
        n = self._act(i2h[:, 2 * hc:] + r * h2h[:, 2 * hc:])
        next_h = (1 - z) * n + z * states[0]
        return next_h, [next_h]


def _dim_variant(base, ndim, layout, name):
    """The per-dimension conv cell ``name`` (Conv{1,2,3}D{RNN,LSTM,GRU}Cell):
    ``base`` in ``layout``, kernels of size 3 and no input padding by
    default."""
    class _Cell(base):
        def __init__(self, input_shape, hidden_channels,
                     i2h_kernel=(3,) * ndim, h2h_kernel=(3,) * ndim,
                     i2h_pad=(0,) * ndim, activation="tanh", **kwargs):
            kwargs.setdefault("conv_layout", layout)
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad, activation, **kwargs)
    _Cell.__name__ = _Cell.__qualname__ = name
    return _Cell


Conv1DRNNCell = _dim_variant(ConvRNNCell, 1, "NCW", "Conv1DRNNCell")
Conv2DRNNCell = _dim_variant(ConvRNNCell, 2, "NCHW", "Conv2DRNNCell")
Conv3DRNNCell = _dim_variant(ConvRNNCell, 3, "NCDHW", "Conv3DRNNCell")
Conv1DLSTMCell = _dim_variant(ConvLSTMCell, 1, "NCW", "Conv1DLSTMCell")
Conv2DLSTMCell = _dim_variant(ConvLSTMCell, 2, "NCHW", "Conv2DLSTMCell")
Conv3DLSTMCell = _dim_variant(ConvLSTMCell, 3, "NCDHW", "Conv3DLSTMCell")
Conv1DGRUCell = _dim_variant(ConvGRUCell, 1, "NCW", "Conv1DGRUCell")
Conv2DGRUCell = _dim_variant(ConvGRUCell, 2, "NCHW", "Conv2DGRUCell")
Conv3DGRUCell = _dim_variant(ConvGRUCell, 3, "NCDHW", "Conv3DGRUCell")
