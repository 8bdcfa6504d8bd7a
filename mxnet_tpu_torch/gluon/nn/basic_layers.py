"""Basic layers (counterpart of the subset of
`mxnet_tpu/gluon/nn/basic_layers.py` that BERT uses): Dense, Dropout,
Embedding, LayerNorm, Activation, GELU."""
from __future__ import annotations

from ... import numpy_extension as npx
from ...initializer import resolve as _resolve_init
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "Activation",
           "GELU"]


class Dense(HybridBlock):
    """Fully-connected layer; the weight is stored (out, in).  The port
    needs ``in_units`` (the reference can defer it to the first input)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = Parameter("weight", shape=(units, in_units), dtype=dtype,
                                init=_resolve_init(weight_initializer))
        self.bias = Parameter("bias", shape=(units,), dtype=dtype,
                              init=_resolve_init(bias_initializer)) \
            if use_bias else None
        self.act = Activation(activation) if activation is not None else None

    def forward(self, x):
        out = npx.fully_connected(
            x, self.weight.data(),
            None if self.bias is None else self.bias.data(),
            flatten=self._flatten)
        return out if self.act is None else self.act(out)


class Dropout(HybridBlock):
    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def forward(self, x):
        return npx.dropout(x, p=self._rate)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter("weight", shape=(input_dim, output_dim),
                                dtype=dtype,
                                init=_resolve_init(weight_initializer))

    def forward(self, x):
        return npx.embedding(x, self.weight.data())


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, beta_initializer="zeros",
                 gamma_initializer="ones", in_channels=0):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=_resolve_init(gamma_initializer))
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=_resolve_init(beta_initializer))

    def forward(self, x):
        return npx.layer_norm(x, self.gamma.data(), self.beta.data(),
                              axis=self._axis, eps=self._epsilon)


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return npx.activation(x, act_type=self._act_type)


class GELU(HybridBlock):
    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation

    def forward(self, x):
        return npx.gelu(x, approximation=self._approx)
