"""Basic layers (counterpart of the subset of
`mxnet_tpu/gluon/nn/basic_layers.py` that BERT and ResNet use):
Sequential, HybridSequential, Dense, Dropout, Embedding, BatchNorm,
LayerNorm, Flatten, Identity, Activation, GELU."""
from __future__ import annotations

from ... import numpy_extension as npx
from ...initializer import resolve as _resolve_init
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "LayerNorm", "Flatten", "Identity", "Activation",
           "GELU"]


class Sequential(Block):
    """Runs its children in order.  They are named ``"0"``, ``"1"``, ...
    and live only in the block's child registry, so replacing one with
    ``setattr(seq, "0", block)`` takes effect (and keeps its place)."""

    @property
    def _layers(self):
        return list(self._modules.values())

    def add(self, *blocks):
        for block in blocks:
            setattr(self, str(len(self._modules)), block)

    def forward(self, x, *args):
        for block in self._layers:
            x = block(x, *args)
            args = ()
            if isinstance(x, (tuple, list)):
                args = tuple(x[1:])
                x = x[0]
        if args:
            return (x,) + args
        return x

    def __getitem__(self, i):
        if isinstance(i, slice):
            out = type(self)()
            out.add(*self._layers[i])
            return out
        return self._layers[i]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._layers)


class HybridSequential(Sequential, HybridBlock):
    pass


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


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` (reference basic_layers.py
    BatchNorm).  ``in_channels=0`` defers the four (C,) parameters to the
    first forward.  The running statistics do not take gradients; in
    train mode they are updated through `ops/aux_scope.py`."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=_resolve_init(gamma_initializer),
                               differentiable=scale, allow_deferred_init=True)
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=_resolve_init(beta_initializer),
                              differentiable=center, allow_deferred_init=True)
        self.running_mean = Parameter(
            "running_mean", shape=(in_channels,),
            init=_resolve_init(running_mean_initializer),
            differentiable=False, allow_deferred_init=True)
        self.running_var = Parameter(
            "running_var", shape=(in_channels,),
            init=_resolve_init(running_variance_initializer),
            differentiable=False, allow_deferred_init=True)

    def forward(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            if not p._shape_known():
                p.shape = (c,)
            if p._data is None:
                p.finish_deferred_init()
        return npx.batch_norm(
            x, self.gamma.data(), self.beta.data(), self.running_mean.data(),
            self.running_var.data(), eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Identity(HybridBlock):
    def forward(self, x):
        return x


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
