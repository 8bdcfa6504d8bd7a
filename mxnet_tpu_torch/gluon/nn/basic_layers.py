"""Basic layers (counterpart of `mxnet_tpu/gluon/nn/basic_layers.py`):
the containers, Dense, Dropout, Embedding, the norms, the activations
and the concatenating container.  Dense and the norms take their input
widths at the first forward when they are not given (``in_units=0`` /
``in_channels=0``), as in the reference."""
from __future__ import annotations

import math

import torch

from ... import numpy as mxnp
from ... import numpy_extension as npx
from ...initializer import Constant
from ...initializer import resolve as _resolve_init
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "SyncBatchNorm", "LayerNorm", "GroupNorm",
           "InstanceNorm", "Flatten", "Lambda", "HybridLambda", "Identity",
           "Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish",
           "SiLU", "HybridConcatenate", "Concatenate"]


def _settle(params, c):
    """Give each parameter of unknown shape the width ``c`` and draw
    every one not drawn yet."""
    for p in params:
        if not p._shape_known():
            p.shape = (c,)
        if p._data is None:
            p.finish_deferred_init()


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
    """Fully-connected layer; the weight is stored (out, in).  With
    ``in_units=0`` the input width is taken at the first forward: the
    product of ``x.shape[1:]`` with ``flatten``, else ``x.shape[-1]``."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = units
        self._in_units = in_units
        self._flatten = flatten
        self._activation = activation
        self.weight = Parameter("weight", shape=(units, in_units), dtype=dtype,
                                init=_resolve_init(weight_initializer),
                                allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(units,), dtype=dtype,
                              init=_resolve_init(bias_initializer),
                              allow_deferred_init=True) if use_bias else None
        self.act = Activation(activation) if activation is not None else None

    def forward(self, x):
        if self.weight.shape[1] == 0:
            in_units = math.prod(x.shape[1:]) if self._flatten \
                else x.shape[-1]
            self.weight.shape = (self._units, in_units)
        if self.weight._data is None:
            self.weight.finish_deferred_init()
        if self.bias is not None and self.bias._data is None:
            self.bias.finish_deferred_init()
        out = npx.fully_connected(
            x, self.weight.data(),
            None if self.bias is None else self.bias.data(),
            flatten=self._flatten)
        return out if self.act is None else self.act(out)


class Dropout(HybridBlock):
    """Dropout at ``rate``; with ``axes``, one mask over those axes,
    broadcast over the others."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return npx.dropout(x, p=self._rate, axes=self._axes)


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
        _settle((self.gamma, self.beta, self.running_mean, self.running_var),
                x.shape[self._axis])
        return npx.batch_norm(
            x, self.gamma.data(), self.beta.data(), self.running_mean.data(),
            self.running_var.data(), eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)


class SyncBatchNorm(BatchNorm):
    """BatchNorm with the reference's signature: on one device the
    batch's statistics are already global."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        kwargs.pop("ndev", None)
        super().__init__(in_channels=in_channels, **kwargs)


class _Norm(HybridBlock):
    """gamma and beta of ``in_channels`` (0: taken at the first
    forward); ``scale=False`` / ``center=False`` keep them fixed."""

    def __init__(self, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels):
        super().__init__()
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=_resolve_init(gamma_initializer),
                               differentiable=scale, allow_deferred_init=True)
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=_resolve_init(beta_initializer),
                              differentiable=center, allow_deferred_init=True)


class LayerNorm(_Norm):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels)
        self._axis = axis

    def forward(self, x):
        _settle((self.gamma, self.beta), x.shape[self._axis])
        return npx.layer_norm(x, self.gamma.data(), self.beta.data(),
                              axis=self._axis, eps=self._epsilon)


class GroupNorm(_Norm):
    """Normalization over groups of channels (axis 1)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels)
        self._num_groups = num_groups

    def forward(self, x):
        _settle((self.gamma, self.beta), x.shape[1])
        return npx.group_norm(x, self.gamma.data(), self.beta.data(),
                              num_groups=self._num_groups,
                              eps=self._epsilon)


class InstanceNorm(_Norm):
    """Normalization of each sample's channel (axis 1) over its spatial
    axes; ``axis`` is accepted for the reference's signature."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels)

    def forward(self, x):
        _settle((self.gamma, self.beta), x.shape[1])
        return npx.instance_norm(x, self.gamma.data(), self.beta.data(),
                                 eps=self._epsilon)


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Identity(HybridBlock):
    def forward(self, x):
        return x


class Lambda(Block):
    """A function as a block: a callable, or the name of one in
    ``mx.np``."""

    def __init__(self, function):
        super().__init__()
        if isinstance(function, str):
            function = getattr(mxnp, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """A function as a hybrid block: a callable, or the name of one in
    ``mx.np`` or ``mx.npx``."""

    def __init__(self, function):
        super().__init__()
        if isinstance(function, str):
            function = getattr(mxnp, function, None) or \
                getattr(npx, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


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


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope per channel (axis 1), 0.25 unless
    ``alpha_initializer`` says otherwise."""

    def __init__(self, alpha_initializer=None, in_channels=1):
        super().__init__()
        self.alpha = Parameter("alpha", shape=(in_channels,),
                               init=_resolve_init(alpha_initializer) or
                               Constant(0.25))

    def forward(self, x):
        return npx.leaky_relu(x, gamma=self.alpha.data(), act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return npx.leaky_relu(x, act_type="selu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


SiLU = Swish


class HybridConcatenate(HybridBlock):
    """Runs each child on the same input and concatenates the results
    along ``axis``."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            setattr(self, str(len(self._modules)), block)

    def forward(self, x):
        return torch.cat([block(x) for block in self._modules.values()],
                         dim=self.axis)


Concatenate = HybridConcatenate
