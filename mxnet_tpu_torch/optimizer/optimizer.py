"""Optimizer base + registry (counterpart of
`mxnet_tpu/optimizer/optimizer.py`).

Each optimizer implements ``update_math``, a pure function
``(weight, grad, states, lr, wd, t) -> (new_weight, new_states)`` over
torch tensors, with ``lr``, ``wd`` and ``t`` host scalars: the rule for
one parameter, which `update` applies per parameter.

The Trainer and `FusedTrainStep` take the multi-tensor form instead, the
counterpart of the reference's one fused update program
(`_try_fused_update`): ``step_scalars(lr, wd, t)`` computes on the host
the values ``update_math`` would compute from its scalars (named by
``scalar_names``), the Trainer packs them for every parameter into one
f32 array that reaches the device with one copy, and
``update_multi(weights, grads, states, scalars)`` applies the same rule
to lists of f32 tensors with ``torch._foreach_*`` ops, ``scalars`` being
0-dim f32 device tensors.  Every intermediate rounds where
``update_math`` rounds it, and an f32 tensor scalar gives the product a
Python float gives (both round the scalar to f32 first), so the two forms
agree bitwise on the CPU.  A division by a scalar (AdamW's and LAMB's
bias corrections) is a true f32 division in both forms on the CPU; on the
card torch turns ``tensor / python_float`` into a product with the f32
reciprocal, which the multi-tensor form, dividing by a device tensor,
does not.  `write_back_multi` writes the results in place, holding
weights and states bitwise where the step's verdict is False.

An optimizer whose rule keeps host state that changes with every
parameter's update (Nadam's momentum schedule, SGLD's noise draws) sets
``supports_fused = False``: the Trainer applies it parameter by
parameter through `update`, and `FusedTrainStep` refuses it.

`Updater` holds per-index states and (de)serializes them in the JAX
package's format: a pickle of ``{index: tuple of numpy arrays}``.
"""
from __future__ import annotations

import io
import pickle

import numpy as onp
import torch

from ..base import registry
from ..utils.serialization import ArraysOnlyUnpickler

__all__ = ["Optimizer", "Updater", "register", "create", "get_updater",
           "Test", "all_finite", "write_back", "write_back_multi"]


class Optimizer:
    # False: the rule runs parameter by parameter (`update`), never in the
    # multi-tensor form or a captured step
    supports_fused = True

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 begin_num_update=0, param_dict=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise TypeError("param_idx2name must be a dict")
        self.idx2name = param_idx2name.copy()
        self.param_dict = param_dict if param_dict else {}
        self.lr_mult = {}
        self.wd_mult = {}

    opt_registry = registry.get_registry("optimizer")

    @staticmethod
    def register(klass):
        return registry.get_register_func(Optimizer, "optimizer")(klass)

    @staticmethod
    def create_optimizer(name, **kwargs):
        return Optimizer.opt_registry.get(name)(**kwargs)

    # -- state ------------------------------------------------------------
    def create_state(self, index, weight):
        return ()

    def create_state_multi_precision(self, index, weight):
        return self.create_state(index, weight)

    # -- lr / wd ----------------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.lr = lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = args_lr_mult.copy()

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = args_wd_mult.copy()

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        param = self.param_dict.get(index)
        if param is not None:
            lr *= getattr(param, "lr_mult", 1.0)
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        param = self.param_dict.get(index)
        if param is not None:
            wd *= getattr(param, "wd_mult", 1.0)
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- the update -------------------------------------------------------
    def preprocess_grad(self, grad):
        """Rescale (in the gradient's own dtype) and clip."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def update_math(self, weight, grad, states, lr, wd, t):
        """Pure update rule; override per optimizer.  ``grad`` arrives
        already rescaled and clipped."""
        raise NotImplementedError

    # the per-step host values ``update_multi`` reads, in packing order
    scalar_names = ("lr", "wd")

    def step_scalars(self, lr, wd, t):
        """The values named by ``scalar_names`` for one parameter's step,
        computed on the host as ``update_math`` computes them from
        ``lr``, ``wd`` and ``t``."""
        return (lr, wd)

    def update_multi(self, weights, grads, states, scalars):
        """``update_math`` over lists: ``weights`` and ``grads`` f32
        tensors (the weights widened), ``states`` one tuple a parameter,
        ``scalars`` a dict of 0-dim f32 tensors named by
        ``scalar_names``, shared by every parameter of the list.  Returns
        ``(new f32 weights, new state tuples)``; nothing is written."""
        raise NotImplementedError

    def update(self, indices, weights, grads, states):
        """Update ``weights`` and ``states`` in place (reference
        signature; lists or single values accepted)."""
        single = not isinstance(indices, (list, tuple))
        if single:
            indices, weights, grads, states = \
                [indices], [weights], [grads], [states]
        for index, weight, grad, state in zip(indices, weights, grads,
                                              states):
            self._update_count(index)
            new_w, new_states = self.update_math(
                weight, self.preprocess_grad(grad), _as_tuple(state),
                self._get_lr(index), self._get_wd(index),
                self._index_update_count[index])
            write_back(weight, new_w, state, new_states)


class Updater:
    """An optimizer with lazily created states, keyed by parameter index
    (reference `optimizer.py:250-300`; upstream `optimizer/updater.py`).
    ``updater(index, grad, weight)`` updates in place."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        single = not isinstance(index, (list, tuple))
        indices, grads, weights = ([index], [grad], [weight]) if single \
            else (list(index), list(grad), list(weight))
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
        self.optimizer.update(indices, weights, grads,
                              [self.states[i] for i in indices])

    def get_states(self, dump_optimizer=False):
        """The states as the JAX package pickles them: ``{index:
        tuple(numpy arrays)}``.  The optimizer object itself is not
        written: its class is this package's, which the JAX package
        cannot load."""
        if dump_optimizer:
            raise NotImplementedError(
                "dump_optimizer: the port writes states only, as the JAX "
                "package's Trainer.save_states does")
        return pickle.dumps({
            i: tuple(s.detach().cpu().numpy() for s in _as_tuple(st))
            for i, st in self.states.items()})

    def set_states(self, states_blob):
        """Load `get_states`' blob, or the JAX package's written without
        its optimizer (as its ``Trainer.save_states`` writes), as numpy
        arrays; the caller copies them into its state tensors."""
        payload = ArraysOnlyUnpickler(io.BytesIO(states_blob),
                                      "an optimizer state file").load()
        self.states = {i: tuple(onp.asarray(s) for s in _as_tuple(st))
                       for i, st in payload.items()}


def get_updater(optimizer):
    return Updater(optimizer)


def all_finite(tensors):
    """One 0-dim bool on the tensors' device: whether every element of
    every tensor is finite.  Reading it is the one sync."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def write_back(weight, new_w, state, new_states):
    """Copy an update into the weight and state tensors in place, outside
    autograd."""
    with torch.no_grad():
        pairs = [(weight, new_w)] + list(zip(_as_tuple(state),
                                             _as_tuple(new_states)))
        for old, new in pairs:
            old.copy_(new)


def write_back_multi(olds, news, keep=None):
    """Copy ``news[i]`` into ``olds[i]`` in place, outside autograd (one
    fused copy), or, with ``keep`` (a 0-dim bool tensor on the device),
    ``where(keep, new, old)`` into each old tensor, which holds it bitwise
    where ``keep`` is False."""
    with torch.no_grad():
        if keep is None:
            torch._foreach_copy_(list(olds), list(news))
        else:
            for old, new in zip(olds, news):
                torch.where(keep, new, old, out=old)


def _as_tuple(x):
    if x is None:
        return ()
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class Test(Optimizer):
    """The reference's trivial optimizer for tests: ``weight + grad *
    rescale_grad``, one state of zeros that it leaves as it is."""

    scalar_names = ("lr", "wd", "rescale")

    def create_state(self, index, weight):
        return (torch.zeros_like(weight),)

    def update_math(self, weight, grad, states, lr, wd, t):
        return weight + grad * self.rescale_grad, states

    def step_scalars(self, lr, wd, t):
        return (lr, wd, self.rescale_grad)

    def update_multi(self, weights, grads, states, scalars):
        return (torch._foreach_add(
            weights, torch._foreach_mul(grads, scalars["rescale"])),
            [tuple(st) for st in states])
