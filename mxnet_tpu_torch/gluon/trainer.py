"""Gluon Trainer (counterpart of `mxnet_tpu/gluon/trainer.py`), single
device.

Owns the optimizer and applies its update to every parameter whose
``grad_req`` is not ``'null'``, from the gradients the last backward
left in them.  The update follows the reference's fused path
(`_try_fused_update`): each gradient is rescaled in f32 by
``1 / batch_size``, clipped, and handed to ``update_math`` with the
per-parameter lr, wd and an f32 update count.  The reference compiled
that loop into one XLA program; here it is plain torch ops per
parameter, in place, outside autograd.

Only one device is supported: ``kvstore`` may be ``None``, ``'local'``
or ``'device'`` (each a no-op on one device), and ``allreduce_grads``
does nothing.  Other kvstores, ``update_on_kvstore``, gradient
compression and multi-device parameters raise ``NotImplementedError``
(ROADMAP queue A, distribution).

``save_states`` / ``load_states`` write and read the optimizer states
in the JAX package's format (`optimizer.Updater`): the file of either
package loads in the other.  As in the reference, the file holds the
states only (SGD's momentum, Adam's moments), not the update counts.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import optimizer as opt
from ..optimizer.optimizer import write_back
from .parameter import Parameter

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, False, "local", "device")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            params = [params[k] for k in sorted(params)]
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a dict or list of Parameters")
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(f"element {i} is not a Parameter")
        if kvstore not in _LOCAL_KVSTORES:
            raise NotImplementedError(
                f"kvstore {kvstore!r}: the port's Trainer runs on one "
                "device (kvstores and collectives are ROADMAP queue A, "
                "distribution)")
        if update_on_kvstore or compression_params is not None:
            raise NotImplementedError(
                "update_on_kvstore and gradient compression need a "
                "distributed kvstore (ROADMAP queue A, distribution)")
        self._params = list(params)
        self._scale = 1.0
        self._states = None
        self._init_optimizer(optimizer, optimizer_params or {})

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- states -----------------------------------------------------------
    def _init_kvstore(self):
        """Check the one-device contract (the reference creates its
        kvstore here)."""
        for param in self._params:
            if len(param.list_ctx()) != 1:
                raise NotImplementedError(
                    f"parameter {param.name} lives on several devices; the "
                    "port's Trainer is single-device (ROADMAP queue A)")

    def _init_states(self):
        if self._states is None:
            self._states = {
                i: self._optimizer.create_state_multi_precision(
                    i, param.data())
                for i, param in enumerate(self._params)
                if param.grad_req != "null"}

    def _trainable(self):
        return [i for i, p in enumerate(self._params) if p.grad_req != "null"]

    def _scalars(self, i):
        """Update count, lr, wd and f32 count of parameter ``i`` for one
        step, in the reference's order."""
        optimizer = self._optimizer
        optimizer._update_count(i)
        return (optimizer._get_lr(i), optimizer._get_wd(i),
                onp.float32(optimizer._index_update_count[i]))

    def save_states(self, fname):
        """Write the optimizer states (reference `trainer.py:380`)."""
        self._init_states()
        updater = opt.Updater(self._optimizer)
        updater.states = self._states
        with open(fname, "wb") as f:
            f.write(updater.get_states(dump_optimizer=False))

    def load_states(self, fname):
        """Copy the states in ``fname`` into this trainer's state tensors,
        which keep their device and dtype."""
        updater = opt.Updater(self._optimizer)
        with open(fname, "rb") as f:
            updater.set_states(f.read())
        self._init_states()
        with torch.no_grad():
            for i, loaded in updater.states.items():
                mine = self._states.get(i, ())
                if len(mine) != len(loaded) or any(
                        tuple(m.shape) != s.shape
                        for m, s in zip(mine, loaded)):
                    raise ValueError(
                        f"state {i} in '{fname}' has shapes "
                        f"{[s.shape for s in loaded]}; this trainer's are "
                        f"{[tuple(m.shape) for m in mine]}")
                for m, s in zip(mine, loaded):
                    m.copy_(torch.from_numpy(s))

    # -- step -------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Normalize the gradients by ``batch_size`` and update."""
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to reduce on one device."""
        self._init_kvstore()

    def update(self, batch_size, ignore_stale_grad=False):
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        self._init_states()
        idx = self._trainable()
        self._apply(idx, [self._params[i].data() for i in idx],
                    self._rescaled(self._params[i].grad() for i in idx))

    def _rescaled(self, grads):
        """Each gradient in f32 times ``rescale_grad`` (lazily, one at a
        time)."""
        rescale = float(onp.float32(self._optimizer.rescale_grad))
        return (g.float() * rescale for g in grads)

    def _apply(self, indices, weights, grads, cast_back=False, keep=None):
        """Clip each rescaled f32 gradient and apply ``update_math`` to
        its weight and state in place, with the per-parameter lr, wd and
        f32 update count.  ``cast_back`` casts the clipped gradient to
        the weight's dtype first (the fused step's rounding point);
        ``keep`` (a 0-dim bool on the device) holds weights and states
        bitwise where it is False."""
        optimizer = self._optimizer
        clip = optimizer.clip_gradient
        with torch.no_grad():
            for i, w, g in zip(indices, weights, grads):
                lr, wd, t = self._scalars(i)
                if clip is not None:
                    g = torch.clamp(g, -clip, clip)
                if cast_back:
                    g = g.to(w.dtype)
                new_w, new_st = optimizer.update_math(w, g, self._states[i],
                                                      lr, wd, t)
                write_back(w, new_w, self._states[i], new_st, keep=keep)
