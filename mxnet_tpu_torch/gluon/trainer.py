"""Gluon Trainer (counterpart of `mxnet_tpu/gluon/trainer.py`), single
device.

Owns the optimizer and applies its update to every parameter whose
``grad_req`` is not ``'null'``, from the gradients the last backward
left in them.  The update follows the reference's fused path
(`_try_fused_update`): each gradient is rescaled in f32 by
``1 / batch_size``, clipped, and updated with the per-parameter lr, wd
and an f32 update count.  As the reference ships its per-parameter lrs,
wds and ts as packed f32 arrays, the host computes each step's scalars
(`StepPlan`: the rescale, then one row of the optimizer's
``step_scalars`` for each group of parameters whose rows are equal) into
one f32 array, which reaches the device with one copy; the update is the
optimizer's multi-tensor form, ``update_multi``, one list of
``torch._foreach_*`` ops a group, reading 0-dim views of that array, in
place and outside autograd.  `FusedTrainStep` captures the same update
inside its CUDA graph, with the array in a static buffer it rewrites
before each replay.

Only one device is supported: ``kvstore`` may be ``None``, ``'local'``
or ``'device'`` (each a no-op on one device), and ``allreduce_grads``
does nothing.  Other kvstores, ``update_on_kvstore``, gradient
compression and multi-device parameters raise ``NotImplementedError``
(ROADMAP queue A, distribution).

An optimizer with ``supports_fused = False`` (Nadam, SGLD) is applied
parameter by parameter instead (`Optimizer.update`: the gradient
rescaled and clipped in its own dtype, ``update_math`` with the host's
scalars), as the reference's Trainer does.

With a loss scaler attached (``amp.init_trainer``), `step` consults it
before the update, as the reference's step guard does: a step whose
gradients hold an inf or a NaN leaves weights and optimizer states
bitwise as they were (and the update counts where they were), counts
itself in ``skipped_steps`` and backs the scale off; a clean step lets
the scaler count it.  The check is one verdict over all gradients on the
device and one read of it.

Telemetry, as in the reference: ``step`` counts a step
(``mxtpu_trainer_steps_total``), times its ``allreduce`` (nothing to do
on one device) and ``optimizer`` phases and the whole step
(``mxtpu_step_duration_seconds``, and a flight-recorder event); a step
the guard skips ticks ``mxtpu_train_steps_skipped_total`` and
``faultline.recovered("train.grads", "nan_grad")``.

``save_states`` / ``load_states`` write and read the optimizer states
in the JAX package's format (`optimizer.Updater`): the file of either
package loads in the other.  As in the reference, the file holds the
states only (SGD's momentum, Adam's moments), not the update counts.
"""
from __future__ import annotations

import time as _time

import numpy as onp
import torch

from .. import observe as _observe
from .. import optimizer as opt
from .. import telemetry as _telemetry
from ..ops import capture
from ..optimizer.optimizer import write_back_multi
from .parameter import Parameter

__all__ = ["Trainer", "StepPlan"]

_LOCAL_KVSTORES = (None, False, "local", "device")


def _step_duration_histogram():
    return _telemetry.histogram(
        "mxtpu_step_duration_seconds",
        "End-to-end Trainer.step wall time (allreduce + step-guards + "
        "optimizer update), including steps the guards skipped — the "
        "distribution the straggler policy and the blackbox step lane "
        "both read")


class StepPlan:
    """One step's optimizer scalars on the host.  ``host`` is the packed
    f32 array: the gradient rescale, then one row of the optimizer's
    ``scalar_names`` for each group, then, for a loss-scaled step, the
    loss scale; ``groups[g]`` holds the positions (into the step's
    parameter list) of the parameters whose rows equal row ``g`` in f32,
    the group the update's ``_foreach_*`` lists run over.  ``key`` says
    how the array is laid out: a step captured with one layout replays
    only under the same one."""

    def __init__(self, rescale, rows, groups, names, loss_scale=None):
        self.names = tuple(names)
        self.groups = tuple(tuple(g) for g in groups)
        self.scaled = loss_scale is not None
        self.host = onp.asarray(
            [rescale] + [x for row in rows for x in row] +
            ([loss_scale] if self.scaled else []), dtype=onp.float32)
        self.key = (self.names, self.groups, self.scaled)

    def loss_scale(self, buf):
        """The loss scale as a 0-dim view of ``buf`` (the array's copy on
        the device), for a loss-scaled step."""
        return buf[self.host.size - 1]

    def views(self, buf):
        """The rescale and each group's scalars as 0-dim views of
        ``buf``, the array's copy on the device (f32, 1-D)."""
        k = len(self.names)
        rows = [{n: buf[1 + g * k + j] for j, n in enumerate(self.names)}
                for g in range(len(self.groups))]
        return buf[0], rows


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
        self.skipped_steps = 0
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
        """Normalize the gradients by ``batch_size`` and update; with a
        loss scaler attached, skip a step whose gradients overflowed."""
        t0 = _time.perf_counter()
        try:
            self._step(batch_size, ignore_stale_grad)
        finally:
            dt = _time.perf_counter() - t0
            _step_duration_histogram().observe(dt)
            _observe.record("step", "trainer.step", seconds=dt)

    def _step(self, batch_size, ignore_stale_grad):
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        _telemetry.mark_step()
        with _telemetry.step_phase("allreduce"):
            pass                        # one device: nothing to reduce
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None and scaler.has_overflow(
                [p for p in self._params if p.grad_req != "null"]):
            from ..resilience import faultline as _faultline
            from ..resilience.policies import step_skip_counter
            self.skipped_steps += 1
            step_skip_counter().inc()
            _faultline.recovered("train.grads", "nan_grad")
            scaler.update_scale(True)
            return
        with _telemetry.step_phase("optimizer"):
            self._update(ignore_stale_grad)
        if scaler is not None:
            scaler.update_scale(False)

    def allreduce_grads(self):
        """Nothing to reduce on one device."""
        self._init_kvstore()
        with _telemetry.step_phase("allreduce"):
            pass

    def update(self, batch_size, ignore_stale_grad=False):
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        with _telemetry.step_phase("optimizer"):
            self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        self._init_states()
        idx = self._trainable()
        if not idx:
            return
        weights = [self._params[i].data() for i in idx]
        if not self._optimizer.supports_fused:
            self._optimizer.update(idx, weights,
                                   [self._params[i].grad() for i in idx],
                                   [self._states[i] for i in idx])
            return
        plan = self._plan(idx)
        rescale, rows = plan.views(capture.upload(plan.host,
                                                  weights[0].device))
        grads = self._rescaled([self._params[i].grad() for i in idx],
                               rescale)
        self._apply(plan, rows, idx, weights, grads)

    def _plan(self, indices, loss_scale=None):
        """This step's `StepPlan` for parameters ``indices`` (their update
        counts move on by one, in the reference's order).  With
        ``loss_scale`` (the backward seed's multiplier), the rescale
        divides it back out and the plan carries it."""
        optimizer = self._optimizer
        rows, groups, where = [], [], {}
        for pos, i in enumerate(indices):
            lr, wd, t = self._scalars(i)
            row = onp.asarray(optimizer.step_scalars(lr, wd, t),
                              dtype=onp.float32)
            g = where.setdefault(row.tobytes(), len(rows))
            if g == len(rows):
                rows.append(row.tolist())
                groups.append([])
            groups[g].append(pos)
        rescale = optimizer.rescale_grad if loss_scale is None else \
            optimizer.rescale_grad / loss_scale
        return StepPlan(onp.float32(rescale), rows, groups,
                        optimizer.scalar_names, loss_scale)

    @staticmethod
    def _rescaled(grads, rescale):
        """Each gradient in f32 times ``rescale`` (a 0-dim f32 tensor)."""
        return torch._foreach_mul([g.float() for g in grads], rescale)

    def _apply(self, plan, rows, indices, weights, grads, cast_back=False,
               keep=None):
        """Clip the rescaled f32 gradients and apply the optimizer's
        ``update_multi`` to the weights and states in place, one group of
        ``plan`` at a time with its scalars ``rows[g]``.  ``cast_back``
        casts each clipped gradient to its weight's dtype first (the fused
        step's rounding point); ``keep`` (a 0-dim bool on the device)
        holds weights and states bitwise where it is False."""
        optimizer = self._optimizer
        clip = optimizer.clip_gradient
        with torch.no_grad():
            if clip is not None:
                grads = torch._foreach_clamp_max(
                    torch._foreach_clamp_min(list(grads), -clip), clip)
            if cast_back:
                grads = [g.to(w.dtype) for g, w in zip(grads, weights)]
            grads = [g.float() for g in grads]
            for positions, scalars in zip(plan.groups, rows):
                ws = [weights[p] for p in positions]
                states = [self._states[indices[p]] for p in positions]
                new_w, new_st = optimizer.update_multi(
                    [w.float() for w in ws], [grads[p] for p in positions],
                    states, scalars)
                olds = ws + [x for st in states for x in st]
                news = [n.to(w.dtype) for n, w in zip(new_w, ws)] + \
                    [x for st in new_st for x in st]
                write_back_multi(olds, news, keep=keep)
