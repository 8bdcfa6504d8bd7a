"""Gluon Trainer (counterpart of `mxnet_tpu/gluon/trainer.py`).

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

Data parallelism in one process, as the reference's: parameters
initialized on a list of contexts keep one copy on each, and the
kvstore (`kvstore.create(kvstore)`, made at the first step) sums the
copies' gradients before the update.  As in the reference, no store is
made for ``None``, or for ``'local'`` / ``'device'`` while every
parameter has one copy in a world of one rank; any other name, several
copies or several ranks make one, and a `kvstore.KVStoreBase` is taken
as it is.  Across ranks the store reduces no single value, as in the
reference: `FusedTrainStep(mesh=)` sums the gradients inside its step
(ROADMAP queue C12 for the eager loop).  The store first
broadcasts each parameter's first copy to its others.  Each step then
reduces ``(index, list_grad())`` for every trainable parameter, in
reverse registration order (`pushpull_list`), and updates every copy
from the same reduced gradient with optimizer states of its own: the
step's scalars are computed once, and the multi-tensor update runs once
for each context's group of copies, so copies on one kind of device
stay bitwise equal.  With ``update_on_kvstore=True`` (a store that
``is_capable(OPTIMIZER)``, `LocalKVStore`) the store runs the optimizer
instead: after the reduce, each gradient is pushed to it and the
updated weight pulled into every copy, as the reference does, which
with n copies pushes n reduced copies and so applies n times their sum
(ROADMAP queue C, C10).  ``compression_params`` goes to the store's
``set_gradient_compression`` when the store is made (``2bit``, ``int8``,
``fp8``, with error feedback; a store without it raises the reference's
``ValueError``).  The reduce goes through the store's ``pushpull_list``
(its `GradBucketer`); ``MXNET_KVSTORE_BUCKETING=0`` pushes key by key,
in registration order with ``priority=-i``, as the reference does.

An optimizer with ``supports_fused = False`` (Nadam, SGLD) is applied
parameter by parameter instead (`Optimizer.update`: the gradient
rescaled and clipped in its own dtype, ``update_math`` with the host's
scalars, taken once for every copy of a parameter), as the reference's
Trainer does.

With a loss scaler attached (``amp.init_trainer``), `step` consults it
before the update, as the reference's step guard does: a step whose
gradients hold an inf or a NaN leaves weights and optimizer states
bitwise as they were (and the update counts where they were), counts
itself in ``skipped_steps`` and backs the scale off; a clean step lets
the scaler count it.  The check is one verdict over all gradients on the
device and one read of it.

Telemetry, as in the reference: ``step`` counts a step
(``mxtpu_trainer_steps_total``), times its ``allreduce`` and
``optimizer`` phases and the whole step
(``mxtpu_step_duration_seconds``, and a flight-recorder event); a step
the guard skips ticks ``mxtpu_train_steps_skipped_total`` and
``faultline.recovered("train.grads", "nan_grad")``.  Before the loss
scaler, the integrity guard (``MXNET_KVSTORE_INTEGRITY=1``) asks the
store for the reduce's integrity violations
(``consume_integrity_violations``): a step whose reduced gradients
disagreed across the copies is skipped the same way, with weights,
states and counts bitwise as they were, an ``integrity_violation``
event in the flight recorder and
``faultline.recovered("collective.dispatch", "bitflip")``.

``save_states`` / ``load_states`` write and read the optimizer states
in the JAX package's format (`optimizer.Updater`): the file of either
package loads in the other.  As in the reference, the file holds the
states only (SGD's momentum, Adam's moments), not the update counts,
and one state a parameter: a parameter with copies saves its first
copy's, and every copy loads the file's.
"""
from __future__ import annotations

import time as _time

import numpy as onp
import torch

from .. import _distributed
from .. import kvstore as _kvstore
from .. import observe as _observe
from .. import optimizer as opt
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..ops import capture
from ..optimizer.optimizer import _as_tuple, write_back, write_back_multi
from .parameter import Parameter

__all__ = ["Trainer", "StepPlan"]


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
        self._params = list(params)
        self._compression_params = compression_params
        self._scale = 1.0
        self.skipped_steps = 0
        self._states = None
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
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

    # -- kvstore ----------------------------------------------------------
    def _init_kvstore(self):
        """Make the store, once (see the module's docstring), and
        broadcast every parameter's first copy to its others."""
        if self._kv_initialized:
            return
        kv = self._kvstore_type
        if kv is None or kv is False:
            store = None
        elif isinstance(kv, _kvstore.KVStoreBase):
            store = kv
        elif isinstance(kv, str):
            # one copy in one process: no store; several copies or ranks
            several = any(len(p.list_ctx()) > 1 for p in self._params)
            ranks = _distributed.world()[1] > 1
            store = None if kv in ("local", "device") and not several \
                and not ranks else _kvstore.create(kv)
        else:
            raise MXNetError(f"invalid kvstore {kv!r}")
        if store is None or self._update_on_kvstore is None:
            self._update_on_kvstore = False
        if self._update_on_kvstore:
            if not store.is_capable(_kvstore.KVStoreBase.OPTIMIZER):
                raise ValueError(f"kvstore {store.type} does not support "
                                 "update_on_kvstore")
            store.set_optimizer(self._optimizer)
        if store is not None and self._compression_params is not None:
            if not hasattr(store, "set_gradient_compression"):
                raise ValueError(f"kvstore {store.type} does not support "
                                 "gradient compression")
            store.set_gradient_compression(self._compression_params)
        if store is not None:
            for i, param in enumerate(self._params):
                ctxs = param.list_ctx()
                if len(ctxs) > 1 and param._data is not None:
                    store.broadcast(i, param.data(ctxs[0]),
                                    param.list_data())
        self._kvstore = store
        self._kv_initialized = True

    @property
    def kvstore(self):
        self._init_kvstore()
        return self._kvstore

    # -- states -----------------------------------------------------------
    def _init_states(self):
        """One optimizer state per parameter, or per copy (a list) for a
        parameter with several."""
        if self._states is None:
            self._states = {}
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    states = [
                        self._optimizer.create_state_multi_precision(i, w)
                        for w in param.list_data()]
                    self._states[i] = states[0] if len(states) == 1 \
                        else states

    def _copy_states(self, i):
        """Parameter ``i``'s states, one per copy in context order (made
        anew where its copies changed, as after `reset_ctx`)."""
        entry = self._states[i]
        states = entry if isinstance(entry, list) else [entry]
        weights = self._params[i].list_data()
        if len(states) != len(weights):
            states = [self._optimizer.create_state_multi_precision(i, w)
                      for w in weights]
            self._states[i] = states[0] if len(states) == 1 else states
        return states

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
        """Write the optimizer states, a parameter's first copy's where
        it has several (reference `trainer.py:380`)."""
        self._init_states()
        updater = opt.Updater(self._optimizer)
        updater.states = {i: st[0] if isinstance(st, list) else st
                          for i, st in self._states.items()}
        with open(fname, "wb") as f:
            f.write(updater.get_states(dump_optimizer=False))

    def load_states(self, fname):
        """Copy the states in ``fname`` into this trainer's state tensors,
        every copy's, which keep their device and dtype."""
        updater = opt.Updater(self._optimizer)
        with open(fname, "rb") as f:
            updater.set_states(f.read())
        self._init_states()
        with torch.no_grad():
            for i, loaded in updater.states.items():
                copies = self._copy_states(i) if i in self._states else [()]
                for mine in copies:
                    if len(mine) != len(loaded) or any(
                            tuple(m.shape) != s.shape
                            for m, s in zip(mine, loaded)):
                        raise ValueError(
                            f"state {i} in '{fname}' has shapes "
                            f"{[s.shape for s in loaded]}; this trainer's "
                            f"are {[tuple(m.shape) for m in mine]}")
                    for m, s in zip(mine, loaded):
                        m.copy_(torch.from_numpy(s))

    # -- step -------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients over the copies, normalize them by
        ``batch_size`` and update; with a loss scaler attached, skip a
        step whose gradients overflowed."""
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
            self._allreduce_grads()
        if self._integrity_violated():
            return
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

    def _integrity_violated(self):
        """The integrity guard: whether the store's reduce flagged a
        corrupted bucket this step; such a step is counted as skipped
        and leaves the update out."""
        consume = getattr(self._kvstore, "consume_integrity_violations",
                          None)
        violations = consume() if consume is not None else 0
        if violations <= 0:
            return False
        from ..resilience import faultline as _faultline
        from ..resilience.policies import step_skip_counter
        self.skipped_steps += 1
        step_skip_counter().inc()
        _observe.record("sentinel", "integrity_violation",
                        site="collective.dispatch",
                        violations=int(violations))
        _faultline.recovered("collective.dispatch", "bitflip")
        return True

    def allreduce_grads(self):
        """Sum every trainable parameter's gradients over its copies, in
        place (nothing without a store)."""
        self._init_kvstore()
        with _telemetry.step_phase("allreduce"):
            self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        pairs = [(i, param.list_grad())
                 for i, param in enumerate(self._params)
                 if param.grad_req != "null"]
        if not pairs:
            return
        from ..kvstore import bucketing as _bucketing
        if _bucketing.bucketing_enabled():
            # reverse registration order: the order a backward produces
            # the gradients
            self._kvstore.pushpull_list(pairs[::-1])
            return
        for i, grads in pairs:
            self._kvstore.pushpull(i, grads, priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        with _telemetry.step_phase("optimizer"):
            self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._update_on_kvstore:
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    self._kvstore.push(i, param.list_grad())
                    self._kvstore.pull(i, param.list_data())
            return
        self._init_states()
        idx = self._trainable()
        if not idx:
            return
        if not self._optimizer.supports_fused:
            self._update_unfused(idx)
            return
        plan = self._plan(idx)
        for weights, grads, states in self._context_groups(idx):
            device = next(w for w in weights if w is not None).device
            rescale, rows = plan.views(capture.upload(plan.host, device))
            present = [p for p, g in enumerate(grads) if g is not None]
            scaled = iter(self._rescaled([grads[p] for p in present],
                                         rescale))
            grads = [None if g is None else next(scaled) for g in grads]
            self._apply(plan, rows, idx, weights, grads, states=states)

    def _context_groups(self, idx):
        """The copies of parameters ``idx``, one group a context (in the
        order the parameters' contexts first appear): ``(weights, grads,
        states)``, lists that line up with ``idx``, None where a
        parameter has no copy on that context."""
        groups = {}
        for pos, i in enumerate(idx):
            param = self._params[i]
            for ctx, w, g, st in zip(param.list_ctx(), param.list_data(),
                                     param.list_grad(), self._copy_states(i)):
                group = groups.setdefault(
                    ctx, tuple([None] * len(idx) for _ in range(3)))
                group[0][pos], group[1][pos], group[2][pos] = w, g, st
        return list(groups.values())

    def _update_unfused(self, idx):
        """Parameter by parameter, as `Optimizer.update` does it: one
        host count, lr and wd for every copy of it, then ``update_math``
        on each copy."""
        optimizer = self._optimizer
        for i in idx:
            lr, wd, _ = self._scalars(i)
            t = optimizer._index_update_count[i]
            param = self._params[i]
            for w, g, st in zip(param.list_data(), param.list_grad(),
                                self._copy_states(i)):
                new_w, new_st = optimizer.update_math(
                    w, optimizer.preprocess_grad(g), _as_tuple(st), lr, wd,
                    t)
                write_back(w, new_w, st, new_st)

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
               keep=None, states=None):
        """Clip the rescaled f32 gradients and apply the optimizer's
        ``update_multi`` to the weights and states in place, one group of
        ``plan`` at a time with its scalars ``rows[g]``.  ``weights`` and
        ``grads`` line up with ``indices``, the step's parameters in the
        plan's positions, all on one device; a position whose weight is
        None (a parameter without a copy on this call's context) is left
        out.  ``states`` (one a position) defaults to the trainer's
        states of ``indices``.  ``cast_back`` casts each clipped gradient
        to its weight's dtype first (the fused step's rounding point);
        ``keep`` (a 0-dim bool on the device) holds weights and states
        bitwise where it is False."""
        optimizer = self._optimizer
        clip = optimizer.clip_gradient
        if states is None:
            states = [self._states[i] for i in indices]
        present = [p for p, w in enumerate(weights) if w is not None]
        gs = [grads[p] for p in present]
        with torch.no_grad():
            if clip is not None:
                gs = torch._foreach_clamp_max(
                    torch._foreach_clamp_min(gs, -clip), clip)
            if cast_back:
                gs = [g.to(weights[p].dtype) for g, p in zip(gs, present)]
            gs = dict(zip(present, [g.float() for g in gs]))
            for positions, scalars in zip(plan.groups, rows):
                positions = [p for p in positions if p in gs]
                if not positions:
                    continue
                ws = [weights[p] for p in positions]
                sts = [states[p] for p in positions]
                new_w, new_st = optimizer.update_multi(
                    [w.float() for w in ws], [gs[p] for p in positions],
                    sts, scalars)
                olds = ws + [x for st in sts for x in st]
                news = [n.to(w.dtype) for n, w in zip(new_w, ws)] + \
                    [x for st in new_st for x in st]
                write_back_multi(olds, news, keep=keep)
