"""One training step: forward, gradients and the optimizer update
(counterpart of `mxnet_tpu/gluon/fused_step.py`), on one device or on
one device a rank over a data-parallel mesh.

``FusedTrainStep(block, trainer)(*inputs, batch_size=B)`` does what
``with autograd.record(): loss = block(*inputs)``, ``loss.backward()``
and ``trainer.step(B)`` do, in the order and at the rounding points of
the reference's one-program step:

- the forward runs recorded and in train mode, and under
  `ops.invoke.tracing` at every call (its eager first one too), so
  control flow inside takes the reference's traced contract
  (``while_loop`` padded to ``max_iterations``, ``cond`` selected on
  the device) and call 1 returns what the replays return; the backward
  seed is the f32 sum of the block's first output leaf;
- the gradients of the trainable parameters (those the trainer owns,
  ``grad_req`` not ``'null'``) are taken with `torch.autograd.grad`,
  so the parameters' stored gradients are not accumulated into (a
  ``'write'`` parameter's is cleared);
- each gradient is rescaled in f32; one finite-gradient verdict is
  taken over all of them before clipping; each is clipped and cast
  back to its weight's dtype before the update widens it again;
- a step whose verdict is False leaves every weight and optimizer state
  bitwise as it was.  The verdict stays on the device as
  ``last_step_finite`` (reading it as a bool syncs);
- auxiliary state that the forward updates (BatchNorm running
  statistics) is collected in an `ops.aux_scope` around the forward and
  committed after the update under the same verdict, so a skipped step
  leaves it bitwise too.

The reference compiles all of it into one donated XLA program, one
host-to-device dispatch a step.  On a CUDA device the port captures it
into one CUDA graph (`ops.capture`) and replays it:

- the first call of a signature (the input shapes, dtypes and devices,
  the non-tensor inputs, ``batch_size``, the trainable set and the
  layout of the optimizer's packed scalars) runs eagerly: a real step,
  which also warms cuBLAS, cuDNN, the allocator and the kernel builds,
  and records the step's random draw sites in order (`ops.seeds`);
- the second captures the step over static copies of the inputs, a
  static seed buffer (one row of two words a draw site) and the static
  copy of the trainer's packed scalars (`gluon.trainer.StepPlan`), then
  replays it;
- each later call copies its inputs into the static ones, draws the
  step's seed words from the generator in the recorded order, computes
  the optimizer's scalars on the host, writes words and scalars into the
  static buffer with one copy (through `ops.capture.HostRing`), and
  replays.  Outputs and ``last_step_finite`` are copies of the graph's
  buffers.

A parameter bound to a new tensor (`Parameter.set_data`, ``cast``,
``load_parameters``) has a new ``generation``, and the next call
captures the step again; in-place copies (`Trainer.load_states`) keep
the graph.  A capture that fails raises: the step does not fall back
to the eager path.  The capture differentiates to fresh leaves over the
trainable parameters' storage (`_fresh_leaves`), so an eager step's
loss whose autograd graph is still alive does not reach into it.  On
the CPU every call runs eagerly.

Deferred parameter shapes are settled before the first step by one
forward in predict mode (`Block._ensure_shapes`).  Train-mode randomness
draws from ``generator`` (a CPU ``torch.Generator``), or from an
enclosing ``autograd.record``/``train_mode`` scope's.  Parameters with
copies on several contexts of one process are ROADMAP queue A item
A7b-rest and raise ``NotImplementedError``; the
record/backward/``Trainer.step`` loop trains over copies.

Ranks (``mesh=``, a `parallel.make_mesh` over the ranks of the
``torch.distributed`` group, one device a rank; `tools/launch.py`
starts them).  Every rank passes the same global batch and
``batch_size`` of the global batch, as in the reference:

- each tensor input whose leading axis divides by the mesh's data axis
  (``data_spec``'s first entry, default the mesh's first axis) is cut
  to this rank's rows (`parallel.global_put`); other inputs are taken
  whole;
- at setup the parameters are broadcast from rank 0
  (`parallel.shard_parameters`, ``partition_rules`` checked there:
  a rule that shards raises, ROADMAP queue A item A8);
- the forward runs inside `parallel.mesh_scope`, so BatchNorm's
  statistics are global across the ranks (`ops.nn`);
- the backward seed is the f32 sum of the first output over this
  rank's rows; every gradient is then summed across the group (one
  ``all_reduce`` a gradient), before the finite verdict and the update,
  so every rank takes the same verdict and applies the same update with
  ``rescale_grad = scale / batch_size`` of the global batch.  A first
  output that is not one value a row (a 0-d mean, as the reference's
  ``(d * d).mean()`` loss) is read as a mean over the batch: its seed
  is divided by the number of ranks, so the sum of the ranks' gradients
  is the gradient of the global batch's mean, exactly with rows split
  evenly;
- outputs come back as the global batch's: one value a row gathered
  across the ranks (an ``all_reduce`` of a zero-padded buffer, which
  both backends carry), a floating output of another shape averaged
  over the ranks.

Under ``nccl`` (one card a rank) the collectives are captured with the
rest of the step: the eager first call of a signature runs them once,
which starts the communicator, before the capture, and a replay syncs
the host never.  Under ``gloo`` (ranks sharing a card, or the CPU) a
collective waits on the host, which a CUDA graph cannot capture, so
every call runs the step's body eagerly (``eager_reason`` says why).
A group of one rank runs the collectives too.  ``recipe`` (and the
``MXNET_PARALLEL_RECIPE`` default) and a mesh axis of more than one
rank besides the data axis are ROADMAP queue A item A8 and raise.

Loss scaling (amp): a `amp.LossScaler`, ``scaler=`` or the one
``amp.init_trainer`` attached to the trainer, multiplies the backward
seed by its ``loss_scale``, and the rescale divides it back out
(``rescale_grad / loss_scale``).  Both values are read from the packed
f32 scalars (`StepPlan`) that each call rewrites, so a replay runs with
the scale of its own step.  After the step, one read of the verdict
drives the scale (``update_scale(not finite)``) and counts a skipped
step in the trainer's ``skipped_steps``: one host sync a step, where a
step without a scaler syncs never.  As in the reference, the update
counts move on before the verdict is known, so a skipped step advances
them too.  An optimizer with ``supports_fused = False`` is refused
(``ValueError``).

Operations (the reference's hooks, `telemetry`, `resilience`): each
call polls ``faultline`` at ``train.grads`` before anything of the step
happens.  A ``nan_grad`` fault writes NaN into the rescale slot of the
packed scalars, which the eager step and a replay alike read on the
card, so every gradient goes NaN and the finite verdict holds the
update, as the reference poisons its program's rescale input; the
other kinds raise there (``InjectedPreemption`` for ``preempt``), so the
interrupted step changes nothing, not even the update counts.  A
skipped step ticks ``mxtpu_train_steps_skipped_total`` and
``faultline.recovered("train.grads", "nan_grad")``: with a scaler from
the verdict it reads anyway; without one only on a step whose
``nan_grad`` this call injected, which reads the verdict once (the
reference ticks nothing there).  Each call counts a step
(``telemetry.mark_step``), runs inside ``step_phase("fused-step")``
(host time: the eager step, or the replay's launch, never a sync) and
lets the retrace watchdog observe ``captures``.
"""
from __future__ import annotations

import contextlib

import numpy as onp
import torch

from .. import _distributed
from .. import autograd
from .. import telemetry as _telemetry
from ..parallel import mesh as _mesh
from ..ops import capture
from ..ops.aux_scope import aux_update_scope
from ..ops.invoke import current_generator, set_seed_table, tracing
from ..ops.seeds import SeedTable, draw_words
from ..optimizer.optimizer import Optimizer, all_finite, write_back_multi
from ..resilience import faultline as _faultline
from ..resilience.policies import step_skip_counter as _step_skip_counter

__all__ = ["FusedTrainStep"]


def _first_leaf(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _detached(outs, copy=False):
    if isinstance(outs, torch.Tensor):
        return outs.detach().clone() if copy else outs.detach()
    return tuple(_detached(o, copy) for o in outs)


@contextlib.contextmanager
def _fresh_leaves(params):
    """Bind each of ``params`` to a new leaf over the same storage
    (``detach``), without a new ``generation``, and back on exit; yields
    the leaves.  A leaf's gradient accumulator lives as long as an
    autograd graph that reaches it, and belongs to the stream that graph
    was recorded on: a capture that differentiated to a leaf of a live
    eager step would make that stream wait on the capture's, which
    invalidates the capture."""
    old = [p._data for p in params]
    leaves = [t.detach().requires_grad_(t.requires_grad) for t in old]
    for p, t in zip(params, leaves):
        p._data = t
    try:
        yield leaves
    finally:
        for p, t in zip(params, old):
            p._data = t


@contextlib.contextmanager
def _seed_table(table):
    prev = set_seed_table(table)
    try:
        yield
    finally:
        set_seed_table(prev)


class _Captured:
    """One signature's captured step: the graph, its static inputs, the
    buffer of seed words then packed scalars, its outputs, and what the
    capture saw (the draw kinds, the parameters' generations)."""

    def __init__(self, graph, args, buf, outs, finite, kinds, generations):
        self.graph = graph
        self.args = args
        self.buf = buf
        self.outs = outs
        self.finite = finite
        self.kinds = kinds
        self.generations = generations
        self.ring = capture.HostRing(buf.numel(), buf.device)


def _data_axis(mesh, data_spec):
    """(spec, dp): the input spec (default: the mesh's first axis) and the
    ranks its leading entry spans, which must be the whole mesh."""
    spec = _mesh.PartitionSpec(*(data_spec if data_spec is not None
                                 else (mesh.axis_names[0],)))
    lead = spec[0] if len(spec) else None
    axes = () if lead is None else \
        ((lead,) if isinstance(lead, str) else tuple(lead))
    dp = 1
    for a in axes:
        dp *= mesh.shape[a]
    if dp != mesh.size:
        raise NotImplementedError(
            f"mesh {mesh.shape} with data spec {spec!r}: axes besides the "
            "data axis larger than 1 (tensor, sequence or pipeline "
            "parallelism) are ROADMAP queue A item A8")
    return spec, dp


class FusedTrainStep:
    """Fuse ``loss = block(*inputs); loss.backward(); trainer.step(bs)``
    into one call.  ``block`` must produce the loss (its first output
    leaf is summed as the backward seed) and the trainer's optimizer
    must implement ``update_multi``.  ``captures`` counts the steps
    captured into CUDA graphs so far.

    >>> step = FusedTrainStep(mod, trainer, generator=torch.Generator())
    >>> loss = step(x, y, batch_size=128)
    """

    def __init__(self, block, trainer, mesh=None, partition_rules=None,
                 data_spec=None, scaler=None, recipe=None, generator=None):
        if recipe is None and mesh is None:
            from .. import env as _env
            recipe = _env.parallel_recipe()
        if recipe is not None:
            raise NotImplementedError(
                f"recipe {recipe!r}: sharding recipes are ROADMAP queue A "
                "item A8 in the port; pass mesh=parallel.make_mesh("
                "{'dp': -1}) for data parallelism")
        self._mesh = mesh
        self._rules = partition_rules or []
        self._dp = 1
        if mesh is not None:
            self._data_spec, self._dp = _data_axis(mesh, data_spec)
        self._rows = None        # this rank's rows of the last batch
        self.eager_reason = None
        self._block = block
        self._trainer = trainer
        self._scaler = scaler if scaler is not None else \
            getattr(trainer, "_amp_loss_scaler", None)
        self._generator = generator
        self.last_step_finite = None
        self.captures = 0
        self._plist = None
        self._managed = None
        self._train_idx = None
        self._opt_index = None
        self._kinds = {}       # signature -> draw kinds of its first call
        self._graphs = {}      # signature -> _Captured

    def _setup(self, args):
        trainer = self._trainer
        opt = trainer._optimizer
        if not opt.supports_fused or \
                type(opt).update_multi is Optimizer.update_multi:
            raise ValueError(f"{type(opt).__name__} has no update_multi; "
                             "use the eager record/backward/step path")
        self._block._ensure_shapes(*args)
        several = [p.name for p in trainer._params if len(p.list_ctx()) > 1]
        if several:
            raise NotImplementedError(
                f"parameters with copies on several contexts ({several[0]}, "
                "...): FusedTrainStep over copies in one process is ROADMAP "
                "queue A item A7b-rest; use the record/backward/Trainer.step "
                "loop, or one rank a device (tools/launch.py) and mesh=")
        params = self._block.collect_params()
        if self._mesh is not None:
            self._join_mesh(params)
        trainer._init_kvstore()
        trainer._init_states()
        self._plist = [params[k] for k in sorted(params)]
        self._managed = {id(p): i for i, p in enumerate(trainer._params)}

    def _join_mesh(self, params):
        """Check the mesh against the process group, replicate the
        parameters from rank 0 and decide whether the step is captured."""
        world = _distributed.world()[1]
        ranks = sorted(int(r) for r in self._mesh.devices.flat)
        if ranks != list(range(world)):
            raise ValueError(
                f"mesh {self._mesh.shape} over ranks {ranks} in a world of "
                f"{world}: a step's mesh spans the process group (start the "
                "ranks with tools/launch.py -n N)")
        _mesh.shard_parameters(params, self._mesh, self._rules)
        if _distributed.backend() == "gloo":
            self.eager_reason = (
                "gloo: its collectives wait on the host, which a CUDA graph "
                "cannot capture")

    def _trainable(self):
        """The trainable parameters: a gradient AND managed by this
        trainer (positions in the block's list, and the trainer's)."""
        self._train_idx = tuple(
            k for k, p in enumerate(self._plist)
            if p.grad_req != "null" and id(p) in self._managed)
        self._opt_index = tuple(self._managed[id(self._plist[k])]
                                for k in self._train_idx)

    def __call__(self, *args, batch_size=1):
        return self.step(*args, batch_size=batch_size)

    def step(self, *args, batch_size=1):
        inject = _faultline.poll("train.grads")
        if inject is not None and inject != "nan_grad":
            _faultline.raise_fault("train.grads", inject)
        if self._mesh is not None:
            args = self._local_rows(args)
        if self._plist is None:
            self._setup(args)
        self._trainable()
        trainer = self._trainer
        trainer._optimizer.rescale_grad = trainer._scale / batch_size
        weights = [self._plist[k].data() for k in self._train_idx]
        plan = trainer._plan(self._opt_index, None if self._scaler is None
                             else float(self._scaler.loss_scale))
        if inject == "nan_grad":
            # poison the rescale: every gradient goes NaN and the step's
            # own guard must hold the update
            plan.host[0] = onp.float32("nan")
        _telemetry.mark_step()
        with _telemetry.step_phase("fused-step"):
            outs = self._dispatch(args, weights, plan, batch_size)
        _telemetry.watchdog().observe(
            self, name=f"FusedTrainStep[{type(self._block).__name__}]",
            scope_root=getattr(self._block, "name", None))
        self._guard(inject)
        return outs

    def _local_rows(self, args):
        """Each tensor input whose leading axis divides over the ranks cut
        to this rank's rows; the others whole."""
        sharding = _mesh.NamedSharding(self._mesh, self._data_spec)
        out, self._rows = [], None
        for a in args:
            if isinstance(a, torch.Tensor) and a.ndim and \
                    a.shape[0] >= self._dp and a.shape[0] % self._dp == 0:
                a = _mesh.global_put(a, sharding)
                self._rows = self._rows or a.shape[0]
            out.append(a)
        return tuple(out)

    def _dispatch(self, args, weights, plan, batch_size):
        if not weights or not capture.capturable(weights[0].device) or \
                self.eager_reason is not None:
            return self._eager(args, weights, plan)
        sig = (tuple((tuple(a.shape), a.dtype, a.device)
                     if isinstance(a, torch.Tensor) else ("value", a)
                     for a in args),
               batch_size, self._train_idx, plan.key)
        entry = self._graphs.get(sig)
        if entry is not None and entry.generations != self._generations():
            entry = None                  # a parameter was rebound
        if entry is None and sig not in self._kinds:
            table = SeedTable()
            with _seed_table(table):
                outs = self._eager(args, weights, plan)
            self._kinds[sig] = tuple(table.kinds)
            return outs
        if entry is None:
            entry, words = self._capture(args, weights, plan,
                                         self._kinds[sig])
            self._graphs[sig] = entry
        else:
            words = draw_words(entry.kinds, self._generator_for(entry))
        return self._replay(entry, args, plan, words)

    # -- the step's work -----------------------------------------------------
    def _body(self, args, weights, plan, buf, leaves=None):
        """Forward, gradients, verdict and update on device tensors, the
        optimizer's scalars (and a loss-scaled step's seed multiplier)
        read from ``buf``, the packed array on the device; the gradients
        are taken to ``leaves`` (the weights by default)."""
        trainer = self._trainer
        rescale, rows = plan.views(buf)
        ranks = self._mesh is not None and _distributed.backend() is not None
        with autograd.record(train_mode=True, generator=self._generator), \
                aux_update_scope() as aux, tracing(), \
                _mesh.mesh_scope(self._mesh):
            outs = self._block(*args)
            first = _first_leaf(outs)
            seed = first.float().sum()
            if self._dp > 1 and not self._per_row(first):
                seed = seed / self._dp      # a mean over the batch
            if plan.scaled:
                seed = seed * plan.loss_scale(buf)
        grads = torch.autograd.grad(seed, leaves or weights,
                                    allow_unused=True)

        with torch.no_grad():
            if ranks:
                outs = self._gathered(outs)
                for g in grads:
                    if g is not None:
                        torch.distributed.all_reduce(g)
            gs = trainer._rescaled([torch.zeros_like(w) if g is None else g
                                    for w, g in zip(weights, grads)],
                                   rescale)
            del grads
            # one verdict over every rescaled gradient, before clipping
            # (a clip would launder an inf into a finite value)
            finite = all_finite(gs)
        trainer._apply(plan, rows, self._opt_index, weights, gs,
                       cast_back=True, keep=finite)
        write_back_multi([arr for arr, _ in aux.updates],
                         [new for _, new in aux.updates], keep=finite)
        return _detached(outs), finite

    def _per_row(self, t):
        return t.ndim > 0 and t.shape[0] == self._rows

    def _gathered(self, outs):
        """The global batch's outputs from this rank's: one value a row
        gathered by an all-reduce of a zero-padded buffer, a floating
        value of another shape averaged over the ranks."""
        import torch.distributed as dist

        if isinstance(outs, (tuple, list)):
            return tuple(self._gathered(o) for o in outs)
        outs = outs.detach()
        if self._per_row(outs):
            rows = outs.shape[0]
            at = _mesh.row_block(self._mesh, self._data_spec)[0] * rows
            full = outs.new_zeros((rows * self._dp,) + outs.shape[1:])
            full[at:at + rows] = outs
            dist.all_reduce(full)
            return full
        if not outs.is_floating_point():
            return outs
        total = outs.clone()
        dist.all_reduce(total)
        return total / self._dp

    def _eager(self, args, weights, plan):
        buf = capture.upload(plan.host, weights[0].device if weights
                             else "cpu")
        outs, self.last_step_finite = self._body(args, weights, plan, buf)
        return outs

    def _guard(self, inject):
        """With a scaler, or after an injected ``nan_grad`` (``inject``):
        read the step's verdict (the one sync), count a skipped step and,
        with a scaler, move the scale."""
        if self._scaler is None and inject != "nan_grad":
            return
        ok = bool(self.last_step_finite)
        if not ok:
            self._trainer.skipped_steps += 1
            _step_skip_counter().inc()
            _faultline.recovered("train.grads", "nan_grad")
        if self._scaler is not None:
            self._scaler.update_scale(not ok)

    # -- capture and replay --------------------------------------------------
    def _generations(self):
        return (tuple(p.generation for p in self._plist),
                id(self._trainer._states))

    def _generator_for(self, entry):
        gen = self._generator or current_generator()
        if entry.kinds and gen is None:
            raise ValueError("this step draws dropout seeds in train mode "
                             "and needs a torch.Generator: pass "
                             "generator= or run under autograd.record("
                             "generator=...)")
        return gen

    def _capture(self, args, weights, plan, kinds):
        """Capture the step of this signature; returns the entry and the
        seed words the capture drew (this call's)."""
        device = weights[0].device
        for a in args:
            if isinstance(a, torch.Tensor) and a.device != device:
                raise ValueError(
                    f"FusedTrainStep captures its step on {device}: every "
                    f"tensor input must lie there; got one on {a.device}")
        static = tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                       else a for a in args)
        n_seed = 2 * len(kinds)
        buf = torch.zeros(n_seed + plan.host.size, dtype=torch.int32,
                          device=device)
        table = SeedTable(buffer=buf[:n_seed].view(len(kinds), 2))
        scalars = buf[n_seed:].view(torch.float32)
        graph = capture.Graph(device)

        trainable = [self._plist[k] for k in self._train_idx]

        def body():
            with _seed_table(table), _fresh_leaves(trainable) as leaves:
                return self._body(static, weights, plan, scalars, leaves)

        outs, finite = graph.capture(body)
        if tuple(table.kinds) != kinds:
            raise RuntimeError(
                f"the captured step drew {list(table.kinds)}, its first "
                f"run {list(kinds)}: a step must reach the same draw "
                "sites every time")
        self.captures += 1
        return (_Captured(graph, static, buf, outs, finite, kinds,
                          self._generations()), table.words)

    def _replay(self, entry, args, plan, words):
        n_seed = 2 * len(entry.kinds)
        host = onp.empty(entry.buf.numel(), dtype=onp.int32)
        host[:n_seed] = onp.asarray(words, dtype=onp.uint32).reshape(
            -1).view(onp.int32)
        host[n_seed:] = plan.host.view(onp.int32)
        entry.ring.upload(host, entry.buf)
        for static, a in zip(entry.args, args):
            if isinstance(static, torch.Tensor):
                static.copy_(a, non_blocking=True)
        # the eager backward clears a 'write' parameter's stored gradient
        for k in self._train_idx:
            if self._plist[k].grad_req == "write":
                self._plist[k].data().grad = None
        entry.graph.replay()
        self.last_step_finite = entry.finite.clone()
        return _detached(entry.outs, copy=True)
