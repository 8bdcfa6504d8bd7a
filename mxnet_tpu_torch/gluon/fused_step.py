"""One training step: forward, gradients and the optimizer update
(counterpart of `mxnet_tpu/gluon/fused_step.py`), single device.

``FusedTrainStep(block, trainer)(*inputs, batch_size=B)`` does what
``with autograd.record(): loss = block(*inputs)``, ``loss.backward()``
and ``trainer.step(B)`` do, in the order and at the rounding points of
the reference's one-program step:

- the forward runs recorded and in train mode; the backward seed is the
  f32 sum of the block's first output leaf;
- the gradients of the trainable parameters (those the trainer owns,
  ``grad_req`` not ``'null'``) are taken with `torch.autograd.grad`,
  so the parameters' stored gradients are not accumulated into (a
  ``'write'`` parameter's is cleared);
- each gradient is rescaled in f32; one finite-gradient verdict is
  taken over all of them before clipping; each is clipped and cast
  back to its weight's dtype before ``update_math`` widens it again;
- a step whose verdict is False leaves every weight and optimizer state
  bitwise as it was.  The verdict stays on the device as
  ``last_step_finite`` (reading it as a bool syncs);
- auxiliary state that the forward updates (BatchNorm running
  statistics) is collected in an `ops.aux_scope` around the forward and
  committed after the update under the same verdict, so a skipped step
  leaves it bitwise too.

Deferred parameter shapes are settled before the first step by one
forward in predict mode (`Block._ensure_shapes`).

The reference compiles all of it into one XLA program; here it runs
eagerly (capturing it as a CUDA graph is later work).  Train-mode
randomness draws from ``generator`` (a CPU ``torch.Generator``), or
from an enclosing ``autograd.record``/``train_mode`` scope's.  SPMD
(``mesh``, ``recipe``, ``partition_rules``, ``data_spec``) and loss
scaling (``scaler``) are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..ops.aux_scope import aux_update_scope
from ..optimizer.optimizer import Optimizer, write_back

__all__ = ["FusedTrainStep"]


def _first_leaf(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


class FusedTrainStep:
    """Fuse ``loss = block(*inputs); loss.backward(); trainer.step(bs)``
    into one call.  ``block`` must produce the loss (its first output
    leaf is summed as the backward seed) and the trainer's optimizer
    must implement ``update_math``.

    >>> step = FusedTrainStep(mod, trainer, generator=torch.Generator())
    >>> loss = step(x, y, batch_size=128)
    """

    def __init__(self, block, trainer, mesh=None, partition_rules=None,
                 data_spec=None, scaler=None, recipe=None, generator=None):
        if mesh is not None or recipe is not None or \
                partition_rules is not None or data_spec is not None:
            raise NotImplementedError(
                "FusedTrainStep is single-device in the port: SPMD meshes "
                "and recipes are ROADMAP queue A (distribution)")
        if scaler is not None:
            raise NotImplementedError(
                "loss scaling (amp) is not ported yet (ROADMAP queue A)")
        self._block = block
        self._trainer = trainer
        self._generator = generator
        self.last_step_finite = None
        self._plist = None
        self._train_idx = None
        self._opt_index = None

    def _setup(self, args):
        trainer = self._trainer
        opt = trainer._optimizer
        if type(opt).update_math is Optimizer.update_math:
            raise ValueError(f"{type(opt).__name__} has no update_math; "
                             "use the eager record/backward/step path")
        self._block._ensure_shapes(*args)
        trainer._init_kvstore()
        trainer._init_states()
        params = self._block.collect_params()
        self._plist = [params[k] for k in sorted(params)]
        # trainable = has a gradient AND is managed by this trainer
        by_id = {id(p): i for i, p in enumerate(trainer._params)}
        self._train_idx = tuple(
            k for k, p in enumerate(self._plist)
            if p.grad_req != "null" and id(p) in by_id)
        self._opt_index = tuple(by_id[id(self._plist[k])]
                                for k in self._train_idx)

    def __call__(self, *args, batch_size=1):
        return self.step(*args, batch_size=batch_size)

    def step(self, *args, batch_size=1):
        if self._plist is None:
            self._setup(args)
        trainer = self._trainer
        trainer._optimizer.rescale_grad = trainer._scale / batch_size
        weights = [self._plist[k].data() for k in self._train_idx]

        with autograd.record(train_mode=True, generator=self._generator), \
                aux_update_scope() as aux:
            outs = self._block(*args)
            seed = _first_leaf(outs).float().sum()
        grads = torch.autograd.grad(seed, weights, allow_unused=True)

        with torch.no_grad():
            gs = list(trainer._rescaled(
                torch.zeros_like(w) if g is None else g
                for w, g in zip(weights, grads)))
            del grads
            # one verdict over every rescaled gradient, before clipping
            # (a clip would launder an inf into a finite value)
            finite = torch.stack([torch.isfinite(g).all() for g in gs]).all()
        trainer._apply(self._opt_index, weights, gs, cast_back=True,
                       keep=finite)
        for arr, new in aux.updates:
            write_back(arr, new, (), (), keep=finite)
        self.last_step_finite = finite
        if isinstance(outs, torch.Tensor):
            return outs.detach()
        return tuple(o.detach() for o in outs)
