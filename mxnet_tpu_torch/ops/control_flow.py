"""Control-flow ops: foreach / while_loop / cond (counterpart of
`mxnet_tpu/ops/control_flow.py`).

The reference has two contracts, and the port keeps both:

* **Eager**: a Python loop over the body, which torch's autograd
  records like any other ops; ``while_loop`` returns exactly the steps
  it ran and ``cond`` runs one branch, each reading its predicate on the
  host.
* **Traced** (inside `ops.invoke.tracing`: a hybridized block, every
  call of `gluon.FusedTrainStep`, a serving cache's function): the
  reference lowers to ``lax.scan`` / ``lax.cond``, whose shapes are
  static.  ``while_loop`` needs ``max_iterations``, runs that many
  steps, keeps a step's new loop variables only while the loop is
  active and zero-pads the outputs of the steps after it ended;
  ``cond`` runs both branches and selects between them.  Nothing reads
  a predicate on the host: the selection is ``torch.where`` on the
  device, so a CUDA graph captures the loop whatever the data.

``foreach`` has the same result under both contracts: a Python loop
over axis 0, its outputs stacked.  Loop variables, outputs and branch
results may be tensors or (nested) lists and tuples of them.
"""
from __future__ import annotations

import torch

from .invoke import is_tracing

__all__ = ["foreach", "while_loop", "cond"]


def _map(fn, *trees):
    """``fn`` over the tensor leaves of same-structured ``trees``."""
    first = trees[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _stack(outputs):
    """Per-step outputs (same structure) stacked along a new axis 0."""
    return _map(lambda *outs: torch.stack(list(outs), dim=0), *outputs)


def _as_list(loop_vars):
    return list(loop_vars) if isinstance(loop_vars, (list, tuple)) \
        else [loop_vars]


def _pred_tensor(pred, like):
    """The predicate as a bool tensor of one element on ``like``'s
    device, without a host read."""
    return torch.as_tensor(pred, device=like.device).to(torch.bool) \
        .reshape(())


def _first_tensor(tree):
    if isinstance(tree, (list, tuple)):
        for part in tree:
            t = _first_tensor(part)
            if t is not None:
                return t
        return None
    return tree if isinstance(tree, torch.Tensor) else None


def foreach(body, data, init_states):
    """``body(data_slice, states) -> (output, new_states)`` mapped over
    axis 0 of ``data`` (a tensor or a list of them); returns (stacked
    outputs, final states)."""
    states = init_states
    outputs = []
    n = (data[0] if isinstance(data, (list, tuple)) else data).shape[0]
    for i in range(n):
        sl = _map(lambda d: d[i], data) \
            if isinstance(data, (list, tuple)) else data[i]
        out, states = body(sl, states)
        outputs.append(out)
    return _stack(outputs), states


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """``while cond_fn(*loop_vars): out, loop_vars = func(*loop_vars)``.
    Returns (stacked step outputs, final loop_vars).  Eagerly the
    outputs are exactly the executed steps (None for none), at most
    ``max_iterations``; traced they are ``max_iterations`` steps, those
    after the loop ended zeros."""
    loop_vars = _as_list(loop_vars)
    if not is_tracing():
        outputs = []
        while bool(cond_fn(*loop_vars)):
            out, loop_vars = func(*loop_vars)
            loop_vars = _as_list(loop_vars)
            outputs.append(out)
            if max_iterations is not None and \
                    len(outputs) >= max_iterations:
                break
        return (_stack(outputs) if outputs else None), loop_vars
    if max_iterations is None:
        raise ValueError(
            "while_loop requires max_iterations inside a trace (a "
            "hybridized block, FusedTrainStep, a serving cache): its "
            "outputs have a static shape, as in the reference's symbolic "
            "while_loop")
    like = _first_tensor(loop_vars)
    done = torch.zeros((), dtype=torch.bool, device=like.device)
    outputs = []
    for _ in range(int(max_iterations)):
        pred = _pred_tensor(cond_fn(*loop_vars), like)
        active = ~done & pred
        out, new_vars = func(*loop_vars)
        new_vars = _as_list(new_vars)
        outputs.append(_map(lambda o: torch.where(active, o,
                                                  torch.zeros_like(o)), out))
        loop_vars = [_map(lambda n, v: torch.where(active, n, v), nv, v)
                     for nv, v in zip(new_vars, loop_vars)]
        done = done | ~pred
    return _stack(outputs), loop_vars


def cond(pred, then_func, else_func, inputs=None):
    """``then_func(*inputs) if pred else else_func(*inputs)``.  Traced,
    both branches run and the result is selected on the device (the two
    must have the same structure and broadcastable shapes)."""
    inputs = list(inputs or [])
    if not is_tracing():
        return then_func(*inputs) if bool(pred) else else_func(*inputs)
    then_out, else_out = then_func(*inputs), else_func(*inputs)
    like = _first_tensor([pred, then_out])
    p = _pred_tensor(pred, like)
    return _map(lambda a, b: torch.where(p, a, b), then_out, else_out)
