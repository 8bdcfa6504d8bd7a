"""Deferred auxiliary-state updates (counterpart of
`mxnet_tpu/ops/aux_scope.py`).

BatchNorm's running statistics change in its train-mode forward.
`apply_aux_update` writes a new value into the state's tensor at once,
in place, outside autograd: that is the eager ``record`` / ``backward``
path, where the reference rebinds the array.  Inside an open
`aux_update_scope` it records ``(tensor, new value)`` instead, and the
scope's owner commits the updates later: `gluon.FusedTrainStep` does so
under the step's finite-gradient verdict, so a skipped step leaves the
running statistics bitwise as they were.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["aux_update_scope", "apply_aux_update"]


class _ScopeState(threading.local):
    def __init__(self):
        self.stack = []


_state = _ScopeState()


class aux_update_scope:  # noqa: N801 - the reference's name
    def __init__(self):
        self.updates = []  # list[(tensor, new value)]

    def __enter__(self):
        _state.stack.append(self)
        return self

    def __exit__(self, *_exc):
        _state.stack.pop()


def apply_aux_update(arr, new_value):
    """Write ``new_value`` into ``arr`` now, or defer it to the innermost
    open scope."""
    if _state.stack:
        _state.stack[-1].updates.append((arr, new_value))
    else:
        with torch.no_grad():
            arr.copy_(new_value)
