"""Dynamic loss scaling (counterpart of `mxnet_tpu/amp/loss_scaler.py`).

Needed for float16 only: bf16 keeps f32's exponent range, so a scaler
that is not dynamic holds its scale at 1.  A dynamic one starts at
``init_scale``, halves (by ``scale_factor``) after a step whose
gradients overflowed, never below 1, and doubles after
``scale_window`` clean steps in a row.

`has_overflow` takes one verdict over every gradient on the device
(`optimizer.all_finite`) and reads it once: one host sync a step, not
one a parameter.
"""
from __future__ import annotations

from ..optimizer.optimizer import all_finite

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, dynamic=True, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale if dynamic else 1.0
        self._dynamic = dynamic
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """Whether any gradient of ``params`` (Parameters) holds an inf or
        a NaN."""
        if not self._dynamic:
            return False
        grads = [g for p in params for g in p.list_grad()]
        return bool(grads) and not bool(all_finite(grads))

    def update_scale(self, overflow):
        if not self._dynamic:
            return
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
