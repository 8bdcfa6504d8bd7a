"""SGD (counterpart of `SGD` in `mxnet_tpu/optimizer/sgd.py`; the
reference kernels `sgd_update` / `sgd_mom_update`)::

    mom = momentum * mom - lr * (grad + wd * weight)
    weight += mom

in f32, the new weight cast back to the weight's dtype.  The momentum
is an f32 buffer whatever the weight's dtype: the reference creates it
as zeros of the weight's dtype, but its fused step keeps the f32 buffer
that ``update_math`` returns from the first step on, so f32 zeros give
the same trajectory without rounding the momentum to bf16 in between.
NAG, Signum, SGLD, LARS and DCASGD are not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, register

__all__ = ["SGD"]


@register
class SGD(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (torch.zeros_like(weight, dtype=torch.float32),)

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        if self.momentum == 0.0:
            new_w = w32 - lr * (grad + wd * w32)
            return new_w.to(weight.dtype), ()
        (mom,) = states
        new_mom = self.momentum * mom - lr * (grad + wd * w32)
        new_w = w32 + new_mom
        return new_w.to(weight.dtype), (new_mom,)

    def update_multi(self, weights, grads, states, scalars):
        lr, wd = scalars["lr"], scalars["wd"]
        step = torch._foreach_mul(
            torch._foreach_add(grads, torch._foreach_mul(weights, wd)), lr)
        if self.momentum == 0.0:
            return torch._foreach_sub(weights, step), [() for _ in weights]
        new_mom = torch._foreach_sub(
            torch._foreach_mul([st[0] for st in states], self.momentum), step)
        return (torch._foreach_add(weights, new_mom),
                [(m,) for m in new_mom])
