"""The SGD family (counterpart of `mxnet_tpu/optimizer/sgd.py`): SGD,
NAG, Signum, SGLD, LARS and DCASGD.  SGD is the reference kernels'
`sgd_update` / `sgd_mom_update`::

    mom = momentum * mom - lr * (grad + wd * weight)
    weight += mom

in f32, the new weight cast back to the weight's dtype.  The momentum
is an f32 buffer whatever the weight's dtype: the reference creates it
as zeros of the weight's dtype, but its fused step keeps the f32 buffer
that ``update_math`` returns from the first step on, so f32 zeros give
the same trajectory without rounding the momentum to bf16 in between.
The others keep f32 states for the same reason.  LARS's per-tensor norms
are one ``torch._foreach_norm`` a list, its trust ratios kept on the
device.  SGLD draws fresh Gaussian noise at every parameter's update, so
it runs parameter by parameter (``supports_fused = False``); the noise
takes a threefry key of two words from an explicit CPU
``torch.Generator`` (its ``generator=``, or the enclosing
``autograd.record`` / ``train_mode`` scope's), never from torch's global
generator, and is what ``jax.random.normal`` draws from that key
(`ops.threefry.normal`, on the weight's device), as the reference's is.
"""
from __future__ import annotations

import torch

from ..ops import threefry
from ..ops.invoke import current_generator
from ..ops.seeds import DRAWS, words_tensor
from .optimizer import Optimizer, register

__all__ = ["SGD", "NAG", "Signum", "SGLD", "LARS", "DCASGD"]


def _f32_zeros(weight):
    return torch.zeros_like(weight, dtype=torch.float32)


def _momenta(states):
    return [st[0] for st in states]


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


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference `nag_mom_update`)::

        mom = momentum * mom + g;  weight -= lr * (g + momentum * mom)

    with ``g = grad + wd * weight``."""

    def __init__(self, learning_rate=0.1, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else (_f32_zeros(weight),)

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        g = grad + wd * w32
        if self.momentum == 0.0:
            return (w32 - lr * g).to(weight.dtype), ()
        (mom,) = states
        new_mom = self.momentum * mom + g
        new_w = w32 - lr * (g + self.momentum * new_mom)
        return new_w.to(weight.dtype), (new_mom,)

    def update_multi(self, weights, grads, states, scalars):
        lr, wd = scalars["lr"], scalars["wd"]
        g = torch._foreach_add(grads, torch._foreach_mul(weights, wd))
        if self.momentum == 0.0:
            return (torch._foreach_sub(weights, torch._foreach_mul(g, lr)),
                    [() for _ in weights])
        new_mom = torch._foreach_add(
            torch._foreach_mul(_momenta(states), self.momentum), g)
        step = torch._foreach_mul(torch._foreach_add(
            g, torch._foreach_mul(new_mom, self.momentum)), lr)
        return (torch._foreach_sub(weights, step), [(m,) for m in new_mom])


@register
class Signum(Optimizer):
    """signSGD and Signum (reference `signsgd_update` /
    `signum_update`): the sign of the gradient, or of its momentum, with
    ``wd_lh`` decoupled weight decay."""

    scalar_names = ("lr", "wd", "decay")

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else (_f32_zeros(weight),)

    def step_scalars(self, lr, wd, t):
        return (lr, wd, 1 - lr * self.wd_lh)

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        decay = 1 - lr * self.wd_lh
        if self.momentum == 0.0:
            new_w = decay * w32 - lr * torch.sign(grad + wd * w32)
            return new_w.to(weight.dtype), ()
        (mom,) = states
        new_mom = self.momentum * mom - (1 - self.momentum) * (grad + wd * w32)
        new_w = decay * w32 + lr * torch.sign(new_mom)
        return new_w.to(weight.dtype), (new_mom,)

    def update_multi(self, weights, grads, states, scalars):
        lr = scalars["lr"]
        g = torch._foreach_add(grads,
                               torch._foreach_mul(weights, scalars["wd"]))
        kept = torch._foreach_mul(weights, scalars["decay"])
        if self.momentum == 0.0:
            return (torch._foreach_sub(kept, torch._foreach_mul(
                torch._foreach_sign(g), lr)), [() for _ in weights])
        new_mom = torch._foreach_sub(
            torch._foreach_mul(_momenta(states), self.momentum),
            torch._foreach_mul(g, 1 - self.momentum))
        return (torch._foreach_add(kept, torch._foreach_mul(
            torch._foreach_sign(new_mom), lr)), [(m,) for m in new_mom])


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference `sgld.py`)::

        weight += -lr / 2 * (grad + wd * weight) + N(0, lr)

    The noise is ``jax.random.normal`` of a key whose two words come
    from ``generator`` (a CPU ``torch.Generator``), or from the enclosing
    train scope's."""

    supports_fused = False

    def __init__(self, learning_rate=0.01, generator=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.generator = generator

    def _noise(self, weight):
        gen = self.generator or current_generator()
        if gen is None:
            raise ValueError(
                "SGLD draws its noise from a torch.Generator: pass "
                "generator= or step under autograd.train_mode("
                "generator=...)")
        key = threefry.key_of(words_tensor(DRAWS["normal"](gen),
                                           weight.device))
        return threefry.normal(key, weight.numel()).reshape(weight.shape)

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        noise = self._noise(weight) * torch.sqrt(
            torch.tensor(lr, dtype=torch.float32, device=weight.device))
        new_w = w32 - lr / 2 * (grad + wd * w32) + noise
        return new_w.to(weight.dtype), ()


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (reference `lars.py`): each
    tensor's lr times ``eta * |w| / (|g| + wd |w| + epsilon)``."""

    def __init__(self, learning_rate=0.1, momentum=0.0, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else (_f32_zeros(weight),)

    def _trust(self, w_norm, g_norm, wd):
        return torch.where((w_norm > 0) & (g_norm > 0),
                           self.eta * w_norm /
                           (g_norm + wd * w_norm + self.epsilon),
                           torch.ones_like(w_norm))

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        trust = self._trust(torch.linalg.vector_norm(w32),
                            torch.linalg.vector_norm(grad), wd)
        scaled_lr = lr * trust
        g = grad + wd * w32
        if self.momentum == 0.0:
            return (w32 - scaled_lr * g).to(weight.dtype), ()
        (mom,) = states
        new_mom = self.momentum * mom + scaled_lr * g
        return (w32 - new_mom).to(weight.dtype), (new_mom,)

    def update_multi(self, weights, grads, states, scalars):
        lr, wd = scalars["lr"], scalars["wd"]
        w_norm = torch.stack(torch._foreach_norm(weights))
        g_norm = torch.stack(torch._foreach_norm(grads))
        # the trust ratios stay on the device: no sync
        scaled = (lr * self._trust(w_norm, g_norm, wd)).unbind()
        g = torch._foreach_add(grads, torch._foreach_mul(weights, wd))
        step = [x * s for x, s in zip(g, scaled)]
        if self.momentum == 0.0:
            return torch._foreach_sub(weights, step), [() for _ in weights]
        new_mom = torch._foreach_add(
            torch._foreach_mul(_momenta(states), self.momentum), step)
        return (torch._foreach_sub(weights, new_mom),
                [(m,) for m in new_mom])


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference `dcasgd.py`): the
    gradient corrected by ``lamda * g * g * (weight - previous weight)``;
    the states are the momentum and the previous weight, in f32."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (_f32_zeros(weight), weight.detach().float().clone())

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        mom, prev_w = states
        g = grad + wd * w32
        comp = g + self.lamda * g * g * (w32 - prev_w)
        new_mom = self.momentum * mom - lr * comp
        new_w = w32 + new_mom
        return new_w.to(weight.dtype), (new_mom, new_w)

    def update_multi(self, weights, grads, states, scalars):
        g = torch._foreach_add(grads,
                               torch._foreach_mul(weights, scalars["wd"]))
        drift = torch._foreach_sub(weights, [st[1] for st in states])
        comp = torch._foreach_add(g, torch._foreach_mul(torch._foreach_mul(
            torch._foreach_mul(g, self.lamda), g), drift))
        new_mom = torch._foreach_sub(
            torch._foreach_mul(_momenta(states), self.momentum),
            torch._foreach_mul(comp, scalars["lr"]))
        new_w = torch._foreach_add(weights, new_mom)
        return new_w, list(zip(new_mom, new_w))
