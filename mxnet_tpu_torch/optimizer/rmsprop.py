"""RMSProp, AdaGrad, AdaDelta, Ftrl and FTML (counterpart of
`mxnet_tpu/optimizer/rmsprop.py`; the reference kernels
`rmsprop(alex)_update`, `adagrad_update`, `ftrl_update`,
`ftml_update`).

Each keeps the reference's f32 math and f32 states, with
``update_math`` for one parameter and ``update_multi`` over lists
(``torch._foreach_*``), which agree bitwise on the CPU.  Host values
that depend on the step (FTML's bias corrections) are computed once on
the host, by ``step_scalars``, and reach the multi-tensor form among the
step's packed scalars.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, register

__all__ = ["RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "FTML"]


def _f32_zeros(weight):
    return torch.zeros_like(weight, dtype=torch.float32)


def _decayed(grads, weights, wd):
    """``grad + wd * weight`` over lists."""
    return torch._foreach_add(grads, torch._foreach_mul(weights, wd))


def _average(rho, olds, news):
    """``(1 - rho) * new + rho * old`` over lists, in that order."""
    return torch._foreach_add(torch._foreach_mul(news, 1 - rho),
                              torch._foreach_mul(olds, rho))


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.momentum = momentum
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return tuple(_f32_zeros(weight) for _ in range(
            3 if self.centered else 1))

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        g = grad + wd * w32
        if not self.centered:
            (n,) = states
            new_n = (1 - self.rho) * torch.square(g) + self.rho * n
            new_w = w32 - lr * g / (torch.sqrt(new_n) + self.epsilon)
            new_states = (new_n,)
        else:
            n, mg, delta = states
            new_n = (1 - self.rho) * torch.square(g) + self.rho * n
            new_mg = (1 - self.rho) * g + self.rho * mg
            new_delta = self.momentum * delta - lr * g / torch.sqrt(
                new_n - torch.square(new_mg) + self.epsilon)
            new_w = w32 + new_delta
            new_states = (new_n, new_mg, new_delta)
        if self.clip_weights:
            new_w = torch.clamp(new_w, -self.clip_weights, self.clip_weights)
        return new_w.to(weight.dtype), new_states

    def update_multi(self, weights, grads, states, scalars):
        lr = scalars["lr"]
        g = _decayed(grads, weights, scalars["wd"])
        new_n = _average(self.rho, [st[0] for st in states],
                         torch._foreach_mul(g, g))
        lr_g = torch._foreach_mul(g, lr)
        if not self.centered:
            new_w = torch._foreach_sub(weights, torch._foreach_div(
                lr_g, torch._foreach_add(torch._foreach_sqrt(new_n),
                                         self.epsilon)))
            new_states = [(n,) for n in new_n]
        else:
            new_mg = _average(self.rho, [st[1] for st in states], g)
            spread = torch._foreach_add(torch._foreach_sub(
                new_n, torch._foreach_mul(new_mg, new_mg)), self.epsilon)
            new_delta = torch._foreach_sub(
                torch._foreach_mul([st[2] for st in states], self.momentum),
                torch._foreach_div(lr_g, torch._foreach_sqrt(spread)))
            new_w = torch._foreach_add(weights, new_delta)
            new_states = list(zip(new_n, new_mg, new_delta))
        if self.clip_weights:
            new_w = torch._foreach_clamp_max(torch._foreach_clamp_min(
                new_w, -self.clip_weights), self.clip_weights)
        return new_w, new_states


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_f32_zeros(weight),)

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        (history,) = states
        g = grad + wd * w32
        new_hist = history + torch.square(g)
        new_w = w32 - lr * g / (torch.sqrt(new_hist) + self.epsilon)
        return new_w.to(weight.dtype), (new_hist,)

    def update_multi(self, weights, grads, states, scalars):
        g = _decayed(grads, weights, scalars["wd"])
        new_hist = torch._foreach_add([st[0] for st in states],
                                      torch._foreach_mul(g, g))
        step = torch._foreach_div(
            torch._foreach_mul(g, scalars["lr"]),
            torch._foreach_add(torch._foreach_sqrt(new_hist), self.epsilon))
        return torch._foreach_sub(weights, step), [(h,) for h in new_hist]


@register
class AdaDelta(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_f32_zeros(weight), _f32_zeros(weight))

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        acc_g, acc_delta = states
        g = grad + wd * w32
        new_acc_g = self.rho * acc_g + (1 - self.rho) * torch.square(g)
        delta = torch.sqrt(acc_delta + self.epsilon) / \
            torch.sqrt(new_acc_g + self.epsilon) * g
        new_acc_delta = self.rho * acc_delta + \
            (1 - self.rho) * torch.square(delta)
        new_w = w32 - lr * delta
        return new_w.to(weight.dtype), (new_acc_g, new_acc_delta)

    def update_multi(self, weights, grads, states, scalars):
        g = _decayed(grads, weights, scalars["wd"])
        acc_g = [st[0] for st in states]
        acc_delta = [st[1] for st in states]
        new_acc_g = torch._foreach_add(
            torch._foreach_mul(acc_g, self.rho),
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.rho))
        delta = torch._foreach_mul(torch._foreach_div(
            torch._foreach_sqrt(torch._foreach_add(acc_delta, self.epsilon)),
            torch._foreach_sqrt(torch._foreach_add(new_acc_g, self.epsilon))),
            g)
        new_acc_delta = torch._foreach_add(
            torch._foreach_mul(acc_delta, self.rho),
            torch._foreach_mul(torch._foreach_mul(delta, delta),
                               1 - self.rho))
        return (torch._foreach_sub(weights,
                                   torch._foreach_mul(delta, scalars["lr"])),
                list(zip(new_acc_g, new_acc_delta)))


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (reference `ftrl_update`); ``wd``
    enters the denominator, not the gradient."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_f32_zeros(weight), _f32_zeros(weight))

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        z, n = states
        new_n = n + torch.square(grad)
        sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
        new_z = z + grad - sigma * w32
        new_w = torch.where(
            torch.abs(new_z) > self.lamda1,
            -(new_z - torch.sign(new_z) * self.lamda1) /
            ((self.beta + torch.sqrt(new_n)) / lr + wd),
            torch.zeros_like(new_z))
        return new_w.to(weight.dtype), (new_z, new_n)

    def update_multi(self, weights, grads, states, scalars):
        lr = scalars["lr"]
        z = [st[0] for st in states]
        n = [st[1] for st in states]
        new_n = torch._foreach_add(n, torch._foreach_mul(grads, grads))
        root = torch._foreach_sqrt(new_n)
        sigma = torch._foreach_div(
            torch._foreach_sub(root, torch._foreach_sqrt(n)), lr)
        new_z = torch._foreach_sub(torch._foreach_add(z, grads),
                                   torch._foreach_mul(sigma, weights))
        shrunk = torch._foreach_neg(torch._foreach_sub(
            new_z, torch._foreach_mul(torch._foreach_sign(new_z),
                                      self.lamda1)))
        denom = torch._foreach_add(torch._foreach_div(
            torch._foreach_add(root, self.beta), lr), scalars["wd"])
        new_w = [torch.where(torch.abs(nz) > self.lamda1, s / d,
                             torch.zeros_like(nz))
                 for nz, s, d in zip(new_z, shrunk, denom)]
        return new_w, list(zip(new_z, new_n))


@register
class FTML(Optimizer):
    """Follow the moving leader (reference `ftml_update`)::

        v = beta2 v + (1 - beta2) g^2
        d = (1 - beta1^t) / lr * (sqrt(v / (1 - beta2^t)) + epsilon)
        z = beta1 z + (1 - beta1) g - (d - beta1 d_prev) weight
        weight = -z / d
    """

    scalar_names = ("wd", "k", "c2")

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        # d_prev, v, z
        return (_f32_zeros(weight), _f32_zeros(weight), _f32_zeros(weight))

    def step_scalars(self, lr, wd, t):
        """``wd``, ``(1 - beta1^t) / lr`` and ``1 - beta2^t``."""
        return (wd, (1 - self.beta1 ** t) / lr, 1 - self.beta2 ** t)

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        d_prev, v, z = states
        _wd, k, c2 = self.step_scalars(lr, wd, t)
        g = grad + wd * w32
        new_v = self.beta2 * v + (1 - self.beta2) * torch.square(g)
        d = k * (torch.sqrt(new_v / c2) + self.epsilon)
        sigma = d - self.beta1 * d_prev
        new_z = self.beta1 * z + (1 - self.beta1) * g - sigma * w32
        new_w = -new_z / d
        return new_w.to(weight.dtype), (d, new_v, new_z)

    def update_multi(self, weights, grads, states, scalars):
        g = _decayed(grads, weights, scalars["wd"])
        d_prev = [st[0] for st in states]
        new_v = torch._foreach_add(
            torch._foreach_mul([st[1] for st in states], self.beta2),
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.beta2))
        d = torch._foreach_mul(torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(new_v, scalars["c2"])), self.epsilon),
            scalars["k"])
        sigma = torch._foreach_sub(d, torch._foreach_mul(d_prev, self.beta1))
        new_z = torch._foreach_sub(torch._foreach_add(
            torch._foreach_mul([st[2] for st in states], self.beta1),
            torch._foreach_mul(g, 1 - self.beta1)),
            torch._foreach_mul(sigma, weights))
        new_w = torch._foreach_div(torch._foreach_neg(new_z), d)
        return new_w, list(zip(d, new_v, new_z))
