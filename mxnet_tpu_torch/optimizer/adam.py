"""Adam-family optimizers (counterpart of `mxnet_tpu/optimizer/adam.py`):
Adam, AdamW, Adamax, Nadam, LAMB and LANS.

Each keeps the reference's f32 math: the weight is widened to an f32
copy, the states are f32, and the new weight is cast back to the
weight's dtype.  ``t`` may be an int (the optimizer's own `update`) or
an f32 scalar (the Trainer and `FusedTrainStep` pass it as the
reference's fused programs do); the bias corrections are computed from
it on the host, and in the multi-tensor form (`update_multi`) reach the
device among the step's packed scalars.  Nadam keeps a momentum schedule
on the host that every parameter's update advances, so it runs parameter
by parameter (``supports_fused = False``).  LAMB's and LANS's per-tensor
norms are one ``torch._foreach_norm`` a list, and their trust ratios
stay on the device.
"""
from __future__ import annotations

import numpy as onp
import torch

from .optimizer import Optimizer, register

__all__ = ["Adam", "AdamW", "Adamax", "Nadam", "LAMB", "LANS"]


def _f32_zeros(weight):
    return torch.zeros_like(weight, dtype=torch.float32)


def _bias_corrections(beta1, beta2, t):
    """``(1 - beta1^t, 1 - beta2^t)`` as the host computes them."""
    return float(1 - beta1 ** t), float(1 - beta2 ** t)


def _norms(tensors):
    """The L2 norm of each tensor, stacked into one f32 vector."""
    return torch.stack(torch._foreach_norm(tensors))


def _ratio(r1, r2):
    """The trust ratio ``r1 / r2`` where both are positive, else 1."""
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))


def _moments(opt, grads, states):
    """``beta1 m + (1 - beta1) g`` and ``beta2 v + (1 - beta2) g^2`` over
    lists."""
    new_mean = torch._foreach_add(
        torch._foreach_mul([st[0] for st in states], opt.beta1),
        torch._foreach_mul(grads, 1 - opt.beta1))
    new_var = torch._foreach_add(
        torch._foreach_mul([st[1] for st in states], opt.beta2),
        torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - opt.beta2))
    return new_mean, new_var


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.correct_bias = correct_bias

    def create_state(self, index, weight):
        return (_f32_zeros(weight), _f32_zeros(weight))

    def _lr(self, lr, t):
        if self.correct_bias:
            # the bias correction folds into lr
            coef1 = 1.0 - self.beta1 ** t
            coef2 = 1.0 - self.beta2 ** t
            lr = float(lr * onp.sqrt(coef2) / coef1)
        return lr

    def step_scalars(self, lr, wd, t):
        return (self._lr(lr, t), wd)

    def update_multi(self, weights, grads, states, scalars):
        g = torch._foreach_add(grads,
                               torch._foreach_mul(weights, scalars["wd"]))
        new_mean, new_var = _moments(self, g, states)
        denom = torch._foreach_add(torch._foreach_sqrt(new_var),
                                   self.epsilon)
        step = torch._foreach_div(
            torch._foreach_mul(new_mean, scalars["lr"]), denom)
        return (torch._foreach_sub(weights, step),
                list(zip(new_mean, new_var)))

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        mean, var = states
        lr = self._lr(lr, t)
        g = grad + wd * w32
        new_mean = self.beta1 * mean + (1 - self.beta1) * g
        new_var = self.beta2 * var + (1 - self.beta2) * torch.square(g)
        new_w = w32 - lr * new_mean / (torch.sqrt(new_var) + self.epsilon)
        return new_w.to(weight.dtype), (new_mean, new_var)


@register
class AdamW(Optimizer):
    """Decoupled weight decay (reference contrib adamw_update)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.correct_bias = correct_bias

    def create_state(self, index, weight):
        return (_f32_zeros(weight), _f32_zeros(weight))

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        mean, var = states
        new_mean = self.beta1 * mean + (1 - self.beta1) * grad
        new_var = self.beta2 * var + (1 - self.beta2) * torch.square(grad)
        m_hat, v_hat = new_mean, new_var
        if self.correct_bias:
            c1, c2 = _bias_corrections(self.beta1, self.beta2, t)
            m_hat = new_mean / c1
            v_hat = new_var / c2
        new_w = w32 - lr * (m_hat / (torch.sqrt(v_hat) + self.epsilon) +
                            wd * w32)
        return new_w.to(weight.dtype), (new_mean, new_var)

    @property
    def scalar_names(self):
        return ("lr", "wd", "c1", "c2") if self.correct_bias else ("lr", "wd")

    def step_scalars(self, lr, wd, t):
        if self.correct_bias:
            return (lr, wd, *_bias_corrections(self.beta1, self.beta2, t))
        return (lr, wd)

    def update_multi(self, weights, grads, states, scalars):
        new_mean, new_var = _moments(self, grads, states)
        m_hat, v_hat = new_mean, new_var
        if self.correct_bias:
            m_hat = torch._foreach_div(new_mean, scalars["c1"])
            v_hat = torch._foreach_div(new_var, scalars["c2"])
        u = torch._foreach_add(
            torch._foreach_div(m_hat, torch._foreach_add(
                torch._foreach_sqrt(v_hat), self.epsilon)),
            torch._foreach_mul(weights, scalars["wd"]))
        return (torch._foreach_sub(weights,
                                   torch._foreach_mul(u, scalars["lr"])),
                list(zip(new_mean, new_var)))


@register
class Adamax(Optimizer):
    """Adam with the infinity norm (reference `adamax_update`)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_f32_zeros(weight), _f32_zeros(weight))

    def step_scalars(self, lr, wd, t):
        return (lr / (1 - self.beta1 ** t), wd)

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        mean, inf_norm = states
        lr, wd = self.step_scalars(lr, wd, t)
        g = grad + wd * w32
        new_mean = self.beta1 * mean + (1 - self.beta1) * g
        new_inf = torch.maximum(self.beta2 * inf_norm, torch.abs(g))
        new_w = w32 - lr * new_mean / (new_inf + 1e-8)
        return new_w.to(weight.dtype), (new_mean, new_inf)

    def update_multi(self, weights, grads, states, scalars):
        g = torch._foreach_add(grads,
                               torch._foreach_mul(weights, scalars["wd"]))
        new_mean = torch._foreach_add(
            torch._foreach_mul([st[0] for st in states], self.beta1),
            torch._foreach_mul(g, 1 - self.beta1))
        new_inf = torch._foreach_maximum(
            torch._foreach_mul([st[1] for st in states], self.beta2),
            torch._foreach_abs(g))
        step = torch._foreach_div(torch._foreach_mul(new_mean, scalars["lr"]),
                                  torch._foreach_add(new_inf, 1e-8))
        return (torch._foreach_sub(weights, step),
                list(zip(new_mean, new_inf)))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (reference `nadam.py`).  The momentum
    schedule ``m_schedule`` is host state that each parameter's update
    multiplies on, as in the reference, so the rule runs parameter by
    parameter."""

    supports_fused = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_f32_zeros(weight), _f32_zeros(weight))

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        mean, var = states
        g = grad + wd * w32
        momentum_t = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1 - 0.5 * 0.96 **
                                     ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        g_prime = g / (1 - self.m_schedule)
        new_mean = self.beta1 * mean + (1 - self.beta1) * g
        new_var = self.beta2 * var + (1 - self.beta2) * torch.square(g)
        m_prime = new_mean / (1 - m_schedule_next)
        v_prime = new_var / (1 - self.beta2 ** t)
        m_bar = (1 - momentum_t) * g_prime + momentum_t_1 * m_prime
        new_w = w32 - lr * m_bar / (torch.sqrt(v_prime) + self.epsilon)
        return new_w.to(weight.dtype), (new_mean, new_var)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (reference `lamb.py`,
    `lamb_update_phase1/2`): the BERT-pretraining optimizer of the
    repo's BERT benchmark configuration."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_f32_zeros(weight), _f32_zeros(weight))

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        mean, var = states
        new_mean = self.beta1 * mean + (1 - self.beta1) * grad
        new_var = self.beta2 * var + (1 - self.beta2) * torch.square(grad)
        if self.bias_correction:
            c1, c2 = _bias_corrections(self.beta1, self.beta2, t)
            m_hat = new_mean / c1
            v_hat = new_var / c2
        else:
            m_hat, v_hat = new_mean, new_var
        g = m_hat / (torch.sqrt(v_hat) + self.epsilon) + wd * w32
        r1 = torch.linalg.vector_norm(w32)
        if self.lower_bound is not None:
            r1 = torch.clamp(r1, min=self.lower_bound)
        if self.upper_bound is not None:
            r1 = torch.clamp(r1, max=self.upper_bound)
        r2 = torch.linalg.vector_norm(g)
        # the trust ratio stays on the device: no sync
        ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                            torch.ones_like(r1))
        new_w = w32 - lr * ratio * g
        return new_w.to(weight.dtype), (new_mean, new_var)

    @property
    def scalar_names(self):
        return ("lr", "wd", "c1", "c2") if self.bias_correction \
            else ("lr", "wd")

    def step_scalars(self, lr, wd, t):
        if self.bias_correction:
            return (lr, wd, *_bias_corrections(self.beta1, self.beta2, t))
        return (lr, wd)

    def update_multi(self, weights, grads, states, scalars):
        new_mean, new_var = _moments(self, grads, states)
        m_hat, v_hat = new_mean, new_var
        if self.bias_correction:
            m_hat = torch._foreach_div(new_mean, scalars["c1"])
            v_hat = torch._foreach_div(new_var, scalars["c2"])
        g = torch._foreach_add(
            torch._foreach_div(m_hat, torch._foreach_add(
                torch._foreach_sqrt(v_hat), self.epsilon)),
            torch._foreach_mul(weights, scalars["wd"]))
        r1 = _norms(weights)
        if self.lower_bound is not None:
            r1 = torch.clamp(r1, min=self.lower_bound)
        if self.upper_bound is not None:
            r1 = torch.clamp(r1, max=self.upper_bound)
        # the trust ratios stay on the device: no sync
        ratio = _ratio(r1, _norms(g))
        lr_ratio = (scalars["lr"] * ratio).unbind()
        step = [x * s for x, s in zip(g, lr_ratio)]
        return (torch._foreach_sub(weights, step),
                list(zip(new_mean, new_var)))


@register
class LANS(Optimizer):
    """LAMB over normalized gradients, two trust ratios (reference
    `lans.py`): one for the moment direction, one for the gradient's."""

    scalar_names = ("lr", "wd", "c1", "c2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_f32_zeros(weight), _f32_zeros(weight))

    def step_scalars(self, lr, wd, t):
        return (lr, wd, *_bias_corrections(self.beta1, self.beta2, t))

    def update_math(self, weight, grad, states, lr, wd, t):
        grad = grad.float()
        w32 = weight.float()
        mean, var = states
        c1, c2 = _bias_corrections(self.beta1, self.beta2, t)
        g_norm = torch.linalg.vector_norm(grad)
        grad_n = torch.where(g_norm > 0, grad / g_norm, grad)
        new_mean = self.beta1 * mean + (1 - self.beta1) * grad_n
        new_var = self.beta2 * var + (1 - self.beta2) * torch.square(grad_n)
        m_hat = new_mean / c1
        denom = torch.sqrt(new_var / c2) + self.epsilon
        r1 = torch.linalg.vector_norm(w32)
        d1 = m_hat / denom + wd * w32
        ratio1 = _ratio(r1, torch.linalg.vector_norm(d1))
        d2 = grad_n / denom + wd * w32
        ratio2 = _ratio(r1, torch.linalg.vector_norm(d2))
        new_w = w32 - lr * (self.beta1 * ratio1 * d1 +
                            (1 - self.beta1) * ratio2 * d2)
        return new_w.to(weight.dtype), (new_mean, new_var)

    def update_multi(self, weights, grads, states, scalars):
        g_norm = _norms(grads).unbind()
        grad_n = [torch.where(n > 0, g / n, g) for g, n in zip(grads, g_norm)]
        new_mean, new_var = _moments(self, grad_n, states)
        m_hat = torch._foreach_div(new_mean, scalars["c1"])
        denom = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(new_var, scalars["c2"])), self.epsilon)
        decay = torch._foreach_mul(weights, scalars["wd"])
        d1 = torch._foreach_add(torch._foreach_div(m_hat, denom), decay)
        d2 = torch._foreach_add(torch._foreach_div(grad_n, denom), decay)
        r1 = _norms(weights)
        # the trust ratios stay on the device: no sync
        s1 = (self.beta1 * _ratio(r1, _norms(d1))).unbind()
        s2 = ((1 - self.beta1) * _ratio(r1, _norms(d2))).unbind()
        u = [a * x + b * y for a, x, b, y in zip(s1, d1, s2, d2)]
        return (torch._foreach_sub(weights,
                                   torch._foreach_mul(u, scalars["lr"])),
                list(zip(new_mean, new_var)))
