"""NN operators (counterpart of the subset of `mxnet_tpu/ops/nn.py` that
the BERT serving and pretraining paths call).  Plain functions on
``torch.Tensor``; the large products go to ``torch.matmul`` /
``F.linear``, as the reference left them to XLA."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["layer_norm", "fully_connected", "softmax", "log_softmax",
           "activation", "leaky_relu", "dropout", "embedding", "pick"]


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization over ``axis``, statistics from a single pass
    over the data, as the reference's.  PyTorch's fused kernel takes that
    pass (mean and variance by Welford's update, in f32 for bf16 data,
    where the reference sums x and x*x in one read) and applies gamma
    and beta in the same launch, rounding once to the input dtype: the
    same function to f32 rounding, in one kernel launch where the
    reference's formula spelled in torch ops takes 19 (PERF.md)."""
    ax = axis if axis >= 0 else data.ndim + axis
    x = data if ax == data.ndim - 1 else data.movedim(ax, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma.to(data.dtype),
                       beta.to(data.dtype), eps)
    return out if ax == data.ndim - 1 else out.movedim(-1, ax)


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias`` with the weight stored (out, in)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


def softmax(data, axis=-1):
    return torch.softmax(data, dim=axis)


def log_softmax(data, axis=-1):
    return torch.log_softmax(data, dim=axis)


_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus}


def activation(data, act_type="relu"):
    return _ACTIVATIONS[act_type](data)


def leaky_relu(data, act_type="gelu"):
    """The GELU members of the reference's leaky_relu family."""
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "gelu_tanh":
        return F.gelu(data, approximate="tanh")
    raise ValueError(f"unknown act_type {act_type!r}")


def dropout(data, seed, p=0.5):
    """Zero elements at rate ``p`` and rescale the rest by 1/(1-p), with
    the keep mask drawn on the data's own device from a generator seeded
    with the integer ``seed`` (no host-device copy, no sync)."""
    if p == 0.0:
        return data
    keep = 1.0 - p
    gen = torch.Generator(device=data.device)
    gen.manual_seed(seed)
    u = torch.rand(data.shape, generator=gen, device=data.device)
    return torch.where(u < keep, data / keep, torch.zeros_like(data))


def embedding(data, weight):
    return F.embedding(data.long(), weight)


def pick(data, index, axis=-1):
    """``data`` at ``index`` along ``axis`` (which drops); out-of-range
    indices are clipped, as the reference's default ``mode="clip"``."""
    ax = axis if axis >= 0 else data.ndim + axis
    idx = index.long().clamp(0, data.shape[ax] - 1)
    return torch.gather(data, ax, idx.unsqueeze(ax)).squeeze(ax)
