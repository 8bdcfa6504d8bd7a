"""``mx.npx`` (counterpart of `mxnet_tpu/numpy_extension/__init__.py`):
the NN primitives Gluon layers call.  Each delegates to `ops/nn.py` or,
for attention, to the flash kernel's wrapper; train/predict mode and
the dropout generator come from `ops/invoke.py`."""
from __future__ import annotations

import torch

from ..ops import nn as _nn
from ..ops.invoke import current_generator, is_training

__all__ = ["activation", "dropout", "embedding", "fully_connected", "gelu",
           "layer_norm", "leaky_relu", "softmax", "flash_attention"]

activation = _nn.activation
embedding = _nn.embedding
fully_connected = _nn.fully_connected
layer_norm = _nn.layer_norm
leaky_relu = _nn.leaky_relu
softmax = _nn.softmax


def gelu(data, approximation="erf"):
    act = "gelu" if approximation in ("erf", "none", None) else "gelu_tanh"
    return leaky_relu(data, act_type=act)


def _generator(what):
    gen = current_generator()
    if gen is None:
        raise ValueError(f"{what} in train mode needs a torch.Generator: "
                         "run under autograd.train_mode(generator=...)")
    return gen


def dropout(data, p=0.5):
    """Active only in train mode, drawing from the generator of
    ``autograd.train_mode``."""
    if not is_training() or p == 0.0:
        return data
    return _nn.dropout(data, _generator("dropout"), p=p)


def flash_attention(q, k, v, **kwargs):
    """Blockwise (flash) attention: the CUDA kernel on the card, its
    plain version on the CPU (see `ops/flash_attention.py`).  Accepts
    ``causal``, ``scale``, ``mask`` (key-padding (B, T)), ``bias`` and
    in-kernel ``dropout``; with dropout and no ``key``, the two seed
    words are drawn from the train-mode generator."""
    from ..ops.flash_attention import flash_attention as _fa
    if kwargs.get("dropout") and kwargs.get("key") is None:
        kwargs["key"] = torch.randint(
            0, 2 ** 32, (2,), generator=_generator("attention dropout"),
            device=current_generator().device).tolist()
    return _fa(q, k, v, **kwargs)
