"""``mx.npx`` (counterpart of `mxnet_tpu/numpy_extension/__init__.py`):
the NN primitives Gluon layers call.  Each delegates to `ops/nn.py`,
`ops/stem.py` or, for attention, to the flash kernels' wrapper;
train/predict mode and the dropout generator come from `ops/invoke.py`.
`batch_norm` in train mode hands its new running statistics to
`ops/aux_scope.apply_aux_update`.

Train-mode randomness takes its seeds from the scope's CPU generator on
the host (`ops.seeds.draw_seed`): each draw's two seed words go to the
device, where the dropout kernel (`ops.nn.dropout`) and the flash
kernels read them, so no draw syncs with the card and a captured step
replays with fresh words.  The reference draws its dropout bits from
XLA's ``rbg`` generator, so model-level dropout masks differ between the
packages (the flash kernels' own bits match, given the same seed
words)."""
from __future__ import annotations

from ..ops import nn as _nn
from ..ops import stem as _stem
from ..ops.aux_scope import apply_aux_update
from ..ops.invoke import is_training
from ..ops.seeds import draw_seed

__all__ = ["activation", "dropout", "embedding", "fully_connected", "gelu",
           "layer_norm", "leaky_relu", "log_softmax", "pick", "softmax",
           "flash_attention", "convolution", "pooling", "batch_norm",
           "stem_conv"]

activation = _nn.activation
convolution = _nn.convolution
pooling = _nn.pooling
stem_conv = _stem.stem_conv_auto
embedding = _nn.embedding
fully_connected = _nn.fully_connected
layer_norm = _nn.layer_norm
leaky_relu = _nn.leaky_relu
log_softmax = _nn.log_softmax
pick = _nn.pick
softmax = _nn.softmax


def gelu(data, approximation="erf"):
    act = "gelu" if approximation in ("erf", "none", None) else "gelu_tanh"
    return leaky_relu(data, act_type=act)


def dropout(data, p=0.5):
    """Active only in train mode; the mask is drawn on the data's device
    from the two seed words of one draw of the scope's generator."""
    if not is_training() or p == 0.0:
        return data
    return _nn.dropout(data, draw_seed("dropout", data.device), p=p)


def flash_attention(q, k, v, **kwargs):
    """Blockwise (flash) attention: the CUDA kernels on the card, their
    plain versions on the CPU (see `ops/flash_attention.py`).  Accepts
    ``causal``, ``scale``, ``mask`` (key-padding (B, T)), ``bias`` and
    in-kernel ``dropout``; with dropout and no ``key``, the two seed
    words are one draw of the train-mode generator."""
    from ..ops.flash_attention import flash_attention as _fa
    if kwargs.get("dropout") and kwargs.get("key") is None:
        kwargs["key"] = draw_seed("attention", q.device,
                                  what="attention dropout")
    return _fa(q, k, v, **kwargs)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1):
    """Batch normalization over ``axis``.  Train mode (``is_training()``,
    not ``nn.Module.training``) without ``use_global_stats`` normalizes
    by the batch's statistics and updates the running statistics, ``new
    = momentum * old + (1 - momentum) * batch`` with the biased
    variance; otherwise it normalizes by the running statistics.
    ``fix_gamma`` uses a gamma of ones (its gradient is zero)."""
    if fix_gamma:
        gamma = gamma * 0 + 1
    if is_training() and not use_global_stats:
        out, new_mean, new_var = _nn.batch_norm_train(
            x, gamma, beta, momentum, eps, axis, running_mean, running_var)
        apply_aux_update(running_mean, new_mean)
        apply_aux_update(running_var, new_var)
        return out
    return _nn.batch_norm_inference(x, gamma, beta, running_mean,
                                    running_var, eps, axis)
