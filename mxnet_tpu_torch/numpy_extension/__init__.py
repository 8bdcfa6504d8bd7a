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
words).

`foreach`, `while_loop` and `cond` are `ops.control_flow`'s, with the
reference's eager and traced contracts; `sequence_mask` and
`sequence_reverse` are the reference's sequence ops, over the time axis.

`remat` is the reference's rematerialization boundary, built on torch's
non-reentrant checkpointing: the backward recomputes what the boundary's
forward did not save, reading the seed words its first run drew
(`ops.seeds.DrawTape`)."""
from __future__ import annotations

import contextlib
import warnings

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import control_flow as _cf
from ..ops import nn as _nn
from ..ops import stem as _stem
from ..ops.aux_scope import apply_aux_update, aux_update_scope
from ..ops.invoke import (draw_tapes, is_recording, is_tracing, is_training,
                          modes, set_modes)
from ..ops.seeds import DrawTape, draw_seed

__all__ = ["activation", "dropout", "embedding", "fully_connected", "gelu",
           "layer_norm", "group_norm", "instance_norm", "leaky_relu",
           "log_softmax", "pick", "softmax", "flash_attention", "convolution",
           "deconvolution", "pooling", "batch_norm",
           "stem_conv", "remat", "foreach", "while_loop", "cond", "relu",
           "sigmoid", "sequence_mask", "sequence_reverse"]

activation = _nn.activation
convolution = _nn.convolution
deconvolution = _nn.deconvolution
pooling = _nn.pooling
stem_conv = _stem.stem_conv_auto
embedding = _nn.embedding
fully_connected = _nn.fully_connected
layer_norm = _nn.layer_norm
group_norm = _nn.group_norm
instance_norm = _nn.instance_norm
leaky_relu = _nn.leaky_relu
log_softmax = _nn.log_softmax
pick = _nn.pick
softmax = _nn.softmax
foreach = _cf.foreach
while_loop = _cf.while_loop
cond = _cf.cond
relu = torch.relu
sigmoid = torch.sigmoid


def gelu(data, approximation="erf"):
    act = "gelu" if approximation in ("erf", "none", None) else "gelu_tanh"
    return leaky_relu(data, act_type=act)


def dropout(data, p=0.5, axes=None, mode=None):
    """Active in train mode (``mode=None``) or always (``mode="always"``;
    any other mode never drops, as in the reference); the mask is drawn
    on the data's device from the two seed words of one draw of the
    scope's generator.  With ``axes``, the mask is drawn over those axes
    only (size 1 along the others, as the reference shapes it) and
    broadcast over the rest."""
    active = is_training() if mode is None else mode == "always"
    if not active or p == 0.0:
        return data
    seed = draw_seed("dropout", data.device)
    if not axes:
        return _nn.dropout(data, seed, p=p)
    shape = [n if i in axes else 1 for i, n in enumerate(data.shape)]
    mask = _nn.dropout(torch.ones(shape, dtype=data.dtype,
                                  device=data.device), seed, p=p)
    return data * mask


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """``value`` at the steps of each sequence at or past its length
    (``axis``: the time axis, 0 or 1; the batch axis is the other)."""
    if not use_sequence_length or sequence_length is None:
        return data
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    steps = torch.arange(data.shape[axis], device=data.device).reshape(shape)
    ln_shape = [1] * data.ndim
    ln_shape[1 - axis] = data.shape[1 - axis]
    ln = sequence_length.to(data.device).reshape(ln_shape)
    return torch.where(steps < ln, data,
                       torch.as_tensor(value, dtype=data.dtype,
                                       device=data.device))


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's first ``length`` steps reversed along ``axis`` (0
    or 1), the steps past it in place; without lengths, the whole axis
    flipped."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    t = data.shape[axis]
    steps = torch.arange(t, device=data.device)
    ln = sequence_length.to(device=data.device, dtype=torch.int64)
    idx = torch.where(steps[None, :] < ln[:, None],
                      ln[:, None] - 1 - steps[None, :], steps[None, :])
    if axis == 0:
        return data[idx.T, torch.arange(data.shape[1],
                                        device=data.device)[None, :]]
    return torch.take_along_dim(
        data, idx.reshape(idx.shape + (1,) * (data.ndim - 2)), dim=1)


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


def remat(fn):
    """Rematerialization boundary around ``fn``, a Block or a function of
    tensors (counterpart of the reference's ``npx.remat``): under
    autograd, the intermediates of ``fn`` are not kept for the backward,
    which recomputes them from the boundary's inputs.  Memory per
    boundary drops to its inputs and outputs; the forward runs twice.

    ``x = npx.remat(layer)(x, mask)``; ``TransformerEncoder(remat=True)``
    wraps every layer so.  The wrapper is cached on ``fn``.

    What the recompute keeps of the first run:
    - the random draws: the recompute is handed the seed tensors the
      first run drew (`ops.seeds.DrawTape`), so a dropout mask or the
      flash kernels' keep bits are bit for bit the forward's.  It draws
      nothing from the generator and, while `gluon.FusedTrainStep`
      captures a step, takes no new row of its seed table; torch's own
      RNG state is not stashed (``preserve_rng_state=False``: the port
      draws no bits from it, and a capture may not read it);
    - the modes (recording, training, backward expected), which the
      recompute sets on the thread that runs it;
    - auxiliary updates (BatchNorm running statistics) are taken from
      the first run only and applied outside the boundary, at once or
      into the enclosing `ops.aux_scope` (a fused step's, under its
      verdict); the recompute's are dropped.

    A Block's parameters get their gradients through the boundary.  A
    function that is not a Block is differentiated with respect to its
    tensor arguments only when called eagerly, as in the reference:
    parameters it closes over are constants inside
    (`gluon.parameter.constant_parameters`) and get no gradient, and
    calling it under ``autograd.record()`` warns.  Inside a
    `gluon.FusedTrainStep` (the reference's traced step, where they do
    get gradients) they are differentiated too.  Deferred parameter
    shapes of a Block are settled first by one forward without
    gradients in predict mode."""
    cached = getattr(fn, "_npx_remat_wrapped", None)
    if cached is not None:
        return cached
    from ..gluon.parameter import constant_parameters

    is_block = hasattr(fn, "collect_params")
    first_call = True

    def wrapped(*args, **kwargs):
        nonlocal first_call
        if first_call:
            first_call = False
            if is_block:
                _settle_shapes(fn, args, kwargs)
            elif is_recording():
                warnings.warn(
                    "npx.remat over a non-Block callable under "
                    "autograd.record(): gradients will not flow to "
                    "parameters closed over by the callable — wrap the "
                    "Block itself", stacklevel=2)
        scope = contextlib.nullcontext if is_block or is_tracing() \
            else constant_parameters
        if not torch.is_grad_enabled():
            with scope():
                return fn(*args, **kwargs)
        flags = modes()
        tape = DrawTape()
        updates = []

        def run(*a, **kw):
            first = not updates and not tape.replaying
            if not first:
                tape.replay()
            prev = set_modes(flags)
            tapes = draw_tapes()
            tapes.append(tape)
            try:
                with aux_update_scope() as aux, scope():
                    out = fn(*a, **kw)
            finally:
                tapes.pop()
                set_modes(prev)
            if first:
                updates.append(aux.updates)
            return out

        out = checkpoint(run, *args, use_reentrant=False,
                         preserve_rng_state=False, **kwargs)
        for arr, new in updates[0]:
            apply_aux_update(arr, new)
        return out

    try:
        fn._npx_remat_wrapped = wrapped
    except AttributeError:
        pass
    return wrapped


def _settle_shapes(block, args, kwargs):
    """One forward without gradients in predict mode when ``block`` has
    parameters of unknown shape (running statistics untouched, no
    draws)."""
    if any(p._deferred_init is not None
           for p in block.collect_params().values()):
        from .. import autograd
        with torch.no_grad(), autograd.predict_mode():
            block(*args, **kwargs)
