"""Automatic mixed precision (counterpart of `mxnet_tpu/amp/__init__.py`).

``init(target_dtype)`` patches the functions of the port's ``mx.np`` and
``mx.npx`` namespaces that the reference's curated lists name, as the
reference patches its own (`amp.py:98`): the products (``_TARGET_FUNCS``)
take f32 tensor arguments down to the target dtype, the numerically
sensitive functions (``_F32_FUNCS``) take half-precision arguments up to
f32, and ``activation`` does so for ``softrelu`` only
(``_CONDITIONAL_F32``).  The parameters stay f32: a cast is part of the
autograd graph, so their gradients arrive in f32 (f32 master weights).
The models reach every listed function through its namespace (Dense
through ``npx.fully_connected``, attention and the MLM head through
``np.einsum`` / ``np.matmul``), so the patch reaches them.  Binary
elementwise ops need no patch: torch promotes f16 + f32 to f32, as
numpy does (the reference's WIDEST casts).

List entries whose module or function the port does not have are
skipped; `UNPORTED` names them all, and a test holds it to what the
port lacks.  ``init_trainer`` attaches a `LossScaler` (dynamic for
float16), which `gluon.Trainer.step` and `gluon.FusedTrainStep` consult;
``scale_loss`` / ``unscale`` drive ``trainer._scale`` as the reference
does.
"""
from __future__ import annotations

import importlib

import torch

from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "convert_hybrid_block", "convert_model",
           "LossScaler", "scale_loss", "unscale", "UNPORTED"]

_initialized = False
_target_dtype = None
_patched = []  # (module, name, original) for _reset()

# The reference's lists (`mxnet_tpu/amp/__init__.py:49-85`), kept as
# they are, module names relative to the package.
_TARGET_FUNCS = [
    ("numpy_extension", ["convolution", "deconvolution", "fully_connected",
                         "batch_dot"]),
    ("numpy", ["matmul", "dot", "einsum", "tensordot", "inner", "outer"]),
    ("ndarray.legacy", ["FullyConnected", "Convolution", "Deconvolution",
                        "RNN", "batch_dot", "dot"]),
]

_F32_FUNCS = [
    ("numpy", ["exp", "expm1", "log", "log10", "log2", "log1p", "square",
               "reciprocal", "power", "sum", "nansum", "prod", "nanprod",
               "mean", "std", "var", "cumsum", "trace", "average",
               "arccos", "arcsin", "cosh", "sinh", "tan", "arctanh",
               "sqrt", "cbrt", "argsort", "sort"]),
    ("numpy_extension", ["softmax", "log_softmax", "masked_softmax",
                         "masked_log_softmax", "layer_norm", "group_norm",
                         "instance_norm", "l2_normalization", "smooth_l1",
                         "topk", "gamma", "gammaln", "erfinv",
                         "khatri_rao"]),
    ("ndarray.legacy", ["sum", "mean", "prod", "nansum", "nanprod", "max",
                        "min", "norm", "moments", "softmin", "rsqrt",
                        "rcbrt", "reciprocal", "LRN", "InstanceNorm",
                        "LayerNorm", "GroupNorm", "L2Normalization",
                        "SoftmaxActivation", "softmax_cross_entropy",
                        "smooth_l1", "CTCLoss", "argsort", "topk",
                        "softmax", "log_softmax"]),
]

_CONDITIONAL_F32 = [
    ("numpy_extension", "activation", "act_type", ("softrelu",)),
    ("ndarray.legacy", "Activation", "act_type", ("softrelu",)),
]

# The list entries the port does not have yet, (module, function):
# `init` skips them.  The legacy ``nd`` namespace (ROADMAP queue A) and
# the npx operators no ported model calls.
UNPORTED = frozenset(
    [("numpy_extension", n) for n in (
        "batch_dot", "masked_softmax", "masked_log_softmax",
        "l2_normalization", "smooth_l1", "topk", "gamma", "gammaln",
        "erfinv", "khatri_rao")] +
    [("ndarray.legacy", n)
     for _m, names in _TARGET_FUNCS + _F32_FUNCS if _m == "ndarray.legacy"
     for n in names] +
    [("ndarray.legacy", "Activation")])

_HALF_DTYPES = (torch.bfloat16, torch.float16)


def _target(target_dtype):
    return torch.bfloat16 if str(target_dtype) in ("bfloat16", "bf16") \
        else torch.float16


def _lookup(mod_name, name):
    """The port's module and function for a list entry, or None where
    the port lacks either."""
    try:
        mod = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}."
                                      f"{mod_name}")
    except ModuleNotFoundError:
        return None, None
    return mod, getattr(mod, name, None)


def init(target_dtype="bfloat16"):
    """Patch the listed functions for ``target_dtype`` (``"float16"`` or
    ``"bfloat16"``); a second call does nothing."""
    global _initialized, _target_dtype
    if _initialized:
        return
    target = _target(target_dtype)
    _target_dtype = target

    def patch(mod_name, name, wrapper):
        mod, orig = _lookup(mod_name, name)
        if orig is None or getattr(orig, "_amp_wrapped", None) is not None:
            return
        _patched.append((mod, name, orig))
        setattr(mod, name, wrapper(orig))

    for mod_name, names in _TARGET_FUNCS:
        for name in names:
            patch(mod_name, name, lambda fn: _wrap_cast(fn, target))
    for mod_name, names in _F32_FUNCS:
        for name in names:
            patch(mod_name, name,
                  lambda fn: _wrap_cast(fn, torch.float32, up=True))
    for mod_name, name, key, vals in _CONDITIONAL_F32:
        patch(mod_name, name,
              lambda fn, k=key, v=vals: _wrap_conditional(fn, k, v))
    _initialized = True


def _reset():
    """Undo `init` (for tests: the reference has no unpatch)."""
    global _initialized, _target_dtype
    for mod, name, orig in reversed(_patched):
        setattr(mod, name, orig)
    _patched.clear()
    _initialized = False
    _target_dtype = None


def _wrap_cast(fn, target, up=False):
    """``up=False``: f32 tensor arguments go down to ``target``.
    ``up=True``: half-precision tensor arguments go up to f32."""
    def cast(a):
        if not isinstance(a, torch.Tensor):
            return a
        if up and a.dtype in _HALF_DTYPES:
            return a.float()
        if not up and a.dtype == torch.float32:
            return a.to(target)
        return a

    def wrapped(*args, **kwargs):
        return fn(*(cast(a) for a in args), **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "amp_op")
    wrapped._amp_wrapped = fn
    return wrapped


def _wrap_conditional(fn, key, f32_values):
    """f32 only for the listed values of ``key`` (``activation``'s
    ``act_type='softrelu'``)."""
    f32 = _wrap_cast(fn, torch.float32, up=True)

    def wrapped(*args, **kwargs):
        if kwargs.get(key) in f32_values or \
                any(a in f32_values for a in args if isinstance(a, str)):
            return f32(*args, **kwargs)
        return fn(*args, **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "amp_op")
    wrapped._amp_wrapped = fn
    return wrapped


def init_trainer(trainer):
    """Attach a loss scaler to ``trainer``: dynamic for float16, a fixed
    scale of 1 otherwise."""
    trainer._amp_loss_scaler = LossScaler(
        dynamic=_target_dtype == torch.float16)
    trainer._amp_original_scale = trainer._scale
    return trainer


class scale_loss:  # noqa: N801 - the reference's name
    """``with amp.scale_loss(loss, trainer) as scaled: backward(scaled)``:
    the loss times the scaler's scale, and ``trainer._scale`` divided by
    it, so that `Trainer.step` sees the true gradients."""

    def __init__(self, loss, trainer):
        self.loss = loss
        self.trainer = trainer

    def __enter__(self):
        scaler = getattr(self.trainer, "_amp_loss_scaler", None)
        if scaler is None:
            return self.loss
        self.trainer._scale = \
            self.trainer._amp_original_scale / scaler.loss_scale
        if isinstance(self.loss, (list, tuple)):
            return [x * scaler.loss_scale for x in self.loss]
        return self.loss * scaler.loss_scale

    def __exit__(self, *_exc):
        return False


def unscale(trainer):
    """Put ``trainer._scale`` back to its value before `scale_loss`."""
    if getattr(trainer, "_amp_loss_scaler", None) is not None:
        trainer._scale = trainer._amp_original_scale


def convert_hybrid_block(block, target_dtype="bfloat16", **_kwargs):
    """Cast ``block``'s parameters to the target dtype (the reference's
    graph conversion reduces to this cast)."""
    block.cast("bfloat16" if _target(target_dtype) == torch.bfloat16
               else "float16")
    return block


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None,
                  conditional_fp32_ops=None, excluded_sym_names=None,
                  cast_optional_params=False):
    """``(sym, arg_params, aux_params)`` with the f32 parameters (name ->
    tensor) cast to the target dtype, those named in
    ``excluded_sym_names`` kept f32; ``sym`` passes through."""
    target = _target(target_dtype)
    excluded = set(excluded_sym_names or ())

    def conv(params):
        out = {}
        for k, v in params.items():
            v = torch.as_tensor(v)
            out[k] = v.to(target) if k not in excluded and \
                v.dtype == torch.float32 else v
        return out

    return sym, conv(arg_params), conv(aux_params or {})
