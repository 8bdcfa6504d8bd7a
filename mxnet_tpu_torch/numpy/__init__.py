"""``mx.np``, the part the port needs (counterpart of
`mxnet_tpu/numpy/__init__.py`).

The functions here are those that amp's lists name under ``"numpy"``
(`amp._TARGET_FUNCS`, `amp._F32_FUNCS`): the products that amp runs in
the target dtype, and the exponentials, reductions and sorts that it
runs in f32.  The models call the products through this namespace
(`models/transformer.py`: the attention's two einsums, the MLM head's
matmul), so that ``amp.init`` reaches them as it reaches the
reference's.  Each is a plain function on tensors with numpy's
signature and its ``axis`` / ``keepdims`` / ``dtype`` semantics; the
products promote mixed operand dtypes as numpy does (same-dtype
operands go through untouched).  Beside them, the array creation and
shape functions `bench.py`'s prologue calls: `array`, `asarray` and
`transpose`; and those the recurrent layers and cells call: `zeros`,
`zeros_like`, `ones_like`, `stack`, `concatenate` and `swapaxes`; and
those the model zoo and ``nn.ReflectionPad2D`` call: `clip` and `pad`.
The rest of ``mx.np`` (the
other creation and shape functions, the ``NDArray`` type) is not ported
yet.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["matmul", "dot", "einsum", "tensordot", "inner", "outer",
           "exp", "expm1", "log", "log10", "log2", "log1p", "square",
           "reciprocal", "power", "sum", "nansum", "prod", "nanprod",
           "mean", "std", "var", "cumsum", "trace", "average", "arccos",
           "arcsin", "cosh", "sinh", "tan", "arctanh", "sqrt", "cbrt",
           "argsort", "sort", "array", "asarray", "transpose", "zeros",
           "zeros_like", "ones_like", "stack", "concatenate", "swapaxes",
           "clip", "pad"]


def _promote(*arrays):
    """The operands in their common dtype (numpy's promotion); an
    operand already in it is returned as it is."""
    dtype = arrays[0].dtype
    for a in arrays[1:]:
        dtype = torch.promote_types(dtype, a.dtype)
    return [a if a.dtype == dtype else a.to(dtype) for a in arrays]


def _as_dtype(a, dtype):
    if dtype is None:
        return a
    from ..gluon.parameter import to_torch_dtype
    return a.to(to_torch_dtype(dtype))


def _float(a):
    """``a``, or ``a`` in f32 when it is not floating (numpy's mean of
    integers is a float)."""
    return a if a.is_floating_point() else a.float()


def _dims(a, axis):
    """``axis`` as a tuple of non-negative dims (None: every dim)."""
    if axis is None:
        return tuple(range(a.ndim))
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    return tuple(x % a.ndim if a.ndim else 0 for x in axes)


def _reduce(fn, a, axis, keepdims):
    """``fn(a, dims, keepdim)`` over ``axis`` with numpy's keepdims."""
    dims = _dims(a, axis)
    if a.ndim == 0 or not dims:
        return fn(a, None, False) if a.ndim == 0 else a
    return fn(a, dims, keepdims)


# -- products (amp: the target dtype) ----------------------------------------
def matmul(a, b):
    a, b = _promote(a, b)
    return torch.matmul(a, b)


def dot(a, b):
    """numpy's ``dot``: a product for scalars, the last axis of ``a``
    against the second-to-last of ``b`` (the only one for a vector)."""
    a, b = _promote(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.ndim - 1], [max(b.ndim - 2, 0)]))


def einsum(subscripts, *operands, **_kwargs):
    return torch.einsum(subscripts, *_promote(*operands))


def tensordot(a, b, axes=2):
    a, b = _promote(a, b)
    if not isinstance(axes, int):
        axes = [list(x) if isinstance(x, (tuple, list)) else [x]
                for x in axes]
    return torch.tensordot(a, b, dims=axes)


def inner(a, b):
    a, b = _promote(a, b)
    return torch.inner(a, b)


def outer(a, b):
    a, b = _promote(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


# -- elementwise (amp: f32) --------------------------------------------------
exp = torch.exp
expm1 = torch.expm1
log = torch.log
log10 = torch.log10
log2 = torch.log2
log1p = torch.log1p
square = torch.square
reciprocal = torch.reciprocal
arccos = torch.arccos
arcsin = torch.arcsin
cosh = torch.cosh
sinh = torch.sinh
tan = torch.tan
arctanh = torch.arctanh
sqrt = torch.sqrt


def power(x1, x2):
    return torch.pow(x1, x2)


def cbrt(x):
    """The real cube root (negative for negative ``x``)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# -- reductions and sorts (amp: f32) -----------------------------------------
def sum(a, axis=None, dtype=None, keepdims=False):  # noqa: A001
    a = _as_dtype(a, dtype)
    return _reduce(lambda x, d, k: torch.sum(x) if d is None else
                   torch.sum(x, dim=d, keepdim=k), a, axis, keepdims)


def nansum(a, axis=None, dtype=None, keepdims=False):
    a = _as_dtype(a, dtype)
    return _reduce(lambda x, d, k: torch.nansum(x) if d is None else
                   torch.nansum(x, dim=d, keepdim=k), a, axis, keepdims)


def _prod(x, dims, keepdim):
    if dims is None:
        return torch.prod(x)
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def prod(a, axis=None, dtype=None, keepdims=False):
    return _reduce(_prod, _as_dtype(a, dtype), axis, keepdims)


def nanprod(a, axis=None, dtype=None, keepdims=False):
    a = _as_dtype(a, dtype)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.ones_like(a), a)
    return _reduce(_prod, a, axis, keepdims)


def mean(a, axis=None, dtype=None, keepdims=False):
    a = _float(_as_dtype(a, dtype))
    return _reduce(lambda x, d, k: torch.mean(x) if d is None else
                   torch.mean(x, dim=d, keepdim=k), a, axis, keepdims)


def var(a, axis=None, dtype=None, ddof=0, keepdims=False):
    a = _float(_as_dtype(a, dtype))
    return _reduce(lambda x, d, k: torch.var(x, correction=ddof)
                   if d is None else
                   torch.var(x, dim=d, correction=ddof, keepdim=k),
                   a, axis, keepdims)


def std(a, axis=None, dtype=None, ddof=0, keepdims=False):
    a = _float(_as_dtype(a, dtype))
    return _reduce(lambda x, d, k: torch.std(x, correction=ddof)
                   if d is None else
                   torch.std(x, dim=d, correction=ddof, keepdim=k),
                   a, axis, keepdims)


def cumsum(a, axis=None, dtype=None):
    a = _as_dtype(a, dtype)
    if axis is None:
        return torch.cumsum(a.reshape(-1), dim=0)
    return torch.cumsum(a, dim=axis)


def trace(a, offset=0, axis1=0, axis2=1, dtype=None):
    return torch.diagonal(_as_dtype(a, dtype), offset, axis1,
                          axis2).sum(-1)


def average(a, axis=None, weights=None, returned=False):
    """The mean, or with ``weights`` (of ``a``'s shape, or 1-D along a
    single ``axis``) the weighted mean; ``returned`` adds the sum of
    the weights."""
    a = _float(a)
    if weights is None:
        avg = mean(a, axis)
        scl = torch.full_like(avg, a.numel() / max(avg.numel(), 1))
    else:
        w = weights.to(a.dtype)
        if w.shape != a.shape:
            shape = [1] * a.ndim
            shape[axis % a.ndim] = -1
            w = w.reshape(shape).expand_as(a)
        scl = sum(w, axis)
        avg = sum(a * w, axis) / scl
    return (avg, scl) if returned else avg


def argsort(a, axis=-1, kind=None, order=None):
    """Stable ascending sort's indices, int32 as the reference's (JAX
    without x64); torch indexes with int32 tensors as it does with
    int64."""
    if axis is None:
        return torch.argsort(a.reshape(-1), stable=True).to(torch.int32)
    return torch.argsort(a, dim=axis, stable=True).to(torch.int32)


def sort(a, axis=-1, kind=None, order=None):
    if axis is None:
        return torch.sort(a.reshape(-1), stable=True).values
    return torch.sort(a, dim=axis, stable=True).values


def array(object, dtype=None, ctx=None, device=None):
    """A tensor of ``object`` on ``ctx`` (default: the card; a tensor's
    own device for a tensor).  Without a dtype, Python and numpy floats
    become f32 and int64 becomes int32, as in the reference (JAX without
    x64); a tensor keeps its dtype."""
    from ..context import resolve_device
    from ..gluon.parameter import to_torch_dtype

    if dtype is None and not isinstance(object, torch.Tensor):
        probe = onp.asarray(object)
        if probe.dtype.kind == "f":
            dtype = torch.float32
        elif probe.dtype == onp.int64:
            dtype = torch.int32
        object = probe
    ctx = ctx if ctx is not None else device
    if ctx is None and isinstance(object, torch.Tensor):
        ctx = object.device
    return torch.as_tensor(object).to(
        device=resolve_device(ctx),
        dtype=None if dtype is None else to_torch_dtype(dtype))


def asarray(a, dtype=None):
    """``a`` itself when it is a tensor and no dtype is asked, else
    `array` (on the card)."""
    if isinstance(a, torch.Tensor) and dtype is None:
        return a
    return array(a, dtype=dtype)


def transpose(a, axes=None):
    """``a`` with its axes permuted (reversed without ``axes``), as a new
    contiguous tensor: the reference's arrays are row-major values."""
    if axes is None:
        axes = tuple(range(a.ndim))[::-1]
    return a.permute(*axes).contiguous()


def _dtype(dtype, default=None):
    """``dtype`` as a torch dtype, ``default`` for None."""
    from ..gluon.parameter import to_torch_dtype
    return default if dtype is None else to_torch_dtype(dtype)


def zeros(shape, dtype=None, order="C", ctx=None, device=None):
    """Zeros on ``ctx`` (default: the card), f32 unless ``dtype``."""
    from ..context import resolve_device
    return torch.zeros(shape, dtype=_dtype(dtype, torch.float32),
                       device=resolve_device(ctx if ctx is not None
                                             else device))


def zeros_like(a, dtype=None, order="C", ctx=None, device=None):
    return torch.zeros_like(a, dtype=_dtype(dtype))


def ones_like(a, dtype=None, order="C", ctx=None, device=None):
    return torch.ones_like(a, dtype=_dtype(dtype))


def stack(seq, axis=0, out=None):
    return torch.stack(list(seq), dim=axis)


def concatenate(seq, axis=0, out=None):
    return torch.cat(list(seq), dim=axis)


def swapaxes(a, axis1, axis2):
    return torch.swapaxes(a, axis1, axis2)


def clip(a, a_min, a_max):
    """``a`` limited to [a_min, a_max] (either may be None)."""
    return torch.clamp(a, a_min, a_max)


def pad(x, pad_width, mode="constant", constant_values=0):
    """numpy's ``pad`` with ``((lo, hi), ...)`` per axis; modes
    ``constant``, and ``reflect`` and ``edge`` over at most the last
    three axes."""
    widths = [w for lo_hi in reversed(pad_width) for w in lo_hi]
    if mode == "constant":
        return torch.nn.functional.pad(x, widths, value=constant_values)
    k = x.ndim
    while k > 0 and tuple(pad_width[x.ndim - k]) == (0, 0):
        k -= 1
    widths = widths[:2 * k]
    lead, trail = x.shape[:x.ndim - k], x.shape[x.ndim - k:]
    out = torch.nn.functional.pad(
        x.reshape((1, -1) + tuple(trail)), widths,
        mode={"reflect": "reflect", "edge": "replicate"}[mode])
    return out.reshape(tuple(lead) + tuple(out.shape[2:]))
