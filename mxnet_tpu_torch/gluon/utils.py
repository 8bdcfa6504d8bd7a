"""Gluon utilities (counterpart of `mxnet_tpu/gluon/utils.py`):
`split_data`, `split_and_load`, `clip_global_norm`, `shape_is_known`,
`check_sha1`."""
from __future__ import annotations

import hashlib
import warnings

import torch

from ..context import mark_context, resolve_device

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "shape_is_known"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` slices along ``batch_axis`` (the
    last takes the remainder unless ``even_split``, which requires an
    even division)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {tuple(data.shape)} cannot be evenly split "
            f"into {num_slice} slices along axis {batch_axis}.")
    step = size // num_slice
    return [data.narrow(batch_axis, i * step,
                        (size if i == num_slice - 1 else (i + 1) * step)
                        - i * step)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """`split_data` into one slice per context of ``ctx_list``, each
    moved to its device.  With several contexts, each CPU slice is
    marked with its own (`context.mark_context`), so a block called on
    it uses that context's copies of the parameters."""
    data = torch.as_tensor(data)
    if len(ctx_list) == 1:
        return [data.to(resolve_device(ctx_list[0]))]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [mark_context(s.to(resolve_device(ctx)), ctx)
            for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (the gradients) in place so their joint L2 norm,
    summed in f32, is at most ``max_norm``; returns the norm before the
    scaling.  With ``check_isfinite`` (the default) the norm is read to
    the host, as the reference does: a non-finite norm warns, the scale
    is taken on the host and the norm returned as a float.  Without it,
    nothing syncs: the scale, min(1, max_norm / norm), is applied on the
    device and the norm returned as a device tensor."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    if any(a.layout != torch.strided for a in arrays):
        raise NotImplementedError(
            "clip_global_norm of sparse gradients waits for the port's "
            "row-sparse arrays (ROADMAP queue A item 10)")
    total = torch.sqrt(sum(torch.sum(torch.square(a.float()))
                           for a in arrays))
    if not check_isfinite:
        scale = torch.clamp(max_norm / (total + 1e-8), max=1.0)
        with torch.no_grad():
            for a in arrays:
                a.mul_(scale.to(a.dtype))
        return total
    total_host = float(total)
    if not total_host == total_host or abs(total_host) == float("inf"):
        warnings.warn(UserWarning(
            "nan or inf is detected. Clipping results will be undefined."),
            stacklevel=2)
    scale = max_norm / (total_host + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a.mul_(scale)
    return total_host


def shape_is_known(shape):
    """Whether every dimension of ``shape`` is known (positive)."""
    if shape is None:
        return False
    return all(s > 0 for s in shape)


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1048576), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash
