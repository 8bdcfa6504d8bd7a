"""Batchify functions for the DataLoader (counterpart of
`mxnet_tpu/gluon/data/batchify.py`): `Stack`, `Pad` (variable-length
samples to the batch's longest) and `Group` (one function per field of
a sample), passed as ``DataLoader(..., batchify_fn=...)``.

They return numpy arrays: the workers stay on the host, and the loader
copies each whole batch to the card once, so a worker process never
touches CUDA.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["Stack", "Pad", "Group", "Tuple"]


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


class Stack:
    """Stack samples along a new batch axis (reference batchify.Stack)."""

    def __call__(self, data):
        return onp.stack([_to_np(d) for d in data])


class Pad:
    """Pad variable-length samples to the batch max along `axis`
    (reference batchify.Pad); optionally also returns the valid lengths.
    """

    def __init__(self, axis=0, pad_val=0, ret_length=False, dtype=None):
        self._axis = axis
        self._pad_val = pad_val
        self._ret_length = ret_length
        self._dtype = dtype

    def __call__(self, data):
        arrs = [_to_np(d) for d in data]
        axis = self._axis % arrs[0].ndim  # normalize: -1 on 2-D -> 1
        max_len = max(a.shape[axis] for a in arrs)
        out_shape = list(arrs[0].shape)
        out_shape[axis] = max_len
        out = onp.full([len(arrs)] + out_shape, self._pad_val,
                       dtype=self._dtype or arrs[0].dtype)
        lengths = onp.empty(len(arrs), onp.int32)
        for i, a in enumerate(arrs):
            lengths[i] = a.shape[axis]
            sl = [i] + [slice(None)] * a.ndim
            sl[1 + axis] = slice(0, a.shape[axis])
            out[tuple(sl)] = a
        if self._ret_length:
            return out, lengths
        return out


class Group:
    """Apply one batchify function per element of the sample tuple
    (reference batchify.Group, also exported as Tuple)."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        self._fns = fns

    def __call__(self, data):
        if len(data[0]) != len(self._fns):
            raise ValueError(
                f"sample has {len(data[0])} fields but {len(self._fns)} "
                "batchify functions were given")
        return tuple(fn([sample[i] for sample in data])
                     for i, fn in enumerate(self._fns))


Tuple = Group  # the reference exports this collate under both names
