"""Saving and loading tensors (counterpart of
`mxnet_tpu/utils/serialization.py`).

The JAX package's format: a NumPy ``.npz`` archive with a
``__mxnet_tpu_magic__`` entry (upstream's 0x112) and, for a dict, the
names in their order under ``__keys__``; a lone array is ``__solo__``,
a list ``arr_0``, ``arr_1``, ...  bfloat16 is stored as the JAX package
stores it, as raw 2-byte void records (``|V2``, the bits); the reader
turns ``|V2`` back into bfloat16 (which the JAX package's own reader
cannot).  `load_ndarrays` also reads upstream's binary format, magic
0x112 (`legacy_format`).

A checkpoint is outside input: `load_ndarrays` reads every array with
``allow_pickle=False`` and the pickled ``__keys__`` through
`ArraysOnlyUnpickler`, which builds numpy arrays and nothing that runs
code.
"""
from __future__ import annotations

import pickle
import zipfile

import numpy as onp
import torch

from ..context import resolve_device
from .legacy_format import MAGIC, load_legacy

__all__ = ["save_ndarrays", "load_ndarrays", "ArraysOnlyUnpickler"]

_SKIP = ("__mxnet_tpu_magic__", "__keys__")


class ArraysOnlyUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays (and the builtins inside them) and refuses
    every other class, so that a crafted file cannot run code when it
    loads.  ``what`` names the file's kind in the error."""

    _ARRAYS = {("numpy", "ndarray"), ("numpy", "dtype"),
               ("numpy.core.multiarray", "_reconstruct"),
               ("numpy._core.multiarray", "_reconstruct"),
               ("numpy.core.multiarray", "scalar"),
               ("numpy._core.multiarray", "scalar"),
               ("numpy.core.numeric", "_frombuffer"),
               ("numpy._core.numeric", "_frombuffer")}

    def __init__(self, file, what="this file"):
        super().__init__(file)
        self.what = what

    def find_class(self, module, name):
        if (module, name) in self._ARRAYS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{self.what} holds numpy arrays only; refusing {module}.{name}")


def _read_keys(fname):
    """The names in an ``.npz``'s ``__keys__``, an object array that
    numpy pickles: read through `ArraysOnlyUnpickler`."""
    fmt = onp.lib.format
    with zipfile.ZipFile(fname) as zf, zf.open("__keys__.npy") as f:
        version = fmt.read_magic(f)
        header = {(1, 0): fmt.read_array_header_1_0,
                  (2, 0): fmt.read_array_header_2_0}.get(version)
        if header is None:
            raise ValueError(f"{fname}: __keys__ has .npy version {version}")
        if not header(f)[2].hasobject:
            raise ValueError(f"{fname}: __keys__ is not an object array")
        keys = ArraysOnlyUnpickler(f, "a checkpoint's __keys__").load()
    keys = onp.asarray(keys).tolist()
    if not (isinstance(keys, list) and all(isinstance(k, str) for k in keys)):
        raise ValueError(f"{fname}: __keys__ is not a list of names")
    return keys


def _to_numpy(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if a.dtype == onp.dtype("V2"):
        return torch.from_numpy(onp.ascontiguousarray(a).view(onp.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(onp.array(a)).to(device)


def save_ndarrays(fname, data):
    """Save a tensor, a list of tensors or a dict of them to ``fname``."""
    if isinstance(data, torch.Tensor):
        payload, keys = {"__solo__": data}, None
    elif isinstance(data, (list, tuple)):
        payload, keys = {f"arr_{i}": a for i, a in enumerate(data)}, None
    elif isinstance(data, dict):
        payload, keys = dict(data), list(data)
    else:
        raise TypeError(f"cannot save {type(data)}")
    arrays = {}
    for k, v in payload.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"value for {k!r} is not a tensor")
        arrays[k] = _to_numpy(v)
    arrays["__mxnet_tpu_magic__"] = onp.asarray(MAGIC, onp.int64)
    if keys is not None:
        arrays["__keys__"] = onp.asarray(keys, dtype=object)
    with open(fname, "wb") as f:
        onp.savez(f, **arrays)


def load_ndarrays(fname, ctx=None):
    """What `save_ndarrays` (or the JAX package's, or upstream's
    ``mx.nd.save``) wrote: a tensor, a list or a dict, on ``ctx`` (None
    = the card), each with its saved dtype."""
    device = resolve_device(ctx)
    with open(fname, "rb") as f:
        head = f.read(8)
    if len(head) == 8 and int.from_bytes(head, "little") == MAGIC:
        with open(fname, "rb") as f:
            arrays, names = load_legacy(f.read())
        tensors = [_to_tensor(a, device) for a in arrays]
        return dict(zip(names, tensors)) if names else tensors
    with onp.load(fname, allow_pickle=False) as z:
        names = [n for n in z.files if n not in _SKIP]
        if "__keys__" in z.files:
            return {k: _to_tensor(z[k], device) for k in _read_keys(fname)}
        if names == ["__solo__"]:
            return _to_tensor(z["__solo__"], device)
        if all(n.startswith("arr_") for n in names):
            names.sort(key=lambda n: int(n.split("_")[1]))
            return [_to_tensor(z[n], device) for n in names]
        return {n: _to_tensor(z[n], device) for n in names}
