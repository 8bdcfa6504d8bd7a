"""Upstream MXNet's binary NDArray file format, magic ``0x112``
(counterpart of `mxnet_tpu/utils/legacy_format.py`; upstream
`src/ndarray/ndarray.cc:1962` for the list, `:1729` for each array).

Real MXNet ``.params`` checkpoints and ``mx.nd.save`` files load here,
and files saved here load in upstream MXNet and in the JAX package.
Arrays are numpy on both sides of the codec, except bfloat16 (type flag
12), which numpy lacks: it reads and writes as a torch tensor.

Layout (little-endian):
  u64 0x112, u64 reserved
  u64 n_arrays, then per array:
    u32 magic: 0xF993fac8 (V1) / 0xF993fac9 (V2) / 0xF993faca (V3),
        anything else = legacy ndim
    [V2/V3] i32 stype (dense = 0 here)
    TShape: u32 ndim + i64*ndim  (legacy pre-V1: u32*ndim with magic=ndim)
    Context: i32 dev_type, i32 dev_id
    i32 type_flag (mshadow dtype code)
    raw contiguous data
  u64 n_names, then per name: u64 len + bytes
"""
from __future__ import annotations

import struct

import numpy as onp
import torch

__all__ = ["MAGIC", "load_legacy", "save_legacy"]

MAGIC = 0x112
_V1 = 0xF993FAC8
_V2 = 0xF993FAC9
_V3 = 0xF993FACA

# mshadow type codes (`3rdparty/mshadow/mshadow/base.h`)
_TYPE_FLAGS = {
    0: onp.float32, 1: onp.float64, 2: onp.float16, 3: onp.uint8,
    4: onp.int32, 5: onp.int8, 6: onp.int64, 7: onp.bool_,
    8: onp.int16, 9: onp.uint16, 10: onp.uint32, 11: onp.uint64,
}
_FLAG_OF = {onp.dtype(v): k for k, v in _TYPE_FLAGS.items()}
_BF16_FLAG = 12


class _Reader:
    def __init__(self, data):
        self.b = data
        self.o = 0

    def read(self, fmt):
        vals = self.read_tuple(fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_tuple(self, fmt):
        vals = struct.unpack_from("<" + fmt, self.b, self.o)
        self.o += struct.calcsize("<" + fmt)
        return vals

    def raw(self, n):
        out = self.b[self.o:self.o + n]
        if len(out) != n:
            raise ValueError("truncated NDArray file")
        self.o += n
        return out


def _read_array(r):
    magic = r.read("I")
    if magic in (_V2, _V3):
        if r.read("i") != 0:
            raise NotImplementedError(
                "sparse storage in 0x112 files is not supported (convert "
                "with cast_storage first)")
        shape = r.read_tuple("q" * r.read("I"))
    elif magic == _V1:
        shape = r.read_tuple("q" * r.read("I"))
    else:
        # pre-V1: the magic is the ndim, and the dims are u32
        shape = r.read_tuple("I" * magic)
    if any(s < 0 for s in shape):
        raise ValueError("negative dimension in saved shape")
    if magic in (_V1, _V2, _V3) and len(shape) == 0:
        return onp.zeros((), onp.float32)  # upstream's is_none sentinel
    _dev_type, _dev_id = r.read("ii")
    type_flag = r.read("i")
    n = int(onp.prod(shape, dtype=onp.int64))
    if type_flag == _BF16_FLAG:
        bits = onp.frombuffer(r.raw(2 * n), dtype=onp.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    if type_flag not in _TYPE_FLAGS:
        raise ValueError(f"unknown type flag {type_flag} in NDArray file")
    dt = onp.dtype(_TYPE_FLAGS[type_flag])
    return onp.frombuffer(r.raw(dt.itemsize * n), dtype=dt).reshape(shape)


def load_legacy(data):
    """Parse 0x112 bytes -> (list of arrays, list of names); each array
    numpy, or a bfloat16 torch tensor."""
    r = _Reader(data)
    header, _reserved = r.read("QQ")
    if header != MAGIC:
        raise ValueError(f"not an NDArray file (magic {header:#x})")
    arrays = [_read_array(r) for _ in range(r.read("Q"))]
    names = [r.raw(r.read("Q")).decode() for _ in range(r.read("Q"))]
    if names and len(names) != len(arrays):
        raise ValueError("invalid NDArray file: key/array count mismatch")
    return arrays, names


def save_legacy(arrays, names=()):
    """Serialize arrays (numpy, or torch tensors of any device) to 0x112
    bytes: V2 records, dense, cpu context, as upstream's ``mx.nd.save``
    writes them.  A 0-dim array raises: ndim 0 is the format's "none"
    record, which has no data."""
    out = [struct.pack("<QQQ", MAGIC, 0, len(arrays))]
    for a in arrays:
        if a.ndim == 0:
            raise ValueError("a 0-dim array has no record in the 0x112 "
                             "format; reshape it to (1,)")
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            shape, flag = tuple(a.shape), _BF16_FLAG
            raw = a.detach().cpu().contiguous().view(torch.int16).numpy()
        else:
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            a = onp.ascontiguousarray(a)
            shape, flag, raw = a.shape, _FLAG_OF[a.dtype], a
        out.append(struct.pack(f"<IiI{len(shape)}q", _V2, 0, len(shape),
                               *shape))
        out.append(struct.pack("<iii", 1, 0, flag))   # cpu(0), type flag
        out.append(raw.tobytes())
    out.append(struct.pack("<Q", len(names)))
    for name in names:
        b = name.encode()
        out.append(struct.pack("<Q", len(b)) + b)
    return b"".join(out)
