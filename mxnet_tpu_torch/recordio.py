"""RecordIO files (counterpart of `mxnet_tpu/recordio.py`).

The reference's format, byte for byte: records framed as
``[kMagic:u32][(cflag<<29|len):u32][payload][pad to 4B]`` with
``kMagic = 0xced7230a`` (dmlc/recordio.h), and the `IRHeader` image
header packed as ``[flag:u32][label:f32][id:u64][id2:u64]``.  Reading
and writing go through the port's host library (`_native`, built by
g++ from `csrc/host/recordio.cc` at first use); there is no
pure-Python framing to fall back on.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as onp

from ._native import NativeRecordReader, NativeRecordWriter

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "unpack_img", "pack_img"]

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential RecordIO reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self._reader = None
        self._writer = None
        self.open()

    def open(self):
        if self.flag == "w":
            self._writer = NativeRecordWriter(self.uri)
            self.writable = True
        elif self.flag == "r":
            self._reader = NativeRecordReader(self.uri)
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()

    @property
    def is_open(self):
        return self._reader is not None or self._writer is not None

    def close(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_reader"] = None
        d["_writer"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def _check_pid(self):
        # reopen after fork, as the reference does
        if self.pid != os.getpid():
            self.open()

    def reset(self):
        if self._reader is not None:
            self._reader.reset()
            return
        self.close()
        self.open()

    def tell(self):
        if self._writer is not None:
            return self._writer.tell()
        return self._reader.tell()

    def write(self, buf):
        if not self.writable:
            raise ValueError(f"{self.uri} is open for reading")
        self._check_pid()
        if len(buf) >= (1 << 29):
            raise ValueError(
                "record of %d bytes exceeds the 29-bit recordio frame limit"
                % len(buf))
        self._writer.write(buf)

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        if self.writable:
            raise ValueError(f"{self.uri} is open for writing")
        self._check_pid()
        return self._reader.next()


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a ``key\\toffset`` index file beside it."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.writable and self.is_open:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def seek(self, idx):
        if self.writable:
            raise ValueError(f"{self.uri} is open for writing")
        self._check_pid()
        self._reader.seek_offset(self.idx[idx])

    def read_idx(self, idx):
        # seek then read, so the sequential cursor moves past the record
        # just read (the reference's semantics)
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """``header`` (an `IRHeader`; a label array sets ``flag`` to its
    length) packed in front of the bytes ``s``."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        packed = struct.pack(_IR_FORMAT, 0, header.label, header.id, header.id2)
    else:
        label = onp.asarray(header.label, dtype=onp.float32)
        packed = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                             header.id2) + label.tobytes()
    return packed + s


def unpack(s):
    """``(IRHeader, payload)`` of a packed record."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = onp.frombuffer(s[:header.flag * 4], dtype=onp.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=1):
    """``(IRHeader, image)``: the payload decoded (`image.imdecode`)."""
    from .image import imdecode
    header, s = unpack(s)
    return header, imdecode(s, flag=iscolor)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """``img`` encoded (`image.imencode`) and packed behind ``header``."""
    from .image import imencode
    return pack(header, imencode(img, img_fmt, quality))
