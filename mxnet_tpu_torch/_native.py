"""The port's host library: RecordIO, CSV, LibSVM and the JPEG image
pipeline in C++ (counterpart of `mxnet_tpu/_native/__init__.py`).

The sources are the port's own copies, `csrc/host/*.cc`.  They are
compiled by ``g++`` (host code: no ``nvcc``) at first use, never at
import, into ``build/host/`` at the root of the checkout, under a name
keyed by a hash of the sources and the flags, as `ops._build` does for
the CUDA kernels: ``host`` from ``recordio.cc``, ``csv.cc`` and
``libsvm.cc``, and ``img`` from ``image_pipeline.cc`` linked with
``-ljpeg``.  Unlike the reference there is no pure-Python fallback: a
build or load failure raises with the compiler's message.
`jpeg_unavailable` says, without building the pipeline, whether this
machine can link libjpeg, so that a caller can decide in code what to
run where it cannot.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as onp

__all__ = ["BUILD_DIR", "SRC", "lib", "img_lib", "jpeg_unavailable",
           "NativeRecordReader", "NativeRecordWriter", "parse_libsvm",
           "parse_csv"]

SRC = Path(__file__).resolve().parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# library -> (its sources, extra link flags)
_LIBS = {"host": (("csv.cc", "libsvm.cc", "recordio.cc"), ()),
         "img": (("image_pipeline.cc",), ("-ljpeg", "-pthread"))}

_lock = threading.Lock()
_loaded = {}


def build(name):
    """Path of the shared library ``name`` (a key of `_LIBS`), compiled
    if no library of these sources and flags exists yet; raises
    ``RuntimeError`` with the compiler's message on failure."""
    srcs, extra = _LIBS[name]
    paths = [SRC / s for s in srcs]
    flags = GXX_FLAGS + extra
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in paths) +
                            " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a per-process temporary, renamed into place: a concurrent process
    # never loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), *map(str, paths), *extra]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the host library {name!r} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(name, declare):
    with _lock:
        L = _loaded.get(name)
        if L is None:
            L = ctypes.CDLL(str(build(name)))
            declare(L)
            _loaded[name] = L
        return L


_JPEG_PROBE = """#include <cstdio>
#include <jpeglib.h>
int main() { jpeg_error_mgr e; jpeg_std_error(&e); return 0; }
"""


def jpeg_unavailable():
    """None where ``g++`` finds ``jpeglib.h`` and links ``-ljpeg`` (the
    image pipeline can be built), else the compiler's message.  The
    probe program is built in ``build/host/`` and removed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"jpeg-probe-{os.getpid()}.cc"
    exe = src.with_suffix("")
    src.write_text(_JPEG_PROBE)
    try:
        proc = subprocess.run(["g++", str(src), "-o", str(exe), "-ljpeg"],
                              capture_output=True, text=True)
    finally:
        for f in (src, exe):
            f.unlink(missing_ok=True)
    if proc.returncode == 0:
        return None
    return proc.stderr.strip() or f"g++ exit {proc.returncode}"


_P, _I, _I64, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint64)
_BYTES = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
_F32P = ctypes.POINTER(ctypes.c_float)


def _declare_host(L):
    L.rio_last_error.restype = ctypes.c_char_p
    L.rio_open_reader.restype = _P
    L.rio_open_reader.argtypes = [ctypes.c_char_p]
    L.rio_close_reader.argtypes = [_P]
    L.rio_num_records.restype = _I64
    L.rio_num_records.argtypes = [_P]
    L.rio_read_record.restype = _I
    L.rio_read_record.argtypes = [_P, _I64, _BYTES,
                                  ctypes.POINTER(ctypes.c_uint64)]
    L.rio_read_at.restype = _I
    L.rio_read_at.argtypes = [_P, _U64, _BYTES,
                              ctypes.POINTER(ctypes.c_uint64)]
    L.rio_next_record.restype = _I
    L.rio_next_record.argtypes = [_P, _BYTES,
                                  ctypes.POINTER(ctypes.c_uint64)]
    L.rio_reset.argtypes = [_P]
    L.rio_record_offset.restype = _U64
    L.rio_record_offset.argtypes = [_P, _I64]
    L.rio_seek.restype = _I
    L.rio_seek.argtypes = [_P, _U64]
    L.rio_reader_tell.restype = _U64
    L.rio_reader_tell.argtypes = [_P]
    L.rio_open_writer.restype = _P
    L.rio_open_writer.argtypes = [ctypes.c_char_p, _I]
    L.rio_writer_tell.restype = _I64
    L.rio_writer_tell.argtypes = [_P]
    L.rio_write_record.restype = _I
    L.rio_write_record.argtypes = [_P, ctypes.c_char_p, _U64]
    L.rio_close_writer.argtypes = [_P]
    L.lsvm_last_error.restype = ctypes.c_char_p
    L.lsvm_open.restype = _P
    L.lsvm_open.argtypes = [ctypes.c_char_p]
    L.lsvm_close.argtypes = [_P]
    L.lsvm_num_rows.restype = _I64
    L.lsvm_num_rows.argtypes = [_P]
    L.lsvm_nnz.restype = _I64
    L.lsvm_nnz.argtypes = [_P]
    L.lsvm_max_index.restype = ctypes.c_int32
    L.lsvm_max_index.argtypes = [_P]
    L.lsvm_copy.argtypes = [_P, _F32P, ctypes.POINTER(ctypes.c_int64),
                            ctypes.POINTER(ctypes.c_int32), _F32P]
    L.csv_last_error.restype = ctypes.c_char_p
    L.csv_open.restype = _P
    L.csv_open.argtypes = [ctypes.c_char_p]
    L.csv_close.argtypes = [_P]
    L.csv_rows.restype = _I64
    L.csv_rows.argtypes = [_P]
    L.csv_cols.restype = _I64
    L.csv_cols.argtypes = [_P]
    L.csv_copy.argtypes = [_P, _F32P]


def _declare_img(L):
    L.imgpipe_last_error.restype = ctypes.c_char_p
    L.imgpipe_create.restype = _P
    L.imgpipe_create.argtypes = [ctypes.c_char_p] + [_I] * 9 + \
        [ctypes.c_uint64, _I, _I]
    L.imgpipe_num_records.restype = _I64
    L.imgpipe_num_records.argtypes = [_P]
    L.imgpipe_part_records.restype = _I64
    L.imgpipe_part_records.argtypes = [_P]
    L.imgpipe_ready_batches.restype = _I
    L.imgpipe_ready_batches.argtypes = [_P]
    L.imgpipe_decode_errors.restype = _I64
    L.imgpipe_decode_errors.argtypes = [_P]
    L.imgpipe_next.restype = _I
    L.imgpipe_next.argtypes = [_P, ctypes.POINTER(ctypes.c_uint8), _F32P]
    L.imgpipe_destroy.argtypes = [_P]


def lib():
    """The RecordIO / CSV / LibSVM library, built and loaded once."""
    return _load("host", _declare_host)


def img_lib():
    """The JPEG image pipeline's library, built and loaded once."""
    return _load("img", _declare_img)


def _out_bytes(fn, *args):
    data = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64()
    rc = fn(*args, ctypes.byref(data), ctypes.byref(n))
    return rc, (ctypes.string_at(data, n.value) if rc == 0 else None)


class NativeRecordReader:
    """Indexed, zero-copy reader over the memory-mapped file."""

    def __init__(self, path):
        self._lib = lib()
        self._h = self._lib.rio_open_reader(os.fsencode(path))
        if not self._h:
            raise IOError(self._lib.rio_last_error().decode())

    def _error(self):
        return IOError(self._lib.rio_last_error().decode())

    def __len__(self):
        return self._lib.rio_num_records(self._h)

    def read(self, i):
        rc, buf = _out_bytes(self._lib.rio_read_record, self._h, i)
        if rc != 0:
            raise self._error()
        return buf

    def read_at(self, offset):
        rc, buf = _out_bytes(self._lib.rio_read_at, self._h,
                             offset)
        if rc != 0:
            raise self._error()
        return buf

    def next(self):
        """The next record, or None at the end (a truncated trailing
        record ends the stream too)."""
        rc, buf = _out_bytes(self._lib.rio_next_record, self._h)
        if rc == -1:
            return None
        if rc < -1:
            raise self._error()
        return buf

    def reset(self):
        self._lib.rio_reset(self._h)

    def seek_offset(self, offset):
        """Put the sequential cursor at the record starting at byte
        ``offset`` (as .idx files store it)."""
        if self._lib.rio_seek(self._h, offset) != 0:
            raise self._error()

    def tell(self):
        """Byte offset of the next sequential record."""
        return self._lib.rio_reader_tell(self._h)

    def offset(self, i):
        return self._lib.rio_record_offset(self._h, i)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.rio_close_reader(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeRecordWriter:
    def __init__(self, path, append=False):
        self._lib = lib()
        self._h = self._lib.rio_open_writer(os.fsencode(path),
                                            1 if append else 0)
        if not self._h:
            raise IOError(self._lib.rio_last_error().decode())

    def tell(self):
        return self._lib.rio_writer_tell(self._h)

    def write(self, buf):
        if self._lib.rio_write_record(self._h, bytes(buf), len(buf)) != 0:
            raise IOError(self._lib.rio_last_error().decode())

    def close(self):
        if getattr(self, "_h", None):
            self._lib.rio_close_writer(self._h)
            self._h = None

    def __del__(self):
        self.close()


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_libsvm(path):
    """A LibSVM file as numpy ``(labels, indptr, indices, values,
    num_cols)``; a malformed row raises ``IOError``."""
    L = lib()
    h = L.lsvm_open(os.fsencode(path))
    if not h:
        raise IOError(L.lsvm_last_error().decode())
    try:
        n, nnz = L.lsvm_num_rows(h), L.lsvm_nnz(h)
        labels = onp.empty(n, onp.float32)
        indptr = onp.empty(n + 1, onp.int64)
        indices = onp.empty(nnz, onp.int32)
        values = onp.empty(nnz, onp.float32)
        L.lsvm_copy(h, _ptr(labels, ctypes.c_float),
                    _ptr(indptr, ctypes.c_int64),
                    _ptr(indices, ctypes.c_int32),
                    _ptr(values, ctypes.c_float))
        ncols = int(L.lsvm_max_index(h)) + 1
    finally:
        L.lsvm_close(h)
    return labels, indptr, indices, values, ncols


def parse_csv(path):
    """A numeric CSV file as a float32 (rows, cols) numpy array."""
    L = lib()
    h = L.csv_open(os.fsencode(path))
    if not h:
        raise IOError(L.csv_last_error().decode())
    try:
        out = onp.empty((L.csv_rows(h), L.csv_cols(h)), onp.float32)
        if out.size:
            L.csv_copy(h, _ptr(out, ctypes.c_float))
        return out
    finally:
        L.csv_close(h)
