"""Environment settings of the input pipeline (the three readers of
`mxnet_tpu/env.py` that `io.ImageRecordIter` and `io.DevicePrefetcher`
read).  The rest of the reference's ``env.py`` is ROADMAP queue A
(operations)."""
from __future__ import annotations

import os

__all__ = ["decode_threads", "prefetch_depth", "io_error_tolerance"]


def decode_threads(default=None):
    """Decode threads of the native image pipeline:
    ``MXNET_DECODE_THREADS``, else ``MXNET_CPU_WORKER_NTHREADS``, else
    ``default``, else the CPU count."""
    for name in ("MXNET_DECODE_THREADS", "MXNET_CPU_WORKER_NTHREADS"):
        v = os.environ.get(name)
        if v is not None:
            return max(1, int(v))
    return default if default is not None else (os.cpu_count() or 1)


def prefetch_depth(default=2):
    """Batches `io.DevicePrefetcher` keeps in flight:
    ``MXNET_PREFETCH_DEPTH``."""
    v = os.environ.get("MXNET_PREFETCH_DEPTH")
    if v is None:
        return default
    return max(1, int(v))


def io_error_tolerance(default=0.01):
    """Share of records that may fail to decode in a window before
    `io.ImageRecordIter` warns: ``MXNET_IO_ERROR_TOLERANCE``."""
    v = os.environ.get("MXNET_IO_ERROR_TOLERANCE")
    if v is None:
        return default
    return max(0.0, float(v))
