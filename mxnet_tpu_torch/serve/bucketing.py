"""Shape buckets for the dynamic micro-batcher (counterpart of
`mxnet_tpu/serve/bucketing.py`, which is pure numpy and carried over as
it is).

Serving traffic, left alone, produces an open-ended set of shapes (any
batch size x any sequence length).  On the card every new shape costs a
cold run (cuBLAS heuristics, allocator growth), and a fixed grid is
what a later captured program (a CUDA graph) needs, so the batcher
snaps every dispatched batch onto a small, pre-declared grid:

* **batch buckets** — powers of two up to ``max_batch_size`` (or an
  explicit user list).  A batch of 5 requests runs as a padded batch
  of 8; rows past the real payload are zero and sliced off after.
* **sequence buckets** — an optional per-endpoint list of lengths for
  one designated axis (``seq_axis``, default 1).  Requests whose
  sequence axes snap to the same bucket share an executable.  Sequence
  padding changes what the model *sees*, so it is only admissible for
  models that mask padding (the standard transformer contract); batch
  padding is always value-preserving because no op mixes rows in
  predict mode.

The grid size is the product ``len(batch_buckets) x len(seq_buckets)``
— that is the number of executables ``warmup()`` precompiles and the
steady-state ceiling on retraces.
"""
from __future__ import annotations

import numpy as onp

__all__ = ["pow2_buckets", "pick_bucket", "BucketSpec"]


def pow2_buckets(max_batch_size):
    """[1, 2, 4, ..., max_batch_size] (the max itself is always a
    bucket, even when not a power of two, so a full batch never pads)."""
    buckets, b = [], 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return buckets


def pick_bucket(n, buckets):
    """Smallest bucket >= n; raises when n exceeds the grid."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


class BucketSpec:
    """The endpoint's shape grid: batch buckets plus optional sequence
    buckets on ``seq_axis``."""

    def __init__(self, max_batch_size, batch_buckets=None, seq_buckets=None,
                 seq_axis=1):
        self.max_batch_size = int(max_batch_size)
        self.batch_buckets = sorted(batch_buckets) if batch_buckets \
            else pow2_buckets(self.max_batch_size)
        if self.batch_buckets[-1] != self.max_batch_size:
            raise ValueError("largest batch bucket must equal max_batch_size")
        self.seq_buckets = sorted(seq_buckets) if seq_buckets else None
        self.seq_axis = seq_axis

    def signature(self, arrays):
        """Group key for one request's (flat) input arrays: the shapes
        they will have after sequence-bucket padding, minus the batch
        dim, plus dtypes.  Requests with equal signatures can share a
        dispatched batch."""
        sig = []
        for a in arrays:
            shape = list(a.shape[1:])
            if self.seq_buckets and a.ndim > self.seq_axis:
                shape[self.seq_axis - 1] = pick_bucket(
                    a.shape[self.seq_axis], self.seq_buckets)
            sig.append((tuple(shape), str(a.dtype)))
        return tuple(sig)

    def pad_concat(self, per_request_arrays, batch_bucket):
        """Concat one input position across requests and pad to the
        bucket grid.  ``per_request_arrays``: the i-th input from each
        request (same signature).  Returns one onp array of shape
        ``(batch_bucket, *sig_shape)``."""
        first = per_request_arrays[0]
        out_shape = [batch_bucket] + list(first.shape[1:])
        if self.seq_buckets and first.ndim > self.seq_axis:
            out_shape[self.seq_axis] = pick_bucket(
                first.shape[self.seq_axis], self.seq_buckets)
        out = onp.zeros(out_shape, dtype=first.dtype)
        row = 0
        for a in per_request_arrays:
            idx = [slice(row, row + a.shape[0])] + \
                [slice(0, s) for s in a.shape[1:]]
            out[tuple(idx)] = a
            row += a.shape[0]
        return out
