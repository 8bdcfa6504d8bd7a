"""Executable cache keyed by bucket shape (counterpart of
`mxnet_tpu/serve/cache.py`).

The reference compiles one XLA executable per ``(input shapes, dtypes,
donate)`` key; the port has no buffer donation, so its key is
``(input shapes, dtypes)``.  PyTorch runs eagerly, so an entry is the
record that the endpoint function has run once at that shape: a
"compile" is a warm run (cuBLAS picks its kernels, the allocator grows
to the bucket's size, the CUDA kernels are built and loaded), and the
cached "executable" is the function itself.  The hit/miss counts keep
their meaning and stay the health metric: a steady-state miss means
traffic reached a shape the grid did not warm, and paid its cold run in
the latency tail.
"""
from __future__ import annotations

import threading

import numpy as onp
import torch

__all__ = ["ExecutableCache"]


class ExecutableCache:
    """Maps ``(input shapes, dtypes)`` -> warmed entry for one
    endpoint function ``fn(*tensors)`` on ``device``."""

    def __init__(self, fn, metrics=None, device=None):
        self._fn = fn
        self._device = device
        self._metrics = metrics
        self._entries = set()
        self._lock = threading.Lock()

    @staticmethod
    def key_for(shapes_dtypes):
        """The entry key for ``[(shape, dtype), ...]`` (numpy or torch
        dtypes)."""
        return tuple((tuple(s), str(_torch_dtype(d))) for s, d in shapes_dtypes)

    def _run(self, tensors):
        out = self._fn(*tensors)
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()
        return out

    def warm(self, shapes_dtypes):
        """Warm one entry from ``[(shape, dtype), ...]`` specs with a run
        on zeros.  Warm runs are not charged to the miss counter — the
        hit rate measures traffic.  Returns True if it ran."""
        key = self.key_for(shapes_dtypes)
        with self._lock:
            if key in self._entries:
                return False
        zeros = [torch.zeros(s, dtype=_torch_dtype(d), device=self._device)
                 for s, d in key]
        self._run(zeros)
        with self._lock:
            self._entries.add(key)
        return True

    def warmed_grid(self):
        """``[shapes_dtypes, ...]`` for every entry, in the form
        ``warm()`` takes: what a successor cache (a new model version)
        replays before the version flip."""
        with self._lock:
            return [list(key) for key in self._entries]

    def adopt_grid(self, other):
        """Warm this cache for every shape ``other`` has served.  Returns
        the number warmed."""
        return sum(self.warm(sig) for sig in other.warmed_grid())

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def __call__(self, tensors):
        """Run the function on ``tensors``, counting a hit when their
        shape was warmed and a miss (which warms it) otherwise."""
        key = self.key_for([(t.shape, t.dtype) for t in tensors])
        with self._lock:
            hit = key in self._entries
            self._entries.add(key)
        if self._metrics is not None:
            self._metrics.incr("cache_hits" if hit else "cache_misses")
        return self._run(tensors)


def _torch_dtype(dtype):
    """torch dtype for a torch dtype, its name, or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype.startswith("torch."):
        return getattr(torch, dtype[len("torch."):])
    return torch.from_numpy(onp.zeros(0, dtype=onp.dtype(dtype))).dtype
