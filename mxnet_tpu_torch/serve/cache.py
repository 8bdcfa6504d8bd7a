"""Executable cache keyed by bucket shape (counterpart of
`mxnet_tpu/serve/cache.py`).

The reference compiles one XLA executable per ``(input shapes, dtypes,
donate)`` key; the port has no buffer donation, so its key is
``(input shapes, dtypes)``.  On a CUDA device an entry is the endpoint
function captured as a CUDA graph at that key (`ops.capture.Graph`),
over static input tensors: a "compile" is one eager run (cuBLAS picks
its kernels, the allocator grows to the bucket's size, the CUDA kernels
are built and loaded) and then the capture.  A call copies the padded
inputs into the static ones, replays the graph (one launch of the host
for the whole forward) and returns copies of the static outputs, which
the next replay overwrites.  The graphs of one cache share one memory
pool; they never replay at once.  On the CPU an entry is the function
itself, run eagerly.  The hit/miss counts keep their meaning and stay
the health metric: a steady-state miss means traffic reached a shape the
grid did not warm, and paid its cold run and capture in the latency
tail.
"""
from __future__ import annotations

import threading

import numpy as onp
import torch

from ..ops import capture
from ..ops.invoke import tracing

__all__ = ["ExecutableCache"]


def _traced(fn):
    def run(*tensors):
        with tracing():
            return fn(*tensors)
    return run


def _tree_map(fn, out):
    if isinstance(out, (tuple, list)):
        return type(out)(_tree_map(fn, o) for o in out)
    if isinstance(out, dict):
        return {k: _tree_map(fn, v) for k, v in out.items()}
    return fn(out) if isinstance(out, torch.Tensor) else out


class _Entry:
    """One key's captured forward: static inputs, graph, static outputs."""

    def __init__(self, fn, tensors, device, pool):
        self.inputs = [t.clone() for t in tensors]
        self.graph = capture.Graph(device, pool=pool)
        self.outputs = self.graph.capture(lambda: fn(*self.inputs))

    def __call__(self, tensors):
        with capture.GRAPH_LOCK:
            for static, t in zip(self.inputs, tensors):
                static.copy_(t)
            self.graph.replay()
            return _tree_map(torch.clone, self.outputs)


class ExecutableCache:
    """Maps ``(input shapes, dtypes)`` -> warmed entry for one
    endpoint function ``fn(*tensors)`` on ``device``."""

    def __init__(self, fn, metrics=None, device=None):
        self._fn = _traced(fn)
        self._device = device
        self._metrics = metrics
        self._entries = {}
        self._lock = threading.Lock()
        self._graphs = device is not None and capture.capturable(device)
        self._pool = None

    @staticmethod
    def key_for(shapes_dtypes):
        """The entry key for ``[(shape, dtype), ...]`` (numpy or torch
        dtypes)."""
        return tuple((tuple(s), str(_torch_dtype(d))) for s, d in shapes_dtypes)

    def _sync(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()

    def _build(self, key, tensors):
        """The entry for ``key``: one eager run of the function on
        ``tensors``, then (on the card) its capture."""
        self._fn(*tensors)
        self._sync()
        if not self._graphs:
            return self._fn
        if self._pool is None:
            self._pool = capture.new_pool()
        return _Entry(self._fn, tensors, self._device, self._pool)

    def _entry(self, key, tensors):
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            entry = self._build(key, tensors)
            with self._lock:
                entry = self._entries.setdefault(key, entry)
        return entry

    def warm(self, shapes_dtypes):
        """Warm one entry from ``[(shape, dtype), ...]`` specs with a run
        on zeros, then capture it.  Warm runs are not charged to the miss
        counter — the hit rate measures traffic.  Returns True if it
        ran."""
        key = self.key_for(shapes_dtypes)
        with self._lock:
            if key in self._entries:
                return False
        self._entry(key, [torch.zeros(s, dtype=_torch_dtype(d),
                                      device=self._device) for s, d in key])
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
        shape was warmed and a miss (which warms it) otherwise.  Returns
        outputs of their own (on the card, copies of the graph's), once
        the device's stream has finished them."""
        key = self.key_for([(t.shape, t.dtype) for t in tensors])
        with self._lock:
            hit = key in self._entries
        if self._metrics is not None:
            self._metrics.incr("cache_hits" if hit else "cache_misses")
        out = self._entry(key, tensors)(tensors) if self._graphs else \
            self._run_eager(key, tensors)
        self._sync()
        return out

    def _run_eager(self, key, tensors):
        with self._lock:
            self._entries.setdefault(key, self._fn)
        return self._fn(*tensors)


def _torch_dtype(dtype):
    """torch dtype for a torch dtype, its name, or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype.startswith("torch."):
        return getattr(torch, dtype[len("torch."):])
    return torch.from_numpy(onp.zeros(0, dtype=onp.dtype(dtype))).dtype
