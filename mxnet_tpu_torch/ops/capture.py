"""CUDA graphs for the one-dispatch paths: `gluon.FusedTrainStep`'s
step and `serve.ExecutableCache`'s buckets.

The reference compiles a training step, or a serving bucket's forward,
into one XLA program that the host dispatches once.  The port captures
the same work into a ``torch.cuda.CUDAGraph`` and replays it: one launch
of the host for the whole step.

- `Graph` captures a function once and replays it.  A capture launches
  nothing, so the launch counters of the kernels it captured
  (`_build.KERNELS`) are set back, and each replay adds them: a replayed
  step counts its kernels as an eager step does.  That is bookkeeping,
  since a replay runs no wrapper: what a replay launched on the card is
  counted from a profiler trace of it.  Captures run on
  torch's side stream with ``capture_error_mode="thread_local"``, and
  under `GRAPH_LOCK`, which replays also take, so that a capture from
  one thread (a model swap warming its buckets) never overlaps a live
  replay on another.
- `upload` stages host values (an eager step's seed words and optimizer
  scalars) onto the card through a pinned buffer, without a sync.
  `HostRing` does the same into a replay's static buffer, from pinned
  host buffers taken in turn: a buffer is rewritten only after the copy
  that last read it has run, so a replay never reads a later step's
  values.
- `capturable` says where graphs are used: on a CUDA device.  On the
  CPU the same paths run eagerly.
- `add_capture_listener` registers a function that each capture calls
  with its host seconds (`telemetry.install_compile_listener` counts
  captures through it).
"""
from __future__ import annotations

import threading
import time

import torch

from ._build import launch_counts

__all__ = ["GRAPH_LOCK", "Graph", "HostRing", "add_capture_listener",
           "capturable", "new_pool", "upload"]

GRAPH_LOCK = threading.RLock()
_capture_listeners = []


def add_capture_listener(fn):
    """Call ``fn(seconds)`` after every capture, with its host time."""
    _capture_listeners.append(fn)


def capturable(device):
    """Whether work on ``device`` is captured into CUDA graphs."""
    return torch.device(device).type == "cuda"


def upload(host, device):
    """``host`` (a numpy array) as a new tensor on ``device``: on the card
    through a fresh pinned buffer, without a sync (torch's pinned
    allocator keeps the buffer until the copy has run)."""
    t = torch.from_numpy(host)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def new_pool():
    """A memory pool that graphs which never replay at once may share."""
    return torch.cuda.graph_pool_handle()


class Graph:
    """One captured CUDA graph on ``device``.  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) lets graphs that never replay
    concurrently share their memory; ``launches`` holds the kernel
    launches the capture recorded, ``replays`` counts the replays."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        self.pool = pool
        self.launches = {}
        self.replays = 0
        self._graph = None

    def capture(self, fn):
        """Capture ``fn()`` and return what it returns (tensors in the
        graph's memory, rewritten by each replay).  A failure raises."""
        with GRAPH_LOCK:
            before = launch_counts()
            t0 = time.perf_counter()
            try:
                out = self._record(fn)
            finally:
                after = launch_counts()
                self.launches = {k: after[k] - n for k, n in before.items()
                                 if after[k] != n}
                for k, n in self.launches.items():
                    k.launches -= n
        for listener in _capture_listeners:
            listener(time.perf_counter() - t0)
        return out

    def replay(self):
        """Launch the captured work on the current stream."""
        with GRAPH_LOCK:
            self._launch()
            for k, n in self.launches.items():
                k.launches += n
            self.replays += 1

    def _record(self, fn):
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(
                self._graph, pool=self.pool,
                capture_error_mode="thread_local"):
            return fn()

    def _launch(self):
        self._graph.replay()


class HostRing:
    """``depth`` host buffers of ``n`` int32 words (pinned on the card),
    taken in turn by `upload`.  ``waits`` counts the uploads that had to
    wait for the copy that last read their buffer."""

    def __init__(self, n, device, depth=3):
        self.device = torch.device(device)
        pinned = self.device.type == "cuda"
        self._bufs = [torch.zeros(n, dtype=torch.int32, pin_memory=pinned)
                      for _ in range(depth)]
        self._events = [None] * depth
        self._next = 0
        self.waits = 0

    def upload(self, words, dest):
        """Write ``words`` (n int32 values) into the next buffer and copy
        it into ``dest`` (n int32 on the device) on the current stream,
        without a sync."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        event = self._events[i]
        if event is not None and not event.query():
            self.waits += 1
            event.synchronize()
        self._bufs[i].numpy()[:] = words
        dest.copy_(self._bufs[i], non_blocking=True)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._events[i] = event
