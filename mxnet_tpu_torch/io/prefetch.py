"""Prefetch to the card (counterpart of `mxnet_tpu/io/prefetch.py`).

A feeder thread pulls host batches from a source and copies them to the
card while the card runs the previous steps, so a step waits for
``max(feed, compute)`` rather than their sum.  On a CUDA device:

- the feeder writes each batch into one of ``depth`` pinned host slots
  (a ring) and copies it to newly allocated device tensors on a stream
  of its own, with ``non_blocking=True``, then records an event there;
- a slot is written again only after the event of the copy that last
  read it has completed (the feeder waits on it, no one else);
- the consumer's ``next`` makes its current stream wait on the batch's
  event (``wait_event``) and marks the tensors as used on that stream
  (``record_stream``), so the caching allocator never hands their memory
  out again while a step may still read it.  No host sync on the
  consumer's side: a CUDA graph replay (`gluon.FusedTrainStep`) copies
  the batch into its static inputs on the same stream, after the wait.

``dtypes=`` casts on the host, before the copy, as the reference does.
On the CPU (``ctx=cpu()``) it is a plain ordered queue of CPU tensors.
The reference's ``sharding=`` (per-device global batches over a mesh)
is ROADMAP queue A item A7d and raises.  As in the reference, the counts
are published to the telemetry registry (``mxtpu_prefetch_batches_total``,
the ``mxtpu_prefetch_ring_occupancy`` gauge and the
``mxtpu_prefetch_wait_seconds`` histogram), and the feeder polls
``faultline`` at ``data.iterator`` before each pull (an injected fault
reaches the consumer as the exception); ``stats()`` returns this
prefetcher's own counts.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as onp
import torch

from ..context import resolve_device
from ..env import prefetch_depth
from .io import DataBatch, DataIter

__all__ = ["DevicePrefetcher"]

_STOP = object()


def _prefetch_metrics():
    from .. import telemetry as _tm

    return (
        _tm.counter("mxtpu_prefetch_batches_total",
                    "Batches delivered by DevicePrefetcher"),
        _tm.gauge("mxtpu_prefetch_ring_occupancy",
                  "Transferred batches queued ahead of the consumer at "
                  "the last pop (0 while compute waits = feed-bound)"),
        _tm.histogram("mxtpu_prefetch_wait_seconds",
                      "Consumer wait for the next device-resident batch"),
    )


def _host_array(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return onp.asarray(a)


class _Slot:
    """One pinned host buffer per array of a batch, and the event of the
    copy that last read them."""

    def __init__(self):
        self.bufs = []
        self.event = None

    def fill(self, arrays):
        if len(self.bufs) != len(arrays) or any(
                tuple(b.shape) != a.shape or b.numpy().dtype != a.dtype
                for b, a in zip(self.bufs, arrays)):
            self.bufs = [torch.from_numpy(onp.empty_like(a)).pin_memory()
                         for a in arrays]
        for b, a in zip(self.bufs, arrays):
            b.numpy()[...] = a
        return self.bufs


class DevicePrefetcher:
    """Overlap host batch production and the host-to-card copy with the
    card's compute.

    Parameters
    ----------
    source : iterator, DataIter or callable
        Yields tuples of host arrays (numpy or CPU tensors).  A
        ``DataIter`` is read through ``next_arrays()`` where it has one,
        else ``next()`` (its data, then its labels).  A callable is
        called once a batch.
    ctx : device, optional
        Where the batches go (default: the card, `context.gpu`).
    depth : int, optional
        Batches in flight ahead of the consumer, and pinned slots
        (default `env.prefetch_depth`).
    dtypes : tuple, optional
        A dtype (or None) per array, cast on the host before the copy.

    Iteration yields tuples of tensors on ``ctx``.  StopIteration from
    the source ends the stream; ``reset()`` rearms it (the source must
    have ``reset``), ``close()`` ends the feeder.  As a context manager
    the feeder never outlives an exception in the consuming loop.
    """

    def __init__(self, source, ctx=None, depth=None, dtypes=None,
                 sharding=None):
        if sharding is not None:
            raise NotImplementedError(
                "DevicePrefetcher(sharding=...) builds batches over a mesh: "
                "ROADMAP queue A item A7d (distribution) in the port")
        self._device = resolve_device(ctx)
        self._cuda = self._device.type == "cuda"
        self._depth = max(1, int(depth if depth is not None
                                 else prefetch_depth()))
        self._dtypes = dtypes
        self._source = source
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._slots = [_Slot() for _ in range(self._depth)]
        self._next_slot = 0
        self.batches = 0
        self.wait_seconds = 0.0
        self.slot_waits = 0
        self._batch_ctr, self._ring_gauge, self._wait_hist = \
            _prefetch_metrics()
        self._start()

    def stats(self):
        """Batches delivered, the seconds the consumer waited for them in
        all, and the feeder's waits for a pinned slot's copy."""
        return {"batches": self.batches, "wait_seconds": self.wait_seconds,
                "slot_waits": self.slot_waits}

    # -- the feeder ----------------------------------------------------------
    def _pull(self):
        from ..resilience import faultline as _faultline

        _faultline.check("data.iterator")
        src = self._source
        if isinstance(src, DataIter):
            if hasattr(src, "next_arrays"):
                return src.next_arrays()
            batch = src.next()
            return tuple(batch.data) + tuple(batch.label)
        if callable(src):
            return src()
        return next(src)

    def _to_device(self, arrays):
        """The batch on the card: pinned slot, copy on the side stream,
        event (see the module's docstring)."""
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot.event is not None and not slot.event.query():
            self.slot_waits += 1
            slot.event.synchronize()
        bufs = slot.fill(arrays)
        with torch.cuda.stream(self._stream):
            out = tuple(b.to(self._device, non_blocking=True) for b in bufs)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        return out, event

    def _feed(self, q, stop):
        while not stop.is_set():
            # the whole batch's production is under one handler: a failed
            # cast or copy reaches the consumer as the exception
            try:
                arrays = tuple(_host_array(a) for a in self._pull())
                if self._dtypes is not None:
                    arrays = tuple(
                        a if dt is None else onp.asarray(a, dtype=dt)
                        for a, dt in zip(arrays, self._dtypes))
                if self._cuda:
                    item = self._to_device(arrays)
                else:
                    item = (tuple(torch.from_numpy(onp.array(a))
                                  for a in arrays), None)
            except StopIteration:
                q.put(_STOP)
                return
            except Exception as exc:  # re-raised in the consumer's next
                q.put(exc)
                return
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def _start(self):
        self._q = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._feed, args=(self._q, self._stop), daemon=True,
            name="mxnet-device-prefetch")
        self._thread.start()

    # -- the consumer --------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                # the feeder ended without a sentinel (close() raced us):
                # never block forever on a dead stream
                if self._thread is None or not self._thread.is_alive():
                    self._done = True
                    raise StopIteration from None
        if item is _STOP:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        waited = time.perf_counter() - t0
        self.wait_seconds += waited
        self.batches += 1
        self._wait_hist.observe(waited)
        self._batch_ctr.inc()
        self._ring_gauge.set(self._q.qsize())
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    next = __next__

    def next_batch(self):
        """One batch as a `DataBatch`: every array but the last is data,
        the last the label."""
        arrays = self.__next__()
        return DataBatch(data=list(arrays[:-1]), label=[arrays[-1]], pad=0)

    def reset(self):
        """End the feeder, reset the source, start again."""
        self.close()
        if hasattr(self._source, "reset"):
            self._source.reset()
        self._start()

    def close(self):
        stop, thread = getattr(self, "_stop", None), \
            getattr(self, "_thread", None)
        if stop is None:
            return
        stop.set()
        # unblock a feeder waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # the feeder may drop the last reference itself, and run __del__
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5)
        self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()
        return False

    def __del__(self):
        self.close()
