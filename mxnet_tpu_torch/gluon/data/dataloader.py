"""DataLoader (counterpart of `mxnet_tpu/gluon/data/dataloader.py`).

Workers produce host batches (numpy, through the batchify function) and
the loader copies each whole batch to ``device`` once.  ``num_workers``
runs a thread pool by default (decode and numpy work release the GIL,
and threads need no pickling); ``thread_pool=False`` runs a ``spawn``
process pool for Python-bound transforms.  With ``prefetch_to_device``
the copies go through `io.DevicePrefetcher` (pinned slots, a side
stream), ``depth`` batches ahead of the consumer.  ``device`` defaults
to the card; the CPU must be asked for.  The reference's ``sharding=``
is ROADMAP queue A item A7d and raises.  Each batch's production is timed
as the ``data-wait`` step phase (`telemetry.step_phase`), as in the
reference.
"""
from __future__ import annotations

import multiprocessing
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as onp
import torch

from ...context import resolve_device
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch; a sample that is a tuple or list
    stacks field by field."""
    if isinstance(data[0], torch.Tensor):
        return torch.stack(data)
    if isinstance(data[0], (tuple, list)):
        return [default_batchify_fn(list(i)) for i in zip(*data)]
    return onp.asarray(data)


default_mp_batchify_fn = default_batchify_fn


def _as_device_batch(batch, device):
    if isinstance(batch, (onp.ndarray, torch.Tensor)):
        return torch.as_tensor(batch).to(device)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_as_device_batch(b, device) for b in batch)
    return batch


def _flatten(batch, leaves):
    """The array leaves of a nested list/tuple batch, appended to
    ``leaves`` in order; returns the batch's structure."""
    if isinstance(batch, (list, tuple)):
        return type(batch), [_flatten(b, leaves) for b in batch]
    leaves.append(batch)
    return None


def _unflatten(structure, leaves):
    if structure is None:
        return next(leaves)
    kind, children = structure
    return kind(_unflatten(c, leaves) for c in children)


def _prefetched_device_batches(host_batches, device, depth):
    """Host batches through `io.DevicePrefetcher`: each is flattened to a
    tuple of arrays for it and rebuilt in order on the way out.  The
    ``with`` block ends the feeder if the consuming loop raises."""
    from ...io.prefetch import DevicePrefetcher

    structures = deque()

    def leaves():
        for b in host_batches:
            flat = []
            structures.append(_flatten(b, flat))
            yield tuple(flat)

    with DevicePrefetcher(leaves(), ctx=device, depth=depth) as pf:
        for arrays in pf:
            yield _unflatten(structures.popleft(), iter(arrays))


def _timed(inner):
    """``inner``'s batches, each one's production timed as the
    ``data-wait`` step phase (as the reference's DataLoader does): with
    enough workers or prefetch it collapses toward zero; a fat span
    means the input pipeline, not the card, bounds the step.  The
    exhausted probe at the end is not a batch wait and is discarded."""
    from ... import telemetry as _telemetry

    while True:
        phase = _telemetry.step_phase("data-wait")
        phase.__enter__()
        try:
            batch = next(inner)
        except StopIteration:
            return
        phase.__exit__(None, None, None)
        yield batch


class _Worker:
    """Top-level callable, so that it pickles for a process pool."""

    def __init__(self, dataset, batchify_fn):
        self.dataset = dataset
        self.batchify_fn = batchify_fn

    def __call__(self, indices):
        return self.batchify_fn([self.dataset[i] for i in indices])


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=True, timeout=120,
                 try_nopython=None, device=None, prefetch_to_device=False,
                 sharding=None):
        if sharding is not None:
            raise NotImplementedError(
                "DataLoader(sharding=...) builds batches over a mesh: "
                "ROADMAP queue A item A7d (distribution) in the port")
        self._dataset = dataset
        self._device = resolve_device(device)
        # an int is the prefetcher's depth; True takes env.prefetch_depth
        self._prefetch_to_device = prefetch_to_device
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None or
              last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._timeout = timeout
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._worker = _Worker(dataset, self._batchify_fn)
        self._pool = None

    def _get_pool(self):
        if self._pool is None and self._num_workers > 0:
            if self._thread_pool:
                self._pool = ThreadPoolExecutor(self._num_workers)
            else:
                ctx = multiprocessing.get_context("spawn")
                self._pool = ctx.Pool(self._num_workers)
        return self._pool

    def __iter__(self):
        if self._prefetch_to_device:
            depth = (None if self._prefetch_to_device is True
                     else int(self._prefetch_to_device))
            inner = _prefetched_device_batches(self._host_batches(),
                                               self._device, depth)
        else:
            inner = (_as_device_batch(b, self._device)
                     for b in self._host_batches())
        return _timed(inner)

    def _host_batches(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._worker(indices)
            return

        pool = self._get_pool()
        pending = deque()
        max_inflight = self._num_workers + self._prefetch

        def submit(indices):
            if self._thread_pool:
                return pool.submit(self._worker, indices)
            return pool.apply_async(self._worker, (indices,))

        def result(fut):
            return (fut.result(self._timeout) if self._thread_pool
                    else fut.get(self._timeout))

        try:
            for indices in self._batch_sampler:
                pending.append(submit(indices))
                if len(pending) >= max_inflight:
                    yield result(pending.popleft())
            while pending:
                yield result(pending.popleft())
        finally:
            if self._thread_pool:
                for fut in pending:
                    fut.cancel()

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """End the worker pool."""
        if getattr(self, "_pool", None) is not None:
            if self._thread_pool:
                self._pool.shutdown(wait=False)
            else:
                self._pool.terminate()
            self._pool = None

    def __del__(self):
        self.close()
