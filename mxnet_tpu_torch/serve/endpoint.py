"""Batched inference endpoint (counterpart of
`mxnet_tpu/serve/endpoint.py`).

The same design as the reference:

* callers ``submit()`` requests into a **bounded queue** (backpressure:
  raise ``QueueFullError`` or block, per config);
* one background **batcher thread** drains the queue, accumulating
  requests until ``max_batch_size`` rows are waiting or the oldest
  request has waited ``max_latency_ms``, then pads/concats compatible
  requests onto the shape-bucket grid (:class:`BucketSpec`) and runs ONE
  forward per group, in predict mode under ``torch.inference_mode()``;
* the :class:`ExecutableCache` counts hits and misses per bucket shape
  (``warmup()`` runs the whole grid once); on the card each warmed
  bucket is a CUDA graph of the forward, replayed once a batch, whose
  outputs are copied out of the graph's buffers before the next batch
  reuses them;
* each request's rows (and sequence positions) are sliced back out of
  the batch and delivered through its own ``Future``; a poisoned request
  fails its own future, never the batch loop (a failed batch is retried
  request by request to isolate the poison).

Around each batch's device call, in the reference's order: the
``serve.model_call`` fault hook (`resilience.faultline.check`), a
``serve/<name>/batch`` span (`telemetry.span`, in a running profiler's
dump), one transient retry (`resilience.policies.retry_transient`), then
the metrics (`EndpointMetrics`, published to the telemetry registry) and
the batch hooks (:meth:`Endpoint.register_batch_hook`, which
`Monitor.install_endpoint` uses).

On the card the batcher thread selects the endpoint's device for its own
CUDA work, and synchronises the device's stream before it stamps a
batch's latency.  Results are torch tensors on the endpoint's device.
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from concurrent.futures import Future

import numpy as onp
import torch

from .. import telemetry as _telemetry
from ..autograd import predict_mode
from ..context import resolve_device
from ..resilience import faultline as _faultline
from ..resilience.policies import retry_transient as _retry_transient
from .bucketing import BucketSpec, pick_bucket
from .cache import ExecutableCache
from .metrics import EndpointMetrics

__all__ = ["Endpoint", "QueueFullError", "RequestTimeout", "EndpointClosed"]


class QueueFullError(RuntimeError):
    """submit() on a full queue under full_policy='raise'."""


class RequestTimeout(RuntimeError):
    """The request's deadline passed before it was dispatched."""


class EndpointClosed(RuntimeError):
    """submit() after shutdown(), or pending at a non-draining shutdown."""


_counter = itertools.count()


class _Request:
    __slots__ = ("arrays", "rows", "seq_len", "future", "t_enqueue",
                 "deadline", "signature", "version")

    def __init__(self, arrays, signature, seq_len, timeout_s):
        self.arrays = arrays
        self.signature = signature
        self.rows = arrays[0].shape[0]
        self.seq_len = seq_len
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline = (self.t_enqueue + timeout_s) if timeout_s else None
        self.version = 0          # model version that admitted the request


class _HookHandle:
    def __init__(self, collection, hook, lock):
        self._collection = collection
        self._hook = hook
        self._lock = lock

    def detach(self):
        # check-then-remove must be atomic: two concurrent detaches of the
        # same hook otherwise race between the `in` and the `remove`
        with self._lock:
            if self._hook in self._collection:
                self._collection.remove(self._hook)


def _tree_map(fn, out):
    if isinstance(out, (tuple, list)):
        return type(out)(_tree_map(fn, o) for o in out)
    if isinstance(out, dict):
        return {k: _tree_map(fn, v) for k, v in out.items()}
    return fn(out)


class Endpoint:
    """Wraps a Gluon block (or any ``fn(*tensors)``) behind a batched
    ``submit``/``predict`` interface.

    Parameters
    ----------
    model : gluon.Block or callable
        A Block runs in predict mode on its current parameters, which
        must lie on ``device``.
    max_batch_size : int
        Row budget per dispatched batch (also the largest batch bucket).
    max_latency_ms : float
        How long the batcher holds the oldest request open for
        batch-mates before dispatching a partial batch.
    batch_buckets, seq_buckets, seq_axis
        The shape grid — see :class:`BucketSpec`.
    max_queue : int
        Bound on queued requests (backpressure depth).
    full_policy : 'raise' | 'block'
        submit() behavior on a full queue.
    timeout_ms : float or None
        Default per-request deadline (None = no deadline).
    donate : bool
        Accepted for the reference's signature, where it donates the
        input buffers to the executable.  Here it changes nothing: a
        call already copies the padded batch into the bucket graph's
        static inputs, so no batch-sized buffer outlives the call
        either way.
    device : torch.device, str or None
        Where batches run.  None is the card (``cuda:0``); pass
        ``"cpu"`` to serve on the CPU.

    Models are **versioned**: :meth:`swap_model` stages a new version's
    grid off the hot path, then flips atomically.  Every request is
    pinned at submit() to the version that admitted it; a retired
    version is dropped once its last in-flight request resolves.
    """

    def __init__(self, model, name=None, max_batch_size=8,
                 max_latency_ms=5.0, batch_buckets=None, seq_buckets=None,
                 seq_axis=1, max_queue=256, full_policy="raise",
                 timeout_ms=None, donate=False, device=None, start=True):
        if full_policy not in ("raise", "block"):
            raise ValueError("full_policy must be 'raise' or 'block'")
        self.device = resolve_device(device)
        self.model = model
        self.name = name or f"{type(model).__name__}_{next(_counter)}"
        self.spec = BucketSpec(max_batch_size, batch_buckets=batch_buckets,
                               seq_buckets=seq_buckets, seq_axis=seq_axis)
        self.max_latency_s = max_latency_ms / 1e3
        self.full_policy = full_policy
        self.timeout_s = timeout_ms / 1e3 if timeout_ms else None
        self.donate = donate
        self.metrics = EndpointMetrics(self.name)
        self._queue = _queue.Queue(maxsize=max_queue)
        self._version = 0
        self._models = {0: model}     # version -> model
        self._caches = {}             # version -> ExecutableCache (lazy)
        self._inflight = {}           # version -> unresolved request count
        self._example_arrays = None   # first-seen inputs (swap staging)
        self._model_lock = threading.Lock()
        self._batch_hooks = []
        self._closed = False
        self._draining = False
        self._holdover = None     # request that would overflow its batch
        self._worker = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._worker is None or not self._worker.is_alive():
            self._closed = False
            self._worker = threading.Thread(
                target=self._run, name=f"serve:{self.name}", daemon=True)
            self._worker.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Stop the batcher.  ``drain=True`` serves everything already
        queued first; ``drain=False`` fails queued requests with
        :class:`EndpointClosed`."""
        if self._closed:
            return
        self._draining = drain
        alive = self._worker is not None and self._worker.is_alive()
        if not alive and drain and not self._queue.empty():
            self.start()              # serve the backlog before closing
            alive = True
        self._closed = True
        self._queue.put(None)         # wake + terminate the worker
        if alive:
            self._worker.join(timeout=timeout)
        else:
            self._fail_pending()      # no worker: refuse synchronously

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- request intake ----------------------------------------------------
    @staticmethod
    def _to_numpy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return onp.asarray(x)

    def submit(self, *inputs, timeout_ms=None):
        """Enqueue one request; axis 0 of every input is its batch axis.
        Returns a ``concurrent.futures.Future`` resolving to the model
        output with exactly the submitted rows (padding sliced away)."""
        if self._closed:
            raise EndpointClosed(f"endpoint {self.name} is shut down")
        if not inputs:
            raise ValueError("submit() needs at least one input array")
        arrays = [self._to_numpy(x) for x in inputs]
        rows = arrays[0].shape[0] if arrays[0].ndim else 0
        if rows < 1:
            raise ValueError("inputs must have a leading batch axis >= 1")
        if rows > self.spec.max_batch_size:
            raise ValueError(
                f"request rows {rows} > max_batch_size "
                f"{self.spec.max_batch_size}; split the request")
        for a in arrays:
            if a.ndim < 1 or a.shape[0] != rows:
                raise ValueError("all inputs must share the batch axis size")
        signature = self.spec.signature(arrays)   # raises off-grid seq len
        seq_len = None
        if self.spec.seq_buckets:
            for a in arrays:
                if a.ndim > self.spec.seq_axis:
                    seq_len = a.shape[self.spec.seq_axis]
                    break
        timeout_s = (timeout_ms / 1e3) if timeout_ms is not None \
            else self.timeout_s
        req = _Request(arrays, signature, seq_len, timeout_s)
        with self._model_lock:
            req.version = self._version
            self._inflight[req.version] = \
                self._inflight.get(req.version, 0) + 1
        try:
            self._queue.put(req, block=self.full_policy == "block")
        except _queue.Full:
            self._retire(req)
            self.metrics.incr("rejected_full")
            raise QueueFullError(
                f"endpoint {self.name}: queue full "
                f"({self._queue.maxsize} pending)") from None
        self.metrics.incr("submitted")
        self.metrics.set_queue_depth(self._queue.qsize())
        return req.future

    def predict(self, *inputs, timeout_ms=None):
        """Blocking submit: returns the model output for this request."""
        fut = self.submit(*inputs, timeout_ms=timeout_ms)
        t = (timeout_ms / 1e3 if timeout_ms is not None else self.timeout_s)
        return fut.result(timeout=t + 60 if t else None)

    def register_batch_hook(self, hook):
        """``hook(endpoint, real_rows, bucket_rows, latency_s)`` after
        every dispatched batch (monitor integration)."""
        with self._model_lock:
            self._batch_hooks.append(hook)
        return _HookHandle(self._batch_hooks, hook, self._model_lock)

    # -- model -> function -------------------------------------------------
    def _build_cache(self, model):
        """The endpoint function and its :class:`ExecutableCache`: a
        Block runs in predict mode under ``torch.inference_mode()``."""
        from ..gluon.block import Block

        if isinstance(model, Block):
            for name, p in model.collect_params().items():
                if p.device is not None and p.device != self.device:
                    raise ValueError(
                        f"parameter {name} lies on {p.device}, the "
                        f"endpoint serves on {self.device}")

        def fn(*tensors):
            with torch.inference_mode(), predict_mode():
                return model(*tensors)

        return ExecutableCache(fn, metrics=self.metrics, device=self.device)

    def _cache_for(self, version, arrays=None):
        """The executable cache serving ``version``, built lazily;
        ``arrays`` (a request's or warmup's inputs) become the staging
        example if none was seen yet."""
        with self._model_lock:
            if self._example_arrays is None and arrays is not None:
                self._example_arrays = [onp.asarray(a) for a in arrays]
            cache = self._caches.get(version)
            if cache is None:
                cache = self._caches[version] = self._build_cache(
                    self._models[version])
            return cache

    def _retire(self, req):
        """One request resolved: drop its version once it was both
        retired (swap happened) and fully drained."""
        with self._model_lock:
            v = req.version
            n = self._inflight.get(v, 1) - 1
            if n > 0:
                self._inflight[v] = n
                return
            self._inflight.pop(v, None)
            if v != self._version:
                self._caches.pop(v, None)
                self._models.pop(v, None)

    def swap_model(self, model, stage=True):
        """Hot-swap to a new model version.

        Stages the new version's cache over the live cache's grid first
        (on the card: an eager run and a capture per bucket, on torch's
        capture stream in thread-local mode and under
        `ops.capture.GRAPH_LOCK`, so the live version's replays go on
        around it), then flips the version atomically.  Requests already
        admitted keep the version that admitted them; requests submitted
        after the flip get ``model``.  Returns the new version number.
        ``stage=False`` captures nothing before the flip: the first
        request of each shape after it pays the eager run and the
        capture, and counts a cache miss."""
        staged = None
        with self._model_lock:
            live_cache = self._caches.get(self._version)
            example = self._example_arrays
        if stage and live_cache is not None and example is not None:
            staged = self._build_cache(model)
            staged.adopt_grid(live_cache)
        with self._model_lock:
            self._version += 1
            v = self._version
            self._models[v] = model
            if staged is not None:
                self._caches[v] = staged
            self.model = model
            for old in [u for u in self._models
                        if u != v and not self._inflight.get(u)]:
                self._models.pop(old, None)
                self._caches.pop(old, None)
        return v

    def warmup(self, *example_inputs):
        """Run the full bucket grid once for this input signature: every
        batch bucket x every sequence bucket.  ``example_inputs`` fix the
        per-input trailing shapes and dtypes (their batch/seq extents are
        ignored).  Returns the number of entries warmed."""
        arrays = [self._to_numpy(x) for x in example_inputs]
        cache = self._cache_for(self._version, arrays)
        warmed = 0
        seq_grid = self.spec.seq_buckets or [None]
        for b in self.spec.batch_buckets:
            for s in seq_grid:
                shapes = []
                for a in arrays:
                    shape = [b] + list(a.shape[1:])
                    if s is not None and a.ndim > self.spec.seq_axis:
                        shape[self.spec.seq_axis] = s
                    shapes.append((tuple(shape), a.dtype))
                warmed += cache.warm(shapes)
        return warmed

    def stats(self):
        out = self.metrics.stats()
        out["queue_depth"] = self._queue.qsize()
        with self._model_lock:
            out["executables"] = sum(len(c) for c in self._caches.values())
            out["model_version"] = self._version
        return out

    # -- the batcher loop --------------------------------------------------
    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        saw_sentinel = False
        while not saw_sentinel:
            if self._holdover is not None:
                item, self._holdover = self._holdover, None
            else:
                try:
                    item = self._queue.get(timeout=0.1)
                except _queue.Empty:
                    continue
            if item is None:          # shutdown sentinel
                saw_sentinel = True
            else:
                saw_sentinel = self._accumulate(item)
        if self._draining:
            self._drain_rest()
        else:
            self._fail_pending()

    def _accumulate(self, first):
        """Hold the oldest request open for up to max_latency_ms while
        batch-mates arrive, then dispatch.  Returns True when the
        shutdown sentinel arrived mid-wait (the caller stops after)."""
        batch = [first]
        rows = first.rows
        deadline = first.t_enqueue + self.max_latency_s
        saw_sentinel = False
        while rows < self.spec.max_batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except _queue.Empty:
                break
            if nxt is None:
                saw_sentinel = True
                break
            if rows + nxt.rows > self.spec.max_batch_size:
                self._holdover = nxt   # next batch leads with it
                break
            batch.append(nxt)
            rows += nxt.rows
        self.metrics.set_queue_depth(self._queue.qsize())
        self._dispatch(batch)
        return saw_sentinel

    def _drain_rest(self):
        """Serve everything still queued (shutdown(drain=True)),
        batching up to max_batch_size rows per dispatch."""
        batch, rows = [], 0
        if self._holdover is not None:
            batch, rows = [self._holdover], self._holdover.rows
            self._holdover = None
        while True:
            try:
                req = self._queue.get_nowait()
            except _queue.Empty:
                break
            if req is None:
                continue
            if batch and rows + req.rows > self.spec.max_batch_size:
                self._dispatch(batch)
                batch, rows = [], 0
            batch.append(req)
            rows += req.rows
        if batch:
            self._dispatch(batch)

    def _fail_pending(self):
        while True:
            if self._holdover is not None:
                req, self._holdover = self._holdover, None
            else:
                try:
                    req = self._queue.get_nowait()
                except _queue.Empty:
                    return
            if req is not None and not req.future.done():
                req.future.set_exception(
                    EndpointClosed(f"endpoint {self.name} shut down "
                                   "without draining"))
                self.metrics.incr("failed")
                self._retire(req)

    def _dispatch(self, batch):
        """Group compatible requests, run one forward per group, deliver
        each request's slice to its future."""
        now = time.perf_counter()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                if not req.future.done():
                    req.future.set_exception(RequestTimeout(
                        f"request waited past its deadline "
                        f"({(now - req.t_enqueue) * 1e3:.1f} ms)"))
                self.metrics.incr("timeouts")
                self._retire(req)
            else:
                self.metrics.observe_queue_wait(now - req.t_enqueue)
                live.append(req)
        groups = {}
        for req in live:
            # a swap between two requests' submits splits them into
            # different groups: each batch runs ONE version's model
            groups.setdefault((req.signature, req.version), []).append(req)
        for group in groups.values():
            try:
                self._execute(group)
            except Exception as exc:                 # noqa: BLE001
                if len(group) == 1:
                    if not group[0].future.done():
                        group[0].future.set_exception(exc)
                    self.metrics.incr("failed")
                    self._retire(group[0])
                else:
                    # isolate the poison: rerun each request alone so
                    # only the bad one fails
                    for req in group:
                        self._dispatch([req])

    def _execute(self, group):
        cache = self._cache_for(group[0].version, group[0].arrays)
        rows = sum(r.rows for r in group)
        bucket = pick_bucket(rows, self.spec.batch_buckets)
        t0 = time.perf_counter()
        padded = [torch.from_numpy(self.spec.pad_concat(
            [r.arrays[i] for r in group], bucket)).to(self.device)
            for i in range(len(group[0].arrays))]
        padded_seq = padded[0].shape[self.spec.seq_axis] \
            if (self.spec.seq_buckets
                and padded[0].ndim > self.spec.seq_axis) else None

        def model_call():
            # the fault hook fires BEFORE the device call, so a retried
            # injection never replays twice; each call copies the padded
            # batch into the graph's static inputs anew
            _faultline.check("serve.model_call")
            return cache(padded)      # synchronises the device's stream

        with _telemetry.span(f"serve/{self.name}/batch", cat="serve",
                             args={"rows": rows, "bucket": bucket,
                                   "requests": len(group)}):
            out = _retry_transient(model_call, site="serve.model_call",
                                   retries=1)
        latency = time.perf_counter() - t0

        self.metrics.observe_batch(rows, bucket)
        self.metrics.observe_execute(latency)
        for hook in list(self._batch_hooks):
            hook(self, rows, bucket, latency)

        row = 0
        for req in group:
            sl = slice(row, row + req.rows)
            row += req.rows

            def take(leaf, _sl=sl, _req=req):
                piece = leaf[_sl]
                # trim sequence padding back off row-aligned outputs
                if (padded_seq is not None and _req.seq_len is not None
                        and piece.ndim > self.spec.seq_axis
                        and piece.shape[self.spec.seq_axis] == padded_seq):
                    piece = piece.narrow(self.spec.seq_axis, 0, _req.seq_len)
                return piece

            result = _tree_map(take, out)
            if not req.future.done():
                req.future.set_result(result)
            self.metrics.observe_latency(time.perf_counter() - req.t_enqueue)
            self._retire(req)
