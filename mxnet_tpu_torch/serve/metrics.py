"""Per-endpoint serving metrics (counterpart of
`mxnet_tpu/serve/metrics.py`).

The same counters and the same ``stats()`` keys as the reference.
Counters ride the :mod:`mxnet_tpu_torch.profiler` Domain/Counter
machinery (``serve/<name>``): while the profiler runs, every update lands
in its chrome-trace dump beside the card's kernels, so a serving trace
shows queue depth and batches on the same timeline as device work.

Every update is also published into the :mod:`mxnet_tpu_torch.telemetry`
default registry under an ``endpoint`` label, in the reference's
families (``mxtpu_serve_requests_total`` / ``_batches_total`` /
``_batch_rows_total`` / ``_cache_total`` / ``_queue_depth`` /
``_latency_seconds`` / ``_queue_wait_seconds`` / ``_execute_seconds``),
so one ``telemetry.export_prometheus()`` scrape covers every live
endpoint beside the trainer's series.  Registry children are resolved
once at construction: the cost of an event is a locked add.

Latency, queue-wait and execute percentiles in ``stats()`` come from
fixed-size windows of the most recent observations (2048 each), exact
over the window; the registry's histograms keep the whole run in
buckets.
"""
from __future__ import annotations

import threading
import time

import numpy as onp

from .. import profiler
from .. import telemetry

__all__ = ["EndpointMetrics"]

_WINDOW = 2048

_EVENTS = ("submitted", "completed", "failed", "timeouts", "rejected_full")

_COUNTERS = _EVENTS + ("batches", "cache_hits", "cache_misses",
                       "queue_depth")


class _Window:
    """The last ``_WINDOW`` observations (under the metrics lock)."""

    def __init__(self):
        self.values = onp.zeros(_WINDOW, dtype=onp.float64)
        self.n = 0

    def add(self, v):
        self.values[self.n % _WINDOW] = v
        self.n += 1

    def percentile(self, q):
        n = min(self.n, _WINDOW)
        return float(onp.percentile(self.values[:n], q)) if n else None


class EndpointMetrics:
    def __init__(self, name):
        self.name = name
        self._domain = profiler.Domain(f"serve/{name}")
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._counters = {n: self._domain.new_counter(n, 0)
                          for n in _COUNTERS}
        self._latency_ms = _Window()
        self._queue_wait_ms = _Window()
        self._execute_ms = _Window()
        self._occ_rows = 0       # real rows dispatched
        self._occ_slots = 0      # bucket slots dispatched

        reg = telemetry.default_registry()
        req = reg.counter(
            "mxtpu_serve_requests_total",
            "Serving requests by lifecycle event", ("endpoint", "event"))
        cache = reg.counter(
            "mxtpu_serve_cache_total",
            "Executable-cache lookups under traffic (a steady-state miss "
            "is a compile stall — check the bucket grid)",
            ("endpoint", "kind"))
        rows = reg.counter(
            "mxtpu_serve_batch_rows_total",
            "Dispatched batch rows: real request rows vs padded bucket "
            "slots (ratio = occupancy)", ("endpoint", "kind"))
        self._reg = {n: req.labels(endpoint=name, event=n) for n in _EVENTS}
        self._reg["cache_hits"] = cache.labels(endpoint=name, kind="hit")
        self._reg["cache_misses"] = cache.labels(endpoint=name, kind="miss")
        self._reg_batches = reg.counter(
            "mxtpu_serve_batches_total", "Batches dispatched to the device",
            ("endpoint",)).labels(endpoint=name)
        self._reg_rows_real = rows.labels(endpoint=name, kind="real")
        self._reg_rows_slots = rows.labels(endpoint=name, kind="slots")
        self._reg_queue = reg.gauge(
            "mxtpu_serve_queue_depth", "Requests waiting in the endpoint "
            "queue", ("endpoint",)).labels(endpoint=name)
        self._reg_latency = reg.histogram(
            "mxtpu_serve_latency_seconds",
            "End-to-end request latency (enqueue to result delivery)",
            ("endpoint",)).labels(endpoint=name)
        self._reg_queue_wait = reg.histogram(
            "mxtpu_serve_queue_wait_seconds",
            "Time a request waited in the endpoint queue before its "
            "batch was dispatched", ("endpoint",)).labels(endpoint=name)
        self._reg_execute = reg.histogram(
            "mxtpu_serve_execute_seconds",
            "Device-call latency per dispatched batch (pad/concat + "
            "executable run + result sync)",
            ("endpoint",)).labels(endpoint=name)

    def incr(self, name, delta=1):
        with self._lock:
            self._counters[name].increment(delta)
        child = self._reg.get(name)
        if child is not None:
            child.inc(delta)

    def set_queue_depth(self, depth):
        with self._lock:
            self._counters["queue_depth"].set_value(depth)
        self._reg_queue.set(depth)

    def observe_batch(self, real_rows, bucket_rows):
        with self._lock:
            self._counters["batches"].increment()
            self._occ_rows += real_rows
            self._occ_slots += bucket_rows
        self._reg_batches.inc()
        self._reg_rows_real.inc(real_rows)
        self._reg_rows_slots.inc(bucket_rows)

    def observe_queue_wait(self, seconds):
        with self._lock:
            self._queue_wait_ms.add(seconds * 1e3)
        self._reg_queue_wait.observe(seconds)

    def observe_execute(self, seconds):
        with self._lock:
            self._execute_ms.add(seconds * 1e3)
        self._reg_execute.observe(seconds)

    def observe_latency(self, seconds):
        with self._lock:
            self._counters["completed"].increment()
            self._latency_ms.add(seconds * 1e3)
        self._reg["completed"].inc()
        self._reg_latency.observe(seconds)

    def stats(self):
        """One flat dict: counters, QPS over the endpoint's lifetime,
        latency percentiles over the recent window, mean batch occupancy,
        executable-cache hit rate, queue-wait and execute percentiles."""
        with self._lock:
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            out = {n: c.value for n, c in self._counters.items()}
            hits, misses = out["cache_hits"], out["cache_misses"]
            out.update({
                "qps": out["completed"] / elapsed,
                "mean_batch_occupancy": (self._occ_rows / self._occ_slots
                                         if self._occ_slots else 0.0),
                "cache_hit_rate": (hits / (hits + misses)
                                   if hits + misses else 0.0),
                "latency_ms_p50": self._latency_ms.percentile(50),
                "latency_ms_p95": self._latency_ms.percentile(95),
                "latency_ms_p99": self._latency_ms.percentile(99),
            })
            for key, win in (("queue_wait_ms", self._queue_wait_ms),
                             ("execute_ms", self._execute_ms)):
                for q in (50, 99):
                    out[f"{key}_p{q}"] = win.percentile(q)
        return out
