"""Per-endpoint serving metrics (counterpart of
`mxnet_tpu/serve/metrics.py`).

The same counters and the same ``stats()`` keys as the reference.  The
reference also publishes every update to its profiler and telemetry
registry; the port has neither yet, so the counters live here alone.
Latency, queue-wait and execute percentiles come from fixed-size
windows of the most recent observations (2048 each).
"""
from __future__ import annotations

import threading
import time

import numpy as onp

__all__ = ["EndpointMetrics"]

_WINDOW = 2048

_COUNTERS = ("submitted", "completed", "failed", "timeouts", "rejected_full",
             "batches", "cache_hits", "cache_misses", "queue_depth")


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
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._counters = dict.fromkeys(_COUNTERS, 0)
        self._latency_ms = _Window()
        self._queue_wait_ms = _Window()
        self._execute_ms = _Window()
        self._occ_rows = 0       # real rows dispatched
        self._occ_slots = 0      # bucket slots dispatched

    def incr(self, name, delta=1):
        with self._lock:
            self._counters[name] += delta

    def set_queue_depth(self, depth):
        with self._lock:
            self._counters["queue_depth"] = depth

    def observe_batch(self, real_rows, bucket_rows):
        with self._lock:
            self._counters["batches"] += 1
            self._occ_rows += real_rows
            self._occ_slots += bucket_rows

    def observe_queue_wait(self, seconds):
        with self._lock:
            self._queue_wait_ms.add(seconds * 1e3)

    def observe_execute(self, seconds):
        with self._lock:
            self._execute_ms.add(seconds * 1e3)

    def observe_latency(self, seconds):
        with self._lock:
            self._counters["completed"] += 1
            self._latency_ms.add(seconds * 1e3)

    def stats(self):
        """One flat dict: counters, QPS over the endpoint's lifetime,
        latency percentiles over the recent window, mean batch occupancy,
        executable-cache hit rate, queue-wait and execute percentiles."""
        with self._lock:
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            out = dict(self._counters)
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
