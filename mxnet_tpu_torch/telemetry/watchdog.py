"""Retrace (re-capture) watchdog (counterpart of
`mxnet_tpu/telemetry/watchdog.py`).

The reference counts XLA compiles and flags a jitted function whose
trace cache grows after steady state: a silent recompile, usually from
a drifting input shape.  The port's counterpart of a compile is a CUDA
graph capture (`ops.capture.Graph`): `gluon.FusedTrainStep` captures its
step at the second call of a signature, a serving cache each bucket it
warms.  So:

* `install_compile_listener` counts every capture, with its duration —
  ``mxtpu_graph_capture_total`` / ``mxtpu_graph_capture_seconds``;
* ``RetraceWatchdog.observe(fn, name)`` (called by ``FusedTrainStep``
  after each step, or through ``watch_jit`` for any callable) reads the
  callable's capture count (its ``captures`` attribute, or its
  ``_cache_size()``) and bumps ``mxtpu_jit_retrace_total{fn}`` when the
  count grew beyond the first capture; growth after the configurable
  steady-state call count (`steady_after`, env
  ``MXNET_TELEMETRY_STEADY_STEPS``) also logs a WARNING.  A step's one
  capture is not a retrace; a second one (a new shape, a rebound
  parameter) is.
"""
from __future__ import annotations

import logging
import os
import threading
import weakref

from . import registry as _registry

__all__ = ["RetraceWatchdog", "watchdog", "watch_jit",
           "install_compile_listener"]

_log = logging.getLogger("mxnet_tpu_torch.telemetry")

# captures take from milliseconds (a bucket) to seconds (a whole step)
_CAPTURE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    30.0, 60.0)

_listener_lock = threading.Lock()
_listener_installed = False


def install_compile_listener(registry=None):
    """Register the process-wide listener that counts graph captures
    (`ops.capture.add_capture_listener`).  Idempotent; installed on
    ``mxnet_tpu_torch.telemetry`` import.  Returns True on first
    install."""
    global _listener_installed
    with _listener_lock:
        if _listener_installed:
            return False
        _listener_installed = True
    reg = registry or _registry.default_registry()
    total = reg.counter(
        "mxtpu_graph_capture_total",
        "CUDA graph captures (a FusedTrainStep's step, a serving "
        "bucket): the port's counterpart of an XLA compile")
    seconds = reg.histogram(
        "mxtpu_graph_capture_seconds", "Host time of each graph capture",
        buckets=_CAPTURE_BUCKETS)

    def _on_capture(duration):
        total.inc()
        seconds.observe(duration)

    from ..ops import capture as _capture
    _capture.add_capture_listener(_on_capture)
    return True


def _cache_size(fn):
    """The capture count of ``fn``, or None when it keeps none."""
    size = getattr(fn, "captures", None)
    if isinstance(size, int):
        return size
    get = getattr(fn, "_cache_size", None)
    return int(get()) if callable(get) else None


class _Tracked:
    __slots__ = ("calls", "cache_size", "ref")

    def __init__(self):
        self.calls = 0
        self.cache_size = None
        self.ref = None


class RetraceWatchdog:
    """Per-callable re-capture tracking over capture counts.

    Parameters
    ----------
    steady_after : int
        Calls after which a callable is considered steady-state: a
        capture past this count logs a WARNING naming it.  Default from
        ``MXNET_TELEMETRY_STEADY_STEPS``, else 2 (a step runs eagerly at
        call 1 and captures at call 2).
    registry : MetricsRegistry
        Where ``mxtpu_jit_retrace_total{fn}`` lives (default registry).
    """

    def __init__(self, steady_after=None, registry=None, logger=None):
        if steady_after is None:
            steady_after = int(
                os.environ.get("MXNET_TELEMETRY_STEADY_STEPS", "2"))
        self.steady_after = int(steady_after)
        reg = registry or _registry.default_registry()
        self._retraces = reg.counter(
            "mxtpu_jit_retrace_total",
            "Trace-cache growth of watched jitted functions beyond their "
            "first compile (nonzero in steady state = shape-driven "
            "retracing)", labelnames=("fn",))
        self._lock = threading.Lock()
        self._tracked = {}

    def retrace_count(self, name):
        return self._retraces.labels(fn=name).value

    def observe(self, fn, name, detail=None, scope_root=None):
        """Record one completed call of ``fn`` (a `FusedTrainStep`, or a
        callable with a capture count).  Growth of the count beyond the
        first capture counts as a retrace; growth after ``steady_after``
        calls also warns, naming ``scope_root`` (the block's name) and
        ``detail`` when given."""
        size = _cache_size(fn)
        if size is None:
            return
        with self._lock:
            ent = self._tracked.get(id(fn))
            if ent is None:
                ent = self._tracked[id(fn)] = _Tracked()
                key = id(fn)
                try:
                    # drop the entry when fn dies, so that a recycled id()
                    # cannot inherit its counts
                    ent.ref = weakref.ref(
                        fn, lambda _r, _k=key: self._tracked.pop(_k, None))
                except TypeError:
                    ent.ref = None
            ent.calls += 1
            calls, prev = ent.calls, ent.cache_size
            ent.cache_size = size
        if prev is None or size <= prev:
            return
        grown = size - max(prev, 1)
        if grown <= 0:
            return                  # the first capture
        self._retraces.labels(fn=name).inc(grown)
        if calls > self.steady_after:
            extras = "".join(
                [f" [block '{scope_root}']" if scope_root else "",
                 f" [{detail}]" if detail else ""])
            _log.warning(
                "retrace watchdog: %s captured again at call %d (captures "
                "%d -> %d)%s — a steady-state capture usually means an "
                "input shape/dtype is drifting or a parameter was rebound; "
                "each one runs the step eagerly and captures it anew",
                name, calls, prev, size, extras)

    def watch(self, fn, name=None):
        """Wrap a callable with a capture count so every call is
        observed."""
        return _WatchedJit(self, fn,
                           name or getattr(fn, "__name__", "jit_fn"))


class _WatchedJit:
    def __init__(self, wd, fn, name):
        self._wd = wd
        self._fn = fn
        self._name = name

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        self._wd.observe(self._fn, self._name)
        return out

    def __getattr__(self, attr):
        return getattr(self._fn, attr)


_default_watchdog = None
_default_watchdog_lock = threading.Lock()


def watchdog():
    """The process-wide watchdog instance (shared by FusedTrainStep and
    ``watch_jit``)."""
    global _default_watchdog
    if _default_watchdog is None:
        with _default_watchdog_lock:
            if _default_watchdog is None:
                _default_watchdog = RetraceWatchdog()
    return _default_watchdog


def watch_jit(fn, name=None):
    """Wrap ``fn`` so the default watchdog sees every call."""
    return watchdog().watch(fn, name)
