"""Structured step-trace spans layered on the profiler's chrome-trace
emitter (counterpart of `mxnet_tpu/telemetry/spans.py`).

A span is two things at once:

* while the profiler runs, a chrome-trace complete event (`ph:"X"`) with a
  structured category — ``step_phase`` / ``collective`` / ``serve`` — so
  one ``profiler.dump()`` interleaves host step phases with the card's
  kernels on a single timeline;
* always, a registry observation (``step_phase`` → the trainer phase
  histogram, ``collective_span`` → kvstore collective counters), so the
  Prometheus exposition reflects steady-state behavior with the profiler
  off.

The trace side costs nothing when profiling is off (one module-global
truthiness check); the registry side is one histogram observation per
*step/collective/batch* — never per op.  A span measures host time: it
reads no device clock and synchronizes nothing, so around a replayed
CUDA graph ``step/fused-step`` is the host's launch time, as the
reference's is its dispatch time.

`set_enabled(False)` turns every span, phase and step count off (not in
the reference, which cannot turn them off): what a step costs without
them, for measuring their host cost.
"""
from __future__ import annotations

import time

from .. import observe as _observe
from .. import profiler as _profiler
from . import registry as _registry

__all__ = ["span", "step_phase", "collective_span", "mark_step",
           "set_enabled", "enabled"]

_enabled = [True]


def set_enabled(flag):
    """Turn spans, step phases and `mark_step` on or off; returns the
    previous setting."""
    prev = _enabled[0]
    _enabled[0] = bool(flag)
    return prev


def enabled():
    return _enabled[0]


class span:
    """Chrome-trace span under category ``cat`` — emits only while the
    profiler runs, a no-op otherwise."""

    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name, cat="step_phase", args=None):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = _profiler._now_us() \
            if _profiler._running and _enabled[0] else None
        return self

    def __exit__(self, *_exc):
        if self._t0 is not None and _profiler._running:
            _profiler._emit(self.name, self.cat, "X", self._t0,
                            args=self.args,
                            dur=_profiler._now_us() - self._t0)
        return False


def _phase_histogram():
    return _registry.histogram(
        "mxtpu_trainer_step_phase_seconds",
        "Training step decomposition: data-wait / fwd / bwd / allreduce / "
        "optimizer (or fused-step for FusedTrainStep)",
        labelnames=("phase",))


def _steps_counter():
    return _registry.counter(
        "mxtpu_trainer_steps_total", "Optimizer steps taken")


class step_phase:
    """Time one phase of a training step: chrome-trace span
    ``step/<phase>`` (cat ``step_phase``) + an observation in the
    ``mxtpu_trainer_step_phase_seconds{phase=...}`` histogram."""

    __slots__ = ("phase", "_span", "_t0")

    def __init__(self, phase):
        self.phase = phase

    def __enter__(self):
        if not _enabled[0]:
            self._span = None
            return self
        self._span = span(f"step/{self.phase}")
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._span is None:
            return False
        dt = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        _phase_histogram().labels(phase=self.phase).observe(dt)
        _observe.record("phase", self.phase, seconds=dt)
        return False


def mark_step():
    """Count one optimizer step (`mxtpu_trainer_steps_total`)."""
    if _enabled[0]:
        _steps_counter().inc()


def _collective_metrics():
    reg = _registry
    return (
        reg.counter("mxtpu_kvstore_collective_total",
                    "Cross-device collectives dispatched by the kvstore",
                    labelnames=("op",)),
        reg.counter("mxtpu_kvstore_collective_bytes_total",
                    "Payload bytes entering kvstore collectives",
                    labelnames=("op",)),
        reg.histogram("mxtpu_kvstore_collective_seconds",
                      "Host-side kvstore collective dispatch latency "
                      "(device time overlaps async; see the XLA trace for "
                      "on-wire timing)",
                      labelnames=("op",)),
        reg.counter("mxtpu_kvstore_collective_launches_total",
                    "XLA collective program launches dispatched by the "
                    "kvstore, across all ops (gradient bucketing collapses "
                    "many keys into one launch; per-key pushpull pays one "
                    "per parameter)"),
    )


class collective_span:
    """Instrument one kvstore collective: count + bytes + latency into the
    registry, and a ``collective/<op>`` chrome-trace span while
    profiling."""

    __slots__ = ("op", "nbytes", "_span", "_t0")

    def __init__(self, op, nbytes=0):
        self.op = op
        self.nbytes = int(nbytes)

    def __enter__(self):
        if not _enabled[0]:
            self._span = None
            return self
        total, bytes_, _lat, launches = _collective_metrics()
        total.labels(op=self.op).inc()
        launches.inc()
        if self.nbytes:
            bytes_.labels(op=self.op).inc(self.nbytes)
        self._span = span(f"collective/{self.op}", cat="collective",
                          args={"op": self.op, "bytes": self.nbytes})
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._span is None:
            return False
        dt = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        _collective_metrics()[2].labels(op=self.op).observe(dt)
        _observe.record("collective", self.op, seconds=dt,
                        bytes=self.nbytes)
        return False
