"""Unified telemetry: metrics registry, step-trace spans, retrace
watchdog (counterpart of `mxnet_tpu/telemetry/__init__.py`).

* :mod:`.registry` — thread-safe counters/gauges/histograms with labels,
  Prometheus-text and JSON exposition, as the reference renders them.
  The Gluon ``Trainer`` and ``FusedTrainStep`` step phases, the step
  guards, the input pipeline and the checkpoint manager publish into the
  default registry;
* :mod:`.spans` — structured chrome-trace spans over the
  :mod:`mxnet_tpu_torch.profiler` emitter, so one ``profiler.dump()``
  interleaves step phases with the card's kernels on one timeline;
* :mod:`.watchdog` — CUDA graph capture counters plus per-step
  re-capture detection with steady-state warnings.

Everything is off the hot path by default: the chrome-trace side is
gated on the profiler running, and registry publications happen per
step / collective / batch, never per op.
"""
from .registry import (
    MetricsRegistry, Counter, Gauge, Histogram, DEFAULT_BUCKETS,
    default_registry, counter, gauge, histogram,
    export_prometheus, export_json,
)
from .spans import (span, step_phase, collective_span, mark_step,
                    set_enabled, enabled)
from .watchdog import (
    RetraceWatchdog, watchdog, watch_jit, install_compile_listener,
)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "default_registry", "counter", "gauge", "histogram",
    "export_prometheus", "export_json",
    "span", "step_phase", "collective_span", "mark_step",
    "set_enabled", "enabled",
    "RetraceWatchdog", "watchdog", "watch_jit", "install_compile_listener",
]

# the listener only fires on captures — safe to wire unconditionally
install_compile_listener()
