"""Thread-safe metrics registry: counters / gauges / histograms with labels
(counterpart of `mxnet_tpu/telemetry/registry.py`; the same families,
samples and exposition text for the same operations).

The production-observability layer the reference framework never had —
MXNet's profiler answers "what happened in this trace window", a registry
answers "what has this process done since it started", which is what a
serving fleet scrapes.  Exposition is Prometheus text format
(`export_prometheus`) and JSON (`export_json`); both render the same
sample set.

Design constraints (this registry sits under serve threads, the trainer
step loop, and — while profiling — per-op dispatch):

* one lock per metric family, held only for the value update;
* ``labels()`` resolves a child from a tuple-keyed dict, so hot callers
  can pre-resolve children once and pay a plain ``inc()`` per event;
* histograms bucket with ``bisect`` over a static bound list — O(log n),
  no allocation.
"""
from __future__ import annotations

import json
import re
import threading
from bisect import bisect_left

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "default_registry", "counter", "gauge", "histogram",
    "export_prometheus", "export_json",
]

# Prometheus client-library default latency buckets (seconds), extended
# down to 100us — step phases and serve dispatches live there.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label_value(v):
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v):
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _format_value(v):
    f = float(v)
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value

    def _samples(self, name, labels):
        return [(name, labels, self._value)]

    def _reset(self):
        with self._lock:
            self._value = 0.0


class _GaugeChild(_CounterChild):
    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds):
        self._lock = threading.Lock()
        self._bounds = bounds                    # sorted, no +Inf
        self._counts = [0] * (len(bounds) + 1)   # last slot = overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        value = float(value)
        i = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def bucket_counts(self):
        """Cumulative counts per upper bound (last entry is +Inf)."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for c in counts:
            cum += c
            out.append(cum)
        return out

    def quantile(self, q):
        """Estimated value at quantile ``q`` in [0, 1] from the bucket
        counts — Prometheus ``histogram_quantile`` semantics: find the
        bucket the rank lands in, interpolate linearly inside it.
        Observations in the overflow bucket clamp to the largest finite
        bound (there is no upper edge to interpolate toward).  Returns
        None when the histogram is empty.  This is what serving SLO
        gates read (p50/p99 per class) without keeping a reservoir."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if not total:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c and cum + c >= rank:
                if i == len(self._bounds):      # overflow bucket
                    return float(self._bounds[-1])
                lo = self._bounds[i - 1] if i > 0 else 0.0
                return float(lo + (self._bounds[i] - lo)
                             * max(rank - cum, 0.0) / c)
            cum += c
        return float(self._bounds[-1])

    def _samples(self, name, labels):
        out = []
        cums = self.bucket_counts()
        for bound, cum in zip(tuple(self._bounds) + ("+Inf",), cums):
            le = bound if bound == "+Inf" else _format_value(bound)
            out.append((name + "_bucket", labels + (("le", le),), cum))
        out.append((name + "_sum", labels, self._sum))
        out.append((name + "_count", labels, self._count))
        return out

    def _reset(self):
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._sum = 0.0
            self._count = 0


class _MetricFamily:
    kind = "untyped"
    _child_cls = _CounterChild

    def __init__(self, name, help="", labelnames=()):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        return self._child_cls()

    def labels(self, *values, **kv):
        """Child metric for one label-value combination (created on first
        use).  Hot paths should call this once and keep the child."""
        if kv:
            if values:
                raise ValueError("pass labels positionally or by name")
            try:
                values = tuple(kv[ln] for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name} needs labels {self.labelnames}") from e
            if len(kv) != len(self.labelnames):
                raise ValueError(
                    f"{self.name} needs labels {self.labelnames}, "
                    f"got {tuple(kv)}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label values")
        values = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
        return child

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call .labels()")
        return self._children[()]

    def _collect(self):
        """[(sample_name, ((label, value), ...), value)] snapshot."""
        with self._lock:
            items = list(self._children.items())
        out = []
        for values, child in items:
            labels = tuple(zip(self.labelnames, values))
            out.extend(child._samples(self.name, labels))
        return out

    def _reset(self):
        with self._lock:
            items = list(self._children.values())
        for child in items:
            child._reset()


class Counter(_MetricFamily):
    kind = "counter"

    def inc(self, amount=1):
        self._unlabeled().inc(amount)

    @property
    def value(self):
        return self._unlabeled().value


class Gauge(_MetricFamily):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value):
        self._unlabeled().set(value)

    def inc(self, amount=1):
        self._unlabeled().inc(amount)

    def dec(self, amount=1):
        self._unlabeled().dec(amount)

    @property
    def value(self):
        return self._unlabeled().value


class Histogram(_MetricFamily):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets=DEFAULT_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if bounds[-1] == float("inf"):
            bounds = bounds[:-1]        # +Inf is implicit
        self._bounds = bounds
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _HistogramChild(self._bounds)

    def observe(self, value):
        self._unlabeled().observe(value)

    def quantile(self, q):
        return self._unlabeled().quantile(q)


class MetricsRegistry:
    """A namespace of metric families.  ``counter``/``gauge``/``histogram``
    are get-or-create: re-registering the same name returns the existing
    family (and raises if kind or labelnames disagree), so library modules
    can declare their metrics independently."""

    _kinds = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def collect(self):
        """[(family, [(sample_name, labels_tuple, value), ...])]."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        return [(fam, fam._collect()) for fam in fams]

    def get_sample_value(self, sample_name, labels=None):
        """Value of one exposition sample (e.g. ``name``, ``name_bucket``
        with ``{"le": "0.1"}``, ``name_count``) or None.  Test/assert
        helper — scraping goes through the exporters."""
        want = tuple(sorted((labels or {}).items()))
        for _fam, samples in self.collect():
            for name, lab, value in samples:
                if name == sample_name and tuple(sorted(lab)) == want:
                    return value
        return None

    def reset(self):
        """Zero every child (families and label sets survive, so cached
        children stay live).  Test helper."""
        for fam, _samples in self.collect():
            fam._reset()

    # -- exposition --------------------------------------------------------
    def export_prometheus(self):
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for fam, samples in self.collect():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for name, labels, value in samples:
                if labels:
                    rendered = ",".join(
                        f'{k}="{_escape_label_value(v)}"' for k, v in labels)
                    lines.append(f"{name}{{{rendered}}} "
                                 f"{_format_value(value)}")
                else:
                    lines.append(f"{name} {_format_value(value)}")
        return "\n".join(lines) + "\n"

    def export_json(self):
        """JSON exposition: the same samples the Prometheus text carries,
        machine-readable (``{"metrics": [{name, type, help, samples}]}``)."""
        metrics = []
        for fam, samples in self.collect():
            metrics.append({
                "name": fam.name,
                "type": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "samples": [
                    {"name": name, "labels": dict(labels), "value": value}
                    for name, labels, value in samples
                ],
            })
        return json.dumps({"metrics": metrics}, indent=1)


_default = MetricsRegistry()


def default_registry():
    """The process-wide registry every built-in subsystem publishes into."""
    return _default


def counter(name, help="", labelnames=()):
    return _default.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return _default.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
    return _default.histogram(name, help, labelnames, buckets=buckets)


def export_prometheus():
    return _default.export_prometheus()


def export_json():
    return _default.export_json()
