"""Profiler (counterpart of `mxnet_tpu/profiler.py`).

Reference: `src/profiler/profiler.h:251` + `python/mxnet/profiler.py` —
chrome://tracing JSON dumps, aggregate stat tables, user Domains, Tasks,
Frames, Events, Counters and Markers.

The port keeps the reference's API and its host-side events (spans,
counters, markers, the telemetry's step phases) and adds the card's side
from ``torch.profiler``: on a machine with CUDA, ``set_state("run")``
starts a ``torch.profiler.profile`` over CPU and CUDA activity, and
``set_state("stop")`` folds what it collected (the CUDA kernels, memory
copies and runtime calls, each with its own ``cat``) into the same event
list, on the host events' clock, so one `dump` holds both.  A stop that
collected no CUDA kernel raises: a trace of the card without its
kernels would say the card did nothing.  Without CUDA (the CPU tests)
the trace holds the host events alone, as the reference records them.

The two clocks are joined by a marker that the host records through
``torch.profiler.record_function`` when it starts and stops the
device trace; where the trace lost both, by the wall clock
(``baseTimeNanoseconds``).  `pause` and `resume` gate the host events
only; the device trace runs from ``run`` to ``stop``.

``dump_memory_profile`` writes ``torch.cuda.memory._snapshot()``
(pickled, as ``torch.cuda.memory._dump_snapshot`` writes it) where the
reference writes jax's pprof.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time

__all__ = [
    "set_config", "set_state", "state", "dump", "dumps", "pause", "resume",
    "Domain", "Task", "Frame", "Event", "Counter", "Marker", "scope",
    "dump_memory_profile",
]

_lock = threading.Lock()
_config = {"filename": "profile.json"}
_running = False
_events = []
_t0 = time.perf_counter()
_t0_wall_ns = time.time_ns()
_ORIGIN = "mxnet_tpu_torch.profiler/clock"
# the running torch.profiler.profile and the host times of its markers
_device = {"prof": None, "marks": []}


def _now_us():
    return (time.perf_counter() - _t0) * 1e6


def set_config(**kwargs):
    _config.update(kwargs)


def _mark():
    """A marker in the device trace at a known host time."""
    import torch

    t = _now_us()
    with torch.profiler.record_function(_ORIGIN):
        pass
    _device["marks"].append(t)


def _start_device_trace():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    prof.__enter__()
    _device["prof"], _device["marks"] = prof, []
    _mark()


def _stop_device_trace():
    """Stop the device trace and fold its events into `_events`; raises
    if it holds no CUDA kernel."""
    import torch

    prof = _device["prof"]
    _mark()
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    _device["prof"] = None
    fd, path = tempfile.mkstemp(suffix=".json", prefix="mxprof-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    evs = [e for e in trace.get("traceEvents", [])
           if isinstance(e, dict) and "ts" in e]
    if not any(e.get("cat") == "kernel" for e in evs):
        raise RuntimeError(
            "profiler: the device trace holds no CUDA kernel (CUDA "
            "activity was not collected, or nothing ran on the card); no "
            "trace is kept")
    # kineto's ts (us, relative to baseTimeNanoseconds) -> _now_us()
    marks = [e for e in evs if e.get("name") == _ORIGIN]
    if marks:
        offset = _device["marks"][-len(marks)] - float(marks[0]["ts"])
    else:
        base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
        offset = base_us - _t0_wall_ns / 1e3
    out = []
    for e in evs:
        if e.get("name") == _ORIGIN or e.get("ph") == "M":
            continue
        e = dict(e)
        e["ts"] = float(e["ts"]) + offset
        out.append(e)
    with _lock:
        _events.extend(out)


def set_state(state_name="stop", profile_process="worker"):
    global _running
    if state_name == "run":
        import torch

        if _device["prof"] is None and not _running and \
                torch.cuda.is_available():
            _start_device_trace()
        _running = True
    elif state_name == "stop":
        _running = False
        if _device["prof"] is not None:
            _stop_device_trace()
    else:
        raise ValueError("state must be 'run' or 'stop'")


def state():
    return "run" if _running else "stop"


def pause(profile_process="worker"):
    global _running
    _running = False


def resume(profile_process="worker"):
    global _running
    _running = True


def _emit(name, cat, ph, ts, args=None, dur=None):
    ev = {"name": name, "cat": cat, "ph": ph, "ts": ts, "pid": 0,
          "tid": threading.get_ident() % 100000}
    if args:
        ev["args"] = args
    if dur is not None:
        ev["dur"] = dur
    with _lock:
        _events.append(ev)


def dumps(reset=False, format="table"):
    """format='json': chrome://tracing events; format='table': aggregate
    per-name statistics of the complete ('X') events, the card's kernels
    among them (reference `AggregateStats`,
    `src/profiler/aggregate_stats.cc`)."""
    with _lock:
        events = list(_events)
        if reset:
            _events.clear()
    if format == "json":
        return json.dumps({"traceEvents": events}, indent=1)
    agg = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev["name"]
        cnt, tot, mx_ = agg.get(name, (0, 0.0, 0.0))
        dur = ev.get("dur", 0.0)
        agg[name] = (cnt + 1, tot + dur, max(mx_, dur))
    lines = [f"{'Name':<40}{'Count':>8}{'Total(us)':>14}{'Avg(us)':>12}"
             f"{'Max(us)':>12}", "-" * 86]
    for name, (cnt, tot, mx_) in sorted(agg.items(),
                                        key=lambda kv: -kv[1][1]):
        lines.append(f"{name[:39]:<40}{cnt:>8}{tot:>14.1f}"
                     f"{tot / cnt:>12.1f}{mx_:>12.1f}")
    return "\n".join(lines)


def dump(finished=True, profile_process="worker"):
    """Write the chrome://tracing JSON to the configured filename.

    ``finished=True`` (default) also stops the profiler (and its device
    trace) *before* the event snapshot and resets the buffer with it.
    ``finished=False`` leaves the profiler running and the buffer intact;
    the device trace's events reach the buffer only at its stop."""
    if finished and (_running or _device["prof"] is not None):
        set_state("stop")
    payload = dumps(format="json", reset=finished)
    with open(_config["filename"], "w") as f:
        f.write(payload)


class Domain:
    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_event(self, name):
        return Event(name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _Span:
    _ph_cat = "task"

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._start = None

    def start(self):
        self._start = _now_us()

    def stop(self):
        if self._start is not None and _running:
            _emit(self.name, self._ph_cat, "X", self._start,
                  dur=_now_us() - self._start)
        self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *_exc):
        self.stop()


class Task(_Span):
    _ph_cat = "task"


class Frame(_Span):
    _ph_cat = "frame"


class Event(_Span):
    def __init__(self, name):
        super().__init__(None, name)
    _ph_cat = "event"


class Counter:
    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        # increments are read-modify-write and may come from several
        # threads
        self._vlock = threading.Lock()
        self._value = 0
        if value is not None:
            self.set_value(value)

    @property
    def value(self):
        """Current counter value (readable with the profiler stopped)."""
        return self._value

    def set_value(self, value):
        with self._vlock:
            self._value = value
        self._sample(value)

    def increment(self, delta=1):
        with self._vlock:
            self._value += delta
            value = self._value
        self._sample(value)

    def decrement(self, delta=1):
        self.increment(-delta)

    def _sample(self, value):
        if _running:
            _emit(self.name, "counter", "C", _now_us(),
                  args={self.name: value})

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        if _running:
            _emit(self.name, "marker", "i", _now_us())


class scope:
    """Context manager timing a host-side region; while the device trace
    runs, also a ``torch.profiler.record_function`` of the same name, so
    the region shows among torch's own host events."""

    def __init__(self, name):
        self.name = name
        self._span = Task(None, name)
        self._fn = None

    def __enter__(self):
        if _device["prof"] is not None:
            import torch

            fn = torch.profiler.record_function(self.name)
            fn.__enter__()
            self._fn = fn
        self._span.start()
        return self

    def __exit__(self, *exc):
        self._span.stop()
        fn, self._fn = self._fn, None
        if fn is not None:
            fn.__exit__(*exc)


def dump_memory_profile(path="memory.pickle"):
    """Write the card's allocator snapshot (``torch.cuda.memory.
    _snapshot()``, pickled) to ``path``; raises without CUDA."""
    import pickle

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("dump_memory_profile needs CUDA")
    snap = torch.cuda.memory._snapshot()
    with open(path, "wb") as f:
        pickle.dump(snap, f)
    return path
