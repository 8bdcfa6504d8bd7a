"""Pod flight recorder (counterpart of `mxnet_tpu/observe/flightrec.py`):
a bounded, always-on ring buffer of structured events behind every
existing emitter.  Same events, same dump format and ``SCHEMA_VERSION``
as the reference, so its ``tools/blackbox`` reads the port's dumps.

The recorder is a *sink*, not an instrumentation pass: the taps live in
the subsystems that already observe the interesting transitions —
``telemetry.spans`` (step phases, collectives), ``resilience.faultline``
(injections), ``resilience.sentinel`` (straggler demotions, divergence
trips), ``resilience.checkpoint`` (save/restore outcomes) and the
Trainer's step; the reference's elastic, kvstore and fleet taps come
with those modules (ROADMAP queue A6, A7).  Each tap is one ``record()``
call: two clock reads, a payload dict, and a lock held only for an index
bump plus a slot write.

Events are ``(mono_ns, wall_ns, rank, generation, category, name,
payload)``.  ``mono_ns`` orders events within a host; ``wall_ns`` is the
cross-host axis that ``tools/blackbox`` skew-corrects from the heartbeat
stamps each dump also carries.  ``generation`` is the elastic world
generation at record time, bumped by the supervisor on re-shard.

Dumps are atomic per-host JSON files (tmp + fsync + rename — the same
discipline as ``resilience.checkpoint``), keyed by (host, generation,
step), written next to the checkpoint step dirs (``<root>/blackbox``),
into ``MXNET_BLACKBOX_DIR``, or wherever ``configure(root=...)`` pointed.
Triggered on ``DeadNodeError`` / ``DegradedNodeError`` /
``DivergenceError`` / ``abort_to_checkpoint``, on SIGTERM/SIGINT
(faulthandler-style: dump, then chain to the previous handler), and on
demand via ``observe.dump()``.

Knobs (documented in ``mxnet_tpu_torch/env.py``): ``MXNET_BLACKBOX=0``
disables recording entirely, ``MXNET_BLACKBOX_EVENTS`` sizes the ring
(default 4096), ``MXNET_BLACKBOX_DIR`` fixes the dump directory.
"""
from __future__ import annotations

import _thread
import json
import os
import signal
import threading
import time

from .. import env as _env

__all__ = ["FlightRecorder", "record", "events", "snapshot", "dump",
           "reset", "configure", "enabled", "set_rank", "set_generation",
           "set_step", "install_signal_handlers",
           "uninstall_signal_handlers", "SCHEMA_VERSION"]

SCHEMA_VERSION = 1


class FlightRecorder:
    """Bounded ring of structured events; oldest events are overwritten.

    ``record()`` is the only hot call: clocks and the payload tuple are
    built outside the lock, which protects exactly an index bump and a
    slot write.
    """

    def __init__(self, capacity=None, enabled=None):
        self._lock = threading.Lock()
        self._cap = int(capacity) if capacity else _env.blackbox_events()
        self._enabled = (_env.blackbox_enabled()
                         if enabled is None else bool(enabled))
        self._buf = [None] * self._cap
        self._n = 0
        self._rank = 0
        self._generation = 0
        self._step = None
        self._root = None

    # -- hot path ---------------------------------------------------------

    def record(self, category, name, **payload):
        """Append one event; drops silently when disabled."""
        if not self._enabled:
            return
        ev = (time.monotonic_ns(), time.time_ns(), self._rank,
              self._generation, category, name, payload or None)
        with self._lock:
            self._buf[self._n % self._cap] = ev
            self._n += 1

    # -- context ----------------------------------------------------------

    def set_rank(self, rank):
        self._rank = int(rank)

    def set_generation(self, generation):
        self._generation = int(generation)

    def set_step(self, step):
        self._step = None if step is None else int(step)

    def set_root(self, root):
        """Default dump directory parent (the checkpoint root)."""
        if root is not None:
            self._root = os.fspath(root)

    @property
    def enabled(self):
        return self._enabled

    def set_enabled(self, enabled):
        self._enabled = bool(enabled)

    # -- snapshot / dump --------------------------------------------------

    def events(self):
        """Events oldest-first (at most ``capacity``)."""
        with self._lock:
            n, cap = self._n, self._cap
            if n <= cap:
                return [e for e in self._buf[:n]]
            i = n % cap
            return self._buf[i:] + self._buf[:i]

    def snapshot(self, reason="on_demand"):
        """The dump payload as a dict, without touching disk."""
        evs = self.events()
        return {
            "schema": SCHEMA_VERSION,
            "host": self._rank,
            "generation": self._generation,
            "step": self._step,
            "reason": reason,
            "capacity": self._cap,
            "recorded": self._n,
            "dropped": max(0, self._n - self._cap),
            "dumped_mono_ns": time.monotonic_ns(),
            "dumped_wall_ns": time.time_ns(),
            "events": [list(e) for e in evs],
        }

    def _dump_dir(self, root=None):
        env_dir = _env.blackbox_dir()
        if env_dir:
            return env_dir
        base = root if root is not None else self._root
        if base is not None:
            return os.path.join(os.fspath(base), "blackbox")
        return os.path.join(".", "blackbox")

    def dump(self, reason="on_demand", root=None, path=None):
        """Atomically write the per-host dump (tmp + fsync + rename, the
        checkpoint discipline) and return its path, or None when the
        recorder is disabled."""
        if not self._enabled:
            return None
        snap = self.snapshot(reason=reason)
        if path is None:
            d = self._dump_dir(root)
            os.makedirs(d, exist_ok=True)
            step = snap["step"] if snap["step"] is not None else 0
            path = os.path.join(
                d, "blackbox-host%05d-gen%03d-step%010d.json"
                % (snap["host"], snap["generation"], step))
        tmp = "%s.tmp-%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(snap, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        try:
            dirfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:  # the directory's fsync is best effort
            pass
        return path

    def reset(self, capacity=None, enabled=None):
        """Clear the ring and re-read the env knobs (test/gate hook)."""
        with self._lock:
            self._cap = (int(capacity) if capacity
                         else _env.blackbox_events())
            self._enabled = (_env.blackbox_enabled()
                             if enabled is None else bool(enabled))
            self._buf = [None] * self._cap
            self._n = 0
            self._generation = 0
            self._step = None


_recorder = FlightRecorder()


def default_recorder():
    return _recorder


def record(category, name, **payload):
    _recorder.record(category, name, **payload)


def events():
    return _recorder.events()


def snapshot(reason="on_demand"):
    return _recorder.snapshot(reason=reason)


def dump(reason="on_demand", root=None, path=None):
    return _recorder.dump(reason=reason, root=root, path=path)


def reset(capacity=None, enabled=None):
    _recorder.reset(capacity=capacity, enabled=enabled)


def enabled():
    return _recorder.enabled


def configure(root=None, capacity=None, enabled=None):
    """Point the default recorder at a dump root and/or resize it."""
    if root is not None:
        _recorder.set_root(root)
    if capacity is not None or enabled is not None:
        with _recorder._lock:
            if capacity is not None:
                _recorder._cap = int(capacity)
                _recorder._buf = [None] * _recorder._cap
                _recorder._n = 0
            if enabled is not None:
                _recorder._enabled = bool(enabled)


def set_rank(rank):
    _recorder.set_rank(rank)


def set_generation(generation):
    _recorder.set_generation(generation)


def set_step(step):
    _recorder.set_step(step)


_signals_installed = False
# (write fd, read fd, {signum: handler before install}, dumper thread)
# while installed
_signal_state = [None]


def _signal_dumper(read_fd, prev_handlers):
    """Deferred dump worker.  The handler only ``os.write``s the signum
    to a pre-opened pipe (async-signal-safe); this daemon thread does
    the lock-taking work — record + dump + chain — that a handler must
    never do (lockscan signal-unsafe: the signal may have landed on the
    thread that holds the recorder lock)."""
    while True:
        try:
            data = os.read(read_fd, 1)
        except OSError:
            return
        if not data:
            return
        signum = int(data[0])
        _recorder.record("terminal", "signal", signum=signum)
        try:
            _recorder.dump(reason="signal%d" % signum)
        except OSError:  # a failed dump must not mask the signal
            pass
        prev = prev_handlers.get(signum)
        if prev is signal.default_int_handler:
            # the stock Ctrl-C disposition: KeyboardInterrupt belongs on
            # the main thread, not on this worker
            _thread.interrupt_main()
        elif callable(prev):
            prev(signum, None)
        elif prev == signal.SIG_DFL:
            # emulate the default terminate disposition —
            # signal.signal() may only be called from the main thread
            os._exit(128 + signum)


def install_signal_handlers():
    """Dump the flight record on SIGTERM/SIGINT, then chain to the
    previous handler (faulthandler-style).  Self-pipe shape: the
    installed handler only writes the signum to a pre-opened pipe fd
    and returns; a daemon worker performs the actual record + dump
    off-handler.  Idempotent; silently a no-op off the main thread or
    when recording is disabled."""
    global _signals_installed
    if _signals_installed or not _recorder.enabled:
        return False
    rfd = wfd = None
    try:
        prev = {signal.SIGTERM: signal.getsignal(signal.SIGTERM),
                signal.SIGINT: signal.getsignal(signal.SIGINT)}
        rfd, wfd = os.pipe()

        def _handler(signum, frame):
            os.write(wfd, bytes([int(signum)]))

        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
    except ValueError:  # signal.signal raises off the main thread
        if rfd is not None:
            os.close(rfd)
            os.close(wfd)
        return False
    worker = threading.Thread(target=_signal_dumper, args=(rfd, prev),
                              name="flightrec-signal-dumper", daemon=True)
    worker.start()
    _signal_state[0] = (wfd, rfd, prev, worker)
    _signals_installed = True
    return True


def uninstall_signal_handlers():
    """Put back the SIGTERM/SIGINT handlers `install_signal_handlers`
    found and stop its dumper thread (closing the pipe ends it).  Not in
    the reference, whose install is for the process's life; here a test
    undoes what it installed.  Returns False when nothing is
    installed."""
    global _signals_installed
    if not _signals_installed:
        return False
    wfd, rfd, prev, worker = _signal_state[0]
    for signum, handler in prev.items():
        signal.signal(signum, handler)
    os.close(wfd)
    worker.join(timeout=5)
    os.close(rfd)
    _signal_state[0] = None
    _signals_installed = False
    return True
