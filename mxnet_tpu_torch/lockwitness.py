"""Runtime lock-acquisition witness (``MXNET_LOCKSCAN_WITNESS=1``)
(counterpart of `mxnet_tpu/lockwitness.py`).

An opt-in shim over ``threading.Lock``/``threading.RLock`` that records,
per thread, the stack of held locks at every acquisition and merges the
``held -> acquired`` pairs into a global order graph.  An acquisition
that would close a cycle in the observed graph raises
:class:`LockOrderViolation` at the offending ``acquire()``, and a process
exiting with recorded violations dies with status 70.  With
``MXNET_LOCKSCAN_REPORT`` set, the observed graph is dumped there at
exit, in the reference's format.

This module is imported at the very top of ``mxnet_tpu_torch/__init__``
when the variable is set, before any other package import creates a
lock, so it imports nothing of the package.  Only locks whose creating
frame (skipping ``threading.py`` and the lock witnesses' own frames)
lies inside ``mxnet_tpu_torch/`` are wrapped.  Names are
``"<relpath>:<lineno>"`` creation sites.

`install` wraps the factories it finds in ``threading`` and `uninstall`
puts exactly those back, so this witness and another one (the JAX
package's, in a process that imports both) may be installed and
uninstalled around each other; the witness's own lock is a raw
``_thread`` lock.
"""
from __future__ import annotations

import _thread
import atexit
import json
import os
import sys
import threading

__all__ = ["LockOrderViolation", "install", "uninstall", "installed",
           "named_lock", "observed_edges", "violations", "reset",
           "check_acyclic", "EXIT_CODE"]

#: process exit status when violations were recorded (atexit enforcement)
EXIT_CODE = 70

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG_DIR)
_THREADING_FILE = threading.__file__

_real_lock = _thread.allocate_lock
_real_rlock = _thread.RLock
# the factories `install` found and `uninstall` puts back
_found = [None, None]


class LockOrderViolation(RuntimeError):
    """An acquisition closed a cycle in the observed order graph."""


class _State:
    def __init__(self):
        # built with the REAL factory: the witness's own lock must not
        # witness itself
        self.mutex = _real_lock()
        self.edges = {}              # src name -> set(dst names)
        self.violations = []         # human-readable strings
        self.tls = threading.local()

    def held(self):
        stack = getattr(self.tls, "stack", None)
        if stack is None:
            stack = self.tls.stack = []
        return stack


_state = _State()
_installed = False
_atexit_registered = False


def _witness_frame(filename):
    """A frame of ``threading.py``, of this module or of another lock
    witness (one installed under or over this one)."""
    return filename in (_THREADING_FILE, __file__) or \
        os.path.basename(filename) == "lockwitness.py"


def _creation_site():
    """(relpath, lineno) of the first non-threading, non-witness frame —
    or None when the lock is not created from inside the package."""
    f = sys._getframe(2)
    while f is not None and _witness_frame(f.f_code.co_filename):
        f = f.f_back
    if f is None:
        return None
    fn = f.f_code.co_filename
    if not fn.startswith(_PKG_DIR + os.sep):
        return None
    return (os.path.relpath(fn, _ROOT).replace(os.sep, "/"), f.f_lineno)


class _WitnessLock:
    """Order-tracking wrapper around one Lock/RLock.

    Delegates ``_is_owned``/``_acquire_restore``/``_release_save`` raw,
    so a ``Condition.wait()``'s release-and-reacquire round trip leaves
    the held stack untouched — the waiting thread acquires nothing
    while parked, so keeping its slot is both harmless and what makes
    the post-wait state consistent again.
    """

    def __init__(self, inner, name, reentrant):
        self._inner = inner
        self._name = name
        self._reentrant = reentrant

    # -- order bookkeeping -------------------------------------------------
    def _note_acquired(self):
        """Record held->self edges; raise on a cycle-closing edge BEFORE
        pushing the held-stack slot (the caller releases the raw lock,
        so a caught violation leaves the witness state consistent)."""
        stack = _state.held()
        for entry in stack:
            if entry[0] is self:
                entry[1] += 1       # reentrant re-acquire: no new edge
                return
        new_cycle = None
        with _state.mutex:
            for held, _n in stack:
                pair = (held._name, self._name)
                if pair[0] == pair[1]:
                    continue
                if pair[1] not in _state.edges.get(pair[0], ()):
                    if self._reaches(pair[1], pair[0]):
                        path = self._path(pair[1], pair[0])
                        new_cycle = (f"{pair[0]} -> {pair[1]} closes the "
                                     f"cycle {' -> '.join(path + [pair[1]])} "
                                     f"(thread "
                                     f"{threading.current_thread().name})")
                        _state.violations.append(new_cycle)
                    _state.edges.setdefault(pair[0], set()).add(pair[1])
        if new_cycle is not None:
            raise LockOrderViolation(new_cycle)
        stack.append([self, 1])

    @staticmethod
    def _reaches(src, dst):
        stack, seen = [src], set()
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(_state.edges.get(n, ()))
        return False

    @staticmethod
    def _path(src, dst):
        """One src -> ... -> dst walk through the observed edges."""
        stack, seen = [[src]], set()
        while stack:
            path = stack.pop()
            if path[-1] == dst:
                return path
            if path[-1] in seen:
                continue
            seen.add(path[-1])
            for nxt in _state.edges.get(path[-1], ()):
                stack.append(path + [nxt])
        return [src, dst]

    def _note_released(self):
        stack = _state.held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is self:
                stack[i][1] -= 1
                if stack[i][1] == 0:
                    del stack[i]
                return

    # -- lock protocol -----------------------------------------------------
    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._note_acquired()
            except LockOrderViolation:
                self._inner.release()
                raise
        return got

    def release(self):
        self._inner.release()
        self._note_released()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # Condition() plumbing: raw delegation (see class docstring), with
    # the stdlib's own acquire/release fallbacks for plain Locks
    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            return self._inner._acquire_restore(state)
        self._inner.acquire()

    def _release_save(self):
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()

    def __repr__(self):
        return f"<witness {self._name} over {self._inner!r}>"


def _make_factory(real, reentrant):
    def factory():
        site = _creation_site()
        if site is None:
            return real()
        name = f"{site[0]}:{site[1]}"
        return _WitnessLock(real(), name, reentrant)
    return factory


def named_lock(name, reentrant=False):
    """A witness-tracked lock with an explicit name (test helper —
    works whether or not the factories are installed)."""
    real = _real_rlock if reentrant else _real_lock
    return _WitnessLock(real(), name, reentrant)


def observed_edges():
    """Snapshot of the observed order graph as sorted (src, dst) pairs."""
    with _state.mutex:
        return sorted((s, d) for s, dsts in _state.edges.items()
                      for d in dsts)


def violations():
    with _state.mutex:
        return list(_state.violations)


def reset():
    """Drop every observed edge and violation, plus the calling
    thread's held stack (test isolation)."""
    with _state.mutex:
        _state.edges.clear()
        _state.violations.clear()
    _state.held().clear()


def check_acyclic():
    """True when the observed graph has no cycle.  (Edges are only ever
    added after a reachability check, so a cycle implies a recorded
    violation — this is the atexit assertion, callable from tests.)"""
    with _state.mutex:
        edges = {s: set(d) for s, d in _state.edges.items()}
    seen, done = set(), set()

    def dfs(n):
        seen.add(n)
        for nxt in edges.get(n, ()):
            if nxt in seen and nxt not in done:
                return False
            if nxt not in seen and not dfs(nxt):
                return False
        done.add(n)
        return True

    return all(dfs(n) for n in list(edges) if n not in seen)


def _at_exit():
    report = os.environ.get("MXNET_LOCKSCAN_REPORT", "")
    vios = violations()
    if report:
        payload = {
            "version": 1,
            "edges": [list(e) for e in observed_edges()],
            "violations": vios,
            "acyclic": check_acyclic() and not vios,
        }
        try:
            with open(report, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=2)
                f.write("\n")
        except OSError:
            sys.stderr.write(f"lockwitness: cannot write report "
                             f"{report}\n")
    if vios:
        sys.stderr.write("lockwitness: FAIL — lock-order violations "
                         "observed:\n")
        for v in vios:
            sys.stderr.write(f"  {v}\n")
        sys.stderr.flush()
        os._exit(EXIT_CODE)


def install():
    """Wrap the threading lock factories found now (idempotent).  Must
    run before the package creates its locks — ``mxnet_tpu_torch/
    __init__`` does this first-thing when ``MXNET_LOCKSCAN_WITNESS=1``."""
    global _installed, _atexit_registered
    if _installed:
        return False
    _found[:] = [threading.Lock, threading.RLock]
    threading.Lock = _make_factory(_found[0], reentrant=False)
    threading.RLock = _make_factory(_found[1], reentrant=True)
    if not _atexit_registered:
        atexit.register(_at_exit)
        _atexit_registered = True
    _installed = True
    return True


def uninstall():
    """Put back the factories `install` found (already-wrapped locks keep
    working)."""
    global _installed
    if not _installed:
        return False
    threading.Lock, threading.RLock = _found
    _found[:] = [None, None]
    _installed = False
    return True


def installed():
    return _installed
