"""SLA-aware request routing for the replica fleet (counterpart of
`mxnet_tpu/serve/router.py`; pure Python, as there).

Requests carry a **service class** (priority + deadline + declared p99
objective).  The router is a single priority heap drained by the
fleet's dispatcher: higher-priority classes always dispatch first, FIFO
within a class (a monotonic sequence number breaks ties, so the heap is
stable).  A request whose deadline passes before a replica could take
it is **shed** — its future fails with :class:`DeadlineExceeded`, a
distinct error the caller can tell apart from a model failure; nothing
is ever silently dropped.

Replica choice is least-loaded-healthy: among routable replicas (minus
any the request already failed on), pick the smallest in-flight +
queued load.  No healthy replica at all raises
:class:`NoHealthyReplica` carrying the full per-replica fleet state, so
the operator sees *why*.

The default class table scales off one knob (``MXNET_SERVE_DEADLINE_MS``,
see :mod:`mxnet_tpu_torch.env`):

============ ======== ================= =========================
class        priority deadline           declared p99 objective
============ ======== ================= =========================
interactive  0        1x base            2x its deadline
standard     1        4x base            2x its deadline
batch        2        20x base           2x its deadline
============ ======== ================= =========================
"""
from __future__ import annotations

import heapq
import itertools
import threading

from .. import env as _env

__all__ = [
    "SLAClass", "default_classes", "PriorityRouter",
    "UnknownServiceClass", "DeadlineExceeded", "NoHealthyReplica",
    "ReplicaUnavailable", "FleetClosed",
]


class UnknownServiceClass(ValueError):
    """submit() named a service class the router has no entry for."""


class DeadlineExceeded(RuntimeError):
    """The request was shed: its deadline passed before a replica could
    serve it.  Distinct from a model failure and from a silent drop —
    the caller always gets this exception, never nothing."""


class NoHealthyReplica(RuntimeError):
    """Every replica is ejected/dead/draining (message carries the
    per-replica fleet state)."""


class ReplicaUnavailable(RuntimeError):
    """A pinned submit targeted a replica that is not routable
    (ejected, dead, or draining)."""


class FleetClosed(RuntimeError):
    """submit() after Fleet.shutdown(), or pending at a non-draining
    shutdown."""


class SLAClass:
    """One service class: name, strict priority (lower dispatches
    first), default deadline, and the declared p99 latency objective the
    storm gate checks against."""

    __slots__ = ("name", "priority", "deadline_ms", "p99_slo_ms")

    def __init__(self, name, priority, deadline_ms, p99_slo_ms=None):
        self.name = name
        self.priority = int(priority)
        self.deadline_ms = float(deadline_ms)
        # default objective: twice the deadline — sheds fire at the
        # deadline, so completions can only exceed it by the in-flight
        # device call; 2x is the honest envelope for a gate
        self.p99_slo_ms = float(p99_slo_ms if p99_slo_ms is not None
                                else 2.0 * deadline_ms)

    def __repr__(self):
        return (f"SLAClass({self.name!r}, priority={self.priority}, "
                f"deadline_ms={self.deadline_ms}, "
                f"p99_slo_ms={self.p99_slo_ms})")


def default_classes(base_deadline_ms=None):
    """The three-tier default table, scaled off MXNET_SERVE_DEADLINE_MS
    (or an explicit base)."""
    base = (_env.serve_deadline_ms() if base_deadline_ms is None
            else float(base_deadline_ms))
    return {
        "interactive": SLAClass("interactive", 0, base),
        "standard": SLAClass("standard", 1, 4 * base),
        "batch": SLAClass("batch", 2, 20 * base),
    }


class PriorityRouter:
    """Priority heap + class table + replica picker (thread-safe)."""

    def __init__(self, classes=None, base_deadline_ms=None):
        self.classes = dict(classes if classes is not None
                            else default_classes(base_deadline_ms))
        self._heap = []
        self._seq = itertools.count()
        self._cv = threading.Condition()

    def resolve_class(self, name):
        """The :class:`SLAClass` for ``name``; unknown names raise with
        the supported list (never a bare KeyError)."""
        try:
            return self.classes[name]
        except KeyError:
            supported = ", ".join(
                repr(c.name) for c in
                sorted(self.classes.values(), key=lambda c: c.priority))
            raise UnknownServiceClass(
                f"unknown service class {name!r}: supported classes are "
                f"{supported} (priority order; docs/SERVING.md \"Fleet\")"
            ) from None

    def push(self, item, priority):
        """Enqueue one item at ``priority`` (lower pops first; FIFO
        within a priority)."""
        with self._cv:
            heapq.heappush(self._heap, (priority, next(self._seq), item))
            self._cv.notify()

    def pop(self, timeout=None):
        """Highest-priority item, or None after ``timeout`` seconds."""
        with self._cv:
            # wait_for re-checks the predicate across spurious wakeups and
            # notifies consumed by a faster sibling: a bare wait() would
            # return None early whenever two dispatchers race one notify
            if not self._cv.wait_for(lambda: self._heap, timeout):
                return None
            return heapq.heappop(self._heap)[2]

    def pending(self):
        with self._cv:
            return len(self._heap)

    def drain(self):
        """Remove and return every queued item (shutdown path)."""
        with self._cv:
            items = [entry[2] for entry in sorted(self._heap)]
            self._heap = []
            return items

    @staticmethod
    def pick_replica(replicas, exclude=(), state_fn=None):
        """Least-loaded routable replica, skipping ``exclude`` indices.
        Raises :class:`NoHealthyReplica` (with the fleet state from
        ``state_fn``) when none qualifies."""
        healthy = [r for r in replicas
                   if r.is_routable() and r.index not in exclude]
        if not healthy:
            detail = state_fn() if state_fn is not None else ", ".join(
                f"r{r.index}={r.state}" for r in replicas)
            raise NoHealthyReplica(
                f"no healthy replica to route to — fleet state: {detail} "
                f"(docs/SERVING.md \"Fleet\")")
        return min(healthy, key=lambda r: r.load())
