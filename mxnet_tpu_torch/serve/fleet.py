"""Replica fleet: N endpoints behind one SLA-aware front door
(counterpart of `mxnet_tpu/serve/fleet.py`).

``Fleet`` pools :class:`~mxnet_tpu_torch.serve.Endpoint` replicas:

* **replicas** — N endpoints, each on one device of ``devices`` (by
  default every visible card).  More replicas than devices share them
  round-robin, with a ``RuntimeWarning``: replicas on one card take
  turns, since every CUDA graph replay and capture of the process holds
  `ops.capture.GRAPH_LOCK`;
* **SLA routing** — requests carry a service class (priority +
  deadline, :mod:`mxnet_tpu_torch.serve.router`); a single dispatcher
  drains the class-priority heap and places each request on the
  least-loaded healthy replica.  Deadline-passed requests are **shed**
  with :class:`DeadlineExceeded` — a distinct error, never a silent
  drop: every admitted future resolves as completed, shed, or failed;
* **health** — consecutive replica failures eject it from routing
  (``MXNET_SERVE_EJECT_AFTER``, default 2: the two-observation suspicion
  rule); ejected-but-alive replicas are probed and readmitted on a fresh
  success.  A killed replica (``serve.replica`` faultline preempt, or a
  dead worker) fails over: its queued requests fail with
  ``EndpointClosed`` and reroute to survivors, the recovery ticks
  ``mxtpu_faults_recovered_total{site="serve.replica"}``, and the
  death-to-first-rerouted-completion interval lands in
  ``mxtpu_fleet_failover_seconds``.  A killed replica keeps its graphs
  and static buffers (its endpoint holds them), so a replay it was in
  the middle of completes;
* **hot swap** — :meth:`swap_model` delegates to every replica's
  :meth:`Endpoint.swap_model`: the new version's graphs are captured
  over the live grid before an atomic flip, and each in-flight request
  is answered by the version that admitted it.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
import warnings

from .. import env as _env
from .. import observe as _observe
from .. import telemetry as _telemetry
from ..context import gpu, num_gpus, resolve_device
from ..resilience import faultline as _faultline
from ..resilience.policies import TRANSIENT_EXCEPTIONS
from .endpoint import Endpoint, EndpointClosed, QueueFullError, \
    RequestTimeout
from .router import DeadlineExceeded, FleetClosed, NoHealthyReplica, \
    PriorityRouter, ReplicaUnavailable

__all__ = ["Fleet", "Replica", "FleetMetrics",
           "HEALTHY", "EJECTED", "DEAD", "DRAINING"]

HEALTHY = "healthy"
EJECTED = "ejected"      # suspicion threshold crossed; probing readmits
DEAD = "dead"            # endpoint killed; terminal
DRAINING = "draining"    # operator-initiated removal from routing

_FLEET_EVENTS = ("submitted", "completed", "shed", "rerouted", "failed")

_counter = itertools.count()


class FleetMetrics:
    """Fleet-level registry series (per-class lifecycle counters and
    latency histograms, replica-state gauge, failover timer)."""

    _STATE_CODE = {HEALTHY: 0, EJECTED: 1, DEAD: 2, DRAINING: 3}

    def __init__(self, name, class_names):
        self.name = name
        reg = _telemetry.default_registry()
        req = reg.counter(
            "mxtpu_fleet_requests_total",
            "Fleet requests by service class and lifecycle event (every "
            "submit ends as completed, shed, or failed — shed means the "
            "deadline passed, distinct from a model failure)",
            ("fleet", "cls", "event"))
        self._req = {(c, e): req.labels(fleet=name, cls=c, event=e)
                     for c in class_names for e in _FLEET_EVENTS}
        lat = reg.histogram(
            "mxtpu_fleet_latency_seconds",
            "End-to-end fleet request latency by service class (submit "
            "to delivery, reroutes included)", ("fleet", "cls"))
        self._lat = {c: lat.labels(fleet=name, cls=c) for c in class_names}
        self._state = reg.gauge(
            "mxtpu_fleet_replica_state",
            "Replica health state: 0 healthy, 1 ejected, 2 dead, "
            "3 draining", ("fleet", "replica"))
        self._probes = reg.counter(
            "mxtpu_fleet_probes_total",
            "Re-admission probes sent to ejected replicas, by outcome",
            ("fleet", "outcome"))
        self._failover = reg.histogram(
            "mxtpu_fleet_failover_seconds",
            "Replica death to the first rerouted request completing on "
            "a survivor", ("fleet",)).labels(fleet=name)

    def event(self, cls, event):
        self._req[(cls, event)].inc()

    def value(self, cls, event):
        return self._req[(cls, event)].value

    def observe_latency(self, cls, seconds):
        self._lat[cls].observe(seconds)

    def latency_quantile(self, cls, q):
        return self._lat[cls].quantile(q)

    def set_replica_state(self, index, state):
        self._state.labels(fleet=self.name, replica=f"r{index}").set(
            self._STATE_CODE[state])

    def probe(self, outcome):
        self._probes.labels(fleet=self.name, outcome=outcome).inc()

    def observe_failover(self, seconds):
        self._failover.observe(seconds)


class Replica:
    """One fleet slot: an endpoint plus its health bookkeeping.

    The ejection rule is the reference kvstore's liveness rule: one
    failure makes a replica SUSPECT
    (the counter), a configurable streak (default two — the
    two-observation rule) ejects it, and any fresh success clears the
    suspicion entirely.
    """

    def __init__(self, index, endpoint, eject_after):
        self.index = index
        self.endpoint = endpoint
        self.eject_after = eject_after
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.inflight = 0        # fleet-dispatched, unresolved
        self.last_probe = 0.0
        self._lock = threading.Lock()

    def is_routable(self):
        return self.state == HEALTHY

    def load(self):
        return self.inflight + self.endpoint._queue.qsize()

    def note_dispatch(self):
        with self._lock:
            self.inflight += 1

    def note_done(self):
        with self._lock:
            self.inflight -= 1

    def record_failure(self):
        """One bad observation; returns True when it crossed the
        ejection threshold (caller updates the state gauge)."""
        with self._lock:
            self.consecutive_failures += 1
            crossed = (self.state == HEALTHY
                       and self.consecutive_failures >= self.eject_after)
            if crossed:
                self.state = EJECTED
                failures = self.consecutive_failures
        if crossed:
            _observe.record("fleet", "replica_ejected",
                            replica=self.index, failures=failures)
        return crossed

    def record_success(self):
        """Fresh observation clears suspicion; readmits an ejected
        replica (probe success).  Returns True on readmission."""
        with self._lock:
            self.consecutive_failures = 0
            readmitted = self.state == EJECTED
            if readmitted:
                self.state = HEALTHY
        if readmitted:
            _observe.record("fleet", "replica_readmitted",
                            replica=self.index)
        return readmitted

    def set_state(self, state):
        with self._lock:
            self.state = state

    def describe(self):
        cf = self.consecutive_failures
        return f"r{self.index}={self.state}" + (f"(cf={cf})" if cf else "")


class _FleetRequest:
    __slots__ = ("arrays", "sla", "future", "t_submit", "deadline",
                 "pinned", "excluded", "attempts", "pending_fault",
                 "rerouted")

    def __init__(self, arrays, sla, deadline_s, pinned):
        from concurrent.futures import Future
        self.arrays = arrays
        self.sla = sla
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + deadline_s) if deadline_s \
            else None
        self.pinned = pinned
        self.excluded = set()    # replicas this request already failed on
        self.attempts = 0
        self.pending_fault = None  # injected fault kind awaiting recovery
        self.rerouted = False


class Fleet:
    """N health-tracked :class:`Endpoint` replicas behind one
    SLA-routing ``submit``/``predict`` interface.

    Parameters
    ----------
    model : gluon.Block or callable
        Shared by every replica (each captures its own bucket graphs on
        its own device); its parameters lie on the replicas' device.
    replicas : int or None
        Pool size (default ``MXNET_SERVE_REPLICAS``).
    classes : dict[str, SLAClass] or None
        Service-class table (default :func:`router.default_classes`).
    devices : sequence of torch devices or contexts, or None
        Devices to spread the replicas over (default: every visible
        card; without CUDA that raises unless ``devices`` names the
        CPU).  Replica ``i`` serves on ``devices[i*k]``, ``k =
        len(devices) // replicas``.  More replicas than devices forfeits
        the disjoint-device guarantee: replicas share devices
        round-robin, with a ``RuntimeWarning``.
    eject_after : int or None
        Consecutive-failure ejection threshold (default
        ``MXNET_SERVE_EJECT_AFTER`` = 2).
    probe_interval : float
        Seconds between re-admission probes per ejected replica.
    **endpoint_kwargs
        Forwarded to every replica's :class:`Endpoint`.
    """

    def __init__(self, model, replicas=None, name=None, classes=None,
                 devices=None, eject_after=None, probe_interval=0.25,
                 start=True, **endpoint_kwargs):
        self.name = name or f"fleet_{next(_counter)}"
        n = int(replicas) if replicas is not None \
            else _env.serve_replicas()
        if devices is None:
            # every visible card; none raises, naming the CPU opt-in
            devices = [gpu(i) for i in range(num_gpus())] \
                or [resolve_device(None)]
        devices = [resolve_device(d) for d in devices]
        self.router = PriorityRouter(classes=classes)
        self.eject_after = int(eject_after) if eject_after is not None \
            else _env.serve_eject_after()
        self.probe_interval = probe_interval
        self.metrics = FleetMetrics(self.name, list(self.router.classes))
        if n > len(devices):
            warnings.warn(
                f"fleet {self.name}: {n} replicas over {len(devices)} "
                "device(s) — replicas will share devices, voiding the "
                "disjoint-slice guarantee (their programs contend for "
                "the same chip); use replicas <= devices for isolation",
                RuntimeWarning, stacklevel=2)
        k = max(1, len(devices) // n)
        self.replicas = []
        for i in range(n):
            dev = devices[(i * k) % len(devices)]
            ep = Endpoint(model, name=f"{self.name}/r{i}", device=dev,
                          start=start, **endpoint_kwargs)
            self.replicas.append(Replica(i, ep, self.eject_after))
            self.metrics.set_replica_state(i, HEALTHY)
        self._example_arrays = None   # probe payload (first real request)
        self._death_ts = None         # failover stopwatch start
        self._inflight = 0            # dispatched to endpoints, unresolved
        self._closed = False
        self._drain = True
        self._lock = threading.Lock()
        self._dispatcher = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        for rep in self.replicas:
            if rep.state != DEAD:
                rep.endpoint.start()
        if self._dispatcher is None or not self._dispatcher.is_alive():
            self._closed = False
            self._dispatcher = threading.Thread(
                target=self._run, name=f"fleet:{self.name}", daemon=True)
            self._dispatcher.start()
        return self

    def shutdown(self, drain=True, timeout=60):
        """Stop the fleet.  ``drain=True`` serves everything already
        admitted first; ``drain=False`` fails queued requests with
        :class:`FleetClosed` (still never a silent drop)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._drain = drain
        if self._dispatcher is not None and self._dispatcher.is_alive():
            self._dispatcher.join(timeout=timeout)
        if self._dispatcher is None or not self._dispatcher.is_alive():
            # the dispatcher is gone: anything still on the heap (a
            # non-draining close, or a submit that raced the close) has
            # no one left to serve it — fail it, never strand it
            for req in self.router.drain():
                self._fail(req, FleetClosed(
                    f"fleet {self.name} shut down without draining"))
        for rep in self.replicas:
            if rep.state != DEAD:
                rep.endpoint.shutdown(drain=drain, timeout=timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- intake ------------------------------------------------------------
    _to_numpy = staticmethod(Endpoint._to_numpy)

    def submit(self, *inputs, cls="standard", timeout_ms=None,
               replica=None):
        """Enqueue one request under service class ``cls``.  Returns a
        Future that resolves to the model output, or raises
        :class:`DeadlineExceeded` (shed) / the model's own error.
        ``timeout_ms`` overrides the class deadline; ``replica`` pins
        the request to one replica (raises
        :class:`ReplicaUnavailable` unless it is healthy)."""
        sla = self.router.resolve_class(cls)
        if replica is not None:
            replica = int(replica)
            if not 0 <= replica < len(self.replicas):
                raise ReplicaUnavailable(
                    f"replica index {replica} is out of range for fleet "
                    f"{self.name}: valid replicas are "
                    f"0..{len(self.replicas) - 1} "
                    f"(docs/SERVING.md \"Fleet\")")
            rep = self.replicas[replica]
            if not rep.is_routable():
                raise ReplicaUnavailable(
                    f"replica r{replica} of fleet {self.name} is "
                    f"{rep.state} and cannot take pinned requests — "
                    f"fleet state: {self.describe_state()} "
                    f"(docs/SERVING.md \"Fleet\")")
        arrays = [self._to_numpy(x) for x in inputs]
        deadline_s = (timeout_ms / 1e3) if timeout_ms is not None \
            else sla.deadline_ms / 1e3
        req = _FleetRequest(arrays, sla, deadline_s, replica)
        # closed-check and push are one atomic step: a submit racing a
        # shutdown must either raise here or land on the heap before the
        # dispatcher's drain check can see it — never push into a loop
        # that already exited (a stranded future)
        with self._lock:
            if self._closed:
                raise FleetClosed(f"fleet {self.name} is shut down")
            self.metrics.event(sla.name, "submitted")
            self.router.push(req, sla.priority)
        return req.future

    def predict(self, *inputs, cls="standard", timeout_ms=None,
                replica=None):
        """Blocking submit."""
        fut = self.submit(*inputs, cls=cls, timeout_ms=timeout_ms,
                          replica=replica)
        t = (timeout_ms / 1e3) if timeout_ms is not None \
            else self.router.resolve_class(cls).deadline_ms / 1e3
        # backstop well past the deadline: the shed path resolves the
        # future long before this fires
        return fut.result(timeout=t + 120)

    # -- dispatcher --------------------------------------------------------
    def _run(self):
        while True:
            self._probe_ejected()
            req = self.router.pop(timeout=0.05)
            if req is None:
                if self._closed:
                    if not self._drain:
                        break
                    with self._lock:
                        # a request is either terminal, on the heap, or
                        # counted in _inflight (callbacks re-push BEFORE
                        # decrementing) — so both empty means truly done
                        if self._inflight == 0 \
                                and self.router.pending() == 0:
                            break
                continue
            if self._closed and not self._drain:
                self._fail(req, FleetClosed(
                    f"fleet {self.name} shut down without draining"))
                continue
            self._dispatch_once(req)

    def _dispatch_once(self, req):
        now = time.perf_counter()
        if req.deadline is not None and now > req.deadline:
            self._shed(req, now)
            return
        if req.pinned is not None:
            target = self.replicas[req.pinned]
            if not target.is_routable():
                self._fail(req, ReplicaUnavailable(
                    f"replica r{req.pinned} of fleet {self.name} became "
                    f"{target.state} before dispatch — fleet state: "
                    f"{self.describe_state()} "
                    f"(docs/SERVING.md \"Fleet\")"))
                return
        else:
            try:
                target = self.router.pick_replica(
                    self.replicas, exclude=req.excluded,
                    state_fn=self.describe_state)
            except NoHealthyReplica as exc:
                if all(r.state == DEAD for r in self.replicas):
                    self._fail(req, exc)   # nothing will ever come back
                    return
                # ejected/draining replicas may return: hold the request
                # (its own deadline bounds the wait — it sheds, not spins)
                req.excluded.clear()
                time.sleep(0.005)
                self.router.push(req, req.sla.priority)
                return
        # replica-level chaos hook: a planned preempt kills the replica
        # the router just picked; the request itself must survive by
        # rerouting — that completion ticks the recovered counter
        try:
            _faultline.check("serve.replica")
        except _faultline.InjectedPreemption:
            self.kill_replica(target.index)
            self._reroute(req, target, fault_kind="preempt")
            return
        except _faultline.InjectedTimeout:
            if target.record_failure():
                self.metrics.set_replica_state(target.index, target.state)
            self._reroute(req, target, fault_kind="timeout")
            return
        except _faultline.InjectedError as exc:
            self._fail(req, exc)   # non-transient: surfaces, not retried
            return
        remaining_ms = max((req.deadline - now) * 1e3, 1.0) \
            if req.deadline is not None else None
        try:
            fut = target.endpoint.submit(*req.arrays,
                                         timeout_ms=remaining_ms)
        except (EndpointClosed, QueueFullError):
            # replica can't take it right now — reroute, no health strike
            # for backpressure (a full queue is load, not sickness)
            self._reroute(req, target)
            return
        target.note_dispatch()
        with self._lock:
            self._inflight += 1
        fut.add_done_callback(
            functools.partial(self._on_result, req, target))

    def _on_result(self, req, target, fut):
        target.note_done()
        exc = fut.exception()
        now = time.perf_counter()
        try:
            if exc is None:
                if target.record_success():
                    self.metrics.set_replica_state(target.index,
                                                   target.state)
                self._complete(req, fut.result(), now)
            elif isinstance(exc, RequestTimeout):
                self._shed(req, now)
            elif isinstance(exc, (EndpointClosed,) + TRANSIENT_EXCEPTIONS):
                # the replica died under the request (or its transport
                # timed out past the retry budget): health strike +
                # reroute
                if target.record_failure():
                    self.metrics.set_replica_state(target.index,
                                                   target.state)
                if self._closed and not self._drain:
                    self._fail(req, FleetClosed(
                        f"fleet {self.name} shut down without draining"))
                elif req.attempts >= len(self.replicas) + 1:
                    self._fail(req, exc)  # bounded: no infinite bounce
                else:
                    self._reroute(req, target)
            else:
                # a real model error is the caller's answer (a failed
                # request, not a dropped one)
                self._fail(req, exc)
        finally:
            # decrement only once the request is terminal or back on the
            # heap: the drain condition reads _inflight together with
            # router.pending(), and decrementing before the re-push
            # opens a window where both look empty while the request is
            # in neither place — the dispatcher would exit and strand it
            with self._lock:
                self._inflight -= 1

    # -- request terminal states (every admitted future hits exactly one) --
    def _complete(self, req, result, now):
        if not req.future.done():
            req.future.set_result(result)
        self.metrics.event(req.sla.name, "completed")
        self.metrics.observe_latency(req.sla.name, now - req.t_submit)
        if req.pending_fault is not None:
            _faultline.recovered("serve.replica", req.pending_fault)
            req.pending_fault = None
        failover = None
        with self._lock:
            if req.rerouted and self._death_ts is not None:
                failover = now - self._death_ts
                self.metrics.observe_failover(failover)
                self._death_ts = None
            if self._example_arrays is None:
                # remember a 1-row probe payload for re-admission checks
                self._example_arrays = [a[:1].copy() for a in req.arrays]
        if failover is not None:
            _observe.record("fleet", "failover", seconds=failover)

    def _shed(self, req, now):
        if not req.future.done():
            budget_ms = (req.deadline - req.t_submit) * 1e3 \
                if req.deadline is not None else float("nan")
            req.future.set_exception(DeadlineExceeded(
                f"request (class {req.sla.name!r}) shed after "
                f"{(now - req.t_submit) * 1e3:.1f} ms: its "
                f"{budget_ms:.0f} ms deadline passed before a replica "
                f"could serve it — shed, not dropped "
                f"(docs/SERVING.md \"Fleet\")"))
        self.metrics.event(req.sla.name, "shed")

    def _fail(self, req, exc):
        if not req.future.done():
            req.future.set_exception(exc)
        self.metrics.event(req.sla.name, "failed")

    def _reroute(self, req, failed_target, fault_kind=None):
        req.excluded.add(failed_target.index)
        req.attempts += 1
        req.rerouted = True
        if fault_kind is not None:
            req.pending_fault = fault_kind
        self.metrics.event(req.sla.name, "rerouted")
        _observe.record("fleet", "reroute", replica=failed_target.index,
                        sla=req.sla.name, fault=fault_kind,
                        attempts=req.attempts)
        self.router.push(req, req.sla.priority)

    # -- health ------------------------------------------------------------
    def kill_replica(self, index):
        """Replica death (injected or operator-driven): mark it dead and
        fail over.  Its queued requests fail with ``EndpointClosed`` and
        reroute through their callbacks; the failover stopwatch starts
        now and stops at the first rerouted completion."""
        target = self.replicas[index]
        target.set_state(DEAD)
        self.metrics.set_replica_state(index, DEAD)
        _observe.record("fleet", "replica_dead", replica=index)
        with self._lock:
            if self._death_ts is None:
                self._death_ts = time.perf_counter()
        target.endpoint.shutdown(drain=False, timeout=60)

    def drain_replica(self, index):
        """Operator removal: stop routing to the replica, serve what it
        already has, keep it out of the pool."""
        target = self.replicas[index]
        target.set_state(DRAINING)
        self.metrics.set_replica_state(index, DRAINING)
        target.endpoint.shutdown(drain=True, timeout=60)

    def _probe_ejected(self):
        """Re-admission: ejected (but alive) replicas get a 1-row probe
        every ``probe_interval``; a fresh success readmits them."""
        with self._lock:
            example = self._example_arrays
        if example is None:
            return
        now = time.perf_counter()
        for rep in self.replicas:
            if rep.state != EJECTED or now - rep.last_probe \
                    < self.probe_interval:
                continue
            rep.last_probe = now
            probe_ms = min(c.deadline_ms
                           for c in self.router.classes.values())
            try:
                fut = rep.endpoint.submit(*example, timeout_ms=probe_ms)
            except Exception:  # noqa: BLE001
                # a probe that cannot even be submitted IS the answer
                # (endpoint gone or closed): it ticks the fail outcome and
                # the replica stays ejected until a later probe lands
                self.metrics.probe("fail")
                continue
            fut.add_done_callback(
                functools.partial(self._on_probe, rep))

    def _on_probe(self, rep, fut):
        if fut.exception() is None:
            self.metrics.probe("ok")
            if rep.record_success():
                self.metrics.set_replica_state(rep.index, rep.state)
        else:
            self.metrics.probe("fail")
            rep.record_failure()

    # -- model management --------------------------------------------------
    def swap_model(self, model, stage=True):
        """Hot-swap every live replica to ``model`` (staged capture,
        atomic flip, in-flight requests keep their admitting version —
        see :meth:`Endpoint.swap_model`).  Returns
        ``{replica: new_version}``."""
        return {f"r{rep.index}": rep.endpoint.swap_model(model,
                                                         stage=stage)
                for rep in self.replicas if rep.state != DEAD}

    def warmup(self, *example_inputs):
        """Warm (on the card: capture) every live replica's bucket grid;
        also seeds the re-admission probe payload.  Returns the total
        entries warmed."""
        with self._lock:
            need_seed = self._example_arrays is None
        if need_seed:
            # the device->host copy happens OUTSIDE the fleet lock:
            # submit/dispatch must not stall behind a warmup transfer; the
            # publish under the lock is a cheap idempotent flip
            arrays = [self._to_numpy(x)[:1].copy() for x in example_inputs]
            with self._lock:
                if self._example_arrays is None:
                    self._example_arrays = arrays
        return sum(rep.endpoint.warmup(*example_inputs)
                   for rep in self.replicas if rep.state != DEAD)

    # -- introspection -----------------------------------------------------
    def describe_state(self):
        return ", ".join(rep.describe() for rep in self.replicas)

    def sla_report(self):
        """Measured per-class p50/p99 vs the declared objective — the
        storm gate's verdict input."""
        report = {}
        for cname, sla in self.router.classes.items():
            p50 = self.metrics.latency_quantile(cname, 0.50)
            p99 = self.metrics.latency_quantile(cname, 0.99)
            report[cname] = {
                "p50_ms": p50 * 1e3 if p50 is not None else None,
                "p99_ms": p99 * 1e3 if p99 is not None else None,
                "slo_p99_ms": sla.p99_slo_ms,
                "ok": p99 is None or p99 * 1e3 <= sla.p99_slo_ms,
            }
        return report

    def stats(self):
        out = {
            "name": self.name,
            "pending": self.router.pending(),
            "replicas": {
                f"r{rep.index}": {
                    "state": rep.state,
                    "consecutive_failures": rep.consecutive_failures,
                    "load": rep.load(),
                    "endpoint": rep.endpoint.stats(),
                } for rep in self.replicas},
            "classes": {},
        }
        for cname in self.router.classes:
            out["classes"][cname] = {
                e: self.metrics.value(cname, e) for e in _FLEET_EVENTS}
        out["sla"] = self.sla_report()
        return out
