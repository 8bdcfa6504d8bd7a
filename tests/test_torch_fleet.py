"""The port's serving fleet (`mxnet_tpu_torch.serve.Fleet`, its router
and replicas) against the JAX package's, on an explicit CPU device.

One case for each case of ``tests/test_fleet.py`` that concerns the
fleet, the router and the replicas (the continuous batcher's are in
``test_torch_continuous.py``).  The model is the reference's small MLP
(Dense 16 relu, Dense 4 over 8 inputs), built in the JAX package and
carried into the port with `load_reference_params`; the same numpy
inputs go through both.  Tolerance: the port's Dense layers on the CPU
against XLA's, in f32 over 8 and 16 terms: atol 1e-6, rtol 1e-5 (the
reference test's own bound between a routed and a direct forward).

Both packages' fault plans are cleared around every test, and fleets get
names of their own, since the telemetry registries are per process.
"""
import re
import threading
import time
import warnings

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import telemetry as ref_telemetry
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.resilience import faultline as ref_faultline
from mxnet_tpu.serve import Fleet as RefFleet
from mxnet_tpu.serve import PriorityRouter as RefRouter
from mxnet_tpu.serve import Replica as RefReplica
from mxnet_tpu.serve.endpoint import Endpoint as RefEndpoint
from mxnet_tpu_torch import cpu, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.resilience import faultline
from mxnet_tpu_torch.serve import (DeadlineExceeded, Endpoint, Fleet,
                                   FleetClosed, NoHealthyReplica,
                                   PriorityRouter, Replica,
                                   ReplicaUnavailable, UnknownServiceClass)
from mxnet_tpu_torch.serve.fleet import DEAD, EJECTED, HEALTHY
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

# two replicas over one CPU device warn by design (the reference's tests
# spread them over its 8-device CPU mesh); one test asserts the warning
pytestmark = pytest.mark.filterwarnings(
    "ignore:.*replicas will share devices:RuntimeWarning")

ATOL, RTOL = 1e-6, 1e-5
CPU = [cpu()]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faultline.clear()
    ref_faultline.clear()
    yield
    faultline.clear()
    ref_faultline.clear()


def _sample(name, labels=None):
    v = telemetry.default_registry().get_sample_value(name, labels)
    return 0.0 if v is None else v


def _pair(seed=None):
    """The reference's MLP and the port's, with the same weights."""
    if seed is not None:
        mx.random.seed(seed)
    ref = ref_nn.HybridSequential()
    ref.add(ref_nn.Dense(16, activation="relu"))
    ref.add(ref_nn.Dense(4))
    ref.initialize()
    ref(mx.np.zeros((1, 8)))
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8))
    net.add(nn.Dense(4, in_units=16))
    net.initialize(ctx=cpu())
    load_reference_params(net, {k: p.data().asnumpy()
                                for k, p in ref.collect_params().items()})
    return ref, net


def _ref_forward(ref, x):
    return ref(mx.np.array(x)).asnumpy()


def _close(out, ref_out):
    onp.testing.assert_allclose(out.numpy(), ref_out, rtol=RTOL, atol=ATOL)


def _matches(out, ref_out):
    return onp.allclose(out.numpy(), ref_out, rtol=RTOL, atol=ATOL)


# -- routing: parity, priority, shedding, negatives ---------------------------

def test_fleet_batched_matches_jax_fleet(rng):
    ref, net = _pair()
    xs = [rng.standard_normal((n, 8)).astype(onp.float32)
          for n in (1, 3, 2, 4, 1, 2)]
    clss = ["interactive", "standard", "batch"]
    kw = dict(replicas=2, name="pt_parity", max_batch_size=4,
              max_latency_ms=2)
    outs = {}
    for key, make, make_kw in (("ref", RefFleet, {}),
                               ("port", Fleet, {"devices": CPU})):
        with make(ref if key == "ref" else net, **kw, **make_kw) as fleet:
            fleet.warmup(xs[0])
            futs = [fleet.submit(x, cls=clss[i % 3], timeout_ms=60_000)
                    for i, x in enumerate(xs)]
            outs[key] = [f.result(timeout=60) for f in futs]
    for out, ref_out, x in zip(outs["port"], outs["ref"], xs):
        assert tuple(out.shape) == ref_out.shape
        _close(out, ref_out.asnumpy())
        _close(out, _ref_forward(ref, x))


def test_priority_ordering_under_full_queue():
    """Stopped dispatchers, the same anti-priority submits: both
    routers pop in the same order, and the port's fleet then serves
    every request."""
    ref, net = _pair()
    order = [("batch", 0), ("batch", 1), ("standard", 2),
             ("standard", 3), ("interactive", 4), ("interactive", 5)]
    popped = {}
    fleets = {"ref": RefFleet(ref, replicas=1, name="pt_prio", start=False,
                              max_batch_size=4, max_latency_ms=1),
              "port": Fleet(net, replicas=1, name="pt_prio", start=False,
                            devices=CPU, max_batch_size=4,
                            max_latency_ms=1)}
    futs = []
    for key, fleet in fleets.items():
        for cls, tag in order:
            x = onp.full((1, 8), float(tag), dtype=onp.float32)
            f = fleet.submit(x, cls=cls, timeout_ms=60_000)
            if key == "port":
                futs.append((f, x))
        popped[key] = [fleet.router.pop(timeout=1) for _ in order]
    assert [r.sla.name for r in popped["port"]] == \
        [r.sla.name for r in popped["ref"]] == \
        ["interactive"] * 2 + ["standard"] * 2 + ["batch"] * 2
    assert [int(r.arrays[0][0, 0]) for r in popped["port"]] == \
        [int(r.arrays[0][0, 0]) for r in popped["ref"]] == [4, 5, 2, 3, 0, 1]
    fleets["ref"].shutdown(drain=False)
    port = fleets["port"]
    for r in popped["port"]:
        port.router.push(r, r.sla.priority)
    port.start()
    for f, x in futs:
        _close(f.result(timeout=60), _ref_forward(ref, x))
    port.shutdown(drain=True)


def test_deadline_shed_is_distinct_error(rng):
    _, net = _pair()
    fleet = Fleet(net, replicas=1, name="pt_shed", start=False, devices=CPU,
                  max_batch_size=4, max_latency_ms=1)
    x = rng.standard_normal((1, 8)).astype(onp.float32)
    fut = fleet.submit(x, cls="interactive", timeout_ms=30)
    time.sleep(0.1)                      # deadline passes pre-dispatch
    fleet.start()
    with pytest.raises(DeadlineExceeded, match="shed, not dropped"):
        fut.result(timeout=30)
    assert fleet.metrics.value("interactive", "shed") == 1
    assert fleet.metrics.value("interactive", "completed") == 0
    fleet.shutdown(drain=True)
    with pytest.raises(FleetClosed):
        fleet.submit(x)


def test_unknown_service_class_message_equals_jax():
    ref, net = _pair()
    msgs = []
    for fleet, exc_type in (
            (RefFleet(ref, replicas=1, name="pt_unknown", start=False),
             Exception),
            (Fleet(net, replicas=1, name="pt_unknown", start=False,
                   devices=CPU), UnknownServiceClass)):
        with pytest.raises(exc_type) as exc:
            fleet.submit(onp.zeros((1, 8), onp.float32), cls="premium")
        msgs.append(str(exc.value))
        fleet.shutdown()
    assert msgs[1] == msgs[0]
    assert "'interactive', 'standard', 'batch'" in msgs[1]


def test_pinned_submit_to_unroutable_replica_carries_fleet_state(rng):
    ref, net = _pair()
    x = rng.standard_normal((1, 8)).astype(onp.float32)
    with Fleet(net, replicas=2, name="pt_pin", devices=CPU, max_batch_size=4,
               max_latency_ms=2) as fleet:
        fleet.replicas[1].set_state(EJECTED)
        with pytest.raises(ReplicaUnavailable) as exc:
            fleet.submit(x, replica=1)
        msg = str(exc.value)
        assert "r1" in msg and "ejected" in msg
        assert "r0=healthy" in msg         # the whole fleet state
        fleet.drain_replica(1)
        with pytest.raises(ReplicaUnavailable, match="draining"):
            fleet.submit(x, replica=1)
        _close(fleet.predict(x, timeout_ms=60_000), _ref_forward(ref, x))


def test_pinned_submit_validates_replica_index(rng):
    ref, net = _pair()
    x = rng.standard_normal((1, 8)).astype(onp.float32)
    with Fleet(net, replicas=2, name="pt_pin_range", devices=CPU,
               max_batch_size=4, max_latency_ms=2) as fleet:
        for bad in (2, 7, -1, -2):
            with pytest.raises(ReplicaUnavailable,
                               match=r"out of range.*0\.\.1"):
                fleet.submit(x, replica=bad)
        _close(fleet.predict(x, replica=1, timeout_ms=60_000),
               _ref_forward(ref, x))


def test_more_replicas_than_devices_warns_as_jax():
    """Nine replicas over eight devices (the reference's virtual CPU
    mesh; eight CPU contexts here): the same RuntimeWarning text."""
    import jax
    ref, net = _pair()
    texts = []
    for make, kw in ((RefFleet, {}), (Fleet, {"devices": CPU * 8})):
        with pytest.warns(RuntimeWarning, match="share devices") as rec:
            fleet = make(ref if make is RefFleet else net,
                         replicas=len(jax.devices()) + 1,
                         name="pt_overcommit", start=False, **kw)
        texts.append([str(w.message) for w in rec
                      if issubclass(w.category, RuntimeWarning)])
        fleet.shutdown()
    assert texts[1] == texts[0]


def test_fleet_requires_card_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default devices are valid")
    _, net = _pair()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        Fleet(net, replicas=1, start=False)


def test_nondrain_shutdown_fails_queued_futures_no_strand(rng):
    _, net = _pair()
    x = rng.standard_normal((1, 8)).astype(onp.float32)
    fleet = Fleet(net, replicas=1, name="pt_nodrain", start=False,
                  devices=CPU, max_batch_size=4, max_latency_ms=1)
    futs = [fleet.submit(x, timeout_ms=60_000) for _ in range(4)]
    fleet.shutdown(drain=False)          # dispatcher never started
    for f in futs:
        with pytest.raises(FleetClosed, match="without draining"):
            f.result(timeout=10)


def test_no_healthy_replica_when_all_dead(rng):
    ref, net = _pair()
    x = rng.standard_normal((1, 8)).astype(onp.float32)
    fleet = Fleet(net, replicas=1, name="pt_alldead", devices=CPU,
                  max_batch_size=4, max_latency_ms=2)
    _close(fleet.predict(x, timeout_ms=60_000), _ref_forward(ref, x))
    fleet.kill_replica(0)
    with pytest.raises(NoHealthyReplica, match="r0=dead"):
        fleet.predict(x, timeout_ms=2_000)
    fleet.shutdown(drain=True)


# -- health: ejection / re-admission ------------------------------------------

def test_replica_state_machine_matches_jax():
    """The same failures and successes through both packages' Replica:
    the same return values, states, streaks and descriptions."""
    steps = ["fail", "success", "fail", "fail", "fail", "success", "fail",
             "dead"]
    trace = {}
    for key, cls in (("ref", RefReplica), ("port", Replica)):
        rep = cls(0, endpoint=None, eject_after=2)
        seen = [(rep.state, rep.is_routable())]
        for s in steps:
            if s == "fail":
                ret = rep.record_failure()
            elif s == "success":
                ret = rep.record_success()
            else:
                ret = rep.set_state("dead")
            seen.append((ret, rep.state, rep.consecutive_failures,
                         rep.is_routable(), rep.describe()))
        trace[key] = seen
    assert trace["port"] == trace["ref"]
    assert trace["port"][4][:2] == (True, EJECTED)
    assert trace["port"][6][:3] == (True, HEALTHY, 0)
    assert trace["port"][-1][1] == DEAD


def test_ejection_and_probe_readmission_end_to_end(rng):
    """Injected transport timeouts strike the replica twice (two
    endpoint submissions, one retry each = 4 model-call arrivals), the
    fleet ejects it, the re-admission probe brings it back once the
    fault clears, and the held request still completes."""
    ref, net = _pair()
    x = rng.standard_normal((2, 8)).astype(onp.float32)
    fleet = Fleet(net, replicas=1, name="pt_eject", devices=CPU,
                  max_batch_size=4, max_latency_ms=1, probe_interval=0.05)
    fleet.warmup(x)                     # seeds the 1-row probe payload
    faultline.plan([{"site": "serve.model_call", "kind": "timeout",
                     "at": 1, "times": 4}])
    out = fleet.predict(x, cls="standard", timeout_ms=20_000)
    _close(out, _ref_forward(ref, x))
    rep = fleet.replicas[0]
    assert rep.state == HEALTHY         # readmitted by a probe success
    assert _sample("mxtpu_fleet_probes_total",
                   {"fleet": "pt_eject", "outcome": "ok"}) >= 1
    assert rep.consecutive_failures == 0
    fleet.shutdown(drain=True)


def test_kill_replica_mid_traffic_zero_drop(rng):
    ref, net = _pair()
    xs = [rng.standard_normal((1 + i % 3, 8)).astype(onp.float32)
          for i in range(8)]
    fleet = Fleet(net, replicas=2, name="pt_kill", devices=CPU,
                  max_batch_size=4, max_latency_ms=2)
    fleet.warmup(xs[0])
    before = _sample("mxtpu_faults_recovered_total",
                     {"site": "serve.replica", "kind": "preempt"})
    faultline.plan([{"site": "serve.replica", "kind": "preempt",
                     "at": 2}])
    futs = [fleet.submit(x, cls="interactive", timeout_ms=60_000)
            for x in xs]
    outs = [f.result(timeout=60) for f in futs]       # zero drops
    for out, x in zip(outs, xs):
        _close(out, _ref_forward(ref, x))
    assert sum(r.state == DEAD for r in fleet.replicas) == 1
    after = _sample("mxtpu_faults_recovered_total",
                    {"site": "serve.replica", "kind": "preempt"})
    assert after == before + 1          # the rerouted request recovered
    assert fleet.metrics._failover.count >= 1
    assert fleet.metrics.value("interactive", "rerouted") >= 1
    fleet.shutdown(drain=True)


# -- hot model-version swap ---------------------------------------------------

def test_endpoint_hot_swap_pins_in_flight_version(rng):
    ref_old, old = _pair(seed=11)
    ref_new, new = _pair(seed=22)
    x = rng.standard_normal((2, 8)).astype(onp.float32)
    want_old, want_new = _ref_forward(ref_old, x), _ref_forward(ref_new, x)
    assert not onp.allclose(want_old, want_new)   # the swap is observable

    ep = Endpoint(old, name="pt_swap_ep", device="cpu", max_batch_size=4,
                  max_latency_ms=1, start=False)
    f_old = ep.submit(x)                 # admitted under version 0
    assert ep.swap_model(new) == 1       # no live cache to stage yet
    f_new = ep.submit(x)                 # admitted under version 1
    ep.start()
    _close(f_old.result(timeout=60), want_old)
    _close(f_new.result(timeout=60), want_new)
    s = ep.stats()
    assert s["model_version"] == 1
    assert s["executables"] == 1         # the drained old version retired
    ep.shutdown(drain=True)


def test_fleet_hot_swap_under_load(rng):
    ref_old, old = _pair(seed=31)
    ref_new, new = _pair(seed=32)
    x = rng.standard_normal((2, 8)).astype(onp.float32)
    want_old, want_new = _ref_forward(ref_old, x), _ref_forward(ref_new, x)
    with Fleet(old, replicas=2, name="pt_swap_fleet", devices=CPU,
               max_batch_size=4, max_latency_ms=1) as fleet:
        fleet.warmup(x)
        futs = [fleet.submit(x, timeout_ms=60_000) for _ in range(6)]
        versions = fleet.swap_model(new)
        assert versions == {"r0": 1, "r1": 1}
        late = [fleet.submit(x, timeout_ms=60_000) for _ in range(4)]
        for f in futs:
            out = f.result(timeout=60)
            assert _matches(out, want_old) or _matches(out, want_new)
        for f in late:                   # post-flip: new params only
            _close(f.result(timeout=60), want_new)


# -- router / metrics units ---------------------------------------------------

def test_router_order_and_timeouts_match_jax():
    pushes = [("b1", 2), ("a1", 0), ("a2", 0), ("s1", 1), ("b2", 2),
              ("a3", 0)]
    orders = {}
    for key, cls in (("ref", RefRouter), ("port", PriorityRouter)):
        r = cls()
        t0 = time.perf_counter()
        assert r.pop(timeout=0.01) is None
        assert time.perf_counter() - t0 >= 0.009
        for item, prio in pushes:
            r.push(item, prio)
        orders[key] = [r.pop() for _ in range(3)] + [
            e for e in r.drain()]
        assert r.pending() == 0
    assert orders["port"] == orders["ref"] == \
        ["a1", "a2", "a3", "s1", "b1", "b2"]


def test_default_classes_match_jax():
    from mxnet_tpu.serve import default_classes as ref_default_classes
    from mxnet_tpu_torch.serve import default_classes
    for base in (None, 40.0):
        mine, theirs = default_classes(base), ref_default_classes(base)
        assert list(mine) == list(theirs)
        assert [repr(c) for c in mine.values()] == \
            [repr(c) for c in theirs.values()]


def test_endpoint_stats_expose_wait_and_execute_quantiles(rng):
    _, net = _pair()
    x = rng.standard_normal((2, 8)).astype(onp.float32)
    with Endpoint(net, name="pt_quant", device="cpu", max_batch_size=4,
                  max_latency_ms=1) as ep:
        for _ in range(5):
            ep.predict(x)
        s = ep.stats()
    for key in ("queue_wait_ms_p50", "queue_wait_ms_p99",
                "execute_ms_p50", "execute_ms_p99"):
        assert s[key] is not None and s[key] >= 0.0
    assert s["queue_wait_ms_p50"] <= s["queue_wait_ms_p99"]
    assert s["execute_ms_p50"] <= s["execute_ms_p99"]


def test_histogram_quantile_matches_jax():
    values = (0.5, 1.5, 1.5, 3.0, 100.0)
    got = {}
    for key, reg in (("ref", ref_telemetry.MetricsRegistry()),
                     ("port", telemetry.MetricsRegistry())):
        h = reg.histogram("pt_q_seconds", "test", buckets=(1.0, 2.0, 4.0))
        assert h.quantile(0.5) is None
        for v in values:
            h.observe(v)
        got[key] = [h.quantile(q) for q in (0.0, 0.25, 0.5, 0.99, 1.0)]
        with pytest.raises(ValueError):
            h.quantile(1.5)
    assert got["port"] == got["ref"]
    assert got["port"][-1] == 4.0


def test_fleet_sla_report_shape(rng):
    _, net = _pair()
    x = rng.standard_normal((1, 8)).astype(onp.float32)
    with Fleet(net, replicas=1, name="pt_sla", devices=CPU, max_batch_size=4,
               max_latency_ms=1) as fleet:
        fleet.warmup(x)
        fleet.predict(x, cls="interactive", timeout_ms=60_000)
        report = fleet.sla_report()
        stats = fleet.stats()
    assert set(report) == {"interactive", "standard", "batch"}
    r = report["interactive"]
    assert r["p99_ms"] is not None and r["ok"] is True
    assert report["standard"]["p99_ms"] is None   # no traffic, no claim
    assert set(stats) == {"name", "pending", "replicas", "classes", "sla"}
    assert stats["classes"]["interactive"]["completed"] == 1
    assert set(stats["replicas"]["r0"]) == {
        "state", "consecutive_failures", "load", "endpoint"}


_SAMPLE = re.compile(r"^(\w+)\{([^}]*)\}")


def _series(text, name):
    """(sample name, labels) of every exposition sample that carries
    ``name`` as its fleet, or as the prefix of its endpoint."""
    out = set()
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if not m:
            continue
        labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"', m.group(2))))
        d = dict(labels)
        if d.get("fleet") == name or \
                d.get("endpoint", "").startswith(name + "/"):
            out.add((m.group(1), labels))
    return out


def test_prometheus_families_match_jax(rng):
    """The same traffic through both packages' fleets of one name: the
    same ``mxtpu_fleet_*`` / ``mxtpu_serve_*`` samples with the same
    labels in each package's ``export_prometheus()``."""
    ref, net = _pair()
    x = rng.standard_normal((1, 8)).astype(onp.float32)
    texts = {}
    for key, make, kw, tele in (
            ("ref", RefFleet, {}, ref_telemetry),
            ("port", Fleet, {"devices": CPU}, telemetry)):
        with make(ref if key == "ref" else net, replicas=2, name="pt_prom",
                  max_batch_size=4, max_latency_ms=1, **kw) as fleet:
            fleet.warmup(x)
            for cls in ("interactive", "batch"):
                fleet.predict(x, cls=cls, timeout_ms=60_000)
        texts[key] = tele.export_prometheus()
    port, theirs = _series(texts["port"], "pt_prom"), \
        _series(texts["ref"], "pt_prom")
    families = {n for n, _ in port}
    assert any(n.startswith("mxtpu_fleet_") for n in families)
    assert any(n.startswith("mxtpu_serve_") for n in families)
    assert port == theirs


# -- concurrency fuzz ---------------------------------------------------------

def test_submit_shutdown_eject_fuzz(rng):
    """Submitter threads race replica ejection/re-admission and a
    draining shutdown: every future obtained from submit() resolves
    exactly once, with a result or a typed error."""
    _, net = _pair()
    fleet = Fleet(net, replicas=2, name="pt_fuzz", devices=CPU,
                  max_batch_size=4, max_latency_ms=1)
    x = rng.standard_normal((1, 8)).astype(onp.float32)
    fleet.warmup(x)

    futs, resolved = [], []
    record_lock = threading.Lock()
    stop = threading.Event()
    submit_errors = []

    def _on_done(fut):
        with record_lock:
            resolved.append(fut)

    def submitter():
        while not stop.is_set():
            try:
                f = fleet.submit(x, cls="standard", timeout_ms=60_000)
            except FleetClosed:
                return               # legal outcome of racing shutdown
            except Exception as e:   # anything else is a real bug
                submit_errors.append(e)
                return
            f.add_done_callback(_on_done)
            with record_lock:
                futs.append(f)
            time.sleep(0.002)        # bound the drain backlog

    threads = [threading.Thread(target=submitter, name=f"fuzz-{i}")
               for i in range(4)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for t in threads:
            t.start()
        deadline = time.time() + 1.2
        while time.time() < deadline:
            fleet.replicas[1].record_failure()
            time.sleep(0.03)
            fleet.replicas[1].record_success()
            time.sleep(0.03)
        fleet.shutdown(drain=True)   # races the still-running submitters
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    assert not submit_errors, submit_errors
    assert futs                      # traffic actually flowed
    for f in futs:
        assert f.done()              # drained or failed — never stranded
        try:
            assert tuple(f.result(timeout=0).shape) == (1, 4)
        except (FleetClosed, DeadlineExceeded, NoHealthyReplica):
            pass                     # typed failures are legal under churn
    assert len(resolved) == len(futs)
    assert len({id(f) for f in resolved}) == len(futs)


def test_jax_endpoint_and_port_endpoint_agree_after_swap(rng):
    """One swap on both packages' endpoints over the same weights: the
    versions and the served outputs agree."""
    ref_old, old = _pair(seed=41)
    ref_new, new = _pair(seed=42)
    x = rng.standard_normal((3, 8)).astype(onp.float32)
    outs = {}
    for key, make, models, kw in (
            ("ref", RefEndpoint, (ref_old, ref_new), {}),
            ("port", Endpoint, (old, new), {"device": "cpu"})):
        with make(models[0], name="pt_swap_pair", max_batch_size=4,
                  max_latency_ms=1, **kw) as ep:
            ep.warmup(x)
            before = ep.predict(x)
            version = ep.swap_model(models[1])
            outs[key] = (version, before, ep.predict(x), ep.stats())
    assert outs["port"][0] == outs["ref"][0] == 1
    for i in (1, 2):
        _close(outs["port"][i], outs["ref"][i].asnumpy())
    assert outs["port"][3]["cache_misses"] == \
        outs["ref"][3]["cache_misses"] == 0
