"""The port's telemetry, profiler, flight recorder, lock witness and
monitor against the JAX package's, in one process.

- The registry: the same operations (counters with hostile label values,
  gauges, histograms with their own and the default buckets) give the
  same Prometheus text and the same JSON, character for character, and
  the same quantiles;
- ``step_phase``: one histogram observation and one flight-recorder
  event a phase, and a ``step/<phase>`` span in the profiler's trace
  while it runs, as the reference's;
- the retrace watchdog: a `FusedTrainStep` under a stand-in for the
  CUDA graph counts no retrace for its one capture and one for a second
  (a new input shape), as the reference counts a jitted function's
  cache growth; captures tick ``mxtpu_graph_capture_total``;
- the flight recorder: the same events give the same snapshot fields and
  a dump of the reference's schema; the signal handlers are put back;
- the lock witness: a lock-order cycle raises, locks made in the port's
  modules are wrapped while the reference's witness wraps the
  reference's, and ``threading.Lock`` is restored exactly;
- ``Monitor``: the same statistics as the reference's, within 1e-5
  (f32 sums in two orders over a few hundred values).

Every global this file installs is undone by the test that installs it.
"""
import json
import logging
import signal
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.lockwitness as ref_lw
import mxnet_tpu.observe as ref_observe
import mxnet_tpu.telemetry as ref_tm
import mxnet_tpu_torch.lockwitness as lw
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.monitor import Monitor as RefMonitor
from mxnet_tpu_torch import cpu, observe, profiler, telemetry
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer, nn
from mxnet_tpu_torch.monitor import Monitor
from mxnet_tpu_torch.ops import capture

torch.set_num_threads(1)

HOSTILE = ["back\\slash", 'quo"te', "new\nline", 'all\\three" \n mixed',
           "trailing backslash\\", '"', "\n", "\\", 'fake closer"} 9']


def _fill(tm):
    reg = tm.MetricsRegistry()
    c = reg.counter("hostile_total", 'help with "quotes" \\ and\nnewline',
                    ("v",))
    for i, val in enumerate(HOSTILE):
        c.labels(v=val).inc(i + 1)
    reg.counter("plain_total").inc(2.5)
    g = reg.gauge("depth", "a gauge", ("k",))
    g.labels(k="a").set(-2.5)
    g.labels(k="b").inc(3)
    g.labels(k="b").dec(0.125)
    h = reg.histogram("lat_seconds", "latency", ("phase",),
                      buckets=(0.5, 0.001, 2.0))
    for v in (0.0005, 0.25, 0.75, 3.0, 1e9):
        h.labels(phase="fwd").observe(v)
    d = reg.histogram("default_seconds")
    for v in (1e-5, 0.003, 0.2, 7.0):
        d.observe(v)
    return reg


@pytest.mark.parametrize("fmt", ["export_prometheus", "export_json"])
def test_exposition_equals_the_reference_s(fmt):
    assert getattr(_fill(telemetry), fmt)() == getattr(_fill(ref_tm), fmt)()


def test_quantiles_equal_the_reference_s():
    port, ref = _fill(telemetry), _fill(ref_tm)
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        a = port.histogram("lat_seconds", labelnames=("phase",)) \
            .labels(phase="fwd").quantile(q)
        b = ref.histogram("lat_seconds", labelnames=("phase",)) \
            .labels(phase="fwd").quantile(q)
        assert a == b, q
    for tm in (telemetry, ref_tm):
        with pytest.raises(ValueError):
            tm.MetricsRegistry().counter("c").inc(-1)


@pytest.fixture
def host_profiler():
    """The port's profiler (host events only on the CPU); stopped and
    emptied after."""
    yield profiler
    if profiler.state() == "run":
        profiler.set_state("stop")
    profiler.dumps(reset=True)


def test_step_phase_observes_records_and_traces(host_profiler):
    def count(tm, phase):
        return tm.default_registry().get_sample_value(
            "mxtpu_trainer_step_phase_seconds_count", {"phase": phase}) or 0

    before = (count(telemetry, "fused-step"), count(ref_tm, "fused-step"))
    n_events = observe.default_recorder()._n
    profiler.set_state("run")
    for tm in (telemetry, ref_tm):
        for _ in range(3):
            with tm.step_phase("fused-step"):
                pass
        tm.mark_step()
    profiler.set_state("stop")
    assert (count(telemetry, "fused-step") - before[0] ==
            count(ref_tm, "fused-step") - before[1] == 3)
    new = observe.default_recorder()._n - n_events
    assert [e[4:6] for e in observe.events()[-new:]] == \
        [("phase", "fused-step")] * 3
    trace = json.loads(profiler.dumps(format="json", reset=True))
    spans = [e for e in trace["traceEvents"] if e["name"] ==
             "step/fused-step"]
    assert len(spans) == 3
    assert all(e["ph"] == "X" and e["cat"] == "step_phase" and e["dur"] >= 0
               for e in spans)
    table = profiler.dumps()
    assert "Name" in table


def test_telemetry_can_be_turned_off():
    key = ("mxtpu_trainer_step_phase_seconds_count", {"phase": "off-test"})
    prev = telemetry.set_enabled(False)
    try:
        with telemetry.step_phase("off-test"):
            pass
        assert telemetry.default_registry().get_sample_value(*key) is None
    finally:
        telemetry.set_enabled(prev)
    with telemetry.step_phase("off-test"):
        pass
    assert telemetry.default_registry().get_sample_value(*key) == 1


class _StandIn(capture.Graph):
    """A graph whose capture runs the function once and whose replay runs
    nothing."""

    def _record(self, fn):
        return fn()

    def _launch(self):
        pass


class _Net(HybridBlock):
    def __init__(self):
        super().__init__()
        self.d = nn.Dense(1, in_units=4)

    def forward(self, x):
        return (self.d(x) ** 2).mean()


def test_watchdog_counts_re_captures_as_the_reference_counts_retraces(
        monkeypatch, caplog):
    monkeypatch.setattr(capture, "Graph", _StandIn)
    monkeypatch.setattr(capture, "capturable", lambda device: True)
    net = _Net()
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(0))
    step = FusedTrainStep(net, Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 0.1}))
    name = "FusedTrainStep[_Net]"
    wd = telemetry.watchdog()
    reg = telemetry.default_registry()
    r0 = wd.retrace_count(name)
    c0 = reg.get_sample_value("mxtpu_graph_capture_total") or 0
    x4, x5 = torch.ones(4, 4), torch.ones(5, 4)
    for _ in range(4):
        step(x4, batch_size=4)                 # eager, capture, replays
    assert step.captures == 1 and wd.retrace_count(name) == r0
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.telemetry"):
        step(x5, batch_size=5)                 # a new shape: eager
        step(x5, batch_size=5)                 # ... and a second capture
    assert step.captures == 2 and wd.retrace_count(name) == r0 + 1
    assert reg.get_sample_value("mxtpu_graph_capture_total") == c0 + 2
    assert any(name in r.getMessage() for r in caplog.records)

    class Jitted:               # the reference's view of the same story
        def __init__(self):
            self.sizes = iter([1, 1, 1, 1, 1, 2])

        def _cache_size(self):
            return next(self.sizes)

    ref_wd = ref_tm.RetraceWatchdog(registry=ref_tm.MetricsRegistry())
    fn = Jitted()
    for _ in range(6):
        ref_wd.observe(fn, "f")
    assert ref_wd.retrace_count("f") == 1


def _record_all(fr):
    fr.set_rank(0)
    fr.set_step(12)
    fr.record("phase", "fused-step", seconds=0.5)
    fr.record("fault", "train.grads/nan_grad", site="train.grads",
              kind="nan_grad", rank=None, arrival=7)
    fr.record("checkpoint", "save", step=10, rank=0, outcome="written")


def test_flight_recorder_snapshot_and_dump_match_the_reference(tmp_path):
    port = observe.FlightRecorder(capacity=2, enabled=True)
    ref = ref_observe.FlightRecorder(capacity=2, enabled=True)
    for fr in (port, ref):
        _record_all(fr)
    a, b = port.snapshot("test"), ref.snapshot("test")
    assert observe.SCHEMA_VERSION == ref_observe.SCHEMA_VERSION == a["schema"]
    assert sorted(a) == sorted(b)
    for k in ("schema", "host", "generation", "step", "reason", "capacity",
              "recorded", "dropped"):
        assert a[k] == b[k], k
    assert [e[2:] for e in a["events"]] == [e[2:] for e in b["events"]]
    path = port.dump(root=tmp_path)
    assert path.endswith("blackbox-host00000-gen000-step0000000012.json")
    assert json.load(open(path))["events"][-1][4:6] == ["checkpoint", "save"]
    assert observe.FlightRecorder(enabled=False).dump(root=tmp_path) is None


def test_signal_handlers_are_put_back():
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGINT)}
    assert observe.install_signal_handlers()
    try:
        assert signal.getsignal(signal.SIGTERM) is not before[signal.SIGTERM]
    finally:
        assert observe.uninstall_signal_handlers()
    assert {s: signal.getsignal(s) for s in before} == before
    assert not observe.uninstall_signal_handlers()


def test_lock_witness_catches_a_cycle_and_restores_threading():
    found = threading.Lock, threading.RLock
    ref_lw.install()
    mid = threading.Lock, threading.RLock
    lw.install()
    try:
        mine = telemetry.MetricsRegistry()._lock
        theirs = ref_tm.MetricsRegistry()._lock
        assert isinstance(mine, lw._WitnessLock)
        assert mine._name.startswith("mxnet_tpu_torch/telemetry/registry.py:")
        assert not isinstance(theirs, lw._WitnessLock)
        a, b = lw.named_lock("test.a"), lw.named_lock("test.b")
        with a, b:
            pass
        with b:
            with pytest.raises(lw.LockOrderViolation, match="test.a"):
                a.acquire()
        assert not a.locked()                  # released on the violation
        assert ("test.a", "test.b") in lw.observed_edges()
        assert lw.violations() and not lw.check_acyclic()
    finally:
        lw.reset()
        ref_lw.reset()
        assert lw.uninstall()
        assert (threading.Lock, threading.RLock) == mid
        ref_lw.uninstall()
    assert (threading.Lock, threading.RLock) == found
    assert not lw.installed() and not lw.violations()


def test_monitor_statistics_match_the_reference():
    rng = onp.random.default_rng(0)
    w1, b1 = rng.standard_normal((16, 8)), rng.standard_normal(16)
    w2, b2 = rng.standard_normal((4, 16)), rng.standard_normal(4)
    x = rng.standard_normal((32, 8)).astype(onp.float32)

    port_net = nn.HybridSequential()
    port_net.add(nn.Dense(16, in_units=8, activation="relu"),
                 nn.Dense(4, in_units=16))
    port_net.initialize(ctx=cpu())
    ref_net = ref_nn.HybridSequential()
    ref_net.add(ref_nn.Dense(16, in_units=8, activation="relu"),
                ref_nn.Dense(4, in_units=16))
    ref_net.initialize()
    for net, load in ((port_net, torch.from_numpy),
                      (ref_net, mx.np.array)):
        for layer, (w, b) in zip((net[0], net[1]), ((w1, b1), (w2, b2))):
            layer.weight.set_data(load(w.astype(onp.float32)))
            layer.bias.set_data(load(b.astype(onp.float32)))
    got = []
    for mon_cls, net, inp in ((Monitor, port_net, torch.from_numpy(x)),
                              (RefMonitor, ref_net, mx.np.array(x))):
        mon = mon_cls(interval=2).install(net)
        stats = []
        for _ in range(3):
            mon.tic()
            net(inp)
            stats.append(mon.toc())
        mon.uninstall()
        mon.tic()
        net(inp)
        assert mon.toc() == []
        got.append(stats)
    port_stats, ref_stats = got
    assert [len(s) for s in port_stats] == [len(s) for s in ref_stats] == \
        [4, 0, 4]
    for mine, theirs in zip(port_stats[0] + port_stats[2],
                            ref_stats[0] + ref_stats[2]):
        assert mine[:2] == theirs[:2]
        assert abs(float(mine[2]) - float(theirs[2])) <= \
            1e-5 * max(1.0, abs(float(theirs[2])))
