"""The port's resilience layer against the JAX package's, in one process.

- faultline: the same plans fire at the same arrivals with the same
  exceptions and counters; ``seeded_plan``, the flaky pattern and
  ``backoff_delay`` are equal; ``retry_transient`` recovers and ticks;
- checkpoints: save/load bitwise (bf16 included), the files crossing
  both ways between the packages; a corrupt step is skipped for the one
  before it; pruning keeps the newest; the async writer's error surfaces
  at ``wait``; a world larger than one, ``reshard=True`` and kvstore
  residuals raise;
- ``gather_training_state`` of a small trained net written by the
  reference restores bitwise in the port (params, Adam states, update
  counts, the random stream), and the reverse;
- ``DivergenceSentinel`` and ``StragglerPolicy`` trip at the same
  observations as the reference's;
- ``FusedTrainStep`` with dropout on the CPU, under a stand-in for the
  CUDA graph that replays by running the step again: a ``nan_grad``
  leaves every parameter and state bitwise as it was and ticks the
  reference's counters; a ``preempt`` at step 5 changes nothing, and a
  fresh net restored from the step-4 checkpoint ends bitwise equal to
  the uninterrupted run.

Every plan, seed and default generator this file sets is put back.
"""
import json
import os

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.random as ref_random
import mxnet_tpu.resilience as ref_res
import mxnet_tpu.telemetry as ref_tm
from mxnet_tpu import gluon as ref_gluon
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.resilience import checkpoint as ref_ckpt
from mxnet_tpu.resilience import faultline as ref_fl
from mxnet_tpu.resilience import policies as ref_policies

import mxnet_tpu_torch.random as prandom
from mxnet_tpu_torch import cpu, resilience, telemetry
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer, nn
from mxnet_tpu_torch.ops import capture, invoke
from mxnet_tpu_torch.ops.seeds import SeedTable
from mxnet_tpu_torch.resilience import checkpoint as ckpt
from mxnet_tpu_torch.resilience import faultline, policies

torch.set_num_threads(1)


def _save_random(mod):
    st = mod._state
    return (st.root, st.counter, st.host, st.host_seeded_with,
            list(mod._host_seed), list(mod._host_spawn))


def _load_random(mod, saved):
    st = mod._state
    (st.root, st.counter, st.host, st.host_seeded_with,
     mod._host_seed[:], mod._host_spawn[:]) = saved


@pytest.fixture(autouse=True)
def _isolated():
    faultline.clear()
    ref_fl.clear()
    saved = (_save_random(prandom), _save_random(ref_random))
    gen = invoke.set_default_generator(None)
    yield
    faultline.clear()
    ref_fl.clear()
    _load_random(prandom, saved[0])
    _load_random(ref_random, saved[1])
    invoke.set_default_generator(gen)


def _sample(tm, name, labels=None):
    v = tm.default_registry().get_sample_value(name, labels)
    return 0.0 if v is None else v


# -- faultline and policies ---------------------------------------------------

PLANS = [
    [{"site": "kvstore.kv", "kind": "timeout", "at": 2, "times": 2}],
    [{"site": "train.grads", "kind": "preempt", "step": 3},
     {"site": "train.grads", "kind": "nan_grad", "at": 1}],
    [{"site": "data.iterator", "kind": "flaky", "times": 6, "seed": 11}],
    [{"site": "checkpoint.write", "kind": "error"},
     {"site": "serve.model_call", "kind": "slow", "delay": 0.0, "at": 2}],
]


def _drive(fl, plan):
    """Five checks and three polls of each planned site: what each
    returned or raised, the arrivals and the fired counts."""
    fl.plan(plan)
    seen = []
    for site in sorted({e["site"] for e in plan}):
        for i in range(8):
            try:
                got = fl.poll(site) if i >= 5 else fl.check(site)
            except fl.InjectedFault as e:
                got = (type(e).__name__, e.site, e.kind, e.arrival)
            seen.append(got)
    return seen, fl.arrivals(), fl.active_plan()


@pytest.mark.parametrize("plan", PLANS, ids=range(len(PLANS)))
def test_plans_fire_as_the_reference_s(plan):
    before = _sample(telemetry, "mxtpu_faults_injected_total",
                     {"site": plan[0]["site"], "kind": plan[0]["kind"]})
    ref_before = _sample(ref_tm, "mxtpu_faults_injected_total",
                         {"site": plan[0]["site"], "kind": plan[0]["kind"]})
    assert _drive(faultline, plan) == _drive(ref_fl, plan)
    assert (_sample(telemetry, "mxtpu_faults_injected_total",
                    {"site": plan[0]["site"], "kind": plan[0]["kind"]})
            - before ==
            _sample(ref_tm, "mxtpu_faults_injected_total",
                    {"site": plan[0]["site"], "kind": plan[0]["kind"]})
            - ref_before)


def test_seeded_plans_patterns_and_backoff_equal_the_reference_s():
    for seed in (0, 7, 1234):
        kw = dict(sites=faultline.SITES, n_faults=5, horizon=30,
                  kinds=("timeout", "error", "preempt"))
        assert faultline.seeded_plan(seed, **kw) == \
            ref_fl.seeded_plan(seed, **kw)
        assert faultline._flaky_pattern(seed, 9) == \
            ref_fl._flaky_pattern(seed, 9)
    for rank in range(3):
        for attempt in range(5):
            assert policies.backoff_delay(attempt, rank=rank) == \
                ref_policies.backoff_delay(attempt, rank=rank)
    payload = onp.arange(12, dtype=onp.float32)
    faultline.plan([{"site": "collective.dispatch", "kind": "bitflip",
                     "seed": 3}])
    ref_fl.plan([{"site": "collective.dispatch", "kind": "bitflip",
                  "seed": 3}])
    assert faultline.corrupt("collective.dispatch", payload).tobytes() == \
        ref_fl.corrupt("collective.dispatch", payload).tobytes()


def test_retry_transient_recovers_ticks_and_gives_up():
    def flaky_fn():
        calls.append(1)
        if len(calls) < 3:
            raise faultline.InjectedFlaky("kvstore.kv", "flaky", len(calls))
        return "ok"

    calls = []
    before = _sample(telemetry, "mxtpu_faults_recovered_total",
                     {"site": "kvstore.kv", "kind": "flaky"})
    assert policies.retry_transient(flaky_fn, "kvstore.kv", retries=3,
                                    sleep=lambda _t: None) == "ok"
    assert _sample(telemetry, "mxtpu_faults_recovered_total",
                   {"site": "kvstore.kv", "kind": "flaky"}) == before + 1
    calls = []
    with pytest.raises(faultline.InjectedFlaky):
        policies.retry_transient(flaky_fn, "kvstore.kv", retries=1,
                                 sleep=lambda _t: None)
    assert policies.check_peers() == []


def test_sentinels_trip_where_the_reference_s_trip():
    losses = [5.0, 4.0, 4.5, 3.9, 60.0, 4.1, float("nan"), 3.0, 45.0]
    port_div = resilience.DivergenceSentinel(factor=10, warmup=3)
    ref_div = ref_res.DivergenceSentinel(factor=10, warmup=3)
    assert [port_div.observe(x) for x in losses] == \
        [ref_div.observe(x) for x in losses]
    assert port_div.ema == ref_div.ema
    windows = [{0: 1.0, 1: 1.1, 2: 4.0}, {0: 1.0, 1: 1.0, 2: 5.0},
               {0: 1.0, 1: 1.2, 2: 5.0}, {0: 1.0, 1: 6.0, 2: 1.0},
               {0: 1.0, 1: 7.0, 2: 1.0}, {0: 1.0}]
    port_st = resilience.StragglerPolicy(factor=3.0, windows=2)
    ref_st = ref_res.StragglerPolicy(factor=3.0, windows=2)
    assert [port_st.observe(w) for w in windows] == \
        [ref_st.observe(w) for w in windows]


# -- checkpoint files ---------------------------------------------------------

def _arrays(seed=0):
    rng = onp.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((5, 3)).astype(onp.float32))
    return {"param/0": w.numpy(), "param/1": w.to(torch.bfloat16),
            "opt/0/0": rng.integers(0, 9, (4,)).astype(onp.int64),
            "rng/root": onp.asarray([0, 42], onp.uint32)}


def _bf16_bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().tobytes()
    return onp.asarray(a).view(onp.int16).tobytes()


def test_save_load_bitwise_across_both_packages(tmp_path):
    arrays = _arrays()
    ckpt.save_checkpoint(tmp_path / "p", 3, arrays, {"k": 1}, rank=0)
    ref_ckpt.save_checkpoint(str(tmp_path / "r"), 3,
                             {k: (onp.asarray(jax.numpy.asarray(
                                 v.float().numpy(), jax.numpy.bfloat16))
                                  if isinstance(v, torch.Tensor) else v)
                              for k, v in arrays.items()}, {"k": 1}, rank=0)
    for root in ("p", "r"):
        step, mine, meta = ckpt.load_checkpoint(tmp_path / root, rank=0)
        _, theirs, _ = ref_ckpt.load_checkpoint(str(tmp_path / root), rank=0)
        assert step == 3 and meta == {"k": 1}
        assert mine["param/1"].dtype == torch.bfloat16
        assert str(theirs["param/1"].dtype) == "bfloat16"
        assert _bf16_bits(mine["param/1"]) == \
            _bf16_bits(theirs["param/1"]) == _bf16_bits(arrays["param/1"])
        for k in ("param/0", "opt/0/0", "rng/root"):
            assert mine[k].dtype == theirs[k].dtype == arrays[k].dtype
            assert mine[k].tobytes() == theirs[k].tobytes() == \
                arrays[k].tobytes()
    man = json.load(open(tmp_path / "p" / "step-0000000003" / "host-00000" /
                         "MANIFEST.json"))
    assert man["schema"] == ref_ckpt.SCHEMA and man["world"] == 1
    assert man["nonnative_dtypes"] == {"param/1": "bfloat16"}


def test_corrupt_step_falls_back_and_prune_keeps_the_newest(tmp_path):
    mgr = resilience.CheckpointManager(tmp_path, keep=2, async_write=False,
                                       rank=0)
    for step in (1, 2, 3):
        mgr.save(step, _arrays(step), {"s": step})
    os.makedirs(tmp_path / ".tmp-step-0000000009-host-00000-1")
    mgr.prune()
    assert ckpt.list_steps(str(tmp_path)) == [2, 3]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    path = tmp_path / "step-0000000003" / "host-00000" / "arrays.npz"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    path.write_bytes(bytes(raw))
    with pytest.raises(resilience.CheckpointCorrupt, match="checksum"):
        ckpt.load_checkpoint(str(tmp_path), 3, rank=0)
    before = _sample(telemetry, "mxtpu_checkpoint_restores_total",
                     {"outcome": "corrupt_fallback"})
    step, arrays, meta = mgr.restore_latest()
    assert step == 2 and meta == {"s": 2}
    assert arrays["param/0"].tobytes() == _arrays(2)["param/0"].tobytes()
    assert _sample(telemetry, "mxtpu_checkpoint_restores_total",
                   {"outcome": "corrupt_fallback"}) == before + 1
    assert resilience.CheckpointManager(tmp_path / "none").restore_latest() \
        is None


def test_async_writer_error_surfaces_at_wait(tmp_path):
    mgr = resilience.CheckpointManager(tmp_path, keep=3, async_write=True,
                                       rank=0)
    faultline.plan([{"site": "checkpoint.write", "kind": "error", "at": 2}])
    mgr.save(1, _arrays(1))
    mgr.save(2, _arrays(2))
    with pytest.raises(faultline.InjectedError):
        mgr.wait()
    mgr.save(3, _arrays(3))
    mgr.close()
    assert ckpt.list_steps(str(tmp_path)) == [1, 3]


# -- training state across the packages ---------------------------------------

def _port_net(dtype="float32", seed=0):
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=6, activation="relu"),
            nn.Dense(3, in_units=8))
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(seed))
    net.cast(dtype)
    params = [net[0].weight, net[0].bias, net[1].weight, net[1].bias]
    return net, Trainer(params, "adam", {"learning_rate": 0.01})


def _ref_net(dtype="float32"):
    net = ref_nn.HybridSequential()
    net.add(ref_nn.Dense(8, in_units=6, activation="relu"),
            ref_nn.Dense(3, in_units=8))
    net.initialize()
    net.cast(dtype)
    params = [net[0].weight, net[0].bias, net[1].weight, net[1].bias]
    return net, ref_gluon.Trainer(params, "adam", {"learning_rate": 0.01})


def _x(t, dtype=onp.float32):
    return onp.random.default_rng(50 + t).standard_normal(
        (4, 6)).astype(dtype)


def _port_state(trainer):
    return ([p.data().view(torch.int16 if p.data().dtype == torch.bfloat16
                           else p.data().dtype).numpy().tobytes()
             for p in trainer._params],
            [s.numpy().tobytes() for i in sorted(trainer._states)
             for s in trainer._states[i]],
            dict(trainer._optimizer._index_update_count))


def _ref_state(trainer):
    return ([(onp.asarray(p.data()._data).view(onp.int16)
              if str(p.data().dtype) == "bfloat16"
              else onp.asarray(p.data()._data)).tobytes()
             for p in trainer._params],
            [onp.asarray(s._data).tobytes() for i in sorted(trainer._states)
             for s in trainer._states[i]],
            dict(trainer._optimizer._all_index_update_counts[0]))


def test_reference_training_state_restores_bitwise_in_the_port(tmp_path):
    ref_random.seed(21)
    net, trainer = _ref_net()
    step = ref_gluon.FusedTrainStep(_RefLoss(net), trainer)
    for t in range(2):
        step.step(mx.np.array(_x(t)), batch_size=4)
    ref_random.new_key()
    arrays, meta = ref_res.gather_training_state(trainer, step=2)
    ref_ckpt.save_checkpoint(str(tmp_path), 2, arrays, meta, rank=0)

    _pnet, ptrainer = _port_net(seed=9)
    got_step, parrays, pmeta = ckpt.load_checkpoint(tmp_path, rank=0)
    assert resilience.restore_training_state(parrays, pmeta, ptrainer) == 2
    assert _port_state(ptrainer) == _ref_state(trainer)
    assert ptrainer._optimizer.num_update == trainer._optimizer.num_update
    assert prandom._state.counter == ref_random._state.counter
    assert prandom.new_key().tolist() == onp.asarray(
        jax.random.key_data(ref_random.new_key())).tolist()


def test_port_training_state_restores_bitwise_in_the_reference(tmp_path):
    prandom.seed(4)
    net, trainer = _port_net("bfloat16", seed=3)
    step = FusedTrainStep(_PortLoss(net), trainer)
    for t in range(2):
        step(torch.from_numpy(_x(t)).to(torch.bfloat16), batch_size=4)
    prandom.new_key()
    arrays, meta = resilience.gather_training_state(trainer, step=2)
    assert "rng/torch_generator" in arrays
    resilience.save_checkpoint(tmp_path, 2, arrays, meta, rank=0)

    _rnet, rtrainer = _ref_net("bfloat16")
    _, rarrays, rmeta = ref_ckpt.load_checkpoint(str(tmp_path), rank=0)
    assert ref_res.restore_training_state(rarrays, rmeta, rtrainer) == 2
    assert _ref_state(rtrainer) == _port_state(trainer)
    assert ref_random._state.counter == prandom._state.counter
    assert onp.asarray(jax.random.key_data(ref_random.new_key())).tolist() \
        == prandom.new_key().tolist()


def test_topology_and_residuals_raise(tmp_path):
    _net, trainer = _port_net()
    arrays, meta = resilience.gather_training_state(trainer, step=0)
    wide = dict(meta, world={"copies": 2, "processes": 1})
    with pytest.raises(resilience.CheckpointTopologyError) as e:
        resilience.restore_training_state(arrays, wide, trainer)
    assert e.value.saved_world == {"copies": 2, "processes": 1}
    with pytest.raises(NotImplementedError, match="A7"):
        resilience.restore_training_state(arrays, meta, trainer,
                                          reshard=True)
    # bucket residuals round-trip: a trainer over two copies with int8
    # compression saves them, and a fresh one adopts them bitwise
    def copies_trainer():
        net = nn.Dense(3, in_units=6)
        net.initialize(ctx=[cpu(0), cpu(1)],
                       generator=torch.Generator().manual_seed(0))
        return net, Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore="tpu_ici",
                            compression_params={"type": "int8"})

    net2, tr2 = copies_trainer()
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.utils import split_and_load
    xs = split_and_load(torch.from_numpy(_x(0)), [cpu(0), cpu(1)])
    with autograd.record():
        losses = [(net2(x) ** 2).mean() for x in xs]
    autograd.backward(losses)
    tr2.step(4)
    arrays2, meta2 = resilience.gather_training_state(tr2, step=1)
    assert any(k.startswith("bucketres/") for k in arrays2)
    _, fresh = copies_trainer()
    resilience.restore_training_state(arrays2, meta2, fresh)
    pending = fresh.kvstore._bucketer._pending_residuals
    for e in meta2["bucket_residuals"]:
        got = pending[(e["digest"], e["bucket"], e["copy"])]
        assert onp.asarray(got).tobytes() == \
            arrays2[f"bucketres/{e['index']}"].tobytes()
    for name in ("ElasticSupervisor", "EmulatedPod", "scaled_lr"):
        with pytest.raises(NotImplementedError, match="A7"):
            getattr(resilience, name)


# -- the fused step under faults ----------------------------------------------

class _RefLoss(ref_gluon.HybridBlock):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return (self.net(x) ** 2).mean()


class _PortLoss(HybridBlock):
    def __init__(self, net, drop=0.0):
        super().__init__()
        self.net = net
        self.drop = nn.Dropout(drop)

    def forward(self, x):
        return (self.drop(self.net(x)) ** 2).mean()


class _Replaying(capture.Graph):
    """A stand-in for the CUDA graph: the capture runs the step once and
    puts the weights and states back (a capture runs nothing), drawing
    its seed words as a capture does; a replay runs the step again on
    the static buffer, its seed table's bookkeeping put back after and
    its own draws from a throwaway generator (a replay draws
    nothing)."""

    undo = None

    def _record(self, fn):
        restore = _Replaying.undo()
        self._fn = fn
        out = fn()
        restore()
        return out

    def _launch(self):
        from mxnet_tpu_torch import autograd
        tables = [c.cell_contents for c in self._fn.__closure__ or ()
                  if isinstance(c.cell_contents, SeedTable)]
        saved = [(t.kinds, t.words) for t in tables]
        for t in tables:
            t.kinds, t.words = [], []
        try:
            with autograd.train_mode(generator=torch.Generator()):
                new = self._fn()
        finally:
            for t, (kinds, words) in zip(tables, saved):
                t.kinds, t.words = kinds, words
        with torch.no_grad():
            for old, fresh in zip(_leaves(self._out), _leaves(new)):
                old.copy_(fresh)

    def capture(self, fn):
        self._out = super().capture(fn)
        return self._out


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _leaves(o)]


def _snapshot(trainer):
    ws = [p.data().clone() for p in trainer._params]
    sts = {i: [s.clone() for s in st]
           for i, st in (trainer._states or {}).items()}

    def restore():
        with torch.no_grad():
            for p, w in zip(trainer._params, ws):
                p.data().copy_(w)
            for i, st in sts.items():
                for s, v in zip(trainer._states[i], st):
                    s.copy_(v)
    return restore


@pytest.fixture
def replaying(monkeypatch):
    monkeypatch.setattr(capture, "Graph", _Replaying)
    monkeypatch.setattr(capture, "capturable", lambda device: True)
    yield _Replaying
    _Replaying.undo = None


def _train_setup(seed):
    net, trainer = _port_net(seed=seed)
    _Replaying.undo = lambda: _snapshot(trainer)
    return trainer, FusedTrainStep(_PortLoss(net, drop=0.3), trainer)


def _batch(t):
    return torch.from_numpy(_x(t))


def test_nan_grad_holds_the_step_and_ticks_the_counters(replaying):
    prandom.seed(8)
    trainer, step = _train_setup(0)
    for t in range(3):
        step(_batch(t), batch_size=4)             # eager, capture, replay
    before = _port_state(trainer)[:2]
    rec0 = _sample(telemetry, "mxtpu_faults_recovered_total",
                   {"site": "train.grads", "kind": "nan_grad"})
    skip0 = _sample(telemetry, "mxtpu_train_steps_skipped_total")
    steps0 = _sample(telemetry, "mxtpu_trainer_steps_total")
    faultline.plan([{"site": "train.grads", "kind": "nan_grad", "at": 1}])
    step(_batch(3), batch_size=4)
    assert not bool(step.last_step_finite)
    assert _port_state(trainer)[:2] == before
    assert _sample(telemetry, "mxtpu_faults_recovered_total",
                   {"site": "train.grads", "kind": "nan_grad"}) == rec0 + 1
    assert _sample(telemetry, "mxtpu_train_steps_skipped_total") == skip0 + 1
    assert trainer.skipped_steps == 1
    step(_batch(4), batch_size=4)                 # trains again
    assert bool(step.last_step_finite)
    assert _port_state(trainer)[0] != before[0]
    assert _sample(telemetry, "mxtpu_trainer_steps_total") == steps0 + 2
    assert step.captures == 1


def test_preempted_run_resumes_bitwise(replaying, tmp_path):
    n_steps, save_at = 8, 4
    prandom.seed(13)
    trainer, step = _train_setup(0)
    for t in range(n_steps):
        step(_batch(t), batch_size=4)
    oracle = _port_state(trainer)

    prandom.seed(13)
    trainer, step = _train_setup(0)
    mgr = resilience.CheckpointManager(tmp_path, keep=2, async_write=True,
                                       rank=0)
    faultline.plan([{"site": "train.grads", "kind": "preempt",
                     "at": save_at + 1}])
    for t in range(save_at):
        step(_batch(t), batch_size=4)
    mgr.save(save_at, *resilience.gather_training_state(trainer, save_at))
    at_save = _port_state(trainer)
    with pytest.raises(faultline.InjectedPreemption):
        step(_batch(save_at), batch_size=4)
    assert _port_state(trainer) == at_save         # the step changed nothing
    mgr.close()
    faultline.clear()

    invoke.set_default_generator(None)            # a restarted process
    prandom.seed(99)
    trainer, step = _train_setup(5)
    restored, arrays, meta = resilience.CheckpointManager(
        tmp_path, rank=0).restore_latest()
    assert resilience.restore_training_state(arrays, meta, trainer) == \
        restored == save_at
    assert _port_state(trainer) == at_save
    for t in range(save_at, n_steps):
        step(_batch(t), batch_size=4)
    assert _port_state(trainer) == oracle
