"""Ranks in the port: the ``torch.distributed`` bootstrap, the store
across ranks and `FusedTrainStep` over a dp mesh of processes, held
against the JAX package.

Worlds of two port ranks are started as the reference's own tests start
theirs, through ``tools/launch.py -n 2 --launcher local``, running
``tests/torch_dist_scripts/ranks_worker.py`` over gloo on the CPU
(``MXNET_DIST_CONTEXT=cpu``); each world is started once for its
module and its tests read what the ranks wrote.  Three worlds, about
4 s each:

- ``train``: the reference's `tests/dist_scripts/train_worker.py` case
  (Dense(4), mean-square loss, 3 SGD steps) against the same numpy
  oracle at rtol 1e-4 (asserted in each rank, read back here); the
  stores a ``Trainer`` makes in a world of 2; a training-state
  checkpoint that both ranks save and restore, and that a world of one
  refuses; ``--profile-rank 1``;
- ``bn``: `ranks_worker.bn_net` (Conv-BatchNorm-ReLU-Dense) through 3
  steps of SGD with momentum over 2 ranks, against the reference's
  `FusedTrainStep` over a 2-device dp mesh in this process, and against
  a 1-rank port step on the global batch, at ``BN_RTOL`` / ``BN_ATOL``
  (f32; the sums of the statistics and the gradients are taken in
  another order on each side).  Per-rank local statistics would have
  given outputs more than ``LOCAL_GAP`` away, so the test shows the
  sync; and dgamma/dbeta after the step's sum equal the full batch's
  (twice them would be 100 % off);
- ``live``: `TPUICIStore` across the ranks (rank, heartbeat and step-time
  stamps, a rank killed and reported on the second stale observation).

The start-up grace and the fault hooks of `get_dead_nodes` run in this
process over a stand-in for the store, as the reference's test does.
"""
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import _distributed as ref_distributed
from mxnet_tpu.parallel import mesh as ref_mesh
from mxnet_tpu_torch import _distributed, autograd, cpu, gluon, kv
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.kvstore.tpu_ici import TPUICIStore
from mxnet_tpu_torch.resilience import checkpoint, faultline

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_scripts" / "ranks_worker.py"
sys.path.insert(0, str(WORKER.parent))
import ranks_worker  # noqa: E402

BN_RTOL, BN_ATOL = 1e-4, 1e-5
LOCAL_GAP = 1e-2
WORLD_TIMEOUT = 120


def _world(mode, outdir, launcher_args=(), env=None):
    """Run a world of two port ranks in ``mode``; returns the ranks'
    JSON outputs."""
    full_env = dict(os.environ, MXNET_DIST_CONTEXT="cpu", **(env or {}))
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "launch.py"), "-n", "2",
         "--launcher", "local", *launcher_args, "--", sys.executable,
         str(WORKER), mode, str(outdir)],
        capture_output=True, text=True, timeout=WORLD_TIMEOUT, cwd=ROOT,
        env=full_env)
    # c10d warns on every connection where the host has no resolvable name
    err = "\n".join(line for line in r.stderr.splitlines()
                    if "hostname of the client socket" not in line)
    assert r.returncode == 0, f"{r.stdout[-2000:]}\n{err[-6000:]}"
    out = []
    for rank in range(2):
        path = outdir / f"{mode}-{rank}.json"
        out.append(json.loads(path.read_text()) if path.exists() else None)
    return out


# -- the bootstrap ------------------------------------------------------------

ENVS = {
    "absent": {},
    "complete": {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1234",
                 "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"},
    "partial": {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1234",
                "JAX_NUM_PROCESSES": "2"},
    "non_integer": {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1234",
                    "JAX_NUM_PROCESSES": "two", "JAX_PROCESS_ID": "1"},
}


@pytest.mark.parametrize("case", sorted(ENVS))
def test_read_env_matches_reference(case, monkeypatch):
    for var in ref_distributed._ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in ENVS[case].items():
        monkeypatch.setenv(k, v)
    got = {}
    for name, fn in (("ref", ref_distributed.read_env),
                     ("port", _distributed.read_env)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got[name] = (fn(), len(caught))
    assert got["port"] == got["ref"]
    assert got["port"][1] == (case in ("partial", "non_integer"))


@pytest.mark.parametrize("world, rank, cards, want_cpu, expect", [
    (2, 1, 0, False, ("gloo", "cpu")),
    (2, 1, 1, False, ("gloo", "cuda:0")),
    (1, 0, 1, False, ("nccl", "cuda:0")),
    (4, 3, 4, False, ("nccl", "cuda:3")),
    (4, 3, 8, False, ("nccl", "cuda:3")),
    (8, 5, 4, False, ("gloo", "cuda:1")),
    (2, 1, 4, True, ("gloo", "cpu")),
])
def test_backend_and_device_are_decided_up_front(world, rank, cards,
                                                 want_cpu, expect):
    backend, device = _distributed.choose(world, rank, cards, want_cpu)
    assert (backend, str(device)) == expect


def test_no_launcher_env_starts_no_group():
    assert not torch.distributed.is_initialized()
    assert _distributed.init_from_env() is False
    assert _distributed.backend() is None and _distributed.store() is None


# -- the train world ----------------------------------------------------------

@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_world")
    ranks = _world("train", out, ("--profile-rank", "1", "--profile-dir",
                                  str(out / "prof")))
    return out, ranks


def test_reference_train_worker_case_over_two_ranks(train_world):
    _, ranks = train_world
    # each rank asserted its weights and loss against the numpy oracle
    # (rtol 1e-4); both hold one weight, over gloo
    for r in ranks:
        assert r["backend"] == "gloo"
        onp.testing.assert_allclose(r["loss"], r["oracle_loss"], rtol=1e-4)
    assert ranks[0]["weight"] == ranks[1]["weight"]


def test_trainer_makes_the_store_in_a_world_of_two(train_world):
    _, ranks = train_world
    for rank, r in enumerate(ranks):
        assert r["stores"] == {"device": "LocalKVStore",
                               "tpu_ici": ["TPUICIStore", rank, 2],
                               "none": None}


def test_checkpoint_of_a_world_of_two(train_world):
    out, ranks = train_world
    # both ranks restored their own shard bitwise (asserted in the ranks)
    assert [r["ckpt_world"] for r in ranks] == [
        {"copies": 1, "processes": 2}] * 2
    steps = sorted(os.listdir(out / "ckpt"))
    assert len(steps) == 1
    assert sorted(os.listdir(out / "ckpt" / steps[0])) == [
        "host-00000", "host-00001"]
    # a world of one refuses it
    net = gluon.nn.Dense(4, in_units=5)
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    _step, arrays, meta = checkpoint.load_checkpoint(str(out / "ckpt"),
                                                     rank=0)
    with pytest.raises(checkpoint.CheckpointTopologyError,
                       match="2 process"):
        checkpoint.restore_training_state(arrays, meta, trainer)


def test_profile_rank_dumps_only_that_rank(train_world):
    out, _ = train_world
    assert sorted(os.listdir(out / "prof")) == ["profile_rank1.json"]
    trace = json.loads((out / "prof" / "profile_rank1.json").read_text())
    assert trace["traceEvents"]


# -- the BatchNorm world ------------------------------------------------------

def _bn_inputs():
    rs = onp.random.RandomState(5)
    net = ranks_worker.bn_net(gluon.nn)
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(3))
    params = {}
    for name, p in net._collect_params_with_prefix().items():
        shape = tuple(p.shape)
        if name.endswith("gamma"):
            v = rs.uniform(0.5, 1.5, shape)
        elif name.endswith("running_var"):
            v = onp.ones(shape)
        elif name.endswith(("beta", "bias", "running_mean")):
            v = rs.uniform(-0.1, 0.1, shape)
        else:
            v = rs.normal(0, 0.3, shape)
        params[name] = v.astype(onp.float32)
    # the channels' means differ between the two halves, so local
    # statistics would differ from the global ones
    x = rs.normal(0, 1, (8, 3, 6, 6)).astype(onp.float32)
    x[4:] = x[4:] * 2.0 + 0.5
    y = rs.randint(0, 3, (8,)).astype(onp.float32)
    return params, x, y


def _reference_bn_run(params, x, y):
    """3 steps of the reference's FusedTrainStep over a 2-device dp mesh;
    (losses, {step: {name: value}})."""
    net = ranks_worker.bn_net(mx.gluon.nn)
    net.initialize()
    net(mx.np.array(x[:1]))
    for name, p in net._collect_params_with_prefix().items():
        p.set_data(mx.np.array(params[name].copy()))
    mod = ranks_worker.with_loss(mx.gluon, net,
                                 mx.gluon.loss.SoftmaxCrossEntropyLoss())
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(ranks_worker.BN_OPT))
    mesh = ref_mesh.make_mesh({"dp": 2}, devices=jax.devices()[:2])
    step = mx.gluon.FusedTrainStep(mod, trainer, mesh=mesh)
    losses, after = [], []
    for _ in range(ranks_worker.BN_STEPS):
        losses.append(onp.asarray(step(mx.np.array(x), mx.np.array(y),
                                       batch_size=x.shape[0]).asnumpy()))
        after.append({n: onp.asarray(p.data().asnumpy()) for n, p in
                      net._collect_params_with_prefix().items()})
    return losses, after


def _port_net(params):
    net = ranks_worker.bn_net(gluon.nn)
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in net._collect_params_with_prefix().items():
            p.data().copy_(torch.from_numpy(params[name]))
    return net


def _port_one_rank(params, x, y):
    net = _port_net(params)
    mod = ranks_worker.with_loss(gluon, net, SoftmaxCrossEntropyLoss())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            dict(ranks_worker.BN_OPT))
    step = gluon.FusedTrainStep(mod, trainer)
    losses, after = [], []
    for _ in range(ranks_worker.BN_STEPS):
        losses.append(step(torch.from_numpy(x), torch.from_numpy(y),
                           batch_size=x.shape[0]).numpy())
        after.append({n: p.data().detach().numpy().copy() for n, p in
                      net._collect_params_with_prefix().items()})
    return losses, after


@pytest.fixture(scope="module")
def bn_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("bn_world")
    params, x, y = _bn_inputs()
    onp.savez(out / "bn_in.npz", x=x, y=y,
              **{"param/" + k: v for k, v in params.items()})
    meta = _world("bn", out)
    ranks = [dict(onp.load(out / f"bn-{r}.npz")) for r in range(2)]
    return params, x, y, ranks, meta


def _rank_run(rank_out):
    losses = [rank_out[f"loss/{k}"] for k in range(ranks_worker.BN_STEPS)]
    after = [{n[len(f"{k}/"):]: v for n, v in rank_out.items()
              if n.startswith(f"{k}/")} for k in range(ranks_worker.BN_STEPS)]
    return losses, after


def _assert_runs_close(mine, theirs, what):
    for k, (a, b) in enumerate(zip(mine[0], theirs[0])):
        onp.testing.assert_allclose(a, b, rtol=BN_RTOL, atol=BN_ATOL,
                                    err_msg=f"{what}: losses of step {k}")
    for k, (a, b) in enumerate(zip(mine[1], theirs[1])):
        assert sorted(a) == sorted(b)
        for name in a:
            onp.testing.assert_allclose(
                a[name], b[name], rtol=BN_RTOL, atol=BN_ATOL,
                err_msg=f"{what}: {name} after step {k}")


def test_bn_ranks_agree_bitwise_and_run_eagerly_over_gloo(bn_world):
    _, _, _, ranks, meta = bn_world
    assert sorted(ranks[0]) == sorted(ranks[1])
    for name in ranks[0]:
        onp.testing.assert_array_equal(ranks[0][name], ranks[1][name],
                                       err_msg=name)
    for m in meta:
        assert m["eager_reason"].startswith("gloo") and m["captures"] == 0


def test_bn_ranks_match_reference_mesh_step(bn_world):
    params, x, y, ranks, _ = bn_world
    _assert_runs_close(_rank_run(ranks[0]), _reference_bn_run(params, x, y),
                       "2 port ranks vs the reference's dp mesh")


def test_bn_ranks_match_one_rank_on_the_global_batch(bn_world):
    params, x, y, ranks, _ = bn_world
    _assert_runs_close(_rank_run(ranks[0]), _port_one_rank(params, x, y),
                       "2 port ranks vs 1 port rank")


def test_bn_statistics_are_global_not_local(bn_world):
    params, x, y, ranks, _ = bn_world
    net = _port_net(params)
    mod = ranks_worker.with_loss(gluon, net, SoftmaxCrossEntropyLoss())
    with autograd.record(train_mode=True):
        local = torch.cat([mod(torch.from_numpy(x[:4]), torch.from_numpy(y[:4])),
                           mod(torch.from_numpy(x[4:]), torch.from_numpy(y[4:]))])
    gap = float(onp.abs(local.detach().numpy() - ranks[0]["loss/0"]).max())
    assert gap > LOCAL_GAP, gap


def test_dgamma_dbeta_are_not_counted_twice(bn_world):
    params, x, y, ranks, _ = bn_world
    net = _port_net(params)
    mod = ranks_worker.with_loss(gluon, net, SoftmaxCrossEntropyLoss())
    with autograd.record(train_mode=True):
        total = mod(torch.from_numpy(x), torch.from_numpy(y)).sum()
    bn = net._collect_params_with_prefix()
    gamma, beta = bn["1.gamma"].data(), bn["1.beta"].data()
    dgamma, dbeta = torch.autograd.grad(total, (gamma, beta))
    lr = ranks_worker.BN_OPT["learning_rate"]
    n = x.shape[0]
    for name, full in (("1.gamma", dgamma), ("1.beta", dbeta)):
        # the first SGD-momentum step moves a weight by lr * grad / n
        moved = (params[name] - ranks[0][f"0/{name}"]) / lr * n
        onp.testing.assert_allclose(moved, full.numpy(), rtol=1e-3,
                                    atol=1e-5, err_msg=name)
        assert not onp.allclose(moved, 2 * full.numpy(), rtol=0.5)


# -- the store across ranks ---------------------------------------------------

@pytest.fixture(scope="module")
def live_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("live_world")
    return _world("live", out, env={"MXNET_HEARTBEAT_INTERVAL": "0.2"})


def test_store_across_ranks_reports_a_killed_rank(live_world):
    rank0, rank1 = live_world
    assert rank1 is None            # rank 1 exited hard, writing nothing
    assert rank0["steptimes"] == {"0": 0.25, "1": 1.25}
    assert rank0["dead"] == [1] and rank0["thread_joined"]
    assert rank0["seconds"] < 10
    # the poll that declared it dead was the second stale observation
    # in a row; every earlier poll reported no one
    polls = rank0["polls"]
    assert polls[-1][1:] == [[1], 2]
    assert polls[-2][1:] == [[], 1]
    assert all(p[1] == [] for p in polls[:-1])


class _FakeStore:
    """A stand-in for the bootstrap's TCPStore: ``check``, ``get``,
    ``set``."""

    def __init__(self):
        self.kv = {}

    def check(self, keys):
        return all(k in self.kv for k in keys)

    def get(self, key):
        return self.kv[key].encode()

    def set(self, key, val):
        self.kv[key] = val


@pytest.fixture
def fake_store(monkeypatch):
    store = kv.create("tpu_ici")
    fake = _FakeStore()
    monkeypatch.setattr(TPUICIStore, "_kv_client", lambda self: fake)
    store._size = 3
    faultline.clear()
    yield store, fake
    faultline.clear()
    store.close()


def test_dead_nodes_startup_grace(fake_store):
    kv_, fake = fake_store
    kv_._started_at = time.time()
    fake.set("mxtpu/heartbeat/0", repr(time.time()))
    # ranks 1, 2 never stamped, but the store just started: grace applies
    assert kv_.get_dead_nodes(timeout=60) == []
    # after the grace window the first stale observation only arms
    # suspicion, the second declares death
    kv_._started_at = time.time() - 120
    assert kv_.get_dead_nodes(timeout=60) == []
    assert kv_.get_dead_nodes(timeout=60) == [1, 2]
    fake.set("mxtpu/heartbeat/1", repr(time.time() - 999))
    kv_._started_at = time.time()
    kv_._stale_counts.clear()
    assert kv_.get_dead_nodes(timeout=60) == []
    assert kv_.get_dead_nodes(timeout=60) == [1]
    # a fresh stamp clears suspicion: no false kill
    fake.set("mxtpu/heartbeat/1", repr(time.time()))
    fake.set("mxtpu/heartbeat/2", repr(time.time() - 999))
    assert kv_.get_dead_nodes(timeout=60) == []
    fake.set("mxtpu/heartbeat/2", repr(time.time()))
    assert kv_.get_dead_nodes(timeout=60) == []


def test_dead_nodes_fault_hooks(fake_store):
    kv_, fake = fake_store
    now = repr(time.time())
    for r in range(3):
        fake.set(f"mxtpu/heartbeat/{r}", now)
    # a dead_node fault at kvstore.kv marks its rank stale for good
    faultline.plan([{"site": "kvstore.kv", "kind": "dead_node", "at": 1,
                     "rank": 2}])
    assert kv_.get_dead_nodes(timeout=60) == []      # fires while reading
    assert kv_.get_dead_nodes(timeout=60) == []      # first stale
    assert kv_.get_dead_nodes(timeout=60) == [2]
    # a bitflip of a stamp reads as a forged, stale beat
    faultline.plan([{"site": "kvstore.kv", "kind": "bitflip", "at": 1,
                     "index": 0, "bit": 6}])
    kv_._stale_counts.clear()
    assert kv_.get_dead_nodes(timeout=60) == []
    assert kv_._stale_counts == {0: 1}
    # a transient timeout is retried, and the stamp still read
    faultline.plan([{"site": "kvstore.kv", "kind": "timeout", "at": 1}])
    assert kv_.get_dead_nodes(timeout=60) == []
    assert kv_._stale_counts == {}
    # step-time stamps
    fake.set("mxtpu/steptime/1", "0.5")
    fake.set("mxtpu/steptime/2", "garbage")
    assert kv_.read_steptimes() == {1: 0.5}


def test_one_rank_store_has_no_peers():
    store = kv.create("tpu_ici")
    assert (store.rank, store.num_workers) == (0, 1)
    assert store.get_dead_nodes(timeout=0) == []
    assert store.read_steptimes() == {}
    store.close()
