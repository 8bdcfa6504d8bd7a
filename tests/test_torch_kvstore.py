"""The port's kvstore package against the JAX package's.

Both packages get the same seeded numpy values as per-context copies:
the port's on ``cpu(0)`` ... ``cpu(3)`` (four host contexts over one
memory), the reference's on its four virtual CPU devices.  Covered:
`create`'s aliases and refusals, ``pushpull`` and ``broadcast`` over
the copies with and without ``out=``, `LocalKVStore`'s
init/push/pull with an updater and an optimizer (its states saved and
loaded), `TestStore`, ``is_capable``, ``rank`` / ``num_workers`` /
``type``, a retried ``pushpull`` under an injected timeout, and the
refusals that name their queue items.  Then `gluon.Trainer` over the
stores: the reference's own data-parallel test
(`tests/test_kvstore_dist.py::test_multi_device_data_parallel_training`:
``Dense(1, in_units=6)`` on four copies, 60 SGD-momentum steps, store
``dist_sync``) run in both packages, which store each name makes,
``update_on_kvstore=True`` with ``local``, Nadam's parameter-by-parameter
update over copies, and per-copy optimizer states saved and loaded
across the packages.

Tolerance: the reference sums four copies with one XLA psum, the port in
index order on the first copy, so the sums agree within one f32 rounding
a term (rtol 1e-6); the port's copies are bitwise equal to each other
and to numpy's index-order f32 sum.  Over training, those roundings
compound: the 60-step trajectory is held at rtol 1e-4 on each loss (the
losses fall to about 1e-3) and atol 1e-5 on the weights (about 1), the
shorter ones at 1e-5.  The reference's hybridized block does not enter
its input's context (ROADMAP queue C, C11) and its ``net(x).sum()``
head gradient lands on the default device, so the reference runs its
nets eagerly under loss blocks here.  No reference registry counter is
asserted: the JAX package's registry is shared by every test of the
worker process.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import kvstore as ref_kv
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.gluon.utils import split_and_load as ref_split
from mxnet_tpu_torch import MXNetError, autograd, cpu, gluon, kv
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.utils import split_and_load
from mxnet_tpu_torch.kvstore import LocalKVStore, TPUICIStore, TestStore
from mxnet_tpu_torch.optimizer import SGD
from mxnet_tpu_torch.resilience import faultline
from mxnet_tpu_torch.telemetry.spans import _collective_metrics

torch.set_num_threads(1)

N = 4
RTOL = 1e-6
SHAPE = (5, 3)


def _values(seed=0, n=N):
    rng = onp.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(onp.float32)
            for _ in range(n)]


def _port(vals):
    return [torch.from_numpy(v.copy()) for v in vals]


def _ref(vals):
    return [mx.np.array(v.copy(), ctx=mx.cpu(i)) for i, v in
            enumerate(vals)]


def _index_order_sum(vals):
    total = vals[0].copy()
    for v in vals[1:]:
        total = total + v
    return total


@pytest.mark.parametrize("name", ["tpu_ici", "nccl", "dist_sync",
                                  "dist_device_sync", "horovod", "TPU_ICI"])
def test_collective_aliases(name):
    mine, theirs = kv.create(name), ref_kv.create(name)
    assert isinstance(mine, TPUICIStore)
    assert mine.type == theirs.type == "tpu_ici"
    assert (mine.rank, mine.num_workers) == (theirs.rank,
                                             theirs.num_workers) == (0, 1)
    assert mine.get_dead_nodes() == theirs.get_dead_nodes() == []


@pytest.mark.parametrize("name", ["local", "device", "local_allreduce_cpu",
                                  "local_allreduce_device"])
def test_local_aliases(name):
    mine, theirs = kv.create(name), ref_kv.create(name)
    assert isinstance(mine, LocalKVStore)
    assert mine.type == theirs.type == "local"
    assert (mine.rank, mine.num_workers) == (0, 1)


@pytest.mark.parametrize("name", ["dist_async", "p3", "dist_sync_device_p3",
                                  "dist_device_sync_p3", "no_such_store"])
def test_refused_names(name):
    for create, error in ((kv.create, MXNetError),
                          (ref_kv.create, mx.MXNetError)):
        with pytest.raises(error) as info:
            create(name)
        assert ("asynchronous" in str(info.value)) == \
            (name != "no_such_store")
    with pytest.raises(TypeError):
        kv.create(3)
    with pytest.raises(TypeError):
        ref_kv.create(3)


def test_is_capable_and_registry():
    for mine, theirs in ((kv.create("local"), ref_kv.create("local")),
                         (kv.create("tpu_ici"), ref_kv.create("tpu_ici")),
                         (kv.create("teststore"),
                          ref_kv.create("teststore"))):
        assert mine.is_capable("optimizer") == \
            theirs.is_capable("optimizer")
        with pytest.raises(MXNetError, match="unknown capability"):
            mine.is_capable("compression")
    assert kv.create("local").is_capable(kv.KVStoreBase.OPTIMIZER)
    assert kv.KVStoreBase.kv_registry["tpuicistore"] is TPUICIStore
    assert kv.KVStoreBase.kv_registry["teststore"] is TestStore
    assert kv.KVStore is LocalKVStore


@pytest.mark.parametrize("name", ["tpu_ici", "local", "teststore"])
def test_pushpull_in_place_over_host_copies(name):
    vals = _values(1)
    mine, theirs = _port(vals), _ref(vals)
    kv.create(name).pushpull(3, mine)
    ref_kv.create(name).pushpull(3, theirs)
    expect = _index_order_sum(vals)
    for m, t in zip(mine, theirs):
        onp.testing.assert_array_equal(m.numpy(), expect)
        onp.testing.assert_allclose(m.numpy(), t.asnumpy(), rtol=RTOL,
                                    atol=1e-6)


@pytest.mark.parametrize("name", ["tpu_ici", "local", "teststore"])
def test_pushpull_into_out(name):
    vals = _values(2)
    mine, theirs = _port(vals), _ref(vals)
    outs = [torch.zeros(SHAPE) for _ in range(2)]
    ref_outs = [mx.np.zeros(SHAPE, ctx=mx.cpu(i)) for i in range(2)]
    kv.create(name).pushpull("w", mine, out=outs)
    ref_kv.create(name).pushpull("w", theirs, out=ref_outs)
    for m, v in zip(mine, vals):                 # values untouched
        onp.testing.assert_array_equal(m.numpy(), v)
    for o, r in zip(outs, ref_outs):
        onp.testing.assert_array_equal(o.numpy(), _index_order_sum(vals))
        onp.testing.assert_allclose(o.numpy(), r.asnumpy(), rtol=RTOL,
                                    atol=1e-6)


def test_pushpull_of_one_copy_is_itself():
    (v,) = _values(3, 1)
    mine = torch.from_numpy(v.copy())
    for name in ("tpu_ici", "local"):
        kv.create(name).pushpull(0, mine)
        kv.create(name).pushpull(0, [mine])
        onp.testing.assert_array_equal(mine.numpy(), v)


@pytest.mark.parametrize("name", ["tpu_ici", "local", "teststore"])
def test_broadcast(name):
    vals = _values(4)
    outs = [torch.zeros(SHAPE) for _ in range(N)]
    ref_outs = [mx.np.zeros(SHAPE, ctx=mx.cpu(i)) for i in range(N)]
    kv.create(name).broadcast(7, torch.from_numpy(vals[0].copy()), outs)
    ref_kv.create(name).broadcast(7, mx.np.array(vals[0].copy()),
                                  ref_outs)
    for o, r in zip(outs, ref_outs):
        onp.testing.assert_array_equal(o.numpy(), vals[0])
        onp.testing.assert_array_equal(r.asnumpy(), vals[0])
    one = torch.zeros(SHAPE)
    kv.create(name).broadcast(7, [torch.from_numpy(vals[1].copy())], one)
    onp.testing.assert_array_equal(one.numpy(), vals[1])


def test_broadcast_into_a_leaf():
    """A parameter's copy is an autograd leaf; the store writes it
    outside autograd."""
    leaf = torch.zeros(SHAPE, requires_grad=True)
    kv.create("tpu_ici").broadcast(0, torch.ones(SHAPE), [leaf])
    assert leaf.requires_grad and bool((leaf == 1).all())


def test_pushpull_list_matches_per_key_pushpull():
    pairs_vals = [(k, _values(10 + k)) for k in range(3)]
    store = kv.create("tpu_ici")
    listed = [(k, _port(v)) for k, v in pairs_vals]
    store.pushpull_list(listed[::-1])
    for (k, v), (_, mine) in zip(pairs_vals, listed):
        single = _port(v)
        store.pushpull(k, single)
        for a, b in zip(mine, single):
            assert torch.equal(a, b)


def test_local_init_push_pull():
    vals = _values(5)
    mine, theirs = LocalKVStore(), ref_kv.create("local")
    mine.init("k", torch.from_numpy(vals[0].copy()))
    theirs.init("k", mx.np.array(vals[0].copy()))
    out = torch.zeros(SHAPE)
    ref_out = mx.np.zeros(SHAPE)
    mine.pull("k", out=out)
    theirs.pull("k", out=ref_out)
    onp.testing.assert_array_equal(out.numpy(), ref_out.asnumpy())
    mine.push("k", _port(vals))
    theirs.push("k", _ref(vals))
    outs = [torch.zeros(SHAPE) for _ in range(2)]
    mine.pull("k", out=outs)
    theirs.pull("k", out=ref_out)
    for o in outs:
        onp.testing.assert_allclose(o.numpy(), ref_out.asnumpy(), rtol=RTOL,
                                    atol=1e-6)
    # several keys at once
    mine.init(["a", "b"], [torch.ones(2), torch.zeros(2)])
    ab = [torch.empty(2), torch.empty(2)]
    mine.pull(["a", "b"], out=ab)
    assert ab[0].tolist() == [1, 1] and ab[1].tolist() == [0, 0]
    with pytest.raises(MXNetError, match="not initialized"):
        mine.pull("missing", out=out)
    with pytest.raises(ValueError):
        mine.init(["a", "b"], [torch.ones(2)])


def test_local_updater_and_optimizer():
    """A push through ``set_updater`` and through ``set_optimizer`` (SGD
    with momentum, the store's own states) against the reference's."""
    vals = _values(6)
    w0 = onp.random.default_rng(7).standard_normal(SHAPE).astype(onp.float32)
    calls = []

    def updater(key, grad, weight):
        calls.append(key)
        with torch.no_grad():
            weight.sub_(0.5 * grad)

    mine = LocalKVStore()
    mine.set_updater(updater)
    mine.init(3, torch.from_numpy(w0.copy()))
    mine.push(3, _port(vals))
    out = torch.zeros(SHAPE)
    mine.pull(3, out=out)
    onp.testing.assert_array_equal(
        out.numpy(), w0 - onp.float32(0.5) * _index_order_sum(vals))
    assert calls == [3]
    with pytest.raises(MXNetError, match="not initialized"):
        mine.push(4, _port(vals))

    mine, theirs = LocalKVStore(), ref_kv.create("local")
    mine.set_optimizer(SGD(learning_rate=0.1, momentum=0.9))
    theirs.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    mine.init(0, torch.from_numpy(w0.copy()))
    theirs.init(0, mx.np.array(w0.copy()))
    for step in range(3):
        v = _values(20 + step)
        mine.push(0, _port(v))
        theirs.push(0, _ref(v))
    out, ref_out = torch.zeros(SHAPE), mx.np.zeros(SHAPE)
    mine.pull(0, out=out)
    theirs.pull(0, out=ref_out)
    onp.testing.assert_allclose(out.numpy(), ref_out.asnumpy(), rtol=1e-5,
                                atol=1e-6)


def test_local_optimizer_states_round_trip(tmp_path):
    """``save_optimizer_states`` / ``load_optimizer_states`` of the store's
    updater, in the reference's file format, both ways."""
    w0 = onp.linspace(-1, 1, 15, dtype=onp.float32).reshape(SHAPE)
    mine = LocalKVStore()
    mine.set_optimizer(SGD(learning_rate=0.1, momentum=0.9))
    mine.init(0, torch.from_numpy(w0.copy()))
    mine.push(0, _port(_values(8)))
    mine.save_optimizer_states(str(tmp_path / "port.states"))
    theirs = ref_kv.create("local")
    theirs.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    theirs.init(0, mx.np.array(w0.copy()))
    theirs.load_optimizer_states(str(tmp_path / "port.states"))
    (mom,) = theirs._updater.states[0]
    onp.testing.assert_array_equal(
        mom.asnumpy(), mine._updater.states[0][0].numpy())
    theirs.push(0, _ref(_values(9)))
    theirs.save_optimizer_states(str(tmp_path / "ref.states"))
    back = LocalKVStore()
    back.set_optimizer(SGD(learning_rate=0.1, momentum=0.9))
    back.init(0, torch.from_numpy(w0.copy()))
    back.load_optimizer_states(str(tmp_path / "ref.states"))
    (state,) = back._updater.states[0]
    assert isinstance(state, torch.Tensor)
    onp.testing.assert_array_equal(state.numpy(),
                                   theirs._updater.states[0][0].asnumpy())
    with pytest.raises(MXNetError, match="optimizer is not set"):
        LocalKVStore().save_optimizer_states(str(tmp_path / "x"))


def test_pushpull_retries_an_injected_timeout():
    """A ``timeout`` at ``kvstore.pushpull`` costs one retry, and the
    reduction then runs once; the collective is counted in the port's
    registry (deltas: other tests share it)."""
    total = _collective_metrics()[0]
    before = total.labels(op="allreduce").value
    faultline.plan([{"site": "kvstore.pushpull", "kind": "timeout",
                     "at": 1}])
    try:
        vals = _values(11)
        mine = _port(vals)
        kv.create("tpu_ici").pushpull(0, mine)
    finally:
        faultline.clear()
    for m in mine:
        onp.testing.assert_array_equal(m.numpy(), _index_order_sum(vals))
    assert total.labels(op="allreduce").value == before + 1


def test_refusals_name_their_queue_items():
    store = kv.create("tpu_ici")
    # compression and bucketing are served now (tests/test_torch_
    # compression.py, tests/test_torch_bucketing.py)
    store.set_gradient_compression({"type": "2bit"})
    assert store._compression == {"type": "2bit", "threshold": 0.5}
    from mxnet_tpu_torch.kvstore.bucketing import GradBucketer
    assert kv.GradBucketer is GradBucketer
    sparse = [torch.eye(3).to_sparse(), torch.eye(3).to_sparse()]
    with pytest.raises(NotImplementedError, match="A10"):
        store.pushpull(0, sparse)
    with pytest.raises(NotImplementedError, match="A10"):
        kv.create("local").pushpull(0, sparse)
    with pytest.raises(AttributeError):
        kv.no_such_name


# -- Trainer over the stores ------------------------------------------------

def _dense_pair(n, units=6, seed=0):
    """``Dense(1, in_units=units)`` on ``n`` copies in both packages, the
    reference's values set from the port's (copied: the JAX package's
    CPU arrays may share a numpy buffer)."""
    ctxs = [cpu(i) for i in range(n)]
    rctx = [mx.cpu(i) for i in range(n)]
    net = nn.Dense(1, in_units=units)
    net.initialize(ctx=ctxs, generator=torch.Generator().manual_seed(seed))
    ref = ref_nn.Dense(1, in_units=units)
    ref.initialize(ctx=rctx)
    for k, p in ref.collect_params().items():
        p.set_data(mx.np.array(
            net.collect_params()[k].data(cpu(0)).detach().numpy().copy()))
    return net, ref, ctxs, rctx


def _train_both(net, ref, ctxs, rctx, trainers, X, Y, steps, batch):
    """``train_imagenet.py``'s loop in both packages (L2 loss); returns
    each step's mean loss, taken before the update, in both."""
    lf, rlf = gluon.loss.L2Loss(), mx.gluon.loss.L2Loss()
    tr, rtr = trainers
    mine, theirs = [], []
    for _ in range(steps):
        xs, ys = split_and_load(X, ctxs), split_and_load(Y, ctxs)
        with autograd.record():
            ls = [lf(net(xb), yb).mean() for xb, yb in zip(xs, ys)]
        autograd.backward(ls)
        mine.append(onp.mean([float(l.detach()) for l in ls]))
        tr.step(batch)
        rxs = ref_split(mx.np.array(X), rctx)
        rys = ref_split(mx.np.array(Y), rctx)
        with mx.autograd.record():
            rls = [rlf(ref(xb), yb).mean() for xb, yb in zip(rxs, rys)]
        mx.autograd.backward(rls)
        theirs.append(onp.mean([float(l.asnumpy()) for l in rls]))
        rtr.step(batch)
    return onp.asarray(mine), onp.asarray(theirs)


def _data(units=6, rows=64, seed=0):
    rng = onp.random.default_rng(seed)
    X = rng.standard_normal((rows, units)).astype(onp.float32)
    Y = X @ rng.standard_normal((units, 1)).astype(onp.float32)
    return X, Y


def _assert_copies_equal(param):
    first = param.list_data()[0]
    for other in param.list_data()[1:]:
        assert torch.equal(first, other), param.name


def test_multi_device_data_parallel_training():
    """The reference's test in both packages: copies start identical, the
    store reduces the gradients, the copies stay bitwise equal, and the
    two trajectories agree."""
    net, ref, ctxs, rctx = _dense_pair(4)
    p = net.collect_params()["weight"]
    _assert_copies_equal(p)
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    tr = gluon.Trainer(net.collect_params(), "sgd", opt,
                       kvstore="dist_sync")
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd", opt,
                           kvstore="dist_sync")
    X, Y = _data()
    mine, theirs = _train_both(net, ref, ctxs, rctx, (tr, rtr), X, Y, 60,
                               16)
    assert isinstance(tr.kvstore, TPUICIStore)
    assert mine[-1] < mine[0] * 1e-2, (mine[0], mine[-1])
    onp.testing.assert_allclose(mine, theirs, rtol=1e-4)
    for k, param in net.collect_params().items():
        _assert_copies_equal(param)
        for c, r in zip(param.list_data(),
                        ref.collect_params()[k].list_data()):
            onp.testing.assert_allclose(c.detach().numpy(), r.asnumpy(),
                                        rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kvstore,copies,kind", [
    ("device", 1, None), ("local", 1, None), (None, 2, None),
    ("local", 2, "local"), ("device", 2, "local"),
    ("tpu_ici", 1, "tpu_ici"), ("nccl", 2, "tpu_ici")])
def test_trainer_store_choice(kvstore, copies, kind):
    """No store for ``None``, or ``local``/``device`` over one copy; a
    store of the named type otherwise, as the reference chooses."""
    net, ref, _ctxs, _rctx = _dense_pair(copies)
    tr = gluon.Trainer(net.collect_params(), "sgd", kvstore=kvstore)
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd", kvstore=kvstore)
    rtr._init_kvstore()
    assert (tr.kvstore is None) == (rtr._kvstore is None) == (kind is None)
    if kind is not None:
        assert tr.kvstore.type == rtr._kvstore.type == kind


def test_trainer_takes_a_store_instance():
    """A `KVStoreBase` is taken as it is; `TestStore` reduces the copies
    and the training matches the reference's over its own."""
    net, ref, ctxs, rctx = _dense_pair(2)
    store = TestStore()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore=store)
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd",
                           {"learning_rate": 0.1},
                           kvstore=ref_kv.TestStore())
    assert tr.kvstore is store
    X, Y = _data(rows=8)
    mine, theirs = _train_both(net, ref, ctxs, rctx, (tr, rtr), X, Y, 3, 8)
    onp.testing.assert_allclose(mine, theirs, rtol=1e-5)
    _assert_copies_equal(net.weight)
    with pytest.raises(MXNetError, match="invalid kvstore"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore=3).kvstore


def test_update_on_kvstore_with_local():
    """``update_on_kvstore=True``: the store's updater runs SGD with
    momentum and every copy pulls the result, in both packages.  As in
    the reference, the step reduces the gradients first and then pushes
    every (reduced) copy, so the store applies twice their sum (C10),
    checked against numpy on the first step.  A store without the
    optimizer capability refuses it, in both."""
    net, ref, ctxs, rctx = _dense_pair(2, units=3, seed=4)
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    tr = gluon.Trainer(net.collect_params(), "sgd", opt, kvstore="local",
                       update_on_kvstore=True)
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd", opt,
                           kvstore="local", update_on_kvstore=True)
    X, Y = _data(units=3, rows=8, seed=2)
    w0 = net.weight.data(cpu(0)).detach().numpy().copy()
    b0 = net.bias.data(cpu(0)).detach().numpy().copy()
    mine, theirs = _train_both(net, ref, ctxs, rctx, (tr, rtr), X, Y, 1, 8)
    pred = X @ w0.T + b0
    g = ((pred - Y) / 4).T @ X                  # d(sum of L2 means)/dw
    onp.testing.assert_allclose(net.weight.data(cpu(1)).detach().numpy(),
                                w0 - onp.float32(0.05) * 2 * g / 8,
                                rtol=1e-5, atol=1e-6)
    more = _train_both(net, ref, ctxs, rctx, (tr, rtr), X, Y, 4, 8)
    onp.testing.assert_allclose(onp.concatenate([mine, more[0]]),
                                onp.concatenate([theirs, more[1]]),
                                rtol=1e-5)
    for k, param in net.collect_params().items():
        _assert_copies_equal(param)
        onp.testing.assert_allclose(
            param.data(cpu(0)).detach().numpy(),
            ref.collect_params()[k].data(mx.cpu(0)).asnumpy(), rtol=1e-5,
            atol=1e-6)
    for make, model in ((gluon.Trainer, net), (mx.gluon.Trainer, ref)):
        with pytest.raises(ValueError, match="update_on_kvstore"):
            make(model.collect_params(), "sgd", kvstore="tpu_ici",
                 update_on_kvstore=True)._init_kvstore()


def test_unfused_optimizer_over_copies():
    """Nadam runs parameter by parameter; each copy's ``update_math``
    advances its host momentum schedule, as the reference's per-copy
    update does, so the two packages' copies agree copy by copy."""
    net, ref, ctxs, rctx = _dense_pair(2, units=3, seed=5)
    opt = {"learning_rate": 0.01}
    tr = gluon.Trainer(net.collect_params(), "nadam", opt,
                       kvstore="tpu_ici")
    rtr = mx.gluon.Trainer(ref.collect_params(), "nadam", opt,
                           kvstore="tpu_ici")
    X, Y = _data(units=3, rows=8, seed=6)
    mine, theirs = _train_both(net, ref, ctxs, rctx, (tr, rtr), X, Y, 3, 8)
    onp.testing.assert_allclose(mine, theirs, rtol=1e-5)
    for k, param in net.collect_params().items():
        for c, r in zip(param.list_data(),
                        ref.collect_params()[k].list_data()):
            onp.testing.assert_allclose(c.detach().numpy(), r.asnumpy(),
                                        rtol=1e-5, atol=1e-7, err_msg=k)


def test_per_copy_states_save_and_load(tmp_path):
    """Every copy keeps its own state; the file holds the first copy's,
    as the reference's does, and a load fills every copy.  A file the
    reference saved with two copies loads in the port, and the port's
    in the reference."""
    net, ref, ctxs, rctx = _dense_pair(2)
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    tr = gluon.Trainer(net.collect_params(), "sgd", opt, kvstore="device")
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd", opt,
                           kvstore="device")
    X, Y = _data(rows=8)
    _train_both(net, ref, ctxs, rctx, (tr, rtr), X, Y, 2, 8)
    states = tr._states
    assert all(isinstance(st, list) and len(st) == 2
               for st in states.values())
    assert states[0][0][0] is not states[0][1][0]
    tr.save_states(str(tmp_path / "port.states"))
    rtr.save_states(str(tmp_path / "ref.states"))
    for fname in ("port.states", "ref.states"):
        fresh = gluon.Trainer(net.collect_params(), "sgd", opt,
                              kvstore="device")
        fresh.load_states(str(tmp_path / fname))
        for i, copies in fresh._states.items():
            ref_state = rtr._states[i][0][0].asnumpy()
            for (mom,) in copies:
                onp.testing.assert_allclose(mom.numpy(), ref_state,
                                            rtol=1e-5, atol=1e-7)
    back = mx.gluon.Trainer(ref.collect_params(), "sgd", opt,
                            kvstore="device")
    back.load_states(str(tmp_path / "port.states"))
    for i, copies in back._states.items():
        for (mom,) in copies:
            onp.testing.assert_array_equal(mom.asnumpy(),
                                           states[i][0][0].numpy())


def test_states_follow_reset_ctx():
    """Parameters moved onto one more context after a step: each gets a
    state for the new copy (the old ones made anew, as the reference's
    update does), and the three copies train equal."""
    net, _ref, ctxs, _rctx = _dense_pair(2)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       kvstore="tpu_ici")
    X, Y = _data(rows=6)
    lf = gluon.loss.L2Loss()
    for ctxs in (ctxs, [cpu(0), cpu(1), cpu(2)]):
        for p in net.collect_params().values():
            p.reset_ctx(ctxs)
        xs, ys = split_and_load(X, ctxs), split_and_load(Y, ctxs)
        with autograd.record():
            ls = [lf(net(xb), yb).mean() for xb, yb in zip(xs, ys)]
        autograd.backward(ls)
        tr.step(6)
    assert all(len(st) == 3 for st in tr._states.values())
    for param in net.collect_params().values():
        _assert_copies_equal(param)
