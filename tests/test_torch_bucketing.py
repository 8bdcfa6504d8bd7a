"""The port's `kvstore.bucketing.GradBucketer` against the JAX package's.

The same seeded numpy values go to both packages as per-context copies:
the port's on ``cpu(0)`` ... ``cpu(3)`` (host tensors marked with their
context, as `split_and_load` and `Parameter.grad` mark them), the
reference's on its virtual CPU devices.  Covered, at the sizes of the
reference's `tests/test_kvstore_bucketing.py`: the plan (bucket
boundaries, capacities, issue order, `last_num_buckets`, mixed dtypes,
an oversize tensor alone, ``MXNET_KVSTORE_BUCKET_BYTES``), dense values
bucketed against per-key and against the reference, the collectives a
step launches, the signature digest a checkpoint keys residuals by,
`LocalKVStore` over the bucketer, and `Trainer`'s issue order, its
``MXNET_KVSTORE_BUCKETING=0`` per-key loop and its trajectory with and
without bucketing.

Tolerance: none.  The port's ring over host copies sums in copy-index
order, as XLA's all-reduce over the reference's host devices does, so
dense values are bitwise the reference's here (the test states rtol 0);
and bucketed and per-key are bitwise equal in the port.  Registry
counts are deltas of one registry per package, read within one test.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import kvstore as ref_kv
from mxnet_tpu import telemetry as ref_tm
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.gluon.utils import split_and_load as ref_split
from mxnet_tpu.kvstore import bucketing as ref_bucketing
from mxnet_tpu_torch import autograd, cpu, gluon, kv, telemetry
from mxnet_tpu_torch.context import mark_context
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.utils import split_and_load
from mxnet_tpu_torch.kvstore import bucketing
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

N = 4
LAUNCHES = "mxtpu_kvstore_collective_launches_total"

MIXED_SIZES = [((256,), "float32"), ((16, 16), "float32"),
               ((4096,), "float32"), ((3, 3, 8, 8), "float32"),
               ((1024, 64), "float32"), ((7,), "float32")]
DTYPES = [((256,), "float32"), ((128,), "bfloat16"),
          ((512,), "float32"), ((64,), "bfloat16")]


def _port(arrays, dtype="float32", ctxs=None):
    """Host copies, copy c marked with ``cpu(c)`` (or ``ctxs[c]``)."""
    out = []
    for c, a in enumerate(arrays):
        t = torch.from_numpy(onp.array(a, onp.float32)).to(
            getattr(torch, dtype))
        out.append(mark_context(t, cpu(c) if ctxs is None else ctxs[c]))
    return out


def _ref(arrays, dtype="float32"):
    return [mx.np.array(onp.array(a, onp.float32), dtype=dtype,
                        ctx=mx.cpu(c)) for c, a in enumerate(arrays)]


def _values(seed, specs, n=N):
    """Per spec, n distinct f32 arrays (copy c is the base plus c)."""
    rs = onp.random.RandomState(seed)
    out = []
    for shape, _dtype in specs:
        base = rs.randn(*shape).astype(onp.float32)
        out.append([base + c for c in range(n)])
    return out


def _pairs(seed, specs, n=N):
    vals = _values(seed, specs, n)
    port = [(k, _port(v, dt)) for k, (v, (_, dt)) in
            enumerate(zip(vals, specs))]
    ref = [(k, _ref(v, dt)) for k, (v, (_, dt)) in
           enumerate(zip(vals, specs))]
    return port, ref


def _np(t):
    return t.detach().float().numpy()


def _plan(bucketer):
    (plan,) = bucketer._plans.values()
    return [(list(b.keys), b.used, b.capacity) for b in plan]


def _sample(registry, name, labels=None):
    return registry.get_sample_value(name, labels) or 0.0


# -- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["mixed", "dtypes", "oversize", "tiny",
                                  "env_cap"])
def test_plan_equals_the_reference(case, monkeypatch):
    """Bucket boundaries, capacities, the issue order and the bucket
    count equal the reference's for the same items."""
    kw, n = {}, N
    specs = {"mixed": MIXED_SIZES, "dtypes": DTYPES,
             "oversize": [((64,), "float32"), ((1024,), "float32"),
                          ((64,), "float32")],
             "tiny": [((64,), "float32")] * 12,
             "env_cap": [((256,), "float32")] * 8}[case]
    if case == "oversize":
        kw, n = {"bucket_bytes": 1024}, 2
    if case == "env_cap":
        monkeypatch.setenv("MXNET_KVSTORE_BUCKET_BYTES", "2048")
        n = 2
    port, ref = _pairs(3, specs, n)
    mine, theirs = bucketing.GradBucketer(**kw), \
        ref_bucketing.GradBucketer(**kw)
    mine.pushpull(port[::-1])
    theirs.pushpull(ref[::-1])
    assert _plan(mine) == _plan(theirs)
    assert mine.last_issue_keys == theirs.last_issue_keys
    assert mine.last_num_buckets == theirs.last_num_buckets
    assert mine.bucket_bytes == theirs.bucket_bytes
    if case == "oversize":
        assert [k for k, _, _ in _plan(mine)] == [[2], [1], [0]]
    if case == "dtypes":
        assert mine.last_num_buckets == 2
        for b in next(iter(mine._plans.values())):
            assert len({port[0][1][0].dtype}) == 1 and b.dtype in (
                torch.float32, torch.bfloat16)
    if case == "tiny":
        (b,) = next(iter(mine._plans.values()))
        assert b.capacity % (bucketing.DEFAULT_QUANTUM_BYTES // 4) == 0
    if case == "env_cap":
        assert mine.bucket_bytes == 2048 and mine.last_num_buckets == 4


# -- dense values -------------------------------------------------------------

@pytest.mark.parametrize("specs", [MIXED_SIZES, DTYPES],
                         ids=["mixed", "dtypes"])
def test_dense_bucketed_equals_per_key_and_the_reference(specs):
    """Bucketed and per-key pushpull are bitwise equal in the port, and
    the port's values bitwise the reference's bucketed ones."""
    port_b, ref_b = _pairs(0, specs)
    port_k, _ = _pairs(0, specs)
    store_b, store_k = kv.create("tpu_ici"), kv.create("tpu_ici")
    ref_store = ref_kv.create("tpu_ici")
    store_b.pushpull_list(port_b[::-1])
    ref_store.pushpull_list(ref_b[::-1])
    for k, vals in port_k[::-1]:
        store_k.pushpull(k, vals)
    for (k, vb), (_, vk), (_, vr) in zip(port_b, port_k, ref_b):
        for a, b, r in zip(vb, vk, vr):
            assert torch.equal(a, b), k
            onp.testing.assert_allclose(
                _np(a), r.asnumpy().astype(onp.float32), rtol=0, atol=0,
                err_msg=str(k))
    assert store_b._bucketer.last_issue_keys == \
        ref_store._bucketer.last_issue_keys


def test_oversize_tensor_reduces_alone():
    b = bucketing.GradBucketer(bucket_bytes=1024)
    pairs = [(0, _port([onp.full(64, 1.0)] * 2)),
             (1, _port([onp.arange(1024)] * 2)),       # 4 KB > the cap
             (2, _port([onp.full(64, 3.0)] * 2))]
    b.pushpull(pairs)
    assert [k for k, _, _ in _plan(b)] == [[0], [1], [2]]
    onp.testing.assert_array_equal(_np(pairs[1][1][0]),
                                   2 * onp.arange(1024, dtype=onp.float32))
    onp.testing.assert_array_equal(_np(pairs[0][1][1]), onp.full(64, 2.0))


def test_unmarked_copies_take_the_fallback():
    """Host tensors that carry no context cannot say they are distinct:
    the fallback sums them on the first copy's device, bitwise the
    ring's sum."""
    vals = _values(5, MIXED_SIZES)
    marked = [(k, _port(v)) for k, v in enumerate(vals)]
    plain = [(k, [torch.from_numpy(a.copy()) for a in v])
             for k, v in enumerate(vals)]
    kv.create("tpu_ici").pushpull_list(marked)
    kv.create("tpu_ici").pushpull_list(plain)
    for (_, a), (_, b) in zip(marked, plain):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_launches_collapse_and_the_fill_gauge():
    """Twelve small gradients cost one collective bucketed and twelve per
    key, in both packages' registries; the fill gauge reads the bucket's
    payload share, and its bytes ride ``allreduce_bucket``."""
    reg, ref_reg = telemetry.default_registry(), ref_tm.default_registry()
    specs = [((256,), "float32")] * 12
    port, ref = _pairs(3, specs)
    store, ref_store = kv.create("tpu_ici"), ref_kv.create("tpu_ici")
    before = (_sample(reg, LAUNCHES), _sample(ref_reg, LAUNCHES))
    store.pushpull_list(port[::-1])
    ref_store.pushpull_list(ref[::-1])
    assert _sample(reg, LAUNCHES) - before[0] == \
        _sample(ref_reg, LAUNCHES) - before[1] == 1
    before = _sample(reg, LAUNCHES)
    for k, vals in _pairs(3, specs)[0][::-1]:
        store.pushpull(k, vals)
    assert _sample(reg, LAUNCHES) - before == 12
    fill = _sample(reg, "mxtpu_kvstore_bucket_fill_fraction",
                   {"bucket": "0"})
    assert fill == _sample(ref_reg, "mxtpu_kvstore_bucket_fill_fraction",
                           {"bucket": "0"})
    assert 0.0 < fill <= 1.0
    assert _sample(reg, "mxtpu_kvstore_collective_bytes_total",
                   {"op": "allreduce_bucket"}) > 0


def test_single_copy_and_sparse_stay_per_key():
    store = kv.create("tpu_ici")
    single = torch.tensor([0.3, -0.2])
    dense = _port([onp.full(8, 1.0)] * 2)
    store.pushpull_list([(0, [single]), (2, dense)])
    onp.testing.assert_allclose(single.numpy(), [0.3, -0.2])
    onp.testing.assert_array_equal(_np(dense[0]), onp.full(8, 2.0))
    assert store._bucketer.last_issue_keys == [2]
    sparse = [torch.eye(3).to_sparse(), torch.eye(3).to_sparse()]
    with pytest.raises(NotImplementedError, match="A10"):
        store.pushpull_list([(1, sparse)])


def test_local_store_buckets_as_the_reference():
    """`LocalKVStore` rides the same bucketer: its bucketed values equal
    its per-key reduce bitwise, and the reference's."""
    port_b, ref_b = _pairs(5, MIXED_SIZES, n=2)
    port_k, _ = _pairs(5, MIXED_SIZES, n=2)
    store_b, store_k = kv.LocalKVStore(), kv.LocalKVStore()
    ref_store = ref_kv.LocalKVStore()
    store_b.pushpull_list(port_b[::-1])
    ref_store.pushpull_list(ref_b[::-1])
    for k, vals in port_k[::-1]:
        store_k.pushpull(k, vals)
    assert store_b._bucketer.last_num_buckets == \
        ref_store._bucketer.last_num_buckets
    for (k, vb), (_, vk), (_, vr) in zip(port_b, port_k, ref_b):
        for a, b, r in zip(vb, vk, vr):
            assert torch.equal(a, b), k
            onp.testing.assert_allclose(_np(a), r.asnumpy(), rtol=1e-6,
                                        err_msg=str(k))


def test_bucket_bytes_env_shapes_a_fresh_bucketer(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_BYTES", "2048")
    b = bucketing.GradBucketer()
    assert b.bucket_bytes == 2048
    b.pushpull([(k, _port([onp.full(256, 1.0)] * 2)) for k in range(8)])
    assert b.last_num_buckets == 4


# -- the checkpoint's digest ----------------------------------------------------

@pytest.mark.parametrize("specs", [MIXED_SIZES, DTYPES],
                         ids=["mixed", "dtypes"])
def test_signature_digest_and_layouts_equal_the_reference(specs):
    """The digest a checkpoint keys bucket residuals by, and the bucket
    layouts, are the reference's for the same items: python-int shapes,
    numpy dtype names, the copy count, no contexts."""
    port, ref = _pairs(7, specs)
    mine, theirs = bucketing.GradBucketer(), ref_bucketing.GradBucketer()
    mine.pushpull(port[::-1])
    theirs.pushpull(ref[::-1])
    (sig,), (ref_sig,) = mine._plans, theirs._plans
    assert mine._sig_digest(sig) == theirs._sig_digest(ref_sig)
    assert mine.export_layouts() == theirs.export_layouts()
    # copies on other contexts (cpu(2), cpu(3)) plan again, same digest
    other = [(k, _port([_np(v) for v in vals[:2]],
                       str(vals[0].dtype).replace("torch.", ""),
                       ctxs=[cpu(2), cpu(3)])) for k, vals in port]
    two = [(k, vals[:2]) for k, vals in port]
    b2 = bucketing.GradBucketer()
    b2.pushpull(two)
    b2.pushpull(other)
    assert len(b2._plans) == 2
    assert len({b2._sig_digest(s) for s in b2._plans}) == 1


# -- the Trainer --------------------------------------------------------------

class _SpyStore(kv.KVStoreBase):
    """Records how the Trainer hands its gradients to a real store."""

    def __init__(self):
        self._inner = kv.create("tpu_ici")
        self.pushpull_calls = []
        self.list_keys = None

    def broadcast(self, key, value, out, priority=0):
        self._inner.broadcast(key, value, out, priority)

    def pushpull(self, key, value, out=None, priority=0):
        self.pushpull_calls.append((key, priority))
        self._inner.pushpull(key, value, out)

    def pushpull_list(self, pairs):
        self.list_keys = [k for k, _ in pairs]
        self._inner.pushpull_list(pairs)

    @staticmethod
    def is_capable(capability):
        return kv.TPUICIStore.is_capable(capability)

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    @property
    def type(self):
        return "spy"


def _mlp(n_ctx=2, seed=0):
    ctxs = [cpu(i) for i in range(n_ctx)]
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=6), nn.Dense(8, in_units=8),
            nn.Dense(4, in_units=8))
    net.initialize(ctx=ctxs, generator=torch.Generator().manual_seed(seed))
    return net, ctxs


def _ref_mlp(n_ctx, net):
    rctx = [mx.cpu(i) for i in range(n_ctx)]
    ref = ref_nn.HybridSequential()
    ref.add(ref_nn.Dense(8, in_units=6), ref_nn.Dense(8, in_units=8),
            ref_nn.Dense(4, in_units=8))
    ref.initialize(ctx=rctx)
    for (_, p), (_, r) in zip(net.collect_params().items(),
                              ref.collect_params().items()):
        r.set_data(mx.np.array(_np(p.data(cpu(0))).copy()))
    return ref, rctx


def _batch(t, rows=8):
    return onp.random.RandomState(100 + t).randn(rows, 6).astype(onp.float32)


def _step(net, trainer, ctxs, x):
    xs = split_and_load(torch.from_numpy(x), ctxs)
    with autograd.record():
        losses = [(net(xb) ** 2).mean() for xb in xs]
    autograd.backward(losses)
    trainer.step(x.shape[0])
    return [float(l.detach()) for l in losses]


def _ref_step(ref, trainer, rctx, x):
    xs = ref_split(mx.np.array(x), rctx)
    with mx.autograd.record():
        losses = [(ref(xb) ** 2).mean() for xb in xs]
    mx.autograd.backward(losses)
    trainer.step(x.shape[0])
    return [float(l.asnumpy()) for l in losses]


def test_trainer_issues_reverse_registration_order():
    spy = _SpyStore()
    net, ctxs = _mlp()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05}, kvstore=spy)
    _step(net, trainer, ctxs, _batch(0))
    n_params = len(net.collect_params())
    assert spy.list_keys == list(range(n_params))[::-1]
    assert spy.pushpull_calls == []


def test_trainer_bucketing_opt_out_pushes_key_by_key(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BUCKETING", "0")
    spy = _SpyStore()
    net, ctxs = _mlp()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05}, kvstore=spy)
    _step(net, trainer, ctxs, _batch(0))
    n_params = len(net.collect_params())
    assert spy.list_keys is None
    assert spy.pushpull_calls == [(i, -i) for i in range(n_params)]


def test_trainer_launches_a_step_equal_the_reference():
    """Two copies of the reference's 3-layer net: a step's collectives,
    counted in each package's registry, are equal and below the count of
    parameters; the copies stay bitwise equal."""
    net, ctxs = _mlp(2)
    ref, rctx = _ref_mlp(2, net)
    opt = {"learning_rate": 0.05}
    tr = gluon.Trainer(net.collect_params(), "sgd", opt, kvstore="tpu_ici")
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd", opt,
                           kvstore="tpu_ici")
    _step(net, tr, ctxs, _batch(0))
    _ref_step(ref, rtr, rctx, _batch(0))
    reg, ref_reg = telemetry.default_registry(), ref_tm.default_registry()
    before = (_sample(reg, LAUNCHES), _sample(ref_reg, LAUNCHES))
    _step(net, tr, ctxs, _batch(1))
    _ref_step(ref, rtr, rctx, _batch(1))
    mine = _sample(reg, LAUNCHES) - before[0]
    theirs = _sample(ref_reg, LAUNCHES) - before[1]
    n_params = len(net.collect_params())
    assert mine == theirs < n_params, (mine, theirs, n_params)
    for p in net.collect_params().values():
        first = p.list_data()[0]
        assert all(torch.equal(first, c) for c in p.list_data()[1:])


def test_trainer_bucketed_matches_per_key_training(monkeypatch):
    """Three steps with bucketing on and off: the weights are bitwise
    equal, and within 1e-6 of the reference's bucketed run (the
    packages' matmuls round differently)."""
    def run(flag):
        monkeypatch.setenv("MXNET_KVSTORE_BUCKETING", flag)
        net, ctxs = _mlp(2, seed=7)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9},
                           kvstore="tpu_ici")
        for t in range(3):
            _step(net, tr, ctxs, _batch(t))
        return net, {k: _np(p.data(cpu(0)))
                     for k, p in net.collect_params().items()}

    net_on, w_on = run("1")
    _, w_off = run("0")
    monkeypatch.setenv("MXNET_KVSTORE_BUCKETING", "1")
    fresh, _ = _mlp(2, seed=7)
    ref, rctx = _ref_mlp(2, fresh)
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9},
                           kvstore="tpu_ici")
    for t in range(3):
        _ref_step(ref, rtr, rctx, _batch(t))
    for (k, w), (_, r) in zip(w_on.items(), ref.collect_params().items()):
        assert onp.array_equal(w, w_off[k]), k
        onp.testing.assert_allclose(w, r.data().asnumpy(), rtol=0,
                                    atol=1e-6, err_msg=k)


def test_load_reference_params_over_copies_then_bucketed_step():
    """Weights carried from the reference (`load_reference_params`) reach
    every copy, and one bucketed step keeps the copies bitwise equal."""
    net, ctxs = _mlp(2)
    ref, _ = _ref_mlp(2, _mlp(2, seed=3)[0])
    load_reference_params(net, {k: p.data().asnumpy() for k, p in
                                ref.collect_params().items()})
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05}, kvstore="tpu_ici")
    _step(net, tr, ctxs, _batch(0))
    assert tr.kvstore._bucketer.last_num_buckets == 1
    for p in net.collect_params().values():
        a, b = p.list_data()
        assert torch.equal(a, b)
