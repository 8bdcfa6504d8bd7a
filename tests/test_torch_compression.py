"""The port's gradient compression, integrity sideband and residual
checkpoints against the JAX package's.

The same seeded numpy values go to both packages as per-context copies
(the port's host tensors marked ``cpu(0)`` ... ``cpu(3)``, the
reference's on its virtual CPU devices), at the sizes of the
reference's `tests/test_kvstore_bucketing.py`, `tests/test_sentinel.py`
and `tests/test_resilience.py`.  Covered: 2bit, int8 and fp8 per key and
bucketed over three steps (reduced values and residuals), the ring body
against its collective-free twin and over a stand-in for the NCCL
binding, fp8 inside the reference's oracle
envelope, the residual reset on a change of contexts, shape or dtype,
``MXNET_KVSTORE_QBLOCK`` and ``block``, the unsupported-type message,
the wrapping digest on edge values, a planned ``bitflip`` caught through
`Trainer` (the step skipped, the three counters), residuals through a
checkpoint (``kvres/``, ``bucketres/``, a preempted compressed run
resumed, checkpoints crossing the packages), and `Trainer` trajectories
with compression in both packages.

Tolerances.  Reduced values and residuals are bitwise the reference's
for every type here: the port follows what XLA makes of the reference's
code (the scale times the f32 reciprocal of qmax, the residual's fused
multiply-subtract, a 16-bit sum accumulated in f32 over host copies).
The fp8 envelope is the reference's own: one top-of-range fp8 step a
copy.  A trajectory differs only through the packages' matmuls (a few
f32 ulps of a gradient).  A quantization level that flipped would move
a weight by lr / batch x one quantum: 1.25e-3 for 2bit at threshold
0.1, about 3e-5 for int8 at this trajectory's gradients (at most 0.15);
the weights are held within 1e-6 and the losses within 1e-6 relative,
which tells the two apart.
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
from mxnet_tpu.kvstore import tpu_ici as ref_ici
from mxnet_tpu.resilience import checkpoint as ref_ckpt
from mxnet_tpu.resilience import faultline as ref_fl
from mxnet_tpu_torch import MXNetError, autograd, cpu, gluon, kv, telemetry
from mxnet_tpu_torch.context import mark_context
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.utils import split_and_load
from mxnet_tpu_torch.kvstore import bucketing, tpu_ici
from mxnet_tpu_torch.resilience import checkpoint as ckpt
from mxnet_tpu_torch.resilience import faultline

torch.set_num_threads(1)

N = 4
TYPES = ["2bit", "int8", "fp8"]


def _params(qtype, **kw):
    out = {"type": qtype}
    if qtype == "2bit":
        out["threshold"] = 0.7
    out.update(kw)
    return out


def _port(arrays, dtype="float32", ctxs=None):
    out = []
    for c, a in enumerate(arrays):
        t = torch.from_numpy(onp.array(a, onp.float32)).to(
            getattr(torch, dtype))
        out.append(mark_context(t, cpu(c) if ctxs is None else ctxs[c]))
    return out


def _ref(arrays, dtype="float32"):
    return [mx.np.array(onp.array(a, onp.float32), dtype=dtype,
                        ctx=mx.cpu(c)) for c, a in enumerate(arrays)]


def _np(t):
    return t.detach().float().numpy()


def _stores(qtype, **kw):
    mine, theirs = kv.create("tpu_ici"), ref_kv.create("tpu_ici")
    mine.set_gradient_compression(_params(qtype, **kw))
    theirs.set_gradient_compression(_params(qtype, **kw))
    return mine, theirs


def _assert_same(port_vals, ref_vals, what):
    for c, (a, b) in enumerate(zip(port_vals, ref_vals)):
        b = b.asnumpy() if hasattr(b, "asnumpy") else onp.asarray(b)
        assert onp.array_equal(_np(a).reshape(-1),
                               b.astype(onp.float32).reshape(-1)), \
            (what, c, float(onp.abs(_np(a).reshape(-1) - b.astype(
                onp.float32).reshape(-1)).max()))


def _sample(registry, name, labels=None):
    return registry.get_sample_value(name, labels) or 0.0


# -- the reduce ---------------------------------------------------------------

@pytest.mark.parametrize("qtype", TYPES)
def test_per_key_bitwise_the_reference_over_three_steps(qtype):
    """One key over four host copies: the reduced values and every
    copy's residual equal the reference's bitwise, step after step."""
    base = onp.random.RandomState(11).randn(700).astype(onp.float32)
    mine, theirs = _stores(qtype)
    for step in range(3):
        grads = [base * (0.5 ** step) + c for c in range(N)]
        a, b = _port(grads), _ref(grads)
        mine.pushpull("k", a)
        theirs.pushpull("k", b)
        _assert_same(a, b, f"{qtype} step {step}")
        _assert_same([mine._residuals[("k", c)] for c in range(N)],
                     [theirs._residuals[("k", c)] for c in range(N)],
                     f"{qtype} residuals step {step}")


BUCKET_SPECS = [((256,), "float32"), ((16, 16), "float32"),
                ((4096,), "float32"), ((3, 3, 8, 8), "float32"),
                ((1024, 64), "float32"), ((7,), "float32"),
                ((128,), "bfloat16"), ((64,), "bfloat16")]


def _bucket_pairs(step):
    rs = onp.random.RandomState(step)
    port, ref = [], []
    for k, (shape, dt) in enumerate(BUCKET_SPECS):
        base = rs.randn(*shape).astype(onp.float32) * (0.5 ** step)
        vals = [base + 0.3 * c for c in range(N)]
        port.append((k, _port(vals, dt)))
        ref.append((k, _ref(vals, dt)))
    return port, ref


@pytest.mark.parametrize("qtype", TYPES)
def test_bucketed_bitwise_the_reference_over_three_steps(qtype):
    """The bucketed reduce (f32 and bf16 groups, a one-key bucket of the
    64K-element tensor) over three steps: values bitwise the reference's,
    and the residuals too, matched by the checkpoint's digest keys."""
    mine, theirs = _stores(qtype)
    for step in range(3):
        port, ref = _bucket_pairs(step)
        mine.pushpull_list(port[::-1])
        theirs.pushpull_list(ref[::-1])
        for (k, a), (_, b) in zip(port, ref):
            _assert_same(a, b, f"{qtype} key {k} step {step}")
        assert mine._bucketer.last_issue_keys == \
            theirs._bucketer.last_issue_keys
        got = mine._bucketer.export_residuals()
        want = theirs._bucketer.export_residuals()
        assert set(got) == set(want)
        for key in got:
            _assert_same([got[key]], [want[key]], f"{qtype} residual {key}")


@pytest.mark.parametrize("qtype", TYPES)
def test_ring_body_equals_its_twin(qtype):
    """Marked copies ride the ring (`_blockwise_body` over the list
    collective), unmarked ones the collective-free twin: bitwise equal
    values and residuals, per key and bucketed."""
    base = onp.random.RandomState(3).randn(1000).astype(onp.float32)
    grads = [base + c for c in range(N)]
    ring, twin = kv.create("tpu_ici"), kv.create("tpu_ici")
    ring.set_gradient_compression(_params(qtype))
    twin.set_gradient_compression(_params(qtype))
    a = _port(grads)
    b = [torch.from_numpy(g.copy()) for g in grads]
    for _ in range(2):
        ring.pushpull(0, a)
        twin.pushpull(0, b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(torch.equal(ring._residuals[(0, c)],
                               twin._residuals[(0, c)]) for c in range(N))
        ring.pushpull_list([(1, a)])
        twin.pushpull_list([(1, b)])
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_nccl_collective_over_a_stand_in_binding(monkeypatch):
    """`_NcclCollective` hands clones to ``torch.cuda.nccl.all_reduce``
    with ncclRedOp_t's SUM (0) and MAX (2), leaving its inputs as they
    were.  With a stand-in binding that reduces in copy order, rounding
    each partial sum to its type as NCCL does, int8's body is bitwise the
    list collective's (its f16 partials are exact integers); fp8's
    residuals are too, and its sums lie within n - 1 bf16 roundings
    (2^-8 each) of the sum of the copies' largest magnitudes."""
    seen = []

    def all_reduce(outs, op=0):
        seen.append(op)
        total = outs[0].clone()
        for t in outs[1:]:
            total = total + t if op == 0 else torch.maximum(total, t)
        for t in outs:
            t.copy_(total)

    monkeypatch.setattr(torch.cuda.nccl, "all_reduce", all_reduce)
    rs = onp.random.RandomState(8)
    gs = [torch.from_numpy(rs.randn(600).astype(onp.float32))
          for _ in range(N)]
    res = [torch.from_numpy(rs.randn(600).astype(onp.float32) * 1e-3)
           for _ in range(N)]
    before = [g.clone() for g in gs]
    peak = sum(float((g + r).abs().max()) for g, r in zip(gs, res))
    for qtype in ("int8", "fp8"):
        got = tpu_ici._blockwise_body(gs, res, qtype, 256,
                                      tpu_ici._NcclCollective)
        want = tpu_ici._blockwise_body(gs, res, qtype, 256,
                                       tpu_ici._ListCollective)
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b), qtype
        for a, b in zip(got[0], want[0]):
            if qtype == "int8":
                assert torch.equal(a, b)
            else:
                assert float((a - b).abs().max()) <= \
                    (N - 1) * 2.0 ** -8 * peak
    assert all(torch.equal(a, b) for a, b in zip(gs, before))
    assert seen == [2, 0, 2, 0]
    _, viol = tpu_ici._integrity_sideband(
        [g.clone() for g in gs[:1] * 2], [0.0, 2.5],
        tpu_ici._NcclCollective)
    assert seen[-1] == 2 and all(bool(v) for v in viol)


def _fp8_oracle(flats, block=256):
    """The reference's oracle for fp8: the shared scale, the fp8 cast,
    an exact f32 sum."""
    n, numel = len(flats), flats[0].size
    nblk = -(-numel // block)
    blocks = onp.concatenate(
        [onp.stack(flats), onp.zeros((n, nblk * block - numel),
                                     onp.float32)], axis=1)
    blocks = blocks.reshape(n, nblk, block)
    gmax = onp.abs(blocks).max(axis=(0, 2))
    scale = onp.where(gmax > 0, gmax / onp.float32(448.0),
                      onp.float32(1.0)).astype(onp.float32)
    q = torch.from_numpy(onp.clip(blocks / scale[None, :, None], -448,
                                  448)).to(torch.float8_e4m3fn).float()
    total = q.numpy().sum(axis=0)
    out = (total * scale[:, None]).reshape(-1)[:numel]
    atol = (n * gmax / 14.0 * 1.05)[onp.repeat(onp.arange(nblk),
                                               block)[:numel]]
    return out, atol


def test_fp8_within_the_oracle_envelope_and_deterministic():
    base = onp.random.RandomState(12).randn(700).astype(onp.float32)
    grads = [base + c for c in range(N)]

    def run():
        store = kv.create("tpu_ici")
        store.set_gradient_compression({"type": "fp8"})
        vals = _port(grads)
        store.pushpull("k", vals)
        return _np(vals[0]), [store._residuals[("k", c)].clone()
                              for c in range(N)]

    got, res1 = run()
    got2, res2 = run()
    assert onp.array_equal(got, got2)
    assert all(torch.equal(a, b) for a, b in zip(res1, res2))
    want, atol = _fp8_oracle(grads)
    assert (onp.abs(got - want) <= atol).all()


def test_int8_bucket_padding_stays_zero():
    """Two keys and zero padding: the tail of the packed residual is
    exactly zero, and the values are the reference's."""
    rs = onp.random.RandomState(13)
    k0, k1 = rs.randn(20).astype(onp.float32), rs.randn(9).astype(
        onp.float32)
    comp = {"type": "int8", "block": 8}
    mine = bucketing.GradBucketer(quantum_bytes=64)
    theirs = ref_bucketing.GradBucketer(quantum_bytes=64)
    port = [(0, _port([k0 + c for c in range(2)])),
            (1, _port([k1 + c for c in range(2)]))]
    ref = [(0, _ref([k0 + c for c in range(2)])),
           (1, _ref([k1 + c for c in range(2)]))]
    mine.pushpull(port, compression=comp)
    theirs.pushpull(ref, compression=comp)
    (sig,) = mine._plans
    assert mine._plans[sig][0].capacity > 29
    for (_, a), (_, b) in zip(port, ref):
        _assert_same(a, b, "int8 padded bucket")
    for j in range(2):
        res = mine._residuals[(sig, 0, j)]
        assert not res[29:].any()


def test_residuals_reset_on_a_change_of_contexts_shape_or_dtype():
    """Stale error feedback is never applied: a bucket plan over other
    contexts starts from zero residuals, and so does a key whose shape or
    dtype changed."""
    b = bucketing.GradBucketer()
    comp = {"threshold": 1.0}
    row = onp.array([2.5, -0.4, 0.1, -3.0], onp.float32)
    first = _port([row] * 2)
    b.pushpull([(0, first)], compression=comp)
    assert _np(first[0]).tolist() == [2.0, 0.0, 0.0, -2.0]
    moved = _port([row] * 2, ctxs=[cpu(2), cpu(3)])
    b.pushpull([(0, moved)], compression=comp)
    assert _np(moved[0]).tolist() == [2.0, 0.0, 0.0, -2.0]
    assert len(b._plans) == 2 and len(b._residuals) == 4

    store = kv.create("tpu_ici")
    store.set_gradient_compression({"type": "2bit", "threshold": 1.0})
    a = _port([row] * 2)
    store.pushpull("g", a)
    assert _np(a[0]).tolist() == [2.0, 0.0, 0.0, -2.0]
    wide = onp.array([2.5, -0.4, 0.1, -3.0, 9.9, 0.0], onp.float32)
    c = _port([wide] * 2)
    store.pushpull("g", c)
    assert _np(c[0]).tolist() == [2.0, 0.0, 0.0, -2.0, 2.0, 0.0]
    e = _port([wide] * 2, dtype="bfloat16")
    store.pushpull("g", e)
    assert _np(e[0]).tolist() == [2.0, 0.0, 0.0, -2.0, 2.0, 0.0]
    # a copy moved to another context resets its own residual only
    kept = store._residuals[("g", 0)].clone()
    f = _port([wide] * 2, dtype="bfloat16", ctxs=[cpu(0), cpu(2)])
    store.pushpull("g", f)
    thr = torch.tensor(1.0, dtype=torch.bfloat16)
    fresh = f[1].new_tensor(wide)       # copy 1 from zero feedback
    lvl0 = torch.where(fresh + kept >= thr, 1, torch.where(
        fresh + kept <= -thr, -1, 0))
    lvl1 = torch.where(fresh >= thr, 1, torch.where(fresh <= -thr, -1, 0))
    assert torch.equal(f[0], (lvl0 + lvl1).to(torch.bfloat16) * thr)


def test_qblock_env_and_block_param(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_QBLOCK", "32")
    mine, theirs = _stores("int8")
    assert mine._compression == theirs._compression == \
        {"type": "int8", "block": 32}
    mine, theirs = _stores("int8", block=16)
    assert mine._compression["block"] == theirs._compression["block"] == 16
    base = onp.random.RandomState(2).randn(100).astype(onp.float32)
    a, b = _port([base, base * 2]), _ref([base, base * 2])
    mine.pushpull(0, a)
    theirs.pushpull(0, b)
    _assert_same(a, b, "block 16")
    assert tpu_ici.qblock_size() == ref_ici.qblock_size() == 32


def test_unsupported_type_message_equals_the_reference():
    with pytest.raises(MXNetError) as mine:
        kv.create("tpu_ici").set_gradient_compression({"type": "1bit"})
    with pytest.raises(mx.MXNetError) as theirs:
        ref_kv.create("tpu_ici").set_gradient_compression({"type": "1bit"})
    assert str(mine.value) == str(theirs.value)
    assert "'2bit'" in str(mine.value) and "'fp8'" in str(mine.value)
    with pytest.raises(ValueError, match="does not support gradient "
                                         "compression"):
        gluon.Trainer(_mlp(2)[0].collect_params(), "sgd",
                      kvstore=kv.LocalKVStore(),
                      compression_params={"type": "int8"}).kvstore


# -- the integrity sideband ---------------------------------------------------

def _ref_digest(values, dtype, monkeypatch):
    """The reference's ``[d, -d]``: `_integrity_sideband` run eagerly
    with its pmax made the identity, the stacked pair captured."""
    import jax
    import jax.numpy as jnp

    seen = []

    def pmax(x, axis):
        seen.append(onp.asarray(x))
        return x

    monkeypatch.setattr(jax.lax, "pmax", pmax)
    ref_ici._integrity_sideband(jnp.asarray(values, dtype=dtype),
                                jnp.zeros((1, 1), jnp.float32))
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("case", ["int32_min", "wraps", "bf16", "normal"])
def test_wrapping_digest_equals_the_reference(case, monkeypatch):
    values, dtype = {
        "int32_min": ([-0.0], "float32"),     # bits 0x80000000
        "wraps": ([1.0, 1.0, 1.0, -0.0], "float32"),
        "bf16": ([1.5, -2.25, 3.0, -0.0, 7.0], "bfloat16"),
        "normal": (onp.random.RandomState(4).randn(1000).tolist(),
                   "float32")}[case]
    t = torch.tensor(values, dtype=getattr(torch, dtype))
    d = tpu_ici._digest(t)
    mine = [int(d), int(tpu_ici._wrap_i32(-d))]
    assert mine == _ref_digest(values, dtype, monkeypatch).tolist()
    # equal copies agree (INT32_MIN's negation wraps onto itself)
    _, viol = tpu_ici._integrity_sideband(
        [t.clone(), t.clone()], [0.0, 0.0], tpu_ici._ListCollective)
    assert not any(bool(v) for v in viol)
    # a flipped copy disagrees; where the clean copy's digest is
    # INT32_MIN, whose negation wraps onto itself, the reference's
    # (max, -min) pair cannot see it, and neither can the port's
    _, viol = tpu_ici._integrity_sideband(
        [t.clone(), t.clone()], [0.0, 3.5], tpu_ici._ListCollective)
    assert all(bool(v) == (case != "int32_min") for v in viol)


@pytest.mark.parametrize("qtype,rank", [(None, 1), (None, None),
                                        ("int8", 2)])
def test_a_planned_bitflip_corrupts_the_same_copy(qtype, rank):
    """With the integrity sideband on, one plan flips the same copy by
    the same magnitude in both packages: every copy's result is bitwise
    the reference's, and both count one violation."""
    base = onp.random.RandomState(9).randn(300).astype(onp.float32)
    grads = [base + c for c in range(N)]
    comp = None if qtype is None else {"type": qtype, "block": 256}
    mine = bucketing.GradBucketer(integrity=True)
    theirs = ref_bucketing.GradBucketer(integrity=True)
    spec = [{"site": "collective.dispatch", "kind": "bitflip", "at": 1,
             "seed": 5, "rank": rank}]
    faultline.plan(spec)
    ref_fl.plan(spec)
    try:
        a, b = _port(grads), _ref(grads)
        mine.pushpull([(0, a), (1, _port(grads))], compression=comp)
        theirs.pushpull([(0, b), (1, _ref(grads))], compression=comp)
    finally:
        faultline.clear()
        ref_fl.clear()
    _assert_same(a, b, f"flipped {qtype}")
    assert sum(not torch.equal(a[0], x) for x in a[1:]) >= 1
    assert mine.consume_integrity() == theirs.consume_integrity() == 1
    assert mine.consume_integrity() == 0


def _mlp(n_ctx=2, seed=0):
    ctxs = [cpu(i) for i in range(n_ctx)]
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=6, activation="relu"),
            nn.Dense(4, in_units=8))
    net.initialize(ctx=ctxs, generator=torch.Generator().manual_seed(seed))
    return net, ctxs


def _ref_mlp(net, n_ctx):
    rctx = [mx.cpu(i) for i in range(n_ctx)]
    ref = ref_nn.HybridSequential()
    ref.add(ref_nn.Dense(8, in_units=6, activation="relu"),
            ref_nn.Dense(4, in_units=8))
    ref.initialize(ctx=rctx)
    for p, r in zip(net.collect_params().values(),
                    ref.collect_params().values()):
        r.set_data(mx.np.array(_np(p.data(cpu(0))).copy()))
    return ref, rctx


def _batch(t, rows=8):
    return onp.random.RandomState(300 + t).randn(rows, 6).astype(onp.float32)


def _step(net, trainer, ctxs, t, rows=8, scale=None):
    """One step of the loop; ``scale`` multiplies the batch and takes the
    sum of squares instead of their mean (gradients large enough for
    2bit levels to fire)."""
    x = _batch(t, rows) * (1.0 if scale is None else scale)
    xs = split_and_load(torch.from_numpy(x), ctxs)
    with autograd.record():
        losses = [(net(xb) ** 2).mean() if scale is None
                  else (net(xb) ** 2).sum() for xb in xs]
    autograd.backward(losses)
    trainer.step(rows)
    return sum(float(l.detach()) for l in losses)


def _ref_step(ref, trainer, rctx, t, rows=8, scale=None):
    x = _batch(t, rows) * (1.0 if scale is None else scale)
    xs = ref_split(mx.np.array(x), rctx)
    with mx.autograd.record():
        losses = [(ref(xb) ** 2).mean() if scale is None
                  else (ref(xb) ** 2).sum() for xb in xs]
    mx.autograd.backward(losses)
    trainer.step(rows)
    return sum(float(l.asnumpy()) for l in losses)


def _weights(net):
    return {k: _np(p.data(cpu(0))).copy()
            for k, p in net.collect_params().items()}


def test_integrity_sideband_trainer_skips_poisoned_step(monkeypatch):
    """The port's version of the reference's sentinel test: four copies,
    a bitflip planned on copy 1 at the second step is caught, the step
    skipped with every copy bitwise as it was, the violations, skipped
    steps and recovered counters each rise by one, and the next clean
    step updates."""
    monkeypatch.setenv("MXNET_KVSTORE_INTEGRITY", "1")
    net, ctxs = _mlp(4)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="tpu_ici")
    reg = telemetry.default_registry()

    def counters():
        return (_sample(reg, "mxtpu_integrity_violations_total",
                        {"site": "collective.dispatch"}),
                _sample(reg, "mxtpu_train_steps_skipped_total"),
                _sample(reg, "mxtpu_faults_recovered_total",
                        {"site": "collective.dispatch", "kind": "bitflip"}))

    def copies():
        return [t.detach().clone() for p in net.collect_params().values()
                for t in p.list_data()]

    _step(net, tr, ctxs, 0)
    before, c0 = copies(), counters()
    faultline.plan([{"site": "collective.dispatch", "kind": "bitflip",
                     "at": 1, "seed": 5, "rank": 1}])
    try:
        _step(net, tr, ctxs, 1)
    finally:
        faultline.clear()
    assert counters() == tuple(c + 1 for c in c0)
    assert tr.skipped_steps == 1
    assert all(torch.equal(a, b) for a, b in zip(copies(), before))
    _step(net, tr, ctxs, 2)
    assert not all(torch.equal(a, b) for a, b in zip(copies(), before))
    assert counters()[:2] == (c0[0] + 1, c0[1] + 1)


@pytest.mark.parametrize("qtype", TYPES)
def test_trainer_trajectory_with_compression_tracks_the_reference(qtype):
    """Three steps of `Trainer(compression_params=...)` over two copies
    in both packages, the reference's weights from the port's: the copies
    stay bitwise equal, the losses and the weights agree within 1e-6
    (the module's docstring)."""
    net, ctxs = _mlp(2, seed=4)
    start = _weights(net)
    ref, rctx = _ref_mlp(net, 2)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    comp = _params(qtype, **({"threshold": 0.1} if qtype == "2bit"
                             else {}))
    tr = gluon.Trainer(net.collect_params(), "sgd", opt, kvstore="tpu_ici",
                       compression_params=comp)
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd", opt,
                           kvstore="tpu_ici", compression_params=comp)
    for t in range(3):
        loss = _step(net, tr, ctxs, t, scale=3.0)
        ref_loss = _ref_step(ref, rtr, rctx, t, scale=3.0)
        assert abs(loss - ref_loss) <= 1e-6 * max(1.0, abs(ref_loss))
    for p in net.collect_params().values():
        a, b = p.list_data()
        assert torch.equal(a, b)
    # the quantized updates moved every layer's weight
    assert all(not onp.array_equal(w, start[k]) for k, w in
               _weights(net).items() if k.endswith("weight"))
    for (k, w), r in zip(_weights(net).items(),
                         ref.collect_params().values()):
        onp.testing.assert_allclose(w, r.data().asnumpy(), rtol=0,
                                    atol=1e-6, err_msg=f"{qtype} {k}")


# -- residuals through a checkpoint ---------------------------------------------

@pytest.mark.parametrize("qtype", TYPES)
def test_kv_residuals_checkpoint_round_trip(qtype):
    """``kvres/``: a store's per-key residuals, gathered with a trainer
    over copies and restored into another store, continue the compressed
    reduce bitwise."""
    def vals():
        base = onp.random.RandomState(29).randn(300).astype(onp.float32)
        return _port([base * (1.0 + c) for c in range(2)])

    def store():
        s = kv.create("tpu_ici")
        s.set_gradient_compression(_params(qtype, threshold=1.0)
                                   if qtype == "2bit" else _params(qtype))
        return s

    kv1 = store()
    kv1.pushpull(0, vals())
    net, ctxs = _mlp(2)
    tr = gluon.Trainer(net.collect_params(), "sgd", kvstore="tpu_ici")
    _step(net, tr, ctxs, 0)
    tr._kvstore = kv1
    arrays, meta = ckpt.gather_training_state(tr, step=1)
    assert {k for k in arrays if k.startswith("kvres/")} == \
        {"kvres/0/0", "kvres/0/1"}
    net2, ctxs2 = _mlp(2)
    tr2 = gluon.Trainer(net2.collect_params(), "sgd", kvstore="tpu_ici")
    _step(net2, tr2, ctxs2, 0)
    kv2 = tr2._kvstore = store()
    ckpt.restore_training_state(arrays, meta, tr2)
    assert set(kv2._residuals) == set(kv1._residuals)
    for k in kv1._residuals:
        assert torch.equal(kv2._residuals[k], kv1._residuals[k])
    a1, a2 = vals(), vals()
    kv1.pushpull(0, a1)
    kv2.pushpull(0, a2)
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))


@pytest.mark.parametrize("qtype", TYPES)
def test_bucketer_residual_export_import_round_trip(qtype):
    def pairs():
        rs = onp.random.RandomState(31)
        return [(k, _port([rs.randn(*shape).astype(onp.float32) + k + c
                           for c in range(2)]))
                for k, shape in enumerate([(40,), (5, 8), (64, 40)])]

    comp = _params(qtype, **({} if qtype == "2bit" else {"block": 16}))
    b_cont, b_orig = bucketing.GradBucketer(bucket_bytes=2048), \
        bucketing.GradBucketer(bucket_bytes=2048)
    b_cont.pushpull(pairs(), compression=comp)
    b_orig.pushpull(pairs(), compression=comp)
    exported = {k: v.clone() for k, v in b_orig.export_residuals().items()}
    assert len(exported) == 4     # two buckets (one of one 2-D key) x 2
    b_rest = bucketing.GradBucketer(bucket_bytes=2048)
    b_rest.import_residuals(exported)
    p_cont, p_rest = pairs(), pairs()
    b_cont.pushpull(p_cont, compression=comp)
    b_rest.pushpull(p_rest, compression=comp)
    for (_, vc), (_, vr) in zip(p_cont, p_rest):
        assert all(torch.equal(x, y) for x, y in zip(vc, vr))


def test_one_key_2bit_bucket_resumes_where_the_reference_drops():
    """ROADMAP C15: the reference saves a one-key 2bit bucket's residual
    flat and compares shapes at adoption, so a tensor of two or more
    dimensions restarts from zero error feedback there; the port adopts
    it by element count and resumes bitwise."""
    def vals(port):
        rs = onp.random.RandomState(37)
        base = rs.randn(4, 6).astype(onp.float32)
        arrs = [base * 0.6 + c * 0.1 for c in range(2)]
        return [(0, _port(arrs) if port else _ref(arrs))]

    comp = {"threshold": 1.0}
    for port, make in ((True, bucketing.GradBucketer),
                       (False, ref_bucketing.GradBucketer)):
        cont, orig, rest = make(), make(), make()
        cont.pushpull(vals(port), compression=comp)
        orig.pushpull(vals(port), compression=comp)
        rest.import_residuals(orig.export_residuals())
        a, b = vals(port), vals(port)
        cont.pushpull(a, compression=comp)
        rest.pushpull(b, compression=comp)
        same = all(onp.array_equal(_np(x) if port else x.asnumpy(),
                                   _np(y) if port else y.asnumpy())
                   for x, y in zip(a[0][1], b[0][1]))
        assert same == port


def _build(seed, comp):
    net, ctxs = _mlp(2, seed=seed)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       kvstore="tpu_ici", compression_params=comp)
    return net, tr, ctxs


def test_quantized_resume_parity_after_injected_preemption(tmp_path):
    """The reference's fence through the int8 bucketed path: preempted
    inside step 3's first bucket, restored into a fresh trainer before
    its first step (the restore makes the store and its bucketer), the
    three steps equal the fault-free run bitwise."""
    comp = {"type": "int8", "block": 64}
    net_a, tr_a, ctxs = _build(11, comp)
    for t in range(3):
        _step(net_a, tr_a, ctxs, t, rows=4)
    want = _weights(net_a)

    net_b, tr_b, _ = _build(11, comp)
    for t in range(2):
        _step(net_b, tr_b, ctxs, t, rows=4)
    mgr = ckpt.CheckpointManager(tmp_path / "ckpt", async_write=False,
                                 rank=0)
    arrays, meta = ckpt.gather_training_state(tr_b, step=2)
    assert any(k.startswith("bucketres/") for k in arrays)
    assert meta["world"]["copies"] == 2
    mgr.save(2, arrays, meta)
    faultline.plan([{"site": "collective.dispatch", "kind": "preempt",
                     "at": 1}])
    try:
        with pytest.raises(faultline.InjectedPreemption):
            _step(net_b, tr_b, ctxs, 2, rows=4)
    finally:
        faultline.clear()

    net_c, tr_c, _ = _build(77, comp)
    assert tr_c._kvstore is None
    step, arrays_r, meta_r = mgr.restore_latest()
    assert ckpt.restore_training_state(arrays_r, meta_r, tr_c) == step == 2
    assert tr_c._kvstore._bucketer is not None
    _step(net_c, tr_c, ctxs, 2, rows=4)
    got = _weights(net_c)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    mgr.close()


def _explicit_grads(seed):
    """The trainer's two copies' next gradients, the same in both
    packages: (key, [copy arrays]) in reverse registration order."""
    rs = onp.random.RandomState(seed)
    shapes = [(8, 6), (8,), (4, 8), (4,)]
    return [(k, [rs.randn(*shapes[k]).astype(onp.float32) * 0.3 + c
                 for c in range(2)]) for k in (3, 2, 1, 0)]


def test_checkpoints_cross_the_packages_with_their_residuals(tmp_path):
    """int8 over two copies: a checkpoint holding ``kvres/`` and
    ``bucketres/`` written by the reference restores in the port, and the
    port's in the reference, bitwise (params, every copy's states,
    residuals); the next compressed reduce of the same gradients is then
    bitwise equal in both packages."""
    comp = {"type": "int8", "block": 64}
    net, tr, ctxs = _build(5, comp)
    ref, rctx = _ref_mlp(net, 2)
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore="tpu_ici", compression_params=comp)
    for t in range(2):
        _step(net, tr, ctxs, t, rows=4)
        _ref_step(ref, rtr, rctx, t, rows=4)
    # a per-key reduce of parameter 0's shape leaves kvres/0/{0,1} too
    g0 = [onp.full((8, 6), 0.37 * (c + 1), onp.float32) for c in range(2)]
    tr.kvstore.pushpull(0, _port(g0))
    rtr.kvstore.pushpull(0, _ref(g0))

    for writer in ("reference", "port"):
        root = tmp_path / writer
        if writer == "reference":
            ref_ckpt.save_checkpoint(str(root), 2,
                                     *ref_ckpt.gather_training_state(rtr, 2),
                                     rank=0)
            _, arrays, meta = ckpt.load_checkpoint(str(root), rank=0)
            fresh, dst, _ = _build(99, comp)
            ckpt.restore_training_state(arrays, meta, dst)
            got_arrays, _ = ckpt.gather_training_state(dst, 2)
        else:
            ckpt.save_checkpoint(str(root), 2,
                                 *ckpt.gather_training_state(tr, 2),
                                 rank=0)
            _, arrays, meta = ref_ckpt.load_checkpoint(str(root), rank=0)
            fresh, _ = _ref_mlp(_mlp(2, seed=99)[0], 2)
            dst = mx.gluon.Trainer(fresh.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9},
                                   kvstore="tpu_ici",
                                   compression_params=comp)
            ref_ckpt.restore_training_state(arrays, meta, dst)
            got_arrays, _ = ref_ckpt.gather_training_state(dst, 2)
        assert any(k.startswith("kvres/") for k in arrays)
        assert any(k.startswith("bucketres/") for k in arrays)
        for name, a in arrays.items():
            if name.startswith(("param/", "opt/", "kvres/")):
                assert onp.asarray(got_arrays[name]).tobytes() == \
                    onp.asarray(a).tobytes(), (writer, name)
    # the reference restored from the port's checkpoint and the port's
    # trainer: the same explicit gradients, the same reduce
    grads = _explicit_grads(41)
    mine = [(k, _port(v)) for k, v in grads]
    theirs = [(k, _ref(v)) for k, v in grads]
    tr.kvstore.pushpull_list(mine)
    dst.kvstore.pushpull_list(theirs)
    for (k, a), (_, b) in zip(mine, theirs):
        _assert_same(a, b, f"after the crossing, key {k}")
    p0, r0 = _port(g0), _ref(g0)
    tr.kvstore.pushpull(0, p0)
    dst.kvstore.pushpull(0, r0)
    _assert_same(p0, r0, "kvres/ after the crossing")
