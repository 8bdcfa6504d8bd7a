"""Data parallelism in one process: the port's parameter copies, contexts
and ``train_imagenet.py``'s loop against the JAX package's.

The port keeps one copy of each parameter on every context of
``initialize(ctx=[...])``; here the contexts are ``cpu(0)``, ``cpu(1)``
... (host contexts over one memory), the reference's its virtual CPU
devices.  Covered: the copies' identity and errors (``data(ctx)``,
``grad(ctx)``, ``list_*``, ``reset_ctx``, ``set_data``, ``cast``,
``zero_grad``, ``grad_req`` per copy, deferred shapes), the context a
block's call enters (`split_and_load`'s marks, an unmarked tensor,
`context_scope`, hybridized blocks), `load_reference_params`,
``save_parameters`` / ``load_parameters``, the refusals that name
A7b / A7d, and the slice as a whole: ``resnet18_v1(classes=10)`` on two
copies through two steps of ``train_imagenet.py``'s loop (SGD, lr 0.1,
momentum 0.9, ``kvstore="tpu_ici"``, the port hybridized as the example
does) in both packages.

The slice runs at 64 x 64, batch 4 (two images a copy).  At 32 x 32
the last stage is 1 x 1, and its BatchNorms normalize 2-4 values a
channel: there one train-mode forward of a single copy already differs
by 1.5 % between the packages at batch 2 and 2e-5 at batch 4, and two
SGD steps of a single copy by 27 % of a weight, so the rounding of
either side, not the port, would decide the comparison.  At 64 x 64
they normalize 8 values, and the first step's losses agree within 1e-5.

Tolerances: the losses of step 1 at rtol 1e-5 and of step 2 at 1e-4;
every parameter and each copy's BatchNorm running statistics after one
step within atol 2e-4 of the reference's copy, after two within 2e-3
(the second step amplifies the first step's f32 differences through
those BatchNorms: 5.6e-4 at most on this seed).  The port's copies of a
trainable parameter stay bitwise equal; the running statistics of the
two copies differ, each updated from its own slice.

The reference's hybridized block does not enter its input's context
(ROADMAP queue C, C11), so its forward runs under ``with ctx:`` here;
its values are set from numpy copies (its CPU arrays may share a numpy
buffer with the port's tensors).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
from mxnet_tpu.gluon.utils import split_and_load as ref_split
from mxnet_tpu_torch import MXNetError, autograd, cpu, gluon, initializer
from mxnet_tpu_torch.context import (context_scope, current_context,
                                     tensor_context)
from mxnet_tpu_torch.gluon import FusedTrainStep, nn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.utils import clip_global_norm, split_and_load
from mxnet_tpu_torch.resilience import checkpoint
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

CTXS = [cpu(0), cpu(1)]
RCTX = [mx.cpu(0), mx.cpu(1)]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _dense(n=4, units=3, in_units=4, **kw):
    net = nn.Dense(units, in_units=in_units, **kw)
    net.initialize(ctx=[cpu(i) for i in range(n)], generator=_gen())
    return net


# -- Parameter copies ---------------------------------------------------------

def test_copies_start_equal_in_context_order():
    net = _dense()
    w = net.weight
    ctxs = [cpu(i) for i in range(4)]
    assert w.list_ctx() == ctxs
    copies = w.list_data()
    assert len(copies) == 4 and len({id(c) for c in copies}) == 4
    assert all(torch.equal(copies[0], c) for c in copies[1:])
    assert all(c.requires_grad and c.is_leaf for c in copies)
    for ctx, copy in zip(ctxs, copies):
        assert w.data(ctx) is copy
        with context_scope(ctx):
            assert w.data() is copy and current_context() == ctx
    assert w.data("cpu:0") is copies[0]
    assert current_context().type == "cuda"       # the default, outside


def test_missing_context_errors_match_the_reference():
    net = _dense(2)
    ref = ref_nn.Dense(3, in_units=4)
    ref.initialize(ctx=RCTX)
    with pytest.raises(RuntimeError, match="was not initialized on"):
        net.weight.data(cpu(3))
    with pytest.raises(RuntimeError, match="was not initialized on"):
        ref.weight.data(mx.cpu(3))
    with pytest.raises(KeyError):
        net.weight.grad(cpu(3))
    with pytest.raises(KeyError):
        ref.weight.grad(mx.cpu(3))
    # several copies and no context: the current one, which the default
    # (the card) is not
    with pytest.raises(RuntimeError, match="was not initialized on"):
        net.weight.data()
    single = _dense(1)
    assert single.weight.data() is single.weight.data(cpu(0))
    with pytest.raises(RuntimeError, match="was not initialized on"):
        single.weight.data(cpu(1))
    nograd = gluon.Parameter("w", shape=(2,), grad_req="null")
    nograd.initialize(ctx=CTXS)
    assert nograd.list_grad() == []
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        nograd.grad(cpu(1))


def test_reset_ctx_matches_the_reference():
    """Contexts already held keep their copy's values, new ones take the
    first copy's, dropped ones go, in both packages."""
    net = _dense(2)
    ref = ref_nn.Dense(3, in_units=4)
    ref.initialize(ctx=RCTX)
    base = net.weight.data(cpu(0)).detach().numpy().copy()
    ref.weight.set_data(mx.np.array(base.copy()))
    with torch.no_grad():
        net.weight.data(cpu(1)).add_(1.0)
    ref.weight.data(mx.cpu(1))._rebind(
        ref.weight.data(mx.cpu(1))._data + 1.0)
    gen = net.weight.generation
    net.weight.reset_ctx([cpu(1), cpu(2)])
    ref.weight.reset_ctx([mx.cpu(1), mx.cpu(2)])
    assert net.weight.list_ctx() == [cpu(1), cpu(2)]
    assert net.weight.generation != gen
    for mine, theirs in zip(net.weight.list_data(),
                            ref.weight.list_data()):
        onp.testing.assert_array_equal(mine.detach().numpy(),
                                       theirs.asnumpy())
    onp.testing.assert_array_equal(
        net.weight.data(cpu(1)).detach().numpy(), base + 1)
    onp.testing.assert_array_equal(
        net.weight.data(cpu(2)).detach().numpy(), base)
    # back to one context: the parameter behaves as a single copy
    net.weight.reset_ctx(cpu(0))
    assert net.weight.list_ctx() == [cpu(0)]
    assert len(net.weight.list_data()) == 1


def test_set_data_cast_zero_grad_over_copies():
    net = _dense(3)
    value = onp.arange(12, dtype=onp.float32).reshape(3, 4)
    net.weight.set_data(value)
    for copy in net.weight.list_data():
        onp.testing.assert_array_equal(copy.detach().numpy(), value)
        assert copy.requires_grad
    net.cast("bfloat16")
    assert all(c.dtype == torch.bfloat16 for c in net.weight.list_data())
    net.cast("float32")
    for g in net.weight.list_grad():
        g.fill_(1.0)
    net.weight.zero_grad()
    assert all(float(g.abs().sum()) == 0 for g in net.weight.list_grad())
    with pytest.raises(ValueError, match="shape"):
        net.weight.set_data(onp.zeros((2, 2), onp.float32))


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_holds_per_copy(req):
    """Each copy is its own leaf: ``'write'`` replaces that copy's
    gradient at each backward, ``'add'`` sums them, copy by copy."""
    net = _dense(2, units=1, in_units=2, use_bias=False)
    net.weight.grad_req = req
    net.weight.set_data(onp.ones((1, 2), onp.float32))
    xs = split_and_load(onp.asarray([[1, 2], [3, 5]], onp.float32), CTXS)
    for _ in range(2):
        with autograd.record():
            ls = [net(x).sum() for x in xs]
        autograd.backward(ls)
    times = 1 if req == "write" else 2
    onp.testing.assert_array_equal(net.weight.grad(cpu(0)).numpy(),
                                   [[times * 1, times * 2]])
    onp.testing.assert_array_equal(net.weight.grad(cpu(1)).numpy(),
                                   [[times * 3, times * 5]])


def test_deferred_shapes_draw_once_for_every_copy():
    net = nn.Dense(3)
    net.initialize(ctx=CTXS, generator=_gen(3))
    assert net.weight.list_ctx() == CTXS
    x = split_and_load(onp.ones((4, 5), onp.float32), CTXS)
    net(x[1])                                   # the first forward: copy 1
    assert net.weight.shape == (3, 5)
    a, b = net.weight.list_data()
    assert torch.equal(a, b)
    again = nn.Dense(3, in_units=5)
    again.initialize(ctx=cpu(), generator=_gen(3))
    assert torch.equal(again.weight.data(), a)  # the same draw


# -- the context a call enters ------------------------------------------------

def _distinct_copies():
    net = _dense(2, units=1, in_units=2, use_bias=False)
    net.weight.set_data(onp.ones((1, 2), onp.float32))
    with torch.no_grad():
        net.weight.data(cpu(1)).mul_(10)
    return net


def test_split_and_load_marks_and_blocks_follow():
    net = _distinct_copies()
    data = onp.asarray([[1, 1], [2, 2]], onp.float32)
    xs = split_and_load(data, CTXS)
    assert [tensor_context(x) for x in xs] == CTXS
    assert float(net(xs[0])) == 2.0 and float(net(xs[1])) == 40.0
    out = net(xs[1])
    assert tensor_context(out) == cpu(1)        # carried on to the loss
    # an unmarked CPU tensor outside any scope is cpu(0)'s; inside a CPU
    # scope it keeps that context
    plain = torch.from_numpy(data[1:])
    assert tensor_context(plain) is None
    assert float(net(plain)) == 4.0
    with context_scope(cpu(1)):
        assert float(net(plain)) == 40.0
    seq = nn.HybridSequential()
    seq.add(nn.Dense(2, in_units=2, use_bias=False), net)
    seq[0].initialize(ctx=CTXS, generator=_gen())
    seq[0].weight.set_data(onp.eye(2, dtype=onp.float32))
    seq.hybridize()
    assert float(seq(xs[0])) == 2.0 and float(seq(xs[1])) == 40.0
    one = split_and_load(data, [cpu()])
    assert len(one) == 1 and tensor_context(one[0]) is None


def test_clip_global_norm_keeps_its_list_contract():
    grads = [torch.full((2,), 3.0), torch.full((1,), 4.0)]
    norm = clip_global_norm(grads, 1.0)
    assert abs(norm - 34 ** 0.5) < 1e-5
    assert abs(float(torch.sqrt(sum((g * g).sum() for g in grads))) - 1) \
        < 1e-5


def test_reference_params_and_files_reach_every_copy(tmp_path):
    ref = ref_nn.Dense(3, in_units=4)
    ref.initialize()
    values = {k: p.data().asnumpy().copy()
              for k, p in ref.collect_params().items()}
    net = nn.Dense(3)                            # deferred: takes the shape
    net.initialize(ctx=CTXS, generator=_gen())
    load_reference_params(net, values)
    for k, p in net.collect_params().items():
        assert p.list_ctx() == CTXS
        for copy in p.list_data():
            onp.testing.assert_array_equal(copy.detach().numpy(), values[k])
    net.save_parameters(str(tmp_path / "dense.npz"))
    back = nn.Dense(3, in_units=4)
    back.initialize(ctx=[cpu(0), cpu(1), cpu(2)], generator=_gen(9))
    back.load_parameters(str(tmp_path / "dense.npz"))
    for copy in back.weight.list_data():
        onp.testing.assert_array_equal(copy.detach().numpy(),
                                       values["weight"])
    moved = nn.Dense(3, in_units=4)
    moved.initialize(ctx=cpu(), generator=_gen())
    moved.load_parameters(str(tmp_path / "dense.npz"), ctx=CTXS)
    assert moved.weight.list_ctx() == CTXS


def test_copies_refusals_name_their_queue_items():
    net = _dense(2)
    trainer = gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(NotImplementedError, match="A7b"):
        FusedTrainStep(net, trainer)(torch.ones(2, 4), batch_size=2)
    # a training state over copies restores only into the same copies;
    # another world is the reshard (A7d)
    arrays, meta = checkpoint.gather_training_state(trainer, 0)
    assert meta["world"]["copies"] == 2
    other = gluon.Trainer(_dense(4).collect_params(), "sgd")
    with pytest.raises(checkpoint.CheckpointTopologyError, match="A7d"):
        checkpoint.restore_training_state(arrays, meta, other)
    with pytest.raises(NotImplementedError, match="A7d"):
        checkpoint.restore_training_state(arrays, meta, trainer,
                                          reshard=True)
    with pytest.raises(MXNetError, match="A7b"):
        from mxnet_tpu_torch.context import resolve_device
        resolve_device(CTXS)


# -- the slice: train_imagenet.py's loop over two copies ----------------------

def _loop_step(net, loss_fn, trainer, ctxs, X, Y):
    xs, ys = split_and_load(X, ctxs), split_and_load(Y, ctxs)
    with autograd.record():
        losses = [loss_fn(net(xb), yb).mean() for xb, yb in zip(xs, ys)]
    autograd.backward(losses)
    trainer.step(X.shape[0])
    return [float(l.detach()) for l in losses]


def _ref_loop_step(ref, loss_fn, trainer, rctx, X, Y):
    xs, ys = ref_split(mx.np.array(X), rctx), ref_split(mx.np.array(Y), rctx)
    losses = []
    with mx.autograd.record():
        for ctx, xb, yb in zip(rctx, xs, ys):
            with ctx:                            # C11: see the docstring
                losses.append(loss_fn(ref(xb), yb).mean())
    mx.autograd.backward(losses)
    values = [float(l.asnumpy()) for l in losses]
    trainer.step(X.shape[0])
    return values


def test_resnet18_two_copies_matches_reference():
    rng = onp.random.default_rng(0)
    X = rng.uniform(-1, 1, (4, 3, 64, 64)).astype(onp.float32)
    Y = rng.integers(0, 10, (4,)).astype(onp.int32)
    net = vision.resnet18_v1(classes=10)
    net.initialize(init=initializer.Xavier(), ctx=CTXS, generator=_gen())
    with torch.no_grad(), autograd.predict_mode():
        net(split_and_load(X, CTXS)[0])           # settle the shapes
    ref = ref_vision.resnet18_v1(classes=10)
    ref.initialize(init=mx.init.Zero(), ctx=RCTX)
    ref.load_dict({k: mx.np.array(p.data(cpu(0)).detach().numpy().copy())
                   for k, p in net.collect_params().items()})
    net.hybridize(static_alloc=True)
    ref.hybridize(static_alloc=True)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    trainer = gluon.Trainer(net.collect_params(), "sgd", opt,
                            kvstore="tpu_ici")
    rtrainer = mx.gluon.Trainer(ref.collect_params(), "sgd", opt,
                                kvstore="tpu_ici")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    ref_loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ref_params = ref.collect_params()
    for step, (rtol, atol) in enumerate([(1e-5, 2e-4), (1e-4, 2e-3)]):
        mine = _loop_step(net, loss_fn, trainer, CTXS, X, Y)
        theirs = _ref_loop_step(ref, ref_loss_fn, rtrainer, RCTX, X, Y)
        assert all(onp.isfinite(mine))
        onp.testing.assert_allclose(mine, theirs, rtol=rtol)
        for k, p in net.collect_params().items():
            copies = [c.detach().numpy() for c in p.list_data()]
            if p.grad_req != "null":
                onp.testing.assert_array_equal(copies[0], copies[1],
                                               err_msg=k)
            for c, r in zip(copies, ref_params[k].list_data()):
                onp.testing.assert_allclose(c, r.asnumpy(), rtol=0,
                                            atol=atol, err_msg=k)
    assert trainer.kvstore.type == "tpu_ici"
    stats = net.collect_params()["features.1.running_mean"].list_data()
    assert not torch.equal(stats[0], stats[1])  # each from its own slice
