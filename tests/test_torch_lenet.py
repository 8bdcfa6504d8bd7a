"""BASELINE config 1 on the CPU: the Gluon LeNet of
`benchmark/lenet_mnist_bench.py` and the MLP of
`examples/gluon/mnist_mlp.py`, built as written (no ``in_units``
anywhere), against the JAX package's.

Both nets get the same random parameter values (the port settles the
deferred shapes, the values go into the reference and come back into a
fresh port net through `load_reference_params`), then five SGD steps on
one seeded batch, through `FusedTrainStep` in both packages (LeNet:
lr 0.1, momentum 0.9, the bench's mean loss; the MLP: lr 0.1) and,
for the MLP, through the example's eager loop (``hybridize()``,
``record``/``backward``/``Trainer.step`` and ``metric.Accuracy``): the
loss trajectory, the final parameters and the accuracy.  Also the
callbacks that `train_imagenet.py` and the fit loops call.

Tolerance: f32 with true f32 products on both sides, summed in other
orders, over five steps: losses at atol = rtol = 1e-5, parameters at
atol = 1e-5 x (1 + max |parameter|).
"""
import logging
from collections import namedtuple

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import callback as ref_callback
from mxnet_tpu.gluon import FusedTrainStep as RefFusedTrainStep
from mxnet_tpu.gluon import nn as ref_nn
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd, callback, cpu
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer, nn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.metric import Accuracy
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

STEPS, B = 5, 8


def lenet(lib):
    net = lib.HybridSequential()
    net.add(lib.Conv2D(20, kernel_size=5, activation="tanh"),
            lib.MaxPool2D(pool_size=2, strides=2),
            lib.Conv2D(50, kernel_size=5, activation="tanh"),
            lib.MaxPool2D(pool_size=2, strides=2),
            lib.Flatten(),
            lib.Dense(500, activation="tanh"),
            lib.Dense(10))
    return net


def mlp(lib):
    net = lib.HybridSequential()
    net.add(lib.Dense(128, activation="relu"),
            lib.Dense(64, activation="relu"),
            lib.Dense(10))
    return net


def with_loss(base, net, loss_fn, mean):
    class WithLoss(base):
        def __init__(self):
            super().__init__()
            self.m = net
            self.loss = loss_fn()

        def forward(self, x, y):
            out = self.loss(self.m(x), y)
            return out.mean() if mean else out
    return WithLoss()


def _pair(build, x):
    """(reference net, port net) with equal random parameters."""
    rng = onp.random.default_rng(2)
    shaper = build(nn)
    shaper.initialize(ctx=cpu())
    shaper(torch.from_numpy(x))
    values = {}
    for k, p in shaper.collect_params().items():
        fan_in = int(onp.prod(p.shape[1:])) if len(p.shape) > 1 else 100
        values[k] = (rng.standard_normal(p.shape) /
                     onp.sqrt(fan_in)).astype(onp.float32)
    ref = build(ref_nn)
    ref.initialize()
    ref.load_dict({k: mx.np.array(v) for k, v in values.items()})
    net = build(nn)
    net.initialize(init=mxt.init.Xavier(), ctx=[cpu()])
    load_reference_params(net, {k: p.data().asnumpy()
                                for k, p in ref.collect_params().items()})
    assert all(p.shape[-1] > 0 for p in net.collect_params().values())
    return ref, net


def _check_params(ref, net):
    ref_params = ref.collect_params()
    for k, p in net.collect_params().items():
        expect = ref_params[k].data().asnumpy()
        onp.testing.assert_allclose(
            p.data().detach().numpy(), expect,
            atol=1e-5 * (1 + onp.abs(expect).max()), rtol=0, err_msg=k)


@pytest.mark.parametrize("which", ["lenet", "mlp"])
def test_fused_sgd_trajectory_matches_reference(which):
    rng = onp.random.default_rng(9)
    shape = (B, 1, 28, 28) if which == "lenet" else (B, 784)
    x = rng.uniform(0, 1, shape).astype(onp.float32)
    y = rng.integers(0, 10, (B,)).astype(onp.int32)
    build = lenet if which == "lenet" else mlp
    opt = {"learning_rate": 0.1, "momentum": 0.9} if which == "lenet" \
        else {"learning_rate": 0.1}
    ref, net = _pair(build, x)
    ref_mod = with_loss(mx.gluon.HybridBlock, ref,
                        mx.gluon.loss.SoftmaxCrossEntropyLoss,
                        mean=which == "lenet")
    ref_step = RefFusedTrainStep(ref_mod, mx.gluon.Trainer(
        ref.collect_params(), "sgd", opt))
    mod = with_loss(HybridBlock, net, SoftmaxCrossEntropyLoss,
                    mean=which == "lenet")
    step = FusedTrainStep(mod, Trainer(net.collect_params(), "sgd", opt))
    expect, got = [], []
    for _ in range(STEPS):
        expect.append(float(ref_step(mx.np.array(x), mx.np.array(y),
                                     batch_size=B).asnumpy().mean()))
        got.append(float(step(torch.from_numpy(x), torch.from_numpy(y),
                              batch_size=B).mean()))
    onp.testing.assert_allclose(got, expect, atol=1e-5, rtol=1e-5)
    assert got[-1] < got[0]
    _check_params(ref, net)
    if which == "lenet":
        assert net[5].weight.shape == (500, 800)


def test_mnist_mlp_eager_loop_matches_reference():
    """The example's loop: hybridized MLP, ``Trainer`` with SGD,
    SoftmaxCrossEntropyLoss on f32 labels, ``metric.Accuracy``.  The
    per-sample loss vector is backed by ``autograd.backward(loss)``: the
    port's losses are torch tensors, whose ``backward()`` takes a scalar
    (``NDArray``'s implicit sum is ROADMAP queue A item A10)."""
    rng = onp.random.default_rng(4)
    xs = rng.uniform(0, 1, (STEPS, B, 784)).astype(onp.float32)
    w = rng.standard_normal((784, 10)).astype(onp.float32)
    ys = (xs @ w).argmax(-1).astype(onp.float32)
    ref, net = _pair(mlp, xs[0])
    ref.hybridize()
    net.hybridize()
    ref_tr = mx.gluon.Trainer(ref.collect_params(), "sgd",
                              {"learning_rate": 0.1})
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    ref_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn = SoftmaxCrossEntropyLoss()
    ref_metric, acc = mx.gluon.metric.Accuracy(), Accuracy()
    for x, y in zip(xs, ys):
        with mx.autograd.record():
            out_r = ref(mx.np.array(x))
            loss_r = ref_fn(out_r, mx.np.array(y))
        loss_r.backward()
        ref_tr.step(B)
        ref_metric.update(mx.np.array(y), out_r)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        with autograd.record():
            out = net(xt)
            loss = loss_fn(out, yt)
        autograd.backward(loss)
        trainer.step(B)
        acc.update(yt, out)
        onp.testing.assert_allclose(loss.detach().numpy(), loss_r.asnumpy(),
                                    atol=1e-5, rtol=1e-5)
    _check_params(ref, net)
    assert acc.get() == ref_metric.get()


P = namedtuple("P", ["epoch", "nbatch", "eval_metric"])


def _log_of(make, calls, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        cb = make()
        for p in calls:
            cb(p)
    return [r.getMessage() for r in caplog.records]


def test_callbacks_log_as_the_reference(caplog, monkeypatch):
    """Speedometer (with the clock fixed, so both log the same speed),
    ProgressBar and log_train_metric write the reference's lines."""
    import time as _time
    monkeypatch.setattr(_time, "time", lambda: 100.0)

    def metric_pair():
        r, m = mx.gluon.metric.Accuracy(), Accuracy()
        r.update([onp.array([1, 0])], [onp.array([[0.2, 0.8], [0.1, 0.9]])])
        m.update([torch.tensor([1, 0])],
                 [torch.tensor([[0.2, 0.8], [0.1, 0.9]])])
        return r, m
    r_metric, m_metric = metric_pair()
    for make_ref, make_mine, with_metric in [
            (lambda: ref_callback.Speedometer(16, frequent=2),
             lambda: callback.Speedometer(16, frequent=2), False),
            (lambda: ref_callback.Speedometer(16, frequent=2),
             lambda: callback.Speedometer(16, frequent=2), True),
            (lambda: ref_callback.ProgressBar(5, length=10),
             lambda: callback.ProgressBar(5, length=10), False),
            (lambda: ref_callback.log_train_metric(2),
             lambda: callback.log_train_metric(2), True)]:
        theirs = _log_of(make_ref, [P(0, i, r_metric if with_metric
                                      else None) for i in range(5)], caplog)
        mine = _log_of(make_mine, [P(0, i, m_metric if with_metric
                                     else None) for i in range(5)], caplog)
        assert mine == theirs and (mine or not with_metric)
    with pytest.raises(NotImplementedError, match="A10"):
        callback.do_checkpoint("prefix")
