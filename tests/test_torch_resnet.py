"""The port's ResNet training path against the JAX package's.

A narrow ResNet-50-style net, ``ResNetV1(BottleneckV1, [1, 1, 1, 1],
[8, 16, 32, 64, 128], classes=10)``, is built in both packages from the
same weights (the JAX model's, carried across with
`load_reference_params`, running statistics included) and run on the
same seeded numpy batch of (2, 3, 64, 64) images on the CPU.  Compared:
parameter names and shapes, logits in predict and train mode, one
backward's gradients and the running statistics that forward leaves,
and three SGD-momentum steps through `FusedTrainStep` and through the
eager ``record`` / ``backward`` / ``Trainer.step`` path (losses, weights
and running statistics).  Beside them: the loss, ``SGD.update_math``
and the non-finite step guard.  The model zoo's other checks are in
`test_torch_model_zoo.py`.

Tolerances (f32 throughout; true f32 products on both sides, which sum
in other orders):
- logits and losses: values of order 1 through 17 layers with 18 batch
  normalizations on the way: atol = rtol = 1e-4.  Train-mode
  BatchNorm over a 2-image batch divides by the batch's deviation,
  which at the 2x2 stage (8 values a channel) magnifies rounding
  differences: some 1e-5 of the values at the last stage, 3e-5 in the
  logits (at 32x32 input the last stage is 1x1, 2 values a channel, and
  the logits differ by 2e-3, which is why the input is 64x64).
- gradients: atol 1e-4 x the largest magnitude of that parameter's
  reference gradient, rtol 1e-3.
- running statistics: means and variances of those activations:
  atol = rtol = 1e-5.
- weights after 3 steps at lr 0.1, momentum 0.9: each step moves a
  weight by lr x its (momentum) gradient, so gradient differences of
  1e-6 of its magnitude move it by under 1e-5: atol 1e-4, rtol 1e-4.
- update_math: the same f32 formula: atol = rtol = 1e-6; bf16 weights
  round the result to bf16 on both sides (one ulp, rtol 2^-7).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_autograd
from mxnet_tpu import optimizer as ref_opt
from mxnet_tpu.gluon import FusedTrainStep as RefFusedTrainStep
from mxnet_tpu.gluon import Trainer as RefTrainer
from mxnet_tpu.gluon import loss as ref_loss
from mxnet_tpu.gluon.block import HybridBlock as RefHybridBlock
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd, cpu
from mxnet_tpu_torch import optimizer as port_opt
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
SPEC = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
B, HW, CLASSES = 2, 64, 10
SGD_KW = {"learning_rate": 0.1, "momentum": 0.9}
STEPS = 3


class RefNetWithLoss(RefHybridBlock):
    def __init__(self, net):
        super().__init__()
        self.net = net
        self.loss = ref_loss.SoftmaxCrossEntropyLoss()

    def forward(self, x, y):
        return self.loss(self.net(x), y)


class NetWithLoss(HybridBlock):
    def __init__(self, net):
        super().__init__()
        self.net = net
        self.loss = gloss.SoftmaxCrossEntropyLoss()

    def forward(self, x, y):
        return self.loss(self.net(x), y)


def _batch(seed=0):
    rng = onp.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, 3, HW, HW)).astype(onp.float32)
    y = rng.integers(0, CLASSES, (B,)).astype(onp.int32)
    return x, y


def _ref_net():
    mx.random.seed(0)
    net = ref_vision.ResNetV1(ref_vision.BottleneckV1, *SPEC, classes=CLASSES)
    net.initialize(init=mx.init.Xavier())
    net(mx.np.zeros((1, 3, HW, HW)))       # finish deferred init
    return net


def _np_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _port_net(params):
    net = vision.ResNetV1(vision.BottleneckV1, *SPEC, classes=CLASSES)
    net.initialize(init=mxt.init.Xavier(), ctx=cpu())
    load_reference_params(net, params)
    return net


@pytest.fixture(scope="module")
def start():
    return _np_params(_ref_net())


def _pair(start):
    """(reference net, port net), both at the reference's start weights."""
    ref = ref_vision.ResNetV1(ref_vision.BottleneckV1, *SPEC, classes=CLASSES)
    ref.initialize()
    ref(mx.np.zeros((1, 3, HW, HW)))
    for name, p in ref.collect_params().items():
        p.set_data(mx.np.array(start[name]))
    return ref, _port_net(start)


def test_parameter_names_and_shapes_match_reference(start):
    net = vision.ResNetV1(vision.BottleneckV1, *SPEC, classes=CLASSES)
    net.initialize(ctx=cpu())
    with pytest.raises(DeferredInitializationError):
        net.collect_params()["features.0.weight"].data()
    with torch.no_grad(), autograd.predict_mode():
        net(torch.zeros(1, 3, HW, HW))
    mine = {k: p.shape for k, p in net.collect_params().items()}
    assert mine == {k: v.shape for k, v in start.items()}
    params = net.collect_params()
    assert params["features.1.running_mean"].grad_req == "null"
    assert params["features.1.gamma"].grad_req == "write"
    trainable = [k for k, p in params.items() if p.grad_req != "null"]
    assert len(trainable) == len(params) - 2 * sum(
        k.endswith("running_mean") for k in params)


def test_forward_matches_reference(start):
    ref, net = _pair(start)
    x, _y = _batch(1)
    expect = ref(mx.np.array(x)).asnumpy()                 # predict mode
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(got, expect, atol=ATOL, rtol=RTOL)
    with ref_autograd.record():                            # train mode
        expect = ref(mx.np.array(x)).asnumpy()
    with autograd.record():
        got = net(torch.from_numpy(x)).detach().numpy()
    onp.testing.assert_allclose(got, expect, atol=ATOL, rtol=RTOL)


def test_gradients_and_running_stats_match_reference(start):
    ref, net = _pair(start)
    x, y = _batch(2)
    ref_mod, mod = RefNetWithLoss(ref), NetWithLoss(net)
    with ref_autograd.record():
        loss_r = ref_mod(mx.np.array(x), mx.np.array(y))
    loss_r.backward()
    with autograd.record():
        loss_p = mod(torch.from_numpy(x), torch.from_numpy(y))
    autograd.backward(loss_p)
    onp.testing.assert_allclose(loss_p.detach().numpy(), loss_r.asnumpy(),
                                atol=ATOL, rtol=RTOL)
    ref_params = ref.collect_params()
    for name, p in net.collect_params().items():
        if p.grad_req == "null":
            onp.testing.assert_allclose(
                p.data().numpy(), ref_params[name].data().asnumpy(),
                atol=1e-5, rtol=1e-5, err_msg=name)
            continue
        expect = ref_params[name].grad().asnumpy()
        scale = float(onp.abs(expect).max())
        onp.testing.assert_allclose(p.grad().numpy(), expect,
                                    atol=1e-4 * scale, rtol=1e-3,
                                    err_msg=name)


def _ref_train(ref, batch, fused):
    ref_mod = RefNetWithLoss(ref)
    trainer = RefTrainer(ref.collect_params(), "sgd", dict(SGD_KW),
                         kvstore="device")
    args = [mx.np.array(a) for a in batch]
    step = RefFusedTrainStep(ref_mod, trainer) if fused else None
    losses = []
    for _ in range(STEPS):
        if fused:
            loss = step(*args, batch_size=B)
        else:
            with ref_autograd.record():
                loss = ref_mod(*args)
            loss.backward()
            trainer.step(B)
        losses.append(loss.asnumpy())
    return losses


def _port_train(net, batch, fused):
    mod = NetWithLoss(net)
    trainer = Trainer(net.collect_params(), "sgd", dict(SGD_KW),
                      kvstore="device")
    args = [torch.from_numpy(a) for a in batch]
    step = FusedTrainStep(mod, trainer) if fused else None
    losses = []
    for _ in range(STEPS):
        if fused:
            loss = step(*args, batch_size=B)
        else:
            with autograd.record():
                loss = mod(*args)
            autograd.backward(loss)      # a (B,) head: ones as head grads
            trainer.step(B)
        losses.append(loss.detach().numpy())
    return losses, trainer


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_sgd_momentum_steps_match_reference(start, fused):
    ref, net = _pair(start)
    batch = _batch(3)
    expect = _ref_train(ref, batch, fused)
    got, trainer = _port_train(net, batch, fused)
    onp.testing.assert_allclose(onp.stack(got), onp.stack(expect), atol=ATOL,
                                rtol=RTOL)
    assert got[-1].mean() < got[0].mean()
    ref_params = ref.collect_params()
    for name, p in net.collect_params().items():
        onp.testing.assert_allclose(p.data().detach().numpy(),
                                    ref_params[name].data().asnumpy(),
                                    atol=1e-4, rtol=1e-4, err_msg=name)
    # every momentum buffer is f32 whatever the weight's dtype
    assert all(st[0].dtype == torch.float32
               for st in trainer._states.values())


def test_nonfinite_step_leaves_weights_momentum_and_stats_bitwise(start):
    _ref, net = _pair(start)
    mod = NetWithLoss(net)
    trainer = Trainer(net.collect_params(), "sgd", dict(SGD_KW))
    args = [torch.from_numpy(a) for a in _batch(4)]
    step = FusedTrainStep(mod, trainer)
    step(*args, batch_size=B)
    assert bool(step.last_step_finite)
    params = net.collect_params()
    before = {k: p.data().detach().clone() for k, p in params.items()}
    states = {i: tuple(s.clone() for s in st)
              for i, st in trainer._states.items()}
    trainer._scale = float("nan")              # every gradient goes NaN
    step(*args, batch_size=B)
    assert not bool(step.last_step_finite)
    for k, p in params.items():
        assert torch.equal(p.data(), before[k]), k
    for i, st in trainer._states.items():
        for a, b in zip(st, states[i]):
            assert torch.equal(a, b)
    trainer._scale = 1.0
    step(*args, batch_size=B)
    assert bool(step.last_step_finite)
    assert not torch.equal(params["features.1.running_mean"].data(),
                           before["features.1.running_mean"])


# ---------------------------------------------------------------------------
# loss and SGD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_softmax_cross_entropy_matches_reference(sparse):
    rng = onp.random.default_rng(6)
    pred = rng.standard_normal((5, 7)).astype(onp.float32)
    if sparse:
        label = rng.integers(0, 7, (5,)).astype(onp.int32)
    else:
        label = rng.random((5, 7)).astype(onp.float32)
        label /= label.sum(1, keepdims=True)
    sw = rng.random((5,)).astype(onp.float32)
    ref = ref_loss.SoftmaxCrossEntropyLoss(sparse_label=sparse, weight=0.5)
    mine = gloss.SoftmaxCrossEntropyLoss(sparse_label=sparse, weight=0.5)
    for args in ((), (sw,)):
        expect = ref(mx.np.array(pred), mx.np.array(label),
                     *(mx.np.array(a) for a in args)).asnumpy()
        got = mine(torch.from_numpy(pred), torch.from_numpy(label),
                   *(torch.from_numpy(a) for a in args)).numpy()
        onp.testing.assert_allclose(got, expect, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{"momentum": 0.0}, {"momentum": 0.9},
                                {"momentum": 0.9, "wd": 1e-4},
                                {"momentum": 0.0, "wd": 1e-2}],
                         ids=["plain", "momentum", "momentum_wd", "wd"])
def test_sgd_update_math_matches_reference(kw, dtype):
    import jax.numpy as jnp

    rng = onp.random.default_rng(8)
    w, g = (rng.standard_normal((9, 13)).astype(onp.float32)
            for _ in range(2))
    mom = rng.standard_normal((9, 13)).astype(onp.float32) * 0.1
    ref = ref_opt.create("sgd", learning_rate=0.1, **kw)
    mine = port_opt.create("sgd", learning_rate=0.1, **kw)
    assert isinstance(mine, port_opt.SGD)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    st_p = mine.create_state(0, torch.zeros(9, 13, dtype=tdt))
    assert len(st_p) == (1 if kw["momentum"] else 0)
    assert all(s.dtype == torch.float32 for s in st_p)
    states_r = (jnp.asarray(mom),) if kw["momentum"] else ()
    states_p = (torch.from_numpy(mom),) if kw["momentum"] else ()
    wd = kw.get("wd", 0.0)
    nw_r, ns_r = ref.update_math(jnp.asarray(w).astype(jdt),
                                 jnp.asarray(g).astype(jdt), states_r, 0.1,
                                 wd, 1)
    nw_p, ns_p = mine.update_math(torch.from_numpy(w).to(tdt),
                                  torch.from_numpy(g).to(tdt), states_p, 0.1,
                                  wd, 1)
    assert nw_p.dtype == tdt
    for a, b in zip(ns_p, ns_r):
        assert a.dtype == torch.float32
        onp.testing.assert_allclose(a.numpy(), onp.asarray(b), atol=1e-6,
                                    rtol=1e-6)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    onp.testing.assert_allclose(nw_p.float().numpy(),
                                onp.asarray(nw_r.astype(jnp.float32)),
                                atol=1e-6, rtol=rtol)
