"""The port's custom operators (`operator`, ``mx.nd.Custom``) against the
JAX package's, and the ``softmax_rtc`` loss head that `chip_smoke.py`
trains ResNet-50 with.

The same numpy inputs go to both packages on the CPU.  The head is
imported from `chip_smoke.py` (its kernels are user code there); on a
CPU tensor it runs its plain versions.  Its JAX counterpart is a
``CustomOp`` whose forward runs the same softmax as a ``PallasModule``
kernel in interpret mode, as `tests/test_rtc_viz.py` runs one.

Tolerances (f32):
- single operators: atol = rtol = 1e-6 (the same few f32 operations).
- the head: probabilities and gradients within atol = rtol = 1e-6; the
  two softmaxes sum a row in other orders (some 1e-7 of a value).
- three SGD-momentum steps of a narrow ResNet with the head: weights
  and running statistics within atol = rtol = 1e-4, as in
  `test_torch_resnet.py`: BatchNorm over a small batch magnifies
  rounding differences of the forward, and lr 0.1 moves a weight by
  about lr times its gradient each step.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_ag
from mxnet_tpu.gluon import Trainer as RefTrainer
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd, cpu, operator
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
X = onp.array([[0.5, -1.25, 2.0], [3.0, 0.25, -0.5]], dtype=onp.float32)
W = onp.array([[1.0, 10.0, -3.0], [2.0, -1.0, 0.5]], dtype=onp.float32)


def _close(port, ref, **tol):
    onp.testing.assert_allclose(port.detach().numpy(), ref.asnumpy(),
                                **(tol or TOL))


def _define(package, name, need_top_grad=True):
    """Register in ``package`` an op ``name`` with outputs ``2 x`` and
    ``x * y`` of its arguments ``x`` and ``y``."""

    @package.operator.register(name)
    class Prop(package.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=need_top_grad)

        def list_arguments(self):
            return ["x", "y"]

        def list_outputs(self):
            return ["double", "product"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Op()

    class Op(package.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2.0)
            self.assign(out_data[1], req[1], in_data[0] * in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x, y = in_data
            if need_top_grad:
                d2, dp = out_grad
            else:
                d2, dp = x * 0 + 1, x * 0 + 1
            self.assign(in_grad[0], req[0], d2 * 2.0 + dp * y)
            self.assign(in_grad[1], req[1], dp * x)

    return Prop


_define(mx, "port_test_two_out")
_define(mxt, "port_test_two_out")
_define(mx, "port_test_no_top_grad", need_top_grad=False)
_define(mxt, "port_test_no_top_grad", need_top_grad=False)


@pytest.mark.parametrize("op_type", ["port_test_two_out",
                                     "port_test_no_top_grad"])
def test_custom_two_outputs_forward_backward(op_type):
    """Two inputs, two outputs, gradients to both inputs; with
    ``need_top_grad=False`` the backward ignores the head gradients."""
    rx, ry = mx.np.array(X), mx.np.array(X[::-1].copy())
    rx.attach_grad()
    ry.attach_grad()
    with ref_ag.record():
        r2, rp = mx.nd.Custom(rx, ry, op_type=op_type)
        rl = (r2 * mx.np.array(W) + rp * 3).sum()
    rl.backward()
    tx = torch.tensor(X).requires_grad_()
    ty = torch.tensor(X[::-1].copy()).requires_grad_()
    with autograd.record():
        t2, tp = mxt.nd.Custom(tx, ty, op_type=op_type)
        tl = (t2 * torch.tensor(W) + tp * 3).sum()
    autograd.backward(tl)
    _close(t2, r2)
    _close(tp, rp)
    _close(tx.grad, rx.grad)
    _close(ty.grad, ry.grad)
    prop = mxt.operator.get_all_registered()[op_type]()
    assert prop.need_top_grad_ == (op_type == "port_test_two_out")


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_assign_req(req):
    rdst, tdst = mx.np.array(X), torch.tensor(X)
    mx.operator.CustomOp.assign(rdst, req, mx.np.array(W))
    operator.CustomOp.assign(tdst, req, torch.tensor(W))
    _close(tdst, rdst)


def test_custom_outside_record_and_types():
    """Outside ``record`` the outputs need no gradient; an int32 input
    gives an int32 output (types from ``infer_type``)."""
    out = mxt.nd.Custom(torch.tensor(X), torch.tensor(X),
                        op_type="port_test_two_out")
    assert not out[0].requires_grad
    ints = onp.array([1, 2, 3], dtype=onp.int32)
    r2, _ = mx.nd.Custom(mx.np.array(ints), mx.np.array(ints),
                         op_type="port_test_two_out")
    t2, _ = mxt.nd.Custom(torch.tensor(ints), torch.tensor(ints),
                          op_type="port_test_two_out")
    assert t2.dtype == torch.int32
    onp.testing.assert_array_equal(t2.numpy(), r2.asnumpy())


def test_custom_unregistered_raises():
    with pytest.raises(ValueError, match="not registered"):
        mxt.nd.Custom(torch.zeros(2), op_type="port_test_nope")


def test_custom_sees_train_mode():
    """``is_train`` is read before the forward pauses: True under
    ``record()``, False outside."""
    seen = []

    @operator.register("port_test_train_flag")
    class Prop(operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Op(operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    seen.append(is_train)
                    self.assign(out_data[0], req[0], in_data[0])
            return Op()

    x = torch.tensor(X)
    with autograd.record():
        mxt.nd.Custom(x, op_type="port_test_train_flag")
    mxt.nd.Custom(x, op_type="port_test_train_flag")
    assert seen == [True, False]


# ---------------------------------------------------------------------------
# the softmax_rtc head
# ---------------------------------------------------------------------------
chip_smoke.register_softmax_rtc()


def _pallas_softmax(x_ref, o_ref):
    x = x_ref[...]
    e = jnp.exp(x - x.max(axis=-1, keepdims=True))
    o_ref[...] = e / e.sum(axis=-1, keepdims=True)


_PALLAS_SOFTMAX = mx.rtc.PallasModule(_pallas_softmax).get_kernel(
    "_pallas_softmax", out_like=0)


@mx.operator.register("softmax_pallas")
class _RefSoftmaxProp(mx.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        class Op(mx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0],
                            _PALLAS_SOFTMAX.launch((in_data[0],)))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                y = out_data[0]
                self.assign(in_grad[0], req[0],
                            y - mx.npx.one_hot(in_data[1], y.shape[1]))
        return Op()


def _head_inputs(rows, cols, seed):
    rng = onp.random.default_rng(seed)
    logits = (rng.standard_normal((rows, cols)) * 4).astype(onp.float32)
    label = rng.integers(0, cols, rows).astype(onp.int32)
    return logits, label


@pytest.mark.parametrize("rows, cols", [(4, 10), (37, 1001)])
def test_softmax_head_against_pallas_custom_op(rows, cols):
    logits, label = _head_inputs(rows, cols, seed=rows)
    rx = mx.np.array(logits)
    rx.attach_grad()
    with ref_ag.record():
        rp = mx.nd.Custom(rx, mx.np.array(label), op_type="softmax_pallas")
    rp.backward()
    tx = torch.tensor(logits).requires_grad_()
    with autograd.record():
        tp = mxt.nd.Custom(tx, torch.tensor(label), op_type="softmax_rtc")
    autograd.backward(tp)
    _close(tp, rp)
    _close(tx.grad, rx.grad)


def test_softmax_head_gradient_is_cross_entropys():
    """The head's gradient (``need_top_grad=False``) is that of
    SoftmaxCrossEntropyLoss summed over the batch: softmax - onehot."""
    logits, label = _head_inputs(8, 1000, seed=3)
    a = torch.tensor(logits).requires_grad_()
    b = torch.tensor(logits).requires_grad_()
    with autograd.record():
        prob = mxt.nd.Custom(a, torch.tensor(label), op_type="softmax_rtc")
        loss = SoftmaxCrossEntropyLoss()(b, torch.tensor(label))
    autograd.backward(prob)
    autograd.backward(loss)
    onp.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                                atol=chip_smoke.HEAD_GRAD_TOL)


def test_softmax_plain_versions():
    """The plain versions the card's kernels are held against."""
    logits, label = _head_inputs(5, 7, seed=1)
    x = torch.tensor(logits)
    y = chip_smoke.softmax_plain(x)
    onp.testing.assert_allclose(y.numpy(), torch.softmax(x, -1).numpy(),
                                **TOL)
    dx = chip_smoke.softmax_bwd_plain(torch.tensor(label), y)
    want = y.numpy().copy()
    want[onp.arange(5), label] -= 1
    onp.testing.assert_array_equal(dx.numpy(), want)
    a, b = torch.tensor(logits[0]), torch.tensor(logits[1])
    assert torch.equal(chip_smoke.axpy_plain(a, b, 2.5), 2.5 * a + b)


# the narrow ResNet-50-style net of `test_torch_resnet.py`:
# ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128])`` at
# (2, 3, 64, 64).  ``resnet18_v1(thumbnail=True)`` at 32 x 32 is no good
# for a trajectory: at its first step a pre-activation of
# ``features.2.1`` lies within rounding of 0, the two packages' last-bit
# differences put it on either side of the ReLU, and their gradients
# then differ by 1e-3, which three steps at lr 0.1 amplify.
STEPS, BATCH, HW, CLASSES = 3, 2, 64, 10
SPEC = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
SGD_KW = {"learning_rate": 0.1, "momentum": 0.9}


def test_small_resnet_trained_with_the_head():
    """Three SGD-momentum steps in the eager loop (record, the head,
    backward, ``Trainer.step``) in both packages from the same Xavier
    weights and batch: probabilities each step, then every weight and
    running statistic."""
    rng = onp.random.default_rng(0)
    x = rng.uniform(-1, 1, (BATCH, 3, HW, HW)).astype(onp.float32)
    label = rng.integers(0, CLASSES, BATCH).astype(onp.int32)
    mx.random.seed(0)
    ref = ref_vision.ResNetV1(ref_vision.BottleneckV1, *SPEC,
                              classes=CLASSES)
    ref.initialize(init=mx.init.Xavier())
    ref(mx.np.zeros((1, 3, HW, HW)))
    net = vision.ResNetV1(vision.BottleneckV1, *SPEC, classes=CLASSES)
    net.initialize(ctx=cpu())
    load_reference_params(net, {k: p.data().asnumpy()
                                for k, p in ref.collect_params().items()})
    ref_tr = RefTrainer(ref.collect_params(), "sgd", SGD_KW)
    tr = Trainer(net.collect_params(), "sgd", SGD_KW)
    rx, rl = mx.np.array(x), mx.np.array(label)
    tx, tl = torch.tensor(x), torch.tensor(label)
    for _ in range(STEPS):
        with ref_ag.record():
            rp = mx.nd.Custom(ref(rx), rl, op_type="softmax_pallas")
        rp.backward()
        ref_tr.step(BATCH)
        with autograd.record():
            tp = mxt.nd.Custom(net(tx), tl, op_type="softmax_rtc")
        autograd.backward(tp)
        tr.step(BATCH)
        _close(tp, rp, rtol=1e-4, atol=1e-4)
    mine = net.collect_params()
    for k, p in ref.collect_params().items():
        _close(mine[k].data(), p.data(), rtol=1e-4, atol=1e-4)
