"""The port's autograd API against the JAX package's: ``grad``,
``backward`` with head gradients, ``retain_graph``, second order,
``mark_variables`` (write and add) and `autograd.Function`.

The same numpy inputs go to both packages (a JAX ``NDArray`` with
``attach_grad()``, a torch tensor that requires grad), in f32 on the
CPU.  Tolerance: atol = rtol = 1e-6: both sides compute the same few
f32 operations, and only the order of a sum or an exp's last bit may
differ.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_ag
from mxnet_tpu_torch import autograd

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
X = onp.array([0.5, -1.25, 2.0], dtype=onp.float32)
HEAD = onp.array([1.0, 10.0, -3.0], dtype=onp.float32)


def _pair(a):
    ref = mx.np.array(a)
    ref.attach_grad()
    return ref, torch.tensor(a).requires_grad_()


def _close(port, ref):
    onp.testing.assert_allclose(port.detach().numpy(), ref.asnumpy(), **TOL)


def test_grad_returns_and_leaves_grad_untouched():
    rx, tx = _pair(X)
    with ref_ag.record():
        ry = (rx ** 3).sum()
    (rg,) = ref_ag.grad(ry, [rx])
    with autograd.record():
        ty = (tx ** 3).sum()
    (tg,) = autograd.grad(ty, [tx])
    _close(tg, rg)
    assert tx.grad is None
    assert not rx.grad.asnumpy().any()


def test_grad_with_head_grads_and_unused_variable():
    rx, tx = _pair(X)
    rz, tz = _pair(X * 2)
    with ref_ag.record():
        ry = rx * rx
    rg, rgz = ref_ag.grad(ry, [rx, rz], head_grads=mx.np.array(HEAD))
    with autograd.record():
        ty = tx * tx
    tg, tgz = autograd.grad(ty, [tx, tz], head_grads=torch.tensor(HEAD))
    _close(tg, rg)
    _close(tgz, rgz)
    assert not tgz.any()


def test_backward_with_head_grads():
    rx, tx = _pair(X)
    with ref_ag.record():
        ry = rx * 2 + rx * rx
    ry.backward(mx.np.array(HEAD))
    with autograd.record():
        ty = tx * 2 + tx * tx
    autograd.backward(ty, torch.tensor(HEAD))
    _close(tx.grad, rx.grad)


def test_retain_graph_then_release():
    rx, tx = _pair(X[:1])
    with ref_ag.record():
        ry = rx * rx
    ry.backward(retain_graph=True)
    ry.backward()
    with pytest.raises(RuntimeError):
        ry.backward()
    with autograd.record():
        ty = tx * tx
    autograd.backward(ty, retain_graph=True)
    autograd.backward(ty)
    with pytest.raises(RuntimeError):
        autograd.backward(ty)
    # 'write' in the reference keeps the last backward; torch's leaf sums
    # both, as a grad_req='add' parameter does
    _close(tx.grad / 2, rx.grad)


def test_second_order_through_create_graph():
    rx, tx = _pair(X)
    with ref_ag.record():
        ry = (rx ** 3).sum()
        (rg,) = ref_ag.grad(ry, [rx], create_graph=True, retain_graph=True)
        rs = rg.sum()
    rs.backward()
    with autograd.record():
        ty = (tx ** 3).sum()
        (tg,) = autograd.grad(ty, [tx], create_graph=True)
        ts = tg.sum()
    autograd.backward(ts)
    _close(tx.grad, rx.grad)
    onp.testing.assert_allclose(tx.grad.numpy(), 6 * X, **TOL)


@pytest.mark.parametrize("req", ["write", "add"])
def test_mark_variables(req):
    """Two backwards into caller-owned buffers: 'write' keeps the last
    gradient, 'add' sums both."""
    rx, tx = mx.np.array(X), torch.tensor(X)
    rg, tg = mx.np.zeros(X.shape), torch.zeros(X.shape)
    ref_ag.mark_variables([rx], [rg], req)
    autograd.mark_variables([tx], [tg], req)
    for scale in (5.0, 7.0):
        with ref_ag.record():
            ry = rx * scale
        ry.backward()
        with autograd.record():
            ty = tx * scale
        autograd.backward(ty)
    _close(tg, rg)
    onp.testing.assert_allclose(tg.numpy(), onp.full(3, 7.0 if req == "write"
                                                     else 12.0), **TOL)
    assert tx.grad is None


def test_mark_variables_again_replaces_the_buffer():
    tx = torch.tensor(X)
    first, second = torch.zeros(3), torch.zeros(3)
    autograd.mark_variables(tx, first, "add")
    autograd.mark_variables(tx, second, "add")
    with autograd.record():
        ty = tx * 3
    autograd.backward(ty)
    assert not first.any()
    onp.testing.assert_allclose(second.numpy(), onp.full(3, 3.0))
    with pytest.raises(ValueError, match="grad_req"):
        autograd.mark_variables([tx], [second], "sum")


class _RefSigmoid(ref_ag.Function):
    def forward(self, x):
        y = 1 / (1 + mx.np.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        (y,) = self.saved_tensors
        return dy * y * (1 - y)


class _Sigmoid(autograd.Function):
    def forward(self, x):
        y = 1 / (1 + torch.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        (y,) = self.saved_tensors
        return dy * y * (1 - y)


def test_custom_function():
    rx, tx = _pair(X)
    with ref_ag.record():
        ry = (_RefSigmoid()(rx) * mx.np.array(HEAD)).sum()
    ry.backward()
    with autograd.record():
        out = _Sigmoid()(tx)
        ty = (out * torch.tensor(HEAD)).sum()
    autograd.backward(ty)
    _close(out, _RefSigmoid()(mx.np.array(X)))
    _close(tx.grad, rx.grad)


class _RefScaleShift(ref_ag.Function):
    """Two inputs (the second an integer shift), two outputs, the first
    its input unchanged."""

    def forward(self, x, shift):
        self.save_for_backward(x)
        return x, x * x + shift

    def backward(self, dx_out, dsq):
        (x,) = self.saved_tensors
        return dx_out + 2 * x * dsq, mx.np.zeros(x.shape)


class _ScaleShift(autograd.Function):
    def forward(self, x, shift):
        assert not autograd.is_recording() and not autograd.is_training()
        self.save_for_backward(x)
        return x, x * x + shift

    def backward(self, dx_out, dsq):
        (x,) = self.saved_tensors
        return dx_out + 2 * x * dsq, torch.zeros_like(x)


def test_function_two_outputs_one_an_input():
    shift = onp.array([1, 2, 3], dtype=onp.int32)
    rx, tx = _pair(X)
    with ref_ag.record():
        ra, rb = _RefScaleShift()(rx, mx.np.array(shift))
        ry = (ra * 3 + rb * mx.np.array(HEAD)).sum()
    ry.backward()
    with autograd.record():
        ta, tb = _ScaleShift()(tx, torch.tensor(shift))
        ty = (ta * 3 + tb * torch.tensor(HEAD)).sum()
    autograd.backward(ty)
    _close(tb, rb)
    _close(tx.grad, rx.grad)
    assert ta.data_ptr() != tx.data_ptr()
