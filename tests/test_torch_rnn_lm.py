"""The port's LSTM word language model (BASELINE config 5) and
`gluon.utils` against the JAX package's.

`RNNModel` tied and untied, every mode, at V 50, E = H = 16, T 7, N 3,
the reference's weights carried across: logits, states and every
parameter's gradient; then five steps of ``examples/rnn/word_lm.py``'s
loop (``record``, SoftmaxCrossEntropyLoss, ``backward``,
``clip_global_norm``, SGD at lr 1.0) as a trajectory of
losses, gradient norms and weights; and `split_data`,
`split_and_load`, `clip_global_norm`, `shape_is_known`, `check_sha1`.
Dropout is 0 where values are compared: the port's model-level dropout
masks come from its own generator, the reference's from XLA's bits.

Tolerances, f32: logits, states and losses rtol 1e-5, atol 1e-6;
gradients rtol 1e-5 and atol 1e-5 x the parameter's largest reference
gradient (sums over T*N = 21 rows, as in `test_torch_rnn.py`); weights
after five clipped steps rtol 1e-5, atol 1e-6 (each step moves the
weights by at most the clipping norm in L2, so rounding in the
gradients moves them by far less).
"""
import pathlib
import warnings

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_autograd
from mxnet_tpu import gluon as ref_gluon
from mxnet_tpu.models import RNNModel as RefRNNModel
from mxnet_tpu_torch import autograd, cpu, gluon
from mxnet_tpu_torch import npx as mxt_npx
from mxnet_tpu_torch.gluon import utils
from mxnet_tpu_torch.models import RNNModel
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

V, E, T, N = 50, 16, 7, 3
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5


def _models(mode="lstm", tie=False, layers=2, dropout=0.0):
    ref = RefRNNModel(V, E, E, layers, mode, dropout=dropout,
                      tie_weights=tie)
    ref.initialize(init=mx.init.Xavier())
    ref(mx.np.array(onp.zeros((T, N), "int32")))
    port = RNNModel(V, E, E, layers, mode, dropout=dropout, tie_weights=tie)
    port.initialize(ctx=cpu())
    load_reference_params(port, {k: p.data().asnumpy()
                                 for k, p in ref.collect_params().items()})
    return ref, port


def _tokens(rng):
    return rng.integers(0, V, (T, N)).astype("int32")


@pytest.mark.parametrize("mode,tie", [("lstm", False), ("lstm", True),
                                      ("gru", False), ("rnn_relu", True),
                                      ("rnn_tanh", False)])
def test_model_matches_reference(mode, tie):
    rng = onp.random.default_rng(0)
    ref, port = _models(mode, tie)
    assert list(port.collect_params()) == list(ref.collect_params())
    assert not tie or not any("decoder" in k for k in port.collect_params())
    x = _tokens(rng)
    head = rng.standard_normal((T, N, V)).astype("float32")
    st_np = [rng.uniform(-0.5, 0.5, (2, N, E)).astype("float32")
             for _ in range(2 if mode == "lstm" else 1)]

    def ref_state():
        st = [mx.np.array(s) for s in st_np]
        return st if mode == "lstm" else st[0]

    def port_state():
        st = [torch.from_numpy(s) for s in st_np]
        return st if mode == "lstm" else st[0]

    with ref_autograd.record(train_mode=False):
        logits_r, new_r = ref(mx.np.array(x), ref_state())
        loss_r = (logits_r * mx.np.array(head)).sum()
    loss_r.backward()
    with autograd.record(train_mode=False):
        logits_p, new_p = port(torch.from_numpy(x), port_state())
        loss_p = (logits_p * torch.from_numpy(head)).sum()
    autograd.backward(loss_p)
    onp.testing.assert_allclose(logits_p.detach().numpy(), logits_r.asnumpy(),
                                rtol=RTOL, atol=ATOL)
    new_r = new_r if isinstance(new_r, list) else [new_r]
    new_p = new_p if isinstance(new_p, list) else [new_p]
    for a, b in zip(new_p, new_r):
        onp.testing.assert_allclose(a.detach().numpy(), b.asnumpy(),
                                    rtol=RTOL, atol=ATOL)
    ref_params = ref.collect_params()
    for name, p in port.collect_params().items():
        expect = ref_params[name].grad().asnumpy()
        onp.testing.assert_allclose(
            p.grad().numpy(), expect, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(onp.abs(expect).max()), err_msg=name)
    # without a state: the logits alone, from zero states
    with autograd.predict_mode():
        alone = port(torch.from_numpy(x))
    onp.testing.assert_allclose(alone.detach().numpy(),
                                ref(mx.np.array(x)).asnumpy(), rtol=RTOL,
                                atol=ATOL)


def test_tie_weights_needs_equal_widths():
    with pytest.raises(ValueError):
        RNNModel(V, num_embed=8, num_hidden=16, tie_weights=True)
    with pytest.raises(ValueError):
        RNNModel(V, mode="lstmp")


def _grads(params):
    return [p.grad() for p in params.values() if p.grad_req != "null"]


# the example clips at 0.25; the gradients of this small model have
# norms near 0.1, so the trajectory clips at 0.05 to scale every step
MAX_NORM = 0.05


def test_word_lm_loop_trajectory_matches_reference():
    """Five steps of the example's loop on one batch: losses, the norm
    ``clip_global_norm`` returns and every weight after each step."""
    rng = onp.random.default_rng(1)
    ref, port = _models("lstm", tie=True)
    data, label = _tokens(rng), _tokens(rng)
    tr_r = ref_gluon.Trainer(ref.collect_params(), "sgd",
                             {"learning_rate": 1.0})
    tr_p = gluon.Trainer(port.collect_params(), "sgd",
                         {"learning_rate": 1.0})
    loss_fn_r = ref_gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn_p = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(5):
        with ref_autograd.record():
            loss_r = loss_fn_r(ref(mx.np.array(data)),
                               mx.np.array(label)).mean()
        loss_r.backward()
        norm_r = ref_gluon.utils.clip_global_norm(
            _grads(ref.collect_params()), MAX_NORM)
        tr_r.step(N)
        with autograd.record():
            loss_p = loss_fn_p(port(torch.from_numpy(data)),
                               torch.from_numpy(label)).mean()
        loss_p.backward()
        norm_p = utils.clip_global_norm(_grads(port.collect_params()),
                                        MAX_NORM)
        tr_p.step(N)
        assert isinstance(norm_p, float)
        onp.testing.assert_allclose(float(loss_p), float(loss_r.asnumpy()),
                                    rtol=RTOL, atol=ATOL)
        onp.testing.assert_allclose(norm_p, norm_r, rtol=RTOL, atol=ATOL)
        assert norm_p > MAX_NORM           # every step is clipped
        ref_params = ref.collect_params()
        for name, p in port.collect_params().items():
            onp.testing.assert_allclose(
                p.data().detach().numpy(), ref_params[name].data().asnumpy(),
                rtol=RTOL, atol=ATOL, err_msg=name)


def test_clip_global_norm_matches_reference_and_warns():
    rng = onp.random.default_rng(2)
    arrs = [rng.standard_normal(s).astype("float32") for s in
            ((4, 5), (7,), (2, 3, 3))]
    for max_norm in (0.5, 100.0):
        ref = [mx.np.array(a) for a in arrs]
        port = [torch.from_numpy(a.copy()) for a in arrs]
        n_r = ref_gluon.utils.clip_global_norm(ref, max_norm)
        n_p = utils.clip_global_norm(port, max_norm)
        onp.testing.assert_allclose(n_p, n_r, rtol=RTOL)
        for a, b in zip(port, ref):
            onp.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=RTOL,
                                        atol=ATOL)
        # without the host check: the norm stays a tensor, the same scale
        dev = [torch.from_numpy(a.copy()) for a in arrs]
        n_d = utils.clip_global_norm(dev, max_norm, check_isfinite=False)
        assert isinstance(n_d, torch.Tensor)
        onp.testing.assert_allclose(float(n_d), n_p, rtol=RTOL)
        for a, b in zip(dev, port):
            onp.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                        atol=ATOL)
    bad = [torch.tensor([float("nan"), 1.0])]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        utils.clip_global_norm(bad, 1.0)
    assert any("nan or inf" in str(w.message) for w in caught)
    with pytest.raises(NotImplementedError, match="item 10"):
        utils.clip_global_norm([torch.eye(3).to_sparse()], 1.0)
    with pytest.raises(ValueError):
        utils.clip_global_norm([], 1.0)


def test_clip_global_norm_without_check_does_not_sync(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("read to the host")
    arrs = [torch.ones(3, 4) * 2.0]
    with monkeypatch.context() as m:
        for name in ("__bool__", "__float__", "item", "tolist"):
            m.setattr(torch.Tensor, name, refuse)
        utils.clip_global_norm(arrs, 1.0, check_isfinite=False)
    onp.testing.assert_allclose(float(torch.linalg.norm(arrs[0])), 1.0,
                                rtol=1e-6)


@pytest.mark.parametrize("size,num,even", [(12, 3, True), (10, 3, False)])
def test_split_data_and_load_match_reference(size, num, even):
    x = onp.arange(size * 2, dtype="float32").reshape(size, 2)
    ref = ref_gluon.utils.split_data(mx.np.array(x), num, even_split=even)
    port = utils.split_data(torch.from_numpy(x), num, even_split=even)
    assert [tuple(p.shape) for p in port] == [r.shape for r in ref]
    for a, b in zip(port, ref):
        assert torch.equal(a, torch.from_numpy(b.asnumpy()))
    loaded = utils.split_and_load(x, [cpu()] * num, even_split=even)
    assert all(torch.equal(a, b) for a, b in zip(loaded, port))
    assert torch.equal(utils.split_and_load(x, [cpu()])[0],
                       torch.from_numpy(x))
    if not even:
        with pytest.raises(ValueError):
            utils.split_data(torch.from_numpy(x), num)


def test_shape_is_known_and_check_sha1(tmp_path):
    for shape in (None, (2, 0), (3, 4), ()):
        assert utils.shape_is_known(shape) == \
            ref_gluon.utils.shape_is_known(shape)
    f = pathlib.Path(tmp_path) / "blob.bin"
    f.write_bytes(b"mxnet" * 1000)
    import hashlib
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert utils.check_sha1(str(f), digest)
    assert not utils.check_sha1(str(f), "0" * 40)
    assert ref_gluon.utils.check_sha1(str(f), digest)


def test_padding_id_reads_the_last_embedding_row():
    """`BucketSentenceIter` pads with -1; the reference's ``take`` reads
    it as the last row, and its gradient lands there."""
    rng = onp.random.default_rng(3)
    w = rng.standard_normal((V, E)).astype("float32")
    idx = onp.array([[3, -1], [-1, 0]], "int32")
    ref_w = mx.np.array(w)
    ref_w.attach_grad()
    with ref_autograd.record():
        out_r = mx.npx.embedding(mx.np.array(idx), ref_w)
        loss_r = (out_r * out_r).sum()
    loss_r.backward()
    port_w = torch.from_numpy(w).requires_grad_(True)
    out_p = mxt_npx.embedding(torch.from_numpy(idx), port_w)
    (out_p * out_p).sum().backward()
    assert torch.equal(out_p.detach(), torch.from_numpy(out_r.asnumpy()))
    onp.testing.assert_allclose(port_w.grad.numpy(), ref_w.grad.asnumpy(),
                                rtol=RTOL, atol=ATOL)
