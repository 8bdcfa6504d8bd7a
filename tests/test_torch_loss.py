"""The port's `gluon.loss` against the JAX package's.

Each of the 14 losses on the same seeded numpy inputs in both packages,
with and without ``weight`` and ``sample_weight``: the per-sample losses
and the gradients of every floating input for one seeded output
gradient.  CTC with ragged ``pred_lengths`` and ``label_lengths``, in
both layouts, and against torch's ``F.ctc_loss`` on the same ragged
batch.  CosineEmbeddingLoss is held to upstream MXNet's formula, since
the JAX package's compares its second input with itself.

Tolerance: f32 on both sides, the same formulas in other orders:
atol = rtol = 1e-5 (1e-4 for CTC, whose log-space sums run over up to
12 frames).
"""
import numpy as onp
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as ref_loss
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.gluon import loss

torch.set_num_threads(1)

TOL = 1e-5


def _run_both(name, kwargs, inputs, float_idx, call_kw=None, tol=TOL):
    """Loss ``name`` of both packages on ``inputs`` (numpy arrays; those
    at ``float_idx`` take gradients): the losses, then the gradients for
    a seeded output gradient."""
    call_kw = call_kw or {}
    ref_in = [mx.np.array(a) for a in inputs]
    for i in float_idx:
        ref_in[i].attach_grad()
    ref_kw = {k: mx.np.array(v) for k, v in call_kw.items()}
    with mx.autograd.record():
        ref_out = getattr(ref_loss, name)(**kwargs)(*ref_in, **ref_kw)
    og = onp.random.default_rng(99).standard_normal(ref_out.shape).astype(
        onp.float32)
    ref_out.backward(mx.np.array(og))
    mine = [torch.tensor(a, requires_grad=i in float_idx)
            for i, a in enumerate(inputs)]
    my_kw = {k: torch.from_numpy(v) for k, v in call_kw.items()}
    with autograd.record():
        out = getattr(loss, name)(**kwargs)(*mine, **my_kw)
    out.backward(torch.from_numpy(og).reshape(out.shape))
    onp.testing.assert_allclose(out.detach().numpy(), ref_out.asnumpy(),
                                atol=tol, rtol=tol)
    for i in float_idx:
        onp.testing.assert_allclose(mine[i].grad.numpy(),
                                    ref_in[i].grad.asnumpy(), atol=tol,
                                    rtol=tol)
    return out


RNG = onp.random.default_rng(0)
PRED = RNG.standard_normal((4, 5)).astype(onp.float32)
LABEL = RNG.standard_normal((4, 5)).astype(onp.float32)
SIGNED = onp.sign(RNG.standard_normal((4, 5))).astype(onp.float32)
BINARY = (RNG.uniform(size=(4, 5)) > 0.5).astype(onp.float32)
PROB = RNG.uniform(0.05, 0.95, (4, 5)).astype(onp.float32)
SW = RNG.uniform(0.5, 1.5, (4, 1)).astype(onp.float32)
CLASSES = RNG.integers(0, 5, (4,)).astype(onp.float32)
DIST = onp.abs(RNG.standard_normal((4, 5))).astype(onp.float32)
DIST /= DIST.sum(-1, keepdims=True)
COUNTS = RNG.integers(0, 4, (4, 5)).astype(onp.float32)

SW5 = RNG.uniform(0.5, 1.5, (5,)).astype(onp.float32)

# (loss, constructor arguments, inputs, a sample weight that broadcasts
# against the per-element loss)
CASES = [
    ("L2Loss", {}, [PRED, LABEL], SW),
    ("L2Loss", {"weight": 0.3}, [PRED, LABEL.reshape(4, 5, 1)], SW),
    ("L1Loss", {"weight": 2.0}, [PRED, LABEL], SW),
    ("SigmoidBinaryCrossEntropyLoss", {}, [PRED, BINARY], SW),
    ("SigmoidBCELoss", {"from_sigmoid": True}, [PROB, BINARY], SW),
    ("SoftmaxCrossEntropyLoss", {}, [PRED, CLASSES], SW[:, 0]),
    ("SoftmaxCELoss", {"sparse_label": False, "weight": 0.5}, [PRED, DIST],
     SW[:, 0]),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True, "axis": 0},
     [PRED, CLASSES[:1].repeat(5)], SW5),
    ("KLDivLoss", {}, [onp.log(PROB), DIST], SW),
    ("KLDivLoss", {"from_logits": False, "weight": 1.5}, [PRED, DIST], SW),
    ("HuberLoss", {"rho": 0.7}, [PRED, LABEL], SW),
    ("HingeLoss", {"margin": 0.5}, [PRED, SIGNED], SW),
    ("SquaredHingeLoss", {}, [PRED, SIGNED], SW),
    ("LogisticLoss", {}, [PRED, SIGNED], SW),
    ("LogisticLoss", {"label_format": "binary", "weight": 0.2},
     [PRED, BINARY], SW),
    ("PoissonNLLLoss", {}, [PRED * 0.3, COUNTS], SW),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     [PROB * 3, COUNTS], SW),
]


@pytest.mark.parametrize("with_sw", [False, True])
@pytest.mark.parametrize("name,kwargs,inputs,sw", CASES)
def test_pointwise_losses_match_reference(name, kwargs, inputs, sw,
                                          with_sw):
    _run_both(name, kwargs, inputs, [0],
              {"sample_weight": sw} if with_sw else None)


def test_sigmoid_bce_pos_weight_matches_reference():
    pw = RNG.uniform(0.5, 3, (4, 5)).astype(onp.float32)
    for from_sigmoid, pred in ((False, PRED), (True, PROB)):
        _run_both("SigmoidBCELoss", {"from_sigmoid": from_sigmoid},
                  [pred, BINARY], [0], {"pos_weight": pw})


@pytest.mark.parametrize("with_sw", [False, True])
def test_triplet_loss_matches_reference(with_sw):
    pos = RNG.standard_normal((4, 5)).astype(onp.float32)
    neg = RNG.standard_normal((4, 5)).astype(onp.float32)
    _run_both("TripletLoss", {"margin": 2.0, "weight": 0.7},
              [PRED, pos, neg], [0, 1, 2],
              {"sample_weight": SW[:, 0]} if with_sw else None)


@pytest.mark.parametrize("with_sw", [False, True])
def test_cosine_embedding_loss_matches_upstream_formula(with_sw):
    """Held to upstream MXNet's formula in numpy, not to the JAX
    package: its ``_reshape_like(input1, input2)`` returns input2, so it
    compares input2 with itself (and input1 gets a zero gradient).  The
    port reshapes input1 like input2, as upstream does."""
    other = RNG.standard_normal((4, 5)).astype(onp.float32)
    lab = onp.array([1, -1, 1, -1], onp.float32)
    sw = SW[:, 0] if with_sw else onp.ones(4, onp.float32)
    a = torch.tensor(PRED, requires_grad=True)
    b = torch.tensor(other, requires_grad=True)
    with autograd.record():
        out = loss.CosineEmbeddingLoss(margin=0.1, weight=1.3)(
            a, b, torch.from_numpy(lab),
            torch.from_numpy(sw) if with_sw else None)
    cos = (PRED * other).sum(-1) / (
        onp.sqrt((PRED ** 2).sum(-1)) * onp.sqrt((other ** 2).sum(-1))
        + 1e-12)
    expect = onp.where(lab == 1, 1 - cos, onp.maximum(cos - 0.1, 0)) \
        * sw * 1.3
    onp.testing.assert_allclose(out.detach().numpy(), expect, atol=TOL,
                                rtol=TOL)
    out.sum().backward()
    assert a.grad.abs().sum() > 0 and b.grad.abs().sum() > 0
    ref_same = ref_loss.CosineEmbeddingLoss()(
        mx.np.array(PRED), mx.np.array(other), mx.np.array(lab)).asnumpy()
    onp.testing.assert_allclose(ref_same[lab == 1], 0.0, atol=1e-6)


def test_sdml_loss_matches_reference():
    x2 = RNG.standard_normal((4, 5)).astype(onp.float32)
    _run_both("SDMLLoss", {"smoothing_parameter": 0.2}, [PRED, x2], [0, 1])


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------
T, N, C, L = 12, 4, 6, 5
CTC_PRED = onp.random.default_rng(7).standard_normal((N, T, C)).astype(
    onp.float32)
CTC_LABEL = onp.random.default_rng(8).integers(1, C, (N, L)).astype(
    onp.float32)
CTC_LABEL[1, 2] = CTC_LABEL[1, 1]          # a repeated label
PRED_LEN = onp.array([12, 9, 7, 12], onp.int32)
LABEL_LEN = onp.array([5, 3, 2, 0], onp.int32)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("ragged", [False, True])
def test_ctc_loss_matches_reference(layout, ragged):
    pred = CTC_PRED if layout == "NTC" else CTC_PRED.swapaxes(0, 1).copy()
    label = CTC_LABEL if layout == "NTC" else CTC_LABEL.T.copy()
    kw = {"layout": layout, "label_layout": "TN" if layout == "TNC"
          else "NT"}
    call = {"pred_lengths": PRED_LEN, "label_lengths": LABEL_LEN} \
        if ragged else {}
    out = _run_both("CTCLoss", kw, [pred, label], [0], call, tol=1e-4)
    assert out.shape == (N,) and torch.isfinite(out).all()


def test_ctc_loss_sample_weight_and_torch_agree():
    """With ragged lengths the reference's recursion and torch's
    ``F.ctc_loss`` (blank 0, no reduction) give the same losses, but for
    an empty label, which the recursion counts twice (log 2 less), and
    a sample weight multiplies them."""
    sw = onp.array([1.0, 0.5, 2.0, 1.5], onp.float32)
    out = _run_both("CTCLoss", {}, [CTC_PRED, CTC_LABEL], [0],
                    {"pred_lengths": PRED_LEN, "label_lengths": LABEL_LEN,
                     "sample_weight": sw}, tol=1e-4)
    logp = torch.log_softmax(torch.from_numpy(CTC_PRED), -1).transpose(0, 1)
    expect = F.ctc_loss(logp, torch.from_numpy(CTC_LABEL).long(),
                        torch.from_numpy(PRED_LEN).long(),
                        torch.from_numpy(LABEL_LEN).long(), blank=0,
                        reduction="none", zero_infinity=False)
    expect = expect - torch.where(torch.from_numpy(LABEL_LEN) == 0,
                                  onp.log(2.0), 0.0)
    torch.testing.assert_close(out.detach(),
                               (expect * torch.from_numpy(sw)).float(),
                               atol=1e-4, rtol=1e-4)


def test_loss_argument_checks():
    with pytest.raises(ValueError, match="layout"):
        loss.CTCLoss(layout="CTN")
    with pytest.raises(ValueError, match="label_format"):
        loss.LogisticLoss(label_format="odd")
