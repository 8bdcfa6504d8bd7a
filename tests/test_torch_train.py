"""The port's training path against the JAX package's.

A small `BertForPretraining` (vocab 100, units 64, FFN 128, 2 layers, 4
heads, T 128, dropout 0, f32) is built in both packages; the JAX
model's weights are carried into the port's with
`load_reference_params`.  Both run the repo's pretraining loss (masked
MLM + NSP, as `benchmark/bert_pretrain_bench.py` defines it) on the
same tokens, labels and ragged valid lengths, on the CPU (the JAX flash
kernels in interpret mode, the port's through their plain versions).
Compared: the forward logits, one backward's gradient for every
parameter, and three Adam steps through `FusedTrainStep` and through
the eager ``record`` / ``backward`` / ``Trainer.step`` path (losses and
final weights).  Beside them: the optimizers' ``update_math`` against
the reference's, ``grad_req`` semantics, the non-finite step guard and
the train-mode dropout keep rate.

Tolerances (f32 throughout, true-f32 products on both sides, which
differ only in summation order):
- logits and losses: values of order 1-5 through 2 layers of width
  64-128 products, two layer norms and a vocab product: a few 1e-6;
  atol = rtol = 1e-4.
- gradients: each compared with atol = 1e-4 x the largest magnitude of
  that parameter's reference gradient and rtol = 1e-3.  Long sums (over
  B*T = 512 rows for the weights) and cancelling terms leave absolute
  errors of order 1e-7 of that magnitude; the margin still catches a
  wrong mask, a wrong tie or a missing path (errors of order 1e-1 or
  more of the magnitude).
- weights after 3 Adam steps at lr 1e-3: Adam moves each element by
  about lr * sign(g) per step, so a gradient that differs only in
  rounding moves the weight by well under 1e-6; atol = 1e-5.  The
  attention key biases are the exception: softmax is invariant to a
  per-row constant, so their gradient is zero but for rounding noise
  (checked below 1e-6 on both sides), and Adam turns that noise into
  steps of either sign; they are left out of the weight comparison.
- update_math: f32 elementwise, same formula, atol = rtol = 1e-6; bf16
  weights round the result to bf16 on both sides, so they may differ by
  one bf16 ulp (rtol 2^-7).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_autograd
from mxnet_tpu import optimizer as ref_opt
from mxnet_tpu.gluon import FusedTrainStep as RefFusedTrainStep
from mxnet_tpu.gluon import Trainer as RefTrainer
from mxnet_tpu.gluon.block import HybridBlock as RefHybridBlock
from mxnet_tpu.models import BertForPretraining as RefBertForPretraining
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd, cpu, npx
from mxnet_tpu_torch import optimizer as port_opt
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Parameter
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.models import BertForPretraining
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=128, dropout=0.0)
B, T = 4, 128
LR = 1e-3
STEPS = 3


class RefPretrainLoss(RefHybridBlock):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, tokens, segments, labels, valid_mask):
        mlm_logits, nsp_logits = self.m(tokens, segments, valid_mask)
        logp = mx.npx.log_softmax(mlm_logits.astype("float32"), axis=-1)
        picked = mx.npx.pick(logp, labels, axis=-1)
        m = valid_mask.astype("float32")
        mlm = -(picked * m).sum() / m.sum()
        nsp = -mx.np.mean(
            mx.npx.log_softmax(nsp_logits.astype("float32"))[:, 0])
        return mlm + nsp


class PretrainLoss(HybridBlock):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, tokens, segments, labels, valid_mask):
        mlm_logits, nsp_logits = self.m(tokens, segments, valid_mask)
        logp = npx.log_softmax(mlm_logits.float(), axis=-1)
        picked = npx.pick(logp, labels, axis=-1)
        m = valid_mask.float()
        mlm = -(picked * m).sum() / m.sum()
        nsp = -npx.log_softmax(nsp_logits.float())[:, 0].mean()
        return mlm + nsp


def _batch(seed=0):
    rng = onp.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], (B, T)).astype(onp.int32)
    segments = (onp.arange(T)[None, :] >= 40).astype(onp.int32).repeat(B, 0)
    labels = rng.integers(0, CFG["vocab_size"], (B, T)).astype(onp.int32)
    lens = onp.random.RandomState(11).randint(T // 2, T + 1, size=B)
    valid = (onp.arange(T)[None, :] < lens[:, None]).astype(onp.int32)
    return tokens, segments, labels, valid


def _reference(use_flash):
    mx.random.seed(0)
    net = RefBertForPretraining(use_flash=use_flash, **CFG)
    net.initialize()
    net(mx.np.zeros((1, T), dtype="int32"))     # finish deferred init
    return net


def _params_np(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _ref_args(batch):
    return [mx.np.array(a, dtype="int32") for a in batch]


def _port_args(batch):
    return [torch.from_numpy(a) for a in batch]


@pytest.fixture(scope="module", params=[True, False],
                ids=["flash", "dense"])
def models(request):
    ref = _reference(request.param)
    return request.param, ref, _params_np(ref)


def _fresh(models):
    """(ref loss block, port loss block) from the same starting weights."""
    use_flash, ref, start = models
    for name, p in ref.collect_params().items():
        p.set_data(mx.np.array(start[name]))
    net = BertForPretraining(use_flash=use_flash, **CFG).initialize(ctx=cpu())
    load_reference_params(net, start)
    return RefPretrainLoss(ref), PretrainLoss(net)


def test_parameter_names_match_reference(models):
    _use_flash, ref, _ = models
    net = BertForPretraining(use_flash=True, **CFG).initialize(ctx=cpu())
    mine = {k: p.shape for k, p in net.collect_params().items()}
    theirs = {k: tuple(p.shape) for k, p in ref.collect_params().items()}
    assert mine == theirs
    assert net.mlm_ln._epsilon == 1e-5


def test_forward_logits_match_reference(models):
    ref_mod, mod = _fresh(models)
    tokens, segments, _labels, valid = _batch(1)
    mlm_r, nsp_r = ref_mod.m(*_ref_args((tokens, segments, valid)))
    with torch.no_grad():
        mlm_p, nsp_p = mod.m(*_port_args((tokens, segments, valid)))
    assert mlm_p.shape == (B, T, CFG["vocab_size"]) and nsp_p.shape == (B, 2)
    onp.testing.assert_allclose(mlm_p.numpy(), mlm_r.asnumpy(),
                                atol=ATOL, rtol=RTOL)
    onp.testing.assert_allclose(nsp_p.numpy(), nsp_r.asnumpy(),
                                atol=ATOL, rtol=RTOL)


def test_gradients_match_reference(models):
    ref_mod, mod = _fresh(models)
    batch = _batch(2)
    with ref_autograd.record():
        loss_r = ref_mod(*_ref_args(batch))
    loss_r.backward()
    with autograd.record():
        loss_p = mod(*_port_args(batch))
    loss_p.backward()
    onp.testing.assert_allclose(loss_p.item(), float(loss_r.asnumpy()),
                                atol=ATOL, rtol=RTOL)
    ref_params = ref_mod.collect_params()
    for name, p in mod.collect_params().items():
        expect = ref_params[name].grad().asnumpy()
        got = p.grad().numpy()
        if name.endswith("attention.key.bias"):
            # zero but for rounding noise on both sides (see the header)
            assert onp.abs(got).max() < 1e-6 and onp.abs(expect).max() < 1e-6
            continue
        scale = float(onp.abs(expect).max())
        onp.testing.assert_allclose(got, expect, atol=1e-4 * scale,
                                    rtol=1e-3, err_msg=name)


def _ref_train(ref_mod, batch, fused):
    trainer = RefTrainer(ref_mod.collect_params(), "adam",
                         {"learning_rate": LR})
    args = _ref_args(batch)
    losses = []
    step = RefFusedTrainStep(ref_mod, trainer) if fused else None
    for _ in range(STEPS):
        if fused:
            loss = step(*args, batch_size=B)
        else:
            with ref_autograd.record():
                loss = ref_mod(*args)
            loss.backward()
            trainer.step(B)
        losses.append(float(loss.asnumpy()))
    return losses


def _port_train(mod, batch, fused):
    trainer = Trainer(mod.collect_params(), "adam", {"learning_rate": LR})
    args = _port_args(batch)
    losses = []
    step = FusedTrainStep(mod, trainer) if fused else None
    for _ in range(STEPS):
        if fused:
            loss = step(*args, batch_size=B)
        else:
            with autograd.record():
                loss = mod(*args)
            loss.backward()
            trainer.step(B)
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_adam_steps_match_reference(models, fused):
    ref_mod, mod = _fresh(models)
    batch = _batch(3)
    expect = _ref_train(ref_mod, batch, fused)
    got = _port_train(mod, batch, fused)
    onp.testing.assert_allclose(got, expect, atol=ATOL, rtol=RTOL)
    assert got[-1] < got[0]
    ref_params = ref_mod.collect_params()
    for name, p in mod.collect_params().items():
        if name.endswith("attention.key.bias"):
            continue                 # zero gradient but for rounding noise
        onp.testing.assert_allclose(p.data().detach().numpy(),
                                    ref_params[name].data().asnumpy(),
                                    atol=1e-5, rtol=0, err_msg=name)


def test_tied_decoder_sums_both_paths():
    """``word_embed.weight`` is one parameter used by the gather and by
    the MLM product; its gradient is the sum over both uses."""
    net = BertForPretraining(use_flash=True, **CFG).initialize(ctx=cpu())
    tokens, segments, labels, valid = _port_args(_batch(4))
    emb = net.collect_params()["bert.word_embed.weight"]
    with autograd.record():
        mlm, _nsp = net(tokens, segments, valid)
    grad_total, = torch.autograd.grad((mlm * mlm).sum(), [emb.data()])
    with autograd.record():
        seq, _ = net.bert(tokens, segments, valid)
        h = net.mlm_ln(net.mlm_act(net.mlm_transform(seq)))
        w = emb.data().detach().requires_grad_()
        mlm2 = torch.matmul(h, w.t()) + net.mlm_bias.data()
    grad_decoder, = torch.autograd.grad((mlm2 * mlm2).sum(), [w])
    grad_gather = grad_total - grad_decoder
    assert float(grad_decoder.abs().max()) > 0
    assert float(grad_gather.abs().max()) > 0


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
OPTIMIZERS = {
    "adam": {"learning_rate": 0.01, "wd": 0.01},
    "adamw": {"learning_rate": 0.01, "wd": 0.01},
    "lamb": {"learning_rate": 0.01, "wd": 0.01, "lower_bound": 0.1,
             "upper_bound": 10.0},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_math_matches_reference(name, dtype):
    import jax.numpy as jnp

    rng = onp.random.default_rng(len(name))
    w = rng.standard_normal((33, 17)).astype(onp.float32)
    g = rng.standard_normal((33, 17)).astype(onp.float32)
    mean = rng.standard_normal((33, 17)).astype(onp.float32) * 0.1
    var = rng.random((33, 17)).astype(onp.float32) * 0.01
    ref = ref_opt.create(name, **OPTIMIZERS[name])
    mine = port_opt.create(name, **OPTIMIZERS[name])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for t in (1, 7):
        nw_r, (m_r, v_r) = ref.update_math(
            jnp.asarray(w).astype(jdt), jnp.asarray(g).astype(jdt),
            (jnp.asarray(mean), jnp.asarray(var)), 0.01, 0.01, t)
        nw_p, (m_p, v_p) = mine.update_math(
            torch.from_numpy(w).to(tdt), torch.from_numpy(g).to(tdt),
            (torch.from_numpy(mean), torch.from_numpy(var)), 0.01, 0.01, t)
        assert nw_p.dtype == tdt and m_p.dtype == torch.float32
        onp.testing.assert_allclose(m_p.numpy(), onp.asarray(m_r),
                                    atol=1e-6, rtol=1e-6)
        onp.testing.assert_allclose(v_p.numpy(), onp.asarray(v_r),
                                    atol=1e-6, rtol=1e-6)
        rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
        onp.testing.assert_allclose(
            nw_p.float().numpy(), onp.asarray(nw_r.astype(jnp.float32)),
            atol=1e-6, rtol=rtol)


def test_optimizer_update_matches_reference():
    """`Optimizer.update`: rescale and clip in the gradient's dtype
    (`preprocess_grad`), per-index update counts, lr multipliers, the
    weight and states updated in place."""
    rng = onp.random.default_rng(3)
    w, g = (rng.standard_normal(5).astype(onp.float32) for _ in range(2))
    kw = dict(learning_rate=0.1, rescale_grad=0.5, clip_gradient=0.3)
    ref = ref_opt.create("adam", **kw)
    ref.set_lr_mult({0: 0.5})
    w_r, g_r = mx.np.array(w), mx.np.array(g)
    st_r = ref.create_state(0, w_r)
    p = Parameter("w", shape=(5,), lr_mult=0.5)
    p.initialize(ctx=cpu())
    p.set_data(w)
    mine = port_opt.create("adam", param_dict={0: p}, **kw)
    st_p = mine.create_state(0, p.data())
    for _ in range(2):
        ref.update(0, w_r, g_r, st_r)
        mine.update(0, p.data(), torch.from_numpy(g), st_p)
    assert mine._index_update_count[0] == 2 and mine.num_update == 2
    assert mine._get_lr(0) == pytest.approx(0.05)
    onp.testing.assert_allclose(p.data().detach().numpy(), w_r.asnumpy(),
                                atol=1e-6, rtol=1e-6)
    onp.testing.assert_allclose(st_p[0].numpy(), st_r[0].asnumpy(),
                                atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="Cannot find optimizer"):
        port_opt.create("nosuch")


# ---------------------------------------------------------------------------
# gradients, guards, dropout
# ---------------------------------------------------------------------------
def _linear(grad_req):
    p = Parameter("w", shape=(4,), grad_req=grad_req)
    p.initialize(ctx=cpu())
    p.set_data(onp.arange(4, dtype=onp.float32))
    return p


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
def test_grad_req_semantics(grad_req):
    p = _linear(grad_req)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    for _ in range(2):
        with autograd.record():
            loss = (p.data() * x).sum() + (p.data() * x).sum()  # two paths
        if grad_req == "null":
            assert not loss.requires_grad
            with pytest.raises(RuntimeError, match="grad_req='null'"):
                p.grad()
            return
        loss.backward()
    expect = 2 * x * (2 if grad_req == "add" else 1)
    assert torch.equal(p.grad(), expect)
    assert p.data().is_leaf
    p.zero_grad()
    assert torch.equal(p.grad(), torch.zeros(4))
    p.cast("bfloat16")
    assert p.data().is_leaf and p.data().requires_grad
    p.set_data(onp.ones(4))
    assert p.data().is_leaf and p.data().dtype == torch.bfloat16


def test_autograd_scopes_and_backward():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording() and not autograd.is_training()
            assert not torch.is_grad_enabled()
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    p = _linear("write")
    with autograd.record():
        y = p.data() * 3.0                       # a non-scalar head
    autograd.backward(y)
    assert torch.equal(p.grad(), torch.full((4,), 3.0))
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        with autograd.record(generator=object()):
            pass


def _tiny_trainer(clip=None, dropout=0.0):
    """A 1-layer, 16-unit pretraining model, its Adam trainer and a
    (2, 16) batch."""
    net = BertForPretraining(vocab_size=30, units=16, hidden_size=32,
                             num_layers=1, num_heads=2, max_length=16,
                             dropout=dropout, use_flash=True).initialize(
        ctx=cpu(), generator=torch.Generator().manual_seed(5))
    mod = PretrainLoss(net)
    kw = {"learning_rate": 0.01}
    if clip is not None:
        kw["clip_gradient"] = clip
    trainer = Trainer(mod.collect_params(), "adam", kw)
    rng = onp.random.default_rng(6)
    batch = (rng.integers(0, 30, (2, 16)).astype(onp.int32),
             onp.zeros((2, 16), onp.int32),
             rng.integers(0, 30, (2, 16)).astype(onp.int32),
             onp.ones((2, 16), onp.int32))
    return mod, trainer, _port_args(batch)


def test_nonfinite_step_leaves_weights_and_states_bitwise():
    mod, trainer, args = _tiny_trainer(clip=1.0)
    step = FusedTrainStep(mod, trainer)
    step(*args, batch_size=2)
    assert bool(step.last_step_finite)
    params = mod.collect_params()
    before = {k: p.data().detach().clone() for k, p in params.items()}
    states = {i: tuple(s.clone() for s in st)
              for i, st in trainer._states.items()}
    trainer._scale = float("nan")              # every gradient goes NaN
    step(*args, batch_size=2)
    assert not bool(step.last_step_finite)
    assert step.last_step_finite.device.type == "cpu"
    for k, p in params.items():
        assert torch.equal(p.data(), before[k]), k
    for i, st in trainer._states.items():
        for a, b in zip(st, states[i]):
            assert torch.equal(a, b)
    trainer._scale = 1.0
    step(*args, batch_size=2)
    assert bool(step.last_step_finite)


def test_train_mode_keep_rate():
    x = torch.ones(256, 256)
    with autograd.train_mode(generator=torch.Generator().manual_seed(3)):
        y = npx.dropout(x, p=0.1)
        y2 = npx.dropout(x, p=0.1)
    kept = float((y != 0).float().mean())
    # 65536 Bernoulli(0.9) draws: the standard deviation of the rate is
    # 0.0012, so 0.9 +- 0.006 is five of them
    assert abs(kept - 0.9) < 0.006
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert not torch.equal(y, y2)                # a fresh seed per call
    with autograd.predict_mode():
        assert npx.dropout(x, p=0.1) is x
    with autograd.train_mode():
        with pytest.raises(ValueError, match="Generator"):
            npx.dropout(x, p=0.1)


def test_dropout_training_is_seeded():
    """Two runs with the same generator seed train identically; the
    flash kernels' dropout seed words come from it on the host."""
    losses = []
    for _ in range(2):
        mod, trainer, args = _tiny_trainer(dropout=0.1)
        step = FusedTrainStep(mod, trainer,
                              generator=torch.Generator().manual_seed(9))
        losses.append([step(*args, batch_size=2).item() for _ in range(2)])
    assert losses[0] == losses[1]


def test_single_device_contract():
    mod, trainer, _args = _tiny_trainer()
    # a distributed store's name is taken (its store reduces copies in
    # one process); recipes, meshes with a tensor-parallel axis and
    # compression name their queue items
    assert Trainer(mod.collect_params(), "adam",
                   kvstore="dist_sync").kvstore.type == "tpu_ici"
    with pytest.raises(NotImplementedError, match="A8"):
        FusedTrainStep(mod, trainer, recipe="dp2.tp2")
    with pytest.raises(NotImplementedError, match="A8"):
        FusedTrainStep(mod, trainer, mesh=mxt.parallel.Mesh(
            onp.arange(2).reshape(1, 2), ("dp", "tp")))
    with pytest.raises(NotImplementedError, match="A7c"):
        Trainer(mod.collect_params(), "adam",
                compression_params={"type": "2bit"})
    # loss scaling is ported: an explicit scaler is taken, not refused
    scaler = mxt.amp.LossScaler()
    assert FusedTrainStep(mod, trainer, scaler=scaler)._scaler is scaler
    assert trainer.learning_rate == 0.01
    trainer.set_learning_rate(0.02)
    assert trainer.learning_rate == 0.02
    assert isinstance(trainer.optimizer, mxt.optimizer.Adam)
