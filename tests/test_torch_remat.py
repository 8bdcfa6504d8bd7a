"""``npx.remat``, the port's rematerialization boundary.

The boundary runs on torch's non-reentrant checkpointing: the backward
recomputes the wrapped forward instead of keeping its intermediates.
What the reference guarantees, held here on the CPU:

- within the port, bitwise: a BERT with ``remat=True`` gives the loss
  and every gradient of the same BERT without it, from the same weights
  and generator, with dropout on (model dropout and the flash path's
  attention dropout): the recompute is handed the seed tensors its
  first run drew (`ops.seeds.DrawTape`), so it applies the same masks;
  eagerly, through `FusedTrainStep`'s body, and through its capture
  (a stand-in for the CUDA graph), where the recompute reads the rows
  the forward took and takes none: one `SeedTable` row a draw site;
- fresh masks every call; a second backward through the same graph
  replays the same draws;
- auxiliary updates once: BatchNorm's running statistics inside the
  boundary move as without it, not twice, also with deferred shapes;
- a function that is not a Block warns under ``record()``, and the
  parameters it closes over get the gradients the reference gives them:
  none (zeros) eagerly, while its tensor arguments get theirs, and
  their true gradients inside `FusedTrainStep`, as in the reference's
  traced step (one SGD step moves the weights as the reference's does);
- against the reference: ``TransformerEncoder(remat=True)`` in both
  packages (dropout 0, f32) gives the reference's output and gradients
  (input and every parameter) within atol = rtol = 1e-4 of the largest
  magnitude (true-f32 products on both sides, differing in summation
  order only, as `test_torch_train.py` allows).
"""
import warnings

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_autograd
from mxnet_tpu import npx as ref_npx
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.models import TransformerEncoder as RefTransformerEncoder
from mxnet_tpu_torch import autograd, cpu, npx
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer, nn
from mxnet_tpu_torch.models import BertForPretraining, TransformerEncoder
from mxnet_tpu_torch.ops import capture
from mxnet_tpu_torch.ops.invoke import set_seed_table
from mxnet_tpu_torch.ops.seeds import SeedTable
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

CFG = dict(vocab_size=50, units=32, hidden_size=64, num_layers=2,
           num_heads=4, max_length=64, dropout=0.1)
B, T = 2, 32


class _Loss(HybridBlock):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, tokens, segments, labels, valid_mask):
        mlm_logits, nsp_logits = self.m(tokens, segments, valid_mask)
        logp = npx.log_softmax(mlm_logits.float(), axis=-1)
        picked = npx.pick(logp, labels, axis=-1)
        m = valid_mask.float()
        return -(picked * m).sum() / m.sum() - \
            npx.log_softmax(nsp_logits.float())[:, 0].mean()


def _batch(seed=0):
    rng = onp.random.default_rng(seed)
    lens = onp.array([T, T - 9])
    return [torch.from_numpy(rng.integers(0, CFG["vocab_size"], (B, T))
                             .astype(onp.int32)),
            torch.zeros(B, T, dtype=torch.int32),
            torch.from_numpy(rng.integers(0, CFG["vocab_size"], (B, T))
                             .astype(onp.int32)),
            torch.from_numpy((onp.arange(T)[None] < lens[:, None])
                             .astype(onp.int32))]


def _model(remat, use_flash):
    net = BertForPretraining(remat=remat, use_flash=use_flash, **CFG)
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(0))
    return _Loss(net)


def _grads(mod, seed=3):
    table = SeedTable()
    prev = set_seed_table(table)
    try:
        with autograd.record(generator=torch.Generator().manual_seed(seed)):
            loss = mod(*_batch())
        loss.backward()
    finally:
        set_seed_table(prev)
    return loss, {k: p.grad().clone() for k, p in
                  mod.collect_params().items()}, table.kinds


@pytest.mark.parametrize("use_flash", [True, False])
def test_remat_is_bitwise_plain_with_dropout(use_flash):
    loss_p, g_p, kinds_p = _grads(_model(False, use_flash))
    loss_r, g_r, kinds_r = _grads(_model(True, use_flash))
    assert torch.equal(loss_p, loss_r)
    for k in g_p:
        assert torch.equal(g_p[k], g_r[k]), k
    # each draw site once: the recompute draws nothing
    assert kinds_r == kinds_p
    expect = ["dropout"] + (["attention", "dropout", "dropout"] if use_flash
                            else ["dropout", "dropout", "dropout"]) * 2
    assert kinds_p == expect
    assert sum(g.abs().sum() for g in g_r.values()) > 0


def test_remat_masks_are_fresh_each_call_and_replayed_within_one():
    mod = _model(True, True)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(2):
        with autograd.record(generator=gen):
            losses.append(mod(*_batch()))
    assert not torch.equal(losses[0], losses[1])
    # two backwards through one graph recompute twice, with the same bits
    with autograd.record(generator=torch.Generator().manual_seed(2)):
        loss = mod(*_batch())
    loss.backward(retain_graph=True)
    first = {k: p.grad().clone() for k, p in mod.collect_params().items()}
    loss.backward()
    for k, p in mod.collect_params().items():
        assert torch.equal(p.grad(), first[k]), k


def test_remat_fused_step_body_is_bitwise_plain():
    """`FusedTrainStep` on the CPU (every call runs the step's body):
    three LAMB steps with and without remat give the same losses and
    weights bitwise."""
    results = []
    for remat in (False, True):
        mod = _model(remat, True)
        trainer = Trainer(mod.collect_params(), "lamb",
                          {"learning_rate": 1e-2})
        step = FusedTrainStep(mod, trainer,
                              generator=torch.Generator().manual_seed(4))
        losses = [step(*_batch(i), batch_size=B) for i in range(3)]
        results.append((losses, {k: p.data().clone() for k, p in
                                 mod.collect_params().items()}))
    (l0, w0), (l1, w1) = results
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k


class _StandIn(capture.Graph):
    """A graph whose capture runs the function once and whose replay
    runs nothing."""

    def _record(self, fn):
        return fn()

    def _launch(self):
        pass


def test_remat_capture_takes_one_row_a_draw_site(monkeypatch):
    """Captured, the forward's draws take rows of the static seed buffer
    and the recompute reads those rows, taking none of its own: the
    capture's draws match the eager first call's kinds (it raises
    otherwise), one row a site, and a replay draws one set of words a
    site."""
    monkeypatch.setattr(capture, "Graph", _StandIn)
    monkeypatch.setattr(capture, "capturable", lambda device: True)
    mod = _model(True, True)
    trainer = Trainer(mod.collect_params(), "adam", {"learning_rate": 1e-3})
    step = FusedTrainStep(mod, trainer,
                          generator=torch.Generator().manual_seed(5))
    served = []
    real_take = SeedTable.take

    def take(table, kind, words, device):
        out = real_take(table, kind, words, device)
        served.append(out)
        return out

    monkeypatch.setattr(SeedTable, "take", take)
    for _ in range(3):
        step(*_batch(), batch_size=B)
    assert step.captures == 1
    entry, = step._graphs.values()
    n = 1 + 3 * CFG["num_layers"]
    assert len(entry.kinds) == n and entry.buf.numel() >= 2 * n
    # the eager call and the capture took n slots each, nothing more
    assert len(served) == 2 * n
    rows = served[n:]
    assert all(r.data_ptr() == entry.buf[2 * i:].data_ptr()
               for i, r in enumerate(rows))


def _bn_net():
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=8, flatten=False), nn.BatchNorm(axis=-1))
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(0))
    return net


def test_remat_batchnorm_updates_once():
    """Running statistics inside the boundary move once, as without it
    (the shapes still deferred at the first call: settled by a forward
    without gradients in predict mode, which leaves them alone); the
    gradients agree bitwise."""
    x = torch.from_numpy(onp.random.default_rng(0).standard_normal(
        (4, 8)).astype(onp.float32)).requires_grad_()
    out = {}
    for remat in (False, True):
        net = _bn_net()
        bn = net[1]
        with autograd.record():
            y = npx.remat(net)(x) if remat else net(x)
            (y ** 2).sum().backward()
        out[remat] = (bn.running_mean.data().clone(),
                      bn.running_var.data().clone(), x.grad.clone(),
                      net[0].weight.grad().clone())
        x.grad = None
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
    assert not torch.equal(out[True][0], torch.zeros(8))


def test_remat_batchnorm_defers_into_the_fused_step_scope():
    """Under `FusedTrainStep` the boundary's running statistics go to the
    step's aux scope (committed under its verdict), once."""
    results = []
    for remat in (False, True):
        net = _bn_net()

        class M(HybridBlock):
            def __init__(self, inner, wrap):
                super().__init__()
                self.inner = inner
                self._wrap = wrap

            def forward(self, a):
                y = npx.remat(self.inner)(a) if self._wrap else self.inner(a)
                return (y ** 2).mean()

        mod = M(net, remat)
        trainer = Trainer(mod.collect_params(), "sgd",
                          {"learning_rate": 0.1})
        step = FusedTrainStep(mod, trainer)
        for i in range(2):
            step(torch.ones(4, 8) * (i + 1), batch_size=4)
        results.append([p.data().clone() for p in
                        mod.collect_params().values()])
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_remat_closure_warns_and_gives_closed_over_params_no_gradient():
    """The reference's behaviour, checked against it: a warning under
    ``record()``; the input's gradient flows; the closed-over Dense gets
    none (its gradient reads zeros on both sides)."""
    rng = onp.random.default_rng(0)
    x_np = rng.standard_normal((2, 4)).astype(onp.float32)
    ref = ref_nn.Dense(4, in_units=4, flatten=False)
    ref.initialize()
    start = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    net = nn.Dense(4, in_units=4, flatten=False).initialize(ctx=cpu())
    load_reference_params(net, start)

    x_r = mx.np.array(x_np)
    x_r.attach_grad()
    with ref_autograd.record():
        with pytest.warns(UserWarning, match="non-Block"):
            y_r = ref_npx.remat(lambda a: ref(a) * 2.0)(x_r)
        y_r.sum().backward()
    x = torch.from_numpy(x_np).requires_grad_()
    with autograd.record():
        with pytest.warns(UserWarning, match="non-Block"):
            y = npx.remat(lambda a: net(a) * 2.0)(x)
        y.sum().backward()
    onp.testing.assert_allclose(y.detach().numpy(), y_r.asnumpy(),
                                atol=1e-6)
    onp.testing.assert_allclose(x.grad.numpy(), x_r.grad.asnumpy(),
                                atol=1e-6)
    for k, p in net.collect_params().items():
        expect = ref.collect_params()[k].grad().asnumpy()
        assert onp.array_equal(p.grad().numpy(), expect), k
        assert not expect.any()
    # outside record(): no warning, and a Block warns never
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        npx.remat(lambda a: net(a))(x)
        with autograd.record():
            npx.remat(net)(x)


def test_remat_closure_in_the_fused_step_trains_as_the_reference():
    """Inside the reference's traced step the closed-over parameters are
    differentiated; the port's `FusedTrainStep` does the same: one SGD
    step gives the reference's weights (atol 1e-6, f32)."""
    from mxnet_tpu.gluon import FusedTrainStep as RefFusedTrainStep
    from mxnet_tpu.gluon import Trainer as RefTrainer
    from mxnet_tpu.gluon.block import HybridBlock as RefHybridBlock

    x_np = onp.random.default_rng(1).standard_normal((2, 4)).astype(
        onp.float32)
    ref_inner = ref_nn.Dense(4, in_units=4, flatten=False)

    class RefM(RefHybridBlock):
        def __init__(self):
            super().__init__()
            self.inner = ref_inner

        def forward(self, a):
            return (ref_npx.remat(lambda z: self.inner(z) * 2.0)(a) ** 2).sum()

    class M(HybridBlock):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, a):
            return (npx.remat(lambda z: self.inner(z) * 2.0)(a) ** 2).sum()

    ref = RefM()
    ref.initialize()
    start = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    mod = M(nn.Dense(4, in_units=4, flatten=False)).initialize(ctx=cpu())
    load_reference_params(mod, start)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        RefFusedTrainStep(ref, RefTrainer(ref.collect_params(), "sgd", {
            "learning_rate": 0.1}))(mx.np.array(x_np), batch_size=1)
        FusedTrainStep(mod, Trainer(mod.collect_params(), "sgd", {
            "learning_rate": 0.1}))(torch.from_numpy(x_np), batch_size=1)
    for k, p in mod.collect_params().items():
        want = ref.collect_params()[k].data().asnumpy()
        assert not onp.allclose(want, start[k]), k
        onp.testing.assert_allclose(p.data().detach().numpy(), want,
                                    atol=1e-6, err_msg=k)


def test_remat_outside_autograd_is_the_plain_forward():
    mod = _model(True, True)
    plain = _model(False, True)
    with torch.no_grad():
        a = mod.m(*(_batch()[i] for i in (0, 1, 3)))
        b = plain.m(*(_batch()[i] for i in (0, 1, 3)))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mask", [False, True])
def test_transformer_encoder_remat_matches_the_reference(mask):
    kw = dict(num_layers=2, units=16, hidden_size=32, num_heads=2,
              dropout=0.0)
    rng = onp.random.default_rng(11)
    x_np = rng.standard_normal((2, 8, 16)).astype(onp.float32)
    w_np = rng.standard_normal((2, 8, 16)).astype(onp.float32)
    m_np = (onp.arange(8)[None] < onp.array([[8], [5]])).astype(onp.int32)
    mx.random.seed(3)
    ref = RefTransformerEncoder(remat=True, **kw)
    ref.initialize()
    ref(mx.np.array(x_np))
    net = TransformerEncoder(remat=True, **kw).initialize(ctx=cpu())
    load_reference_params(net, {k: p.data().asnumpy() for k, p in
                                ref.collect_params().items()})

    x_r = mx.np.array(x_np)
    x_r.attach_grad()
    m_r = mx.np.array(m_np) if mask else None
    with ref_autograd.record():
        out_r = ref(x_r, m_r)
        loss_r = (out_r * mx.np.array(w_np)).sum()
    loss_r.backward()
    x = torch.from_numpy(x_np).requires_grad_()
    m = torch.from_numpy(m_np) if mask else None
    with autograd.record():
        out = net(x, m)
        loss = (out * torch.from_numpy(w_np)).sum()
    loss.backward()

    def close(got, want, what):
        mag = float(onp.abs(want).max())
        onp.testing.assert_allclose(got, want, atol=1e-4 * mag, rtol=1e-4,
                                    err_msg=what)

    close(out.detach().numpy(), out_r.asnumpy(), "out")
    close(x.grad.numpy(), x_r.grad.asnumpy(), "input grad")
    ref_params = ref.collect_params()
    for k, p in net.collect_params().items():
        if k.endswith("attention.key.bias"):
            continue                      # softmax-invariant: noise only
        close(p.grad().numpy(), ref_params[k].grad().asnumpy(), k)
