"""The port's control flow (`npx.foreach`, `npx.while_loop`, `npx.cond`)
against the JAX package's, mirroring `tests/test_control_flow.py`.

Both contracts: eagerly a Python loop that reads its predicate on the
host (``while_loop`` returns exactly the steps it ran); traced (a
hybridized block, every call of `FusedTrainStep`, a serving cache's
function) ``while_loop`` runs ``max_iterations`` masked steps and
zero-pads, ``cond`` selects on the device, and no predicate is read on
the host.  The same numpy inputs go through both packages; f32, rtol
1e-5, atol 1e-6 (the bodies are a few elementwise ops and one small
product).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.gluon.block import HybridBlock as RefHybridBlock
from mxnet_tpu_torch import autograd, cpu, npx
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer, nn
from mxnet_tpu_torch.ops.invoke import is_tracing
from mxnet_tpu_torch.serve.cache import ExecutableCache
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def test_foreach_cumsum_eager():
    x = onp.arange(12, dtype="float32").reshape(4, 3)
    outs_r, final_r = mx.npx.foreach(lambda x, s: (x + s, x + s),
                                     mx.np.array(x), mx.np.zeros((3,)))
    outs, final = npx.foreach(lambda x, s: (x + s, x + s),
                              torch.from_numpy(x), torch.zeros(3))
    assert torch.equal(outs, torch.from_numpy(outs_r.asnumpy()))
    assert torch.equal(final, torch.from_numpy(final_r.asnumpy()))


def test_foreach_over_a_list_with_list_states():
    a = onp.arange(6, dtype="float32").reshape(3, 2)
    b = onp.ones((3, 2), "float32")

    def body(xs, st):
        s = st[0] + xs[0] * xs[1]
        return [s, xs[0]], [s]

    outs_r, fin_r = mx.npx.foreach(body, [mx.np.array(a), mx.np.array(b)],
                                   [mx.np.zeros((2,))])
    outs, fin = npx.foreach(body, [torch.from_numpy(a), torch.from_numpy(b)],
                            [torch.zeros(2)])
    for p, r in zip(outs + fin, list(outs_r) + list(fin_r)):
        assert torch.equal(p, torch.from_numpy(r.asnumpy()))


def test_foreach_gradient_flows_to_closure_params():
    w = torch.ones(3, requires_grad=True)
    data = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    with autograd.record():
        _, final = npx.foreach(lambda x, s: (x * w + s, x * w + s),
                               data, torch.zeros(3))
        loss = final.sum()
    loss.backward()
    assert torch.equal(w.grad, torch.tensor([3.0, 5.0, 7.0]))


class _RefScanner(RefHybridBlock):
    def __init__(self):
        super().__init__()
        self.proj = ref_nn.Dense(4, flatten=False, in_units=3)

    def forward(self, seq, init):
        return mx.npx.foreach(
            lambda x, s: ((lambda h: (h, h))(mx.npx.relu(self.proj(x)) + s)),
            seq, init)


class _Scanner(HybridBlock):
    def __init__(self):
        super().__init__()
        self.proj = nn.Dense(4, flatten=False, in_units=3)

    def forward(self, seq, init):
        return npx.foreach(
            lambda x, s: ((lambda h: (h, h))(npx.relu(self.proj(x)) + s)),
            seq, init)


def test_foreach_in_hybridized_block_matches_reference():
    ref = _RefScanner()
    ref.initialize()
    net = _Scanner()
    net.initialize(ctx=cpu())
    load_reference_params(net, {k: p.data().asnumpy()
                                for k, p in ref.collect_params().items()})
    seq = onp.random.default_rng(0).uniform(-1, 1, (5, 2, 3)) \
        .astype("float32")
    ref.hybridize()
    outs_r, final_r = ref(mx.np.array(seq), mx.np.zeros((2, 4)))
    outs_e, final_e = net(torch.from_numpy(seq), torch.zeros(2, 4))
    net.hybridize()
    outs_h, final_h = net(torch.from_numpy(seq), torch.zeros(2, 4))
    assert outs_h.shape == (5, 2, 4)
    assert torch.equal(outs_e, outs_h) and torch.equal(final_e, final_h)
    onp.testing.assert_allclose(outs_h.detach().numpy(), outs_r.asnumpy(),
                                rtol=RTOL, atol=ATOL)
    onp.testing.assert_allclose(final_h.detach().numpy(), final_r.asnumpy(),
                                rtol=RTOL, atol=ATOL)


def test_while_loop_eager():
    def cond_fn(i, s):
        return i < 5

    def func(i, s):
        return s + i, [i + 1, s + i]

    outs_r, (i_r, s_r) = mx.npx.while_loop(
        cond_fn, func, [mx.np.array(0.0), mx.np.array(0.0)],
        max_iterations=10)
    outs, (i, s) = npx.while_loop(
        cond_fn, func, [torch.tensor(0.0), torch.tensor(0.0)],
        max_iterations=10)
    assert outs.shape[0] == outs_r.shape[0] == 5   # exactly the steps run
    assert torch.equal(outs, torch.from_numpy(outs_r.asnumpy()))
    assert float(i) == float(i_r.asnumpy()) == 5.0
    assert float(s) == float(s_r.asnumpy()) == 10.0
    # max_iterations stops the eager loop too, and no step gives None
    outs, (i, _) = npx.while_loop(cond_fn, func,
                                  [torch.tensor(0.0), torch.tensor(0.0)],
                                  max_iterations=3)
    assert outs.shape[0] == 3 and float(i) == 3.0
    outs, final = npx.while_loop(cond_fn, func,
                                 [torch.tensor(9.0), torch.tensor(0.0)])
    assert outs is None and float(final[0]) == 9.0


class _RefLoop(RefHybridBlock):
    def forward(self, i, s):
        return mx.npx.while_loop(lambda i, s: i < 5,
                                 lambda i, s: (s + i, [i + 1, s + i]),
                                 [i, s], max_iterations=8)


class _Loop(HybridBlock):
    def forward(self, i, s):
        return npx.while_loop(lambda i, s: i < 5,
                              lambda i, s: (s + i, [i + 1, s + i]),
                              [i, s], max_iterations=8)


def _no_host_reads(monkeypatch):
    """Make any read of a tensor's value on the host raise."""
    def refuse(*_a, **_k):
        raise AssertionError("a predicate was read on the host")
    for name in ("__bool__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_while_loop_traced_pads_to_max(monkeypatch):
    ref = _RefLoop()
    ref.hybridize()
    outs_r, final_r = ref(mx.np.array(0.0), mx.np.array(0.0))
    net = _Loop()
    net.hybridize()
    with monkeypatch.context() as m:
        _no_host_reads(m)
        outs, final = net(torch.tensor(0.0), torch.tensor(0.0))
    assert outs.shape[0] == outs_r.shape[0] == 8
    assert torch.equal(outs, torch.from_numpy(outs_r.asnumpy()))
    assert float(final[0]) == float(final_r[0].asnumpy()) == 5.0
    assert float(final[1]) == float(final_r[1].asnumpy()) == 10.0
    assert (outs[5:] == 0).all()
    # the same block unhybridized takes the eager contract
    net.hybridize(False)
    assert net(torch.tensor(0.0), torch.tensor(0.0))[0].shape[0] == 5


class _RefCond(RefHybridBlock):
    def forward(self, x):
        return mx.npx.cond(x > 1, lambda v: v * 2, lambda v: v * 10, [x])


class _Cond(HybridBlock):
    def forward(self, x):
        return npx.cond(x > 1, lambda v: v * 2, lambda v: v * 10, [x])


@pytest.mark.parametrize("x", [3.0, 0.5])
def test_cond_eager_and_traced(x, monkeypatch):
    expect = float(mx.npx.cond(mx.np.array(x) > 1, lambda v: v * 2,
                               lambda v: v * 10, [mx.np.array(x)]).asnumpy())
    ref = _RefCond()
    ref.hybridize()
    assert float(ref(mx.np.array(x)).asnumpy()) == expect
    taken = []

    def then(v):
        taken.append("then")
        return v * 2

    def other(v):
        taken.append("else")
        return v * 10

    out = npx.cond(torch.tensor(x) > 1, then, other, [torch.tensor(x)])
    assert float(out) == expect and len(taken) == 1      # one branch
    net = _Cond()
    net.hybridize()
    with monkeypatch.context() as m:
        _no_host_reads(m)
        out = net(torch.tensor(x))
    assert float(out) == expect


def test_while_loop_requires_max_iterations_in_trace():
    class Loop(HybridBlock):
        def forward(self, i):
            return npx.while_loop(lambda i: i < 5, lambda i: (i, [i + 1]),
                                  [i])

    net = Loop()
    net.hybridize()
    with pytest.raises(ValueError, match="max_iterations"):
        net(torch.tensor(0.0))


class _LossWithLoop(HybridBlock):
    """A loss whose forward runs a while_loop over a parameter; returns
    (loss, the loop's outputs)."""

    def __init__(self):
        super().__init__()
        self.proj = nn.Dense(2, flatten=False, in_units=2)

    def forward(self, x):
        outs, (_, s) = npx.while_loop(
            lambda i, s: i < 3, lambda i, s: (self.proj(s), [i + 1,
                                                          self.proj(s)]),
            [torch.zeros((), device=x.device), x], max_iterations=6)
        return (s * s).sum(), outs


def test_fused_train_step_takes_the_traced_contract_from_its_first_call():
    net = _LossWithLoop()
    net.initialize(ctx=cpu())
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.01})
    step = FusedTrainStep(net, trainer)
    x = torch.ones(4, 2)
    shapes = [tuple(step(x, batch_size=4)[1].shape) for _ in range(3)]
    assert shapes == [(6, 4, 2)] * 3
    # eagerly, the same block gives exactly the 3 steps it ran
    with autograd.record():
        assert net(x)[1].shape == (3, 4, 2)


def test_serving_cache_runs_its_function_traced(monkeypatch):
    seen = []

    def fn(x):
        seen.append(is_tracing())
        return npx.cond(x.sum() > 0, lambda v: v + 1, lambda v: v - 1, [x])

    cache = ExecutableCache(fn, device=torch.device("cpu"))
    with monkeypatch.context() as m:
        _no_host_reads(m)
        out = cache([torch.ones(3)])
    assert torch.equal(out, torch.full((3,), 2.0)) and seen == [True]
    assert not is_tracing()
