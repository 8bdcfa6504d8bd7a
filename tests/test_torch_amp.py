"""The port's mixed precision (``amp``) against the JAX package's.

``amp.init`` patches module globals in both packages, and ``xdist
--dist loadfile`` runs this file's tests in one worker beside others, so
every test that calls it undoes it (both packages' ``amp._reset()``) in
a ``finally``.  Held here, on the CPU, on the same numpy inputs:

- the lists: every entry the port has gives, under ``amp.init("float16")``,
  the output dtype the reference's gives, for f32 and for f16 inputs,
  with values within f16's rounding (atol = rtol = 2e-3 where the output
  is f16, 1e-5 where it is f32; argsort's integer type is compared by
  kind only, as before its int32 was settled in `test_torch_numpy.py`); the
  entries the port lacks are exactly `amp.UNPORTED`; ``_reset`` puts
  every function back;
- `LossScaler`: the scale over a fixed list of overflow flags equals the
  reference's; ``has_overflow`` takes one verdict over all gradients;
- ``scale_loss`` / ``unscale`` set ``trainer._scale`` and scale the loss
  as the reference's do;
- the eager step guard (the reference's
  ``test_trainer_step_guard_skips_overflowed_update``);
- `FusedTrainStep` with a scaler: its step equals the eager triple
  (``record``, ``scale_loss``, ``backward``, ``Trainer.step``) bitwise;
  its packed scalars carry the loss scale and ``rescale_grad /
  loss_scale``; captured (a stand-in for the CUDA graph that replays by
  running the step again), a changed scale reaches the next replay: a
  scale that overflows f32 is held there, weights bitwise, and the
  scale backs off; an explicit ``scaler=`` overrides the trainer's;
- a small BERT (2 layers, units 64, 4 heads, T 128, dropout 0, f32
  parameters) under ``amp.init("float16")``, the flash path on both
  sides (the reference's Pallas kernels in interpret mode): loss and
  gradients, the backward seeded with the loss times 2^16 on both sides
  and the gradients divided by it again, as a loss scaler does (without
  it most of the f16 gradients of this small model fall below f16's
  normal range, where a difference of one subnormal step is a large
  relative error).  Tolerances there: f16 products on both sides, which round
  where amp casts but accumulate in different orders, so an f16
  rounding of an activation may differ by one ulp (2^-11 relative) and
  that difference travels through two layers; loss within rtol 2e-3,
  each parameter's gradient within atol 1e-2 x its largest reference
  magnitude + rtol 2e-2 (measured: at most 2.3e-3 x that magnitude, the
  biases' sums the worst).
"""
import contextlib

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as ref_amp
from mxnet_tpu import autograd as ref_autograd
from mxnet_tpu.amp.loss_scaler import LossScaler as RefLossScaler
from mxnet_tpu.gluon import Trainer as RefTrainer
from mxnet_tpu.gluon import nn as ref_nn
from mxnet_tpu.gluon.block import HybridBlock as RefHybridBlock
from mxnet_tpu.models import BertForPretraining as RefBertForPretraining
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import amp, autograd, cpu, npx
from mxnet_tpu_torch.amp import loss_scaler
from mxnet_tpu_torch.amp.loss_scaler import LossScaler
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer, nn
from mxnet_tpu_torch.models import BertForPretraining
from mxnet_tpu_torch.ops import capture
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)


@contextlib.contextmanager
def _amp_both(target="float16"):
    """``amp.init(target)`` in both packages, undone on exit."""
    try:
        ref_amp.init(target)
        amp.init(target)
        yield
    finally:
        amp._reset()
        ref_amp._reset()


# -- the lists ---------------------------------------------------------------
def _inputs(seed=0):
    rng = onp.random.default_rng(seed)
    return {
        "A": rng.standard_normal((3, 4)).astype(onp.float32),
        "B": rng.standard_normal((4, 5)).astype(onp.float32),
        "C": rng.standard_normal((5, 4)).astype(onp.float32),
        "a": rng.standard_normal(3).astype(onp.float32),
        "b": rng.standard_normal(4).astype(onp.float32),
        "P": rng.uniform(0.5, 2.0, (3, 4)).astype(onp.float32),
        "U": rng.uniform(-0.9, 0.9, (3, 4)).astype(onp.float32),
        "S": rng.standard_normal((4, 4)).astype(onp.float32),
        "X": rng.standard_normal((2, 4)).astype(onp.float32),
        "W": rng.standard_normal((3, 4)).astype(onp.float32),
        "w": rng.standard_normal(3).astype(onp.float32),
        "g": rng.uniform(0.5, 1.5, 4).astype(onp.float32),
        "I": rng.standard_normal((1, 2, 5, 5)).astype(onp.float32),
        "K": rng.standard_normal((3, 2, 3, 3)).astype(onp.float32),
        "D": rng.standard_normal((2, 3, 3, 3)).astype(onp.float32),
        "G": rng.uniform(0.5, 1.5, 2).astype(onp.float32),
    }


# (module, function) -> (argument names, keyword arguments,
# reference-only keyword arguments)
CALLS = {
    ("numpy", "matmul"): ("AB", {}, {}),
    ("numpy", "dot"): ("AB", {}, {}),
    ("numpy", "einsum"): ("AB", {}, {}),
    ("numpy", "tensordot"): ("AB", {"axes": 1}, {}),
    ("numpy", "inner"): ("AC", {}, {}),
    ("numpy", "outer"): ("ab", {}, {}),
    ("numpy", "power"): ("PP", {}, {}),
    ("numpy", "sum"): ("P", {"axis": 1}, {}),
    ("numpy", "nansum"): ("P", {"axis": 0, "keepdims": True}, {}),
    ("numpy", "prod"): ("P", {"axis": 1}, {}),
    ("numpy", "nanprod"): ("P", {}, {}),
    ("numpy", "mean"): ("P", {"axis": (0, 1)}, {}),
    ("numpy", "std"): ("P", {"axis": 1, "ddof": 1}, {}),
    ("numpy", "var"): ("P", {"axis": 0}, {}),
    ("numpy", "cumsum"): ("P", {"axis": 1}, {}),
    ("numpy", "trace"): ("S", {}, {}),
    ("numpy", "average"): ("P", {"axis": 1}, {}),
    ("numpy", "argsort"): ("U", {"axis": -1}, {}),
    ("numpy", "sort"): ("U", {"axis": 0}, {}),
    ("numpy_extension", "fully_connected"): ("XWw", {"flatten": False},
                                             {"num_hidden": 3}),
    ("numpy_extension", "convolution"): ("IK", {"kernel": (3, 3),
                                                "num_filter": 3}, {}),
    ("numpy_extension", "softmax"): ("X", {"axis": -1}, {}),
    ("numpy_extension", "log_softmax"): ("X", {"axis": 0}, {}),
    ("numpy_extension", "layer_norm"): ("Xgg", {"axis": -1, "eps": 1e-5},
                                        {}),
    ("numpy_extension", "deconvolution"): ("ID", {"kernel": (3, 3),
                                                  "num_filter": 3}, {}),
    ("numpy_extension", "group_norm"): ("IGG", {"num_groups": 2,
                                                "eps": 1e-5}, {}),
    ("numpy_extension", "instance_norm"): ("IGG", {"eps": 1e-5}, {}),
}
_UNIT = {"arccos", "arcsin", "arctanh", "cosh", "sinh", "tan"}
for _name in ("exp", "expm1", "log", "log10", "log2", "log1p", "square",
              "reciprocal", "sqrt", "cbrt", "arccos", "arcsin", "cosh",
              "sinh", "tan", "arctanh"):
    CALLS[("numpy", _name)] = ("U" if _name in _UNIT else "P", {}, {})

_PORT_MODULES = {"numpy": mxt.np, "numpy_extension": mxt.npx}
_REF_MODULES = {"numpy": mx.np, "numpy_extension": mx.npx}


def _all_entries():
    entries = [(m, n) for m, names in amp._TARGET_FUNCS + amp._F32_FUNCS
               for n in names]
    return entries + [(m, n) for m, n, _k, _v in amp._CONDITIONAL_F32]


def _kind(dtype_name):
    return "int" if "int" in dtype_name else dtype_name


def _call(modules, key, dtype, port):
    mod_name, name = key
    letters, kw, ref_kw = CALLS[key]
    data = _inputs()
    args = []
    for ch in letters:
        x = data[ch].astype(dtype)
        args.append(torch.from_numpy(x) if port else mx.np.array(x))
    if name == "einsum":
        args = ["ij,jk->ik"] + args
    fn = getattr(modules[mod_name], name)
    out = fn(*args, **kw) if port else fn(*args, **kw, **ref_kw)
    if port:
        return str(out.dtype).split(".")[1], out.float().numpy()
    return str(out.dtype), onp.asarray(out.asnumpy(), onp.float32)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("key", sorted(CALLS), ids=lambda k: ".".join(k))
def test_listed_function_dtypes_match_the_reference(key, dtype):
    with _amp_both():
        got_dt, got = _call(_PORT_MODULES, key, dtype, port=True)
        want_dt, want = _call(_REF_MODULES, key, dtype, port=False)
    assert _kind(got_dt) == _kind(want_dt), (got_dt, want_dt)
    tol = 2e-3 if want_dt == "float16" else 1e-5
    onp.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("act", ["softrelu", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_conditional_activation_matches_the_reference(act, dtype):
    x = _inputs()["X"].astype(dtype)
    with _amp_both():
        got = mxt.npx.activation(torch.from_numpy(x), act_type=act)
        want = mx.npx.activation(mx.np.array(x), act_type=act)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(want.asnumpy(), onp.float32),
                                atol=2e-3, rtol=2e-3)


def test_unported_entries_are_the_named_constant():
    """Every list entry is in the port or in `amp.UNPORTED`, never both;
    a later slice that adds one must take it out of the constant."""
    missing = set()
    for mod_name, name in _all_entries():
        mod, fn = amp._lookup(mod_name, name)
        if fn is None:
            missing.add((mod_name, name))
    assert missing == set(amp.UNPORTED)
    assert set(CALLS) | {("numpy_extension", "activation")} == \
        set(_all_entries()) - set(amp.UNPORTED)


def test_init_patches_and_reset_restores():
    before = {k: getattr(_PORT_MODULES[k[0]], k[1]) for k in CALLS}
    try:
        amp.init("float16")
        amp.init("float16")                # a second call does nothing
        for key in CALLS:
            fn = getattr(_PORT_MODULES[key[0]], key[1])
            assert fn._amp_wrapped is before[key]
        # the models reach the patched functions through the namespaces
        out = nn.Dense(3, in_units=4, flatten=False).initialize(
            ctx=cpu())(torch.ones(2, 4))
        assert out.dtype == torch.float16
    finally:
        amp._reset()
    for key in CALLS:
        assert getattr(_PORT_MODULES[key[0]], key[1]) is before[key]


def test_mx_np_without_amp_keeps_the_dtype():
    """Without amp, the products are torch's own on same-dtype operands
    (the transformer's einsums and matmul are bitwise what they were),
    and promote mixed ones as numpy does."""
    rng = onp.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 5, 3, 4)).astype("f4"))
    k = torch.from_numpy(rng.standard_normal((2, 5, 3, 4)).astype("f4"))
    assert torch.equal(mxt.np.einsum("bthd,bshd->bhts", q, k),
                       torch.einsum("bthd,bshd->bhts", q, k))
    h, w = q.reshape(10, 12), k.reshape(10, 12)
    assert torch.equal(mxt.np.matmul(h, w.t()), torch.matmul(h, w.t()))
    assert mxt.np.matmul(h.half(), w.t()).dtype == torch.float32


# -- LossScaler --------------------------------------------------------------
FLAGS = [False, False, True, False, False, False, True, True, True, False,
         False, False, False, False, False, True, False, False, False]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(init_scale=4.0, scale_factor=2.0, scale_window=3),
    dict(init_scale=8.0, scale_factor=4.0, scale_window=2),
    dict(dynamic=False),
])
def test_loss_scaler_trajectory_equals_the_reference(kw):
    mine, theirs = LossScaler(**kw), RefLossScaler(**kw)
    got, want = [], []
    for flag in FLAGS * 2:
        mine.update_scale(flag)
        theirs.update_scale(flag)
        got.append((mine.loss_scale, mine._unskipped))
        want.append((theirs.loss_scale, theirs._unskipped))
    assert got == want
    assert min(s for s, _ in got) >= 1.0


@pytest.mark.parametrize("bad", [None, "nan", "inf"])
def test_has_overflow_is_one_verdict(bad, monkeypatch):
    """One `all_finite` over every gradient of every parameter (one
    read), True where any holds a NaN or an inf."""
    net = nn.Dense(3, in_units=4).initialize(ctx=cpu())
    for i, p in enumerate(net.collect_params().values()):
        p.data().grad = torch.full_like(p.data(), 0.5)
        if bad is not None and i == 1:
            p.data().grad[0] = float(bad)
    calls = []
    real = loss_scaler.all_finite

    def counted(tensors):
        calls.append(len(tensors))
        return real(tensors)

    monkeypatch.setattr(loss_scaler, "all_finite", counted)
    scaler = LossScaler()
    assert scaler.has_overflow(list(net.collect_params().values())) == \
        (bad is not None)
    assert calls == [2]
    assert LossScaler(dynamic=False).has_overflow(
        list(net.collect_params().values())) is False


# -- scale_loss / unscale ----------------------------------------------------
@pytest.mark.parametrize("as_list", [False, True])
def test_scale_loss_drives_trainer_scale_as_the_reference(as_list):
    net = nn.Dense(2, in_units=3).initialize(ctx=cpu())
    ref = ref_nn.Dense(2, in_units=3)
    ref.initialize()
    with _amp_both():
        mine = amp.init_trainer(Trainer(net.collect_params(), "sgd"))
        theirs = ref_amp.init_trainer(
            RefTrainer(ref.collect_params(), "sgd"))
        assert mine._amp_loss_scaler.loss_scale == \
            theirs._amp_loss_scaler.loss_scale == 2.0 ** 16
        values = [1.5, -2.0]
        loss = [torch.tensor(v) for v in values] if as_list else \
            torch.tensor(values[0])
        ref_loss = [mx.np.array(v) for v in values] if as_list else \
            mx.np.array(values[0])
        with amp.scale_loss(loss, mine) as scaled, \
                ref_amp.scale_loss(ref_loss, theirs) as ref_scaled:
            assert mine._scale == theirs._scale == 2.0 ** -16
            if as_list:
                assert [x.item() for x in scaled] == \
                    [float(x.asnumpy()) for x in ref_scaled]
            else:
                assert scaled.item() == float(ref_scaled.asnumpy())
        amp.unscale(mine)
        ref_amp.unscale(theirs)
        assert mine._scale == theirs._scale == 1.0
    # bf16 (and no init): a scaler that is not dynamic, scale 1
    plain = amp.init_trainer(Trainer(net.collect_params(), "sgd"))
    assert plain._amp_loss_scaler.loss_scale == 1.0


# -- the eager step guard ----------------------------------------------------
def test_trainer_step_guard_skips_overflowed_update():
    """An overflowed step leaves the parameters bitwise unchanged, backs
    the scale off and counts a skipped step; a clean step trains."""
    net = nn.Dense(2, in_units=3).initialize(ctx=cpu())
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
    amp.init_trainer(trainer)
    trainer._amp_loss_scaler = LossScaler(dynamic=True, init_scale=2.0)
    scaler = trainer._amp_loss_scaler
    x = torch.ones(4, 3)

    def backward(scale):
        scaler.loss_scale = scale
        with autograd.record():
            out = net(x).sum()
            with amp.scale_loss(out, trainer) as scaled:
                autograd.backward(scaled)

    backward(3.0e38)            # f32 overflow: the gradients go inf
    w0 = {k: p.data().clone() for k, p in net.collect_params().items()}
    counts = dict(trainer.optimizer._index_update_count)
    trainer.step(4)
    for k, p in net.collect_params().items():
        assert torch.equal(p.data(), w0[k]), k
    assert scaler.loss_scale == 1.5e38   # halved
    assert trainer.skipped_steps == 1
    assert trainer.optimizer._index_update_count == counts

    backward(2.0)               # a clean step trains again
    trainer.step(4)
    assert any(not torch.equal(p.data(), w0[k])
               for k, p in net.collect_params().items())
    assert scaler._unskipped == 1 and trainer.skipped_steps == 1


# -- FusedTrainStep with a scaler --------------------------------------------
class _Net(HybridBlock):
    def __init__(self):
        super().__init__()
        self.d1 = nn.Dense(8, in_units=4)
        self.d2 = nn.Dense(1, in_units=8)

    def forward(self, x):
        return (self.d2(self.d1(x)) ** 2).mean()


def _setup(seed=0, optimizer="adam"):
    net = _Net()
    net.initialize(ctx=cpu(), generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(net.collect_params(), optimizer,
                      {"learning_rate": 0.01})
    amp.init_trainer(trainer)
    trainer._amp_loss_scaler = LossScaler(init_scale=2.0 ** 10,
                                          scale_window=2)
    return net, trainer


def _x(seed=1, scale=1.0):
    return torch.from_numpy(scale * onp.random.default_rng(seed)
                            .standard_normal((6, 4)).astype(onp.float32))


def test_fused_step_with_scaler_equals_the_eager_triple():
    """On the CPU every call runs the step's body: the seed times the
    scale from the packed array, the rescale dividing it back out, one
    verdict read; bitwise the eager triple under `scale_loss`, scale
    trajectory included (window 2: the scale doubles every two clean
    steps)."""
    net, trainer = _setup()
    twin, twin_trainer = _setup()
    step = FusedTrainStep(net, trainer)
    plans = []
    real_plan = Trainer._plan

    def spy(self, indices, loss_scale=None):
        plan = real_plan(self, indices, loss_scale)
        plans.append((loss_scale, plan))
        return plan

    Trainer._plan = spy
    try:
        for i in range(5):
            x = _x(i)
            scale = trainer._amp_loss_scaler.loss_scale
            loss = step(x, batch_size=6)
            with autograd.record():
                ref = twin(x)
            with amp.scale_loss(ref, twin_trainer) as scaled:
                autograd.backward(scaled)
            twin_trainer.step(6)
            amp.unscale(twin_trainer)
            assert torch.equal(loss, ref.detach())
            for (k, p), q in zip(net.collect_params().items(),
                                 twin.collect_params().values()):
                assert torch.equal(p.data(), q.data()), (i, k)
            assert trainer._amp_loss_scaler.loss_scale == \
                twin_trainer._amp_loss_scaler.loss_scale
            ls, plan = plans[-2]          # the fused step's plan
            assert ls == scale and plan.scaled
            assert plan.host[-1] == onp.float32(scale)
            assert plan.host[0] == onp.float32(1 / 6 / scale)
    finally:
        Trainer._plan = real_plan
    assert trainer._amp_loss_scaler.loss_scale == 2.0 ** 12


class _Replaying(capture.Graph):
    """A stand-in for the CUDA graph: the capture records the step's
    function without its effects (the test puts the weights and states
    back, as a capture runs nothing), and a replay runs it again,
    writing into the captured outputs, as a replay reuses the graph's
    buffers."""

    undo = None

    def _record(self, fn):
        restore = _Replaying.undo()
        self._fn = fn
        self._out = fn()
        restore()
        return self._out

    def _launch(self):
        new = self._fn()
        with torch.no_grad():
            for old, fresh in zip(_leaves(self._out), _leaves(new)):
                old.copy_(fresh)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _leaves(o)]


def _snapshot(net, trainer):
    weights = [p.data().clone() for p in net.collect_params().values()]
    states = {i: [s.clone() for s in st]
              for i, st in (trainer._states or {}).items()}

    def restore():
        with torch.no_grad():
            for p, w in zip(net.collect_params().values(), weights):
                p.data().copy_(w)
            for i, st in states.items():
                for s, v in zip(trainer._states[i], st):
                    s.copy_(v)
    return restore


def test_captured_step_reads_the_scale_of_each_replay(monkeypatch):
    """The second call captures, later calls replay.  Each replay writes
    this step's loss scale and rescale into the static buffer: the
    replays equal eager steps taken with the same scales, and a scale
    that overflows f32, set between two replays, makes the next replay
    overflow (weights and states held bitwise, the scale halved, a step
    skipped) where a scale frozen at capture would not."""
    monkeypatch.setattr(capture, "Graph", _Replaying)
    monkeypatch.setattr(capture, "capturable", lambda device: True)
    net, trainer = _setup()
    twin, twin_trainer = _setup()
    _Replaying.undo = lambda: _snapshot(net, trainer)
    step = FusedTrainStep(net, trainer)
    eager = FusedTrainStep(twin, twin_trainer)
    scales = [2.0 ** 10, 2.0 ** 3, 2.0 ** 20, 3.0e38, None, None]
    for i, forced in enumerate(scales):
        if forced is not None:
            trainer._amp_loss_scaler.loss_scale = forced
            twin_trainer._amp_loss_scaler.loss_scale = forced
        x = _x(i, scale=1000.0)          # a loss of order 100
        before = [p.data().clone() for p in net.collect_params().values()]
        skipped = trainer.skipped_steps
        loss = step(x, batch_size=6)
        monkeypatch.setattr(capture, "capturable", lambda device: False)
        ref = eager(x, batch_size=6)
        monkeypatch.setattr(capture, "capturable", lambda device: True)
        assert torch.equal(loss, ref), i
        for p, q in zip(net.collect_params().values(),
                        twin.collect_params().values()):
            assert torch.equal(p.data(), q.data()), i
        assert trainer._amp_loss_scaler.loss_scale == \
            twin_trainer._amp_loss_scaler.loss_scale
        if forced == 3.0e38:
            assert trainer.skipped_steps == skipped + 1
            assert not bool(step.last_step_finite)
            assert trainer._amp_loss_scaler.loss_scale == 1.5e38
            for p, b in zip(net.collect_params().values(), before):
                assert torch.equal(p.data(), b)
    assert step.captures == 1
    graph = next(iter(step._graphs.values())).graph
    assert graph.replays == len(scales) - 1


def test_explicit_scaler_overrides_the_trainers():
    net, trainer = _setup()
    mine = LossScaler(init_scale=2.0 ** 5)
    step = FusedTrainStep(net, trainer, scaler=mine)
    step(_x(), batch_size=6)
    assert mine._unskipped == 1
    assert trainer._amp_loss_scaler._unskipped == 0


# -- a small BERT under amp against the reference ----------------------------
CFG = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
           num_heads=4, max_length=128, dropout=0.0, use_flash=True)
B, T = 2, 128


class _RefLoss(RefHybridBlock):
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


class _Loss(HybridBlock):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, tokens, segments, labels, valid_mask):
        mlm_logits, nsp_logits = self.m(tokens, segments, valid_mask)
        logp = npx.log_softmax(mlm_logits.float(), axis=-1)
        picked = npx.pick(logp, labels, axis=-1)
        m = valid_mask.float()
        mlm = -(picked * m).sum() / m.sum()
        nsp = -mxt.np.mean(npx.log_softmax(nsp_logits.float())[:, 0])
        return mlm + nsp


def _batch(seed=2):
    rng = onp.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], (B, T)).astype(onp.int32)
    segments = (onp.arange(T)[None, :] >= 40).astype(onp.int32).repeat(B, 0)
    labels = rng.integers(0, CFG["vocab_size"], (B, T)).astype(onp.int32)
    lens = onp.random.RandomState(11).randint(T // 2, T + 1, size=B)
    valid = (onp.arange(T)[None, :] < lens[:, None]).astype(onp.int32)
    return tokens, segments, labels, valid


def test_small_bert_under_amp_matches_the_reference():
    mx.random.seed(0)
    ref = RefBertForPretraining(**CFG)
    ref.initialize()
    ref(mx.np.zeros((1, T), dtype="int32"))
    start = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    net = BertForPretraining(**CFG).initialize(ctx=cpu())
    load_reference_params(net, start)
    ref_mod, mod = _RefLoss(ref), _Loss(net)
    batch = _batch()
    scale = 2.0 ** 16
    with _amp_both():
        with ref_autograd.record():
            loss_r = ref_mod(*[mx.np.array(a, dtype="int32") for a in batch])
            scaled_r = loss_r * scale
        scaled_r.backward()
        with autograd.record():
            loss_p = mod(*[torch.from_numpy(a) for a in batch])
            # the products run in f16
            assert net.bert.encoder.layer0.ffn.ffn_1(
                torch.zeros(1, CFG["units"])).dtype == torch.float16
        (loss_p * scale).backward()
    assert loss_p.dtype == torch.float32
    onp.testing.assert_allclose(loss_p.item(), float(loss_r.asnumpy()),
                                rtol=2e-3)
    ref_params = ref_mod.collect_params()
    for name, p in mod.collect_params().items():
        got = p.grad() / scale
        assert got.dtype == torch.float32, name       # f32 master grads
        expect = ref_params[name].grad().asnumpy() / scale
        if name.endswith("attention.key.bias"):
            # softmax ignores a per-row constant: rounding noise only
            assert onp.abs(got.numpy()).max() < 1e-6
            assert onp.abs(expect).max() < 1e-6
            continue
        mag = float(onp.abs(expect).max())
        onp.testing.assert_allclose(got.numpy(), expect, atol=1e-2 * mag,
                                    rtol=2e-2, err_msg=name)
