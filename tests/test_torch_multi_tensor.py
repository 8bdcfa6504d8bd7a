"""The Trainer's multi-tensor update against the per-parameter rule.

`Trainer.step` (and `FusedTrainStep`) pack each step's optimizer scalars
into one f32 array (`gluon.trainer.StepPlan`) and apply the optimizer's
``update_multi``, ``torch._foreach_*`` ops over a group of parameters
reading 0-dim views of that array.  Held here, bitwise, against the
per-parameter path they replace: each gradient rescaled in f32 by the
f32 rescale, clipped, handed to ``update_math`` with the host's lr, wd
and f32 update count, and copied back (`optimizer.write_back`), for Adam,
AdamW, LAMB and SGD with and without momentum, on f32 and bf16 weights,
with clipping, weight decay, per-parameter ``lr_mult``/``wd_mult`` and a
scheduled lr, over three steps.  Beside it: the packed array holds, bit
for bit, the f32 rounding of the host values each parameter's update
reads, and a step whose verdict is False leaves weights and states
bitwise as they were, NaN and inf gradients included.  All on the CPU,
where the foreach ops run tensor by tensor: equal bits here mean every
intermediate rounds where ``update_math`` rounds it.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.gluon import Parameter, Trainer
from mxnet_tpu_torch.optimizer.optimizer import write_back

torch.set_num_threads(1)

SHAPES = [(7, 5), (5,), (3, 4, 2), (11,), (6, 6)]
LR_MULT = [1.0, 0.5, 1.0, 2.0, 1.0]
WD_MULT = [1.0, 0.0, 1.0, 1.0, 3.0]
BATCH = 4
STEPS = 3


class _Decay:
    """A scheduled lr: base_lr * 0.8^num_update."""

    def __init__(self):
        self.base_lr = 0.01

    def __call__(self, num_update):
        return self.base_lr * 0.8 ** num_update


OPTIMIZERS = [
    ("adam", dict(learning_rate=0.01, wd=0.01, clip_gradient=0.5)),
    ("adam", dict(learning_rate=0.01, correct_bias=False)),
    ("adamw", dict(learning_rate=0.01, wd=0.02, clip_gradient=1.0)),
    ("lamb", dict(learning_rate=0.01, wd=0.01, lower_bound=0.1,
                  upper_bound=5.0)),
    ("lamb", dict(learning_rate=0.01, bias_correction=False)),
    ("sgd", dict(learning_rate=0.1, wd=1e-3, clip_gradient=0.3)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
]


def _params(dtype, seed):
    rng = onp.random.default_rng(seed)
    params = []
    for i, shape in enumerate(SHAPES):
        p = Parameter(f"p{i}", shape=shape, dtype=dtype,
                      lr_mult=LR_MULT[i], wd_mult=WD_MULT[i])
        p.initialize(ctx=cpu())
        p.set_data(rng.standard_normal(shape).astype(onp.float32))
        params.append(p)
    return params


def _grads(step, dtype, bad=False):
    rng = onp.random.default_rng(100 + step)
    gs = [torch.from_numpy(2 * rng.standard_normal(s).astype(onp.float32)
                           ).to(dtype) for s in SHAPES]
    if bad:
        gs[2].view(-1)[3] = float("nan")
        gs[4].view(-1)[0] = float("inf")
    return gs


def _trainer(name, kw, dtype, seed=0, schedule=False):
    kw = dict(kw)
    if schedule:
        kw["lr_scheduler"] = _Decay()
    params = _params(dtype, seed)
    return Trainer(params, name, kw), params


def _per_parameter_step(trainer, grads):
    """The update as the Trainer took it parameter by parameter: rescale
    in f32, clip, ``update_math`` with the host scalars, write back."""
    opt = trainer.optimizer
    opt.rescale_grad = trainer._scale / BATCH
    trainer._init_states()
    rescale = float(onp.float32(opt.rescale_grad))
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(trainer._params, grads)):
            lr, wd, t = trainer._scalars(i)
            g = g.float() * rescale
            if opt.clip_gradient is not None:
                g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
            new_w, new_st = opt.update_math(p.data(), g, trainer._states[i],
                                            lr, wd, t)
            write_back(p.data(), new_w, trainer._states[i], new_st)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_multi_tensor_step_is_bitwise_the_per_parameter_step(name, kw, dtype,
                                                             schedule):
    mine, params = _trainer(name, kw, dtype, schedule=schedule)
    theirs, ref_params = _trainer(name, kw, dtype, schedule=schedule)
    tdt = getattr(torch, dtype)
    for step in range(STEPS):
        grads = _grads(step, tdt)
        for p, g in zip(params, grads):
            p.data().grad = g.clone()
        mine.step(BATCH)
        _per_parameter_step(theirs, grads)
        for i, (p, q) in enumerate(zip(params, ref_params)):
            assert p.data().dtype == tdt
            assert torch.equal(p.data(), q.data()), (step, i)
            for a, b in zip(mine._states[i], theirs._states[i]):
                assert torch.equal(a, b), (step, i)
    assert mine.optimizer._index_update_count == \
        theirs.optimizer._index_update_count


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_packed_scalars_are_the_host_values(name, kw):
    """Each parameter's row of the packed array holds, bit for bit, the
    f32 rounding of the values ``update_math`` computes on the host from
    its lr, wd and t, and the rescale comes first; parameters with equal
    rows share a group."""
    trainer, _ = _trainer(name, kw, "float32", schedule=True)
    twin, _ = _trainer(name, kw, "float32", schedule=True)
    opt = trainer.optimizer
    for step in range(2):
        opt.rescale_grad = twin.optimizer.rescale_grad = 1.0 / BATCH
        idx = list(range(len(SHAPES)))
        plan = trainer._plan(idx)
        k = len(opt.scalar_names)
        assert plan.host.dtype == onp.float32
        assert plan.host[0] == onp.float32(1.0 / BATCH)
        assert sorted(p for g in plan.groups for p in g) == idx
        rows = {}
        for g, positions in enumerate(plan.groups):
            for pos in positions:
                rows[pos] = plan.host[1 + g * k: 1 + (g + 1) * k]
        for i in idx:
            lr, wd, t = twin._scalars(i)
            host = onp.asarray(opt.step_scalars(lr, wd, t), onp.float32)
            assert host.tobytes() == rows[i].tobytes(), (step, i)
            # an f32 tensor scalar gives the product a Python float gives
            x = torch.from_numpy(onp.random.default_rng(i).standard_normal(
                50).astype(onp.float32))
            for value, packed in zip(opt.step_scalars(lr, wd, t), rows[i]):
                assert torch.equal(x * value, x * torch.tensor(packed))
        # lr_mult 0.5 and 2.0 and wd_mult 0 and 3 split the groups
        assert len(plan.groups) == len({
            (m, kw.get("wd", 0.0) * w) for m, w in zip(LR_MULT, WD_MULT)})


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_finite_verdict_holds_weights_and_states_bitwise(name, kw,
                                                             dtype):
    """With ``keep`` False the update leaves every weight and state
    bitwise as it was, though NaN and inf flow through the math; with
    ``keep`` True it equals the unguarded update."""
    tdt = getattr(torch, dtype)
    trainer, params = _trainer(name, kw, dtype)
    plain, plain_params = _trainer(name, kw, dtype)
    for tr, ps in ((trainer, params), (plain, plain_params)):
        for p, g in zip(ps, _grads(0, tdt)):
            p.data().grad = g
        tr.step(BATCH)                        # states are not zero
    before = [p.data().clone() for p in params]
    states = {i: tuple(x.clone() for x in st)
              for i, st in trainer._states.items()}
    idx = list(range(len(SHAPES)))
    for keep, tr, ps in ((False, trainer, params), (True, trainer, params),
                         (None, plain, plain_params)):
        weights = [p.data() for p in ps]
        plan = tr._plan(idx)
        rescale, rows = plan.views(torch.from_numpy(plan.host))
        grads = tr._rescaled(_grads(1, tdt, bad=keep is False), rescale)
        flag = None if keep is None else torch.tensor(keep)
        tr._apply(plan, rows, idx, weights, grads, cast_back=True,
                  keep=flag)
        if keep is False:
            for p, b in zip(params, before):
                assert torch.equal(p.data(), b)
            for i, st in trainer._states.items():
                for a, b in zip(st, states[i]):
                    assert torch.equal(a, b)
            # the plain trainer's counts stay one step behind: catch up
            plain._plan(idx)
    for p, q in zip(params, plain_params):
        assert torch.equal(p.data(), q.data())
    for i, st in trainer._states.items():
        for a, b in zip(st, plain._states[i]):
            assert torch.equal(a, b)
