"""The optimizers the port adds, against the JAX package's.

Thirteen optimizers join Adam, AdamW, LAMB and SGD: Adamax, Nadam and
LANS (`optimizer/adam.py`), RMSProp, AdaGrad, AdaDelta, Ftrl and FTML
(`optimizer/rmsprop.py`), NAG, Signum, SGLD, LARS and DCASGD
(`optimizer/sgd.py`), and the reference's ``Test``.  Held here, on the
CPU:

- each rule's ``update_math`` against the reference's on the same f32
  weights, gradients and host scalars over five steps, each package
  carrying its own states.  Tolerance atol 1e-6 + rtol 1e-5: both are
  f32 elementwise chains of the same formula, XLA free to contract a
  product and a sum into one FMA and to sum a norm in another order
  (LARS, LANS), so they differ by a few f32 ulps a step;
- the multi-tensor form the Trainer and `FusedTrainStep` run
  (``update_multi``, ``torch._foreach_*`` over the packed scalars)
  bitwise against ``update_math`` parameter by parameter, on f32 and
  bf16 weights, with clipping, weight decay, per-parameter multipliers
  and a scheduled lr, over three steps (as `test_torch_multi_tensor.py`
  holds the first four);
- Nadam and SGLD (``supports_fused = False``: host state that every
  parameter's update changes) take the per-parameter path in the
  Trainer, and `FusedTrainStep` refuses them;
- SGLD's deterministic part against the reference's with the noise
  zeroed in both; its noise, from an explicit generator, by mean and
  variance; and the noise against the reference's ``jax.random.normal``
  given the same key (the two words the port draws): within 4 f32 ulps
  of the reference's value, since XLA's ``erf_inv`` polynomial is
  computed in torch with torch's own ``log1p`` (every other step of the
  draw is exact integer arithmetic);
- the registry covers the reference's set, and each new optimizer's
  ``Updater`` state file loads in the other package.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import optimizer as ref_opt
from mxnet_tpu_torch import autograd, cpu
from mxnet_tpu_torch import optimizer as port_opt
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Parameter
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.optimizer.optimizer import write_back

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-5
STEPS = 5
SHAPE = (6, 7)

NEW = [
    ("adamax", dict(learning_rate=0.01, wd=0.01)),
    ("nadam", dict(learning_rate=0.01, wd=0.01)),
    ("lans", dict(learning_rate=0.01, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=1.5)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    ("adadelta", dict(learning_rate=1.0, wd=0.01)),
    ("ftrl", dict(learning_rate=0.1, wd=0.01, lamda1=0.05)),
    ("ftml", dict(learning_rate=0.01, wd=0.01)),
    ("nag", dict(learning_rate=0.1, wd=0.01)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("signum", dict(learning_rate=0.01, wd=0.01, wd_lh=0.02)),
    ("signum", dict(learning_rate=0.01, momentum=0.0, wd_lh=0.02)),
    ("lars", dict(learning_rate=0.1, wd=0.01)),
    ("lars", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("dcasgd", dict(learning_rate=0.1)),
    ("test", dict(learning_rate=0.1)),
]
FUSABLE = [(n, kw) for n, kw in NEW if n not in ("nadam", "sgld")]


def _ids(cases):
    return [f"{n}-{i}" for i, (n, _) in enumerate(cases)]


def _tuple(x):
    if x is None:
        return ()
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _data(rng):
    w = rng.standard_normal(SHAPE).astype(onp.float32)
    grads = [2 * rng.standard_normal(SHAPE).astype(onp.float32)
             for _ in range(STEPS)]
    return w, grads


@pytest.mark.parametrize("name,kw", NEW, ids=_ids(NEW))
def test_update_math_matches_the_reference(name, kw):
    w_np, grads = _data(onp.random.default_rng(7))
    mine = port_opt.create(name, **kw)
    theirs = ref_opt.create(name, **kw)
    w_p = torch.from_numpy(w_np.copy())
    st_p = tuple(mine.create_state(0, w_p))
    w_r = jnp.asarray(w_np)
    st_r = tuple(s._data for s in _tuple(theirs.create_state(
        0, mx.np.array(w_np))))
    lr, wd = kw.get("learning_rate", 0.01), kw.get("wd", 0.0)
    for t, g in enumerate(grads, start=1):
        w_p, st_p = mine.update_math(w_p, torch.from_numpy(g), st_p, lr, wd,
                                     t)
        w_r, st_r = theirs.update_math(w_r, jnp.asarray(g), st_r, lr, wd, t)
        st_p, st_r = _tuple(st_p), _tuple(st_r)
        onp.testing.assert_allclose(w_p.numpy(), onp.asarray(w_r),
                                    atol=ATOL, rtol=RTOL, err_msg=f"w {t}")
        assert len(st_p) == len(st_r)
        for a, b in zip(st_p, st_r):
            onp.testing.assert_allclose(a.numpy(), onp.asarray(b),
                                        atol=ATOL, rtol=RTOL,
                                        err_msg=f"state {t}")


# -- the multi-tensor form ---------------------------------------------------
SHAPES = [(7, 5), (5,), (3, 4, 2), (11,), (6, 6)]
LR_MULT = [1.0, 0.5, 1.0, 2.0, 1.0]
WD_MULT = [1.0, 0.0, 1.0, 1.0, 3.0]
BATCH = 4


class _Decay:
    """A scheduled lr: base_lr * 0.8^num_update."""

    def __init__(self):
        self.base_lr = 0.01

    def __call__(self, num_update):
        return self.base_lr * 0.8 ** num_update


def _trainer(name, kw, dtype, schedule, clip):
    kw = dict(kw, clip_gradient=clip)
    if schedule:
        kw["lr_scheduler"] = _Decay()
    rng = onp.random.default_rng(0)
    params = []
    for i, shape in enumerate(SHAPES):
        p = Parameter(f"p{i}", shape=shape, dtype=dtype,
                      lr_mult=LR_MULT[i], wd_mult=WD_MULT[i])
        p.initialize(ctx=cpu())
        p.set_data(rng.standard_normal(shape).astype(onp.float32))
        params.append(p)
    return Trainer(params, name, kw), params


def _grads(step, dtype):
    rng = onp.random.default_rng(100 + step)
    return [torch.from_numpy(2 * rng.standard_normal(s).astype(onp.float32)
                             ).to(dtype) for s in SHAPES]


def _per_parameter_step(trainer, grads):
    """The update parameter by parameter: rescale in f32, clip,
    ``update_math`` with the host scalars, write back."""
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


@pytest.mark.parametrize("schedule,clip", [(False, None), (True, 0.5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", FUSABLE, ids=_ids(FUSABLE))
def test_multi_tensor_step_is_bitwise_update_math(name, kw, dtype, schedule,
                                                  clip):
    mine, params = _trainer(name, kw, dtype, schedule, clip)
    theirs, ref_params = _trainer(name, kw, dtype, schedule, clip)
    tdt = getattr(torch, dtype)
    for step in range(3):
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


# -- the per-parameter path --------------------------------------------------
class _Net(HybridBlock):
    def __init__(self):
        super().__init__()
        self.d = nn.Dense(2, in_units=3)

    def forward(self, x):
        return (self.d(x) ** 2).mean()


@pytest.mark.parametrize("name", ["nadam", "sgld"])
def test_unfused_optimizers_step_per_parameter(name):
    """The Trainer applies Nadam and SGLD through `Optimizer.update`, one
    parameter at a time (the gradient rescaled in its own dtype), equal
    to calling it by hand; `FusedTrainStep` refuses them."""
    kw = dict(learning_rate=0.01, wd=0.01)
    if name == "sgld":
        kw["generator"] = torch.Generator().manual_seed(3)
    mine, params = _trainer(name, kw, "float32", False, None)
    kw2 = dict(kw)
    if name == "sgld":
        kw2["generator"] = torch.Generator().manual_seed(3)
    theirs, ref_params = _trainer(name, kw2, "float32", False, None)
    assert port_opt.create(name).supports_fused is False
    for step in range(3):
        grads = _grads(step, torch.float32)
        for p, g in zip(params, grads):
            p.data().grad = g.clone()
        mine.step(BATCH)
        opt = theirs.optimizer
        opt.rescale_grad = 1.0 / BATCH
        theirs._init_states()
        idx = list(range(len(SHAPES)))
        opt.update(idx, [p.data() for p in ref_params], grads,
                   [theirs._states[i] for i in idx])
        for p, q in zip(params, ref_params):
            assert torch.equal(p.data(), q.data()), step
    net = _Net().initialize(ctx=cpu())
    trainer = Trainer(net.collect_params(), name, dict(kw))
    with pytest.raises(ValueError, match="no update_multi"):
        FusedTrainStep(net, trainer)(torch.ones(2, 3), batch_size=2)


def test_sgld_deterministic_part_matches_the_reference(monkeypatch):
    w_np, grads = _data(onp.random.default_rng(9))
    mine = port_opt.create("sgld", learning_rate=0.05, wd=0.01)
    theirs = ref_opt.create("sgld", learning_rate=0.05, wd=0.01)
    monkeypatch.setattr(type(mine), "_noise",
                        lambda self, w: torch.zeros(w.shape))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.zeros(shape, dtype))
    w_p, w_r = torch.from_numpy(w_np.copy()), jnp.asarray(w_np)
    for t, g in enumerate(grads, start=1):
        w_p, _ = mine.update_math(w_p, torch.from_numpy(g), (), 0.05, 0.01, t)
        w_r, _ = theirs.update_math(w_r, jnp.asarray(g), (), 0.05, 0.01, t)
        onp.testing.assert_allclose(w_p.numpy(), onp.asarray(w_r),
                                    atol=ATOL, rtol=RTOL)


def test_sgld_noise_is_gaussian_from_the_explicit_generator():
    """The noise is N(0, lr): over 200,000 elements the mean lies within
    5 standard errors of 0 and the variance within 2 % of lr.  It comes
    from the generator given, or the train scope's, never torch's global
    generator; without either, the update raises."""
    lr, n = 0.04, 200_000
    w = torch.zeros(n)
    g = torch.zeros(n)
    opt = port_opt.create("sgld", learning_rate=lr)
    with pytest.raises(ValueError, match="torch.Generator"):
        opt.update_math(w, g, (), lr, 0.0, 1)
    torch.manual_seed(0)
    global_state = torch.get_rng_state()
    with autograd.train_mode(generator=torch.Generator().manual_seed(5)):
        noise, _ = opt.update_math(w, g, (), lr, 0.0, 1)
    assert torch.equal(torch.get_rng_state(), global_state)
    assert abs(noise.mean().item()) < 5 * (lr / n) ** 0.5
    assert abs(noise.var().item() / lr - 1) < 0.02
    again = port_opt.create("sgld", learning_rate=lr,
                            generator=torch.Generator().manual_seed(5))
    assert torch.equal(again.update_math(w, g, (), lr, 0.0, 1)[0], noise)


def test_sgld_noise_is_jax_random_normal_of_the_same_key(monkeypatch):
    from mxnet_tpu import random as ref_random
    from mxnet_tpu_torch.ops.seeds import DRAWS

    lr, shape = 0.09, (300, 70)
    words = DRAWS["normal"](torch.Generator().manual_seed(8))
    monkeypatch.setattr(ref_random, "new_key",
                        lambda: jnp.asarray(words, jnp.uint32))
    opt = port_opt.create("sgld", learning_rate=lr,
                          generator=torch.Generator().manual_seed(8))
    zeros = onp.zeros(shape, onp.float32)
    got, _ = opt.update_math(torch.from_numpy(zeros), torch.from_numpy(zeros),
                             (), lr, 0.0, 1)
    want, _ = ref_opt.create("sgld", learning_rate=lr).update_math(
        jnp.asarray(zeros), jnp.asarray(zeros), (), lr, 0.0, 1)
    want = onp.asarray(want)
    ulp = onp.spacing(onp.abs(want)).astype(onp.float64)
    err = onp.abs(got.numpy().astype(onp.float64) - want) / ulp
    assert err.max() <= 4, err.max()
    assert (got.numpy() == want).mean() > 0.9


# -- the registry and state files --------------------------------------------
def test_registry_covers_the_reference():
    mine = set(port_opt.Optimizer.opt_registry._entries)
    theirs = set(ref_opt.Optimizer.opt_registry._entries)
    assert theirs <= mine, sorted(theirs - mine)
    assert port_opt.get_updater(port_opt.create("sgd")).states == {}


STATEFUL = sorted({n for n, _ in NEW if n not in ("sgld",)})


@pytest.mark.parametrize("name", STATEFUL)
def test_state_files_load_across_packages(name):
    """Two updates through each package's `Updater`; each one's
    ``get_states`` blob loads in the other's ``set_states`` with the same
    arrays."""
    kw = dict(learning_rate=0.01)
    if name in ("nag", "lars", "dcasgd"):
        kw["momentum"] = 0.9
    rng = onp.random.default_rng(4)
    w_np = rng.standard_normal(SHAPE).astype(onp.float32)
    g_np = rng.standard_normal(SHAPE).astype(onp.float32)
    mine = port_opt.Updater(port_opt.create(name, **kw))
    w = torch.from_numpy(w_np.copy())
    for _ in range(2):
        mine(0, torch.from_numpy(g_np), w)
    theirs = ref_opt.Updater(ref_opt.create(name, **kw))
    w_r = mx.np.array(w_np)
    for _ in range(2):
        theirs(0, mx.np.array(g_np), w_r)

    loaded = ref_opt.Updater(ref_opt.create(name, **kw))
    loaded.set_states(mine.get_states())
    back = port_opt.Updater(port_opt.create(name, **kw))
    back.set_states(theirs.get_states())
    mine_st = [s.numpy() for s in mine.states[0]]
    theirs_st = [s.asnumpy() for s in _tuple(theirs.states[0])]
    assert len(mine_st) == len(theirs_st) >= 1
    for a, b in zip(mine_st, loaded.states[0]):
        assert onp.array_equal(a, b.asnumpy())
    for a, b in zip(theirs_st, back.states[0]):
        assert onp.array_equal(a, b)
