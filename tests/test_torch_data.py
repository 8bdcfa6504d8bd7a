"""The port's ``gluon.data`` against the JAX package's: datasets,
samplers, batchify functions, the DataLoader, and DeviceAugment.

Held on the CPU:

- datasets (``shard``, ``take``, ``filter``, ``transform``,
  ``transform_first``, ``sample``), every sampler (``RandomSampler``
  from numpy's global generator, seeded the same before each package)
  and ``BatchSampler`` with each ``last_batch`` give the reference's
  indices and items;
- ``Stack``, ``Pad`` (with lengths) and ``Group`` batchify equal the
  reference's bitwise;
- the DataLoader, with and without a worker pool and through the
  prefetcher (``prefetch_to_device``, ``device=cpu()``, nested batches
  flattened and rebuilt), yields the reference's batches bitwise;
- DeviceAugment: from the same two key words, the crop offsets and
  flips (``split``, ``randint``, ``bernoulli``) are bitwise
  ``jax.random``'s; the augmented batch equals the reference's
  ``_augment_math`` on the same raw key bitwise in f32 and within one
  bf16 ulp (2^-8 relative, both round each op to bf16 but XLA may keep
  f32 between the subtraction and the division) in bf16, in train and
  eval mode, with and without the transpose;
- in train mode its key is one ``"augment"`` draw from the scope's
  generator; a `FusedTrainStep` records it as a draw site, and each
  replay of the captured step (a stand-in graph that runs the step
  again) crops with the words the eager step would have drawn there.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import data as ref_data
from mxnet_tpu.gluon.data.augment import _augment_math
from mxnet_tpu_torch import autograd, cpu
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer, nn
from mxnet_tpu_torch.gluon import data as gdata
from mxnet_tpu_torch.gluon.data.augment import augment_draws, augment_math
from mxnet_tpu_torch.ops import capture, threefry
from mxnet_tpu_torch.ops.invoke import current_seed_table
from mxnet_tpu_torch.ops.seeds import DRAWS

torch.set_num_threads(1)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    if isinstance(a, (list, tuple)):
        return [_np(x) for x in a]
    return onp.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    onp.testing.assert_array_equal(a, b)


def _arrays(n=11):
    rng = onp.random.default_rng(0)
    return (rng.uniform(size=(n, 2, 3)).astype(onp.float32),
            rng.integers(0, 5, n).astype(onp.int32))


# -- datasets and samplers ----------------------------------------------------
def test_datasets_equal_the_references():
    x, y = _arrays()
    mine, theirs = gdata.ArrayDataset(x, y), ref_data.ArrayDataset(x, y)
    assert len(mine) == len(theirs) == 11
    ops = [lambda d: d.shard(3, 1), lambda d: d.take(4),
           lambda d: d.filter(lambda s: s[1] > 1),
           lambda d: d.transform(lambda a, b: (a * 2, b + 1)),
           lambda d: d.transform_first(lambda a: a.sum()),
           lambda d: d.sample([3, 1, 4])]
    for op in ops:
        m, t = op(mine), op(theirs)
        assert len(m) == len(t)
        for i in range(len(m)):
            for a, b in zip(m[i], t[i]):
                onp.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_equal_the_references(last_batch):
    runs = []
    for pkg in (gdata, ref_data):
        onp.random.seed(3)
        ds = pkg.SimpleDataset(list(range(13)))
        samplers = [pkg.SequentialSampler(13, start=2),
                    pkg.RandomSampler(13),
                    pkg.IntervalSampler(13, 4),
                    pkg.IntervalSampler(13, 4, rollover=False),
                    pkg.FilterSampler(lambda v: v % 3 == 0, ds)]
        out = [list(s) for s in samplers]
        bs = pkg.BatchSampler(pkg.SequentialSampler(13), 5, last_batch)
        out += [len(bs), list(bs), list(bs), len(bs)]
        runs.append(out)
    assert runs[0] == runs[1]


def test_batchify_equals_the_references():
    rng = onp.random.default_rng(2)
    seqs = [rng.uniform(size=(int(n), 3)).astype(onp.float32)
            for n in (3, 5, 2)]
    labels = [onp.int32(i) for i in range(3)]
    b, rb = gdata.batchify, ref_data.batchify
    _same(b.Stack()([s[:2] for s in seqs]), rb.Stack()([s[:2] for s in seqs]))
    _same(b.Stack()([torch.from_numpy(s[:2]) for s in seqs]),
          rb.Stack()([mx.np.array(s[:2]) for s in seqs]))
    for kw in (dict(), dict(axis=0, pad_val=-1, ret_length=True),
               dict(dtype=onp.float64)):
        got, want = b.Pad(**kw)(seqs), rb.Pad(**kw)(seqs)
        if kw.get("ret_length"):
            got, want = list(got), list(want)
        _same(got, want)
    samples = list(zip(seqs, labels))
    _same(list(b.Group(b.Pad(), b.Stack())(samples)),
          list(rb.Group(rb.Pad(), rb.Stack())(samples)))
    assert b.Tuple is b.Group


# -- the DataLoader -----------------------------------------------------------
LOADER_CASES = [dict(batch_size=4), dict(batch_size=4, last_batch="discard"),
                dict(batch_size=3, shuffle=True),
                dict(batch_size=4, num_workers=2),
                dict(batch_size=4, prefetch_to_device=True),
                dict(batch_size=5, num_workers=2, prefetch_to_device=2)]


@pytest.mark.parametrize("kw", LOADER_CASES,
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_dataloader_equals_the_reference(kw):
    x, y = _arrays()
    runs = []
    for pkg, extra in ((gdata, {"device": cpu()}), (ref_data, {})):
        onp.random.seed(5)
        dl = pkg.DataLoader(pkg.ArrayDataset(x, y), **kw, **extra)
        runs.append([[_np(f) for f in batch] for batch in dl] +
                    [len(dl)])
    mine, theirs = runs
    assert mine[-1] == theirs[-1] and len(mine) == len(theirs)
    for m, t in zip(mine[:-1], theirs[:-1]):
        _same(m, t)


def test_dataloader_nested_batches_through_the_prefetcher():
    rng = onp.random.default_rng(4)
    samples = [(rng.uniform(size=(int(n), 2)).astype(onp.float32),
                onp.int32(n)) for n in rng.integers(1, 6, 9)]
    fn = gdata.batchify.Group(gdata.batchify.Pad(ret_length=True),
                              gdata.batchify.Stack())
    rfn = ref_data.batchify.Group(ref_data.batchify.Pad(ret_length=True),
                                  ref_data.batchify.Stack())
    mine = list(gdata.DataLoader(gdata.SimpleDataset(samples), batch_size=4,
                                 batchify_fn=fn, prefetch_to_device=True,
                                 device=cpu()))
    theirs = list(ref_data.DataLoader(ref_data.SimpleDataset(samples),
                                      batch_size=4, batchify_fn=rfn,
                                      prefetch_to_device=True))
    assert len(mine) == len(theirs) == 3
    for m, t in zip(mine, theirs):
        assert isinstance(m, tuple) and isinstance(m[0], tuple)
        _same([m[0][0], m[0][1], m[1]], [t[0][0], t[0][1], t[1]])
    with pytest.raises(NotImplementedError, match="A7d"):
        gdata.DataLoader(gdata.SimpleDataset(samples), batch_size=2,
                         device=cpu(), sharding=object())


# -- DeviceAugment --------------------------------------------------------------
WORDS = [(0, 0), (7, 3), (0xDEADBEEF, 0x12345678), (4294967295, 1)]
MEAN = (123.68, 116.779, 103.939)
STD = (58.393, 57.12, 57.375)


@pytest.mark.parametrize("words", WORDS)
def test_augment_draws_are_bitwise_jax_randoms(words):
    B, H, W, ch, cw = 37, 64, 60, 56, 48
    key = jnp.asarray(words, jnp.uint32)
    ky, kx, kf = jax.random.split(key, 3)
    y0, x0, flip = augment_draws(threefry.key_of(words), B, H, W, ch, cw)
    onp.testing.assert_array_equal(
        y0.numpy(), onp.asarray(jax.random.randint(ky, (B,), 0, H - ch + 1)))
    onp.testing.assert_array_equal(
        x0.numpy(), onp.asarray(jax.random.randint(kx, (B,), 0, W - cw + 1)))
    onp.testing.assert_array_equal(
        flip.numpy(), onp.asarray(jax.random.bernoulli(kf, 0.5, (B,))))


def _canvas(b=6, h=40, w=36):
    return onp.random.default_rng(8).integers(0, 256, (b, h, w, 3),
                                              dtype=onp.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("nchw", [True, False])
def test_augment_math_equals_the_references(dtype, train, nchw):
    x = _canvas()
    words = (0xC0FFEE, 99)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    mean = jnp.asarray(onp.asarray(MEAN, onp.float32)).astype(jdt)
    std = jnp.asarray(onp.asarray(STD, onp.float32)).astype(jdt)
    want = _augment_math(jnp.asarray(x), jnp.asarray(words, jnp.uint32)
                         if train else None, 32, 24, True, True, mean, std,
                         1.0, nchw, jdt)
    got = augment_math(torch.from_numpy(x), threefry.key_of(words)
                       if train else None, 32, 24, True, True,
                       torch.tensor(MEAN).to(tdt), torch.tensor(STD).to(tdt),
                       1.0, nchw, tdt)
    want = onp.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)


def test_device_augment_block_draws_one_augment_key():
    x = torch.from_numpy(_canvas())
    aug = gdata.DeviceAugment((32, 24), rand_crop=True, rand_mirror=True,
                              mean=MEAN, std=STD)
    expect_words = DRAWS["augment"](torch.Generator().manual_seed(12))
    with autograd.train_mode(generator=torch.Generator().manual_seed(12)):
        got = aug(x)
    want = augment_math(x, threefry.key_of(expect_words), 32, 24, True, True,
                        torch.tensor(MEAN), torch.tensor(STD), 1.0, True,
                        torch.float32)
    assert torch.equal(got, want) and got.is_contiguous()
    center = aug(x)                          # eval mode: a center crop
    assert torch.equal(center, augment_math(
        x, None, 32, 24, True, True, torch.tensor(MEAN), torch.tensor(STD),
        1.0, True, torch.float32))
    with pytest.raises(ValueError, match="smaller than crop"):
        gdata.DeviceAugment(64)(x)


class _StandIn(capture.Graph):
    """Capture runs the step once; each replay runs it again, as a graph
    replays its draws: reading the rows the replay wrote into the seed
    buffer, without taking new rows or drawing from the generator."""

    table = gen = None

    def _record(self, fn):
        self._fn = fn
        return fn()

    def _launch(self):
        _StandIn.table.kinds.clear()
        _StandIn.table.words.clear()
        state = _StandIn.gen.get_state()
        self._fn()
        _StandIn.gen.set_state(state)


class _AugNet(HybridBlock):
    def __init__(self):
        super().__init__()
        self.aug = gdata.DeviceAugment((8, 8), rand_crop=True,
                                       rand_mirror=True)
        self.dense = nn.Dense(1, in_units=8 * 8 * 3)
        self.seen = []

    def forward(self, x):
        _StandIn.table = current_seed_table()
        a = self.aug(x)
        self.seen.append(a.detach().clone())
        return (self.dense(a.reshape(a.shape[0], -1)) ** 2).mean()


def test_captured_step_replays_draw_fresh_augment_words(monkeypatch):
    monkeypatch.setattr(capture, "Graph", _StandIn)
    monkeypatch.setattr(capture, "capturable", lambda device: True)
    x = torch.from_numpy(_canvas(4, 12, 12))
    net = _AugNet()
    net.initialize(ctx=cpu())
    _StandIn.gen = torch.Generator().manual_seed(21)
    step = FusedTrainStep(net, Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 0.0}),
                          generator=_StandIn.gen)
    gen = torch.Generator().manual_seed(21)
    for call in range(4):
        step(x, batch_size=4)
        words = DRAWS["augment"](gen)
        want = augment_math(x, threefry.key_of(words), 8, 8, True, True,
                            None, None, 1.0, True, torch.float32)
        assert torch.equal(net.seen[-1], want), call
    assert step.captures == 1
    assert step._kinds[next(iter(step._kinds))] == ("augment",)
    assert not torch.equal(net.seen[-1], net.seen[-2])
