"""The port's ``ImageRecordIter`` against the JAX package's, and a
ResNet training step fed from a RecordIO file through it.

The .rec files are written here with Pillow: 40 JPEG images of 64 x 64
(low-frequency textures, as `bench.py`'s file holds) and labels.  Held
on the CPU:

- batches and labels from the port's g++ build of the native pipeline
  are bitwise the reference's for the same file, seed, crop, mirror and
  shuffle (one decode thread where crops or flips are random: each
  thread draws them from its own generator, in both packages), over
  more batches than an epoch holds (the stream wraps and
  reshuffles), and for each part of ``num_parts`` = 3; the NCHW layout
  and the `DataBatch` protocol; ``stats()`` counts the batches popped;
- a corrupt record is zero-filled and counted, as in the reference;
- ``reshard`` raises and names the roadmap item;
- three SGD-momentum steps of a narrow ResNet-50-shaped net
  (``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128])``, 10
  classes, the reference's weights carried across) through
  `FusedTrainStep`, fed by ``ImageRecordIter`` -> ``DevicePrefetcher``
  and `bench.py`'s ``RecNetWithLoss`` prologue (uint8 NHWC -> f32 ->
  normalised -> NCHW, here kept in f32): the losses equal the
  reference's within the tolerance `test_torch_resnet.py` states for
  f32 logits and losses (atol = rtol = 1e-4).
"""
import io as pio

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import recordio as ref_rio
from mxnet_tpu.gluon import FusedTrainStep as RefFusedTrainStep
from mxnet_tpu.gluon import Trainer as RefTrainer
from mxnet_tpu.gluon import loss as ref_loss
from mxnet_tpu.gluon.block import HybridBlock as RefHybridBlock
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.gluon import FusedTrainStep, HybridBlock, Trainer
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.io import DevicePrefetcher, ImageRecordIter
from mxnet_tpu_torch.utils.convert import load_reference_params

PIL = pytest.importorskip("PIL.Image")

torch.set_num_threads(1)

N_IMAGES, SIDE, CLASSES = 40, 64, 10
MEAN = (123.68, 116.779, 103.939)
STD = (58.393, 57.12, 57.375)
ATOL = RTOL = 1e-4


def _write_rec(path, n=N_IMAGES, corrupt=()):
    rs = onp.random.RandomState(0)
    w = ref_rio.MXRecordIO(str(path), "w")
    for i in range(n):
        small = rs.randint(0, 255, (8, 8, 3), dtype=onp.uint8)
        img = PIL.fromarray(small).resize((SIDE, SIDE), PIL.BILINEAR)
        buf = pio.BytesIO()
        img.save(buf, "JPEG", quality=85)
        payload = b"not a jpeg" if i in corrupt else buf.getvalue()
        w.write(ref_rio.pack(ref_rio.IRHeader(0, float(i % CLASSES), i, 0),
                             payload))
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return _write_rec(tmp_path_factory.mktemp("rec") / "imgs.rec")


CASES = [dict(),
         dict(rand_crop=True, data_shape=(3, 48, 56)),
         dict(rand_mirror=True),
         dict(shuffle=True, seed=5),
         dict(rand_crop=True, rand_mirror=True, shuffle=True,
              data_shape=(3, 56, 56), seed=11)]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(kw) or "plain")
def test_batches_are_bitwise_the_references(rec, kw):
    # each decode thread draws crops and flips from its own generator and
    # takes the next record when it is free, so with random crops or flips
    # the batches are a function of the seed only with one thread (in the
    # reference as in the port); without them, two threads
    random = kw.get("rand_crop") or kw.get("rand_mirror")
    args = dict(path_imgrec=rec, batch_size=8, data_shape=(3, SIDE, SIDE),
                preprocess_threads=1 if random else 2)
    args.update(kw)
    mine, theirs = ImageRecordIter(**args), mx.io.ImageRecordIter(**args)
    try:
        assert mine.num_records == theirs.num_records == N_IMAGES
        for _ in range(12):           # 2.4 epochs of 5 batches
            (d1, l1), (d2, l2) = mine.next_arrays(), theirs.next_arrays()
            onp.testing.assert_array_equal(d1, d2)
            onp.testing.assert_array_equal(l1, l2)
        assert mine.stats()["batches"] == 12
        assert mine.stats()["decode_errors"] == 0
    finally:
        mine.close()
        theirs.close()


@pytest.mark.parametrize("part", [0, 1, 2])
def test_parts_are_bitwise_the_references(rec, part):
    args = dict(path_imgrec=rec, batch_size=4, data_shape=(3, SIDE, SIDE),
                shuffle=True, rand_mirror=True, seed=3, num_parts=3,
                part_index=part, preprocess_threads=1)
    mine, theirs = ImageRecordIter(**args), mx.io.ImageRecordIter(**args)
    try:
        assert mine.part_records == theirs.part_records
        for _ in range(7):
            (d1, l1), (d2, l2) = mine.next_arrays(), theirs.next_arrays()
            onp.testing.assert_array_equal(d1, d2)
            onp.testing.assert_array_equal(l1, l2)
    finally:
        mine.close()
        theirs.close()


def test_databatch_protocol_and_nchw_layout(rec):
    it = ImageRecordIter(rec, batch_size=16, data_shape=(3, SIDE, SIDE),
                         layout="NCHW", preprocess_threads=1)
    ref = mx.io.ImageRecordIter(rec, batch_size=16,
                                data_shape=(3, SIDE, SIDE), layout="NCHW",
                                preprocess_threads=1)
    assert it.provide_data[0].shape == (16, 3, SIDE, SIDE)
    batches = list(it)
    ref_batches = list(ref)
    assert len(batches) == len(ref_batches) == N_IMAGES // 16
    for b, r in zip(batches, ref_batches):
        onp.testing.assert_array_equal(b.data[0].numpy(),
                                       r.data[0].asnumpy())
        onp.testing.assert_array_equal(b.label[0].numpy(),
                                       r.label[0].asnumpy())
    it.reset()
    assert next(it).data[0].dtype == torch.uint8
    with pytest.raises(NotImplementedError, match="A7d"):
        it.reshard(2, 0)
    it.close()
    ref.close()


def test_corrupt_records_are_zero_filled_and_counted(tmp_path):
    path = _write_rec(tmp_path / "bad.rec", n=8, corrupt=(2, 5))
    it = ImageRecordIter(path, batch_size=8, data_shape=(3, SIDE, SIDE),
                         preprocess_threads=1)
    data, labels = it.next_arrays()
    # the workers decode ahead into the ring, so later batches' errors
    # may be counted already
    assert it.decode_errors >= 2 and it.stats()["decode_errors"] >= 2
    assert not data[2].any() and not data[5].any() and data[0].any()
    assert labels.tolist() == [float(i) for i in range(8)]
    it.close()


# -- a ResNet step fed from the .rec ------------------------------------------
SPEC = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
B, STEPS = 2, 3
SGD_KW = {"learning_rate": 0.1, "momentum": 0.9}


class RefRecNetWithLoss(RefHybridBlock):
    """`bench.py`'s prologue, the cast kept in f32."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.loss_fn = ref_loss.SoftmaxCrossEntropyLoss()

    def forward(self, x_u8, y):
        x = x_u8.astype("float32")
        x = (x - mx.np.array(MEAN)) / mx.np.array(STD)
        return self.loss_fn(self.net(mx.np.transpose(x, (0, 3, 1, 2))), y)


class RecNetWithLoss(HybridBlock):
    def __init__(self, net):
        super().__init__()
        self.net = net
        self.loss_fn = gloss.SoftmaxCrossEntropyLoss()
        self.mean = mxt.np.array(MEAN, ctx=cpu())
        self.std = mxt.np.array(STD, ctx=cpu())

    def forward(self, x_u8, y):
        x = (x_u8.to(torch.float32) - self.mean) / self.std
        return self.loss_fn(self.net(mxt.np.transpose(x, (0, 3, 1, 2))), y)


def test_resnet_steps_from_the_rec_match_the_reference(rec):
    mx.random.seed(0)
    ref = ref_vision.ResNetV1(ref_vision.BottleneckV1, *SPEC, classes=CLASSES)
    ref.initialize(init=mx.init.Xavier())
    ref(mx.np.zeros((1, 3, SIDE, SIDE)))
    net = vision.ResNetV1(vision.BottleneckV1, *SPEC, classes=CLASSES)
    net.initialize(ctx=cpu())
    load_reference_params(net, {k: p.data().asnumpy() for k, p in
                                ref.collect_params().items()})
    it_args = dict(path_imgrec=rec, batch_size=B, data_shape=(3, SIDE, SIDE),
                   rand_mirror=True, shuffle=True, preprocess_threads=1)
    losses = {}
    for name, pkg_it, mod, trainer_cls, step_cls, pf_kw in (
            ("ref", mx.io.ImageRecordIter, RefRecNetWithLoss(ref),
             RefTrainer, RefFusedTrainStep, {}),
            ("port", ImageRecordIter, RecNetWithLoss(net), Trainer,
             FusedTrainStep, {"ctx": cpu()})):
        it = pkg_it(**it_args)
        kw = {"kvstore": "device"}
        trainer = trainer_cls(mod.net.collect_params(), "sgd", dict(SGD_KW),
                              **kw)
        step = step_cls(mod, trainer)
        pf_cls = mx.io.DevicePrefetcher if name == "ref" else DevicePrefetcher
        with pf_cls(it, depth=3, dtypes=(None, onp.int32), **pf_kw) as pf:
            out = []
            for _ in range(STEPS):
                x, y = next(pf)
                loss = step(x, y, batch_size=B)
                out.append(onp.asarray(loss.asnumpy() if name == "ref"
                                       else loss.numpy()))
        it.close()
        losses[name] = out
    for got, want in zip(losses["port"], losses["ref"]):
        onp.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
