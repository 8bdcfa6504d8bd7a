"""The port's model-zoo families against the JAX package's.

For each family (AlexNet, VGG, SqueezeNet, MobileNet v1 and v2,
DenseNet, Inception v3) a network of the family at the smallest input
it accepts, with 3 classes and batch 2: the reference's parameters
(random values) carried across by name with `load_reference_params`,
then the logits and one SGD step's new parameters on the same seeded
batch, the reference hybridized.  The named networks run the step in
predict mode: dropout off (the two packages draw different dropout
bits) and BatchNorm on its running statistics: MobileNet's 27-53
BatchNorms on batch statistics over a few positions each amplify the
two sides' rounding differences (with a (4, 3, 64, 64) batch, whose
last BatchNorms see 16 positions, the first conv's new weights
differed by up to 80 %).  DenseNet,
Inception's blocks and the NHWC ResNet run in train mode, BatchNorm on
the batch's statistics, the port's backward through B1's plain
version.  The reference's CPU cost grows with the layer count, so the
cheapest member of each family runs: vgg11_bn, mobilenet0.25,
mobilenetv2_0.25, a DenseNet with one layer per dense block, and
Inception v3's five mixed blocks one by one; the full chip networks
(vgg16_bn, mobilenet1.0, mobilenetv2_1.0, densenet121, inceptionv3)
are held to the reference's parameter names and order.  Also
`get_model`'s dotted names, ``resnet18_v1(layout="NHWC")`` in
train mode against the reference's NHWC model, and vgg16_bn's
trajectory over three steps of the zoo phase's optimizer (SGD, lr 0.1,
momentum 0.9) in train mode with its Dropout rates set to 0.

Tolerance: f32 on both sides, true f32 products summed in other
orders through up to 20 layers: logits and new parameters at
atol = rtol = 2e-4 (5e-4 for the NHWC ResNet, whose BatchNorm gradients
sum over 2 x 16 x 16 positions).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
from mxnet_tpu.gluon.model_zoo.vision import densenet as ref_densenet
from mxnet_tpu.gluon.model_zoo.vision import inception as ref_inception
from mxnet_tpu_torch import autograd, cpu
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.vision import densenet, inception
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

TOL = 2e-4
LR = 0.1


def _step_both(make_ref, make_port, x, train, tol=TOL):
    """Random parameter values set in the reference (the port, which
    settles deferred shapes cheaply, gives their shapes), carried into
    the port by `load_reference_params`; then one SGD step of the
    summed logits times a fixed seeded weight in both.  The reference
    runs hybridized, which compiles its forward and backward once."""
    rng = onp.random.default_rng(11)
    shaper = make_port()
    shaper.initialize(ctx=cpu())
    with torch.no_grad(), autograd.predict_mode():
        out_shape = shaper(torch.from_numpy(x)).shape
    values = {}
    for k, p in shaper.collect_params().items():
        if k.endswith(("gamma", "running_var")):
            val = rng.uniform(0.5, 1.5, p.shape)
        else:   # weights at 1 / sqrt(fan in), vectors at 0.1
            fan_in = int(onp.prod(p.shape[1:])) if len(p.shape) > 1 else 100
            val = rng.standard_normal(p.shape) / onp.sqrt(fan_in)
        values[k] = val.astype(onp.float32)
    ref = make_ref()
    ref.initialize()
    ref.load_dict({k: mx.np.array(v) for k, v in values.items()})
    ref.hybridize()
    net = make_port()
    net.initialize(ctx=[cpu()])
    load_reference_params(net, {k: p.data().asnumpy()
                                for k, p in ref.collect_params().items()})
    w = rng.standard_normal(tuple(out_shape)).astype(onp.float32)
    with mx.autograd.record(train_mode=train):
        ref_out = ref(mx.np.array(x))
        ref_loss = (ref_out * mx.np.array(w)).sum()
    ref_loss.backward()
    mx.gluon.Trainer(ref.collect_params(), "sgd",
                     {"learning_rate": LR}).step(1)
    with autograd.record(train_mode=train):
        out = net(torch.from_numpy(x))
        loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    Trainer(net.collect_params(), "sgd", {"learning_rate": LR}).step(1)
    onp.testing.assert_allclose(out.detach().numpy(), ref_out.asnumpy(),
                                atol=tol, rtol=tol)
    ref_params = ref.collect_params()
    for k, p in net.collect_params().items():
        onp.testing.assert_allclose(p.data().detach().numpy(),
                                    ref_params[k].data().asnumpy(),
                                    atol=tol, rtol=tol, err_msg=k)
    return net, out


def _batch(shape, seed=5):
    return onp.random.default_rng(seed).uniform(-1, 1, shape).astype(
        onp.float32)


FAMILIES = [("alexnet", 63), ("vgg11_bn", 32), ("squeezenet1.1", 17),
            ("mobilenet0.25", 8), ("mobilenetv2_0.25", 8)]


@pytest.mark.parametrize("name,side", FAMILIES)
def test_family_step_matches_reference(name, side):
    _, out = _step_both(lambda: ref_vision.get_model(name, classes=3),
                        lambda: vision.get_model(name, classes=3),
                        _batch((2, 3, side, side)), False)
    assert out.shape == (2, 3)


def test_densenet_step_matches_reference():
    """DenseNet with one layer per dense block (AvgPool2D(7) at the end
    needs a 221 x 221 input); train mode."""
    _step_both(lambda: ref_densenet.DenseNet(8, 4, [1, 1, 1, 1], classes=3),
               lambda: densenet.DenseNet(8, 4, [1, 1, 1, 1], classes=3),
               _batch((2, 3, 221, 221)), True)


@pytest.mark.parametrize("block,args,c_in", [
    ("_make_A", (8,), 16), ("_make_B", (), 16), ("_make_C", (8,), 16),
    ("_make_D", (), 16), ("_make_E", (), 16)])
def test_inception_blocks_match_reference(block, args, c_in):
    """Each of Inception v3's mixed blocks (their widths as published)
    on a (2, c_in, 9, 9) input, train mode."""
    _step_both(lambda: getattr(ref_inception, block)(*args),
               lambda: getattr(inception, block)(*args),
               _batch((2, c_in, 9, 9)), True)


@pytest.mark.parametrize("name", ["alexnet", "vgg16_bn", "squeezenet1.1",
                                  "mobilenet1.0", "mobilenetv2_1.0",
                                  "densenet121", "inceptionv3"])
def test_chip_networks_have_the_reference_parameter_names(name):
    ref = ref_vision.get_model(name)
    net = vision.get_model(name)
    assert list(net.collect_params()) == list(ref.collect_params())
    n_bn = sum(k.endswith("running_mean") for k in net.collect_params())
    assert n_bn == {"alexnet": 0, "vgg16_bn": 13, "squeezenet1.1": 0,
                    "mobilenet1.0": 27, "mobilenetv2_1.0": 53,
                    "densenet121": 121, "inceptionv3": 94}[name]


def test_inceptionv3_takes_299():
    net = vision.get_model("inceptionv3", classes=5)
    net.initialize(ctx=cpu())
    with torch.no_grad(), autograd.predict_mode():
        assert net(torch.zeros(1, 3, 299, 299)).shape == (1, 5)


def test_get_model_dotted_names_match_reference():
    assert set(vision._models) == set(ref_vision._models)
    for dotted, plain in [("mobilenetv2_1.0", "mobilenet_v2_1_0"),
                          ("squeezenet1.1", "squeezenet1_1"),
                          ("mobilenet0.25", "mobilenet0_25"),
                          ("inceptionv3", "inception_v3")]:
        assert vision._models[dotted] is getattr(vision, plain)
    assert type(vision.get_model("MobileNetV2_0.5")).__name__ == "MobileNetV2"
    with pytest.raises(NotImplementedError, match="not shipped"):
        vision.get_model("densenet121", pretrained=True)
    with pytest.raises(ValueError, match="not supported"):
        vision.get_model("lenet")


def test_resnet18_nhwc_matches_reference():
    """ResNet-18 v1 (thumbnail) built with layout="NHWC" on an NHWC
    batch in train mode: BatchNorm over axis 3, whose backward hands B1
    the (N*H*W, C, 1) view; the weights are the NCHW model's layouts."""
    net, _ = _step_both(
        lambda: ref_vision.resnet18_v1(layout="NHWC", classes=3,
                                       thumbnail=True),
        lambda: vision.resnet18_v1(layout="NHWC", classes=3, thumbnail=True),
        _batch((2, 16, 16, 3)), True, tol=5e-4)
    assert net.features[0].weight.shape == (64, 3, 3, 3)
    assert net.features[1][0].body[1]._axis == 3


def _xavier_values(net, rng):
    """Values for each parameter of ``net`` as `mx.init.Xavier()` draws
    them (uniform, magnitude 3, fan average), from numpy: weights at
    +-sqrt(6 / (fan_in + fan_out)), biases and betas 0, gammas 1, the
    running mean 0 and variance 1."""
    values = {}
    for k, p in net.collect_params().items():
        if k.endswith(("gamma", "running_var")):
            val = onp.ones(p.shape)
        elif len(p.shape) == 1:
            val = onp.zeros(p.shape)
        else:
            field = int(onp.prod(p.shape[2:]))
            bound = onp.sqrt(6.0 / ((p.shape[0] + p.shape[1]) * field))
            val = rng.uniform(-bound, bound, p.shape)
        values[k] = val.astype(onp.float32)
    return values


def test_vgg16_bn_trajectory_matches_reference():
    """vgg16_bn with 3 classes, three train-mode steps of softmax cross
    entropy under SGD at lr 0.1 and momentum 0.9, as the zoo phase of
    `chip_smoke.py` trains it (there at batch 64 in bf16, where its loss
    rises): the same Xavier weights in both packages, the same (4, 3,
    32, 32) batch and seeded labels, BatchNorm on the batch's
    statistics.  Both classifiers' Dropout(0.5) blocks run at rate 0,
    the only way the two packages draw the same masks.  Each step's
    loss and the final parameters (running statistics included) agree
    within `TOL`: f32 on both sides, the same functions summed in other
    orders (the worst parameter differs by about 1e-5 of TOL's
    terms)."""
    x = _batch((4, 3, 32, 32))
    y = onp.random.default_rng(6).integers(0, 3, 4).astype(onp.int32)
    shaper = vision.vgg16_bn(classes=3)
    shaper.initialize(ctx=cpu())
    with torch.no_grad(), autograd.predict_mode():
        shaper(torch.from_numpy(x))
    values = _xavier_values(shaper, onp.random.default_rng(13))
    ref = ref_vision.vgg16_bn(classes=3)
    ref.initialize(init=mx.init.Zero())     # replaced by load_dict
    ref.load_dict({k: mx.np.array(v) for k, v in values.items()})
    net = vision.vgg16_bn(classes=3)
    net.initialize(ctx=[cpu()])
    load_reference_params(net, values)

    def dropouts(block):
        found = [block] if type(block).__name__ == "Dropout" else []
        for child in block._children.values():
            found += dropouts(child)
        return found
    drops = dropouts(ref) + [m for m in net.modules()
                             if type(m).__name__ == "Dropout"]
    assert len(drops) == 4
    for block in drops:
        block._rate = 0.0
    ref.hybridize()
    opt = {"learning_rate": LR, "momentum": 0.9}
    ref_trainer = mx.gluon.Trainer(ref.collect_params(), "sgd", opt)
    trainer = Trainer(net.collect_params(), "sgd", opt)
    ref_loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn = gloss.SoftmaxCrossEntropyLoss()
    ref_losses, losses = [], []
    for _ in range(3):
        with mx.autograd.record(train_mode=True):
            ref_loss = ref_loss_fn(ref(mx.np.array(x)), mx.np.array(y))
        ref_loss.backward()
        ref_trainer.step(x.shape[0])
        ref_losses.append(float(ref_loss.asnumpy().mean()))
        with autograd.record(train_mode=True):
            loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(loss)
        trainer.step(x.shape[0])
        losses.append(float(loss.detach().mean()))
    onp.testing.assert_allclose(losses, ref_losses, atol=TOL, rtol=TOL)
    ref_params = ref.collect_params()
    for k, p in net.collect_params().items():
        onp.testing.assert_allclose(p.data().detach().numpy(),
                                    ref_params[k].data().asnumpy(),
                                    atol=TOL, rtol=TOL, err_msg=k)
