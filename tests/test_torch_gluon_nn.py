"""The port's `gluon.nn` against the JAX package's, and the Block repairs.

Every layer class the port added (the norms, activations, containers,
the 1-d and 3-d convolutions, the transposed convolutions, the pools,
reflection padding, pixel shuffles, deformable convolution), in each
layout the reference takes: the same seeded numpy input and random
parameter values (set in the reference, carried across with
`load_reference_params`) through both packages, forward and the
gradients of the input and of every parameter for the same seeded
output gradient.  Also the repaired Block surface: Dense, LayerNorm
and the norms deferring their widths, Dropout's ``axes``,
``collect_params(select)``, ``children`` as a dict that torch's
``train``/``eval``/``to``/``apply`` still walk, and ``initialize``
with a one-element context list.

Tolerance: f32 on both sides, true f32 products summed in other orders,
values of order 1-10: atol = rtol = 1e-4 (2e-4 for the 3-d and
deformable convolutions, whose gradients sum several hundred products).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as ref_nn
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd, cpu
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

TOL = 1e-4


def _np_params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _randomize_reference(ref, rng):
    for k, p in ref.collect_params().items():
        shape = p.data().shape
        val = rng.uniform(0.5, 1.5, shape) if k.endswith(("gamma", "alpha")) \
            else rng.standard_normal(shape) * 0.5
        p.set_data(mx.np.array(val.astype(onp.float32)))


def compare(ref, port, x_shape, seed=0, tol=TOL, n_inputs=1):
    """Forward of ``ref`` and ``port`` on the same seeded input(s),
    parameters from the reference (random values), then the gradients
    of the inputs and of every parameter for one seeded output
    gradient."""
    rng = onp.random.default_rng(seed)
    xs = [rng.standard_normal(x_shape).astype(onp.float32)
          for _ in range(n_inputs)]
    ref.initialize()
    ref(*[mx.np.array(x) for x in xs])
    _randomize_reference(ref, rng)
    params = _np_params(ref)
    port.initialize(ctx=cpu())
    if params:
        load_reference_params(port, params)
    ref_x = [mx.np.array(x) for x in xs]
    for a in ref_x:
        a.attach_grad()
    with mx.autograd.record():
        ref_out = ref(*ref_x)
    ograd = rng.standard_normal(ref_out.shape).astype(onp.float32)
    ref_out.backward(mx.np.array(ograd))
    port_x = [torch.tensor(x, requires_grad=True) for x in xs]
    with autograd.record():
        out = port(*port_x)
    out.backward(torch.from_numpy(ograd))
    onp.testing.assert_allclose(out.detach().numpy(), ref_out.asnumpy(),
                                atol=tol, rtol=tol)
    for a, b in zip(port_x, ref_x):
        onp.testing.assert_allclose(a.grad.numpy(), b.grad.asnumpy(),
                                    atol=tol, rtol=tol)
    ref_params = ref.collect_params()
    for k, p in port.collect_params().items():
        if p.grad_req == "null":
            continue
        onp.testing.assert_allclose(p.grad().numpy(),
                                    ref_params[k].grad().asnumpy(),
                                    atol=tol, rtol=tol, err_msg=k)
    return out


# ---------------------------------------------------------------------------
# the norms and activations
# ---------------------------------------------------------------------------
NORMS = [
    ("GroupNorm", dict(num_groups=2), (2, 4, 3, 5)),
    ("GroupNorm", dict(num_groups=3, center=False), (2, 6, 7)),
    ("InstanceNorm", {}, (2, 3, 4, 5)),
    ("InstanceNorm", dict(scale=False), (3, 2, 6)),
    ("LayerNorm", {}, (2, 3, 8)),
    ("LayerNorm", dict(axis=1, center=False, scale=False), (2, 5, 3)),
]


@pytest.mark.parametrize("name,kw,shape", NORMS)
def test_norms_match_reference(name, kw, shape):
    compare(getattr(ref_nn, name)(**kw), getattr(nn, name)(**kw), shape)


def test_sync_batch_norm_is_batch_norm_with_its_signature():
    """In predict mode it normalizes by the running statistics; in train
    mode by the batch's, as BatchNorm does (the reference's alias)."""
    for cls in (ref_nn.SyncBatchNorm, nn.SyncBatchNorm):
        assert issubclass(cls, (ref_nn.BatchNorm, nn.BatchNorm))
    compare(ref_nn.SyncBatchNorm(num_devices=4, momentum=0.8),
            nn.SyncBatchNorm(num_devices=4, momentum=0.8), (4, 3, 5))


ACTIVATIONS = [
    ("LeakyReLU", dict(alpha=0.1)),
    ("ELU", dict(alpha=0.7)),
    ("SELU", {}),
    ("Swish", dict(beta=1.5)),
    ("SiLU", {}),
    ("GELU", {}),
    ("GELU", dict(approximation="tanh")),
]


@pytest.mark.parametrize("name,kw", ACTIVATIONS)
def test_activations_match_reference(name, kw):
    compare(getattr(ref_nn, name)(**kw), getattr(nn, name)(**kw), (3, 4, 5))


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (4, 3)])
def test_prelu_matches_reference(shape):
    compare(ref_nn.PReLU(in_channels=3), nn.PReLU(in_channels=3), shape)
    p = nn.PReLU()
    p.initialize(ctx=cpu())
    assert p.alpha.data().tolist() == [0.25]


@pytest.mark.parametrize("act", ["log_sigmoid", "softsign", "mish",
                                 "softrelu"])
def test_activation_types_match_reference(act):
    compare(ref_nn.Activation(act), nn.Activation(act), (3, 7))


def test_leaky_relu_rrelu_matches_reference():
    x = onp.random.default_rng(3).standard_normal((4, 5)).astype(onp.float32)
    ref = mx.npx.leaky_relu(mx.np.array(x), act_type="rrelu").asnumpy()
    got = mxt.npx.leaky_relu(torch.from_numpy(x), act_type="rrelu").numpy()
    onp.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------
def _concat(lib, axis):
    c = lib.HybridConcatenate(axis=axis)
    c.add(lib.Dense(3, in_units=4), lib.Identity(),
          lib.Dense(2, activation="relu"))
    return c


@pytest.mark.parametrize("axis", [-1, 1])
def test_hybrid_concatenate_matches_reference(axis):
    compare(_concat(ref_nn, axis), _concat(nn, axis), (5, 4))
    assert nn.Concatenate is nn.HybridConcatenate


@pytest.mark.parametrize("fn", ["sinh", "exp", "square"])
def test_lambdas_by_name_match_reference(fn):
    compare(ref_nn.Lambda(fn), nn.Lambda(fn), (2, 3))
    compare(ref_nn.HybridLambda(fn), nn.HybridLambda(fn), (2, 3))


def test_lambda_callables_and_npx_names():
    x = torch.randn(2, 3)
    assert torch.equal(nn.Lambda(lambda a, b: a + b)(x, x), 2 * x)
    assert torch.equal(nn.HybridLambda("relu")(x), torch.relu(x))
    compare(ref_nn.HybridLambda(lambda a, b: a * b),
            nn.HybridLambda(lambda a, b: a * b), (2, 3), n_inputs=2)


# ---------------------------------------------------------------------------
# convolutions and pools, every layout
# ---------------------------------------------------------------------------
def _channels_last(layout, shape):
    """``shape`` given channels-first, in ``layout``."""
    if layout[1] == "C":
        return shape
    return (shape[0],) + tuple(shape[2:]) + (shape[1],)


CONVS = [
    ("Conv1D", dict(channels=4, kernel_size=3, strides=2, padding=1),
     "NCW", (2, 3, 9)),
    ("Conv1D", dict(channels=4, kernel_size=3, dilation=2, groups=1),
     "NWC", (2, 3, 9)),
    ("Conv2D", dict(channels=4, kernel_size=(3, 2), strides=(2, 1),
                    padding=(1, 0), groups=2), "NCHW", (2, 4, 7, 6)),
    ("Conv2D", dict(channels=4, kernel_size=3, strides=2, padding=1,
                    activation="relu"), "NHWC", (2, 3, 7, 6)),
    ("Conv2D", dict(channels=6, kernel_size=3, padding=1, groups=3),
     "NHWC", (2, 3, 5, 5)),
    ("Conv3D", dict(channels=3, kernel_size=2, padding=1), "NCDHW",
     (2, 2, 4, 3, 5)),
    ("Conv3D", dict(channels=3, kernel_size=(2, 3, 1), strides=2),
     "NDHWC", (2, 2, 5, 6, 4)),
    ("Conv1DTranspose", dict(channels=3, kernel_size=3, strides=2,
                             padding=1, output_padding=1), "NCW", (2, 4, 5)),
    ("Conv1DTranspose", dict(channels=3, kernel_size=3), "NWC", (2, 4, 5)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=3, strides=2,
                             padding=1, output_padding=1, groups=2),
     "NCHW", (2, 4, 4, 5)),
    ("Conv2DTranspose", dict(channels=3, kernel_size=(2, 3), strides=(2, 1),
                             dilation=(1, 2)), "NHWC", (2, 4, 3, 5)),
    ("Conv3DTranspose", dict(channels=2, kernel_size=2, strides=2),
     "NCDHW", (1, 3, 3, 2, 4)),
    ("Conv3DTranspose", dict(channels=2, kernel_size=3, padding=1),
     "NDHWC", (1, 3, 3, 2, 4)),
]


@pytest.mark.parametrize("name,kw,layout,shape", CONVS)
def test_convolutions_match_reference(name, kw, layout, shape):
    tol = 2e-4 if "3D" in name else TOL
    out = compare(getattr(ref_nn, name)(layout=layout, **kw),
                  getattr(nn, name)(layout=layout, **kw),
                  _channels_last(layout, shape), tol=tol)
    assert out.shape[layout.index("C")] == kw["channels"]


POOLS = [
    ("MaxPool1D", dict(pool_size=3, strides=2, padding=1), "NCW",
     (2, 3, 9)),
    ("AvgPool1D", dict(pool_size=2, ceil_mode=True), "NWC", (2, 3, 9)),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1), "NHWC",
     (2, 3, 7, 6)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), "NHWC", (2, 3, 7, 6)),
    ("MaxPool2D", dict(pool_size=3, strides=2, ceil_mode=True), "NHWC",
     (2, 3, 8, 8)),
    ("MaxPool3D", dict(pool_size=2), "NCDHW", (1, 2, 4, 4, 5)),
    ("AvgPool3D", dict(pool_size=(2, 1, 2), padding=(1, 0, 0)), "NDHWC",
     (1, 2, 4, 4, 5)),
    ("GlobalMaxPool1D", {}, "NCW", (2, 3, 5)),
    ("GlobalMaxPool1D", {}, "NWC", (2, 3, 5)),
    ("GlobalMaxPool2D", {}, "NCHW", (2, 3, 4, 5)),
    ("GlobalMaxPool2D", {}, "NHWC", (2, 3, 4, 5)),
    ("GlobalMaxPool3D", {}, "NDHWC", (2, 3, 2, 3, 4)),
    ("GlobalAvgPool1D", {}, "NWC", (2, 3, 5)),
    ("GlobalAvgPool2D", {}, "NHWC", (2, 3, 4, 5)),
    ("GlobalAvgPool3D", {}, "NCDHW", (2, 3, 2, 3, 4)),
]


@pytest.mark.parametrize("name,kw,layout,shape", POOLS)
def test_pools_match_reference(name, kw, layout, shape):
    compare(getattr(ref_nn, name)(layout=layout, **kw),
            getattr(nn, name)(layout=layout, **kw),
            _channels_last(layout, shape))


def test_channels_last_conv_takes_no_copy():
    """An NHWC input reaches torch's conv as a channels-last NCHW view,
    and the result comes back in NHWC with the weight (O, I, kh, kw)."""
    conv = nn.Conv2D(8, 3, padding=1, layout="NHWC", in_channels=4)
    conv.initialize(ctx=cpu())
    assert conv.weight.shape == (8, 4, 3, 3)
    x = torch.randn(2, 5, 6, 4)
    out = conv(x)
    assert out.shape == (2, 5, 6, 8)
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).contiguous(),
                                     conv.weight.data(), conv.bias.data(),
                                     padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="layout"):
        mxt.npx.convolution(x, conv.weight.data(), layout="HWNC")


@pytest.mark.parametrize("padding,shape", [(1, (2, 3, 4, 5)),
                                           ((2, 1), (1, 2, 5, 4)),
                                           ((1, 2, 0, 3), (2, 1, 4, 5))])
def test_reflection_pad_matches_reference(padding, shape):
    compare(ref_nn.ReflectionPad2D(padding), nn.ReflectionPad2D(padding),
            shape)


@pytest.mark.parametrize("name,factor,shape", [
    ("PixelShuffle1D", 3, (2, 6, 4)),
    ("PixelShuffle2D", 2, (2, 8, 3, 4)),
    ("PixelShuffle2D", (1, 3), (1, 6, 2, 3)),
    ("PixelShuffle3D", 2, (1, 16, 2, 3, 2)),
    ("PixelShuffle3D", (1, 2, 3), (1, 12, 2, 2, 3)),
])
def test_pixel_shuffles_match_reference(name, factor, shape):
    compare(getattr(ref_nn, name)(factor), getattr(nn, name)(factor), shape)


def test_deformable_convolution_matches_reference():
    """Random offsets (the offset conv's weights are randomized too), so
    the sampling points fall between pixels and outside the image; a
    non-square kernel, stride 2, asymmetric padding and an activation."""
    kw = dict(channels=3, kernel_size=(3, 2), strides=2, padding=(1, 0),
              activation="relu")
    compare(ref_nn.DeformableConvolution(**kw),
            nn.DeformableConvolution(**kw), (2, 3, 6, 5), tol=2e-4)


# ---------------------------------------------------------------------------
# the Block repairs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flatten,shape", [(True, (2, 3, 4)),
                                           (False, (2, 3, 4)),
                                           (True, (5, 7))])
def test_dense_defers_in_units(flatten, shape):
    ref = ref_nn.Dense(6, activation="tanh", flatten=flatten)
    net = nn.Dense(6, activation="tanh", flatten=flatten)
    out = compare(ref, net, shape)
    width = int(onp.prod(shape[1:])) if flatten else shape[-1]
    assert net.weight.shape == (6, width)
    assert out.shape == ((shape[0], 6) if flatten else shape[:-1] + (6,))


def test_deferred_dense_draws_from_the_generator_in_forward_order():
    def make():
        seq = nn.HybridSequential()
        seq.add(nn.Dense(5, activation="relu"), nn.Dense(3, in_units=5),
                nn.Dense(2))
        seq.initialize(init=mxt.init.Xavier(), ctx=cpu(),
                       generator=torch.Generator().manual_seed(4))
        seq(torch.ones(1, 7))
        return {k: p.data().clone() for k, p in seq.collect_params().items()}
    a, b = make(), make()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["0.weight"].shape == (5, 7) and a["2.weight"].shape == (2, 3)


def test_layer_norm_defers_and_takes_center_and_scale():
    ln = nn.LayerNorm(center=False, scale=False)
    ln.initialize(ctx=cpu())
    x = torch.randn(3, 6)
    ln(x)
    assert ln.gamma.shape == (6,) and ln.gamma.grad_req == "null"
    assert ln.beta.grad_req == "null"
    assert nn.LayerNorm().gamma.grad_req == "write"


def test_dropout_axes_share_one_mask():
    """``axes=(1,)`` draws one keep decision per index of axis 1 and
    broadcasts it over axes 0 and 2, as the reference shapes the mask."""
    drop = nn.Dropout(0.5, axes=(1,))
    x = torch.ones(4, 64, 5)
    with autograd.record(generator=torch.Generator().manual_seed(3)):
        y = drop(x)
    kept = y[0, :, 0] != 0
    assert 0 < int(kept.sum()) < 64
    assert torch.equal(y, y[:1, :, :1].expand_as(y))
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(drop(x), x)   # predict mode


def test_collect_params_select_matches_reference_names():
    ref = mx.gluon.model_zoo.vision.resnet18_v1(classes=4)
    net = vision.resnet18_v1(classes=4)
    for select in (".*gamma|.*beta", r"features\.5\..*weight$",
                   "output", ".*running_(mean|var)"):
        assert list(net.collect_params(select)) == \
            list(ref.collect_params(select))
    assert len(net.collect_params(".*weight")) == 21


def test_children_is_a_dict_that_torch_still_walks():
    net = vision.resnet18_v1(classes=4)
    net.initialize(ctx=cpu())
    net(torch.zeros(1, 3, 32, 32))
    assert list(net.children) == ["features", "output"]
    assert net.children["output"] is net.output
    assert list(net.features.children)[:2] == ["0", "1"]
    assert [type(c).__name__ for c in net.children()] == \
        ["HybridSequential", "Dense"]
    net.eval()
    assert not any(m.training for m in net.modules())
    net.train()
    assert all(m.training for m in net.modules())
    seen = []
    net.apply(lambda m: seen.append(type(m).__name__))
    assert seen.count("BatchNorm") == 20 and seen[-1] == "ResNetV1"
    assert net.to("cpu") is net and net.to(torch.float32) is net
    net.hybridize()
    assert net._hybridized and not net.features.__dict__.get("_hybridized")
    net.cast("bfloat16")
    assert net.features[0].weight.data().dtype == torch.bfloat16
    assert net.features[1].running_mean.data().dtype == torch.bfloat16
    assert isinstance(net.state_dict(), dict)
    x = torch.zeros(1, 3, 32, 32, dtype=torch.bfloat16)
    assert net(x).shape == (1, 4)


def test_initialize_takes_a_one_element_context_list():
    net = nn.Dense(3)
    net.initialize(ctx=[cpu()])
    net(torch.ones(2, 4))
    assert net.weight.data().device.type == "cpu"
    # several contexts keep a copy on each (data parallelism in one
    # process); an empty list or a context named twice raises
    two = nn.Dense(3, in_units=2)
    two.initialize(ctx=[cpu(), cpu(1)])
    assert two.weight.list_ctx() == [cpu(), cpu(1)]
    with pytest.raises(mxt.MXNetError, match="empty"):
        nn.Dense(3, in_units=2).initialize(ctx=[])
    with pytest.raises(mxt.MXNetError, match="twice"):
        nn.Dense(3, in_units=2).initialize(ctx=[cpu(1), cpu(1)])
