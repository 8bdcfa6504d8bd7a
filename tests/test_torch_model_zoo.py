"""The port's ResNet model zoo against the JAX package's.

`resnet18_v1(thumbnail=True)` from the reference's weights (carried
across with `load_reference_params`) against the reference's logits on
the same seeded (2, 3, 32, 32) batch in predict mode; `resnet50_v1`'s
parameter names, order and shapes after one tiny forward; deferred
initialization drawn from one seed in a fixed order; a Sequential child
replaced with ``setattr``.

Tolerance: logits of order 1 through 18 layers, f32 with true f32
products on both sides that sum in other orders: atol = rtol = 1e-4.
"""
import numpy as onp
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as ref_vision
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.utils.convert import load_reference_params

torch.set_num_threads(1)

ATOL = RTOL = 1e-4
CLASSES = 10


def _np_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def test_resnet18_thumbnail_matches_reference():
    mx.random.seed(1)
    ref = ref_vision.resnet18_v1(thumbnail=True, classes=CLASSES)
    ref.initialize()
    x = onp.random.default_rng(5).uniform(-1, 1, (2, 3, 32, 32)).astype(
        onp.float32)
    ref(mx.np.zeros((1, 3, 32, 32)))
    params = _np_params(ref)
    net = vision.resnet18_v1(thumbnail=True, classes=CLASSES)
    net.initialize(ctx=cpu())
    load_reference_params(net, params)
    assert {k: p.shape for k, p in net.collect_params().items()} == \
        {k: v.shape for k, v in params.items()}
    expect = ref(mx.np.array(x)).asnumpy()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(got, expect, atol=ATOL, rtol=RTOL)


def test_resnet50_v1_names_and_shapes_match_reference():
    mx.random.seed(2)
    ref = ref_vision.resnet50_v1()
    ref.initialize()
    ref(mx.np.zeros((1, 3, 32, 32)))
    net = vision.get_model("resnet50_v1")
    net.initialize(ctx=cpu())
    with torch.no_grad():
        net(torch.zeros(1, 3, 32, 32))
    mine = {k: p.shape for k, p in net.collect_params().items()}
    theirs = {k: tuple(p.shape) for k, p in ref.collect_params().items()}
    assert mine == theirs
    assert list(mine) == list(theirs)
    n_bn = sum(k.endswith("running_mean") for k in mine)
    assert n_bn == 53 and len(mine) - 2 * n_bn == 161
    assert mine["features.0.weight"] == (64, 3, 7, 7)


def test_deferred_init_is_seeded_and_sequential_children_replace():
    outs = []
    for _ in range(2):
        net = vision.resnet18_v1(classes=CLASSES)
        net.initialize(init=mxt.init.Xavier(), ctx=cpu(),
                       generator=torch.Generator().manual_seed(7))
        net.cast("bfloat16")
        with torch.no_grad():
            net(torch.zeros(1, 3, 64, 64, dtype=torch.bfloat16))
        outs.append({k: p.data().clone()
                     for k, p in net.collect_params().items()})
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    w = outs[0]["features.0.weight"]
    assert w.dtype == torch.bfloat16
    bound = (3.0 / ((3 * 49 + 64 * 49) / 2.0)) ** 0.5    # Xavier uniform avg
    assert float(w.float().abs().max()) <= bound * (1 + 2 ** -7)
    assert torch.equal(outs[0]["features.1.gamma"],
                       torch.ones(64, dtype=torch.bfloat16))
    stem = mxt.gluon.nn.SpaceToDepthStem(64, in_channels=3)
    setattr(net.features, "0", stem)
    assert net.features[0] is stem
    assert list(net.collect_params())[0] == "features.0.weight"
